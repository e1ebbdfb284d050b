"""The PyTorch port's planner tagging and conf (``plan/overrides.py``,
``config/rapids_conf.py``) against the JAX package's, on the CPU.

The cases of ``tests/test_conf.py`` this slice covers, each through both
packages on the same numpy-seeded data: unknown keys, per-exec and
per-expression disables (a typo in one is rejected), the window
expression disable, the format gate, the float-aggregate and cast gates
and ``suppressPlanningFailure``.  Each checks that both packages tag the
same plan nodes and expressions (the ``!`` lines of their explains) and,
where both answer, that the answers agree.  Then the explain modes, and
the sharded path: a disabled operator or expression sends the plan to one
device with the reason on ``last_dist_explain``, while a tagged
expression over an encoded string column still runs distributed as a
lookup the CPU evaluates over the dictionary.
"""

import re

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.config.rapids_conf import RapidsConf as JaxConf
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.config import rapids_conf as rc
from spark_rapids_tpu_torch.config.rapids_conf import RapidsConf

RTOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _data(n=200, seed=3):
    rng = np.random.default_rng(seed)
    return {"g": rng.integers(0, 5, n), "x": rng.integers(-50, 50, n),
            "v": rng.normal(size=n).round(4),
            "s": [f"w{int(i)}" for i in rng.integers(0, 12, n)]}


def tagged(explain: str):
    """The names an explain marks ``!`` (off the device), in order."""
    return [m.group(1) for m in re.finditer(r"^\s*! (\w+) ", explain,
                                            re.M)]


def run_both(conf, build, data=None):
    """``build(F, df)`` through both packages under ``conf``: (port
    session, port DataFrame, JAX answer or the error it raised, JAX
    explain)."""
    data = data if data is not None else _data()
    port = TpuSession(conf, device="cpu")
    pdf = build(TF, port.create_dataframe(data))
    jax = JaxSession(conf)
    try:
        jdf = build(JF, jax.create_dataframe(data))
        jax.plan(jdf.plan)
        jexplain = jax.overrides.last_explain
        try:
            want = jdf.to_pandas()
        except (NotImplementedError, RuntimeError, ValueError) as exc:
            want = exc
    finally:
        jax.stop()
    return port, pdf, want, jexplain


def same(got, want, sort=None):
    if sort is not None:
        got = got.sort_values(sort, ignore_index=True)
        want = want.sort_values(sort, ignore_index=True)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in got.columns:
        if got[c].dtype.kind == "f":
            np.testing.assert_allclose(got[c].to_numpy(),
                                       want[c].to_numpy(), rtol=RTOL,
                                       atol=0, equal_nan=True)
        else:
            assert got[c].tolist() == want[c].tolist(), c


def test_unknown_rapids_key_rejected():
    for conf in (RapidsConf, JaxConf):
        with pytest.raises(ValueError, match="unknown configuration key"):
            conf({"spark.rapids.sql.batchSizeByts": "1024"})  # typo
        # non-rapids keys pass through untouched
        conf({"spark.sql.shuffle.partitions": "8"})
    # the dynamic families
    RapidsConf({"spark.rapids.sql.exec.Sort": "false",
                "spark.rapids.sql.expression.Like": "false",
                "spark.rapids.sql.optimizer.tpuOpCost.Sort": "0.5",
                "spark.rapids.sql.optimizer.cpuOpCost.AnyOp": "1"})


def test_per_expression_disable():
    conf = {"spark.rapids.sql.expression.Substring": "false"}

    def build(F, df):
        return df.select(F.substring(F.col("s"), 1, 2).alias("p"), "x")
    port, df, want, jexplain = run_both(conf, build)
    assert df.explain().splitlines()[0] == "CpuFallbackExec[Project]"
    assert "disabled by spark.rapids.sql.expression.Substring" in \
        port.overrides.last_explain
    # an expression under an alias shows in its node's reason
    assert tagged(port.overrides.last_explain) == tagged(jexplain) == \
        ["Project"]
    same(df.to_pandas(), want)
    # enabled by default
    s2 = TpuSession({}, device="cpu")
    assert "CpuFallbackExec" not in build(TF, s2.create_dataframe(
        _data())).explain().split("== Logical Plan ==")[0]


def test_per_exec_disable():
    conf = {"spark.rapids.sql.exec.Sort": "false"}

    def build(F, df):
        return df.orderBy("x", "g", "s", "v")
    port, df, want, jexplain = run_both(conf, build)
    assert "CpuFallbackExec[Sort]" in df.explain()
    assert tagged(port.overrides.last_explain) == tagged(jexplain) == \
        ["Sort"]
    got = df.to_pandas()
    assert got["x"].is_monotonic_increasing
    same(got, want)


def test_conf_docs_generate():
    reg = rc._REGISTRY
    for key in ("spark.rapids.sql.variableFloatAgg.enabled",
                "spark.rapids.sql.castStringToFloat.enabled",
                "spark.rapids.sql.explain", "spark.rapids.sql.test.enabled",
                "spark.rapids.sql.optimizer.enabled",
                "spark.rapids.sql.suppressPlanningFailure"):
        assert key in reg
        # the reference's default
        assert reg[key].default == JaxConf.registry()[key].default


@pytest.mark.parametrize("key", [
    # no ported expression is incompatible and the port has no decimal
    # type: a key nothing reads is rejected, not silently ignored
    "spark.rapids.sql.incompatibleOps.enabled",
    "spark.rapids.sql.castFloatToDecimal.enabled"])
def test_unread_reference_keys_rejected(key):
    JaxConf({key: "false"})
    with pytest.raises(ValueError, match="unknown configuration key"):
        RapidsConf({key: "false"})


def test_per_op_key_typo_rejected():
    for conf in (RapidsConf, JaxConf):
        with pytest.raises(ValueError, match="unknown configuration key"):
            conf({"spark.rapids.sql.expression.Substrng": "false"})
        with pytest.raises(ValueError, match="unknown configuration key"):
            conf({"spark.rapids.sql.exec.Srot": "false"})


def test_window_expression_disable_honored():
    conf = {"spark.rapids.sql.expression.WindowExpression": "false"}

    def build(F, df):
        return df.select("g", F.row_number().over(
            F.Window.partitionBy("g").orderBy("x")).alias("rn"))
    port, df, want, jexplain = run_both(conf, build)
    assert "TpuWindowExec" not in df.explain()
    assert tagged(port.overrides.last_explain) == tagged(jexplain)
    # neither package's CPU fallback runs a window
    assert isinstance(want, NotImplementedError)
    with pytest.raises(NotImplementedError,
                       match=re.escape(str(want))):
        df.collect()


def test_format_enable_gate(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq
    p = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"a": list(range(10)),
                             "s": [f"r{i}" for i in range(10)]}), p)
    conf = {"spark.rapids.sql.format.parquet.enabled": "false"}
    port = TpuSession(conf, device="cpu")
    df = port.read.parquet(p)
    assert "CpuFallbackExec[FileRelation]" in df.explain()
    jax = JaxSession(conf)
    jdf = jax.read.parquet(p)
    jax.plan(jdf.plan)
    assert tagged(port.overrides.last_explain) == \
        tagged(jax.overrides.last_explain) == ["FileRelation"]
    same(df.to_pandas(), jdf.to_pandas(), sort="a")
    jax.stop()
    s2 = TpuSession({}, device="cpu")
    assert "CpuFallbackExec" not in s2.read.parquet(p).explain()


def test_variable_float_agg_gate():
    conf = {"spark.rapids.sql.variableFloatAgg.enabled": "false"}

    def build(F, df):
        return df.groupBy("g").agg(F.sum("v").alias("s"),
                                   F.avg("x").alias("a"))
    port, df, want, jexplain = run_both(conf, build)
    assert "CpuFallbackExec[Aggregate]" in df.explain()
    assert tagged(port.overrides.last_explain) == tagged(jexplain)
    same(df.to_pandas(), want, sort="g")
    # integer sums and counts are not gated
    q2 = TpuSession(conf, device="cpu").create_dataframe(_data()).groupBy(
        "g").agg(TF.count("v").alias("c"), TF.sum("x").alias("sx"))
    assert "CpuFallbackExec" not in q2.explain().split("==")[0]


def test_cast_config_gates():
    conf = {"spark.rapids.sql.castStringToFloat.enabled": "false"}
    data = {"x": ["1.5", "2.5", "-3", "bad", None]}

    def build(F, df):
        return df.select(F.col("x").cast("double").alias("d"))
    port, df, want, jexplain = run_both(conf, build, data)
    assert "CpuFallbackExec[Project]" in df.explain()
    assert "disabled by spark.rapids.sql.castStringToFloat.enabled" in \
        port.overrides.last_explain
    assert tagged(port.overrides.last_explain) == tagged(jexplain)
    same(df.to_pandas(), want)
    got = df.to_pandas()["d"].tolist()
    assert got[:3] == [1.5, 2.5, -3.0] and pd.isna(got[3])
    # by default the JAX package parses on its device; the port has no
    # device string cast, so it still falls back (with that reason) and
    # answers the same
    port, df, want, jexplain = run_both({}, build, data)
    assert tagged(jexplain) == []
    assert "CpuFallbackExec[Project]" in df.explain()
    assert "casts to and from strings are not ported" in \
        port.overrides.last_explain
    same(df.to_pandas(), want)


def test_suppress_planning_failure():
    class Boom:
        def apply(self, logical):
            raise RuntimeError("planner bug")

    for session in (TpuSession({"spark.rapids.sql.suppressPlanningFailure":
                                "true"}, device="cpu"),
                    JaxSession({"spark.rapids.sql.suppressPlanningFailure":
                                "true"})):
        df = session.create_dataframe({"x": [2, 1]})
        plan = df.orderBy("x").plan
        session.overrides = Boom()
        with pytest.warns(RuntimeWarning, match="planner bug"):
            exec_plan = session.plan(plan)
        assert "CpuFallbackExec" in exec_plan.tree_string()
        assert str(session.last_planning_error) == "planner bug"
        import pyarrow as pa
        out = pa.concat_tables(
            [b.to_arrow() for b in exec_plan.execute()]).to_pandas()
        assert out["x"].tolist() == [1, 2]
    # default: the failure surfaces
    s2 = TpuSession({}, device="cpu")
    plan = s2.create_dataframe({"x": [2, 1]}).orderBy("x").plan
    s2.overrides = Boom()
    with pytest.raises(RuntimeError, match="planner bug"):
        s2.plan(plan)


@pytest.mark.parametrize("mode", ["NONE", "NOT_ON_TPU", "ALL"])
def test_explain_modes(mode, capsys):
    s = TpuSession({"spark.rapids.sql.explain": mode,
                    "spark.rapids.sql.exec.Sort": "false"}, device="cpu")
    df = s.create_dataframe(_data()).filter(TF.col("x") > 0).orderBy("x")
    capsys.readouterr()
    s.plan(df.plan)
    out = capsys.readouterr().out
    if mode == "NONE":
        assert out == ""
    elif mode == "NOT_ON_TPU":
        assert out.strip() == "! Sort will NOT run on the device because " \
            "Sort disabled by spark.rapids.sql.exec.Sort"
    else:
        assert "* Filter will run on the device" in out
        assert "! Sort will NOT run" in out
    with pytest.raises(ValueError, match="NONE, NOT_ON_TPU or ALL"):
        RapidsConf({"spark.rapids.sql.explain": "SOME"})


def test_fusion_and_topn_take_only_device_members():
    """A Filter that falls back is not folded into the aggregate above
    it, nor a Sort into a TopN."""
    s = TpuSession({"spark.rapids.sql.expression.Like": "false"},
                   device="cpu")
    df = s.create_dataframe(_data())
    q = df.filter(TF.col("s").like("w1%")).filter(TF.col("x") > 0) \
        .groupBy("g").agg(TF.sum("x").alias("sx"))
    plan = q.explain().split("== Logical Plan ==")[0]
    assert "CpuFallbackExec[Filter]" in plan
    assert "fused filter" in plan  # the device Filter above still folds
    assert plan.index("fused filter") < plan.index("CpuFallbackExec")
    t = TpuSession({"spark.rapids.sql.exec.Sort": "false"}, device="cpu")
    top = t.create_dataframe(_data()).orderBy("x", "g").limit(5)
    plan = top.explain()
    assert plan.splitlines()[0].startswith("TpuLocalLimitExec")
    assert "TpuTopNExec" not in plan
    want = pd.DataFrame(_data()).sort_values(["x", "g"], kind="stable")
    assert top.to_pandas()["x"].tolist() == want["x"].tolist()[:5]


# ------------------------------------------------------------- sharded --

def _sharded(conf):
    return TpuSession(dict(conf, **{
        "spark.rapids.sql.distributed.numShards": 4}), device="cpu")


def test_sharded_disabled_expression_runs_on_one_device():
    s = _sharded({"spark.rapids.sql.expression.Multiply": "false"})
    df = s.create_dataframe(_data()).groupBy("g").agg(
        TF.sum(TF.col("x") * 2).alias("s2"))
    got = df.to_pandas().sort_values("g", ignore_index=True)
    assert s.last_dist_explain.startswith("fallback: ")
    assert "expression Multiply disabled by " \
        "spark.rapids.sql.expression.Multiply" in s.last_dist_explain
    assert df._last_exec is not None
    assert "CpuFallbackExec[Aggregate]" in df._last_exec.tree_string()
    want = pd.DataFrame(_data()).groupby("g", as_index=False).agg(
        s2=("x", lambda x: int((x * 2).sum())))
    assert got["s2"].tolist() == want["s2"].tolist()


def test_sharded_disabled_exec_runs_on_one_device():
    s = _sharded({"spark.rapids.sql.exec.Sort": "false"})
    df = s.create_dataframe(_data()).orderBy("x", "g", "s", "v")
    got = df.to_pandas()
    assert s.last_dist_explain == \
        "fallback: Sort: Sort disabled by spark.rapids.sql.exec.Sort"
    jax = JaxSession({})
    want = jax.create_dataframe(_data()).orderBy("x", "g", "s", "v") \
        .to_pandas()
    jax.stop()
    same(got, want)


def test_sharded_tagged_string_expression_stays_distributed():
    """A LIKE with ``_`` over an encoded string column tags off the
    device, yet runs distributed: the CPU evaluates it over the column's
    dictionary, each row gathers its result."""
    s = _sharded({})
    df = s.create_dataframe(_data()).filter(TF.col("s").like("w1_")) \
        .groupBy("s").agg(TF.count().alias("n"))
    got = df.to_pandas().sort_values("s", ignore_index=True)
    assert s.last_dist_explain == "distributed"
    jax = JaxSession({})
    want = jax.create_dataframe(_data()).filter(JF.col("s").like("w1_")) \
        .groupBy("s").agg(JF.count().alias("n")).to_pandas() \
        .sort_values("s", ignore_index=True)
    jax.stop()
    assert sorted(got["s"]) == ["w10", "w11"]
    same(got, want)
