"""The query-level recovery of the PyTorch port (``robustness/driver.py``
through ``DataFrame._execute_batches``) against the JAX package's, on
the CPU.

The same injection rule at the same point in both packages gives the
same recovery trail (action, fault kind) and the same answer: a device
OOM that outlives the operator-level retries (a raw OOM enters at the
``spill`` rung, a split that bottomed out at ``split``), a failed disk
spill write, a corrupted host spill payload under a spill budget, and
reader faults over parquet (retries, and a reader that never succeeds
answering from the ``cpu`` rung).  On a CUDA session the port's ladder
has no ``cpu`` rung: the same two persistent faults re-raise there.  A UDF worker-pool fault degrades
inline and is recorded as a local action; a fatal fault writes its
QueryFatal trail; recovery actions land in the event log under the
failed attempt's query id.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.memory import retry as JR
from spark_rapids_tpu.models import tpch as jtpch
from spark_rapids_tpu.robustness import inject as JI
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.memory import retry as R
from spark_rapids_tpu_torch.models import tpch
from spark_rapids_tpu_torch.robustness import driver as D
from spark_rapids_tpu_torch.robustness import faults as FT
from spark_rapids_tpu_torch.robustness import inject as I
from spark_rapids_tpu_torch.robustness.driver import recovery_metrics
from spark_rapids_tpu_torch.tools.eventlog import load_logs

FAST = {"spark.rapids.sql.recovery.backoffMs": 0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _clean_registries():
    I.clear()
    JI.clear()
    recovery_metrics.reset()
    with I.scoped_rules(), JI.scoped_rules():
        yield


@pytest.fixture(scope="module")
def data():
    return jtpch.gen_tables(sf=0.002)


def _trail(session):
    return [(r["action"], r["fault"]) for r in session.recovery_log]


def _both(conf, build, arm, device_conf=None):
    """Run ``build`` clean, then under the rule ``arm`` installs, in both
    packages: {pkg: (clean, injected, trail)}."""
    out = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            s, mod = JaxSession(dict(conf)), JF
        else:
            s, mod = TpuSession(dict(conf, **(device_conf or {})),
                                device="cpu"), F
        df = build(s, mod, pkg)
        want = df.to_pandas()
        s.recovery_log.clear()
        with arm(pkg):
            got = df.to_pandas()
        out[pkg] = (want, got, _trail(s))
        s.stop()
    return out


def _norm(df, keys):
    return df.sort_values(keys, ignore_index=True)


def _same(out, keys, rtol=1e-12):
    jw, jg, jt = out["jax"]
    tw, tg, tt = out["torch"]
    assert tt == jt, (tt, jt)
    pd.testing.assert_frame_equal(_norm(tg, keys), _norm(tw, keys))
    pd.testing.assert_frame_equal(_norm(tg, keys), _norm(jg, keys),
                                  check_dtype=False, rtol=rtol)
    return tt


class _oom:
    """The OOM hook of either package, as a context manager."""

    def __init__(self, num, skip=0):
        self.num, self.skip = num, skip

    def __call__(self, pkg):
        self.mod = JR if pkg == "jax" else R
        return self

    def __enter__(self):
        self.mod.inject_oom(self.num, skip=self.skip)

    def __exit__(self, *exc):
        self.mod.clear_injected_oom()
        return False


def _rule(point, **kw):
    def arm(pkg):
        return (JI if pkg == "jax" else I).injected(point, **kw)
    return arm


def test_persistent_oom_splits_then_answers_on_cpu():
    """A device OOM that never stops: the operator split bottoms out at
    one row (a SplitAndRetryOOM, degradable), the query enters at the
    split rung and the CPU answers."""
    pdf = pd.DataFrame({"k": np.random.default_rng(11).integers(0, 20, 600),
                        "v": np.random.default_rng(12).normal(size=600)})

    def build(s, mod, pkg):
        return s.create_dataframe(pdf).groupBy("k").agg(
            mod.sum(mod.col("v")).alias("sv"))

    out = _both(FAST, build, _oom(10_000))
    assert _same(out, ["k"]) == [("split", "device_oom"),
                                 ("cpu", "device_oom")]


def _on_a_card(monkeypatch):
    """Make the port's ladder treat the (CPU) session as a CUDA one."""
    monkeypatch.setattr(D, "on_card", lambda session: True)


def test_persistent_oom_on_a_card_session_raises(monkeypatch):
    """The same OOM on a CUDA session: its ladder has no ``cpu`` rung,
    so once ``split`` is spent the fault re-raises and nothing answers
    on the host (a divergence from the JAX package, which answers on
    the CPU)."""
    _on_a_card(monkeypatch)
    pdf = pd.DataFrame({"k": np.random.default_rng(11).integers(0, 20, 40),
                        "v": np.random.default_rng(12).normal(size=40)})
    s = TpuSession(dict(FAST), device="cpu")
    df = s.create_dataframe(pdf).groupBy("k").agg(F.sum(F.col("v")).alias("sv"))
    with _oom(10_000)("torch"):
        with pytest.raises(Exception) as err:
            df.to_pandas()
    assert FT.classify(err.value).kind == "device_oom"
    assert _trail(s) == [("split", "device_oom")]
    assert "cpu" not in recovery_metrics.snapshot()
    s.stop()


def test_oom_past_operator_retries_enters_at_spill(data):
    """TPC-H q3 with three OOMs from the third guarded attempt on (the
    join build's keys, an attempt that cannot be split): the raw OOM
    outlives oomRetry.maxRetries=2, the query spills its device store
    and answers on the retry."""
    def build(s, mod, pkg):
        return (jtpch if pkg == "jax" else tpch).q3(
            (jtpch if pkg == "jax" else tpch).load(s, data))

    out = _both(FAST, build, _oom(3, skip=2))
    assert _same(out, ["l_orderkey"], rtol=1e-9) == [("spill", "device_oom")]


def test_spill_disk_fault_retries():
    conf = dict(FAST, **{
        "spark.rapids.memory.tpu.deviceLimitBytes": 4096,
        "spark.rapids.memory.host.spillStorageSize": 4096,
        "spark.rapids.memory.spill.diskWriteThreads": 1})
    rng = np.random.default_rng(5)
    pdf = pd.DataFrame({"k": rng.integers(0, 1000, 3000),
                        "v": rng.normal(size=3000)})

    def build(s, mod, pkg):
        return s.create_dataframe(pdf).orderBy("k", "v")

    out = _both(conf, build, _rule("spill.disk", count=1, all_threads=True))
    assert _same(out, ["k", "v"]) == [("retry", "spill_io")]


def test_corrupt_host_spill_replans_from_source():
    """A flipped bit in a host spill payload is caught by its checksum,
    the batch is dropped, and the query re-plans (split rung) and reads
    its source again."""
    conf = dict(FAST, **{"spark.rapids.memory.tpu.deviceLimitBytes": 4096})
    rng = np.random.default_rng(6)
    pdf = pd.DataFrame({"k": rng.integers(0, 500, 2000),
                        "v": rng.normal(size=2000)})

    def build(s, mod, pkg):
        return s.create_dataframe(pdf).orderBy("k", "v")

    out = _both(conf, build, _rule("spill.corrupt.host", kind="corrupt",
                                   count=1, seed=3))
    assert _same(out, ["k", "v"]) == [("split", "spill_corruption")]


@pytest.fixture(scope="module")
def lineitem_parquet(tmp_path_factory, data):
    path = tmp_path_factory.mktemp("tpch") / "lineitem.parquet"
    data["lineitem"].to_parquet(path, index=False)
    return str(path)


def _scan_agg(path):
    def build(s, mod, pkg):
        return (s.read.parquet(path).groupBy("l_returnflag")
                .agg(mod.sum(mod.col("l_extendedprice")).alias("rev"),
                     mod.count(mod.col("l_quantity")).alias("n")))
    return build


def test_reader_fault_retries(lineitem_parquet):
    out = _both(FAST, _scan_agg(lineitem_parquet), _rule("io.read", count=2))
    assert _same(out, ["l_returnflag"], rtol=1e-9) == \
        [("retry", "io_read"), ("retry", "io_read")]


def test_reader_that_never_succeeds_answers_on_cpu(lineitem_parquet):
    out = _both(FAST, _scan_agg(lineitem_parquet),
                _rule("io.read", count=1000))
    trail = _same(out, ["l_returnflag"], rtol=1e-9)
    assert [a for a, _ in trail] == ["retry", "retry", "spill", "split",
                                     "cpu"]


def test_reader_that_never_succeeds_on_a_card_session_raises(
        lineitem_parquet, monkeypatch):
    _on_a_card(monkeypatch)
    s = TpuSession(dict(FAST), device="cpu")
    df = _scan_agg(lineitem_parquet)(s, F, "torch")
    with I.injected("io.read", count=1000):
        with pytest.raises(FT.InjectedReaderFault):
            df.to_pandas()
    assert [a for a, _ in _trail(s)] == ["retry", "retry", "spill", "split"]
    assert "cpu" not in recovery_metrics.snapshot()
    s.stop()


def _half(x):
    # dict indirection keeps the UDF compiler from lowering this to a
    # device expression: it takes the worker-pool path
    return {"f": x * 0.5}["f"]


def test_udf_worker_fault_degrades_inline():
    from spark_rapids_tpu_torch.udf import worker_pool
    s = TpuSession({"spark.rapids.sql.python.numWorkers": 2}, device="cpu")
    pdf = pd.DataFrame({"x": np.arange(2000, dtype=np.float64)})
    half = F.udf(_half, "double")
    df = s.create_dataframe(pdf).select(half(F.col("x")).alias("h"))
    before = worker_pool.pool_metrics.snapshot().get("degradedToInline", 0)
    with I.injected("udf.worker", count=1) as rule:
        got = df.to_pandas()
    assert rule.fired == 1
    pd.testing.assert_frame_equal(got, pd.DataFrame({"h": pdf["x"] * 0.5}))
    # the degradation was local (inline), not a query re-drive
    assert [(r["action"], r["fault"], r["rung"])
            for r in s.recovery_log] == [("inline_fallback", "udf_worker",
                                          "local")]
    assert worker_pool.pool_metrics.snapshot()["degradedToInline"] == \
        before + 1
    s.stop()
    worker_pool.shutdown_pool()


def test_recovery_and_fatal_trails_in_event_log(tmp_path, lineitem_parquet):
    s = TpuSession(dict(FAST, **{"spark.rapids.tpu.eventLog.dir":
                                 str(tmp_path)}), device="cpu")
    df = _scan_agg(lineitem_parquet)(s, F, "torch")
    with I.injected("io.read", count=1):
        df.to_pandas()
    with pytest.raises(ValueError):
        with I.injected("io.read", count=1,
                        exc=lambda *a: ValueError("user bug")):
            df.to_pandas()
    s.stop()
    (app,) = load_logs(str(tmp_path))
    failed = [q for q in app.queries if q.recovery]
    assert [(r["action"], r["fault"]) for q in failed
            for r in q.recovery] == [("retry", "io_read")]
    assert failed[0].status.startswith("failed: InjectedReaderFault")
    fatal = [q for q in app.queries if q.fatal]
    assert len(fatal) == 1 and "user bug" in fatal[0].fatal["error"]
    assert [q.status for q in app.queries].count("success") == 1
