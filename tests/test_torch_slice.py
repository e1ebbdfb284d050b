"""The PyTorch port's query path against the JAX package's, on the CPU.

The same numpy-seeded tables go through the JAX engine's ``TpuSession``
and the port's ``TpuSession(device="cpu")``: TPC-H q6, the q1-shaped
group-by, and the sparse-key hash group-by with the hash path on and off.
Tolerances: group keys, counts and integer-valued sums exactly; other
float sums to a relative 1e-12 (the port adds in another order).
"""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from bench import gen_host
from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.columnar.column import Column as JaxColumn
from spark_rapids_tpu.exec.fusion import fusion_metrics as jax_fusion
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.columnar.dtypes import FLOAT64 as DOUBLE
from spark_rapids_tpu_torch.exec.fusion import fusion_metrics
from spark_rapids_tpu_torch.interop import batch_from_arrays
from spark_rapids_tpu_torch.ops.expressions import ColVal, UnaryExpression

N = 1 << 14
RTOL = 1e-12
HASH_ON = {"spark.rapids.tpu.pallas.hash.enabled": True,
           "spark.rapids.tpu.pallas.hash.tableSlots": 4096}


def _q6(F, df):
    return df.filter(
        (F.col("l_shipdate") >= 9131) & (F.col("l_shipdate") < 9496) &
        (F.col("l_discount") >= 0.05) & (F.col("l_discount") <= 0.07) &
        (F.col("l_quantity") < 24.0)
    ).select((F.col("l_extendedprice") * F.col("l_discount"))
             .alias("rev")).agg(F.sum("rev").alias("revenue"))


def _q1(F, df):
    return (df.filter(F.col("l_shipdate") <= 10471)
            .groupBy("l_returnflag_code", "l_linestatus_code")
            .agg(F.sum("l_quantity").alias("sum_qty"),
                 F.sum("l_extendedprice").alias("sum_base"),
                 F.sum((F.col("l_extendedprice") *
                        (F.lit(1.0) - F.col("l_discount")))
                       .alias("d")).alias("sum_disc"),
                 F.avg("l_discount").alias("avg_disc"),
                 F.count("l_quantity").alias("n")))


def _sparse_agg(F, df):
    return df.groupBy("k").agg(F.sum("v").alias("s"),
                               F.count("v").alias("n"))


def _jax(conf, build, data):
    s = JaxSession(conf)
    try:
        return build(JF, s.create_dataframe(data)).to_pandas()
    finally:
        s.stop()


def _port(conf, build, data):
    s = TpuSession(conf, device="cpu")
    try:
        return build(TF, s.create_dataframe(data)).to_pandas()
    finally:
        s.stop()


def _sorted(df, keys):
    # stable: a null key and a NaN key both read as NaN in pandas, and
    # both engines emit the null group first and the NaN group last
    return df.sort_values(keys, ignore_index=True, na_position="first",
                          kind="mergesort")


def _assert_frames(got, want, keys, exact=(), rtol=RTOL):
    """Keys and ``exact`` columns bit-equal, other columns to rtol."""
    assert list(got.columns) == list(want.columns)
    got, want = _sorted(got, keys), _sorted(want, keys)
    assert len(got) == len(want)
    for c in got.columns:
        a, b = got[c].to_numpy(), want[c].to_numpy()
        if c in keys or c in exact:
            pd.testing.assert_series_equal(got[c], want[c],
                                           check_dtype=False)
        else:
            np.testing.assert_allclose(a.astype(np.float64),
                                       b.astype(np.float64),
                                       rtol=rtol, atol=0, equal_nan=True)


@pytest.fixture(scope="module")
def lineitem():
    return gen_host(N, seed=42)


@pytest.fixture(scope="module")
def jax_q6(lineitem):
    return _jax({}, _q6, lineitem)


@pytest.fixture(scope="module")
def jax_q1(lineitem):
    return _jax({}, _q1, lineitem)


PORT_CONFS = {
    "default": {},
    "small_batches": {"spark.rapids.sql.tpu.maxBatchRows": 3000},
    "unfused": {"spark.rapids.tpu.fusion.enabled": False},
    "unfused_small_batches": {"spark.rapids.tpu.fusion.enabled": False,
                              "spark.rapids.sql.tpu.maxBatchRows": 3000},
}


@pytest.mark.parametrize("conf", list(PORT_CONFS))
def test_q6_matches_jax(lineitem, jax_q6, conf):
    got = _port(PORT_CONFS[conf], _q6, lineitem)
    assert list(got.columns) == ["revenue"] and len(got) == 1
    np.testing.assert_allclose(got["revenue"][0], jax_q6["revenue"][0],
                               rtol=RTOL, atol=0)


@pytest.mark.parametrize("conf", list(PORT_CONFS))
def test_q1_matches_jax(lineitem, jax_q1, conf):
    got = _port(PORT_CONFS[conf], _q1, lineitem)
    assert len(got) == 6
    _assert_frames(got, jax_q1, ["l_returnflag_code", "l_linestatus_code"],
                   exact=["n"])


def test_q1_keyless_empty_input_is_one_null_row(lineitem):
    def none_pass(F, df):
        return df.filter(F.col("l_shipdate") < 0).agg(
            F.sum("l_quantity").alias("s"), F.count("l_quantity").alias("c"))
    got = _port({}, none_pass, lineitem)
    want = _jax({}, none_pass, lineitem)
    assert got["c"].tolist() == want["c"].tolist() == [0]
    assert got["s"].isna().all() and want["s"].isna().all()


def _sparse(n=N, card=1 << 10, seed=7):
    rng = np.random.default_rng(seed)
    uni = np.unique(rng.integers(0, 1 << 40, 4 * card,
                                 dtype=np.int64))[:card]
    return {"k": uni[rng.integers(0, len(uni), n)],
            "v": rng.integers(0, 1000, n).astype(np.float64)}


def test_sparse_hash_groupby_bit_identical():
    data = _sparse()
    want = _jax({}, _sparse_agg, data)
    want_on = _jax(HASH_ON, _sparse_agg, data)
    fusion_metrics.reset()
    got_off = _port({}, _sparse_agg, data)
    assert fusion_metrics.snapshot()["hashKernelLaunches"] == 0
    got_on = _port(HASH_ON, _sparse_agg, data)
    m = fusion_metrics.snapshot()
    assert m["hashKernelLaunches"] >= 2, m  # update and merge stages
    assert m["hashOverflowFallbacks"] == 0, m
    for got in (got_off, got_on, want_on):
        _assert_frames(got, want, ["k"], exact=["s", "n"])


def test_hash_overflow_falls_back_exactly():
    data = _sparse()
    conf = {"spark.rapids.tpu.pallas.hash.enabled": True,
            "spark.rapids.tpu.pallas.hash.tableSlots": 64}
    want = _jax({}, _sparse_agg, data)
    jax_fusion.reset()
    want_ovf = _jax(conf, _sparse_agg, data)
    assert jax_fusion.snapshot()["hashOverflowFallbacks"] >= 1
    fusion_metrics.reset()
    got = _port(conf, _sparse_agg, data)
    m = fusion_metrics.snapshot()
    assert m["hashKernelLaunches"] >= 1, m
    assert m["hashOverflowFallbacks"] >= 1, m
    for g in (got, want_ovf):
        _assert_frames(g, want, ["k"], exact=["s", "n"])


def test_null_and_nan_float_keys_parity():
    """Float keys with NaN from pandas: arrow turns NaN into null in both
    engines; the sort path groups nulls together."""
    rng = np.random.default_rng(13)
    k = rng.normal(size=4000).round(1)
    k[::11] = np.nan
    k[::17] = -0.0
    pdf = pd.DataFrame({"k": k, "v": rng.normal(size=4000)})
    want = _jax({}, _sparse_agg, pdf)
    for conf in ({}, HASH_ON):
        _assert_frames(_port(conf, _sparse_agg, pdf), want, ["k"],
                       exact=["n"])


def _keyed_batches(keys, key_valid, vals):
    """One table with null keys for both engines."""
    jax_batch = JaxBatch({
        "k": JaxColumn.from_numpy(keys, validity=key_valid),
        "v": JaxColumn.from_numpy(vals)}, len(keys))
    port_batch = batch_from_arrays({
        "k": (str(keys.dtype), keys, key_valid),
        "v": ("double", vals, None)}, device="cpu")
    return jax_batch, port_batch


@pytest.mark.parametrize("key_space", ["dense", "sparse", "float_nan"])
def test_null_keys_through_each_path(key_space):
    """Null keys (digit 0 of the radix code) through the coded, hashed and
    sort paths; NaN values (not nulls) group as one key."""
    rng = np.random.default_rng(21)
    n = 5000
    if key_space == "dense":
        keys = rng.integers(-50, 50, n).astype(np.int64)
    elif key_space == "sparse":
        keys = rng.integers(0, 1 << 40, 300, dtype=np.int64)[
            rng.integers(0, 300, n)]
    else:
        keys = rng.normal(size=n).round(1)
        keys[::13] = np.nan
        keys[::19] = -0.0
    key_valid = rng.random(n) > 0.1
    vals = rng.integers(0, 100, n).astype(np.float64)
    jax_batch, port_batch = _keyed_batches(keys, key_valid, vals)
    s = JaxSession({})
    try:
        want = _sparse_agg(JF, s.create_dataframe(jax_batch)).to_pandas()
    finally:
        s.stop()
    for conf in ({}, HASH_ON):
        p = TpuSession(conf, device="cpu")
        got = _sparse_agg(TF, p.create_dataframe(port_batch)).to_pandas()
        _assert_frames(got, want, ["k"], exact=["s", "n"])
    # one null group, plus one NaN group for float keys
    assert got["k"].isna().sum() == (2 if key_space == "float_nan" else 1)


# ------------------------------------------------------------------ guards --

def test_port_imports_no_jax():
    """Importing every module of the port loads neither jax nor any module
    of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import spark_rapids_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'spark_rapids_tpu' or m.startswith('spark_rapids_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules"
        " if m.startswith('spark_rapids_tpu_torch')]))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_session_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TpuSession()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TpuSession({}, device="cuda")
    assert TpuSession({}, device="cpu").device.type == "cpu"


def test_unknown_rapids_key_rejected():
    with pytest.raises(ValueError, match="unknown configuration key"):
        TpuSession({"spark.rapids.sql.not.a.key": 1}, device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        TpuSession({"spark.rapids.tpu.pallas.hash.tableSlots": 100},
                   device="cpu")


# ------------------------------------------- expressions and aggregates --

def _mixed_table(n=3000, seed=31):
    """Columns with nulls, NaN, -0.0 and zeros, as (values, validity)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=n).round(1)
    a[::23] = np.nan
    a[::29] = -0.0
    b = rng.integers(-3, 4, n).astype(np.float64)   # zeros for x / 0
    i = rng.integers(-1000, 1000, n).astype(np.int32)
    g = rng.integers(0, 5, n).astype(np.int64)
    return {"a": (a, rng.random(n) > 0.1), "b": (b, rng.random(n) > 0.2),
            "i": (i, rng.random(n) > 0.15), "g": (g, None)}


def _both(cols):
    jax_batch = JaxBatch({name: JaxColumn.from_numpy(v, validity=ok)
                          for name, (v, ok) in cols.items()},
                         len(next(iter(cols.values()))[0]))
    port_batch = batch_from_arrays(
        {name: (str(v.dtype), v, ok) for name, (v, ok) in cols.items()},
        device="cpu")
    return jax_batch, port_batch


EXPRS = {
    "add": lambda F: F.col("a") + F.col("b"),
    "sub_int_lit": lambda F: F.col("i") - 7,
    "mul_float_lit": lambda F: F.col("i") * 0.5,
    "div_by_zero_is_null": lambda F: F.col("a") / F.col("b"),
    "lt_nan": lambda F: F.col("a") < F.col("b"),
    "le_nan": lambda F: F.col("a") <= 0.0,
    "gt_nan": lambda F: F.col("a") > F.col("b"),
    "ge_int": lambda F: F.col("i") >= 10,
    "eq_nan_zero": lambda F: F.col("a") == 0.0,
    "kleene_and": lambda F: (F.col("a") > 0) & (F.col("b") > 0),
    "kleene_or": lambda F: (F.col("a") > 0) | (F.col("b") > 0),
    "not": lambda F: ~(F.col("i") > 0),
    "is_null": lambda F: F.col("a").isNull(),
    "is_not_null": lambda F: F.col("b").isNotNull(),
    "between": lambda F: F.col("i").between(-100, 100),
}


@pytest.mark.parametrize("name", list(EXPRS))
def test_expression_matches_jax(name):
    jax_batch, port_batch = _both(_mixed_table())
    s = JaxSession({})
    try:
        want = s.create_dataframe(jax_batch).select(
            EXPRS[name](JF).alias("x")).to_pandas()
    finally:
        s.stop()
    got = TpuSession({}, device="cpu").create_dataframe(port_batch).select(
        EXPRS[name](TF).alias("x")).to_pandas()
    pd.testing.assert_frame_equal(got, want, check_dtype=True)


def _aggs(F):
    return [F.sum("a").alias("sa"), F.sum("i").alias("si"),
            F.min("a").alias("mna"), F.max("i").alias("mxi"),
            F.avg("b").alias("ab"), F.count("*").alias("c"),
            F.count("i").alias("ci")]


@pytest.mark.parametrize("grouped", [False, True])
def test_aggregate_functions_match_jax(grouped):
    jax_batch, port_batch = _both(_mixed_table())

    def run(F, df):
        if grouped:
            return df.groupBy("g").agg(*_aggs(F))
        return df.agg(*_aggs(F))
    s = JaxSession({})
    try:
        want = run(JF, s.create_dataframe(jax_batch)).to_pandas()
    finally:
        s.stop()
    for conf in PORT_CONFS.values():
        got = run(TF, TpuSession(conf, device="cpu")
                  .create_dataframe(port_batch)).to_pandas()
        _assert_frames(got, want, ["g"] if grouped else [],
                       exact=["si", "mxi", "c", "ci"])


def test_coalesce_batches_exec():
    from spark_rapids_tpu_torch.exec.basic import (
        TpuCoalesceBatchesExec, TpuScanExec)
    data = {"x": np.arange(10_000, dtype=np.int64)}
    s = TpuSession({}, device="cpu")
    batch = s.create_dataframe(data).plan.batches[0]
    scan = TpuScanExec([batch], batch.schema, max_rows=1000)
    out = list(TpuCoalesceBatchesExec(scan, goal_rows=3000).execute())
    assert [b.nrows for b in out] == [3000, 3000, 3000, 1000]
    got = np.concatenate([b.to_pandas()["x"].to_numpy() for b in out])
    np.testing.assert_array_equal(got, data["x"])


def test_plan_shapes_follow_fusion_switch(lineitem):
    s = TpuSession({}, device="cpu")
    df = s.create_dataframe(lineitem)
    fused = _q6(TF, df).explain()
    assert fused.splitlines()[0].startswith("TpuHashAggregateExec")
    assert "fused filter" in fused and "TpuScanExec" in fused
    assert "TpuFilterExec" not in fused
    chain = df.filter(TF.col("l_quantity") < 24.0).select(
        (TF.col("l_tax") * 2.0).alias("t")).explain()
    assert chain.splitlines()[0].startswith("FusedStageExec[Project+Filter")
    off = TpuSession({"spark.rapids.tpu.fusion.enabled": False},
                     device="cpu")
    unfused = _q6(TF, off.create_dataframe(lineitem)).explain()
    for op in ("TpuHashAggregateExec", "TpuProjectExec", "TpuFilterExec",
               "TpuScanExec"):
        assert op in unfused
    assert "fused filter" not in unfused


def test_q6_host_syncs_do_not_grow_with_batches(lineitem):
    """The keyless path keeps every partial on the device: one counted
    fetch per query (the result), however many batches."""
    from spark_rapids_tpu_torch.utils.hostsync import host_sync_metrics
    for rows in (1 << 22, 1000):
        s = TpuSession({"spark.rapids.sql.tpu.maxBatchRows": rows},
                       device="cpu")
        q = _q6(TF, s.create_dataframe(lineitem))
        host_sync_metrics.reset()
        q.to_pandas()
        assert host_sync_metrics.snapshot() == 1


class _CheckedRecip(UnaryExpression):
    """1 / x that records a check for x == 0 (an ANSI-style failure) over
    the rows the context may report: the check-mask channel."""

    @property
    def dtype(self):
        return DOUBLE

    def emit(self, ctx):
        c = self.child.emit(ctx)
        ctx.add_check("division by zero",
                      ((c.values == 0) & ctx.check_mask()).any())
        return ColVal(DOUBLE, 1.0 / c.values, c.validity)


@pytest.mark.parametrize("fusion", [True, False])
def test_check_masking_follows_filter_order(fusion):
    """A check fires only for rows the filters below it kept, fused or
    not; without the guarding filter it fires."""
    data = {"b": np.array([0.0, 2.0, 0.0, 4.0]),
            "v": np.array([1.0, 2.0, 3.0, 4.0])}
    s = TpuSession({"spark.rapids.tpu.fusion.enabled": fusion},
                   device="cpu")
    df = s.create_dataframe(data)
    recip = TF.Col(_CheckedRecip(TF.col("b").expr))
    guarded = df.filter(TF.col("b") != 0.0).filter(recip > 0.3)
    assert guarded.agg(TF.sum("v").alias("s")).collect() == [(2.0,)]
    assert guarded.select(TF.col("v")).collect() == [(2.0,)]
    with pytest.raises(ArithmeticError, match="division by zero"):
        df.filter(recip > 0.3).agg(TF.sum("v").alias("s")).collect()


# ----------------------------------------------- BOOLEAN and string min/max --

BOOLS = {"a": [True, False, None, False, None],
         "g": [1, 1, 2, None, 3]}


def _bool_minmax(grouped):
    def build(F, df):
        aggs = [F.max("a").alias("mx"), F.min("a").alias("mn"),
                F.count("a").alias("n")]
        if grouped:
            return df.groupBy("g").agg(*aggs).orderBy("g")
        return df.agg(*aggs)
    return build


BOOL_CONFS = {
    "default": {},
    "hash": HASH_ON,
    "unfused_batches_of_2": {"spark.rapids.tpu.fusion.enabled": False,
                             "spark.rapids.sql.tpu.maxBatchRows": 2},
    "shards_8": {"spark.rapids.sql.distributed.numShards": 8},
}


@pytest.mark.parametrize("conf", list(BOOL_CONFS))
@pytest.mark.parametrize("grouped", [False, True])
def test_boolean_min_max_match_jax(grouped, conf):
    """max True and min False over [True, False, None, False, None];
    grouped, the group whose rows are all null stays null, and so does
    the null group's."""
    build = _bool_minmax(grouped)
    want = _jax({}, build, BOOLS)
    s = TpuSession(BOOL_CONFS[conf], device="cpu")
    got = build(TF, s.create_dataframe(BOOLS)).to_pandas()
    if conf == "shards_8":
        assert s.last_dist_explain == "distributed"
    pd.testing.assert_frame_equal(got, want)
    if not grouped:
        assert got.iloc[0].tolist() == [True, False, 3]


@pytest.mark.parametrize("conf", ["default", "hash", "small_batches"])
def test_string_min_max_matches_jax(conf):
    """min "a" and max "c" over ["b", "a", "c"] (with a null), keyless
    and grouped."""
    data = {"s": ["b", None, "a", "c", "ab"], "g": [1, 2, 1, 1, 2]}

    def build(F, df):
        return df.agg(F.min("s").alias("mn"), F.max("s").alias("mx"))

    def grouped(F, df):
        return df.groupBy("g").agg(F.min("s").alias("mn"),
                                   F.max("s").alias("mx")).orderBy("g")
    conf = {**PORT_CONFS, "hash": HASH_ON}[conf]
    for b in (build, grouped):
        got = _port(conf, b, data)
        pd.testing.assert_frame_equal(got, _jax({}, b, data))
    assert _port(conf, build, data).iloc[0].tolist() == ["a", "c"]


@pytest.mark.parametrize("n,size,k", [(1, 3, 1), (5, 3, 2), (256, 4, 1),
                                      (257, 4, 2), (70_000, 7, 2),
                                      (70_000, 60_000, 1),
                                      (300_000, 5, 3)])
def test_fixed_order_sums_match_index_add(n, size, k):
    """The fixed-order float sums equal ``index_add_``'s (another order:
    rtol 1e-12), with the same bits on a second run; runs crossing many
    256-row scan blocks included."""
    from spark_rapids_tpu_torch.ops.aggregates import fixed_order_sums
    rng = np.random.default_rng(n + size)
    idx = torch.from_numpy(rng.integers(0, size, n))
    v = torch.from_numpy(rng.normal(size=(n, k)) * 1e3)
    if k == 1:
        v = v[:, 0]
    got = fixed_order_sums(idx, v, size)
    want = torch.zeros_like(got).index_add_(0, idx, v)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-9)
    assert torch.equal(got, fixed_order_sums(idx, v, size))


@pytest.mark.parametrize("batch_rows", [1 << 22, 4096])
def test_hash_group_by_sums_do_not_depend_on_slots(monkeypatch,
                                                   batch_rows):
    """The hash group-by's float sums have the same bits whichever slot
    each key takes (on the card two colliding keys claim slots in either
    order from run to run), and equal the sort path's bit for bit: rows
    reduce into their group's rank in key order, not into their slot."""
    from spark_rapids_tpu_torch.ops import kernels
    rng = np.random.default_rng(3)
    n = 20_000
    pool = rng.integers(0, 1 << 40, 3000)
    data = {"k": pool[rng.integers(0, 3000, n)],
            "v": rng.normal(size=n) * 10.0 ** rng.integers(-3, 6, n)}

    def run(hash_on):
        s = TpuSession({"spark.rapids.tpu.pallas.hash.enabled": hash_on,
                        "spark.rapids.tpu.pallas.hash.tableSlots": 1 << 13,
                        "spark.rapids.sql.tpu.maxBatchRows": batch_rows},
                       device="cpu")
        return s.create_dataframe(data).groupBy("k").agg(
            TF.sum("v").alias("s"), TF.avg("v").alias("a")).to_pandas()

    before = fusion_metrics.snapshot()["hashKernelLaunches"]
    plain = run(True)
    assert fusion_metrics.snapshot()["hashKernelLaunches"] > before
    orig = kernels.hash_insert

    def moved(lo, hi, live, T):
        """The plain insert with every slot moved to another place."""
        slot, tlo, thi, occ, ovf = orig(lo, hi, live, T)
        perm = torch.from_numpy(np.random.default_rng(9).permutation(T))
        out = []
        for t in (tlo, thi, occ):
            m = torch.empty_like(t)
            m[perm] = t
            out.append(m)
        slot = torch.where(slot < T, perm[slot.clamp(max=T - 1)].to(
            slot.dtype), slot)
        return (slot, *out, ovf)

    monkeypatch.setattr(kernels, "hash_insert", moved)
    assert run(True).equals(plain)
    monkeypatch.setattr(kernels, "hash_insert", orig)
    assert run(False).equals(plain)
