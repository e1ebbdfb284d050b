"""The PyTorch port's joins, sort and TopN against the JAX package's, on
the CPU.

The same numpy-seeded tables go through the JAX engine's ``TpuSession``
and the port's ``TpuSession(device="cpu")``.  Joins, sorts and TopN move
rows without arithmetic, so the collected frames must be equal row for
row and bit for bit, with the hash path on and off.  The ops-level test
holds the port's two phase-A formulations against each other and against
the JAX package's.
"""

import datetime

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.exec.fusion import fusion_metrics as jax_fusion
from spark_rapids_tpu.ops import joins as JJ
from spark_rapids_tpu.ops.expressions import ColVal as JaxColVal
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.exec.fusion import fusion_metrics
from spark_rapids_tpu_torch.columnar.dtypes import INT64
from spark_rapids_tpu_torch.ops import joins as TJ
from spark_rapids_tpu_torch.ops.expressions import ColVal

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one host: keep this module's
    torch ops on one thread so they do not crowd the other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


HASH_ON = {"spark.rapids.tpu.pallas.hash.enabled": True,
           "spark.rapids.tpu.pallas.hash.tableSlots": 4096}
JOIN_TYPES = ["inner", "left", "right", "full", "semi", "anti"]


def _run(conf, build, *tables):
    """``build(F, *dataframes)`` through both engines: (port, jax)."""
    js = JaxSession(conf)
    try:
        want = build(JF, *[js.create_dataframe(t) for t in tables]) \
            .to_pandas()
    finally:
        js.stop()
    ts = TpuSession(conf, device="cpu")
    got = build(TF, *[ts.create_dataframe(t) for t in tables]).to_pandas()
    return got, want


def _same(got, want):
    pd.testing.assert_frame_equal(got, want, check_dtype=True,
                                  check_exact=True)


def _keyed(n, kmax, seed, null_every=9, name="v"):
    rng = np.random.default_rng(seed)
    k = [int(x) for x in rng.integers(0, kmax, n)]
    for i in range(0, n, null_every):
        k[i] = None
    return {"k": k, name: rng.normal(size=n).round(3)}


@pytest.mark.parametrize("conf", [{}, HASH_ON], ids=["sort", "hash"])
@pytest.mark.parametrize("how", JOIN_TYPES)
def test_join_types_match_jax(how, conf):
    left = _keyed(300, 50, 3, name="lv")
    right = _keyed(200, 50, 4, null_every=7, name="rv")
    got, want = _run(conf, lambda F, l, r: l.join(r, on="k", how=how),
                     left, right)
    _same(got, want)
    assert len(got) > 0


def test_cross_join_matches_jax():
    left = {"a": np.arange(5, dtype=np.int64)}
    right = {"b": [1.5, None, -2.0], "s": ["x", None, "zz"]}
    got, want = _run({"spark.rapids.sql.join.outputBatchRows": 4},
                     lambda F, l, r: l.crossJoin(r), left, right)
    _same(got, want)
    assert len(got) == 15


def _float_keys(seed):
    rng = np.random.default_rng(seed)
    k = list(rng.normal(size=120).round(0))
    for i in range(0, 120, 10):
        k[i] = float("nan")
    for i in range(3, 120, 11):
        k[i] = -0.0
    for i in range(5, 120, 13):
        k[i] = 0.0
    for i in range(7, 120, 17):
        k[i] = None
    return k


KEY_KINDS = {
    "float_nan_negzero_null": lambda s: _float_keys(s),
    "bool_null": lambda s: [None if i % 7 == 0 else bool(x) for i, x in
                            enumerate(np.random.default_rng(s)
                                      .integers(0, 2, 120))],
    "date_null": lambda s: [None if i % 8 == 0 else
                            datetime.date(1995, 1, 1)
                            + datetime.timedelta(days=int(x))
                            for i, x in enumerate(np.random.default_rng(s)
                                                  .integers(0, 40, 120))],
    "int32": lambda s: np.random.default_rng(s).integers(
        -30, 30, 120).astype(np.int32),
}


@pytest.mark.parametrize("conf", [{}, HASH_ON], ids=["sort", "hash"])
@pytest.mark.parametrize("kind", list(KEY_KINDS))
def test_key_kinds_match_jax(kind, conf):
    """-0.0 joins 0.0, NaN joins NaN, null never matches."""
    left = {"k": KEY_KINDS[kind](1), "lv": np.arange(120)}
    right = {"k": KEY_KINDS[kind](2)[:90], "rv": np.arange(90) * 10}
    if kind.startswith("date"):
        # through pandas and arrow: date32 with nulls in both engines
        left, right = pd.DataFrame(left), pd.DataFrame(right)
    for how in ("inner", "full"):
        got, want = _run(conf, lambda F, l, r: l.join(r, on="k", how=how),
                         left, right)
        _same(got, want)


@pytest.mark.parametrize("conf", [{}, HASH_ON], ids=["sort", "hash"])
def test_multi_key_and_duplicate_build_keys(conf):
    rng = np.random.default_rng(9)
    left = {"a": rng.integers(0, 5, 60), "b": rng.integers(0, 5, 60),
            "lv": np.arange(60)}
    right = {"a": rng.integers(0, 5, 40), "b": rng.integers(0, 5, 40),
             "rv": np.arange(40)}
    got, want = _run(conf, lambda F, l, r: l.join(r, on=["a", "b"],
                                                  how="left"), left, right)
    _same(got, want)
    dup_l = {"k": [1, 1, 2, 3], "lv": [10, 11, 20, 30]}
    dup_r = {"k": [1, 1, 1, 2, 2], "rv": [5, 6, 7, 8, 9]}
    got, want = _run(conf, lambda F, l, r: l.join(r, on="k"), dup_l, dup_r)
    _same(got, want)
    assert len(got) == 8  # 2 * 3 + 1 * 2


@pytest.mark.parametrize("how", ["inner", "left", "full"])
def test_chunked_output(how):
    """outputBatchRows cuts the joined rows into chunks; the frame stays
    the same and the port emits ceil(total / chunk) batches per probe
    batch."""
    left = _keyed(300, 20, 5, name="lv")
    right = _keyed(100, 20, 6, name="rv")
    conf = {"spark.rapids.sql.join.outputBatchRows": 37}
    got, want = _run(conf, lambda F, l, r: l.join(r, on="k", how=how),
                     left, right)
    _same(got, want)
    s = TpuSession(conf, device="cpu")
    df = s.create_dataframe(left).join(s.create_dataframe(right), on="k",
                                       how=how)
    batches = df._execute_batches()
    assert max(b.nrows for b in batches) <= 37
    assert len(batches) >= len(got) // 37


def test_join_through_filters_and_renames():
    """A filtered probe side, a renamed build key, and a second join."""
    rng = np.random.default_rng(17)
    a = {"id": np.arange(200), "x": rng.integers(0, 9, 200)}
    b = {"aid": rng.integers(0, 220, 300), "y": rng.normal(size=300)}
    c = {"x": np.arange(9), "z": np.arange(9) * 1.5}

    def q(F, a, b, c):
        return (a.filter(F.col("x") > 2)
                .join(b.withColumnRenamed("aid", "id"), on="id")
                .join(c, on="x", how="left"))
    for conf in ({}, HASH_ON):
        got, want = _run(conf, q, a, b, c)
        _same(got, want)


# -------------------------------------------------------- fact ⋈ dim shape --

def _fact_dim(n_fact=1 << 14, n_dim=1 << 10, seed=11):
    """The repo's hash-join shape (tests/test_hash_wire.py), scaled: dim
    holds every second of 2 * n_dim distinct keys from [0, 2^40), fact
    draws from all of them, so about half the fact rows match."""
    rng = np.random.default_rng(seed)
    uni = np.unique(rng.integers(0, 1 << 40, 8 * n_dim,
                                 dtype=np.int64))[: 2 * n_dim]
    fact = {"k": uni[rng.integers(0, len(uni), n_fact)],
            "v": rng.integers(0, 10 ** 4, n_fact).astype(np.float64)}
    dim = {"k": uni[::2],
           "w": rng.integers(0, 100, len(uni[::2])).astype(np.float64)}
    return fact, dim


def _fact_dim_query(F, fact, dim):
    return (fact.join(dim, on="k").group_by("k")
            .agg(F.sum(F.col("v")).alias("sv"),
                 F.sum(F.col("w")).alias("sw")))


def test_fact_dim_hash_join_bit_identical():
    fact, dim = _fact_dim()
    got_off, want_off = _run({}, _fact_dim_query, fact, dim)
    fusion_metrics.reset()
    jax_fusion.reset()
    got_on, want_on = _run(HASH_ON, _fact_dim_query, fact, dim)
    port_m, jax_m = fusion_metrics.snapshot(), jax_fusion.snapshot()
    for f in (got_on, want_on, want_off):
        _same(got_off, f)
    # one probe batch: the join's hash phase A plus the group-by's update
    # and merge stages, in both engines
    assert port_m["hashKernelLaunches"] == jax_m["hashKernelLaunches"] == 3
    assert port_m["hashOverflowFallbacks"] == 0
    hit = np.isin(fact["k"], dim["k"])
    k, inv = np.unique(fact["k"][hit], return_inverse=True)
    assert got_on["k"].tolist() == k.tolist()
    np.testing.assert_array_equal(got_on["sv"].to_numpy(),
                                  np.bincount(inv, weights=fact["v"][hit]))
    # the port cuts the scan into 4096-row batches: one hash phase A per
    # probe batch, and the same answer
    small = dict(HASH_ON, **{"spark.rapids.sql.tpu.maxBatchRows": 4096})
    s = TpuSession(small, device="cpu")
    fusion_metrics.reset()
    got = _fact_dim_query(TF, s.create_dataframe(fact),
                          s.create_dataframe(dim)).to_pandas()
    _same(got, got_off)
    m = fusion_metrics.snapshot()
    assert m["hashKernelLaunches"] >= 4 + 1 and \
        m["hashOverflowFallbacks"] == 0, m


def test_hash_join_gate_and_overflow_fallback(monkeypatch):
    """The gate admits a build of at most 2^19 (bucketed) rows and one key
    column; a table overflow discards the hash output, is counted, and
    the sort merge gives the same answer."""
    assert TJ.hash_join_eligible([None], [None], 1 << 19)
    assert not TJ.hash_join_eligible([None], [None], (1 << 19) + 1)
    assert not TJ.hash_join_eligible([None, None], [None, None], 64)
    fact, dim = _fact_dim(n_fact=4000, n_dim=1 << 10)
    _, want = _run({}, _fact_dim_query, fact, dim)
    # 1024 build keys cannot fit a 64-slot table
    monkeypatch.setattr(TJ, "hash_join_table_slots", lambda b_cap: 64)
    s = TpuSession(HASH_ON, device="cpu")
    fusion_metrics.reset()
    got = _fact_dim_query(TF, s.create_dataframe(fact),
                          s.create_dataframe(dim)).to_pandas()
    m = fusion_metrics.snapshot()
    assert m["hashOverflowFallbacks"] >= 1, m
    _same(got, want)


# ------------------------------------------------------------ phase A / B --

def _phase_inputs(seed, n_build=300, n_probe=500, kind="int"):
    rng = np.random.default_rng(seed)
    if kind == "int":
        b = rng.integers(-40, 40, n_build).astype(np.int64)
        p = rng.integers(-50, 50, n_probe).astype(np.int64)
    else:
        b = rng.normal(size=n_build).round(0)
        p = rng.normal(size=n_probe).round(0)
        b[::9], p[::7] = -0.0, -0.0
        b[::13], p[::11] = np.nan, np.nan
    bv = rng.random(n_build) > 0.1
    pv = rng.random(n_probe) > 0.1
    return b, bv, p, pv


@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("outer", [False, True])
def test_phase_a_paths_give_identical_gather_indices(kind, outer):
    """join_match and hash_join_match feed phase B the same mapping in the
    port, and it equals the JAX package's."""
    b, bv, p, pv = _phase_inputs(23, kind=kind)
    b_n, p_n = len(b) - 20, len(p) - 30      # padding rows at the end
    tk = lambda v, ok: [ColVal(INT64, torch.from_numpy(v),  # noqa: E731
                               torch.from_numpy(ok))]
    jk = lambda v, ok: [JaxColVal(INT64, jnp.asarray(v),  # noqa: E731
                                  jnp.asarray(ok))]
    T = TJ.hash_join_table_slots(len(b))
    ms = [TJ.join_match(tk(b, bv), tk(p, pv), b_n, p_n),
          TJ.hash_join_match(tk(b, bv), tk(p, pv), b_n, p_n, T)]
    assert not bool(ms[1].pop("overflow"))
    jm = JJ.join_match(jk(b, bv), jk(p, pv), jnp.int32(b_n),
                       jnp.int32(p_n))
    outs = []
    for m in ms:
        _, starts, ends, total = TJ.join_out_starts(m["probe_count"], p_n,
                                                    outer)
        total = int(total)
        outs.append([x.numpy() for x in TJ.join_gather_indices(
            starts, ends, m["probe_count"], m["probe_bstart"],
            m["sorted_to_build"], total, total)])
        np.testing.assert_array_equal(m["build_matched"].numpy(),
                                      ms[0]["build_matched"].numpy())
    _, js, je, jt = JJ.join_out_starts(jm["probe_count"], jnp.int32(p_n),
                                       outer)
    want = [np.asarray(x) for x in JJ.join_gather_indices(
        js, je, jm["probe_count"], jm["probe_bstart"],
        jm["sorted_to_build"], jt, int(jt))]
    assert int(jt) == total > 0

    def defined(out):
        # the build row of an unmatched (outer) output row is unspecified
        p_row, brow, matched, in_range = out
        return p_row, np.where(matched, brow, -1), matched, in_range
    for got in outs:
        for g, w in zip(defined(got), defined(want)):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(ms[0]["probe_count"].numpy(),
                                  np.asarray(jm["probe_count"]))
    np.testing.assert_array_equal(ms[0]["build_matched"].numpy(),
                                  np.asarray(jm["build_matched"]))


# ---------------------------------------------------------------- sort/TopN --

def _sort_table():
    rng = np.random.default_rng(31)
    n = 400
    f = list(rng.normal(size=n).round(1))
    for i in range(0, n, 17):
        f[i] = float("nan")
    for i in range(3, n, 19):
        f[i] = -0.0
    for i in range(5, n, 23):
        f[i] = None
    d = [datetime.date(1994, 1, 1) + datetime.timedelta(days=int(x))
         for x in rng.integers(0, 30, n)]
    g = [None if i % 31 == 0 else int(x)
         for i, x in enumerate(rng.integers(0, 5, n))]
    return {"f": f, "d": d, "g": g, "i": np.arange(n)}


SORTS = {
    "asc_default": lambda F: [F.col("f")],
    "desc_default": lambda F: [F.col("f").desc()],
    "asc_nulls_last": lambda F: [F.col("f").asc_nulls_last()],
    "desc_nulls_first": lambda F: [F.col("f").desc_nulls_first()],
    "date_desc_then_float": lambda F: [F.col("d").desc(), F.col("f")],
    "int_then_date_nulls_last": lambda F: [F.col("g"),
                                           F.col("d").asc_nulls_last()],
}


@pytest.mark.parametrize("name", list(SORTS))
def test_sort_matches_jax(name):
    got, want = _run({}, lambda F, t: t.orderBy(*SORTS[name](F)),
                     _sort_table())
    _same(got, want)


def test_sort_dates_with_nulls_matches_jax():
    rng = np.random.default_rng(37)
    pdf = pd.DataFrame({
        "d": [None if i % 9 == 0 else datetime.date(2000, 1, 1)
              + datetime.timedelta(days=int(x))
              for i, x in enumerate(rng.integers(-500, 500, 300))],
        "i": np.arange(300)})
    for keys in (lambda F: [F.col("d")], lambda F: [F.col("d").desc()],
                 lambda F: [F.col("d").asc_nulls_last()]):
        got, want = _run({}, lambda F, t: t.orderBy(*keys(F)), pdf)
        _same(got, want)


@pytest.mark.parametrize("name", ["desc_default", "date_desc_then_float",
                                  "asc_nulls_last"])
def test_topn_matches_jax(name):
    conf = {"spark.rapids.sql.tpu.maxBatchRows": 37}   # 11 batches
    got, want = _run(conf, lambda F, t: t.orderBy(*SORTS[name](F))
                     .limit(13), _sort_table())
    _same(got, want)
    s = TpuSession(conf, device="cpu")
    q = s.create_dataframe(_sort_table()).orderBy(
        *SORTS[name](TF)).limit(13)
    assert q.explain().splitlines()[0] == "TpuTopNExec[13]"


def test_limit_without_sort():
    t = {"x": np.arange(100), "s": [f"r{i}" for i in range(100)]}
    conf = {"spark.rapids.sql.tpu.maxBatchRows": 30}
    got, want = _run(conf, lambda F, t: t.limit(45), t)
    _same(got, want)
    assert got["x"].tolist() == list(range(45))
