"""The PyTorch port's sharded query path against the JAX package's, on the
CPU.

Operator level: ``DistributedAggregate`` and ``DistributedHashJoin`` on
``LocalShards(8, "cpu")`` against the JAX classes on ``make_mesh(8)``
(the virtual 8-device CPU mesh), over the same per-shard inputs.  Query
level: q6, the q1 shape, the sparse-key group-by, fact-dim joins and
``orderBy`` / TopN through a port session with
``spark.rapids.sql.distributed.numShards = 8`` against the JAX session on
``make_mesh(8)``.  One test runs a real two-rank gloo process group.

The JAX operators run under a session with
``spark.rapids.tpu.shuffle.slot.mode = fixed``: in the default adaptive
mode a warm exchange site launches speculatively and skips the stats pass
whose histograms these tests compare.

Tolerances: bucket and partition histograms, the bucket->shard map, group
keys, counts, integer-valued sums and join rows exactly; other float sums
to a relative 1e-12 (the port adds in another order).
"""

import os
import pickle

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from bench import gen_host
from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.columnar import dtypes as jdts
from spark_rapids_tpu.ops import aggregates as jagg
from spark_rapids_tpu.ops import predicates as JPR
from spark_rapids_tpu.ops.arithmetic import Multiply as JMul
from spark_rapids_tpu.ops.expressions import BoundReference as JRef
from spark_rapids_tpu.ops.expressions import Literal as JLit
from spark_rapids_tpu.parallel.distributed import (
    DistributedAggregate as JaxAggregate, DistributedHashJoin as JaxJoin)
from spark_rapids_tpu.parallel.mesh import make_mesh as jax_make_mesh
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.columnar import dtypes as tdts
from spark_rapids_tpu_torch.ops import aggregates as tagg
from spark_rapids_tpu_torch.ops import kernels as K
from spark_rapids_tpu_torch.ops import predicates as TPR
from spark_rapids_tpu_torch.ops.arithmetic import Multiply as TMul
from spark_rapids_tpu_torch.ops.expressions import BoundReference as TRef
from spark_rapids_tpu_torch.ops.expressions import ColVal
from spark_rapids_tpu_torch.ops.expressions import Literal as TLit
from spark_rapids_tpu_torch.parallel.distributed import (
    DistributedAggregate, DistributedHashJoin)
from spark_rapids_tpu_torch.parallel.mesh import LocalShards
from spark_rapids_tpu_torch.parallel.shuffle import shuffle_metrics

NSHARDS = 8
CAP = 256
RTOL = 1e-12
MESH_CONF = {"spark.rapids.sql.distributed.numShards": NSHARDS}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one host: keep this module's
    torch ops on one thread so they do not crowd the other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def mesh():
    return jax_make_mesh(NSHARDS)


@pytest.fixture
def fixed_slots():
    """The JAX operators read the active session's slot planner."""
    s = JaxSession({"spark.rapids.tpu.shuffle.slot.mode": "fixed"})
    yield s
    s.stop()


# ------------------------------------------------------- operator inputs --

def _jax_flat(values, validity=None):
    v = jnp.asarray(np.asarray(values).reshape(-1))
    ok = None if validity is None else \
        jnp.asarray(np.asarray(validity).reshape(-1))
    return v, ok


def _port_shards(columns, nrows):
    """columns: [(port dtype, values[NSHARDS, CAP], validity or None)]."""
    shards = []
    for s in range(NSHARDS):
        n = int(nrows[s])
        shards.append([ColVal(dt, torch.from_numpy(
            np.ascontiguousarray(v[s, :n])),
            None if ok is None else torch.from_numpy(
                np.ascontiguousarray(ok[s, :n])))
            for dt, v, ok in columns])
    return shards, [int(n) for n in nrows]


def _jax_shard(values, nrows, s):
    return np.asarray(values).reshape(NSHARDS, -1)[s, :int(nrows[s])]


def _agg_table(rng):
    keys = rng.integers(0, 20, (NSHARDS, CAP)).astype(np.int64)
    kval = rng.random((NSHARDS, CAP)) < 0.9
    vals = rng.normal(size=(NSHARDS, CAP)) * 100
    vok = rng.random((NSHARDS, CAP)) < 0.85
    ivals = rng.integers(-1000, 1000, (NSHARDS, CAP)).astype(np.int64)
    nrows = rng.integers(0, CAP, NSHARDS).astype(np.int32)
    nrows[3] = 0  # an empty shard
    return keys, kval, vals, vok, ivals, nrows


def _funcs(agg, Ref, dts, min_max: bool):
    v = Ref(1, dts.FLOAT64, name="v")
    iv = Ref(2, dts.INT64, name="iv")
    funcs = [agg.Sum(v), agg.Count(v), agg.Sum(iv), agg.Average(v)]
    if min_max:
        funcs += [agg.Min(v), agg.Max(iv)]
    return funcs


# ------------------------------------------------------------- aggregates --

@pytest.mark.parametrize("filtered", [False, True])
def test_keyless_aggregate_matches_jax(mesh, fixed_slots, filtered):
    rng = np.random.default_rng(11)
    _, _, vals, vok, ivals, nrows = _agg_table(rng)
    cond_j = JPR.GreaterThan(JRef(1, jdts.FLOAT64, name="v"),
                             JLit(0.0)) if filtered else None
    cond_t = TPR.GreaterThan(TRef(1, tdts.FLOAT64, name="v"),
                             TLit(0.0)) if filtered else None
    keys = np.zeros((NSHARDS, CAP), dtype=np.int64)
    jax_dist = JaxAggregate(
        mesh, [jdts.INT64, jdts.FLOAT64, jdts.INT64], [],
        _funcs(jagg, JRef, jdts, True), filter_cond=cond_j)
    outs = jax_dist([(*_jax_flat(keys), None),
                     (*_jax_flat(vals, vok), None),
                     (*_jax_flat(ivals), None)], jnp.asarray(nrows))
    group = LocalShards(NSHARDS, "cpu")
    shards, counts = _port_shards(
        [(tdts.INT64, keys, None), (tdts.FLOAT64, vals, vok),
         (tdts.INT64, ivals, None)], nrows)
    K.launches.reset()
    dist = DistributedAggregate(
        group, [tdts.INT64, tdts.FLOAT64, tdts.INT64], [],
        _funcs(tagg, TRef, tdts, True), filter_cond=cond_t)
    got, sizes = dist(shards, counts)
    assert sizes == [1] + [0] * (NSHARDS - 1)
    assert dist.last_stats == {"keyless": True}
    exact = {1, 2, 4, 5}  # count, integer sum, min, integer max
    for i, (jv, jok, _) in enumerate(outs):
        want_v = np.asarray(jv).reshape(NSHARDS, -1)[0, 0]
        want_ok = bool(np.asarray(jok).reshape(NSHARDS, -1)[0, 0])
        c = got[0][i]
        ok = True if c.validity is None else bool(c.validity[0])
        assert ok == want_ok
        if not ok:
            continue
        if i in exact:
            assert c.values[0].item() == want_v
        else:
            np.testing.assert_allclose(c.values[0].item(), want_v,
                                       rtol=RTOL, atol=0)


def _q6_shape(rng):
    price = rng.uniform(100, 1000, (NSHARDS, CAP))
    disc = rng.uniform(0, 0.1, (NSHARDS, CAP)).round(2)
    return price, disc, np.full(NSHARDS, CAP, dtype=np.int32)


def test_keyless_float_sums_take_the_reduce_kernel_path(mesh, fixed_slots):
    """The q6 shape: every buffer a float sum, so the per-shard reduce and
    the grand-total merge both go through ``masked_multi_reduce`` (its
    plain version on the CPU)."""
    price, disc, nrows = _q6_shape(np.random.default_rng(5))
    rev_j = jagg.Sum(JMul(JRef(0, jdts.FLOAT64, name="p"),
                          JRef(1, jdts.FLOAT64, name="d")))
    rev_t = tagg.Sum(TMul(TRef(0, tdts.FLOAT64, name="p"),
                          TRef(1, tdts.FLOAT64, name="d")))
    jd = JaxAggregate(mesh, [jdts.FLOAT64, jdts.FLOAT64], [], [rev_j],
                      filter_cond=JPR.GreaterThanOrEqual(
                          JRef(1, jdts.FLOAT64, name="d"), JLit(0.05)))
    want = np.asarray(jd([(*_jax_flat(price), None),
                          (*_jax_flat(disc), None)],
                         jnp.asarray(nrows))[0][0]).reshape(NSHARDS, -1)
    shards, counts = _port_shards([(tdts.FLOAT64, price, None),
                                   (tdts.FLOAT64, disc, None)], nrows)
    calls = []
    real = K.masked_multi_reduce_plain

    def spy(*a):
        calls.append(len(a[2]))
        return real(*a)

    K.masked_multi_reduce_plain = spy
    try:
        td = DistributedAggregate(
            LocalShards(NSHARDS, "cpu"), [tdts.FLOAT64, tdts.FLOAT64], [],
            [rev_t], filter_cond=TPR.GreaterThanOrEqual(
                TRef(1, tdts.FLOAT64, name="d"), TLit(0.05)))
        got, _ = td(shards, counts)
    finally:
        K.masked_multi_reduce_plain = real
    # one reduce per shard, then the merge over the eight partials
    assert calls == [CAP] * NSHARDS + [NSHARDS]
    np.testing.assert_allclose(got[0][0].values[0].item(), want[0, 0],
                               rtol=RTOL, atol=0)


@pytest.mark.parametrize("filtered", [False, True])
def test_keyed_aggregate_matches_jax(mesh, fixed_slots, filtered):
    rng = np.random.default_rng(7)
    keys, kval, vals, vok, ivals, nrows = _agg_table(rng)
    cond_j = JPR.GreaterThan(JRef(2, jdts.INT64, name="iv"),
                             JLit(-500)) if filtered else None
    cond_t = TPR.GreaterThan(TRef(2, tdts.INT64, name="iv"),
                             TLit(-500)) if filtered else None
    jd = JaxAggregate(
        mesh, [jdts.INT64, jdts.FLOAT64, jdts.INT64],
        [JRef(0, jdts.INT64, name="k")], _funcs(jagg, JRef, jdts, False),
        filter_cond=cond_j)
    outs = jd([(*_jax_flat(keys, kval), None),
               (*_jax_flat(vals, vok), None),
               (*_jax_flat(ivals), None)], jnp.asarray(nrows))
    shards, counts = _port_shards(
        [(tdts.INT64, keys, kval), (tdts.FLOAT64, vals, vok),
         (tdts.INT64, ivals, None)], nrows)
    shuffle_metrics.reset()
    td = DistributedAggregate(
        LocalShards(NSHARDS, "cpu"), [tdts.INT64, tdts.FLOAT64, tdts.INT64],
        [TRef(0, tdts.INT64, name="k")], _funcs(tagg, TRef, tdts, False),
        filter_cond=cond_t)
    got, sizes = td(shards, counts)
    # the stage statistics, exactly
    js, ts = jd.last_stats, td.last_stats
    np.testing.assert_array_equal(ts["bucket_counts"],
                                  np.asarray(js["bucket_counts"]))
    np.testing.assert_array_equal(ts["bucket_map"], js["bucket_map"])
    np.testing.assert_array_equal(ts["partition_counts"],
                                  js["partition_counts"])
    assert shuffle_metrics.snapshot()["rowsMoved"] == \
        int(ts["partition_counts"].sum())
    # the output shard by shard: same groups on the same shard
    jn = np.asarray(outs[0][2]).reshape(NSHARDS, -1)[:, 0]
    assert sizes == jn.tolist()
    for s in range(NSHARDS):
        for i, (jv, jok, _) in enumerate(outs):
            wv, wok = _jax_shard(jv, jn, s), _jax_shard(jok, jn, s)
            c = got[s][i]
            ok = np.ones(sizes[s], bool) if c.validity is None else \
                c.validity.numpy()
            np.testing.assert_array_equal(ok, wok)
            gv = np.where(ok, c.values.numpy(), 0)
            wv = np.where(wok, wv, 0)
            if i in (0, 2, 3):  # key, count, integer sum
                np.testing.assert_array_equal(gv, wv)
            else:
                np.testing.assert_allclose(gv, wv, rtol=RTOL, atol=0)


# ------------------------------------------------------------------ joins --

def _join_tables(rng):
    fk = rng.integers(0, 40, (NSHARDS, CAP)).astype(np.int64)
    fok = rng.random((NSHARDS, CAP)) < 0.95
    amount = rng.normal(size=(NSHARDS, CAP))
    p_nrows = rng.integers(50, CAP, NSHARDS).astype(np.int32)
    # 30 of the 40 keys on the build side, five of them twice
    dim_keys = np.concatenate([rng.permutation(40)[:30],
                               rng.permutation(30)[:5]]).astype(np.int64)
    dk = np.zeros((NSHARDS, CAP), dtype=np.int64)
    dv = np.zeros((NSHARDS, CAP), dtype=np.float64)
    b_nrows = np.zeros(NSHARDS, dtype=np.int32)
    for i, k in enumerate(dim_keys):
        s = i % NSHARDS
        dk[s, b_nrows[s]] = k
        dv[s, b_nrows[s]] = float(k) * 10 + i
        b_nrows[s] += 1
    return fk, fok, amount, p_nrows, dk, dv, b_nrows


def _rows(cols, n):
    """Row tuples from (values, validity) host arrays of n rows."""
    out = []
    for i in range(n):
        out.append(tuple(v[i].item() if ok[i] else None
                         for v, ok in cols))
    return sorted(out, key=repr)


@pytest.mark.parametrize("strategy,join_type", [
    ("broadcast", "inner"), ("broadcast", "left"), ("broadcast", "semi"),
    ("broadcast", "anti"), ("shuffle", "inner"), ("shuffle", "left"),
    ("shuffle", "full"), ("shuffle", "semi"), ("shuffle", "anti")])
def test_join_matches_jax(mesh, fixed_slots, strategy, join_type):
    rng = np.random.default_rng(3)
    fk, fok, amount, p_nrows, dk, dv, b_nrows = _join_tables(rng)
    ones = np.ones((NSHARDS, CAP), bool)
    jj = JaxJoin(mesh, [jdts.INT64, jdts.FLOAT64], [jdts.INT64, jdts.FLOAT64],
                 [0], [0], join_type=join_type, strategy=strategy,
                 out_factor=4)
    flat, n_out, total = jj(
        [_jax_flat(fk, fok), _jax_flat(amount, ones)], jnp.asarray(p_nrows),
        [_jax_flat(dk, ones), _jax_flat(dv, ones)], jnp.asarray(b_nrows))
    jn = np.asarray(n_out).reshape(-1)
    np.testing.assert_array_equal(np.asarray(total).reshape(-1), jn)
    probe, pn = _port_shards([(tdts.INT64, fk, fok),
                              (tdts.FLOAT64, amount, None)], p_nrows)
    build, bn = _port_shards([(tdts.INT64, dk, None),
                              (tdts.FLOAT64, dv, None)], b_nrows)
    tj = DistributedHashJoin(LocalShards(NSHARDS, "cpu"),
                             [tdts.INT64, tdts.FLOAT64],
                             [tdts.INT64, tdts.FLOAT64], [0], [0],
                             join_type=join_type,
                             broadcast_threshold_rows=(
                                 1 << 30 if strategy == "broadcast" else -1))
    got, sizes = tj(probe, pn, build, bn)
    js, ts = jj.last_stats, tj.last_stats
    assert ts["strategy"] == js["strategy"] == strategy
    assert ts["build_rows"] == js["build_rows"]
    if strategy == "shuffle":
        np.testing.assert_array_equal(ts["probe_counts"],
                                      js["probe_counts"])
        np.testing.assert_array_equal(ts["build_counts"],
                                      js["build_counts"])
    assert sizes == jn.tolist()
    for s in range(NSHARDS):
        want = _rows([(_jax_shard(v, jn, s), _jax_shard(ok, jn, s))
                      for v, ok in flat], jn[s])
        cols = [(c.values.numpy(),
                 np.ones(sizes[s], bool) if c.validity is None
                 else c.validity.numpy()) for c in got[s]]
        assert _rows(cols, sizes[s]) == want, f"shard {s}"


# ---------------------------------------------------------------- queries --

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


def _fact_dim(F, fact, dim):
    return (fact.join(dim, on="k").group_by("k")
            .agg(F.sum(F.col("v")).alias("sv"),
                 F.sum(F.col("w")).alias("sw")))


def _sparse(n, card, seed):
    rng = np.random.default_rng(seed)
    uni = np.unique(rng.integers(0, 1 << 40, 4 * card,
                                 dtype=np.int64))[:card]
    return {"k": uni[rng.integers(0, len(uni), n)],
            "v": rng.integers(0, 1000, n).astype(np.float64)}


def _fact_dim_tables(n_fact, n_dim, seed):
    rng = np.random.default_rng(seed)
    uni = np.unique(rng.integers(0, 1 << 40, 8 * n_dim,
                                 dtype=np.int64))[: 2 * n_dim]
    dim = {"k": uni[::2],
           "w": rng.integers(0, 100, n_dim).astype(np.float64)}
    fact = {"k": uni[rng.integers(0, len(uni), n_fact)],
            "v": rng.integers(0, 10 ** 4, n_fact).astype(np.float64)}
    return fact, dim


def _both(conf, build, *tables):
    """``build(F, *dataframes)`` through the JAX session on make_mesh(8)
    and the port's session with numShards=8: (port, jax, port session,
    jax session)."""
    js = JaxSession(dict(conf), mesh=jax_make_mesh(NSHARDS))
    try:
        want = build(JF, *[js.create_dataframe(t) for t in tables]) \
            .to_pandas()
    finally:
        js.stop()
    ts = TpuSession({**MESH_CONF, **conf}, device="cpu")
    got = build(TF, *[ts.create_dataframe(t) for t in tables]).to_pandas()
    return got, want, ts, js


def _assert_frames(got, want, keys, exact=()):
    assert list(got.columns) == list(want.columns)
    got = got.sort_values(keys, ignore_index=True, kind="mergesort")
    want = want.sort_values(keys, ignore_index=True, kind="mergesort")
    assert len(got) == len(want)
    for c in got.columns:
        if c in keys or c in exact:
            pd.testing.assert_series_equal(got[c], want[c],
                                           check_dtype=False)
        else:
            np.testing.assert_allclose(got[c].to_numpy(np.float64),
                                       want[c].to_numpy(np.float64),
                                       rtol=RTOL, atol=0)


@pytest.fixture(scope="module")
def lineitem():
    return gen_host(1 << 13, seed=42)


def test_q6_distributed_matches_jax(lineitem):
    K.launches.reset()
    got, want, ts, js = _both({}, _q6, lineitem)
    assert ts.last_dist_explain == js.last_dist_explain == "distributed"
    np.testing.assert_allclose(got["revenue"][0], want["revenue"][0],
                               rtol=RTOL, atol=0)


def test_q1_distributed_matches_jax(lineitem):
    got, want, ts, js = _both({}, _q1, lineitem)
    assert ts.last_dist_explain == js.last_dist_explain == "distributed"
    assert len(got) == 6
    _assert_frames(got, want, ["l_returnflag_code", "l_linestatus_code"],
                   exact=["n", "sum_qty"])
    (op, stats), = ts.last_dist_stats
    assert op == "aggregate" and stats["bucket_counts"].shape == (8, 32)
    # six groups per shard before the exchange, each counted once
    assert int(stats["bucket_counts"].sum()) == 6 * NSHARDS


def test_sparse_groupby_distributed_matches_jax():
    data = _sparse(1 << 13, 1 << 11, seed=7)
    shuffle_metrics.reset()
    got, want, ts, js = _both({}, _sparse_agg, data)
    assert ts.last_dist_explain == js.last_dist_explain == "distributed"
    _assert_frames(got, want, ["k"], exact=["s", "n"])
    (_, stats), = ts.last_dist_stats
    assert shuffle_metrics.snapshot()["rowsMoved"] == \
        int(stats["partition_counts"].sum())


@pytest.mark.parametrize("threshold", [1 << 16, 100])
def test_fact_dim_distributed_matches_jax(threshold):
    fact, dim = _fact_dim_tables(1 << 12, 1 << 8, seed=9)
    conf = {"spark.rapids.sql.join.broadcastThresholdRows": threshold}
    got, want, ts, js = _both(conf, _fact_dim, fact, dim)
    assert ts.last_dist_explain == js.last_dist_explain == "distributed"
    _assert_frames(got, want, ["k"], exact=["sv", "sw"])
    (jop, jstats), (aop, _) = ts.last_dist_stats
    assert (jop, aop) == ("join:inner", "aggregate")
    assert jstats["strategy"] == ("broadcast" if threshold > (1 << 8)
                                  else "shuffle")


@pytest.mark.parametrize("how", ["left", "right", "full", "anti"])
def test_join_types_distributed_match_jax(how):
    fact, dim = _fact_dim_tables(1 << 11, 1 << 7, seed=4)
    conf = {"spark.rapids.sql.join.broadcastThresholdRows": 16}

    def q(F, a, b):
        return a.join(b, on="k", how=how)
    got, want, ts, js = _both(conf, q, fact, dim)
    assert ts.last_dist_explain == js.last_dist_explain == "distributed"
    keys = list(got.columns)
    _assert_frames(got.fillna(-1.0), want.fillna(-1.0), keys)


def test_sort_and_topn_distributed_match_jax():
    data = _sparse(1 << 13, 1 << 12, seed=21)
    got, want, ts, js = _both({}, lambda F, df: df.orderBy("k"), data)
    assert ts.last_dist_explain == js.last_dist_explain == "distributed"
    pd.testing.assert_frame_equal(got, want)
    np.testing.assert_array_equal(got["k"].to_numpy(),
                                  np.sort(data["k"], kind="stable"))
    (op, stats), = ts.last_dist_stats
    assert op == "sort" and int(stats["partition_counts"].sum()) == \
        len(data["k"])

    def top(F, df):
        return df.orderBy(F.col("v").desc(), F.col("k")).limit(10)
    got, want, ts, js = _both({}, top, data)
    assert ts.last_dist_explain == js.last_dist_explain == "distributed"
    pd.testing.assert_frame_equal(got, want)
    (op, stats), = ts.last_dist_stats
    assert op == "topn" and stats == {"gathered_rows": 10 * NSHARDS,
                                      "rows": 10}


@pytest.mark.parametrize("fused", [True, False])
def test_stages_expressions_and_limit_match_jax(lineitem, fused):
    """A Filter/Project chain as one stage (and one stage per member with
    fusion off), aggregate outputs that combine aggregates and keys, and
    a plain limit over the shards."""
    conf = {"spark.rapids.tpu.fusion.enabled": fused}

    def chain(F, df):
        return (df.filter(F.col("l_quantity") < 30.0)
                .select(F.col("l_returnflag_code").alias("rf"),
                        (F.col("l_extendedprice") * F.col("l_discount"))
                        .alias("rev"), F.col("l_tax"))
                .filter(F.col("l_tax") > 0.02))

    got, want, ts, js = _both(conf, chain, lineitem)
    assert ts.last_dist_explain == js.last_dist_explain == "distributed"
    pd.testing.assert_frame_equal(got, want)

    def ratios(F, df):
        return (chain(F, df).groupBy("rf")
                .agg((F.sum("rev") / F.count("rev")).alias("mean_rev"),
                     (F.col("rf") + F.lit(100)).alias("rf100"),
                     F.max("l_tax").alias("top_tax"),
                     F.min("rev").alias("low_rev")))

    got, want, ts, js = _both(conf, ratios, lineitem)
    assert ts.last_dist_explain == js.last_dist_explain == "distributed"
    _assert_frames(got, want, ["rf"], exact=["rf100", "top_tax", "low_rev"])

    got, want, ts, js = _both(conf, lambda F, df: chain(F, df).limit(700),
                              lineitem)
    assert ts.last_dist_explain == js.last_dist_explain == "distributed"
    pd.testing.assert_frame_equal(got, want)


def _string_union(F, df):
    """A union over a string column: the fallback the sharded path keeps
    (the children's dictionaries would need aligning)."""
    return df.filter(F.col("v") > 3.0).union(df.filter(F.col("v") <= 3.0)) \
        .orderBy("v")


def test_string_scan_falls_back_with_reason():
    """String scans distribute since dictionary codes travel on the shard
    group; a union over strings still falls back, with the JAX package's
    reason, and answers as the single device does."""
    data = {"s": ["a", "b", None, "a"] * 8, "v": np.arange(32.0)}
    ts = TpuSession(MESH_CONF, device="cpu")
    got = _string_union(TF, ts.create_dataframe(data)).to_pandas()
    assert ts.last_dist_explain == (
        "fallback: union over string columns needs dictionary alignment "
        "(not yet distributed)")
    single = TpuSession({}, device="cpu")
    want = _string_union(TF, single.create_dataframe(data)).to_pandas()
    pd.testing.assert_frame_equal(got, want)


def test_fallback_clears_stage_statistics(lineitem):
    """A plan that falls back leaves no stage statistics of the query
    before it on the session."""
    ts = TpuSession(MESH_CONF, device="cpu")
    _q1(TF, ts.create_dataframe(lineitem)).to_pandas()
    assert ts.last_dist_stats
    data = {"s": ["a", "b"] * 8, "v": np.arange(16.0)}
    _string_union(TF, ts.create_dataframe(data)).to_pandas()
    assert ts.last_dist_explain.startswith("fallback:")
    assert ts.last_dist_stats is None


def _sparse_agg_by(F, df):
    return df.filter(F.col("v") > 3.0).agg(F.sum("v").alias("s"))


def test_distributed_disabled_by_conf(lineitem):
    ts = TpuSession({**MESH_CONF,
                     "spark.rapids.sql.distributed.enabled": False},
                    device="cpu")
    got = _q6(TF, ts.create_dataframe(lineitem)).to_pandas()
    assert ts.last_dist_explain == "distributed disabled by conf"
    want = _q6(TF, TpuSession({}, device="cpu")
               .create_dataframe(lineitem)).to_pandas()
    np.testing.assert_allclose(got["revenue"], want["revenue"], rtol=RTOL)


# ----------------------------------------------------- a real process group --

def _gloo_rank(rank, world, store_path, out_dir, data):
    import torch.distributed as dist
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.session import TpuSession as Session
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        s = Session({}, device="cpu", process_group=dist.group.WORLD)
        q1 = _q1(F, s.create_dataframe(data)).to_pandas()
        q1_stats = s.last_dist_stats
        explain = s.last_dist_explain
        fact, dim = _fact_dim_tables(1 << 10, 1 << 6, seed=2)
        s2 = Session({"spark.rapids.sql.join.broadcastThresholdRows": 8},
                     device="cpu", process_group=dist.group.WORLD)
        fd = _fact_dim(F, s2.create_dataframe(fact),
                       s2.create_dataframe(dim)).to_pandas()
        fd_stats = s2.last_dist_stats
        sdf = s2.create_dataframe(fact)
        top = sdf.orderBy(F.col("v").desc(), F.col("k")).limit(7) \
            .to_pandas()
        srt = sdf.orderBy("k").to_pandas()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump({"q1": q1, "q1_stats": q1_stats, "fd": fd,
                         "fd_stats": fd_stats, "top": top, "sort": srt,
                         "sort_stats": s2.last_dist_stats,
                         "explain": explain}, f)
    finally:
        dist.destroy_process_group()


def test_two_rank_gloo_process_group_matches_local_shards(tmp_path,
                                                          lineitem):
    import torch.multiprocessing as mp
    data = {k: v[:2000] for k, v in lineitem.items()}
    ctx = mp.spawn(_gloo_rank, args=(2, str(tmp_path / "store"),
                                     str(tmp_path), data),
                   nprocs=2, join=False)
    deadline = 60.0
    import time
    t0 = time.monotonic()
    while not ctx.join(timeout=1.0):
        if time.monotonic() - t0 > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail("two-rank gloo run did not finish within 60 s")
    results = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    local = TpuSession({"spark.rapids.sql.distributed.numShards": 2},
                       device="cpu")
    want_q1 = _q1(TF, local.create_dataframe(data)).to_pandas()
    want_q1_stats = local.last_dist_stats
    fact, dim = _fact_dim_tables(1 << 10, 1 << 6, seed=2)
    local2 = TpuSession({"spark.rapids.sql.distributed.numShards": 2,
                         "spark.rapids.sql.join.broadcastThresholdRows": 8},
                        device="cpu")
    want_fd = _fact_dim(TF, local2.create_dataframe(fact),
                        local2.create_dataframe(dim)).to_pandas()
    want_fd_stats = local2.last_dist_stats
    ldf = local2.create_dataframe(fact)
    want_top = ldf.orderBy(TF.col("v").desc(), TF.col("k")).limit(7) \
        .to_pandas()
    want_sort = ldf.orderBy("k").to_pandas()
    want_sort_stats = local2.last_dist_stats
    for res in results:
        assert res["explain"] == "distributed"
        pd.testing.assert_frame_equal(res["q1"], want_q1)
        pd.testing.assert_frame_equal(res["fd"], want_fd)
        (_, got), = res["q1_stats"]
        (_, want), = want_q1_stats
        for k in ("bucket_counts", "bucket_map", "partition_counts"):
            np.testing.assert_array_equal(got[k], want[k])
        pd.testing.assert_frame_equal(res["top"], want_top)
        pd.testing.assert_frame_equal(res["sort"], want_sort)
        np.testing.assert_array_equal(
            dict(res["sort_stats"])["sort"]["partition_counts"],
            dict(want_sort_stats)["sort"]["partition_counts"])
        got_j = dict(res["fd_stats"])["join:inner"]
        want_j = dict(want_fd_stats)["join:inner"]
        assert got_j["strategy"] == want_j["strategy"] == "shuffle"
        for k in ("probe_counts", "build_counts"):
            np.testing.assert_array_equal(got_j[k], want_j[k])
