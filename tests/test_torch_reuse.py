"""The result cache and the shared stage store of the PyTorch port
(``serving/reuse.py`` and its envelope in ``api/dataframe.py``) against
the JAX package's, on the CPU.

The same seeded parquet file and frames go through both packages: a hit
pulls nothing from its sources (the ``io.read`` injection point counts
the pulls), a rewritten file is a miss, a rotten stored result is
recomputed, UDF and pandas plans are never cached, the budget evicts,
in-memory inputs are held by weak references, and a second sharded
query splices the first's stage bit for bit.  The counters of both
caches agree; answers agree with keys exact and float sums within a
relative 1e-12 (the packages add in different orders).  With every reuse
setting off the event stream has no ``sharing`` key and no reuse event.
"""

import glob
import json
import os

import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.parallel.mesh import make_mesh as jax_make_mesh
from spark_rapids_tpu.robustness import inject as JI
from spark_rapids_tpu.serving.reuse import ResultCache as JaxResultCache
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.robustness import inject as I
from spark_rapids_tpu_torch.robustness.driver import recovery_metrics
from spark_rapids_tpu_torch.serving.reuse import ResultCache

NSHARDS = 8
REUSE = {"spark.rapids.tpu.serving.resultCache.enabled": True,
         "spark.rapids.tpu.serving.sharedStage.enabled": True,
         "spark.rapids.sql.recovery.backoffMs": 1}
MESH = {"spark.rapids.sql.distributed.numShards": NSHARDS}
REL = 1e-12


@pytest.fixture(autouse=True)
def _clean_registry():
    I.clear()
    JI.clear()
    recovery_metrics.reset()
    with I.scoped_rules(), JI.scoped_rules():
        yield
    I.clear()
    JI.clear()


@pytest.fixture(scope="module")
def jmesh():
    return jax_make_mesh(NSHARDS)


def _write_fact(path, scale, n=3000):
    rng = np.random.default_rng(11)
    pd.DataFrame({
        "k": rng.integers(0, 24, n).astype(np.int64),
        "v": rng.normal(size=n) * scale,
    }).to_parquet(path)


@pytest.fixture()
def fact(tmp_path):
    path = str(tmp_path / "fact.parquet")
    _write_fact(path, scale=1.0)
    return path


def _query(F_, session, path):
    return (session.read.parquet(path).filter(F_.col("v") > -1.0)
            .groupBy("k").agg(F_.sum(F_.col("v")).alias("sv")))


def _norm(df):
    return df.sort_values("k", ignore_index=True)


def _agree(got, want):
    got, want = _norm(got), _norm(want)
    np.testing.assert_array_equal(got.k, want.k)
    np.testing.assert_allclose(got.sv, want.sv, rtol=REL)


def _count_rule(inj, point):
    return inj.inject(point, count=1, skip=1_000_000, all_threads=True)


def _hits(rule):
    return 1_000_000 - rule.skip


def _pair(conf=REUSE, jmesh=None):
    s = TpuSession(dict(conf, **(MESH if jmesh is not None else {})),
                   device="cpu")
    js = JaxSession(dict(conf), mesh=jmesh) if jmesh is not None \
        else JaxSession(dict(conf))
    return s, js


SNAP_KEYS = ("hits", "misses", "stores", "invalidations", "evictions",
             "entries")


def _snap(cache):
    snap = cache.snapshot()
    return {k: snap[k] for k in SNAP_KEYS}


def test_hit_pulls_nothing_from_its_sources(fact):
    s, js = _pair()
    try:
        out = {}
        for name, sess, F_, inj in (("torch", s, F, I), ("jax", js, JF, JI)):
            r1 = _norm(_query(F_, sess, fact).to_pandas())
            reads = _count_rule(inj, "io.read")
            r2 = _norm(_query(F_, sess, fact).to_pandas())
            assert _hits(reads) == 0, name
            inj.remove(reads)
            pd.testing.assert_frame_equal(r2, r1)
            out[name] = r2
        _agree(out["torch"], out["jax"])
        assert _snap(s.result_cache) == _snap(js.result_cache)
        assert s.result_cache.snapshot()["hits"] == 1
    finally:
        s.stop()
        js.stop()


def test_hit_batches_stay_on_the_host(fact):
    s = TpuSession(dict(REUSE), device="cpu")
    try:
        q = _query(F, s, fact)
        fresh = q._execute_batches()
        cached = _query(F, s, fact)._execute_batches()
        assert s.last_dist_explain == "result-cache hit"
        assert all(c.data.device.type == "cpu"
                   for b in cached for c in b.columns.values())
        assert [b.to_arrow() for b in cached] == \
            [b.to_arrow() for b in fresh]
    finally:
        s.stop()


def test_rewritten_file_is_a_miss(fact):
    s, js = _pair()
    try:
        for name, sess, F_ in (("torch", s, F), ("jax", js, JF)):
            _write_fact(fact, scale=1.0)
            r1 = _norm(_query(F_, sess, fact).to_pandas())
            _write_fact(fact, scale=4.0)
            r2 = _norm(_query(F_, sess, fact).to_pandas())
            pdf = pd.read_parquet(fact)
            want = pdf[pdf.v > -1.0].groupby("k", as_index=False).v.sum()
            np.testing.assert_allclose(r2.sv, want.v, rtol=1e-9)
            assert not r2.equals(r1), name
        assert _snap(s.result_cache) == _snap(js.result_cache)
        assert s.result_cache.snapshot()["invalidations"] >= 1
        assert s.result_cache.snapshot()["hits"] == 0
    finally:
        s.stop()
        js.stop()


def test_rotten_entry_is_recomputed(fact):
    s, js = _pair()
    try:
        for name, sess, F_, inj in (("torch", s, F, I), ("jax", js, JF, JI)):
            r1 = _norm(_query(F_, sess, fact).to_pandas())
            with inj.injected("resultcache.load", kind="corrupt", count=1,
                              all_threads=True):
                r2 = _norm(_query(F_, sess, fact).to_pandas())
            pd.testing.assert_frame_equal(r2, r1)
            r3 = _norm(_query(F_, sess, fact).to_pandas())
            pd.testing.assert_frame_equal(r3, r1)
        assert _snap(s.result_cache) == _snap(js.result_cache)
        snap = s.result_cache.snapshot()
        assert snap["invalidations"] >= 1 and snap["hits"] == 1
    finally:
        s.stop()
        js.stop()


def test_udf_and_pandas_plans_are_not_cached(fact):
    s, js = _pair()
    try:
        df, jdf = s.read.parquet(fact), js.read.parquet(fact)
        assert ResultCache.cacheable(df.filter(F.col("v") > 0).plan)
        assert JaxResultCache.cacheable(jdf.filter(JF.col("v") > 0).plan)
        pandas = df.mapInPandas(lambda it: it, "k long, v double")
        assert not ResultCache.cacheable(pandas.plan)
        assert not JaxResultCache.cacheable(jdf.mapInPandas(
            lambda it: it, "k long, v double").plan)
        py = F.udf(lambda v: str(v), "string")
        assert not ResultCache.cacheable(
            df.select(py(F.col("v")).alias("u")).plan)
        pandas.to_pandas()
        pandas.to_pandas()
        assert s.result_cache.snapshot()["stores"] == 0
    finally:
        s.stop()
        js.stop()


def test_budget_evicts(fact):
    conf = dict(REUSE, **{"spark.rapids.tpu.serving.resultCache.maxBytes": 1})
    s, js = _pair(conf)
    try:
        for sess, F_ in ((s, F), (js, JF)):
            r1 = _norm(_query(F_, sess, fact).to_pandas())
            r2 = _norm(_query(F_, sess, fact).to_pandas())
            pd.testing.assert_frame_equal(r2, r1)
        assert _snap(s.result_cache) == _snap(js.result_cache)
        snap = s.result_cache.snapshot()
        assert snap["hits"] == 0 and snap["entries"] == 0
    finally:
        s.stop()
        js.stop()


def test_lru_eviction_keeps_the_newest(fact):
    s = TpuSession(dict(REUSE), device="cpu")
    try:
        _query(F, s, fact).to_pandas()
        one = s.result_cache.snapshot()["bytes"]
        s.result_cache.max_bytes = 2 * one
        for cut in (-1.0, -0.5, 0.0):
            (s.read.parquet(fact).filter(F.col("v") > cut).groupBy("k")
             .agg(F.sum(F.col("v")).alias("sv")).to_pandas())
        snap = s.result_cache.snapshot()
        assert snap["evictions"] >= 1 and snap["bytes"] <= 2 * one
    finally:
        s.stop()


def test_in_memory_inputs_are_pinned_weakly():
    """A hit needs the fingerprinted batches alive: a dead input's id
    may name other data, so its entry is invalidated, not served."""
    import gc
    pdf = pd.DataFrame({"k": np.arange(60) % 6, "v": np.arange(60.0)})
    s, js = _pair()
    try:
        for sess, F_ in ((s, F), (js, JF)):
            df = sess.create_dataframe(pdf)
            q = df.groupBy("k").agg(F_.sum(F_.col("v")).alias("sv"))
            r1 = _norm(q.to_pandas())
            pd.testing.assert_frame_equal(_norm(q.to_pandas()), r1)
            assert sess.result_cache.snapshot()["hits"] == 1
            del df, q
            gc.collect()
            df2 = sess.create_dataframe(pdf)
            r3 = _norm(df2.groupBy("k").agg(F_.sum(F_.col("v"))
                                             .alias("sv")).to_pandas())
            pd.testing.assert_frame_equal(r3, r1)
            assert sess.result_cache.snapshot()["hits"] == 1
            if sess is s:
                # the dead input's entry holds a dead weak reference,
                # df2's a live one
                assert sorted(e.pins_alive() for e in
                              s.result_cache._entries.values()) == \
                    [False, True]
    finally:
        s.stop()
        js.stop()


def test_new_frame_over_equal_values_is_a_miss():
    pdf = pd.DataFrame({"k": np.arange(60) % 6, "v": np.arange(60.0)})
    s = TpuSession(dict(REUSE), device="cpu")
    try:
        a = s.create_dataframe(pdf)
        b = s.create_dataframe(pdf)
        for df in (a, b):
            df.groupBy("k").agg(F.sum(F.col("v")).alias("sv")).to_pandas()
        assert s.result_cache.snapshot()["hits"] == 0
    finally:
        s.stop()


def test_cross_query_splice_is_bit_identical(jmesh, fact):
    """A second, different sharded query sharing the aggregate subtree
    splices the first's stage: no source pull, the store-off answer bit
    for bit, and the same splice count as the reference."""
    off = TpuSession(dict(MESH), device="cpu")
    try:
        want = _query(F, off, fact).orderBy("k").to_pandas()
    finally:
        off.stop()
    s, js = _pair(jmesh=jmesh)
    try:
        for name, sess, F_, inj in (("torch", s, F, I), ("jax", js, JF, JI)):
            _query(F_, sess, fact).to_pandas()
            assert sess.last_dist_explain == "distributed", name
            reads = _count_rule(inj, "io.read")
            got = _query(F_, sess, fact).orderBy("k").to_pandas()
            assert _hits(reads) == 0, name
            inj.remove(reads)
            if name == "torch":
                pd.testing.assert_frame_equal(got, want)
            else:
                _agree(want, got)
        t, j = s.shared_stages.snapshot(), js.shared_stages.snapshot()
        assert t["resumes"] == j["resumes"] >= 1
        assert t["writes"] == j["writes"]
    finally:
        s.stop()
        js.stop()


def test_shared_store_drops_the_stage_of_a_freed_table(monkeypatch):
    """A shared entry holds weak references to its in-memory inputs.
    Once a table is freed, CPython may give its id to a new table of the
    same row count, and the new query's stage ids then equal the old
    ones.  That recycling is made certain here by keying each stage by
    its tree text, which holds no object id.  The dead table's entries
    must drop and the new query answer from its own data, as with the
    store off."""
    import gc
    from spark_rapids_tpu_torch.robustness import checkpoint as cp
    monkeypatch.setattr(
        cp, "stage_id", lambda plan, group, memo=None, inputs=True:
        "recycled:" + plan.tree_string())
    rng = np.random.default_rng(5)
    pdf_a = pd.DataFrame({"k": rng.integers(0, 12, 600),
                          "v": rng.normal(size=600)})
    pdf_b = pdf_a.assign(v=pdf_a.v * 3.0 + 1.0)

    def q(sess, pdf):
        return (sess.create_dataframe(pdf).groupBy("k")
                .agg(F.sum(F.col("v")).alias("sv")).orderBy("k")
                .to_pandas())
    conf = {"spark.rapids.tpu.serving.sharedStage.enabled": True,
            "spark.rapids.sql.recovery.backoffMs": 1}
    s = TpuSession(dict(conf, **MESH), device="cpu")
    off = TpuSession(dict(MESH), device="cpu")
    try:
        want_b = q(off, pdf_b)
        q(s, pdf_a)
        gc.collect()
        entries = list(s.shared_stages._entries.values())
        assert entries and not any(e.pins_alive() for e in entries)
        got = q(s, pdf_b)
        pd.testing.assert_frame_equal(got, want_b)
        snap = s.shared_stages.snapshot()
        assert snap["resumes"] == 0 and snap["invalid"] >= 1
    finally:
        s.stop()
        off.stop()


def test_shared_store_rotten_restore_recomputes(jmesh, fact):
    s, js = _pair(jmesh=jmesh)
    try:
        for sess, F_, inj in ((s, F, I), (js, JF, JI)):
            _query(F_, sess, fact).to_pandas()
            with inj.injected("checkpoint.restore", kind="corrupt",
                              count=1, all_threads=True):
                got = _query(F_, sess, fact).orderBy("k").to_pandas()
            pdf = pd.read_parquet(fact)
            want = pdf[pdf.v > -1.0].groupby("k", as_index=False).v.sum()
            np.testing.assert_allclose(_norm(got).sv, want.v, rtol=1e-9)
        assert s.shared_stages.snapshot()["invalid"] >= 1
        assert js.shared_stages.snapshot()["invalid"] >= 1
    finally:
        s.stop()
        js.stop()


def _events(log_dir):
    out = []
    for path in glob.glob(os.path.join(log_dir, "*.jsonl")):
        with open(path) as fh:
            out += [json.loads(x) for x in fh if x.strip()]
    return out


def test_everything_off_stream_is_unchanged(jmesh, fact, tmp_path):
    """No reuse setting on: no store exists, every run executes, and no
    QueryEnd has a ``sharing`` key nor any event a reuse name, as in the
    reference."""
    shapes = {}
    for name in ("torch", "jax"):
        log_dir = str(tmp_path / name)
        conf = {"spark.rapids.tpu.eventLog.dir": log_dir}
        sess = TpuSession(conf, device="cpu") if name == "torch" \
            else JaxSession(conf)
        F_, inj = (F, I) if name == "torch" else (JF, JI)
        try:
            assert sess.result_cache is None
            assert sess.shared_stages is None
            _query(F_, sess, fact).to_pandas()
            reads = _count_rule(inj, "io.read")
            _query(F_, sess, fact).to_pandas()
            assert _hits(reads) > 0
            inj.remove(reads)
        finally:
            sess.stop()
        events = _events(log_dir)
        ends = [e for e in events if e["event"] == "QueryEnd"]
        assert ends and all("sharing" not in e for e in ends)
        assert not any(e["event"].startswith(
            ("ResultCache", "SharedStage", "Template")) for e in events)
        shapes[name] = [e["event"] for e in events]
    assert shapes["torch"] == shapes["jax"]


def test_sharing_reaches_the_event_log(jmesh, fact, tmp_path):
    from spark_rapids_tpu_torch.tools.eventlog import load_logs
    conf = dict(REUSE, **MESH,
                **{"spark.rapids.tpu.eventLog.dir": str(tmp_path)})
    s = TpuSession(conf, device="cpu")
    try:
        _query(F, s, fact).to_pandas()
        _query(F, s, fact).to_pandas()               # a hit
        _query(F, s, fact).orderBy("k").to_pandas()  # a splice
    finally:
        s.stop()
    apps = load_logs(str(tmp_path))
    queries = [q for a in apps for q in a.queries]
    assert any(q.sharing.get("resultCacheHit") for q in queries)
    assert any(q.sharing.get("spliceResumes") for q in queries)
    assert any(q.sharing.get("stageWrites") for q in queries)
    kinds = {e["kind"] for a in apps for q in a.queries
             for e in q.sharing_events} | \
        {e["kind"] for a in apps for e in a.sharing_events}
    assert {"hit", "store", "write", "splice"} <= kinds
