"""``df.cache()`` and ``pivot`` of the PyTorch port, on the CPU, against the
JAX package and pandas.

Cache (``exec/cache.py``): the first action materializes the plan
(``TpuMaterializeCacheExec`` in its plan) and later queries read its frames
(``TpuCachedScanExec``, no scan below), equal bit for bit to the same plan
uncached and to the JAX package's; strings and nulls survive the native
codec; ``unpersist`` drops the node; a ``limit`` that stops early
publishes no partial cache; a cached Sort under a Limit is read, not
rewritten into a TopN; and the planner's pushdown stops at a cached node,
so a first query's filter, projection pruning or a join's pruning over a
parquet file never shrinks what is cached (the port prunes through joins,
which the JAX pass does not).

Pivot: one aggregate (the value is the column's name), several (value and
alias), ``count()`` per pivot value, and a sum against pandas'
``pivot_table``; keys and counts exactly, doubles within a relative 1e-12
of the JAX package's and of pandas'.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.session import TpuSession

RTOL = 1e-12


def _data(n=2000, seed=9):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"k": (np.arange(n) % 11).astype(np.int64),
                         "v": rng.uniform(size=n),
                         "s": [f"name-{i % 5}" for i in range(n)]})


def _session():
    return TpuSession({}, device="cpu")


def _tree(df):
    return df.session.plan(df.plan).tree_string()


def test_cache_materializes_then_reads():
    s = _session()
    df = s.create_dataframe(_data()).filter(F.col("v") < 0.5)
    df.cache()
    entry = s.cache_manager.lookup(df.plan)
    assert entry is not None and not entry.materialized
    assert "TpuMaterializeCacheExec" in _tree(df)
    first = df.to_pandas()
    assert entry.materialized and entry.cached_bytes > 0 and \
        entry.raw_bytes > 0
    q = df.groupBy("k").agg(F.sum("v").alias("sv"), F.count().alias("n"))
    tree = _tree(q)
    assert "TpuCachedScanExec" in tree and "TpuScanExec" not in tree
    got = q.orderBy("k").to_pandas()
    pd.testing.assert_frame_equal(first, df.to_pandas())
    plain = _session().create_dataframe(_data()).filter(F.col("v") < 0.5)
    want = plain.groupBy("k").agg(F.sum("v").alias("sv"),
                                  F.count().alias("n")).orderBy("k")
    pd.testing.assert_frame_equal(got, want.to_pandas())
    js = JaxSession()
    jdf = js.create_dataframe(_data()).filter(JF.col("v") < 0.5).cache()
    jdf.count()
    jq = jdf.groupBy("k").agg(JF.sum("v").alias("sv"),
                              JF.count().alias("n")).to_pandas() \
        .sort_values("k").reset_index(drop=True)
    pd.testing.assert_frame_equal(got, jq, check_dtype=False, rtol=RTOL)


def test_cache_keeps_strings_and_nulls():
    s = _session()
    base = s.create_dataframe(pd.DataFrame({
        "k": [1, 2, 3, 4], "s": ["a", None, "ccc", ""],
        "d": [1.5, None, 2.5, np.nan]}))
    df = base.cache()
    first = df.to_pandas()
    second = df.to_pandas()
    assert "TpuCachedScanExec" in _tree(df)
    pd.testing.assert_frame_equal(first, second)
    assert second["s"][0] == "a" and pd.isna(second["s"][1]) and \
        second["s"][2:].tolist() == ["ccc", ""]
    assert pd.isna(second["d"][1]) and second["d"][2] == 2.5


def test_unpersist_drops_the_node():
    s = _session()
    df = s.create_dataframe(_data()).cache()
    assert df.is_cached
    df.count()
    df.unpersist()
    assert not df.is_cached
    tree = _tree(df)
    assert "TpuCachedScanExec" not in tree and \
        "TpuMaterializeCacheExec" not in tree


def test_limit_publishes_no_partial_cache():
    s = TpuSession({"spark.rapids.sql.tpu.maxBatchRows": 256}, device="cpu")
    df = s.create_dataframe(_data()).cache()
    assert len(df.limit(5).to_pandas()) == 5
    entry = s.cache_manager.lookup(df.plan)
    if entry.materialized:
        assert len(df.to_pandas()) == 2000
    assert len(df.to_pandas()) == 2000 and entry.materialized
    assert len(df.to_pandas()) == 2000


def test_cached_sort_under_limit_reads_the_cache():
    s = _session()
    df = s.create_dataframe(_data()).orderBy(F.col("v")).cache()
    df.count()
    limited = df.limit(3)
    tree = _tree(limited)
    assert "TpuCachedScanExec" in tree and "TopN" not in tree
    got = limited.to_pandas()["v"].tolist()
    assert got == sorted(_data()["v"])[:3]


@pytest.mark.parametrize("first", ["filter_prune", "join_prune"])
def test_pushdown_stops_at_the_cache(tmp_path, first):
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"a": list(range(100)),
                             "b": [float(i) for i in range(100)],
                             "c": [f"s{i}" for i in range(100)]}), path)
    s = _session()
    df = s.read.parquet(path).cache()
    if first == "filter_prune":
        n = df.filter(F.col("a") > 90).select("a").count()
        assert n == 9
    else:
        other = s.create_dataframe({"a2": np.array([1, 2, 3])})
        got = df.join(other, F.col("a") == F.col("a2")).select("a") \
            .to_pandas()
        assert sorted(got["a"]) == [1, 2, 3]
    full = df.to_pandas()
    assert "TpuCachedScanExec" in _tree(df)
    assert len(full) == 100
    assert full["b"].tolist() == [float(i) for i in range(100)]
    assert full["c"].tolist() == [f"s{i}" for i in range(100)]


def _pivot_data(n=300, seed=7):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 6, n), "p": rng.choice(["a", "b", "c"], n),
            "v": rng.normal(size=n).round(3), "w": rng.integers(0, 9, n)}


def _pivot_both(build):
    data = _pivot_data()
    out = []
    for mod, s in ((F, _session()), (JF, JaxSession())):
        out.append(build(mod, s.create_dataframe(data)).to_pandas()
                   .sort_values("k").reset_index(drop=True))
    return data, out[0], out[1]


def test_pivot_sum_matches_pandas():
    data, got, want = _pivot_both(
        lambda m, df: df.groupBy("k").pivot("p", ["a", "b", "c"]).sum("v"))
    assert list(got.columns) == ["k", "a", "b", "c"]
    pd.testing.assert_frame_equal(got, want, check_dtype=False, rtol=RTOL)
    ref = pd.DataFrame(data).pivot_table(index="k", columns="p", values="v",
                                         aggfunc="sum")
    for c in ("a", "b", "c"):
        np.testing.assert_allclose(got[c], ref[c].to_numpy(), rtol=RTOL)


def test_pivot_several_aggregates():
    data, got, want = _pivot_both(
        lambda m, df: df.groupBy("k").pivot("p", ["a", "b"]).agg(
            m.sum("v").alias("sv"), m.max("w").alias("mw")))
    assert list(got.columns) == ["k", "a_sv", "a_mw", "b_sv", "b_mw"]
    pd.testing.assert_frame_equal(got, want, check_dtype=False, rtol=RTOL)


def test_pivot_count():
    data, got, want = _pivot_both(
        lambda m, df: df.groupBy("k").pivot("p", ["a", "c"]).agg(m.count()))
    pd.testing.assert_frame_equal(got, want, check_dtype=False)
    d = pd.DataFrame(data)
    for c in ("a", "c"):
        ref = d[d["p"] == c].groupby("k").size().reindex(
            got["k"]).fillna(0).to_numpy()
        np.testing.assert_array_equal(got[c].to_numpy(), ref)


def test_pivot_needs_values():
    df = _session().create_dataframe(_pivot_data())
    with pytest.raises(ValueError, match="values"):
        df.groupBy("k").pivot("p", None)
