"""The port's sharded file scan, against the JAX package and the port's
own single device.

Parquet and ORC file lists shard over the group by their footers' row
counts (``last_scan_stats``: ``sharded_files``, ``files``,
``peak_host_rows``, ``total_rows``); CSV and a group of several
processes read the relation once and scatter it.  Every case must answer
as the JAX session on ``make_mesh(8)`` or the port's single device does:
keys, counts, strings and order equal, float sums within 1e-12 relative.
A two-rank gloo group runs a string group-by, a string-key join and a
parquet scan equal to ``LocalShards(2)``.
"""

import os
import pickle
import time

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.parallel.mesh import make_mesh as jax_make_mesh
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.ops import dictionary as D

NSHARDS = 8
RTOL = 1e-12
MESH_CONF = {"spark.rapids.sql.distributed.numShards": NSHARDS}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the host: one torch thread here."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cmp(got, want, sort_by=None):
    assert list(got.columns) == list(want.columns)
    if sort_by:
        got = got.sort_values(sort_by, ignore_index=True, kind="mergesort")
        want = want.sort_values(sort_by, ignore_index=True,
                                kind="mergesort")
    assert len(got) == len(want)
    for c in got.columns:
        g, w = got[c], want[c]
        if g.dtype.kind == "f" or w.dtype.kind == "f":
            np.testing.assert_allclose(g.to_numpy(np.float64),
                                       w.to_numpy(np.float64), rtol=RTOL,
                                       atol=0, equal_nan=True)
        else:
            pd.testing.assert_series_equal(g.reset_index(drop=True),
                                           w.reset_index(drop=True),
                                           check_dtype=False)


def _against_jax(build, paths):
    """``build(session, F)`` on the JAX mesh and the port's 8 shards."""
    js = JaxSession({}, mesh=jax_make_mesh(NSHARDS))
    try:
        want = build(js, JF).to_pandas()
        assert js.last_dist_explain == "distributed"
    finally:
        js.stop()
    ts = TpuSession(MESH_CONF, device="cpu")
    got = build(ts, TF).to_pandas()
    assert ts.last_dist_explain == "distributed", ts.last_dist_explain
    return got, want, ts


def _against_single(build):
    """``build(session, F)`` on the port's 8 shards and one device."""
    ts = TpuSession(MESH_CONF, device="cpu")
    got = build(ts, TF).to_pandas()
    assert ts.last_dist_explain == "distributed", ts.last_dist_explain
    want = build(TpuSession({}, device="cpu"), TF).to_pandas()
    return got, want, ts


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """16 parquet files of 500 rows (k, v, s with nulls): the JAX
    package's sharded-scan table."""
    rng = np.random.default_rng(3)
    root = tmp_path_factory.mktemp("trees")
    paths = []
    for i in range(16):
        t = pa.table({
            "k": rng.integers(0, 40, 500),
            "v": rng.uniform(-5, 5, 500).round(3),
            "s": rng.choice(["ash", "birch", "cedar", None], 500),
        })
        p = str(root / f"part-{i:02d}.parquet")
        pq.write_table(t, p)
        paths.append(p)
    return paths


def test_sharded_file_scan(trees):
    """Each shard reads its own files; the host never holds more than one
    shard's rows."""
    got, want, ts = _against_jax(
        lambda s, F: s.read.parquet(*trees).groupBy("k").agg(
            F.sum("v").alias("sv"), F.count("v").alias("cv"),
            F.min("s").alias("ms")), trees)
    _cmp(got, want, sort_by=["k"])
    st = ts.last_scan_stats
    assert st["sharded_files"] and st["files"] == 16 and st["scans"] == 1
    assert st["total_rows"] == 16 * 500
    assert st["peak_host_rows"] <= st["shard_bound_rows"] == 2 * 500


def test_sharded_file_scan_string_distinct(trees):
    got, want, _ = _against_jax(
        lambda s, F: s.read.parquet(*trees).select("s").distinct()
        .orderBy("s"), trees)
    _cmp(got, want)


def test_sharded_scan_with_pushdown(tmp_path):
    """The pushed filter rides into each shard's read."""
    rng = np.random.default_rng(4)
    paths = []
    for i in range(9):
        t = pa.table({"id": np.arange(i * 100, (i + 1) * 100),
                      "v": rng.uniform(0, 1, 100)})
        p = str(tmp_path / f"f{i}.parquet")
        pq.write_table(t, p)
        paths.append(p)
    got, want, ts = _against_jax(
        lambda s, F: s.read.parquet(*paths).filter(F.col("id") >= 450)
        .groupBy().agg(F.count("id").alias("n"), F.sum("v").alias("sv")),
        paths)
    _cmp(got, want)
    assert ts.last_scan_stats["total_rows"] == 450


def test_sharded_orc_scan(tmp_path, trees):
    from pyarrow import orc
    paths = []
    for i, p in enumerate(trees[:6]):
        out = str(tmp_path / f"part-{i}.orc")
        orc.write_table(pq.read_table(p), out)
        paths.append(out)
    got, want, ts = _against_single(
        lambda s, F: s.read.orc(*paths).groupBy("s").agg(
            F.sum("v").alias("sv"), F.max("k").alias("mk")).orderBy("s"))
    _cmp(got, want)
    assert ts.last_scan_stats["sharded_files"]
    assert ts.last_scan_stats["files"] == 6


def test_csv_reads_once_and_scatters(tmp_path, trees):
    """CSV files carry no footer row counts: read once and scattered."""
    from pyarrow import csv
    paths = []
    for i, p in enumerate(trees[:3]):
        out = str(tmp_path / f"part-{i}.csv")
        csv.write_csv(pq.read_table(p), out)
        paths.append(out)
    got, want, ts = _against_single(
        lambda s, F: s.read.csv(*paths).groupBy("s").agg(
            F.count("k").alias("n"), F.sum("v").alias("sv")).orderBy("s"))
    _cmp(got, want)
    assert ts.last_scan_stats is None


def test_one_file_on_one_shard_with_edge_strings(tmp_path):
    """A single file puts every row on one shard (seven are empty); an
    all-null string column and strings past 256 bytes (the host
    dictionary) travel as codes."""
    rng = np.random.default_rng(9)
    long = ["x" * 300, "x" * 299 + "y", "short", "é" * 200]
    t = pa.table({
        "g": pa.array([long[i] for i in rng.integers(0, 4, 200)]),
        "nul": pa.array([None] * 200, type=pa.string()),
        "v": rng.uniform(0, 1, 200),
    })
    p = str(tmp_path / "one.parquet")
    pq.write_table(t, p)
    got, want, ts = _against_single(
        lambda s, F: s.read.parquet(p).groupBy("g").agg(
            F.min("nul").alias("mn"), F.sum("v").alias("sv"),
            F.max("g").alias("mg")).orderBy("g"))
    _cmp(got, want)
    st = ts.last_scan_stats
    assert st["files"] == 1 and st["peak_host_rows"] == 200


def test_scans_encode_only_the_columns_read(monkeypatch, tmp_path, trees):
    """The sharded scans encode the string columns the plan reads, not
    every string column of the relation."""
    t = pq.read_table(trees[0]).append_column(
        "comment", pa.array([f"c{i}" for i in range(500)]))
    p = str(tmp_path / "wide.parquet")
    pq.write_table(t, p)
    names = []
    real_sorted, real_stable = D.encode_sorted, D.StableDictionary.encode
    monkeypatch.setattr(D, "encode_sorted",
                        lambda c, n: names.append(n) or real_sorted(c, n))
    stable = []
    monkeypatch.setattr(D.StableDictionary, "encode",
                        lambda self, c, n, **kw: stable.append(n) or
                        real_stable(self, c, n, **kw))

    def build(s, F):
        return s.read.parquet(p).groupBy("s").agg(F.count("k").alias("n"))
    ts = TpuSession(MESH_CONF, device="cpu")
    got = build(ts, TF).orderBy("s").to_pandas()
    assert ts.last_dist_explain == "distributed"
    assert sum(stable) == 500 and not names  # "s" only, by the file scan
    mem = ts.create_dataframe(t.to_pandas())
    got2 = mem.groupBy("s").agg(TF.count("k").alias("n")).orderBy("s") \
        .to_pandas()
    assert names == [500]  # "s" only, by the in-memory scan
    _cmp(got, got2)


def test_range_reads_once_and_a_numeric_union_distributes():
    """A range is made once and scattered; a union of fixed-width columns
    keeps each shard's rows of both children (no exchange)."""
    def build(s, F):
        r = s.range(1000)
        return r.filter(F.col("id") % 7 == 0).union(
            r.filter(F.col("id") < 5)).groupBy(
            (F.col("id") % 3).alias("m")).agg(
            F.count().alias("n"), F.sum("id").alias("s")).orderBy("m")
    got, want, ts = _against_single(build)
    _cmp(got, want)
    assert ts.last_scan_stats is None


# ----------------------------------------------------- a real process group --

def _frames():
    rng = np.random.default_rng(7)
    n = 600
    fact = pd.DataFrame({
        "k2": rng.integers(0, 5, n),
        "v": rng.uniform(-10, 10, n).round(3),
        "s": rng.choice(["ash", "birch", "cedar", "oak", None], n),
    })
    lookup = pd.DataFrame({"s": ["ash", "cedar", "pine"],
                           "grp": ["soft", "soft", "hard"]})
    return fact, lookup


def _queries(s, F, paths):
    fact, lookup = _frames()
    f, d = s.create_dataframe(fact), s.create_dataframe(lookup)
    out = {
        "by_string": f.groupBy("s").agg(F.sum("v").alias("sv"),
                                        F.min("s").alias("lo"))
        .orderBy("s").to_pandas(),
        "join": f.join(d, "s").groupBy("grp", "s").agg(
            F.count("v").alias("n")).orderBy("grp", "s").to_pandas(),
    }
    out["explain"] = s.last_dist_explain
    out["files"] = s.read.parquet(*paths).groupBy("s").agg(
        F.count("k").alias("n"), F.sum("v").alias("sv")).orderBy("s") \
        .to_pandas()
    out["scan_stats"] = s.last_scan_stats
    out["files_explain"] = s.last_dist_explain
    return out


def _gloo_rank(rank, world, store_path, out_dir, paths):
    import torch.distributed as dist
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.session import TpuSession as Session
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        s = Session({}, device="cpu", process_group=dist.group.WORLD)
        got = _queries(s, F, paths)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(got, f)
    finally:
        dist.destroy_process_group()


def test_two_rank_gloo_strings_and_files_match_local_shards(tmp_path,
                                                            trees):
    """Every rank encodes the whole relation, so the ranks' dictionaries
    agree; a multi-rank group reads files once and scatters them."""
    import torch.multiprocessing as mp
    paths = trees[:4]
    ctx = mp.spawn(_gloo_rank, args=(2, str(tmp_path / "store"),
                                     str(tmp_path), paths),
                   nprocs=2, join=False)
    t0 = time.monotonic()
    while not ctx.join(timeout=1.0):
        if time.monotonic() - t0 > 60.0:
            for p in ctx.processes:
                p.terminate()
            pytest.fail("two-rank gloo run did not finish within 60 s")
    local = TpuSession({"spark.rapids.sql.distributed.numShards": 2},
                       device="cpu")
    want = _queries(local, TF, paths)
    assert want["scan_stats"]["sharded_files"]
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            got = pickle.load(f)
        assert got["explain"] == got["files_explain"] == "distributed"
        assert got["scan_stats"] is None  # read once and scattered
        for key in ("by_string", "join", "files"):
            _cmp(got[key], want[key])
