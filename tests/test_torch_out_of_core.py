"""The out-of-core sort and the aggregate's tree merge in the PyTorch port,
against the JAX package, on the CPU.

The single-device cases of ``tests/test_out_of_core.py`` under its four
conf values: a device budget of 200 kB (the sort's runs spill), a 50 kB
out-of-core threshold, 1000-row merge windows and 6000-row merge chunks,
so six 4096-row batches take both paths.  Each answer equals the JAX
package's on the same frames (floats exact for the sort, within a
relative 1e-12 for the tree merge's sums, which add in another grouping),
the catalog moved data to the host, the streamed sort emitted several
batches and the tree merge ran (``treeMergeSteps``).
"""

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.api.session import TpuSession

NBATCH = 6
ROWS = 4096
WINDOW = 1000
CONF = {
    "spark.rapids.memory.tpu.deviceLimitBytes": 200_000,
    "spark.rapids.sql.sort.outOfCoreThresholdBytes": 50_000,
    "spark.rapids.sql.sort.outOfCoreWindowRows": WINDOW,
    "spark.rapids.sql.agg.mergeChunkRows": 6000,
}
SUM_RTOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(11)
    return [pd.DataFrame({
        "k": rng.integers(0, 50, ROWS),
        "v": rng.normal(size=ROWS),
        "s": np.array(["r%04d" % i for i in
                       rng.integers(0, 3000, ROWS)]),
    }) for _ in range(NBATCH)]


def _union(session, frames):
    df = session.create_dataframe(frames[0])
    for f in frames[1:]:
        df = df.union(session.create_dataframe(f))
    return df


def _both(frames, build, conf=CONF):
    """(port session, port frame, JAX frame) of the same query."""
    s = TpuSession(dict(conf), device="cpu")
    got = build(_union(s, frames), TF)
    df = got.to_pandas()
    want = build(_union(JaxSession(dict(conf)), frames), JF).to_pandas()
    return s, got, df, want


def _metric(exec_, name):
    total = exec_.metrics[name].value if name in exec_.metrics else 0
    return total + sum(_metric(c, name) for c in exec_.children)


def test_out_of_core_sort_numeric(frames):
    s, q, got, want = _both(frames, lambda df, F: df.orderBy(
        F.col("v").desc()))
    pd.testing.assert_frame_equal(got, want, check_dtype=False)
    oracle = pd.concat(frames).sort_values("v", ascending=False)
    np.testing.assert_array_equal(got["v"], oracle["v"])
    assert _metric(q._last_exec, "outOfCoreRuns") == NBATCH
    assert s.memory_catalog.stats()["spilled_to_host_total"] > 0


def test_out_of_core_sort_multi_key_with_strings(frames):
    _, _, got, want = _both(frames, lambda df, F: df.orderBy(
        F.col("s").asc(), F.col("v").asc()))
    pd.testing.assert_frame_equal(got, want, check_dtype=False)


def test_out_of_core_sort_emits_sorted_stream(frames):
    s = TpuSession(dict(CONF), device="cpu")
    plan = s.plan(_union(s, frames).orderBy("k").plan)
    batches = list(plan.execute())
    assert len(batches) > 1, "expected a streamed merge output"
    ks = np.concatenate([b.column("k").data[:b.nrows].numpy()
                         for b in batches])
    assert len(ks) == NBATCH * ROWS
    assert (np.diff(ks) >= 0).all()
    jsess = JaxSession(dict(CONF))
    jplan = jsess.plan(_union(jsess, frames).orderBy("k").plan)
    jks = np.concatenate([np.asarray(b.column("k").data[:b.nrows])
                          for b in jplan.execute()])
    np.testing.assert_array_equal(ks, jks)


def test_tree_merge_aggregate(frames):
    _, q, got, want = _both(frames, lambda df, F: df.groupBy("k").agg(
        F.sum("v").alias("sv"), F.count("v").alias("c"),
        F.min("v").alias("mn"), F.max("v").alias("mx")))
    got = got.sort_values("k", ignore_index=True)
    want = want.sort_values("k", ignore_index=True)
    np.testing.assert_array_equal(got["k"], want["k"])
    np.testing.assert_array_equal(got["c"], want["c"])
    np.testing.assert_array_equal(got["mn"], want["mn"])
    np.testing.assert_array_equal(got["mx"], want["mx"])
    np.testing.assert_allclose(got["sv"], want["sv"], rtol=SUM_RTOL)


def test_tree_merge_aggregate_string_keys(frames):
    s, q, got, want = _both(frames, lambda df, F: df.groupBy("s").agg(
        F.sum("v").alias("sv"), F.count("v").alias("c")))
    got = got.sort_values("s", ignore_index=True)
    want = want.sort_values("s", ignore_index=True)
    assert got["s"].tolist() == want["s"].tolist()
    np.testing.assert_array_equal(got["c"], want["c"])
    np.testing.assert_allclose(got["sv"], want["sv"], rtol=SUM_RTOL)
    assert _metric(q._last_exec, "treeMergeSteps") >= 1
    assert s.memory_catalog.stats()["spilled_to_host_total"] > 0


def test_tree_merge_repeatable(frames):
    """Two runs of a tree-merged aggregate give the same bits."""
    s = TpuSession(dict(CONF), device="cpu")
    q = _union(s, frames).groupBy("s").agg(TF.sum("v").alias("sv"))
    a, b = q.to_pandas(), q.to_pandas()
    pd.testing.assert_frame_equal(a, b, check_exact=True)


def test_out_of_core_sort_presorted_disjoint_runs():
    """Pre-sorted input cut into batches (disjoint-range runs): the merge
    refills one run a step, so the carry holds about one window per run
    and every emitted batch stays within (runs + 1) windows."""
    frames_sorted = [pd.DataFrame({
        "v": np.arange(i * ROWS, (i + 1) * ROWS, dtype=np.float64)})
        for i in range(NBATCH)]
    s = TpuSession(dict(CONF), device="cpu")
    plan = s.plan(_union(s, frames_sorted).orderBy("v").plan)
    batches = list(plan.execute())
    vs = np.concatenate([b.column("v").data[:b.nrows].numpy()
                         for b in batches])
    np.testing.assert_array_equal(vs, np.arange(NBATCH * ROWS,
                                                dtype=np.float64))
    assert max(b.nrows for b in batches) <= (NBATCH + 1) * WINDOW


def test_out_of_core_sort_string_payload():
    rng = np.random.default_rng(5)
    frames_s = [pd.DataFrame({
        "v": rng.normal(size=ROWS),
        "s": np.array(["x" * 40 + "%05d" % i for i in
                       rng.integers(0, 10000, ROWS)])}) for _ in range(4)]
    _, _, got, want = _both(frames_s, lambda df, F: df.orderBy("v"))
    assert got["s"].tolist() == want["s"].tolist()
    np.testing.assert_array_equal(got["v"], want["v"])


def test_out_of_core_sort_through_disk(frames):
    """With a host tier of 64 kB the runs reach disk too; the answer is
    still the JAX package's, bit for bit, and no spill file outlives the
    session."""
    import os
    conf = dict(CONF)
    conf["spark.rapids.memory.host.spillStorageSize"] = 65536
    s, _, got, want = _both(frames, lambda df, F: df.orderBy(
        F.col("k"), F.col("v").desc()), conf)
    pd.testing.assert_frame_equal(got, want, check_dtype=False)
    s.memory_catalog.wait_for_writes()
    st = s.memory_catalog.stats()
    assert st["spilled_to_disk_total"] > 0 and st["integrity_failures"] == 0
    spill_dir = s.memory_catalog._spill_dir
    s.stop()
    assert spill_dir is None or not os.path.exists(spill_dir)


def test_operators_use_their_own_sessions_catalog(frames):
    """A plan's operators register in the catalog of the session that
    planned it, even when another session was made, or made and stopped,
    after it."""
    small = TpuSession(dict(CONF), device="cpu")
    df = _union(small, frames).orderBy(TF.col("v").desc())
    exec_ = small.plan(df.plan)
    other = TpuSession(device="cpu")
    other.stop()
    later = TpuSession(device="cpu")
    rows = sum(b.nrows for b in exec_.execute())
    assert rows == NBATCH * ROWS
    assert small.memory_catalog.spilled_to_host_total > 0
    assert later.memory_catalog.spilled_to_host_total == 0
    assert later.memory_catalog.stats()["num_handles"] == 0
    assert all(node.catalog is small.memory_catalog
               for node in _nodes(exec_))


def _nodes(exec_):
    yield exec_
    for c in exec_.children:
        yield from _nodes(c)
