"""The PyTorch port's asynchronous pipeline (``exec/pipeline.py``), on the
CPU.

The pipelined drive of a multi-batch file scan yields the sequential
loop's batches, batch by batch and in order; a query's answer is the
same with the pipeline on and off (and equal to the JAX package's, whose
pipeline is on by default); closing the generator early joins the
worker; an exception on the worker re-raises on the driving thread with
its traceback; ``PipelineStats`` is filled in.
"""

import threading
import traceback

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.exec.pipeline import PipelineStats, pipelined

SMALL_BATCHES = {"spark.rapids.sql.reader.batchSizeRows": 64}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the host: one torch thread here."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe")
    rng = np.random.default_rng(17)
    paths = []
    for i in range(5):
        n = 300 + 37 * i
        p = str(d / f"part-{i}.parquet")
        pq.write_table(pa.table({
            "k": rng.integers(0, 9, n),
            "v": rng.normal(size=n),
            "s": [f"s{int(x)}" for x in rng.integers(0, 4, n)]}), p)
        paths.append(p)
    return paths


def _batches_host(batches):
    return [b.to_arrow() for b in batches]


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_pipelined_equals_sequential_batch_by_batch(files, depth):
    s = TpuSession(SMALL_BATCHES, device="cpu")
    plan_a = s.plan(s.read.parquet(*files).filter(F.col("v") > 0).plan)
    plan_b = s.plan(s.read.parquet(*files).filter(F.col("v") > 0).plan)
    seq = _batches_host(plan_a.execute())
    stats = PipelineStats(depth)
    pip = _batches_host(pipelined(plan_b.execute(), depth, stats))
    assert len(seq) == len(pip) > 5
    for a, b in zip(seq, pip):
        assert a.equals(b)
    assert stats.batches == len(seq)
    assert 0.0 <= stats.fill_ratio <= 1.0
    assert stats.gets == len(seq) + 1


def test_order_and_count_kept():
    src = iter(list(range(1000)))
    assert list(pipelined(src, 3)) == list(range(1000))
    assert list(pipelined(iter([]), 2)) == []


def test_query_same_with_pipeline_on_and_off(files):
    def q(s, f):
        return (s.read.parquet(*files).filter(f.col("k") != 3)
                .groupBy("s").agg(f.sum("v").alias("sv"),
                                  f.count().alias("n")).orderBy("s"))
    on = TpuSession(SMALL_BATCHES, device="cpu")
    off = TpuSession(dict(SMALL_BATCHES, **{
        "spark.rapids.tpu.pipeline.enabled": False}), device="cpu")
    got_on = q(on, F).to_pandas()
    stats = on.last_pipeline_stats
    assert stats is not None and stats.batches == 1
    got_off = q(off, F).to_pandas()
    assert off.last_pipeline_stats is None
    pd.testing.assert_frame_equal(got_on, got_off)
    js = JaxSession(SMALL_BATCHES)
    want = q(js, JF).to_pandas()
    js.stop()
    pd.testing.assert_frame_equal(got_on, want, check_dtype=False,
                                  rtol=1e-12)


def test_early_close_joins_the_worker():
    produced = []

    def source():
        for i in range(10_000):
            produced.append(i)
            yield i

    before = {t.ident for t in threading.enumerate()}
    gen = pipelined(source(), 2)
    assert next(gen) == 0 and next(gen) == 1
    gen.close()
    alive = [t for t in threading.enumerate()
             if t.ident not in before and t.name == "torch-pipeline"]
    assert not alive, "the worker thread outlived the close"
    # the worker stopped within its lookahead, far short of the source
    assert len(produced) <= 2 + 2 + 2


def test_limit_over_a_file_scan_stops_early(files):
    s = TpuSession(SMALL_BATCHES, device="cpu")
    got = s.read.parquet(*files).limit(10).to_pandas()
    assert len(got) == 10
    assert not [t for t in threading.enumerate()
                if t.name == "torch-pipeline"]


def test_worker_exception_reraises_with_traceback():
    def failing_source():
        yield 1
        raise_deep()

    with pytest.raises(KeyError, match="from the worker") as info:
        list(pipelined(failing_source(), 2))
    frames = [f.name for f in traceback.extract_tb(info.value.__traceback__)]
    assert "raise_deep" in frames and "failing_source" in frames


def raise_deep():
    raise KeyError("from the worker")


def test_reader_error_in_worker_reraises(files, tmp_path):
    bad = str(tmp_path / "bad.parquet")
    with open(bad, "wb") as f:
        f.write(b"not a parquet file")
    s = TpuSession({"spark.rapids.sql.format.parquet.reader.type":
                    "MULTITHREADED"}, device="cpu")
    df = s.read.parquet(files[0], files[1])
    df.plan.paths.append(bad)
    with pytest.raises(Exception, match="bad.parquet|Parquet|parquet"):
        df.to_pandas()


def test_pipeline_stats_filled_in(files):
    s = TpuSession(dict(SMALL_BATCHES, **{
        "spark.rapids.tpu.pipeline.depth": 3}), device="cpu")
    got = s.read.parquet(*files).to_pandas()
    st = s.last_pipeline_stats
    assert st.depth == 3
    assert st.batches >= len(got) // 64
    assert st.upload_overlap_ns > 0, "the scan uploaded on the worker"
    assert st.host_sync_count == 0, "a scan never waits for the device"
    s.read.parquet(*files).groupBy("s").agg(F.sum("v")).to_pandas()
    assert s.last_pipeline_stats.host_sync_count > 0
    d = st.as_dict()
    assert set(d) == {"depth", "batches", "pipelineFillRatio",
                      "hostSyncCount", "uploadOverlapMs", "consumerWaitMs"}
    with pytest.raises(ValueError, match="positive"):
        TpuSession({"spark.rapids.tpu.pipeline.depth": 0}, device="cpu")


def test_many_pipelines_at_once_keep_their_order():
    """More concurrent pipelines than cores, with a short switch
    interval: each still yields exactly its own source, in order."""
    import os
    import sys
    n = 2 * (os.cpu_count() or 2) + 2
    results = [None] * n

    def run(i):
        results[i] = list(pipelined(iter(range(i, i + 500)), 1 + i % 3))

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(before)
    assert results == [list(range(i, i + 500)) for i in range(n)]
