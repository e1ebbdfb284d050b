"""The chunked window of the PyTorch port (``exec/window.py``), on the
CPU: the cases of ``tests/test_window_chunked.py``.

A window with partition keys sits over its sort and streams chunks of
``spark.rapids.sql.window.batchRows`` rows, carrying running state across
chunk edges inside a partition.  Each answer equals the JAX package's
(same data, same conf), and the port's whole-input answer (a batchRows
larger than the input: one chunk), floats within a relative 1e-9 (the
carry adds a running sum in another grouping), everything else exactly;
the chunk counts equal the JAX package's output batches.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.functions import Window as JWindow
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.api.functions import Window as TWindow
from spark_rapids_tpu_torch.api.session import TpuSession

RTOL = 1e-9
WHOLE = 1 << 30


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    n = 6000
    pdf = pd.DataFrame({
        "g": rng.integers(0, 37, n),
        "s": rng.choice(["ash", "birch", "cedar"], n),
        "o": rng.permutation(n),
        "v": rng.uniform(-3, 3, n).round(3),
    })
    pdf.loc[rng.choice(n, 150, replace=False), "v"] = np.nan
    return pdf


def _conf(batch_rows, extra=None):
    conf = {"spark.rapids.sql.window.batchRows": str(batch_rows)}
    conf.update(extra or {})
    return conf


def _windows(exec_):
    from spark_rapids_tpu_torch.exec.window import TpuWindowExec
    out = [exec_] if isinstance(exec_, TpuWindowExec) else []
    for c in exec_.children:
        out.extend(_windows(c))
    return out


def _run(pdf, build, batch_rows, order, extra=None):
    """(port answer, port whole-input answer, JAX answer, port chunks,
    JAX output batches) of ``build(df, F, Window)``, sorted by ``order``."""
    s = TpuSession(_conf(batch_rows, extra), device="cpu")
    q = build(s.create_dataframe(pdf), TF, TWindow)
    plan = s.plan(q.plan)
    got_batches = list(plan.execute())
    chunks = sum(w.metrics["windowChunks"].value for w in _windows(plan))
    got = pd.concat([b.to_pandas() for b in got_batches],
                    ignore_index=True)
    whole = build(TpuSession(_conf(WHOLE), device="cpu").create_dataframe(
        pdf), TF, TWindow).to_pandas()
    js = JaxSession(_conf(batch_rows, extra))
    jq = build(js.create_dataframe(pdf), JF, JWindow)
    jbatches = list(js.plan(jq.plan).execute())
    jax = pd.concat([b.to_pandas() for b in jbatches], ignore_index=True)
    got, whole, jax = (x.sort_values(order, ignore_index=True)
                       for x in (got, whole, jax))
    return got, whole, jax, chunks, len(jbatches)


def _equal(a, b):
    pd.testing.assert_frame_equal(a, b, rtol=RTOL, check_dtype=False)


def test_chunked_running_window(data):
    def build(df, F, Window):
        w = Window.partitionBy("g").orderBy("o")
        return df.select(
            "g", "o", F.window_sum("v").over(w).alias("rs"),
            F.row_number().over(w).alias("rn"),
            F.window_count("v").over(w).alias("rc"),
            F.window_min("v").over(w).alias("rm"),
            F.window_avg("v").over(w).alias("ra"))

    got, whole, jax, chunks, jchunks = _run(data, build, 512, ["g", "o"])
    _equal(got, jax)
    _equal(got, whole)
    assert chunks == jchunks and chunks > 4


def test_giant_partition_running_carry(data):
    """One partition many times the chunk: the carry crosses every chunk
    edge."""
    def build(df, F, Window):
        w = Window.partitionBy("g").orderBy("o")
        return df.select("o", F.window_sum("v").over(w).alias("rs"),
                         F.row_number().over(w).alias("rn"),
                         F.window_max("v").over(w).alias("mx"))

    got, whole, jax, chunks, jchunks = _run(data.assign(g=0), build, 256,
                                            ["o"])
    _equal(got, jax)
    _equal(got, whole)
    assert chunks == jchunks and chunks >= len(data) // 256
    np.testing.assert_array_equal(got["rn"], np.arange(len(data)) + 1)


def test_rank_key_aligned_chunks(data):
    """rank and percent_rank are not running: chunks end only at
    partition boundaries, so they stay exact."""
    def build(df, F, Window):
        w = Window.partitionBy("g").orderBy("o")
        return df.select("g", "o", F.rank().over(w).alias("rk"),
                         F.percent_rank().over(w).alias("pr"))

    got, whole, jax, chunks, jchunks = _run(data, build, 256, ["g", "o"])
    _equal(got, jax)
    _equal(got, whole)
    assert chunks == jchunks


def test_string_partition_keys_chunked(data):
    def build(df, F, Window):
        w = Window.partitionBy("s").orderBy("o")
        return df.select("s", "o", F.window_sum("v").over(w).alias("rs"))

    got, whole, jax, chunks, jchunks = _run(data, build, 512, ["s", "o"])
    _equal(got, jax)
    _equal(got, whole)
    assert chunks == jchunks


def test_range_frame_tie_runs_across_chunks():
    """RANGE running frames take the whole tie run: splits land where the
    order key changes, even when one partition spans many chunks."""
    n = 200
    pdf = pd.DataFrame({"g": np.zeros(n, np.int64),
                        "o": np.repeat(np.arange(n // 5), 5),
                        "v": np.ones(n)})

    def build(df, F, Window):
        w = Window.partitionBy("g").orderBy("o")
        return df.select("o", F.window_sum("v").over(w).alias("rs"))

    got, whole, jax, chunks, jchunks = _run(pdf, build, 16, ["o", "rs"])
    np.testing.assert_array_equal(got["rs"], (got["o"] + 1) * 5.0)
    _equal(got, jax)
    _equal(got, whole)
    assert chunks == jchunks


def test_window_over_spilling_sort(data):
    """The sort under the window takes the out-of-core merge and spills
    to the host; the chunked answer is unchanged."""
    extra = {"spark.rapids.sql.sort.outOfCoreThresholdBytes": "20000",
             "spark.rapids.sql.sort.outOfCoreWindowRows": "1024",
             "spark.rapids.memory.tpu.deviceLimitBytes": "65536",
             "spark.rapids.sql.tpu.maxBatchRows": "1000"}

    def build(df, F, Window):
        w = Window.partitionBy("g").orderBy("o")
        return df.select("g", "o", F.window_sum("v").over(w).alias("rs"))

    s = TpuSession(_conf(512, extra), device="cpu")
    got = build(s.create_dataframe(data), TF, TWindow).to_pandas() \
        .sort_values(["g", "o"], ignore_index=True)
    assert s.memory_catalog.spilled_to_host_total > 0
    js = JaxSession(_conf(512, extra))
    jax = build(js.create_dataframe(data), JF, JWindow).to_pandas() \
        .sort_values(["g", "o"], ignore_index=True)
    _equal(got, jax)


def _direct_window(pdfs, batch_rows):
    """TpuWindowExec driven directly (presorted, a ROWS running sum and
    row_number over g, ordered by o), one input batch per frame, so the
    chunk edges land where the test puts them."""
    from spark_rapids_tpu_torch.columnar import dtypes as dts
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.exec.basic import TpuScanExec
    from spark_rapids_tpu_torch.exec.window import (
        Frame, TpuWindowExec, WindowExpression, WindowSpec)
    from spark_rapids_tpu_torch.ops.expressions import BoundReference
    batches = [ColumnarBatch.from_pandas(p) for p in pdfs]
    schema = [("g", dts.INT64), ("o", dts.INT64), ("v", dts.FLOAT64)]
    child = TpuScanExec(batches, schema, 1 << 20)
    spec = WindowSpec([BoundReference(0, dts.INT64, "g")],
                      [(BoundReference(1, dts.INT64, "o"), False, True)],
                      Frame("rows", None, 0))
    exprs = [("rs", WindowExpression("sum", spec,
                                     BoundReference(2, dts.FLOAT64, "v"))),
             ("rn", WindowExpression("row_number", spec))]
    ex = TpuWindowExec(exprs, child, torch.device("cpu"), presorted=True,
                       batch_rows=batch_rows)
    return pd.concat([b.to_pandas() for b in ex.execute()],
                     ignore_index=True)


def test_partition_ends_exactly_at_chunk_edge():
    """A chunk consumed whole with its last partition open: the next
    chunk starts a new partition, so the carry must be dropped."""
    out = _direct_window([
        pd.DataFrame({"g": [0, 0, 0, 0], "o": [0, 1, 2, 3],
                      "v": [1.0, 2.0, 3.0, 4.0]}),
        pd.DataFrame({"g": [1, 1], "o": [0, 1], "v": [10.0, 20.0]}),
    ], batch_rows=4)
    assert out.rs.tolist() == [1.0, 3.0, 6.0, 10.0, 10.0, 30.0]
    assert out.rn.tolist() == [1, 2, 3, 4, 1, 2]


def test_same_partition_resumes_after_exact_chunk_edge():
    out = _direct_window([
        pd.DataFrame({"g": [0] * 4, "o": [0, 1, 2, 3], "v": [1.0] * 4}),
        pd.DataFrame({"g": [0] * 4, "o": [4, 5, 6, 7], "v": [1.0] * 4}),
    ], batch_rows=4)
    assert out.rs.tolist() == [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0]
    assert out.rn.tolist() == [1, 2, 3, 4, 5, 6, 7, 8]


@pytest.mark.parametrize("g,fn,chunk", [
    (None, "sum", 256), (0, "sum", 256), ("twelve", "rank", 128)],
    ids=["partitions", "one_partition", "rank_partitions_past_a_chunk"])
def test_chunks_stage_only_their_rows(data, g, fn, chunk):
    """Each chunk evaluates its key and input expressions over the rows
    that decide its split and the rows it emits, not over everything
    still buffered: the rows staged stay within a few times the input's.
    ``rank`` carries no running state, so a partition past a chunk is
    emitted whole once its end is found."""
    if g == "twelve":
        pdf = data.assign(g=np.arange(len(data)) % 12)
    else:
        pdf = data if g is None else data.assign(g=g)
    s = TpuSession(_conf(chunk), device="cpu")
    w = TWindow.partitionBy("g", "s").orderBy("o") if fn == "sum" else \
        TWindow.partitionBy("g").orderBy("o")
    out = TF.window_sum("v").over(w) if fn == "sum" else \
        TF.rank().over(w)
    q = s.create_dataframe(pdf).select("g", "s", "o", out.alias("r"))
    plan = s.plan(q.plan)
    (win,) = _windows(plan)
    staged = []
    inner = win._pre_fn

    def counting(batch):
        staged.append(batch.nrows)
        return inner(batch)

    win._pre_fn = counting
    rows = sum(b.nrows for b in plan.execute())
    assert rows == len(pdf)
    assert win.metrics["windowChunks"].value > len(pdf) // 512
    assert sum(staged) <= 3 * len(pdf), sum(staged)
