"""Split-and-retry on device OOM in the PyTorch port
(``memory/retry.py``), on the CPU.

The cases of ``tests/test_retry.py``: OOMs are injected
(``inject_oom``, the port's one named injection point) and the recovered
answer must equal the uninjected one, and the JAX package's answer on
the same data, through project/filter, aggregate, join and sort.  A
``torch.OutOfMemoryError`` raised by hand is recovered like the caching
allocator's own; a host ``MemoryError`` is not.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.memory import retry as R
from spark_rapids_tpu_torch.memory.spill import SpillableBatchCatalog


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _clean_injector():
    R.clear_injected_oom()
    R.retry_metrics.reset()
    yield
    R.clear_injected_oom()


@pytest.fixture(scope="module", params=[True, False],
                ids=["pipeline", "no_pipeline"])
def sessions(request):
    conf = {"spark.rapids.tpu.pipeline.enabled": request.param}
    return TpuSession(conf, device="cpu"), JaxSession({})


def _batch(n=100, seed=0):
    rng = np.random.default_rng(seed)
    return ColumnarBatch.from_pydict({
        "a": rng.integers(0, 1000, n),
        "b": rng.normal(size=n),
        "s": [f"v{i}" for i in rng.integers(0, 50, n)],
    })


# ------------------------------------------------------------ classification --
def test_is_oom():
    assert not R.is_oom(MemoryError("host"))
    assert R.is_oom(R.InjectedOomError("x"))
    assert R.is_oom(torch.OutOfMemoryError("CUDA out of memory."))
    assert R.is_oom(torch.cuda.OutOfMemoryError("CUDA out of memory."))
    assert not R.is_oom(RuntimeError("out of memory"))
    assert not R.is_oom(ValueError("bad shape"))


# ------------------------------------------------------- with_retry_no_split --
def test_no_split_retries_and_spills():
    cat = SpillableBatchCatalog(device_budget=1 << 30)
    h = cat.register(_batch())
    calls = []

    def fn():
        calls.append(1)
        return 42

    R.inject_oom(1)
    assert R.with_retry_no_split(fn, catalog=cat) == 42
    assert len(calls) == 1          # the first attempt died at the point
    assert h.tier != "DEVICE"       # the recovery spilled the store
    snap = R.retry_metrics.snapshot()
    assert snap["retryCount"] == 1 and snap["spilledOnRetryBytes"] > 0


def test_torch_oom_is_recovered():
    """A torch.OutOfMemoryError (what the caching allocator raises) is
    spilled and retried; a host MemoryError passes straight through."""
    cat = SpillableBatchCatalog()
    state = {"n": 0}

    def fn():
        state["n"] += 1
        if state["n"] == 1:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried ...")
        return "ok"

    assert R.with_retry_no_split(fn, catalog=cat) == "ok"
    assert R.retry_metrics.snapshot()["retryCount"] == 1
    with pytest.raises(MemoryError):
        R.with_retry_no_split(
            lambda: (_ for _ in ()).throw(MemoryError("host")), catalog=cat)
    assert R.retry_metrics.snapshot()["retryCount"] == 1


def test_no_split_gives_up_after_max_retries():
    cat = SpillableBatchCatalog()
    R.inject_oom(5)
    with pytest.raises(R.InjectedOomError):
        R.with_retry_no_split(lambda: 1, catalog=cat, max_retries=2)
    # the budget comes from the catalog (the session's conf)
    cat.max_retries = 0
    R.inject_oom(1)
    with pytest.raises(R.InjectedOomError):
        R.with_retry_no_split(lambda: 1, catalog=cat)


def test_non_oom_errors_pass_through():
    cat = SpillableBatchCatalog()
    with pytest.raises(ValueError):
        R.with_retry_no_split(
            lambda: (_ for _ in ()).throw(ValueError("no")), catalog=cat)


# ---------------------------------------------------------------- with_retry --
def test_retry_splits_after_second_oom():
    cat = SpillableBatchCatalog()
    R.inject_oom(2)
    outs = list(R.with_retry([_batch(100)], lambda x: x.nrows, catalog=cat))
    assert sum(outs) == 100 and len(outs) >= 2
    assert R.retry_metrics.snapshot()["splitAndRetryCount"] >= 1


def test_retry_split_preserves_rows():
    cat = SpillableBatchCatalog()
    b = _batch(101, seed=3)
    want = b.to_pandas()
    R.inject_oom(2)
    parts = list(R.with_retry([b], lambda x: x.to_pandas(), catalog=cat))
    pd.testing.assert_frame_equal(pd.concat(parts, ignore_index=True), want)


def test_retry_unsplittable_raises():
    cat = SpillableBatchCatalog()
    R.inject_oom(20)
    with pytest.raises(R.SplitAndRetryOOM):
        list(R.with_retry([_batch(1)], lambda x: x.nrows, catalog=cat))


def test_retry_is_lazy_over_upstream():
    pulled = []

    def upstream():
        for i in range(5):
            pulled.append(i)
            yield _batch(10, seed=i)

    it = R.with_retry(upstream(), lambda b: b.nrows,
                      catalog=SpillableBatchCatalog())
    next(it)
    assert pulled == [0]


# ------------------------------------------------------------- through execs --
def _run_with_oom(sessions, build, num_ooms, skip=0, key=None):
    """(recovered, uninjected, JAX) answers, each sorted by ``key``."""
    s, js = sessions
    df = build(s, F)
    want = df.to_pandas()
    R.inject_oom(num_ooms, skip=skip)
    got = df.to_pandas()
    R.clear_injected_oom()
    jax = build(js, JF).to_pandas()
    if key is not None:
        got, want, jax = (x.sort_values(key, ignore_index=True)
                          for x in (got, want, jax))
    assert s.last_memory_stats["retryCount"] >= 1, s.last_memory_stats
    return got, want, jax


def _frame(rng, n):
    return pd.DataFrame({"x": rng.integers(0, 100, n),
                         "y": rng.normal(size=n)})


def test_project_filter_recover(sessions):
    pdf = _frame(np.random.default_rng(7), 500)

    def build(s, F):
        return (s.create_dataframe(pdf).filter(F.col("x") > 20)
                .select((F.col("x") * 2 + 1).alias("x2"), F.col("y")))

    got, want, jax = _run_with_oom(sessions, build, 2, key=["x2", "y"])
    pd.testing.assert_frame_equal(got, want)
    pd.testing.assert_frame_equal(got, jax, check_dtype=False)


def test_aggregate_recover(sessions):
    rng = np.random.default_rng(8)
    pdf = pd.DataFrame({"k": rng.integers(0, 9, 400),
                        "v": rng.normal(size=400)})

    def build(s, F):
        return s.create_dataframe(pdf).groupBy("k").agg(
            F.sum(F.col("v")).alias("s"), F.count(F.col("v")).alias("c"))

    got, want, jax = _run_with_oom(sessions, build, 2, key="k")
    np.testing.assert_array_equal(got["c"], want["c"])
    np.testing.assert_array_equal(got["c"], jax["c"])
    # a split adds the halves' partials in another grouping
    np.testing.assert_allclose(got["s"], want["s"], rtol=1e-12)
    np.testing.assert_allclose(got["s"], jax["s"], rtol=1e-12)


def test_join_recover(sessions):
    rng = np.random.default_rng(9)
    left = pd.DataFrame({"k": rng.integers(0, 30, 200),
                         "lv": rng.normal(size=200).round(3)})
    right = pd.DataFrame({"k": rng.integers(0, 30, 150),
                          "rv": rng.integers(0, 99, 150)})

    def build(s, F):
        return s.create_dataframe(left).join(s.create_dataframe(right),
                                             on="k", how="inner")

    got, want, jax = _run_with_oom(sessions, build, 2, skip=1,
                                   key=["k", "lv", "rv"])
    pd.testing.assert_frame_equal(got, want)
    pd.testing.assert_frame_equal(got[want.columns], jax[want.columns],
                                  check_dtype=False)


def test_full_join_empty_probe(sessions):
    s, _ = sessions
    left = s.create_dataframe(
        pd.DataFrame({"k": [1, 2, 3], "v": [1.0, 2.0, 3.0]})
    ).filter(F.col("k") > 99)
    right = s.create_dataframe(pd.DataFrame({"k": [1, 2], "w": [10, 20]}))
    out = left.join(right, on="k", how="full").to_pandas()
    assert len(out) == 2
    assert out["v"].isna().all()
    assert sorted(out["w"].tolist()) == [10, 20]


def test_sort_recover(sessions):
    pdf = pd.DataFrame({"k": np.random.default_rng(10).integers(0, 1000,
                                                                 300),
                        "v": np.random.default_rng(11).normal(size=300)})

    def build(s, F):
        return s.create_dataframe(pdf).orderBy("k", "v")

    got, want, jax = _run_with_oom(sessions, build, 1)
    pd.testing.assert_frame_equal(got, want)
    pd.testing.assert_frame_equal(got, jax, check_dtype=False)


def test_string_group_recover_splits(sessions):
    """Three OOMs in a row: spill, split, and the halves' string keys
    still come out as the uninjected run's."""
    rng = np.random.default_rng(12)
    pdf = pd.DataFrame({"s": [f"w{i}" for i in rng.integers(0, 20, 300)],
                        "v": rng.integers(0, 9, 300)})

    def build(s, F):
        return s.create_dataframe(pdf).groupBy("s").agg(
            F.sum("v").alias("t"))

    got, want, jax = _run_with_oom(sessions, build, 3, key="s")
    pd.testing.assert_frame_equal(got, want)
    pd.testing.assert_frame_equal(got, jax, check_dtype=False)
    assert sessions[0].last_memory_stats["splitAndRetryCount"] >= 1


def test_build_concat_oom_is_retried_whole(monkeypatch):
    """A device OOM inside the join build's concatenation (within the
    coalesce) spills and retries the concatenation with the pending
    batches still registered: the build is whole, the answer the
    uninjected one.  (The JAX package retries ``next()`` of the coalesce
    generator, which the OOM has already ended: its build comes back
    empty; ROADMAP queue 3.)"""
    from spark_rapids_tpu_torch.ops import concat as C
    rng = np.random.default_rng(13)
    left = pd.DataFrame({"k": rng.integers(0, 40, 300),
                         "lv": rng.integers(0, 9, 300)})
    right = pd.DataFrame({"k": rng.integers(0, 40, 200),
                          "rv": rng.integers(0, 9, 200)})
    s = TpuSession({"spark.rapids.sql.tpu.maxBatchRows": 64,
                    "spark.rapids.tpu.pipeline.enabled": False},
                   device="cpu")
    q = s.create_dataframe(left).join(s.create_dataframe(right), on="k")
    want = q.to_pandas()
    real = C.concat_batches
    calls = []

    def flaky(batches):
        calls.append(len(batches))
        if len(calls) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory (test)")
        return real(batches)

    monkeypatch.setattr(C, "concat_batches", flaky)
    got = q.to_pandas()
    key = ["k", "lv", "rv"]
    pd.testing.assert_frame_equal(got.sort_values(key, ignore_index=True),
                                  want.sort_values(key, ignore_index=True))
    assert calls[0] == calls[1] == 4      # the whole build, twice
    assert R.retry_metrics.snapshot()["retryCount"] == 1
