"""Worker processes for black-box Python UDF evaluation.

Counterpart of ``spark_rapids_tpu/udf/worker_pool.py`` (the reference's
pandas UDF execs reuse Spark's daemon-forked Python workers, gated by
``concurrentPythonWorkers``).  The engine runs in one process, so a
black-box UDF is bound by the GIL: the pool spreads row chunks over
``spawn``-started worker processes (spawn, not fork: the parent holds a
CUDA context, which a forked child must not inherit) and keeps them
across batches to amortize their start.

Off by default (``spark.rapids.sql.python.numWorkers = 0``).  A function
that does not pickle, or that a worker cannot rebuild (a lambda, a
function of ``__main__`` pickled by reference), and a pool whose process
died, degrade to inline evaluation; each degradation counts in
``pool_metrics`` (``degradedToInline``, with the last reason), so it is
never silent; a pool fault (a broken pool, the ``udf.worker`` injection
point) is also recorded on the session's recovery trail
(``record_degradation``).  The wait for the chunks is a ``udf.worker``
watchdog section that beats per chunk.

This module imports nothing of torch at import time: a worker that
imports it (to run ``_eval_chunk``) makes no CUDA call.
"""

from __future__ import annotations

import pickle
import threading
import weakref
from typing import List, Optional

_pool = None
_pool_size = 0
_lock = threading.Lock()

# functions that failed to pickle or to rebuild in a worker; weak, so a
# collected function never aliases a new one at its address
_unpicklable_fns: "weakref.WeakSet" = weakref.WeakSet()


class PoolMetrics:
    """Process-wide counters of the pool: ``poolStarts`` (processes
    pools started), ``poolChunks`` (row chunks a worker evaluated),
    ``poolRows``, ``degradedToInline`` and ``lastDegradation``."""

    KEYS = ("poolStarts", "poolChunks", "poolRows", "degradedToInline")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.counts = {k: 0 for k in self.KEYS}
        self.last_degradation = ""

    def bump(self, key: str, n: int = 1) -> None:
        self.counts[key] += n

    def snapshot(self) -> dict:
        return dict(self.counts, lastDegradation=self.last_degradation)


pool_metrics = PoolMetrics()


class WorkerUnpicklable(Exception):
    """The worker could not rebuild the function; raised before any row
    runs, so evaluating inline cannot repeat a side effect."""


def _eval_chunk(fn_bytes: bytes, rows: list) -> list:
    """In a worker: rebuild the function, then evaluate it per row (a row
    with a null argument gives null)."""
    try:
        fn = pickle.loads(fn_bytes)
    except Exception as e:
        raise WorkerUnpicklable(repr(e))
    return [None if any(v is None for v in r) else fn(*r) for r in rows]


def get_pool(num_workers: int):
    """The process-wide pool, remade when the size changes; None for 0."""
    global _pool, _pool_size
    if num_workers <= 0:
        return None
    with _lock:
        if _pool is not None and _pool_size == num_workers:
            return _pool
        if _pool is not None:
            _pool.shutdown(wait=False, cancel_futures=True)
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        _pool = ProcessPoolExecutor(
            max_workers=num_workers,
            mp_context=multiprocessing.get_context("spawn"))
        _pool_size = num_workers
        pool_metrics.bump("poolStarts")
        return _pool


def shutdown_pool() -> None:
    """Stop the pool's processes (the next use starts a new pool)."""
    global _pool, _pool_size
    with _lock:
        if _pool is not None:
            _pool.shutdown(wait=True, cancel_futures=True)
            _pool = None
            _pool_size = 0


def worth_trying(fn, nrows: int, num_workers: int,
                 min_rows_per_worker: int = 256) -> bool:
    """The cheap checks, before any row tuple is built."""
    if num_workers <= 0 or nrows < 2 * min_rows_per_worker:
        return False
    try:
        if fn in _unpicklable_fns:
            return False
    except TypeError:
        pass  # an unhashable callable retries the pickle
    return True


def _degrade(fn, reason: str, fault: Optional[str] = None) -> None:
    """Count a degradation to inline evaluation; a pool fault (``fault``
    names its kind) is also a recovery action on the session's trail
    (``robustness/driver.record_degradation``), though no exception ever
    reaches the query's driver."""
    pool_metrics.bump("degradedToInline")
    pool_metrics.last_degradation = reason
    if fn is not None:
        try:
            _unpicklable_fns.add(fn)
        except TypeError:
            pass
    if fault is not None:
        from spark_rapids_tpu_torch.api.session import TpuSession
        from spark_rapids_tpu_torch.robustness.driver import (
            record_degradation)
        record_degradation(TpuSession._active, fault, "inline_fallback",
                           reason)


def eval_rows(fn, rows: List[tuple], num_workers: int,
              min_rows_per_worker: int = 256) -> Optional[list]:
    """``fn`` over ``rows`` on the pool, in order; None when the pool does
    not apply (off, too few rows) or degrades (the caller then evaluates
    inline).  An exception of the function itself propagates: running
    the rows again inline would repeat the side effects of the rows that
    completed."""
    if not worth_trying(fn, len(rows), num_workers, min_rows_per_worker):
        return None
    # "udf.worker" models the pool dying before any row evaluates:
    # degrade to inline evaluation exactly as a broken pool does below
    from spark_rapids_tpu_torch.robustness import watchdog
    from spark_rapids_tpu_torch.robustness.faults import InjectedWorkerFault
    from spark_rapids_tpu_torch.robustness.inject import fire
    try:
        fire("udf.worker")
    except InjectedWorkerFault as e:
        shutdown_pool()
        _degrade(None, f"{type(e).__name__}: {e}", e.kind)
        return None
    try:
        fn_bytes = pickle.dumps(fn)
    except Exception as e:
        _degrade(fn, f"the function does not pickle: {e!r}")
        return None
    pool = get_pool(num_workers)
    chunk = max(min_rows_per_worker, -(-len(rows) // num_workers))
    import concurrent.futures as cf
    from concurrent.futures.process import BrokenProcessPool

    def _result(f):
        # poll instead of a bare f.result(): the wait is the driving
        # thread's cancellation checkpoint, so a worker process stuck in
        # user code trips the deadline and the TimeoutFault is
        # delivered here
        while not f.done():
            watchdog.checkpoint()
            cf.wait([f], timeout=0.05)
        return f.result()

    try:
        futures = [pool.submit(_eval_chunk, fn_bytes, rows[i:i + chunk])
                   for i in range(0, len(rows), chunk)]
        # a "udf.worker" section that beats per finished chunk: the
        # deadline measures silence, so a slow stage that keeps
        # finishing chunks never trips while a wedged worker does
        with watchdog.section("udf.worker") as sect:
            out: list = []
            for f in futures:
                out.extend(_result(f))
                if sect is not None:
                    sect.beat()
    except WorkerUnpicklable as e:
        _degrade(fn, f"a worker could not rebuild the function: {e}")
        return None
    except BrokenProcessPool as e:
        shutdown_pool()
        _degrade(None, f"the pool broke: {e!r}", "udf_worker")
        return None
    pool_metrics.bump("poolChunks", len(futures))
    pool_metrics.bump("poolRows", len(rows))
    return out
