"""Split-and-retry on device out-of-memory.

Counterpart of ``spark_rapids_tpu/memory/retry.py`` (the reference's
``DeviceMemoryEventHandler.onAllocFailure``: spill the device store and
try the allocation again, plus the split-and-retry iterators its
operators layer on top).  PyTorch's caching allocator raises
``torch.OutOfMemoryError`` (also ``torch.cuda.OutOfMemoryError``) when
an allocation cannot be met even after it freed its cached blocks; the
wrappers here catch exactly that, demote every registered spillable
batch off the device and try again; a second failure at the same size
splits the input batch in half (down to one row).  No other recovery
exists: nothing gives way to the CPU or to a plain version.

A host ``MemoryError`` is not recoverable: the recovery (a host copy,
the split's round trip) allocates host memory and would add to the very
pressure that raised it.

Test hook: ``inject_oom(num_ooms, skip)`` makes the next ``num_ooms``
guarded attempts on this thread (after ``skip`` of them pass) raise
``InjectedOomError``.  Every guarded attempt passes the ``memory.oom``
point of the unified injection registry (``robustness/inject.py``), so
``inject_oom`` is a wrapper over ``inject("memory.oom", ...)``, as in the
JAX package.  An OOM that outlives these retries leaves the operator and
reaches the query's recovery driver (``robustness/driver.py``).
"""

from __future__ import annotations

import gc
import threading
from collections import deque
from typing import Callable, Iterable, Iterator, List, Optional, TypeVar

import torch

T = TypeVar("T")
R = TypeVar("R")


class InjectedOomError(MemoryError):
    """The synthetic OOM of the test hook."""


class SplitAndRetryOOM(MemoryError):
    """An attempt still ran out of memory at the one-row floor: the work
    cannot be made to fit."""


def is_oom(exc: BaseException) -> bool:
    """True for device memory exhaustion only (and the injected error);
    a host ``MemoryError`` is not."""
    if isinstance(exc, InjectedOomError):
        return True
    return isinstance(exc, torch.OutOfMemoryError)


# ---------------------------------------------------------------- injection --
# the OOM checkpoint is one named point of the unified injection registry
# (robustness/inject.py); inject_oom stays as the wrapper the retry tests
# call.  A pipeline worker adopts its driving thread there
# (exec/pipeline.worker_attribution), so it takes that thread's rule.
from spark_rapids_tpu_torch.robustness import inject as _inject  # noqa: E402

_inject.register_point("memory.oom", InjectedOomError)


def inject_oom(num_ooms: int = 1, skip: int = 0) -> None:
    """Force the next ``num_ooms`` guarded attempts on this thread, after
    ``skip`` attempts that pass, to raise ``InjectedOomError`` (the last
    call wins: it replaces this thread's earlier rule, never another
    thread's).  Equivalent to ``inject("memory.oom", count=num_ooms,
    skip=skip)``."""
    _inject.clear("memory.oom", this_thread_only=True)
    _inject.inject("memory.oom", count=num_ooms, skip=skip,
                   exc=InjectedOomError)


def clear_injected_oom() -> None:
    _inject.clear("memory.oom", this_thread_only=True)


def _checkpoint() -> None:
    """The injection point ``memory.oom``: every guarded attempt passes
    here first."""
    _inject.fire("memory.oom")


# ------------------------------------------------------------------ metrics --
_ZERO = {"retryCount": 0, "splitAndRetryCount": 0, "spilledOnRetryBytes": 0}


class RetryMetrics:
    """Recovery counters: process-wide totals and a per-thread view, where
    a pipeline worker counts for the thread that drives it (``adopt``),
    so a query's retries are read on the thread that ran it."""

    def __init__(self):
        self.lock = threading.Lock()
        self.retry_count = 0
        self.split_count = 0
        self.spilled_on_retry = 0
        self._per_thread = {}
        self._owner = {}

    def _effective_ident(self) -> int:
        ident = threading.get_ident()
        return self._owner.get(ident, ident)

    def _bump(self, retries=0, splits=0, spilled=0) -> None:
        with self.lock:
            self.retry_count += retries
            self.split_count += splits
            self.spilled_on_retry += spilled
            loc = self._per_thread.setdefault(self._effective_ident(),
                                              dict(_ZERO))
            loc["retryCount"] += retries
            loc["splitAndRetryCount"] += splits
            loc["spilledOnRetryBytes"] += spilled

    def snapshot(self) -> dict:
        with self.lock:
            return {"retryCount": self.retry_count,
                    "splitAndRetryCount": self.split_count,
                    "spilledOnRetryBytes": self.spilled_on_retry}

    def snapshot_local(self) -> dict:
        """This thread's counters (the per-query view)."""
        with self.lock:
            return dict(self._per_thread.get(self._effective_ident(), _ZERO))

    def adopt(self, owner_ident: int) -> None:
        """Count this thread's recoveries as ``owner_ident``'s (the
        pipeline's worker)."""
        with self.lock:
            self._owner[threading.get_ident()] = owner_ident

    def release(self) -> None:
        with self.lock:
            self._owner.pop(threading.get_ident(), None)

    def disown(self, ident: int) -> None:
        """Sever ``ident``'s adoption from the outside (a driver
        abandoning a wedged worker thread)."""
        with self.lock:
            self._owner.pop(ident, None)

    def purge_owner(self, owner_ident: int) -> None:
        """Drop every adoption mapping TO ``owner_ident`` (the query-exit
        cleanup, serving/context.QueryContext.__exit__); the per-thread
        counters survive, since callers take deltas across queries."""
        from spark_rapids_tpu_torch.robustness.inject import purge_adoptions
        with self.lock:
            purge_adoptions(self._owner, owner_ident)

    def reset(self) -> None:
        with self.lock:
            self.retry_count = 0
            self.split_count = 0
            self.spilled_on_retry = 0
            self._per_thread.clear()


retry_metrics = RetryMetrics()

# ----------------------------------------------------------------- recovery --
# serialises the budget save/zero/restore: two threads recovering at once
# must not leave the shared catalog's budget at 0
_recovery_lock = threading.Lock()


def _catalog(catalog=None):
    if catalog is None:
        from spark_rapids_tpu_torch.memory.spill import default_catalog
        catalog = default_catalog()
    return catalog


def _spill_device_store(catalog=None) -> int:
    """Demote every registered batch off the device (the
    synchronousSpill(targetSize=0) step of onAllocFailure); returns the
    bytes moved."""
    catalog = _catalog(catalog)
    with _recovery_lock:
        before = catalog.spilled_to_host_total
        saved = catalog.device_budget
        try:
            catalog.device_budget = 0
            catalog.ensure_budget()
        finally:
            catalog.device_budget = saved
        return catalog.spilled_to_host_total - before


def _handle_oom(catalog=None) -> None:
    """Runs after the ``except`` block that caught the OOM has ended:
    while the handler is live, the exception's traceback holds the failed
    attempt's frame and its tensors, so neither the collection nor the
    spill here could hand their memory back to the allocator."""
    gc.collect()
    freed = _spill_device_store(catalog)
    retry_metrics._bump(retries=1, spilled=freed)


# ----------------------------------------------------------------- wrappers --
def _resolve_max_retries(catalog=None) -> int:
    """The catalog's budget: the session sets it from
    ``spark.rapids.memory.oomRetry.maxRetries``."""
    return _catalog(catalog).max_retries


def with_retry_no_split(fn: Callable[[], R], *, catalog=None,
                        max_retries: Optional[int] = None) -> R:
    """Run ``fn``; on a device OOM spill the device store and run it
    again, at most ``max_retries`` times.  For work that cannot be
    divided (one already-sized output batch)."""
    if max_retries is None:
        max_retries = _resolve_max_retries(catalog)
    attempt = 0
    while True:
        try:
            _checkpoint()
            return fn()
        except Exception as e:  # noqa: BLE001 - classified below
            if not is_oom(e) or attempt >= max_retries:
                raise
            attempt += 1
        # after the except block: see _handle_oom
        _handle_oom(catalog)


def split_batch_in_half(batch) -> List:
    """One ColumnarBatch as two of half its rows each (views of its
    buffers; a string half's offsets rebased), so the failed attempt's
    scratch halves with them."""
    n = batch.nrows
    if n <= 1:
        raise SplitAndRetryOOM(
            f"cannot split a batch of {n} row(s) any further")
    from spark_rapids_tpu_torch.exec.basic import slice_batch
    mid = n // 2
    return slice_batch(batch, [0, mid, n])


def with_retry(inputs: Iterable[T], fn: Callable[[T], R], *,
               split: Callable[[T], List[T]] = split_batch_in_half,
               catalog=None) -> Iterator[R]:
    """Map ``fn`` over ``inputs`` with OOM recovery.

    Per input: the first OOM spills the device store and retries at full
    size; an OOM on the retry splits the input and queues the halves,
    each treated the same way in turn.  One result per final attempt, so
    callers must accept ``fn``'s unit of work shrinking.  ``inputs`` is
    pulled lazily, one upstream batch at a time."""
    upstream = iter(inputs)
    queue: deque = deque()
    while True:
        if queue:
            item = queue.popleft()
        else:
            try:
                item = next(upstream)
            except StopIteration:
                return
        spilled_once = False
        while True:
            must_split = False
            try:
                _checkpoint()
                result = fn(item)
            except Exception as e:  # noqa: BLE001 - classified below
                # SplitAndRetryOOM from the one-row floor re-raises here
                if not is_oom(e):
                    raise
                must_split = spilled_once
            else:
                yield result
                break
            # after the except block: see _handle_oom
            if not must_split:
                spilled_once = True
                _handle_oom(catalog)
                continue
            halves = split(item)
            retry_metrics._bump(splits=1)
            for h in reversed(halves):
                queue.appendleft(h)
            break
