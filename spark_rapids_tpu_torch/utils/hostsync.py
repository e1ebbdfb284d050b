"""Device -> host fetches, counted.

Counterpart of ``spark_rapids_tpu/utils/hostsync.py``.  Every value the
host needs from the device on the query path (a row count, the key ranges
that pick a group-by path, a hash-overflow flag, the final result) comes
through :func:`fetch`, which counts one sync per call, so a run can say how
often the host waited for the card.  Host -> device uploads time
themselves into the calling thread's watcher (:func:`watch_uploads`), as
the pipeline's worker asks.

Every counted sync is also:

* a watchdog cancellation checkpoint (``robustness/watchdog.checkpoint``),
  the place the driving thread provably touches the host.  The checkpoint
  runs *before* the copy: a sync blocked on the card cannot be
  interrupted, so a deadline that trips during it surfaces at the next
  checkpoint after it returns;
* charged to the owning query's sync budget
  (``spark.rapids.tpu.serving.syncBudget``, ``QueryContext.charge_syncs``);
* a ``hostsync.fetch`` span when tracing is on.  CUDA work is
  asynchronous, so this span is where the device time of the work
  enqueued before it shows up on the host's clock.

Process-wide totals plus a per-thread view, where a pipeline worker
counts for the thread that drives it (``adopt``), so per-query deltas
read the driving thread's view.
"""

from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch


class HostSyncMetrics:
    """Process-wide count of device->host synchronisations, with a
    per-thread view."""

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self._per_thread = {}  # effective thread ident -> count
        self._owner = {}       # worker ident -> owning (driving) ident

    def _effective_ident(self) -> int:
        ident = threading.get_ident()
        return self._owner.get(ident, ident)

    def bump(self, n: int = 1) -> None:
        with self._lock:
            self.count += n
            ident = self._effective_ident()
            self._per_thread[ident] = self._per_thread.get(ident, 0) + n

    def snapshot(self) -> int:
        with self._lock:
            return self.count

    def snapshot_local(self) -> int:
        """This thread's (or its driving thread's) count."""
        with self._lock:
            return self._per_thread.get(self._effective_ident(), 0)

    def adopt(self, owner_ident: int) -> None:
        """Attribute this thread's syncs to ``owner_ident``'s view (the
        pipeline worker adopts its driving thread)."""
        with self._lock:
            self._owner[threading.get_ident()] = owner_ident

    def release(self) -> None:
        with self._lock:
            self._owner.pop(threading.get_ident(), None)

    def disown(self, ident: int) -> None:
        """Sever ``ident``'s adoption from the outside (a driver
        abandoning a wedged worker thread)."""
        with self._lock:
            self._owner.pop(ident, None)

    def purge_owner(self, owner_ident: int) -> None:
        """Drop every adoption mapping TO ``owner_ident`` (the query-exit
        cleanup, serving/context.QueryContext.__exit__): the OS reuses
        idents, so a stale entry would attribute a new query's syncs to
        this dead one.  The per-thread counters survive."""
        from spark_rapids_tpu_torch.robustness.inject import purge_adoptions
        with self._lock:
            purge_adoptions(self._owner, owner_ident)

    def reset(self) -> None:
        with self._lock:
            self.count = 0
            self._per_thread.clear()


host_sync_metrics = HostSyncMetrics()


def _charge_budget(n: int) -> None:
    """The owning QueryContext counts every sync against
    ``spark.rapids.tpu.serving.syncBudget`` and rejects THIS query (a
    typed BudgetExhaustedFault) past it.  One dict probe when no context
    is active."""
    from spark_rapids_tpu_torch.serving import context as qc
    ctx = qc.current()
    if ctx is not None:
        ctx.charge_syncs(n)


def count_sync(n: int = 1) -> None:
    """Record ``n`` device->host synchronisations made outside
    :func:`fetch` (a checkpoint, a budget charge and a count)."""
    from spark_rapids_tpu_torch.robustness import watchdog
    watchdog.checkpoint()
    host_sync_metrics.bump(n)
    _charge_budget(n)


_upload_sink = threading.local()


def watch_uploads(stats) -> None:
    """Route this thread's upload timings into ``stats`` (any object with
    an ``upload_overlap_ns`` attribute)."""
    _upload_sink.sink = stats


def unwatch_uploads() -> None:
    _upload_sink.sink = None


def note_upload(ns: int) -> None:
    sink = getattr(_upload_sink, "sink", None)
    if sink is not None:
        sink.upload_overlap_ns += ns


def _to_host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def fetch(*tensors):
    """Copy tensors to the host as numpy arrays, counted as ONE sync: the
    first copy waits for the stream, the rest find their data ready.
    Returns the arrays in input order (a single tensor returns the bare
    array)."""
    from spark_rapids_tpu_torch.utils import tracing
    count_sync(1)
    with tracing.span("hostsync.fetch"):
        got = [_to_host(t) for t in tensors]
    return got[0] if len(tensors) == 1 else got


def fetch_all(tensors: Sequence) -> list:
    """List form of :func:`fetch` (always returns a list)."""
    if not tensors:
        return []
    from spark_rapids_tpu_torch.utils import tracing
    count_sync(1)
    with tracing.span("hostsync.fetch"):
        return [_to_host(t) for t in tensors]
