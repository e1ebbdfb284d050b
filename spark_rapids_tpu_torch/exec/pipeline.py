"""The bounded asynchronous pipeline.

Counterpart of ``spark_rapids_tpu/exec/pipeline.py``.  ``pipelined(source,
depth)`` re-drives an operator iterator from a worker thread with a
bounded queue: the worker pulls batches (reader decode, host -> device
upload, kernel launches) while the driving thread drains the batches
already made.

* ``depth`` bounds the queue (``spark.rapids.tpu.pipeline.depth``): the
  worker blocks on a full queue, the consumer on an empty one.  Every
  in-flight batch is registered in the spill catalog at
  ``ACTIVE_ON_DECK_PRIORITY`` before it enters the queue, so a stalled
  consumer's batches can still leave the device under pressure; the
  consumer restores and closes each one as it takes it.
* The worker acts for the driving thread in every thread-attributed
  registry at once (``worker_attribution``): injection rules, the
  watchdog, the query's context, host-sync and OOM-retry counters.
* The worker runs inside a ``pipeline.worker`` watchdog section and
  beats on every batch and while the queue is full, so the deadline
  measures silence; the consumer's queue wait is a cancellation
  checkpoint, where a trip surfaces as a retryable ``TimeoutFault``.
* An exception on the worker re-raises on the driving thread with its
  original traceback.
* Closing the returned generator early (LIMIT, an error in the consumer)
  stops the worker at its next queue put, closes the registrations it
  had queued and joins the thread, for at most a second: a wedged worker
  is abandoned (``disown_worker``) rather than joined forever.
* The batches, and their order, are those of the sequential loop.

Streams: the worker runs with the session's device current (a new
thread's current device is ``cuda:0``) and issues its device work on
that device's default CUDA stream, as the driving thread does, so every batch it hands over is ordered
before anything the consumer enqueues and no event is needed.  The
overlap the pipeline buys is on the host: the worker decodes, stages
and enqueues the next batches (the reader's pool decodes files ahead of
it) while the device runs the work already enqueued and the consumer
takes the results.  Copies and kernels do not overlap each other on the
device.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Iterator, Optional

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch

_DONE = object()


@contextlib.contextmanager
def worker_attribution(owner_ident: int, stats=None):
    """Make the calling thread act as ``owner_ident`` for every
    thread-attributed registry at once: fault-injection rules
    (robustness/inject.py), watchdog sections and tokens
    (robustness/watchdog.py), the query context (serving/context.py),
    host-sync accounting and upload timing (utils/hostsync.py), and
    OOM-retry counters (memory/retry.py).  The one place that knows the
    whole adoption set."""
    from spark_rapids_tpu_torch.memory.retry import retry_metrics
    from spark_rapids_tpu_torch.robustness import inject, watchdog
    from spark_rapids_tpu_torch.serving import context as qcontext
    from spark_rapids_tpu_torch.utils import hostsync
    inject.adopt_thread(owner_ident)
    watchdog.adopt_thread(owner_ident)
    qcontext.adopt_thread(owner_ident)
    hostsync.host_sync_metrics.adopt(owner_ident)
    retry_metrics.adopt(owner_ident)
    if stats is not None:
        hostsync.watch_uploads(stats)
    try:
        yield
    finally:
        if stats is not None:
            hostsync.unwatch_uploads()
        retry_metrics.release()
        hostsync.host_sync_metrics.release()
        qcontext.release_thread()
        watchdog.release_thread()
        inject.release_thread()


def disown_worker(ident: int) -> None:
    """Sever a worker thread's adopted identity in every registry
    ``worker_attribution`` enrolled it in (a driver abandoning a wedged
    worker): when it unwedges it must not take the driver's next
    attempt's cancellation token or rule budgets, nor count its syncs
    and retries into the next query's views."""
    from spark_rapids_tpu_torch.memory.retry import retry_metrics
    from spark_rapids_tpu_torch.robustness import inject, watchdog
    from spark_rapids_tpu_torch.serving import context as qcontext
    from spark_rapids_tpu_torch.utils import hostsync
    watchdog.disown(ident)
    inject.disown(ident)
    qcontext.disown(ident)
    hostsync.host_sync_metrics.disown(ident)
    retry_metrics.disown(ident)


class PipelineStats:
    """One pipelined drive's counters.

    ``fill_ratio``: mean queue occupancy (0..1) sampled at each consumer
    get; 1.0 means the worker always had a batch ready, about 0 that the
    consumer waited on the worker.  ``host_sync_count``: counted
    device -> host syncs of the driving thread's query while the
    pipeline ran.
    ``upload_overlap_ns``: host time of the uploads made on the worker
    thread (time the sequential loop would spend on the driving thread).
    ``wait_ns``: consumer time blocked on an empty queue."""

    def __init__(self, depth: int):
        self.depth = depth
        self.batches = 0
        self.gets = 0
        self.fill_sum = 0.0
        self.upload_overlap_ns = 0
        self.host_sync_count = 0
        self.wait_ns = 0
        # batches the worker registered in the spill catalog
        self.registered = 0

    @property
    def fill_ratio(self) -> float:
        return (self.fill_sum / self.gets) if self.gets else 0.0

    def as_dict(self) -> dict:
        from spark_rapids_tpu_torch.exec.base import (
            HOST_SYNC_COUNT, PIPELINE_FILL_RATIO, UPLOAD_OVERLAP_MS)
        return {
            "depth": self.depth,
            "batches": self.batches,
            PIPELINE_FILL_RATIO: round(self.fill_ratio, 4),
            HOST_SYNC_COUNT: self.host_sync_count,
            UPLOAD_OVERLAP_MS: round(self.upload_overlap_ns / 1e6, 3),
            "consumerWaitMs": round(self.wait_ns / 1e6, 3),
        }


def _put(q: "queue.Queue", stop: threading.Event, item,
         beat=None) -> bool:
    """Put ``item`` unless the consumer has stopped; True if it went
    in.  A full queue is a slow consumer, not a hang: ``beat`` (the
    worker's watchdog section) beats while it waits."""
    while not stop.is_set():
        if beat is not None:
            beat.beat()
        try:
            q.put(item, timeout=0.05)
            return True
        except queue.Full:
            continue
    return False


def pipelined(source: Iterator[ColumnarBatch], depth: int,
              stats: Optional[PipelineStats] = None,
              device: Optional[torch.device] = None,
              catalog=None) -> Iterator[ColumnarBatch]:
    """Drive ``source`` from a worker thread with ``depth`` batches of
    lookahead; yields the same batches in the same order.  The worker
    runs with ``device`` current when it is a CUDA device and registers
    its batches in ``catalog`` (the default catalog when None)."""
    from spark_rapids_tpu_torch.memory.spill import (
        ACTIVE_ON_DECK_PRIORITY, SpillableHandle, default_catalog)
    from spark_rapids_tpu_torch.robustness import watchdog
    from spark_rapids_tpu_torch.utils import hostsync

    catalog = catalog or default_catalog()
    owner = threading.get_ident()
    depth = max(int(depth), 1)
    stats = stats or PipelineStats(depth)
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    sync0 = hostsync.host_sync_metrics.snapshot_local()

    on_device = torch.cuda.device(device) \
        if device is not None and torch.device(device).type == "cuda" \
        else contextlib.nullcontext()

    def worker() -> None:
        with worker_attribution(owner, stats):
            try:
                with on_device:
                    try:
                        # heartbeat section: the deadline measures the
                        # silence since the last batch, so a worker
                        # wedged inside the operator iterator trips while
                        # a busy one never does.  The trip cancels the
                        # DRIVING thread's token (this thread adopted
                        # it), which the consumer's queue wait delivers
                        with watchdog.section("pipeline.worker") as beat:
                            for batch in source:
                                if beat is not None:
                                    beat.beat()
                                item = batch
                                if isinstance(batch, ColumnarBatch):
                                    item = catalog.register(
                                        batch, ACTIVE_ON_DECK_PRIORITY)
                                    stats.registered += 1
                                del batch
                                if not _put(q, stop, item, beat):
                                    _close(item)
                                    break
                            else:
                                _put(q, stop, _DONE)
                    finally:
                        close = getattr(source, "close", None)
                        if close is not None:
                            close()
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                _put(q, stop, exc)

    t = threading.Thread(target=worker, name="torch-pipeline", daemon=True)
    t.start()
    try:
        while True:
            stats.fill_sum += min(q.qsize() / depth, 1.0)
            stats.gets += 1
            t0 = time.perf_counter_ns()
            # the queue wait is the driving thread's cancellation
            # checkpoint: when the watchdog trips (a wedged worker, the
            # query's deadline) the TimeoutFault is raised here instead
            # of blocking forever on a queue no one will fill
            while True:
                watchdog.checkpoint()
                try:
                    item = q.get(timeout=0.05)
                    break
                except queue.Empty:
                    continue
            stats.wait_ns += time.perf_counter_ns() - t0
            if item is _DONE:
                break
            if isinstance(item, BaseException):
                # the worker's exception, its traceback intact
                raise item
            if isinstance(item, SpillableHandle):
                handle = item
                try:
                    item = handle.materialize()
                finally:
                    # a dequeued handle is out of the drain's reach
                    handle.close()
            stats.batches += 1
            yield item
            del item
    finally:
        stop.set()
        # bound the join: waiting forever on a WEDGED worker would
        # re-create the hang the watchdog just turned into a fault.  A
        # healthy worker exits within the grace period; an abandoned one
        # is a daemon that sees ``stop`` when it unwedges and closes what
        # it still holds
        grace_until = time.monotonic() + 1.0
        while t.is_alive() and time.monotonic() < grace_until:
            _drain(q)
            t.join(timeout=0.05)
        _drain(q)
        if t.is_alive() and t.ident is not None:
            disown_worker(t.ident)
        stats.host_sync_count = \
            hostsync.host_sync_metrics.snapshot_local() - sync0


def _drain(q: "queue.Queue") -> None:
    """Empty the queue, closing the registrations in it."""
    while True:
        try:
            item = q.get_nowait()
        except queue.Empty:
            return
        _close(item)


def _close(item) -> None:
    from spark_rapids_tpu_torch.memory.spill import SpillableHandle
    if isinstance(item, SpillableHandle):
        item.close()
