"""Byte-weighted, fair admission semaphore for concurrent queries.

Counterpart of ``spark_rapids_tpu/serving/admission.py``.  The reference
throttles device pressure with ``GpuSemaphore`` (GpuSemaphore.scala:28,
``spark.rapids.sql.concurrentGpuTasks``); this is the query-granularity
analog for a session that serves many queries on one card, where
admission keeps one query's footprint from becoming another's OOM.

:class:`AdmissionController` grants :class:`AdmissionTicket`\\ s under
two constraints at once:

- **count**: at most ``concurrentQueries`` admitted at once;
- **bytes**: admitted queries' declared memory weights must fit in
  ``hbm_bytes`` (the spill catalog's device budget times
  ``hbmAdmissionFraction``); a query heavier than the whole budget
  still admits *alone* (the spill tiers absorb the overshoot).

Waiting is **strict FIFO** (ticket order), so starvation is impossible
by construction: a heavy query at the head blocks later light ones
rather than being overtaken forever.  Two typed rejections keep a
saturated session from wedging: a bounded queue (``maxQueuedQueries``)
rejects at arrival, and a wait deadline (``admissionTimeoutMs``) rejects
a queued query, both as :class:`~..robustness.faults.AdmissionFault`,
which the recovery ladder classifies FATAL for this query and hands
back.

Every grant and rejection emits an ``Admission`` / ``AdmissionReject``
event, and cumulative counters (``snapshot()``) feed the profiling.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, Optional

from spark_rapids_tpu_torch.robustness.faults import AdmissionFault


class AdmissionTicket:
    """One admitted (or queued) query's place in the controller."""

    _seqs = itertools.count(1)

    __slots__ = ("seq", "weight_bytes", "admitted")

    def __init__(self, weight_bytes: int):
        self.seq = next(AdmissionTicket._seqs)
        self.weight_bytes = int(weight_bytes)
        self.admitted = False


class AdmissionController:
    def __init__(self, max_queries: int, hbm_bytes: int,
                 default_weight: int = 0, timeout_ms: int = 0,
                 max_queue: int = 0):
        self.max_queries = int(max_queries)
        self.hbm_bytes = int(hbm_bytes)
        # weight a query declares when it has no explicit budget:
        # an equal share of the admission bytes
        self.default_weight = int(default_weight) or max(
            self.hbm_bytes // max(self.max_queries, 1), 1)
        self.timeout_ms = int(timeout_ms)
        self.max_queue = int(max_queue)
        self._cond = threading.Condition()
        self._queue: deque = deque()   # waiting tickets, FIFO
        self._active: Dict[int, AdmissionTicket] = {}  # seq -> ticket
        self.admitted_bytes = 0
        # cumulative counters (snapshot())
        self.total_admitted = 0
        self.total_rejected = 0
        self.total_wait_ns = 0
        self.peak_concurrent = 0
        self.peak_queue_depth = 0

    # ------------------------------------------------------------ internals --
    def _fits(self, ticket: AdmissionTicket) -> bool:
        if len(self._active) >= self.max_queries:
            return False
        if not self._active:
            return True  # never deadlock a query heavier than the pool
        return self.admitted_bytes + ticket.weight_bytes <= self.hbm_bytes

    def _emit(self, session, event: str, **fields) -> None:
        from spark_rapids_tpu_torch.utils.events import emit_on_session
        try:
            emit_on_session(event, session=session, **fields)
        except Exception:
            pass  # admission decisions must never die on a log write

    # ------------------------------------------------------------- interface --
    def acquire(self, weight_bytes: Optional[int] = None,
                session=None) -> AdmissionTicket:
        """Block (FIFO) until admitted; returns the ticket to pass to
        :meth:`release`.  Raises AdmissionFault on a full queue or a
        wait past ``timeout_ms``."""
        w = int(weight_bytes) if weight_bytes else self.default_weight
        ticket = AdmissionTicket(w)
        t0 = time.perf_counter_ns()
        deadline = None if self.timeout_ms <= 0 else \
            time.monotonic() + self.timeout_ms / 1e3
        # rejections are decided under the lock but emitted/raised
        # outside it — an eventlog write on a slow disk must never
        # stall every other tenant's acquire/release behind _cond
        reject = None  # (event fields, AdmissionFault)
        with self._cond:
            if self.max_queue and len(self._queue) >= self.max_queue:
                self.total_rejected += 1
                reject = (
                    dict(reason="queue-full", queued=len(self._queue)),
                    AdmissionFault(
                        "queue-full",
                        f"{len(self._queue)} queries already queued "
                        f"(maxQueuedQueries={self.max_queue})"))
            else:
                self._queue.append(ticket)
                self.peak_queue_depth = max(self.peak_queue_depth,
                                            len(self._queue))
                while not (self._queue[0] is ticket and
                           self._fits(ticket)):
                    timeout = None
                    if deadline is not None:
                        timeout = deadline - time.monotonic()
                        if timeout <= 0:
                            self._queue.remove(ticket)
                            self._cond.notify_all()
                            self.total_rejected += 1
                            wait_ms = \
                                (time.perf_counter_ns() - t0) / 1e6
                            reject = (
                                dict(reason="timeout",
                                     waitMs=round(wait_ms, 3)),
                                AdmissionFault(
                                    "timeout",
                                    f"waited {wait_ms:.0f}ms > "
                                    f"admissionTimeoutMs="
                                    f"{self.timeout_ms}"))
                            break
                    self._cond.wait(timeout)
                if reject is None:
                    self._queue.popleft()
                    ticket.admitted = True
                    self._active[ticket.seq] = ticket
                    self.admitted_bytes += ticket.weight_bytes
                    self.total_admitted += 1
                    self.peak_concurrent = max(self.peak_concurrent,
                                               len(self._active))
                    wait_ns = time.perf_counter_ns() - t0
                    self.total_wait_ns += wait_ns
                    active = len(self._active)
                    queued = len(self._queue)
                    # the head may now also fit (count freed by a
                    # racer, or several light queries behind a
                    # just-admitted one)
                    self._cond.notify_all()
        if reject is not None:
            fields, fault = reject
            self._emit(session, "AdmissionReject", **fields)
            raise fault
        self._emit(session, "Admission", waitMs=round(wait_ns / 1e6, 3),
                   weightBytes=ticket.weight_bytes, active=active,
                   queued=queued)
        return ticket

    def release(self, ticket: AdmissionTicket) -> None:
        with self._cond:
            if self._active.pop(ticket.seq, None) is None:
                return  # double release / never admitted
            self.admitted_bytes -= ticket.weight_bytes
            self._cond.notify_all()

    def snapshot(self) -> Dict[str, float]:
        with self._cond:
            return {
                "active": len(self._active),
                "queued": len(self._queue),
                "admittedBytes": self.admitted_bytes,
                "totalAdmitted": self.total_admitted,
                "totalRejected": self.total_rejected,
                "totalWaitMs": round(self.total_wait_ns / 1e6, 3),
                "peakConcurrent": self.peak_concurrent,
                "peakQueueDepth": self.peak_queue_depth,
            }
