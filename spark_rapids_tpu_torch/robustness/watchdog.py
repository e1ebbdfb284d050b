"""Watchdog: deadlines over named engine sections, hang detection, and
cooperative cancellation.

Counterpart of ``spark_rapids_tpu/robustness/watchdog.py``.  The
recovery ladder (driver.py) only fires when a fault surfaces as an
*exception*; a stalled reader, a wedged pipeline worker or a stuck disk
writer raises nothing.  This module turns such hangs into faults the
ladder can consume:

- ``section(point, deadline_ms=...)`` wraps a monitored region.  The
  deadline comes from the explicit argument, the per-point conf key
  ``spark.rapids.tpu.watchdog.deadline.<point>``, or
  ``spark.rapids.tpu.watchdog.defaultDeadlineMs``.
- a single daemon **monitor thread** polls active sections; an overrun
  becomes a classified :class:`~.faults.TimeoutFault` (RETRYABLE) parked
  on the owning thread's **cancellation token**.
- the fault is *raised at the next cooperative checkpoint* on the
  driving thread: every ``inject.fire`` site, every counted host sync
  (utils/hostsync.py), the pipeline consumer's queue wait
  (exec/pipeline.py), and section entry/exit.
- long-lived sections (the pipeline worker) call ``Section.beat()`` on
  progress: the deadline then measures *silence since the last beat*,
  not total elapsed time, so a worker that makes progress never trips
  while a wedged one does.

**What the watchdog cannot do on CUDA.**  A monitor thread cannot
interrupt the card.  A ``.item()``, a ``.cpu()`` or a
``torch.cuda.synchronize()`` blocks inside C++ until the device
finishes; the monitor can only park the ``TimeoutFault``, which is
raised at the next checkpoint *after* the sync returns.  A kernel that
never finishes (a hang inside a kernel) therefore cannot be recovered in
the process at all: the sync never returns.  The JAX package's XLA calls
have the same limit, and its design is kept.  What the watchdog does
catch is a hang on the host: a reader, a worker, a disk writer or a
``delay`` injection rule.

Worker threads adopt their driving thread's identity
(``adopt_thread``/``release_thread``, wired through
``exec/pipeline.worker_attribution``) so a section opened on the worker
cancels the *query's* token, and either thread (whichever checkpoints
first) delivers the fault to the recovery ladder.

Every trip and every delivered cancellation is counted in
``watchdog_metrics`` and emitted as a ``WatchdogTrip`` /
``WatchdogCancel`` event on the session event log, stamped with the
owning query's id.
"""

from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional

from spark_rapids_tpu_torch.robustness import faults as F
from spark_rapids_tpu_torch.utils import tracing

# monitor cadence bounds: never poll faster than 2ms (a busy loop) or
# slower than 100ms (a 150ms test deadline must still detect promptly)
_POLL_MIN_S = 0.002
_POLL_MAX_S = 0.1
_IDLE_SLEEP_S = 0.2


class WatchdogMetrics:
    """Process-wide trip/cancel counters, surfaced by tools/profiling
    alongside the OOM-retry and recovery counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self.trips: Dict[str, int] = {}
        self.cancels: Dict[str, int] = {}
        self.max_overrun_ms = 0.0

    def trip(self, point: str, overrun_ms: float) -> None:
        with self._lock:
            self.trips[point] = self.trips.get(point, 0) + 1
            self.max_overrun_ms = max(self.max_overrun_ms, overrun_ms)

    def cancel(self, point: str) -> None:
        with self._lock:
            self.cancels[point] = self.cancels.get(point, 0) + 1

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {"trips": dict(self.trips),
                    "cancels": dict(self.cancels),
                    "max_overrun_ms": self.max_overrun_ms}

    def reset(self) -> None:
        with self._lock:
            self.trips.clear()
            self.cancels.clear()
            self.max_overrun_ms = 0.0


watchdog_metrics = WatchdogMetrics()


class Section:
    """One active monitored region."""

    __slots__ = ("id", "point", "deadline_s", "owner", "opener",
                 "session", "started", "deadline_at", "tripped")
    _ids = itertools.count(1)

    def __init__(self, point: str, deadline_s: float, owner: int,
                 session):
        self.id = next(Section._ids)
        self.point = point
        self.deadline_s = deadline_s
        self.owner = owner
        # the physical thread that opened the section (== owner unless
        # adopted); disown() evicts by opener when a wedged worker is
        # abandoned
        self.opener = threading.get_ident()
        self.session = session
        self.started = time.monotonic()
        self.deadline_at = self.started + deadline_s
        self.tripped = False

    def beat(self) -> None:
        """Heartbeat: push the deadline out from *now*.  A hang is
        silence longer than the deadline, not total elapsed time."""
        self.deadline_at = time.monotonic() + self.deadline_s


_lock = threading.Lock()
_sections: Dict[int, Section] = {}
# owning (driving) thread ident -> the pending TimeoutFault the next
# checkpoint on that thread (or a worker adopted into it) must raise
_pending: Dict[int, F.TimeoutFault] = {}
# worker thread ident -> driving thread it acts for (same discipline
# as inject._adopted: int-keyed dict ops are atomic under the GIL)
_adopted: Dict[int, int] = {}
_monitor: Optional[threading.Thread] = None
# set on section registration so an idle monitor re-evaluates its
# cadence immediately instead of finishing an idle sleep first
_monitor_wake = threading.Event()
# hot-path guard: checkpoint() costs one global read when nothing is
# pending (it is threaded through per-batch loops via inject.fire and
# utils/hostsync)
_any_pending = False
# target poll cadence (spark.rapids.tpu.watchdog.pollMs, refreshed at
# section registration); the monitor also adapts to the shortest
# active deadline so short test deadlines detect promptly
_poll_target_s = 0.025


def adopt_thread(owner_ident: int) -> None:
    """Sections opened and checkpoints hit on the calling thread act
    for ``owner_ident`` (the pipeline worker adopts its driver)."""
    _adopted[threading.get_ident()] = owner_ident


def release_thread() -> None:
    _adopted.pop(threading.get_ident(), None)


def disown(ident: int) -> None:
    """Sever ``ident``'s adoption from the outside — used when a
    driver abandons a wedged worker: the zombie must not consume the
    driver's NEXT attempt's one-shot cancellation token when it
    eventually unwedges and checkpoints, and its still-open sections
    must not trip spurious faults onto that attempt either."""
    _adopted.pop(ident, None)
    with _lock:
        stale = [sid for sid, s in _sections.items()
                 if s.opener == ident]
        for sid in stale:
            del _sections[sid]


def purge_owner(owner_ident: int) -> None:
    """Drop every adoption mapping TO ``owner_ident`` plus any token
    still parked for it — the query-exit counterpart of
    :func:`disown` (serving/context.QueryContext.__exit__).  The OS
    reuses thread idents: a stale worker adoption would deliver a NEW
    query's cancellation to this dead query's token, and a stale
    parked token would cancel whatever unrelated query next runs on a
    recycled owner ident."""
    global _any_pending
    from spark_rapids_tpu_torch.robustness.inject import purge_adoptions
    purge_adoptions(_adopted, owner_ident)
    with _lock:
        _pending.pop(owner_ident, None)
        _any_pending = bool(_pending)


def _effective_ident() -> int:
    ident = threading.get_ident()
    return _adopted.get(ident, ident)


def checkpoint() -> None:
    """Cooperative cancellation point: raise the pending TimeoutFault
    for this thread's query, if the monitor parked one.  One-shot —
    delivery clears the token so the ladder's next attempt starts
    clean."""
    global _any_pending
    if not _any_pending:
        return
    ident = _effective_ident()
    with _lock:
        fault = _pending.pop(ident, None)
        _any_pending = bool(_pending)
    if fault is None:
        return
    watchdog_metrics.cancel(fault.point)
    try:
        _emit(None, "WatchdogCancel", point=fault.point,
              deadlineMs=fault.deadline_ms, elapsedMs=fault.elapsed_ms)
    except Exception:
        pass  # a log-write failure must not mask the TimeoutFault
    raise fault


def clear_thread() -> None:
    """Drop any pending cancellation for this thread's query.  Called
    at each query attempt boundary so a token left behind by an
    attempt that died of a *different* exception cannot leak into the
    retry."""
    global _any_pending
    with _lock:
        _pending.pop(_effective_ident(), None)
        _any_pending = bool(_pending)


def _emit(session, event: str, **fields) -> None:
    from spark_rapids_tpu_torch.utils.events import emit_on_session
    emit_on_session(event, session=session, **fields)


def _active_session():
    try:
        from spark_rapids_tpu_torch.api.session import TpuSession
        return TpuSession._active
    except ImportError:  # torn-down interpreter only
        return None


def _resolve_deadline_ms(point: str, deadline_ms, session) -> float:
    """Explicit arg > per-point conf > default conf; 0/None disables.
    Returns 0.0 when the section should not be monitored."""
    global _poll_target_s
    conf = getattr(session, "conf", None) if session is not None else None
    if conf is not None:
        from spark_rapids_tpu_torch.config import rapids_conf as rc
        if not conf.get(rc.WATCHDOG_ENABLED):
            return 0.0
        if deadline_ms is None:
            deadline_ms = conf.watchdog_deadline_ms(point)
        _poll_target_s = conf.get(rc.WATCHDOG_POLL_MS) / 1e3
    return float(deadline_ms or 0)


def _ensure_monitor() -> None:
    global _monitor
    if _monitor is not None and _monitor.is_alive():
        return
    with _lock:
        if _monitor is not None and _monitor.is_alive():
            return
        _monitor = threading.Thread(
            target=_monitor_loop, name="tpu-watchdog", daemon=True)
        _monitor.start()


def _monitor_loop() -> None:
    global _any_pending
    while True:
        with _lock:
            active = list(_sections.values())
        now = time.monotonic()
        min_deadline = None
        for s in active:
            if s.tripped:
                continue
            if now >= s.deadline_at:
                s.tripped = True
                elapsed_ms = (now - s.started) * 1e3
                overrun_ms = (now - s.deadline_at) * 1e3
                fault = F.TimeoutFault(s.point, s.deadline_s * 1e3,
                                       elapsed_ms)
                with _lock:
                    # never overwrite an earlier pending fault — the
                    # first overrun is the root cause
                    _pending.setdefault(s.owner, fault)
                    _any_pending = True
                watchdog_metrics.trip(s.point, overrun_ms)
                try:
                    # stamp the OWNING query's id: the monitor thread
                    # has no query of its own, and under concurrent
                    # queries a session-global "current qid" would
                    # attribute this trip to whichever query last
                    # started (serving/context resolves by owner)
                    from spark_rapids_tpu_torch.serving import context as qc
                    _emit(s.session, "WatchdogTrip", point=s.point,
                          queryId=qc.qid_for_ident(s.owner, s.session),
                          deadlineMs=s.deadline_s * 1e3,
                          elapsedMs=round(elapsed_ms, 3),
                          overrunMs=round(overrun_ms, 3))
                except Exception:
                    # an event-log write failure (disk full — exactly
                    # the degraded world this thread exists for) must
                    # never kill the singleton monitor: the token was
                    # already parked, detection keeps working
                    pass
            else:
                min_deadline = s.deadline_s if min_deadline is None \
                    else min(min_deadline, s.deadline_s)
        _reap_dead_owners()
        if min_deadline is None:
            _monitor_wake.wait(_IDLE_SLEEP_S)
        else:
            _monitor_wake.wait(
                min(max(min(min_deadline / 5, _poll_target_s),
                        _POLL_MIN_S), _POLL_MAX_S))
        _monitor_wake.clear()


def _reap_dead_owners() -> None:
    """Drop pending faults whose owning thread is gone: a token the
    owner can never consume (the thread died without a final
    checkpoint) would pin ``_any_pending`` — a per-checkpoint lock for
    the process's life — and could be mis-delivered to an unrelated
    thread that recycles the ident."""
    global _any_pending
    if not _pending:
        return
    live = {t.ident for t in threading.enumerate()}
    with _lock:
        for ident in [i for i in _pending if i not in live]:
            del _pending[ident]
        _any_pending = bool(_pending)


@contextmanager
def section(point: str, deadline_ms: Optional[float] = None,
            session=None):
    """Monitor the enclosed region: if it runs past its deadline the
    watchdog parks a TimeoutFault on the owning thread's token.  Yields
    the :class:`Section`, or None when monitoring is disabled for this
    point.  Long-lived sections become heartbeat-style by calling
    ``.beat()`` on progress — the deadline then measures silence, not
    total elapsed time (exec/pipeline.py's worker does this).

    Entry and (clean) exit are checkpoints: a region that finishes
    *after* its trip still surfaces the fault at the boundary —
    deadlines are a contract, and recovery re-runs with correct
    results either way."""
    checkpoint()
    if session is None:
        session = _active_session()
    ms = _resolve_deadline_ms(point, deadline_ms, session)
    # every monitored section doubles as a tracing span (the section
    # taxonomy IS most of the span taxonomy: reader pulls, exchange
    # launches, host syncs, UDF/pipeline waits, checkpoint writes).
    # "query" is excluded — it stays open across the QueryEnd drain,
    # whose wall clock already covers it.
    sp = tracing.span(point) if point != "query" else None
    if ms <= 0:
        if sp is None:
            yield None
        else:
            with sp:
                yield None
        return
    s = Section(point, ms / 1e3, _effective_ident(), session)
    with _lock:
        _sections[s.id] = s
    _monitor_wake.set()
    _ensure_monitor()
    try:
        if sp is None:
            yield s
        else:
            with sp:
                yield s
    finally:
        with _lock:
            _sections.pop(s.id, None)
    checkpoint()  # after finally: never masks an in-flight exception


@contextmanager
def query_scope(session, deadline_ms: Optional[float] = None):
    """One query attempt's watchdog envelope: clears any stale token
    left by a previous attempt, then monitors whole-query wall time
    under ``spark.rapids.tpu.watchdog.queryDeadlineMs`` (0 = off)."""
    clear_thread()
    if deadline_ms is None:
        conf = getattr(session, "conf", None)
        if conf is not None:
            from spark_rapids_tpu_torch.config import rapids_conf as rc
            deadline_ms = conf.get(rc.WATCHDOG_QUERY_DEADLINE_MS)
    with section("query", deadline_ms=deadline_ms or 0,
                 session=session):
        yield
