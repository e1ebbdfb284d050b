"""QueryRetryDriver: query-level recovery with a bounded degradation
ladder.

Counterpart of ``spark_rapids_tpu/robustness/driver.py``.
Operator-level recovery (memory/retry.py) absorbs faults that stay
inside one operator.  Whatever escapes to the query boundary lands here,
where the recovery options get progressively more drastic:

  retry      — re-run the same plan after a short backoff (transient
               reader/shuffle faults, watchdog timeouts)
  spill      — demote the session's whole device store to host
               (memory/retry's ``_spill_device_store``) and re-run
               (device OOM)
  split      — re-plan with the scan and coalesce batch sizes halved so
               every operator sees smaller working sets (the query-level
               face of split-and-retry)
  demote     — re-plan a sharded query onto the session's one device
               (sessions with a shard group only)
  cpu        — re-plan the whole query onto the CPU fallback
               (``session.plan_cpu_only``) — slow, but it answers.
               Sessions on the CPU only: on a CUDA session an exhausted
               ladder re-raises instead (see below)

The JAX package's ``shrink`` rung rebuilds a fleet's mesh over its
surviving hosts; the port has no fleet, so no ladder here holds it.

The ladder only moves forward, every action is appended to
``session.recovery_log`` and emitted as a ``RecoveryAction`` event, and
FATAL faults re-raise at once: the driver absorbs classified
infrastructure failures, never bugs.  A CUDA runtime error, a kernel
build or launch failure and ``NotImplementedError`` are FATAL
(robustness/faults.py), so a broken kernel is never answered quietly by
the ``cpu`` rung.

Unlike the JAX package's, a ladder on a CUDA session has no ``cpu``
rung: a device OOM that outlives spill and split, a recurring watchdog
timeout or a reader that never succeeds re-raises once the ladder is
spent, instead of answering from pandas while the query's tables sit on
the card.  A query that ran on the card is then never timed as the
card's with its work done on the host.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List

from spark_rapids_tpu_torch.robustness import faults as F

# distinct jitter seeds for unlabeled drivers (see QueryRetryDriver)
_jitter_seeds = itertools.count(1)

# ladder rungs, in escalation order
RETRY = "retry"
SPILL_RETRY = "spill"
SPLIT_RETRY = "split"
DEMOTE_SINGLE_DEVICE = "demote"
CPU_FALLBACK = "cpu"

# canonical escalation order (every ladder is a subsequence of this)
RUNG_ORDER = [RETRY, SPILL_RETRY, SPLIT_RETRY, DEMOTE_SINGLE_DEVICE,
              CPU_FALLBACK]
# rungs whose attempt no longer runs on the shard layout the lineage log
# was keyed to
_LAYOUT_CHANGING = (SPLIT_RETRY, DEMOTE_SINGLE_DEVICE, CPU_FALLBACK)

def on_card(session) -> bool:
    """Whether ``session`` runs on a CUDA device: its ladder then ends
    at ``split`` (or ``demote``) and never re-plans onto the CPU."""
    return getattr(getattr(session, "device", None), "type", None) == "cuda"


@dataclass
class AttemptMode:
    """What the next execution attempt is allowed to look like.  The
    attempt callable receives this and shapes planning accordingly."""

    rung: str = "initial"
    # offer the plan to the session's shard group (try_distributed)
    use_mesh: bool = True
    # plan the whole query on the CPU fallback (session.plan_cpu_only)
    cpu_only: bool = False
    # scale of the scan and coalesce batch sizes
    batch_scale: float = 1.0
    # resume capability, orthogonal to the rungs: a re-attempt that
    # keeps the shard layout splices completed stages from the query's
    # stage-checkpoint lineage log (robustness/checkpoint.py)
    resume: bool = False


class RecoveryMetrics:
    """Process-wide recovery counters (per action), beside the OOM
    retry counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counts: Dict[str, int] = {}

    def bump(self, action: str) -> None:
        with self._lock:
            self.counts[action] = self.counts.get(action, 0) + 1

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.counts)

    def reset(self) -> None:
        with self._lock:
            self.counts.clear()


recovery_metrics = RecoveryMetrics()


def record_degradation(session, kind: str, action: str, error: str
                       ) -> None:
    """Record a recovery action handled *locally* by a subsystem (e.g.
    the UDF worker pool degrading to inline evaluation) so it shows up
    in the same trail/event stream as driver-level recoveries."""
    recovery_metrics.bump(action)
    rec = {"action": action, "fault": kind, "error": error,
           "rung": "local"}
    if session is not None:
        getattr(session, "recovery_log", []).append(rec)
        ev = getattr(session, "events", None)
        if ev is not None and ev.enabled:
            ev.emit("RecoveryAction",
                    queryId=getattr(session, "_current_qid", None),
                    action=action, fault=kind, error=error,
                    rung="local")


class QueryRetryDriver:
    """Drives one query's execution attempts down the degradation
    ladder.  ``run(attempt)`` calls ``attempt(mode)`` until it returns,
    the ladder is exhausted, or a FATAL fault surfaces."""

    def __init__(self, session, label: str = ""):
        import random
        import zlib
        self.session = session
        self.label = label
        self.trail: List[dict] = []
        from spark_rapids_tpu_torch.config import rapids_conf as rc
        conf = session.conf
        self.enabled = conf.get(rc.QUERY_RECOVERY_ENABLED)
        self.max_retries = conf.get(rc.QUERY_RECOVERY_MAX_RETRIES)
        self.backoff_s = conf.get(rc.QUERY_RECOVERY_BACKOFF_MS) / 1e3
        self.backoff_cap_s = \
            conf.get(rc.QUERY_RECOVERY_BACKOFF_CAP_MS) / 1e3
        # jitter de-synchronizes retry herds (every SPMD controller
        # re-driving the same preempted step at once).  A labeled
        # driver seeds from its label so chaos runs replay the exact
        # same sleep sequence; unlabeled (production) drivers each
        # draw a distinct seed, else every driver would jitter in
        # lockstep and the herd would survive
        seed = zlib.crc32(label.encode()) if label else \
            (os.getpid() << 20) ^ next(_jitter_seeds)
        self._rng = random.Random(seed)
        # ladder cursor state (reset by run(); initialized here so
        # _advance_to is exercisable standalone in unit tests)
        self._rungs: List[str] = self._ladder()
        self._pos = 0

    # ------------------------------------------------------------ ladder --
    def _ladder(self) -> List[str]:
        rungs = [RETRY] * self.max_retries + [SPILL_RETRY, SPLIT_RETRY]
        if getattr(self.session, "shards", None) is not None:
            rungs.append(DEMOTE_SINGLE_DEVICE)
        if not on_card(self.session):
            rungs.append(CPU_FALLBACK)
        return rungs

    @staticmethod
    def _entry_rung(fault: F.Fault) -> str:
        if fault.severity == F.DEGRADABLE:
            # identical re-execution is pointless; jump to plan
            # changes.  Spill corruption enters at SPLIT: the dropped
            # batch's bytes only exist at the source, and a re-planned
            # attempt re-reads inputs (demoting off the shards would not)
            return SPLIT_RETRY \
                if fault.kind in ("device_oom", "spill_corruption") \
                else DEMOTE_SINGLE_DEVICE
        if fault.kind == "device_oom":
            # a bare retry without freeing HBM would just OOM again
            return SPILL_RETRY
        return RETRY

    def _mode_for(self, rung: str, prev: AttemptMode) -> AttemptMode:
        mode = AttemptMode(rung=rung, use_mesh=prev.use_mesh,
                           cpu_only=prev.cpu_only,
                           batch_scale=prev.batch_scale)
        if rung == SPLIT_RETRY:
            mode.batch_scale = prev.batch_scale / 2
        elif rung == DEMOTE_SINGLE_DEVICE:
            mode.use_mesh = False
        elif rung == CPU_FALLBACK:
            mode.use_mesh = False
            mode.cpu_only = True
        return mode

    # ------------------------------------------------------------ events --
    def _record(self, action: str, fault: F.Fault,
                exc: BaseException) -> None:
        recovery_metrics.bump(action)
        rec = {"action": action, "fault": fault.kind,
               "severity": fault.severity,
               "error": f"{type(exc).__name__}: {exc}"}
        self.trail.append(rec)
        getattr(self.session, "recovery_log", []).append(rec)
        ev = getattr(self.session, "events", None)
        if ev is not None and ev.enabled:
            ev.emit("RecoveryAction",
                    queryId=getattr(self.session, "_current_qid", None),
                    action=action, fault=fault.kind,
                    severity=fault.severity, error=rec["error"],
                    label=self.label)

    def _emit_summary(self, status: str) -> None:
        if not self.trail:
            return
        ev = getattr(self.session, "events", None)
        if ev is not None and ev.enabled:
            ev.emit("QueryRecovery",
                    queryId=getattr(self.session, "_current_qid", None),
                    status=status, actions=self.trail,
                    label=self.label)

    def _advance_to(self, level: str) -> None:
        """Move the ladder cursor FORWARD (never backward) to the
        first rung at or above ``level`` in the canonical escalation
        order — the single place rung-reentry position is computed.  A
        device OOM never burns plain-retry budget, a degradable fault
        never burns the spill/split budget, and an entry rung missing
        from this ladder (demote without a shard group) escalates to the next
        rung present.  A cursor already past the requested level stays
        where it is: the ladder only ever moves forward."""
        want = RUNG_ORDER.index(level)
        entry_pos = next(
            (i for i, r in enumerate(self._rungs)
             if RUNG_ORDER.index(r) >= want), len(self._rungs))
        self._pos = max(self._pos, entry_pos)

    def _update_lineage(self, rung: str, mode: AttemptMode) -> None:
        """Stage-checkpoint wiring: a retry-class re-attempt keeps the
        shard layout and resumes from the lineage log; a layout-changing
        rung (split, demote, cpu) clears it (``clear()``: the per-query
        manager drops every entry, keyed to a layout this query no
        longer runs on; the shared stage store keeps its entries, whose
        layout serves other queries)."""
        mgr = getattr(self.session, "checkpoints", None)
        if rung in _LAYOUT_CHANGING or not mode.use_mesh or \
                mode.cpu_only or mode.batch_scale != 1.0:
            mode.resume = False
            if mgr is not None:
                mgr.clear(f"rung:{rung}")
        elif mgr is not None:
            mode.resume = True

    # --------------------------------------------------------------- run --
    def run(self, attempt: Callable[[AttemptMode], Any]) -> Any:
        mode = AttemptMode()
        if not self.enabled:
            return attempt(mode)
        self._rungs = self._ladder()
        self._pos = 0  # next rung to use on failure; only moves forward
        backoffs = 0
        while True:
            try:
                result = attempt(mode)
                self._emit_summary("recovered")
                return result
            except Exception as exc:  # noqa: BLE001 - classified below
                fault = F.classify(exc)
                if fault.fatal:
                    self._emit_summary("fatal")
                    raise
                self._advance_to(self._entry_rung(fault))
                if self._pos >= len(self._rungs):
                    self._emit_summary("exhausted")
                    raise
                rung = self._rungs[self._pos]
                self._pos += 1
                self._record(rung, fault, exc)
                mode = self._mode_for(rung, mode)
                self._update_lineage(rung, mode)
            # after the except block: while its handler is live, the
            # exception's traceback holds the failed attempt's frames
            # and their tensors, so the spill could not free them
            if rung == SPILL_RETRY:
                self._spill_device_store()
            if rung == RETRY and self.backoff_s > 0:
                # exponential backoff, capped (backoffCapMs) and
                # jittered into [0.5, 1.0]x: chaos tests stay
                # responsive, and concurrent drivers never retry in
                # lockstep
                base = min(self.backoff_s * (2 ** backoffs),
                           self.backoff_cap_s)
                time.sleep(base * (0.5 + 0.5 * self._rng.random()))
                backoffs += 1

    def _spill_device_store(self) -> None:
        import gc
        gc.collect()  # drop dead tensors so the allocator can reuse them
        from spark_rapids_tpu_torch.memory.retry import _spill_device_store
        _spill_device_store(getattr(self.session, "memory_catalog", None))
