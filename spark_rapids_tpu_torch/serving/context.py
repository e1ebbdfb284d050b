"""QueryContext: every piece of per-query robustness state, scoped.

Counterpart of ``spark_rapids_tpu/serving/context.py``.  Without it,
state that attributes work to "the query" (the session's in-flight query
id, fault-injection rule scoping, watchdog cancellation tokens, the
host-sync and OOM-retry per-thread views) would only stay right while
one query ran at a time.

A :class:`QueryContext` is entered by ``DataFrame._execute_batches``
around the whole recovery-driven execution (every attempt of one query
action):

- it registers itself under the driving thread's ident in a
  process-wide registry, with the worker-adoption discipline of the
  other registries (``exec/pipeline.worker_attribution`` adopts workers
  into it), so ``current()`` resolves the owning query from any thread
  doing its work;
- the session's ``_current_qid`` / ``checkpoints`` attributes are
  thread-keyed views through this registry;
- entry drops the spans its thread closed while no query ran there (the
  previous query's ``to_arrow``, say: ``utils/tracing.discard_owner``),
  so this query's span rollup holds only its own;
- it carries the query's budgets (memory bytes, host syncs, deadline)
  and the admission ticket, and gathers the BudgetExhausted and
  admission facts the QueryEnd event reports;
- **exit is the containment boundary**: the context releases its
  admission ticket and interleaver slot, clears its thread's watchdog
  token, drops its per-owner spill budget, and purges every
  adoption-registry entry that still maps a worker ident to this query
  (the OS reuses thread idents: a stale adoption would attribute a new
  query's syncs, or deliver its cancellation, to this dead one).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

# owner (driving) thread ident -> its active QueryContext
_contexts: Dict[int, "QueryContext"] = {}
# worker thread ident -> owner ident (same GIL-atomic dict discipline
# as inject._adopted / watchdog._adopted)
_adopted: Dict[int, int] = {}


def adopt_thread(owner_ident: int) -> None:
    """The calling thread acts for ``owner_ident``'s query (wired
    through exec/pipeline.worker_attribution alongside the other
    adoption registries)."""
    _adopted[threading.get_ident()] = owner_ident


def release_thread() -> None:
    _adopted.pop(threading.get_ident(), None)


def disown(ident: int) -> None:
    _adopted.pop(ident, None)


def effective_ident() -> int:
    ident = threading.get_ident()
    return _adopted.get(ident, ident)


def current() -> Optional["QueryContext"]:
    """The QueryContext the calling thread is working for, if any."""
    return _contexts.get(effective_ident())


def qid_for_ident(ident: int, session=None) -> Optional[int]:
    """Query id owned by a specific thread ident — the watchdog
    monitor uses this to stamp WatchdogTrip events with the OWNING
    query's id instead of reading a session-global field from the
    monitor thread.  Falls back to the session's thread-keyed qid map
    for paths that run outside a QueryContext."""
    ctx = _contexts.get(ident)
    if ctx is not None and ctx.qid is not None:
        return ctx.qid
    if session is not None:
        return getattr(session, "_qid_by_ident", {}).get(ident)
    return None


class QueryContext:
    """One query action's scope: identity, budgets, admission ticket.

    Context manager; re-entrant entry on the same thread is rejected
    (a nested query action would splice two queries' state — the
    nested call must run in its own thread, as concurrent clients do).
    """

    def __init__(self, session):
        from spark_rapids_tpu_torch.config import rapids_conf as rc
        self.session = session
        conf = session.conf
        self.owner_ident: Optional[int] = None
        self.qid: Optional[int] = None
        # qids this context has carried (a query action draws a fresh
        # qid per attempt envelope; tests read the full set)
        self.qids: list = []
        self.memory_budget = conf.get(rc.SERVING_QUERY_MEMORY_BUDGET)
        self.sync_budget = conf.get(rc.SERVING_SYNC_BUDGET)
        self.deadline_budget_ms = conf.get(rc.SERVING_DEADLINE_BUDGET_MS)
        self.syncs_used = 0
        self.ticket = None            # AdmissionTicket once admitted
        self.admission_wait_ms = 0.0
        self.admission_weight = 0
        # per-query stage-checkpoint manager (the session's
        # ``checkpoints`` view, robustness/checkpoint.py): the query's
        # lineage log or the shared stage store on a sharded session
        self.checkpoints = None
        self.budget_events: list = []  # BudgetExhausted facts emitted
        # facts for the QueryEnd ``sharing`` dict (the interleaver's
        # ticket adds its own); empty when nothing is shared
        self.sharing: dict = {}
        # fair-interleaver slot (serving/scheduler.py), registered at
        # admit() and held across every attempt of this query action —
        # recovery-ladder re-drives keep their slot
        self.interleave_ticket = None
        self._budget_spilled = False   # memory ladder: spill fired once
        self._lock = threading.Lock()

    # --------------------------------------------------------------- scope --
    def __enter__(self) -> "QueryContext":
        ident = threading.get_ident()
        if _contexts.get(ident) is not None:
            raise RuntimeError(
                "a QueryContext is already active on this thread; "
                "concurrent queries must run on distinct threads")
        self.owner_ident = ident
        _contexts[ident] = self
        from spark_rapids_tpu_torch.utils import tracing
        tracing.discard_owner(ident)
        if self.memory_budget:
            cat = getattr(self.session, "memory_catalog", None)
            if cat is not None:
                cat.set_owner_budget(ident, self.memory_budget)
        return self

    def __exit__(self, *exc) -> bool:
        ident = self.owner_ident
        try:
            if self.interleave_ticket is not None:
                sched = getattr(self.session, "interleaver", None)
                if sched is not None:
                    sched.unregister(self.interleave_ticket)
                self.interleave_ticket = None
            self.release_admission()
        finally:
            cat = getattr(self.session, "memory_catalog", None)
            if cat is not None and self.memory_budget:
                cat.clear_owner_budget(ident)
            # containment boundary: purge every adoption entry still
            # pointing at this query's owner ident.  A finished (or
            # wedged-and-abandoned) worker's stale adoption must not
            # survive into the ident's next life — the OS reuses
            # thread idents, and a recycled ident would attribute a
            # NEW query's syncs to this dead one, or deliver this
            # query's parked cancellation into an unrelated query.
            from spark_rapids_tpu_torch.memory.retry import retry_metrics
            from spark_rapids_tpu_torch.robustness import inject, watchdog
            from spark_rapids_tpu_torch.utils import hostsync
            purge_owner(ident)
            inject.purge_owner(ident)
            watchdog.purge_owner(ident)
            hostsync.host_sync_metrics.purge_owner(ident)
            retry_metrics.purge_owner(ident)
            watchdog.clear_thread()
            # the finished query's qid must not survive on the thread:
            # the next query's PRE-attempt events (an AdmissionReject
            # before it ever draws a qid) would otherwise be stamped
            # with this dead query's id
            getattr(self.session, "_qid_by_ident", {}).pop(ident, None)
            if _contexts.get(ident) is self:
                del _contexts[ident]
        return False

    # ----------------------------------------------------------- admission --
    def admit(self) -> None:
        """Acquire the session's admission semaphore (no-op when the
        controller is disabled).  Blocks in FIFO order; a timeout or a
        full queue raises the typed AdmissionFault.  Admitted queries
        also join the fair interleaver's round (when enabled) — the
        ticket spans every attempt, so ladder re-drives keep their
        slot."""
        ctrl = getattr(self.session, "admission", None)
        if ctrl is not None and self.ticket is None:
            from spark_rapids_tpu_torch.utils import tracing
            t0 = time.perf_counter()
            with tracing.span("admission.wait"):
                self.ticket = ctrl.acquire(session=self.session)
            self.admission_wait_ms = (time.perf_counter() - t0) * 1e3
            self.admission_weight = self.ticket.weight_bytes
        # the interleave ticket joins the round ONLY once admitted: a
        # QUEUED query's ticket would hold the round-robin turn while
        # never reaching a gate — admitted co-tenants would block at
        # their gates waiting on it, and with all slots held by
        # blocked tenants the queued query is never admitted either
        # (session-wide deadlock)
        sched = getattr(self.session, "interleaver", None)
        if sched is not None and self.interleave_ticket is None:
            self.interleave_ticket = sched.register(self)

    def release_admission(self) -> None:
        ctrl = getattr(self.session, "admission", None)
        if ctrl is not None and self.ticket is not None:
            ctrl.release(self.ticket)
            self.ticket = None

    def admission_info(self) -> dict:
        """QueryEnd payload: what admission cost this query."""
        if not self.admission_weight and not self.admission_wait_ms:
            return {}
        return {"waitMs": round(self.admission_wait_ms, 3),
                "weightBytes": self.admission_weight}

    # ------------------------------------------------------------- budgets --
    def set_qid(self, qid: Optional[int]) -> None:
        self.qid = qid
        if qid is not None:
            self.qids.append(qid)

    def charge_syncs(self, n: int) -> None:
        """Host-sync budget ladder: count, and past the limit reject
        THIS query with a typed fault (emitting BudgetExhausted first
        so the trail explains the rejection)."""
        if not self.sync_budget:
            return
        with self._lock:
            self.syncs_used += n
            used, limit = self.syncs_used, self.sync_budget
            over = used > limit
        if over:
            self._emit_budget("syncs", used, limit, action="reject")
            from spark_rapids_tpu_torch.robustness.faults import (
                BudgetExhaustedFault)
            raise BudgetExhaustedFault("syncs", used, limit)

    def note_memory_pressure(self, used: int, spilled: bool) -> None:
        """Memory budget ladder, called by the spill catalog: the
        first overrun self-spills (degrade) and records it; an overrun
        the self-spill could not cure rejects the query."""
        limit = self.memory_budget
        if spilled:
            first = not self._budget_spilled
            self._budget_spilled = True
            if first:
                self._emit_budget("memory", used, limit, action="spill")
            return
        self._emit_budget("memory", used, limit, action="reject")
        from spark_rapids_tpu_torch.robustness.faults import (
            BudgetExhaustedFault)
        raise BudgetExhaustedFault("memory", used, limit)

    def _emit_budget(self, budget: str, used, limit, action: str) -> None:
        fact = {"budget": budget, "used": used, "limit": limit,
                "action": action}
        self.budget_events.append(fact)
        from spark_rapids_tpu_torch.utils.events import emit_on_session
        extra = {"queryId": self.qid} if self.qid is not None else {}
        emit_on_session("BudgetExhausted", session=self.session,
                        **extra, **fact)


def purge_owner(owner_ident: int) -> None:
    """Drop every worker adoption in THIS registry that maps to
    ``owner_ident`` (the per-registry counterparts live in
    inject/watchdog/hostsync/retry and are called alongside)."""
    from spark_rapids_tpu_torch.robustness.inject import purge_adoptions
    purge_adoptions(_adopted, owner_ident)
