"""Fair interleaving of admitted queries' batch loops.

Counterpart of ``spark_rapids_tpu/serving/scheduler.py``.  Admission
(serving/admission.py) decides WHO may touch the device; this decides
WHEN.  Without it each admitted query's batch loop dispatches as fast
as its thread can run, so a long scan admitted first occupies the card
query-at-a-time.

:class:`FairInterleaver` is a cooperative, weighted round-robin
timeslice gate at the batch boundary:

- every admitted query registers an :class:`InterleaveTicket`
  (``QueryContext.admit``) and calls :func:`yield_slice` before each
  batch pull (``DataFrame._drive`` wraps the operator iterator) and at
  every exchange stage of the sharded path (``DistPlanner.run``);
- queries advance in strict round-robin ticket order, each consuming
  its **quantum** of batch slices per turn, so every runnable query
  advances within one round;
- the quantum is weighted by the serving budgets the QueryContext
  carries: a query declaring a byte weight lighter than the pool
  default gets proportionally more slices per round (bounded 8x), and a
  deadline-budgeted query gets double;
- recovery-ladder re-drives keep their slot: the ticket lives on the
  QueryContext, which spans every attempt of one query action;
- the gate is **cooperative and content-blind**: it reorders when
  batches dispatch, never what they compute, so answers are the same
  bits with the knob off.  Waits are watchdog checkpoints and traced as
  ``scheduler.timeslice`` spans.

On one card every query's kernels go to the session device's default
stream (exec/pipeline.py), so the device runs them in the order the
gate lets them be enqueued; the interleaving is of host dispatch.

A query that stops pulling batches holds its turn only until the turn
lease lapses or its context exits (``unregister`` passes the turn on);
a gate never blocks a query that is the only one registered.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import List, Optional


class InterleaveTicket:
    """One registered query's place in the round."""

    _seqs = itertools.count(1)

    __slots__ = ("seq", "quantum", "used", "granted", "wait_ns",
                 "rounds")

    def __init__(self, quantum: int):
        self.seq = next(InterleaveTicket._seqs)
        self.quantum = max(int(quantum), 1)
        self.used = 0        # slices consumed this turn
        self.granted = 0     # total slices granted (observability)
        self.wait_ns = 0     # total time blocked at the gate
        self.rounds = 0      # turns this ticket has taken

    def info(self) -> dict:
        return {"waitMs": round(self.wait_ns / 1e6, 3),
                "timeslices": self.granted,
                "quantum": self.quantum,
                "rounds": self.rounds}


class FairInterleaver:
    """Weighted round-robin timeslice scheduler for one session."""

    # bound on how far a light query's quantum may scale past the base
    MAX_WEIGHT_SCALE = 8
    # turn LEASE: a holder that has not consumed a slice within this
    # window is off-gate (a kernel build, a long stage body, the
    # post-final-gate tail before its context exits) — waiters pass
    # the turn over it rather than stalling the whole round behind
    # work the gate cannot see.  The passed-over query rejoins on its
    # next gate like any other ticket; the scheduler is cooperative,
    # so this lease is what keeps one tenant's long host step from
    # serializing every co-tenant.
    TURN_LEASE_S = 0.05

    def __init__(self, quantum_batches: int = 1):
        self.quantum_batches = max(int(quantum_batches), 1)
        self._cond = threading.Condition()
        self._order: List[InterleaveTicket] = []
        self._cur = 0
        self._turn_t0 = time.monotonic()  # when the turn last moved
        # cumulative counters (snapshot())
        self.total_registered = 0
        self.total_slices = 0
        self.total_wait_ns = 0
        self.peak_tickets = 0
        self.turn_leases_expired = 0

    # ------------------------------------------------------------ weights --
    def quantum_for(self, ctx) -> int:
        """Slices per turn from the query's serving budgets: byte
        weights lighter than the pool default scale the quantum up
        (bounded), a deadline budget doubles it — the queries a human
        is waiting on advance more batches per round.  Every query
        gets at least one slice per round regardless."""
        q = self.quantum_batches
        session = getattr(ctx, "session", None)
        ctrl = getattr(session, "admission", None) if session else None
        weight = int(getattr(ctx, "memory_budget", 0) or 0)
        if ctrl is not None and weight:
            default = max(int(ctrl.default_weight), 1)
            if weight < default:
                q *= min(max(default // weight, 1),
                         self.MAX_WEIGHT_SCALE)
        if getattr(ctx, "deadline_budget_ms", 0):
            q *= 2
        return max(min(q, self.quantum_batches *
                       self.MAX_WEIGHT_SCALE * 2), 1)

    # ------------------------------------------------------------- rounds --
    def register(self, ctx) -> InterleaveTicket:
        ticket = InterleaveTicket(self.quantum_for(ctx))
        with self._cond:
            self._order.append(ticket)
            self.total_registered += 1
            self.peak_tickets = max(self.peak_tickets,
                                    len(self._order))
            self._cond.notify_all()
        return ticket

    def unregister(self, ticket: InterleaveTicket) -> None:
        """Drop a finished query from the round; if it held the turn,
        the turn passes to the next ticket immediately."""
        with self._cond:
            try:
                idx = self._order.index(ticket)
            except ValueError:
                return
            held_turn = idx == self._cur
            del self._order[idx]
            if idx < self._cur:
                self._cur -= 1  # same current ticket, shifted left
            if self._order and self._cur >= len(self._order):
                self._cur = 0  # the removed tail held the turn: wrap
            if held_turn and self._order:
                self._order[self._cur].used = 0
                self._order[self._cur].rounds += 1
                self._turn_t0 = time.monotonic()
            self._cond.notify_all()

    def _advance_locked(self) -> None:
        if not self._order:
            return
        self._cur = (self._cur + 1) % len(self._order)
        nxt = self._order[self._cur]
        nxt.used = 0
        nxt.rounds += 1
        self._turn_t0 = time.monotonic()
        self._cond.notify_all()

    def yield_slice(self, ticket: InterleaveTicket) -> None:
        """The batch-boundary gate: consume one slice when it is this
        ticket's turn (advancing the round when its quantum is spent),
        else block until the turn arrives.  Waits poll with watchdog
        cancellation checkpoints so a deadline-budgeted query blocked
        here still times out as a retryable fault instead of wedging;
        the wait is traced as a ``scheduler.timeslice`` span."""
        # single-tenant fast path: no lock, no wait (len is one atomic
        # read; a concurrent register just means the NEXT boundary
        # starts taking turns)
        if len(self._order) <= 1:
            ticket.used += 1
            ticket.granted += 1
            self.total_slices += 1
            return
        from spark_rapids_tpu_torch.robustness import watchdog
        from spark_rapids_tpu_torch.utils import tracing
        t0 = time.perf_counter_ns()
        waited = False
        with self._cond:
            while True:
                if ticket not in self._order:
                    break  # unregistered underneath us: never block
                cur = self._order[self._cur]
                if cur is ticket:
                    if ticket.used < ticket.quantum:
                        ticket.used += 1
                        ticket.granted += 1
                        self.total_slices += 1
                        self._turn_t0 = time.monotonic()
                        break
                    # quantum spent: pass the turn and (unless the
                    # round came straight back — everyone else left)
                    # wait for it to return
                    self._advance_locked()
                    continue
                if time.monotonic() - self._turn_t0 > \
                        self.TURN_LEASE_S:
                    # the holder is off-gate (compiling, mid-stage,
                    # or in its tail): pass the turn over it so the
                    # round keeps moving — it rejoins at its next gate
                    self.turn_leases_expired += 1
                    self._advance_locked()
                    continue
                waited = True
                # bounded waits so cancellation (watchdog trip,
                # deadline budget) is delivered instead of sleeping
                # on a condition no one may ever signal
                watchdog.checkpoint()
                self._cond.wait(0.02)
        if waited:
            wait_ns = time.perf_counter_ns() - t0
            ticket.wait_ns += wait_ns
            self.total_wait_ns += wait_ns
            if tracing._armed:
                tracing.emit_span("scheduler.timeslice", t0, wait_ns,
                                  is_async=False)

    def interleaved(self, iterator, ticket: InterleaveTicket):
        """Wrap an operator batch iterator so every pull passes
        through the timeslice gate (the ``DataFrame._drive`` hook —
        runs on the pipeline worker thread when pipelined, which is
        exactly the thread doing the dispatching)."""
        for batch in iterator:
            yield batch
            self.yield_slice(ticket)

    def snapshot(self) -> dict:
        with self._cond:
            return {
                "tickets": len(self._order),
                "totalRegistered": self.total_registered,
                "totalSlices": self.total_slices,
                "totalWaitMs": round(self.total_wait_ns / 1e6, 3),
                "peakTickets": self.peak_tickets,
                "turnLeasesExpired": self.turn_leases_expired,
            }


def yield_current(session) -> None:
    """Gate the calling thread's query at a stage boundary, resolving
    the ticket through the thread's QueryContext: the hook the sharded
    path's planner calls before each exchange stage (a sharded query's
    'batches' are its stages)."""
    sched = getattr(session, "interleaver", None)
    if sched is None:
        return
    from spark_rapids_tpu_torch.serving import context as qc
    ctx = qc.current()
    ticket: Optional[InterleaveTicket] = \
        getattr(ctx, "interleave_ticket", None) if ctx else None
    if ticket is not None:
        sched.yield_slice(ticket)
