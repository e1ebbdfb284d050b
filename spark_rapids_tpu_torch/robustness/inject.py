"""Scoped fault-injection registry: named points, count/probability
rules, context-manager scoping.

Counterpart of ``spark_rapids_tpu/robustness/inject.py``.  Each
subsystem threads one cheap ``fire(point)`` checkpoint through its hot
path; tests arm rules against those points:

    with injected("io.read", count=2):
        df.to_pandas()          # the first two scan batches fail

Rules are thread-scoped by default (a rule armed on the test thread
never fires in another session's worker thread); points that execute on
pool threads (the disk spill writers) take ``all_threads=True``.  A
pipeline worker adopts its driving thread (``adopt_thread``, through
``exec/pipeline.worker_attribution``), so a rule armed for a query
fires in its worker too.

Beyond the default ``kind="raise"``, rules can **delay/hang**
(``kind="delay"``: the checkpoint wedges for ``delay_s`` seconds, or
until the rule is disarmed when ``delay_s`` is None; each wedge slice is
a watchdog cancellation checkpoint, so a tripped deadline aborts the
stuck caller) or **corrupt** (``kind="corrupt"``: one seeded bit flipped
in the payload offered at a ``fire_mutate`` site, the spill restore
paths, so checksum verification has real rot to catch).

Points this port wires: ``io.read`` (a file scan's batch),
``shuffle.exchange`` and ``dist.host_sync`` (the sharded path),
``spill.disk``, ``spill.corrupt.host`` and ``spill.corrupt.disk`` (the
spill catalog), ``udf.worker`` (the UDF worker pool) and
``memory.oom`` (``memory/retry.py``'s guarded attempts; registered
there, with the MemoryError its ``is_oom`` recognises).  The default
exception of a point pins the fault kind/severity the real failure would
classify as, so the recovery path under test is the production one.
"""

from __future__ import annotations

import random
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Type

from spark_rapids_tpu_torch.robustness import faults as F
from spark_rapids_tpu_torch.robustness import watchdog as _watchdog

RULE_KINDS = ("raise", "delay", "corrupt")

# known points -> the fault each raises by default.  "memory.oom" is
# the legacy inject_oom surface; its exception type lives in
# memory/retry.py (it must stay a MemoryError for is_oom), so it
# registers lazily from there.
_POINTS: Dict[str, Optional[Type[BaseException]]] = {
    "io.read": F.InjectedReaderFault,
    "shuffle.exchange": F.InjectedShuffleFault,
    "dist.host_sync": F.InjectedHostSyncFault,
    "spill.disk": F.InjectedSpillFault,
    # mutate-capable restore points (memory/spill.py fire_mutate):
    # corrupt rules flip payload bits here; raise/delay rules also apply
    "spill.corrupt.host": F.InjectedSpillFault,
    "spill.corrupt.disk": F.InjectedSpillFault,
    "udf.worker": F.InjectedWorkerFault,
}


def register_point(name: str,
                   default_exc: Optional[Type[BaseException]] = None
                   ) -> None:
    """Declare an injection point (idempotent).  Subsystems call this
    at import time so ``injection_points()`` is the live catalog."""
    _POINTS.setdefault(name, default_exc)
    if default_exc is not None and _POINTS[name] is None:
        _POINTS[name] = default_exc


def injection_points() -> List[str]:
    return sorted(_POINTS)


class InjectionRule:
    """One armed rule.  Count-based by default (fire the next ``count``
    checkpoints after skipping ``skip``); with ``probability`` set,
    each checkpoint fires with that chance (seeded — chaos runs must
    replay) until ``count`` faults have fired."""

    def __init__(self, point: str, *, count: int = 1, skip: int = 0,
                 probability: Optional[float] = None,
                 seed: Optional[int] = None,
                 exc: Optional[Callable[..., BaseException]] = None,
                 all_threads: bool = False, kind: str = "raise",
                 delay_s: Optional[float] = None,
                 scope: Optional[str] = None):
        if point not in _POINTS:
            raise KeyError(
                f"unknown injection point {point!r}; known: "
                f"{injection_points()} (register_point to add one)")
        if kind not in RULE_KINDS:
            raise ValueError(
                f"unknown rule kind {kind!r}; known: {RULE_KINDS}")
        self.kind = kind
        # delay kind: wedge this long; None = hang until disarmed
        self.delay_s = delay_s
        self.point = point
        self.remaining = int(count)
        self.skip = int(skip)
        self.probability = probability
        self._rng = random.Random(seed)
        self.exc = exc or _POINTS[point] or F.InjectedFault
        self.thread_id = None if all_threads else threading.get_ident()
        # who armed this rule (effective ident: an adopted pipeline
        # worker arms on behalf of its driving thread) — scoped_rules
        # containment removes exactly ITS thread-tree's rules on exit,
        # so concurrent scopes on other threads never clobber each
        # other's armed rules
        _ident = threading.get_ident()
        self.armer = _adopted.get(_ident, _ident)
        # keyed scope (multi-tenant chaos): the rule only fires on
        # threads whose active scope key matches — explicit arg, or
        # inherited from the enclosing scoped_rules(key=...) block
        self.scope = scope if scope is not None else \
            _arming_scope()
        self.fired = 0

    def _matches_thread(self) -> bool:
        if self.scope is not None and self.scope != _active_scope():
            return False
        if self.thread_id is None:
            return True
        ident = threading.get_ident()
        # a pipeline worker adopts its driving thread's identity, so
        # rules armed on the test/driver thread still fire inside the
        # pipelined iterator (exec/pipeline.py)
        return self.thread_id == _adopted.get(ident, ident)

    def _should_fire(self) -> bool:
        if self.remaining <= 0 or not self._matches_thread():
            return False
        if self.probability is not None:
            return self._rng.random() < self.probability
        if self.skip > 0:
            self.skip -= 1
            return False
        return True

    def make_exc(self, note: str) -> BaseException:
        if isinstance(self.exc, type) and \
                issubclass(self.exc, F.InjectedFault):
            return self.exc(self.point, note)
        # plain exception classes (e.g. the legacy InjectedOomError)
        # take a single message
        return self.exc(f"injected fault at {self.point!r}"
                        + (f": {note}" if note else ""))


_lock = threading.Lock()
_rules: List[InjectionRule] = []
# worker thread ident -> the driving thread it acts for (plain dict:
# int-keyed put/get/del are atomic under the GIL, and _matches_thread
# runs on the hot path)
_adopted: Dict[int, int] = {}


def adopt_thread(owner_ident: int) -> None:
    """Make rules armed by ``owner_ident`` fire on the calling thread.
    Used by exec/pipeline.py so a fault injected for a query keeps
    firing when the operator iterator moves to the pipeline worker."""
    _adopted[threading.get_ident()] = owner_ident


def release_thread() -> None:
    _adopted.pop(threading.get_ident(), None)


def disown(ident: int) -> None:
    """Sever ``ident``'s adoption from the outside (a driver
    abandoning a wedged worker): the zombie must not keep consuming
    rule budgets armed for the driving thread's next attempt."""
    _adopted.pop(ident, None)


def purge_adoptions(mapping: Dict[int, int], owner_ident: int) -> None:
    """Drop every entry of a worker->owner adoption dict that maps TO
    ``owner_ident`` — THE query-exit cleanup shared by every adoption
    registry (inject, watchdog, hostsync, retry, serving/context): the
    OS reuses thread idents, so an adoption a finished worker left
    behind would bind a future thread with the recycled ident to a
    dead query.  Callers holding a lock call this under it; the
    module-level dicts rely on GIL-atomic dict ops as everywhere else.
    """
    for ident in [i for i, o in list(mapping.items())
                  if o == owner_ident]:
        mapping.pop(ident, None)


def purge_owner(owner_ident: int) -> None:
    """This registry's query-exit cleanup (see :func:`purge_adoptions`
    and serving/context.QueryContext.__exit__)."""
    purge_adoptions(_adopted, owner_ident)


# scope keys (multi-tenant chaos): owner thread ident -> active key.
# Worker threads resolve through _adopted, so a rule scoped to one
# query fires in that query's pipeline worker but never in another
# query's — even with all_threads=True.
_scopes: Dict[int, str] = {}
# thread ident -> key new rules armed by that thread inherit
_arming: Dict[int, str] = {}


def _active_scope() -> Optional[str]:
    ident = threading.get_ident()
    return _scopes.get(_adopted.get(ident, ident))


def _arming_scope() -> Optional[str]:
    return _arming.get(threading.get_ident())


# thread trees (owner idents) with a scoped_rules block currently
# open: a rule armed by a tree with its OWN open scope is that
# scope's to clean up; a rule armed by any other thread is an orphan
# the enclosing scope removes on exit (the test-fixture containment
# guarantee)
_open_scopes: Dict[int, int] = {}


# cheap hot-path guard: fire() is threaded through per-batch loops and
# must cost one attribute read when nothing is armed
_armed = False


def inject(point: str, **kw) -> InjectionRule:
    """Arm a rule; see ``InjectionRule`` for the knobs.  Returns the
    rule (pass to ``remove``/inspect ``fired``)."""
    global _armed
    rule = InjectionRule(point, **kw)
    with _lock:
        _rules.append(rule)
        _armed = True
    return rule


def remove(rule: InjectionRule) -> None:
    global _armed
    with _lock:
        if rule in _rules:
            _rules.remove(rule)
        _armed = bool(_rules)


def clear(point: Optional[str] = None, *,
          this_thread_only: bool = False) -> None:
    """Disarm every rule (or just one point's).  With
    ``this_thread_only``, only rules armed by the calling thread are
    removed — the inject_oom shim needs the old ``threading.local``
    semantics where one thread's re-arm never disarms another's."""
    global _armed
    tid = threading.get_ident()

    def _keep(r: InjectionRule) -> bool:
        if point is not None and r.point != point:
            return True
        return this_thread_only and r.thread_id != tid

    with _lock:
        _rules[:] = [r for r in _rules if _keep(r)]
        _armed = bool(_rules)


@contextmanager
def injected(point: str, **kw):
    """Scope a rule to a ``with`` block — the chaos-test idiom."""
    rule = inject(point, **kw)
    try:
        yield rule
    finally:
        remove(rule)


@contextmanager
def scoped_rules(key: Optional[str] = None):
    """Hard containment scope: every rule armed inside the block —
    including rules the body leaked by never removing them, or armed
    on worker threads with ``all_threads=True`` — is disarmed on exit,
    UNLESS the arming thread tree has its own scoped_rules block still
    open (then that scope's exit owns the cleanup — one concurrent
    client finishing must never disarm another client's still-armed
    rules).  Rules armed BEFORE the scope survive it (and stay
    removable inside it).  Test fixtures wrap each test in one of
    these so injection rules can never leak across tests, whatever
    the teardown order.

    With ``key``, the scope is **keyed** (the multi-tenant chaos
    form): rules armed inside the block carry the key and only fire on
    threads whose active scope matches — this thread for the duration
    of the block, plus any worker adopted into it.  Concurrent clients
    each wrap their query in ``scoped_rules(key=client_id)``: client
    A's rules provably cannot fire inside client B's query, whatever
    ``all_threads``/probability knobs the rules use."""
    global _armed
    ident = threading.get_ident()
    my_tree = _adopted.get(ident, ident)
    prev_scope = _scopes.get(ident)
    prev_arming = _arming.get(ident)
    if key is not None:
        _scopes[ident] = key
        _arming[ident] = key
    with _lock:
        before = list(_rules)
        _open_scopes[my_tree] = _open_scopes.get(my_tree, 0) + 1
    try:
        yield
    finally:
        if key is not None:
            if prev_scope is None:
                _scopes.pop(ident, None)
            else:
                _scopes[ident] = prev_scope
            if prev_arming is None:
                _arming.pop(ident, None)
            else:
                _arming[ident] = prev_arming
        with _lock:
            # close MY scope first so my own rules are not protected
            # by it, then remove every rule armed inside the block
            # except those owned by another LIVE tree's still-open
            # scope.  The liveness check keeps the fixture guarantee
            # against scopes whose thread died without exiting (a
            # killed client can never run its own cleanup), and prunes
            # their stale _open_scopes entries so a recycled ident
            # cannot inherit the protection
            n = _open_scopes.get(my_tree, 1) - 1
            if n:
                _open_scopes[my_tree] = n
            else:
                _open_scopes.pop(my_tree, None)
            live = {t.ident for t in threading.enumerate()}
            for tree in [t for t in _open_scopes if t not in live]:
                del _open_scopes[tree]
            survivors = [r for r in _rules
                         if r in before or
                         (r.armer != my_tree and
                          _open_scopes.get(r.armer, 0) > 0)]
            _rules[:] = survivors
            _armed = bool(_rules)


def _pick(point: str, mutating: bool) -> Optional[InjectionRule]:
    """Select-and-consume the next firing rule for ``point``.  Corrupt
    rules only apply at mutate-capable sites (``fire_mutate``)."""
    with _lock:
        for rule in _rules:
            if rule.point != point:
                continue
            if rule.kind == "corrupt" and not mutating:
                continue
            if rule._should_fire():
                rule.remaining -= 1
                rule.fired += 1
                return rule
    return None


def _wedge(rule: InjectionRule) -> None:
    """The delay/hang kind: sleep in slices until the rule's duration
    elapses or the rule is disarmed (tests un-wedge by removing it).
    Each slice is a watchdog cancellation checkpoint, so a tripped
    deadline aborts the stuck caller — the cooperative analog of the
    runtime tearing down a dead collective with DEADLINE_EXCEEDED."""
    t_end = None if rule.delay_s is None else \
        time.monotonic() + rule.delay_s
    while True:
        _watchdog.checkpoint()
        if t_end is not None and time.monotonic() >= t_end:
            return
        with _lock:
            if rule not in _rules:
                return
        time.sleep(0.005)


def fire(point: str, note: str = "") -> None:
    """Checkpoint: apply the armed rule for ``point``, if any (raise
    its fault, or wedge for a delay rule).  Called on the engine's hot
    paths — the unarmed cost is one global read.  Every fire site is
    also a watchdog cancellation checkpoint."""
    _watchdog.checkpoint()
    if not _armed:
        return
    rule = _pick(point, mutating=False)
    if rule is None:
        return
    if rule.kind == "delay":
        _wedge(rule)
        return
    raise rule.make_exc(note)


def fire_mutate(point: str, data):
    """Mutate-capable checkpoint: offered a payload (bytes or a numpy
    array), a corrupt rule returns a copy with one seeded bit flipped;
    raise/delay rules behave as at ``fire``.  Returns ``data``
    unchanged when nothing fires."""
    _watchdog.checkpoint()
    if not _armed:
        return data
    rule = _pick(point, mutating=True)
    if rule is None:
        return data
    if rule.kind == "delay":
        _wedge(rule)
        return data
    if rule.kind == "corrupt":
        return _flip_bit(data, rule._rng)
    raise rule.make_exc("")


def _flip_bit(data, rng: random.Random):
    """One seeded bit flip in a COPY of the payload (the stored
    original must rot, not the caller's live view — callers pass the
    stored buffer and adopt the return value)."""
    import numpy as np
    if isinstance(data, (bytes, bytearray)):
        if not data:
            return data
        arr = np.frombuffer(bytes(data), dtype=np.uint8).copy()
        arr[rng.randrange(arr.size)] ^= 1 << rng.randrange(8)
        return arr.tobytes()
    out = np.ascontiguousarray(data).copy()
    flat = out.view(np.uint8).reshape(-1)
    if not flat.size:
        return data
    flat[rng.randrange(flat.size)] ^= 1 << rng.randrange(8)
    return out
