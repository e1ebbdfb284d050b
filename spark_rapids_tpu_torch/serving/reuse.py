"""Cross-query computation reuse: the result cache and the shared stage
store.

Counterpart of ``spark_rapids_tpu/serving/reuse.py``, without its fleet
and epoch tiers (they come with ``serving/fleet.py`` and
``robustness/incremental.py``).

**ResultCache**: a plan-keyed, budgeted store of whole query results on
the spill catalog's host and disk tiers, asked by
``DataFrame._execute_batches`` before planning.  The exact tier keys on
the plan's structural signature (``plan/template.plan_signature``:
every node's attributes, literal values included); the template tier on
(template fingerprint, parameter vector), one entry per binding of a
hoisted template.  A hit also needs the plan's input fingerprint
(``robustness/checkpoint.input_fingerprint``: file path/size/mtime_ns
triples statted afresh at lookup, in-memory batch identities) to match,
and re-checks the stored crc32 (the ``resultcache.load`` and
``templatecache.load`` injection points feed that check real rot); any
failure invalidates the entry and the query runs.  In-memory inputs are
held by weak references: an input batch that died invalidates the entry,
since its recycled ``id()`` could alias other data.  A hit runs no
operator and returns the stored batches as CPU tensors (``to_arrow``
reads them there; nothing goes back to the card).  Plans with Python or
torch UDFs or pandas nodes are never cached.

**SharedStageCache**: the ``always_resume`` lineage store over
``CheckpointManager``, shared by a session's queries: every sharded
query registers its completed exchange stages, and asks the store on its
first attempt, so two different queries sharing a subtree (same scan,
filter and partial aggregate, proven by the structural stage id with the
input fingerprint folded in) splice each other's frames.  An entry holds
weak references to its in-memory input batches, as a cached result
does: once one has died, its recycled id could name another table of
the same size, so the entry drops and the subtree re-runs.  Entries carry
the registering query's id; the recovery driver's layout-rung
``clear()`` is a no-op here (a rung moves one query off the shards, the
entries stay valid for the others).  A failed stamp, an eviction or a
moved fingerprint re-runs the subtree.

Both live in the session's spill catalog (moved to the host at write,
so standing reuse state never competes with live batches for the card)
under ``spark.rapids.tpu.serving.{resultCache,sharedStage}.*``.
"""

from __future__ import annotations

import hashlib
import itertools
import threading
import weakref
from typing import Dict, Optional

from spark_rapids_tpu_torch.robustness.checkpoint import (
    CheckpointManager, checkpoint_metrics, inmemory_batches,
    input_fingerprint)
from spark_rapids_tpu_torch.robustness.inject import (fire, fire_mutate,
                                                      register_point)

# chaos surface: raise/delay rules turn a load into a miss (the query
# runs), corrupt rules rot a stored payload for the crc check; the
# template tier has its own point
register_point("resultcache.load")
register_point("templatecache.load")

# spill priorities: reuse state is colder than a query's checkpoints
# (-1500), so a live query's lineage keeps the card first
SHARED_STAGE_PRIORITY = -1750
RESULT_CACHE_PRIORITY = -1800


def in_tick_execution() -> bool:
    """Whether the calling thread runs a continuous-ingest tick, whose
    plans bypass both stores in the JAX package.  The port has no
    ``robustness/incremental.py`` yet, so no thread does."""
    return False


def _coop_acquire(lock) -> None:
    """Watchdog-cooperative lock acquire: a thread blocked behind a
    wedged peer still receives its deadline's cancellation."""
    from spark_rapids_tpu_torch.robustness import watchdog
    while not lock.acquire(timeout=0.05):
        watchdog.checkpoint()


class _Locked:
    """``with _Locked(lock):`` through the cooperative acquire."""

    __slots__ = ("lock",)

    def __init__(self, lock):
        self.lock = lock

    def __enter__(self):
        _coop_acquire(self.lock)
        return self

    def __exit__(self, *exc):
        self.lock.release()
        return False


def _offer_rot(point: str, payload: dict) -> dict:
    """Chaos hook: the first non-empty buffer to a corrupt rule at
    ``point``; a rotten copy replaces it in a copy of the dict."""
    key = next((k for k in sorted(payload) if payload[k].size > 0), None)
    if key is None:
        return payload
    mutated = fire_mutate(point, payload[key])
    if mutated is payload[key]:
        return payload
    payload = dict(payload)
    payload[key] = mutated
    return payload


class _CachedResult:
    """One plan's stored result: a catalog handle per batch, with the
    crc32 and row count of each, and weak references to the in-memory
    input batches whose ids the stored fingerprint holds (a dead one
    makes the entry unprovable: invalidated at the next lookup)."""

    __slots__ = ("key", "fingerprint", "parts", "seq", "owner_qid", "hits",
                 "pins")

    def __init__(self, key, fingerprint, parts, seq, owner_qid, pins=()):
        self.key = key
        self.fingerprint = fingerprint
        self.parts = parts  # [(handle, crc, nrows)] in batch order
        self.seq = seq
        self.owner_qid = owner_qid
        self.hits = 0
        self.pins = [weakref.ref(b) for b in pins]

    def pins_alive(self) -> bool:
        return all(r() is not None for r in self.pins)

    @property
    def stored_bytes(self) -> int:
        return sum(h.stored_bytes for h, _, _ in self.parts if not h.closed)

    def close(self) -> None:
        for h, _, _ in self.parts:
            try:
                h.close()
            except Exception:
                pass


class PendingResult:
    """The token ``offer()`` returns: the key and the input fingerprint
    taken BEFORE execution (a file changed mid-run leaves the entry with
    the old identity, so the next lookup misses)."""

    __slots__ = ("key", "fingerprint", "hit", "batches", "cacheable",
                 "pins", "tier")

    def __init__(self):
        self.key: Optional[str] = None
        self.fingerprint: Optional[str] = None
        self.hit = False
        self.batches = None
        self.cacheable = False
        self.pins: list = []
        self.tier = "exact"   # or "template"


class ResultCache:
    """A session's budgeted result store (see the module docstring)."""

    def __init__(self, session):
        from spark_rapids_tpu_torch.config import rapids_conf as rc
        self.session = session
        conf = session.conf
        self.enabled = bool(conf.get(rc.SERVING_RESULT_CACHE_ENABLED))
        self.max_bytes = int(conf.get(rc.SERVING_RESULT_CACHE_MAX_BYTES))
        self.catalog = getattr(session, "memory_catalog", None)
        self._entries: Dict[str, _CachedResult] = {}
        self._seq = itertools.count(1)
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.stores = 0
        self.invalidations = 0
        self.evictions = 0
        # the template tier shares the map, budget and lock ("T:" keys)
        self.template_hits = 0
        self.template_misses = 0
        self.template_stores = 0

    @staticmethod
    def plan_key(plan) -> str:
        """Exact plan identity: the structural signature, literal values
        included (the data is keyed by the input fingerprint)."""
        from spark_rapids_tpu_torch.plan.template import plan_signature
        return hashlib.sha256(
            repr(plan_signature(plan)).encode()).hexdigest()

    @staticmethod
    def template_key(fingerprint: str, param_vector) -> str:
        return "T:" + hashlib.sha256(
            (fingerprint + "|" + repr(param_vector)).encode()).hexdigest()

    @staticmethod
    def cacheable(plan) -> bool:
        """Only deterministic plans cache: a Python or torch UDF or a
        pandas node (arbitrary Python) is refused."""
        from spark_rapids_tpu_torch.plan.overrides import (
            PANDAS_NODES, _node_expressions)
        from spark_rapids_tpu_torch.udf.python_exec import (PythonUDF,
                                                            TorchUDF)

        def user_code(e) -> bool:
            return isinstance(e, (PythonUDF, TorchUDF)) or \
                any(user_code(c) for c in e.children)

        stack = [plan]
        while stack:
            node = stack.pop()
            if isinstance(node, PANDAS_NODES) or \
                    any(user_code(e) for e in _node_expressions(node)):
                return False
            stack.extend(node.children)
        return True

    def _emit(self, event: str, **fields) -> None:
        from spark_rapids_tpu_torch.utils.events import emit_on_session
        try:
            emit_on_session(event, session=self.session, **fields)
        except Exception:
            pass  # bookkeeping never fails a query

    @staticmethod
    def _note_sharing(**fields) -> None:
        from spark_rapids_tpu_torch.serving import context as qc
        ctx = qc.current()
        if ctx is not None:
            ctx.sharing.update(fields)

    def _note(self, tier: str, value) -> None:
        self._note_sharing(**{"templateCache" if tier == "template"
                              else "resultCache": value})

    # ----------------------------------------------------------- lookup --
    def offer(self, plan, count_miss: bool = True) -> PendingResult:
        """Ask the cache before planning: ``pend.hit`` with the stored
        batches on a verified hit; else the caller runs the query and
        hands the result to :meth:`store` with this token.
        ``count_miss=False`` for the second ask of a query that already
        missed once (after an admission wait)."""
        pend = PendingResult()
        return self._offer(pend, plan, lambda: self.plan_key(plan),
                           count_miss)

    def offer_template(self, info, count_miss: bool = True
                       ) -> PendingResult:
        """Template-tier lookup: (template fingerprint, the current
        binding's parameter vector), with the exact tier's checks."""
        pend = PendingResult()
        pend.tier = "template"
        return self._offer(
            pend, info.plan,
            lambda: self.template_key(info.fingerprint, info.param_vector()),
            count_miss)

    def _offer(self, pend: PendingResult, plan, key_fn,
               count_miss: bool) -> PendingResult:
        if not self.enabled or self.catalog is None:
            return pend
        try:
            pend.cacheable = self.cacheable(plan)
            if not pend.cacheable:
                return pend
            pend.key = key_fn()
            pend.fingerprint = input_fingerprint(plan)  # before the read
            pend.pins = inmemory_batches(plan)
        except Exception:
            pend.cacheable = False
            return pend
        try:
            batches = self._load(pend, count_miss)
        except Exception:
            batches = None  # a failed load is a miss, never a failure
        if batches is not None:
            pend.hit = True
            pend.batches = batches
        return pend

    def _count_miss_locked(self, tier: str) -> None:
        self.misses += 1
        if tier == "template":
            self.template_misses += 1

    def _miss(self, note: str, count: bool, tier: str):
        if count:
            with _Locked(self._lock):
                self._count_miss_locked(tier)
            self._note(tier, note)
        return None

    def _invalidate(self, entry: _CachedResult, reason: str,
                    count_miss: bool, tier: str):
        """Invalidate the entry if still stored (a concurrent lookup or
        eviction may have taken it) and count the miss."""
        with _Locked(self._lock):
            if self._entries.get(entry.key) is entry:
                self._invalidate_locked(entry, reason)
            if count_miss:
                self._count_miss_locked(tier)
        self._note(tier, "invalidated")
        return None

    def _load(self, pend: PendingResult, count_miss: bool = True):
        from spark_rapids_tpu_torch.memory.spill import _payload_checksum
        from spark_rapids_tpu_torch.robustness.faults import CorruptionFault
        tier = pend.tier
        point = "templatecache.load" if tier == "template" \
            else "resultcache.load"
        with _Locked(self._lock):
            entry = self._entries.get(pend.key)
            if entry is None:
                if count_miss:
                    self._count_miss_locked(tier)
                    self._note(tier, "miss")
                return None
            if entry.fingerprint != pend.fingerprint or \
                    not entry.pins_alive():
                # an input file moved, or an in-memory input died (its id
                # may now name other data): the result is unprovable
                self._invalidate_locked(
                    entry, "input-fingerprint-moved"
                    if entry.fingerprint != pend.fingerprint
                    else "input-batch-collected")
                if count_miss:
                    self._count_miss_locked(tier)
                self._note(tier, "invalidated")
                return None
            parts = list(entry.parts)
        # the heavy checks run outside the lock, so concurrent lookups do
        # not queue behind one another; an eviction closing a handle
        # meanwhile surfaces as ValueError and invalidates
        try:
            fire(point)
            batches = []
            for h, crc, nrows in parts:
                payload = _offer_rot(point, h.host_payload())
                got = _payload_checksum(payload, nrows)
                if got != crc:
                    return self._invalidate(
                        entry, f"crc {got:#010x} != stored {crc:#010x}",
                        count_miss, tier)
                batches.append(h.host_batch(payload))
        except (CorruptionFault, OSError, ValueError) as e:
            return self._invalidate(entry, f"{type(e).__name__}: {e}",
                                    count_miss, tier)
        except Exception:
            # an injected raise, or any other failed load: a miss
            return self._miss("miss", count_miss, tier)
        with _Locked(self._lock):
            if self._entries.get(pend.key) is entry:
                entry.hits += 1
                entry.seq = next(self._seq)  # least recently used: touched
            self.hits += 1
            if tier == "template":
                self.template_hits += 1
        self._emit("TemplateCacheHit" if tier == "template"
                   else "ResultCacheHit", key=pend.key[:16],
                   batches=len(batches),
                   rows=sum(int(b.row_count) for b in batches))
        self._note_sharing(**{"templateCacheHit" if tier == "template"
                              else "resultCacheHit": True})
        return batches

    # ------------------------------------------------------------ store --
    def store(self, pend: PendingResult, batches) -> None:
        """Best-effort store of a fresh result under the token's key and
        pre-execution fingerprint: each batch's live rows move to the
        host (two counted fetches a batch, the spill path's), and a
        result over the whole budget is not kept."""
        if not self.enabled or self.catalog is None or \
                not pend.cacheable or pend.hit or pend.key is None:
            return
        if any(c.dictionary is not None
               for b in batches for c in b.columns.values()):
            # an array<string>'s host string table does not travel
            # through the catalog's frames
            return
        from spark_rapids_tpu_torch.memory.spill import (
            HOST, _payload_checksum)
        parts = []
        try:
            with _Locked(self._lock):
                if pend.key in self._entries:
                    return  # a concurrent twin stored it
            from spark_rapids_tpu_torch.serving import context as qc
            ctx = qc.current()
            owner_qid = ctx.qid if ctx is not None else None
            total = 0
            for b in batches:
                h = self.catalog.register(b, priority=RESULT_CACHE_PRIORITY)
                parts.append((h, None, 0))
                self.catalog.demote(h, HOST)
                nrows = h.nrows
                crc = _payload_checksum(h.host_payload(), nrows)
                parts[-1] = (h, crc, nrows)
                total += h.stored_bytes
            if total > self.max_bytes:
                for h, _, _ in parts:
                    h.close()
                return
            with _Locked(self._lock):
                if pend.key in self._entries:
                    for h, _, _ in parts:
                        h.close()
                    return
                self._entries[pend.key] = _CachedResult(
                    pend.key, pend.fingerprint, parts, next(self._seq),
                    owner_qid, pins=pend.pins)
                self.stores += 1
                if pend.tier == "template":
                    self.template_stores += 1
                self._evict_over_budget_locked()
            # the store lands after the query's QueryEnd, so the fact
            # rides its own event
            self._emit("TemplateCacheStore" if pend.tier == "template"
                       else "ResultCacheStore", key=pend.key[:16],
                       bytes=total, batches=len(parts))
        except Exception:
            for h, _, _ in parts:
                try:
                    h.close()
                except Exception:
                    pass

    # ----------------------------------------------------- invalidation --
    def _invalidate_locked(self, entry: _CachedResult, reason: str) -> None:
        self._entries.pop(entry.key, None)
        entry.close()
        self.invalidations += 1
        self._emit("ResultCacheInvalid", key=entry.key[:16], reason=reason)

    def _evict_over_budget_locked(self) -> None:
        while self._entries and sum(
                e.stored_bytes for e in self._entries.values()) > \
                self.max_bytes:
            victim = min(self._entries.values(), key=lambda e: e.seq)
            self._entries.pop(victim.key, None)
            nbytes = victim.stored_bytes
            victim.close()
            self.evictions += 1
            self._emit("ResultCacheEvict", key=victim.key[:16],
                       bytes=nbytes, reason="max-bytes")

    def snapshot(self) -> Dict[str, int]:
        with _Locked(self._lock):
            return {
                "entries": len(self._entries),
                "bytes": sum(e.stored_bytes for e in self._entries.values()),
                "hits": self.hits,
                "misses": self.misses,
                "stores": self.stores,
                "invalidations": self.invalidations,
                "evictions": self.evictions,
                "templateHits": self.template_hits,
                "templateMisses": self.template_misses,
                "templateStores": self.template_stores,
            }

    def close(self) -> None:
        with _Locked(self._lock):
            for entry in list(self._entries.values()):
                entry.close()
            self._entries.clear()


class SharedStageCache(CheckpointManager):
    """The ``always_resume`` lineage store shared by a session's queries
    (see the module docstring): CheckpointManager's save, restore and
    stamp, with the session as its scope, a lock around its entry map,
    its own event names, per-query tallies, and a ``clear()`` that keeps
    other queries' entries."""

    always_resume = True

    def __init__(self, session):
        from spark_rapids_tpu_torch.config import rapids_conf as rc
        super().__init__(session)
        conf = session.conf
        self.enabled = bool(conf.get(rc.SERVING_SHARED_STAGE_ENABLED))
        self.max_bytes = int(conf.get(rc.SERVING_SHARED_STAGE_MAX_BYTES))
        # never on the card: shared insurance must not compete with a
        # live query's batches
        self.tiers = ("HOST", "DISK")
        self.priority = SHARED_STAGE_PRIORITY
        self._mu = threading.RLock()
        # restore() runs unlocked, so the counters have their own lock
        self._tally_mu = threading.Lock()
        # stage id -> the registering query's id
        self._owners: Dict[str, Optional[int]] = {}
        # per query (thread) write and splice tallies, popped into the
        # QueryEnd sharing dict
        self._by_ident: Dict[int, Dict[str, int]] = {}

    _EVENT_MAP = {"CheckpointWrite": "SharedStageWrite",
                  "CheckpointResume": "SharedStageSplice",
                  "CheckpointEvict": "SharedStageEvict",
                  "CheckpointInvalid": "SharedStageInvalid"}

    def _emit(self, event: str, **fields) -> None:
        sid = fields.get("stageId")
        if sid is not None and sid in self._owners:
            fields["owner"] = self._owners.get(sid)
        from spark_rapids_tpu_torch.utils.events import emit_on_session
        emit_on_session(self._EVENT_MAP.get(event, event),
                        session=self.session, **fields)

    def _bump(self, field: str, by: int = 1) -> None:
        checkpoint_metrics.bump(field, by)
        with self._tally_mu:
            self.local[field] += int(by)

    def _tally(self, field: str, by: int = 1) -> None:
        from spark_rapids_tpu_torch.serving import context as qc
        ident = qc.effective_ident()
        with self._tally_mu:
            rec = self._by_ident.setdefault(ident, {})
            rec[field] = rec.get(field, 0) + by

    def take_query_stats(self) -> Dict[str, int]:
        """Pop the calling query's write and splice tallies."""
        from spark_rapids_tpu_torch.serving import context as qc
        with self._tally_mu:
            return self._by_ident.pop(qc.effective_ident(), {})

    def save(self, sid: str, frame, stages: int = 1, pins=()) -> None:
        # saves hold the lock (once per new stage id); restores, the
        # frequent path, do not
        with _Locked(self._mu):
            known = sid in self._entries
            if not known:
                from spark_rapids_tpu_torch.serving import context as qc
                ctx = qc.current()
                self._owners[sid] = ctx.qid if ctx is not None else None
            super().save(sid, frame, stages, pins)
            if not known and sid in self._entries:
                self._tally("stageWrites")
            elif not known:
                self._owners.pop(sid, None)  # refused or failed

    def restore(self, sid: str, group):
        # unlocked: the base restore only reads the entry map, every
        # change to it goes through the locked paths, and a handle closed
        # by a concurrent eviction surfaces as ValueError: dropped, the
        # subtree re-runs
        frame = super().restore(sid, group)
        if frame is not None:
            self._tally("spliceResumes")
        return frame

    def drop(self, sid: str, reason: str, evict: bool = False) -> None:
        with _Locked(self._mu):
            super().drop(sid, reason, evict=evict)
            self._owners.pop(sid, None)

    def clear(self, reason: str) -> None:
        """A layout rung moves ONE query off the shards; the entries are
        keyed to (subtree, layout, inputs), which all still hold for the
        other queries, so nothing is cleared."""

    def finish(self) -> None:
        """The store outlives queries: a call per query clears nothing."""

    def close(self) -> None:
        """Session teardown: release every payload."""
        with _Locked(self._mu):
            for sid in list(self._entries):
                self._entries.pop(sid).close()
            self._owners.clear()
            self._by_ident.clear()

    def snapshot(self) -> Dict[str, int]:
        with _Locked(self._mu):
            return super().snapshot()
