"""Stage-boundary lineage checkpoints for partial query recovery.

Counterpart of ``spark_rapids_tpu/robustness/checkpoint.py``.  Without
it the recovery ladder (``driver.py``) re-runs a failed sharded query
from its sources: a fault in the last exchange of a five-stage plan
throws every completed stage away.  Each time the distributed planner
(``parallel/dist_planner.py``) completes an exchange-consuming operator
(aggregate, join, sort, top-N), the operator's output frame is registered
here as a named :class:`StageCheckpoint` in a per-query lineage log:

- the **stage id** is a sha256 of the plan subtree's structural
  signature (``plan/template.plan_signature``: every node's attributes,
  expressions in full; the JAX package hashes its tree text, which in the
  port names only output columns) with the columns its scans read, plus
  the shard layout (the ``ShardGroup``'s kind, shard
  count, local shards and device), so the same subtree re-planned on the
  next attempt resolves to the same entry;
- the **payload** is the frame itself: one spill-catalog batch per local
  shard holding the frame's tensors (no copy).  The query's next stage
  still holds those tensors, so the batches register as aliased: while
  they stay on the card the catalog counts them in neither its device
  bytes nor the query's memory budget, and pressure does not move them
  (a move would free nothing).  The log bounds them itself by
  ``maxBytes``, and a write is best effort: a failed one drops the
  entry and the query goes on.  A tier policy without DEVICE moves them
  to the host at once, where they gain the catalog's crc32;
- the **stamp**: a payload that never leaves the card is verified too.
  Where the JAX package brings the frame to the host for a crc32, the
  port folds it on the card: per buffer, the sum mod 2^64 of its words
  (its elements as integers of their width) each times an odd weight of
  its position, and over the buffers those sums each times an odd
  multiplier of the buffer's place.  A flipped bit changes a word by
  ±2^b, and two odd factors times 2^b are not 0 mod 2^64, so any single
  flipped bit changes the stamp.  A save launches about three ops a
  buffer and waits for nothing; a restore recomputes the stamp and
  fetches one flag (one counted sync);
- on a **resume** attempt (the driver arms ``mode.resume`` for the
  retry and spill rungs) the planner asks the log before it recurses into
  a subtree, and splices the checkpoint in place of the subtree's scans,
  stages and exchanges;
- a checkpoint that fails its stamp, no longer materializes or was
  evicted is dropped from the log and its subtree re-runs: never wrong
  bytes, never a stuck query;
- rungs that change the layout (split, demote, cpu) clear the log.

Governed by ``spark.rapids.sql.recovery.checkpoint.{enabled,maxBytes,
tiers}``; observable through the ``CheckpointWrite`` /
``CheckpointResume`` / ``CheckpointEvict`` / ``CheckpointInvalid``
events, with watchdog sections and injection points
``checkpoint.write`` and ``checkpoint.restore`` (a corrupt rule there is
offered a host copy of the first payload buffer, and only while a rule
is armed).
"""

from __future__ import annotations

import hashlib
import threading
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch.robustness import inject, watchdog
from spark_rapids_tpu_torch.robustness.inject import (fire, fire_mutate,
                                                      register_point)

# checkpoints are insurance, colder than shuffle outputs: under device
# pressure they leave the card before any live batch
CHECKPOINT_PRIORITY = -1500

register_point("checkpoint.write")
register_point("checkpoint.restore")

# odd multiplier of the stamp's position weights (the golden ratio's
# 64-bit constant, as a signed int64), and the words one weighted sum
# covers (the cached weights stay at most 32 MiB a device)
_WEIGHT_MUL = 0x9E3779B97F4A7C15 - (1 << 64)
_FOLD_CHUNK = 1 << 22
_INT_VIEW = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
             8: torch.int64}


class CheckpointMetrics:
    """Process-wide checkpoint counters."""

    FIELDS = ("writes", "bytesWritten", "resumes", "stagesSkipped",
              "evictions", "invalid")

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {k: 0 for k in self.FIELDS}

    def bump(self, field: str, by: int = 1) -> None:
        with self._lock:
            self.counters[field] += int(by)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.counters)

    def reset(self) -> None:
        with self._lock:
            for k in self.counters:
                self.counters[k] = 0


checkpoint_metrics = CheckpointMetrics()


def input_fingerprint(plan, memo: Optional[dict] = None) -> str:
    """Identity of everything a subtree reads: for every FileRelation the
    sorted (path, size, mtime_ns) triples of its files (an appended file,
    a new size or a same-size rewrite, which only the mtime shows, moves
    it), and for every InMemoryRelation the ids and row counts of its
    live batches (two relations alive at once never share an id; a
    holder of the fingerprint keeps weak references to the batches
    (:func:`inmemory_batches`) and drops its entry once one has died,
    since CPython recycles the id for new data; a batch's capacity
    stands for its size, which needs no sync).  ``memo`` (one planner run's dict) stats each
    scan node once per attempt."""
    from spark_rapids_tpu_torch.io.readers import (input_signature,
                                                   scan_input_meta)
    from spark_rapids_tpu_torch.plan import logical as L
    parts = []

    def scan_part(node):
        if memo is not None and id(node) in memo:
            return memo[id(node)]
        part = "files:" + input_signature(scan_input_meta(node.paths))
        if memo is not None:
            memo[id(node)] = part
        return part

    def walk(node):
        if isinstance(node, L.FileRelation):
            parts.append(scan_part(node))
        elif isinstance(node, L.InMemoryRelation):
            parts.append("mem:" + ";".join(
                f"{id(b)}={b.capacity}" for b in node.batches))
        for c in node.children:
            walk(c)

    walk(plan)
    return "\x1e".join(parts)


def inmemory_batches(plan) -> list:
    """The batch objects of every InMemoryRelation leaf: the objects whose
    ids the input fingerprint holds."""
    from spark_rapids_tpu_torch.plan import logical as L
    out = []

    def walk(node):
        if isinstance(node, L.InMemoryRelation):
            out.extend(node.batches)
        for c in node.children:
            walk(c)

    walk(plan)
    return out


def _scan_columns(plan) -> str:
    """The columns each scan of the subtree reads and the filters pushed
    into it (``plan/overrides._pushdown_pass`` sets them per query, from
    what the whole plan reads): a frame carries unread columns as
    placeholders, so two queries may share a subtree's frame only when
    its scans read the same columns."""
    from spark_rapids_tpu_torch.plan import logical as L
    parts = []

    def walk(node):
        if isinstance(node, (L.InMemoryRelation, L.FileRelation)):
            req = getattr(node, "required_columns", None)
            parts.append(repr(None if req is None else sorted(req)))
            pushed = getattr(node, "pushed_filters", None)
            if pushed:
                parts.append(repr([e.cache_key() for e in pushed]))
        for c in node.children:
            walk(c)

    walk(plan)
    return ";".join(parts)


def stage_id(plan, group, memo: Optional[dict] = None,
             inputs: bool = True) -> str:
    """Stable lineage key of one plan subtree on one shard layout.
    Structural, not object identity: every re-planned attempt resolves
    the same subtree to the same id, and two occurrences of one subtree
    (a self-join) share a checkpoint.  With ``inputs`` (the shared
    store's case) the key folds in the subtree's input fingerprint, so a
    store that splices across queries never splices a frame of other
    bytes; the per-query log passes False (its inputs cannot change
    mid-query).  A full sha256: a key collision would splice another
    stage's valid bytes, which no payload check can catch."""
    from spark_rapids_tpu_torch.plan.template import plan_signature
    sig = "\x1f".join([
        repr(plan_signature(plan)),
        _scan_columns(plan),
        input_fingerprint(plan, memo) if inputs else "",
        type(group).__name__,
        f"shards={group.nshards}",
        f"local={list(group.local_shards)}",
        f"device={group.device}",
    ])
    return hashlib.sha256(sig.encode()).hexdigest()


def _words(t: torch.Tensor) -> torch.Tensor:
    """A buffer's elements as int64 words (each viewed as an integer of
    its own width, sign-extended)."""
    t = t.reshape(-1)
    if t.dtype == torch.bool:
        t = t.view(torch.uint8)
    elif t.dtype.is_floating_point or t.dtype.is_complex:
        t = t.contiguous().view(_INT_VIEW[t.element_size()])
    return t if t.dtype == torch.int64 else t.to(torch.int64)


_weights_cache: Dict[str, torch.Tensor] = {}
_weights_lock = threading.Lock()


def _weights(n: int, device) -> torch.Tensor:
    """The first ``n`` (at most ``_FOLD_CHUNK``) position weights, odd
    int64s (``i * MUL + 1``, an odd multiplier), made once per device and
    grown by doubling."""
    key = str(device)
    with _weights_lock:
        w = _weights_cache.get(key)
        if w is None or w.shape[0] < n:
            size = 1 << max(n - 1, 1).bit_length()
            w = torch.arange(size, dtype=torch.int64, device=device)
            w = w * _WEIGHT_MUL + 1
            w |= 1
            _weights_cache[key] = w
    return w[:n]


def _to_int64(v: int) -> int:
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= 1 << 63 else v


def payload_stamp(buffers: List[Optional[torch.Tensor]], host_ints,
                  device) -> torch.Tensor:
    """The stamp (see the module docstring) of the buffers, in order, and
    of some host integers (row counts), as a 0-d int64 tensor on
    ``device``; launches only, with no copy to or from the host.  Each
    buffer's words are weighted by an odd weight of their position and
    summed, and the sums are weighted by an odd multiplier of their
    chunk's place (a buffer past ``_FOLD_CHUNK`` words sums in chunks);
    the host integers and the buffers' lengths fold in as a scalar.  A
    zero-stride buffer folds its one element."""
    host = 0
    sums = []
    for b, t in enumerate(buffers):
        mult = (b * _WEIGHT_MUL + 3) | 1
        if t is None:
            host += mult * 0x51ED
            continue
        n = t.numel()
        if t.dim() == 1 and n > 1 and t.stride(0) == 0:
            t = t[:1]
        host += mult * (n + 1)
        w = _words(t)
        # chunks of at most _FOLD_CHUNK words, each a sum of its own
        for lo in range(0, w.shape[0], _FOLD_CHUNK):
            part = w[lo:lo + _FOLD_CHUNK]
            sums.append((part * _weights(part.shape[0], w.device)).sum())
    for j, v in enumerate(host_ints):
        host += ((j * _WEIGHT_MUL + 5) | 1) * (int(v) + 7)
    if not sums:
        return torch.full((), _to_int64(host), dtype=torch.int64,
                          device=device)
    stacked = torch.stack(sums)
    mults = torch.arange(len(sums), dtype=torch.int64,
                         device=stacked.device) * _WEIGHT_MUL + 3
    mults |= 1
    return (stacked * mults).sum() + _to_int64(host)


class StageCheckpoint:
    """One lineage entry: the catalog handles of the frame's local shards
    and what splicing them back needs (schema, dictionaries, pruned
    columns, row counts, the live columns' value types), the stamp, and
    weak references to the in-memory input batches whose ids the stage
    id holds (the shared store's case: a dead one makes the entry
    unprovable)."""

    __slots__ = ("stage_id", "handles", "names", "dtypes", "enc",
                 "pruned", "counts", "coltypes", "stamp", "size_bytes",
                 "stages", "seq", "pins")

    def __init__(self, sid: str, handles, frame, coltypes, stamp,
                 size_bytes: int, stages: int, seq: int, pins=()):
        self.stage_id = sid
        self.handles = list(handles)
        self.names = list(frame.names)
        self.dtypes = list(frame.dtypes)
        self.enc = dict(frame.enc)
        self.pruned = frozenset(frame.pruned)
        self.counts = [int(n) for n in frame.nrows]
        self.coltypes = coltypes
        self.stamp = stamp
        self.size_bytes = size_bytes
        self.stages = stages  # exchange stages the subtree holds
        self.seq = seq
        self.pins = [weakref.ref(b) for b in pins]

    def pins_alive(self) -> bool:
        return all(r() is not None for r in self.pins)

    @property
    def stored_bytes(self) -> int:
        return sum(h.stored_bytes for h in self.handles if not h.closed)

    def close(self) -> None:
        for h in self.handles:
            try:
                h.close()
            except Exception:
                pass


def _stamp_buffers(shards, live) -> List[Optional[torch.Tensor]]:
    """Each shard's live columns' values and validity, in order."""
    bufs: List[Optional[torch.Tensor]] = []
    for shard in shards:
        for i in live:
            bufs.append(shard[i].values)
            bufs.append(shard[i].validity)
    return bufs


class CheckpointManager:
    """Per-query lineage log of StageCheckpoints.

    Lives on ``session.checkpoints`` for one ``DataFrame._execute_batches``
    call (every attempt of one query); the driver arms ``resume`` on
    retry-class rungs and clears the log on layout-changing ones; the
    planner saves after each completed exchange stage and restores on
    resume attempts."""

    # the shared store (serving/reuse.SharedStageCache) sets this: the
    # planner then asks the log on first attempts too
    always_resume = False
    priority = CHECKPOINT_PRIORITY

    def __init__(self, session):
        from spark_rapids_tpu_torch.config import rapids_conf as rc
        self.session = session
        conf = session.conf
        self.enabled = bool(conf.get(rc.RECOVERY_CHECKPOINT_ENABLED))
        self.max_bytes = int(conf.get(rc.RECOVERY_CHECKPOINT_MAX_BYTES))
        self.tiers = tuple(
            t.strip().upper()
            for t in conf.get(rc.RECOVERY_CHECKPOINT_TIERS).split(",")
            if t.strip())
        self.catalog = getattr(session, "memory_catalog", None)
        self._entries: Dict[str, StageCheckpoint] = {}
        self._seq = 0
        self.local = {k: 0 for k in CheckpointMetrics.FIELDS}

    @classmethod
    def for_query(cls, session) -> Optional["CheckpointManager"]:
        """Install a manager on the session for one query; None (and no
        change) when checkpointing cannot apply: no shard group, the conf
        off, no catalog, or a manager already active."""
        if getattr(session, "shards", None) is None:
            return None
        if getattr(session, "checkpoints", None) is not None:
            return None
        mgr = cls(session)
        if not mgr.enabled or mgr.catalog is None:
            return None
        session.checkpoints = mgr
        return mgr

    def finish(self) -> None:
        """Query over: release every payload and detach from the session
        (stage ids mean something only against this query's plan)."""
        for e in list(self._entries.values()):
            e.close()
        self._entries.clear()
        if getattr(self.session, "checkpoints", None) is self:
            self.session.checkpoints = None

    def _bump(self, field: str, by: int = 1) -> None:
        checkpoint_metrics.bump(field, by)
        self.local[field] += int(by)

    def _emit(self, event: str, **fields) -> None:
        from spark_rapids_tpu_torch.utils.events import emit_on_session
        emit_on_session(event, session=self.session, **fields)

    def snapshot(self) -> Dict[str, int]:
        out = dict(self.local)
        out["live"] = len(self._entries)
        out["liveBytes"] = self.live_bytes
        out["liveBytesRaw"] = self.live_bytes_raw
        return out

    @property
    def live_bytes(self) -> int:
        """Bytes the entries occupy at their current tiers (a compressed
        host frame counts its own)."""
        return sum(e.stored_bytes for e in self._entries.values())

    @property
    def live_bytes_raw(self) -> int:
        return sum(e.size_bytes for e in self._entries.values())

    # ---------------------------------------------------------- write --
    def save(self, sid: str, frame, stages: int = 1, pins=()) -> None:
        """Register a completed stage's frame under ``sid``; ``pins``: the
        in-memory input batches a stage id with inputs folded in names by
        id.  Best effort: an I/O failure or a memory budget the write
        would pass drops the checkpoint (the query goes on without it); a
        watchdog deadline on a wedged write is a TimeoutFault."""
        from spark_rapids_tpu_torch.robustness.faults import (
            BudgetExhaustedFault)
        if not self.enabled or sid in self._entries:
            return
        with watchdog.section("checkpoint.write"):
            fire("checkpoint.write")
            try:
                self._save_body(sid, frame, stages, pins)
            except (OSError, BudgetExhaustedFault):
                self.drop(sid, reason="write-failed")

    def _save_body(self, sid: str, frame, stages: int, pins) -> None:
        from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
        from spark_rapids_tpu_torch.columnar.column import Column
        from spark_rapids_tpu_torch.memory.spill import DEVICE
        live = frame.live
        if frame.dry or not live or any(
                frame.shards[s][i].offsets is not None
                for s in range(len(frame.shards)) for i in live):
            return
        phys = frame.phys_dtypes
        handles = []
        for shard, n in zip(frame.shards, frame.nrows):
            cols = {f"c{i}": Column(phys[i], shard[i].values, int(n),
                                    validity=shard[i].validity)
                    for i in live}
            handles.append(self.catalog.register(
                ColumnarBatch(cols, int(n)), priority=self.priority,
                aliased=True))
        stamp = payload_stamp(_stamp_buffers(frame.shards, live),
                              frame.nrows, frame.group.device)
        entry = StageCheckpoint(
            sid, handles, frame, [frame.shards[0][i].dtype for i in live],
            stamp,
            sum(h.size_bytes for h in handles), stages, self._seq, pins)
        self._seq += 1
        self._entries[sid] = entry
        if DEVICE not in self.tiers:
            # the tier policy keeps checkpoints off the card
            for h in handles:
                self.catalog.demote(h, self.tiers[0] if self.tiers
                                    else "HOST")
        self._bump("writes")
        self._bump("bytesWritten", entry.size_bytes)
        self._emit("CheckpointWrite", stageId=sid, bytes=entry.size_bytes,
                   stages=stages, tier=handles[0].tier)
        self._evict_over_budget()

    def _evict_over_budget(self) -> None:
        """Oldest first, until the log holds at most ``maxBytes``."""
        while self.live_bytes > self.max_bytes and self._entries:
            victim = min(self._entries.values(), key=lambda e: e.seq)
            self.drop(victim.stage_id, reason="max-bytes", evict=True)

    # -------------------------------------------------------- restore --
    def restore(self, sid: str, group):
        """The checkpoint of ``sid`` as a ShardedFrame, or None when the
        subtree must re-run (no entry, evicted, stamp mismatch, a payload
        that does not materialize).  Wrong bytes are never returned."""
        entry = self._entries.get(sid)
        if entry is None:
            return None
        if not entry.pins_alive():
            # an in-memory input died: its id may now name other data
            self.drop(sid, reason="input-batch-collected")
            return None
        from spark_rapids_tpu_torch.robustness.faults import CorruptionFault
        with watchdog.section("checkpoint.restore"):
            try:
                batches = [h.materialize() for h in entry.handles]
            except (CorruptionFault, OSError, ValueError) as e:
                # the catalog's own check (or a vanished disk frame, a
                # closed handle) already dropped the batch
                self.drop(sid, reason=f"{type(e).__name__}: {e}")
                return None
            return self._restore_body(sid, entry, batches, group)

    def _restore_body(self, sid, entry, batches, group):
        from spark_rapids_tpu_torch.ops.expressions import ColVal
        from spark_rapids_tpu_torch.parallel.dist_planner import (
            ShardedFrame, _placeholder)
        from spark_rapids_tpu_torch.utils import hostsync
        live = [i for i in range(len(entry.names)) if i not in entry.pruned]
        # the catalog restores exact-length buffers (validity None where
        # the frame had none)
        shards = [{i: ColVal(dt, batch.columns[f"c{i}"].data,
                             batch.columns[f"c{i}"].validity)
                   for i, dt in zip(live, entry.coltypes)}
                  for batch in batches]
        if inject._armed:
            self._offer_corruption(shards, live)
        got = payload_stamp(_stamp_buffers(shards, live), entry.counts,
                            group.device)
        (same,) = hostsync.fetch_all([got == entry.stamp])
        if not bool(same):
            self.drop(sid, reason="stamp mismatch")
            return None
        out = []
        for row, n in zip(shards, entry.counts):
            out.append([row[i] if i in row else
                        _placeholder(entry.dtypes[i], n, group.device)
                        for i in range(len(entry.names))])
        self._bump("resumes")
        self._bump("stagesSkipped", entry.stages)
        self._emit("CheckpointResume", stageId=sid, bytes=entry.size_bytes,
                   stagesSaved=entry.stages)
        return ShardedFrame(group, entry.names, entry.dtypes, out,
                            list(entry.counts), entry.enc, entry.pruned)

    @staticmethod
    def _offer_corruption(shards, live) -> None:
        """Chaos hook, only while a rule is armed: the first non-empty
        data buffer, as a host copy, to a corrupt rule on
        ``checkpoint.restore``; its rotten copy replaces the buffer."""
        for row in shards:
            for i in live:
                v = row[i].values
                if v.numel() == 0:
                    continue
                host = v.detach().to("cpu").numpy()
                mutated = fire_mutate("checkpoint.restore", host)
                if mutated is not host:
                    row[i] = type(row[i])(
                        row[i].dtype,
                        torch.from_numpy(np.ascontiguousarray(mutated))
                        .to(v.device), row[i].validity)
                return

    # --------------------------------------------------- invalidation --
    def drop(self, sid: str, reason: str, evict: bool = False) -> None:
        """Remove one entry; its subtree re-runs on the next attempt."""
        entry = self._entries.pop(sid, None)
        if entry is not None:
            entry.close()
        if evict:
            self._bump("evictions")
            self._emit("CheckpointEvict", stageId=sid, reason=reason,
                       bytes=entry.size_bytes if entry else 0)
        else:
            self._bump("invalid")
            self._emit("CheckpointInvalid", stageId=sid, reason=reason)

    def clear(self, reason: str) -> None:
        """Invalidate the whole log: a rung changed the shard layout."""
        if not self._entries:
            return
        for sid in list(self._entries):
            self._entries.pop(sid).close()
        self._bump("invalid")
        self._emit("CheckpointInvalid", stageId="*", reason=reason)
