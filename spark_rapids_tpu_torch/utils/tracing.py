"""Span tracing: host wall-clock attribution for every engine phase.

Counterpart of ``spark_rapids_tpu/utils/tracing.py`` (the NVTX-range
analog, carried host-side):

* ``span(point, site=..., op=...)`` wraps a region.  Spans are
  **thread-aware** (each thread appends to its own buffer; list appends
  under the GIL, no lock on the hot path) and **query-attributed**: each
  record is stamped with the *effective* owner ident (an adopted
  pipeline worker resolves to its driving query, serving/context.py), so
  two concurrent queries' spans never mix.
* Nesting is tracked per thread: a span's **exclusive** time is its
  duration minus its direct children's, so rollups never double count.
* Tracing is off by default and then every span site costs one branch
  (``span`` returns a shared no-op; hot loops read ``_armed`` and skip
  even the call).  Tracing changes no data path: answers are the same
  bits with it on.
* At QueryEnd ``finish_query`` drains the owner's closed records into
  (a) a Chrome-trace-event JSON file per query under
  ``spark.rapids.tpu.trace.dir`` (tools/traceview.py), (b) an
  exclusive-time rollup per point / operator / site that rides the
  QueryEnd ``spans`` dict.  The JAX package also folds per-site times
  into a persisted observation store for its profiler and cost model;
  neither reader is ported, so neither is the store.

**Host wall clock, not device time.**  Spans read ``perf_counter_ns`` on
the host, as the JAX package's do; no CUDA event is recorded.  CUDA
launches are asynchronous, so a span around kernel launches (an
``operator.batch`` pull) measures the time to *enqueue* them; the device
time surfaces in whichever ``hostsync.fetch`` span waits for it (the
first counted fetch after the work).  Read a rollup's ``hostsync.``
points as "waiting for the card".

The runtime is process-global: the last-constructed session's
``spark.rapids.tpu.trace.*`` conf wins.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

# --------------------------------------------------------------- state --

_armed = False
_trace_dir: Optional[str] = None
_max_events = 100_000
_reg_lock = threading.Lock()
_bufs: List["_Buf"] = []
_tls = threading.local()
# per-process trace file sequence for drains without a query id
_seq_lock = threading.Lock()
_seq = 0

# record tuple indices (tuples, not objects: the hot path allocates one
# per span and the drain touches thousands)
R_POINT, R_SITE, R_OP, R_T0, R_DUR, R_EXCL, R_OWNER, R_TID, R_ASYNC = \
    range(9)

# span points that measure DEVICE-side in-flight time overlapping host
# work (the async exchange window): exported and summed as overlapMs,
# but excluded from the exclusive-attribution sums — counting them
# toward "attributed wall" would let real blind spots hide under
# overlap credit
ASYNC_POINTS = frozenset({"exchange.async.inflight"})

# phase classification for timeline stripes / bench fractions: every
# span point maps to one of compile | exchange | spill | wait | compute
# (docs/observability.md "span taxonomy")
_PHASE_PREFIXES: Tuple[Tuple[str, str], ...] = (
    ("shuffle.exchange", "exchange"),
    ("exchange.", "exchange"),
    ("spill.", "spill"),
    ("admission.wait", "wait"),
    ("scheduler.", "wait"),
    ("udf.worker", "wait"),
    ("pipeline.worker", "wait"),
    ("hostsync.", "wait"),
    ("dist.host_sync", "wait"),
)


def phase_of(point: str) -> str:
    for prefix, phase in _PHASE_PREFIXES:
        if point.startswith(prefix):
            return phase
    return "compute"


def site_id(site: Any) -> str:
    """Stable short id for a structural site object, hashed the same
    way everywhere, so the spans rollup and the Chrome trace key on
    identical strings."""
    return hashlib.sha256(repr(site).encode()).hexdigest()[:16]


class _Buf:
    """One thread's append-only span storage.

    ``items`` holds closed records; appends are plain ``list.append``
    (GIL-atomic).  The drain compacts with one slice assignment —
    also a single atomic list op — so no lock is ever taken on the
    recording path."""

    __slots__ = ("items", "stack", "dropped", "tid", "name", "thread")

    def __init__(self):
        t = threading.current_thread()
        self.items: List[tuple] = []
        # open spans: [point, site, op, t0_ns, child_ns, owner]
        self.stack: List[list] = []
        self.dropped = 0
        self.tid = t.ident or 0
        self.name = t.name
        # held so the drain can prune buffers of finished threads (the
        # pipeline spawns one worker per drive — without pruning the
        # registry grows one buffer per query for the process life)
        self.thread = t


def _buf() -> _Buf:
    b = getattr(_tls, "buf", None)
    if b is None:
        b = _Buf()
        _tls.buf = b
        with _reg_lock:
            _bufs.append(b)
    return b


def _owner_ident() -> int:
    from spark_rapids_tpu_torch.serving import context as qc
    return qc.effective_ident()


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _SpanCtx:
    __slots__ = ("point", "site", "op")

    def __init__(self, point: str, site, op):
        self.point = point
        self.site = site
        self.op = op

    def __enter__(self):
        b = _buf()
        b.stack.append([self.point, self.site, self.op,
                        time.perf_counter_ns(), 0, _owner_ident()])
        return self

    def __exit__(self, *exc):
        b = _buf()
        end = time.perf_counter_ns()
        point, site, op, t0, child_ns, owner = b.stack.pop()
        dur = end - t0
        excl = dur - child_ns
        if b.stack:
            b.stack[-1][4] += dur
        if not _armed:
            return False  # disarmed mid-span: unwind, record nothing
        if len(b.items) < _max_events:
            b.items.append((point, site, op, t0, dur, excl, owner,
                            b.tid, False))
        else:
            b.dropped += 1
        return False


def span(point: str, site=None, op=None):
    """Trace the enclosed region.  One branch when tracing is off.

    ``site``: structural site object (an operator or stage id) —
    hashed into the rollup's per-site breakdown."""
    if not _armed:
        return _NOOP
    return _SpanCtx(point, site, op)


def emit_span(point: str, t0_ns: int, dur_ns: int, site=None, op=None,
              is_async: bool = True) -> None:
    """Append an already-timed record (no stack interaction): the async
    exchange in-flight window — regions whose
    endpoints the caller times itself."""
    if not _armed:
        return
    b = _buf()
    if len(b.items) < _max_events:
        b.items.append((point, site, op, int(t0_ns), int(dur_ns),
                        int(dur_ns), _owner_ident(), b.tid, is_async))
    else:
        b.dropped += 1


# ------------------------------------------------------------ configure --

def configure(enabled: bool, trace_dir: Optional[str] = None,
              max_events: int = 100_000) -> None:
    """(Re)arm the process-global runtime from a session's conf.
    ``enabled=False`` disarms (buffers drop their backlog so a
    disarmed process holds no span memory)."""
    global _armed, _trace_dir, _max_events
    _trace_dir = trace_dir or None
    _max_events = max(int(max_events), 1)
    _armed = bool(enabled)
    if not _armed:
        with _reg_lock:
            for b in _bufs:
                del b.items[:]
                b.dropped = 0


def armed() -> bool:
    return _armed


# ---------------------------------------------------------------- drain --

def _drain(owner: int) -> Tuple[List[tuple], int]:
    """Collect (and remove) every CLOSED record attributed to
    ``owner`` across all thread buffers.  Open spans stay on their
    stacks and surface in a later drain."""
    out: List[tuple] = []
    dropped = 0
    # the whole drain holds _reg_lock: recording stays lock-free
    # (appends land at >= n and the slice assignment preserves them),
    # but two concurrent QueryEnd drains must not interleave their
    # snapshot/compact sequences on a shared buffer — a stale
    # compaction would resurrect the other query's already-drained
    # records into its next trace (cross-query duplication)
    with _reg_lock:
        # prune finished threads' drained buffers (one pipeline worker
        # is born per drive; its buffer must die with it once emptied)
        _bufs[:] = [b for b in _bufs
                    if b.thread.is_alive() or b.items or b.stack]
        for b in _bufs:
            n = len(b.items)
            mine = ()
            if n:
                snapshot = b.items[:n]
                mine = [r for r in snapshot if r[R_OWNER] == owner]
                if mine:
                    keep = [r for r in snapshot
                            if r[R_OWNER] != owner]
                    # single slice assignment: atomic under the GIL,
                    # racing appends land at >= n and are preserved
                    b.items[:n] = keep
                    out.extend(mine)
            # drop accounting is per-buffer, so attribution is
            # best-effort: charge a buffer's drops to the drain that
            # owns the buffer's thread or harvested records from it —
            # an unrelated query's drain must not zero the counter and
            # make the owner's truncated trace read as complete
            if b.dropped and (mine or b.tid == owner):
                dropped += b.dropped
                b.dropped = 0
    out.sort(key=lambda r: r[R_T0])
    return out, dropped


def discard_owner(owner: int) -> None:
    """Drop ``owner``'s closed records without reporting them.  A query
    calls this as it begins: a span closed on its thread while no query
    ran there (the previous query's ``to_arrow`` fetches, after that
    query's QueryEnd) belongs to no query, and would otherwise land in
    this query's rollup, outside its wall."""
    if _armed:
        _drain(owner)


def rollup(records: List[tuple], wall_ms: float,
           dropped: int = 0) -> Dict[str, Any]:
    """Exclusive-time rollup: per point, per operator, per structural
    site, plus the phase stripes and the unattributed-time health
    metric (wall - sum(exclusive); > 20% of wall = an instrumentation
    blind spot)."""
    points: Dict[str, Dict[str, float]] = {}
    operators: Dict[str, Dict[str, float]] = {}
    sites: Dict[str, Dict[str, float]] = {}
    phases: Dict[str, float] = {}
    total_excl = 0.0
    overlap_ms = 0.0
    for r in records:
        dur_ms = r[R_DUR] / 1e6
        excl_ms = max(r[R_EXCL], 0) / 1e6
        point = r[R_POINT]
        if r[R_ASYNC] or point in ASYNC_POINTS:
            overlap_ms += dur_ms
            p = points.setdefault(point, {"count": 0, "ms": 0.0,
                                          "exclusiveMs": 0.0})
            p["count"] += 1
            p["ms"] += dur_ms
            continue
        p = points.setdefault(point, {"count": 0, "ms": 0.0,
                                      "exclusiveMs": 0.0})
        p["count"] += 1
        p["ms"] += dur_ms
        p["exclusiveMs"] += excl_ms
        total_excl += excl_ms
        ph = phase_of(point)
        phases[ph] = phases.get(ph, 0.0) + excl_ms
        if r[R_OP]:
            o = operators.setdefault(r[R_OP], {"count": 0, "ms": 0.0,
                                               "exclusiveMs": 0.0})
            o["count"] += 1
            o["ms"] += dur_ms
            o["exclusiveMs"] += excl_ms
        if r[R_SITE] is not None:
            # one key derivation everywhere (operator and exchange sites,
            # stage ids): the observation store and the rollup must
            # agree on the string a site hashes to
            sid = site_id(r[R_SITE])
            s = sites.setdefault(sid, {"count": 0, "ms": 0.0})
            s["count"] += 1
            s["ms"] += excl_ms
    unattributed = max(wall_ms - total_excl, 0.0)
    out = {
        "wallMs": round(wall_ms, 3),
        "exclusiveMs": round(total_excl, 3),
        "unattributedMs": round(unattributed, 3),
        "unattributedFrac": round(unattributed / wall_ms, 4)
        if wall_ms > 0 else 0.0,
        "overlapMs": round(overlap_ms, 3),
        "events": len(records),
        "dropped": dropped,
        "phases": {k: round(v, 3) for k, v in sorted(phases.items())},
        "points": {k: {"count": v["count"], "ms": round(v["ms"], 3),
                       "exclusiveMs": round(v["exclusiveMs"], 3)}
                   for k, v in sorted(points.items())},
    }
    if operators:
        out["operators"] = {
            k: {"count": v["count"], "ms": round(v["ms"], 3),
                "exclusiveMs": round(v["exclusiveMs"], 3)}
            for k, v in sorted(operators.items())}
    if sites:
        out["sites"] = {k: {"count": v["count"], "ms": round(v["ms"], 3)}
                        for k, v in sorted(sites.items())}
    return out


def finish_query(session, qid: Optional[int], wall_ms: float,
                 status: str = "success",
                 label: Optional[str] = None) -> Dict[str, Any]:
    """The QueryEnd drain: collect this thread's query's spans, export
    the per-query Chrome trace file (trace.dir), and return the rollup dict for the
    QueryEnd ``spans`` field.  Cheap no-op ({}) when tracing is off —
    faulted and fatal envelopes call it too, so their trace files are
    still well-formed."""
    if not _armed:
        return {}
    records, dropped = _drain(_owner_ident())
    roll = rollup(records, wall_ms, dropped)
    roll["status"] = status
    if _trace_dir and (records or qid is not None):
        global _seq
        with _seq_lock:
            _seq += 1
            seq = _seq
        sid = getattr(session, "session_id", "nosession")
        name = label or (f"q{qid}" if qid is not None else f"s{seq}")
        path = os.path.join(_trace_dir,
                            f"trace-{sid}-{name}-{seq}.json")
        try:
            from spark_rapids_tpu_torch.tools.traceview import write_trace
            write_trace(records, path, qid=qid, max_events=_max_events,
                        dropped=dropped, wall_ms=wall_ms, status=status)
            roll["traceFile"] = path
        except Exception:
            pass  # trace export must never fail the query
    try:
        session.last_span_stats = roll
    except Exception:
        pass
    return roll


