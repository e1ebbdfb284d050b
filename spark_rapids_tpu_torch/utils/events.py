"""Query event log: JSON-lines records of plans, metrics and spill stats.

Counterpart of ``spark_rapids_tpu/utils/events.py``, with its event and
field names, so the event logs of the two packages read alike.  One file
per session in ``spark.rapids.tpu.eventLog.dir``; each line is one
event:

  {"event": "SessionStart", "ts": ..., "conf": {...}}
  {"event": "QueryStart",  "queryId": n, "logicalPlan": "...",
   "physicalPlan": "...", "explain": "..."}
  {"event": "QueryEnd",    "queryId": n, "durationMs": ..., "status": ...,
   "metrics": {...}, "spill": {...}, "retry": {...}, "admission": {...},
   "spans": {...}}

``tools/eventlog.py`` parses these files into per-session and per-query
records.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional


# events that always flush through to disk immediately, whatever
# flushMs says: the records a crash post-mortem cannot live without
_FLUSH_EVENTS = frozenset({"QueryEnd", "QueryFatal", "SessionEnd"})


class EventLogger:
    """Append-only JSON-lines writer; no-op when dir is empty.

    ``flush_ms`` (spark.rapids.tpu.eventLog.flushMs) batches flushes:
    lines still write() immediately (a crash loses at most the OS
    buffer tail), but the explicit flush() — which hot-path emitters
    like the watchdog monitor and spill integrity used to pay per
    line under the lock — is coalesced to one per window.  0 keeps
    flush-per-line; QueryEnd/QueryFatal/SessionEnd and close() always
    flush so the tail is durable at every envelope boundary."""

    def __init__(self, log_dir: Optional[str], session_id: str,
                 conf_snapshot: Optional[Dict[str, Any]] = None,
                 flush_ms: int = 0):
        self._lock = threading.Lock()
        self._fh = None
        self.flush_ms = max(int(flush_ms), 0)
        self._last_flush = 0.0
        self.path: Optional[str] = None
        if log_dir:
            import atexit
            os.makedirs(log_dir, exist_ok=True)
            self.path = os.path.join(log_dir,
                                     f"tpu-events-{session_id}.jsonl")
            self._fh = open(self.path, "a", encoding="utf-8")
            self.emit("SessionStart", conf=conf_snapshot or {},
                      sessionId=session_id)
            # sessions without an explicit stop() still close their log
            # (and emit SessionEnd) at interpreter shutdown
            atexit.register(self.close)

    @property
    def enabled(self) -> bool:
        return self._fh is not None

    def emit(self, event: str, **fields: Any) -> None:
        if self._fh is None:
            return
        rec = {"event": event, "ts": time.time()}
        rec.update(fields)
        line = json.dumps(rec, default=str)
        with self._lock:
            # re-check under the lock: the watchdog monitor thread may
            # emit concurrently with a close() on the session thread
            if self._fh is None:
                return
            self._fh.write(line + "\n")
            now = time.monotonic()
            if self.flush_ms == 0 or event in _FLUSH_EVENTS or \
                    (now - self._last_flush) * 1e3 >= self.flush_ms:
                self._fh.flush()
                self._last_flush = now

    def flush(self) -> None:
        """Force the buffered tail to disk (QueryEnd/close do this
        implicitly)."""
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                self._last_flush = time.monotonic()

    def close(self) -> None:
        if self._fh is not None:
            import atexit
            self.emit("SessionEnd")
            with self._lock:
                if self._fh is not None:
                    self._fh.close()
                    self._fh = None
            try:  # release the atexit pin so the logger can be GC'd
                atexit.unregister(self.close)
            except Exception:
                pass


def emit_on_session(event: str, session=None, **fields: Any) -> None:
    """Emit ``event`` on the given (or active) session's event log,
    stamped with the in-flight query id.  No-op without an enabled
    logger.  The one shared resolver for subsystems that emit from
    arbitrary threads (the watchdog monitor, spill integrity) — keeps
    the session lookup / torn-interpreter guard in one place."""
    if session is None:
        try:
            from spark_rapids_tpu_torch.api.session import TpuSession
            session = TpuSession._active
        except ImportError:  # torn-down interpreter only
            return
    ev = getattr(session, "events", None) if session is not None else None
    if ev is not None and ev.enabled:
        fields.setdefault("queryId",
                          getattr(session, "_current_qid", None))
        ev.emit(event, **fields)
