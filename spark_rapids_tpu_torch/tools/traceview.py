"""Chrome-trace-event export + validation for the span runtime
(counterpart of ``spark_rapids_tpu/tools/traceview.py``).

One file per query under ``spark.rapids.tpu.trace.dir``
(utils/tracing.py drains into :func:`write_trace` at QueryEnd).  The
format is the Chrome Trace Event JSON Object Format — open a file at
``ui.perfetto.dev`` (or chrome://tracing) and the query's operators,
exchanges, spills, and compiles render as nested slices per thread,
with the async exchange in-flight windows on their own track.

``validate_chrome_trace`` is the pure-python schema check the tests and
the premerge smoke gate on: no jsonschema dependency, just the format
contract (https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU).

CLI:  python -m spark_rapids_tpu_torch.tools.traceview TRACE.json
      validates the file and prints the top exclusive-time slices.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict
from typing import Any, Dict, List, Optional

# the synthetic tid async in-flight windows render on (their wall time
# overlaps the dispatching thread's slices; Perfetto wants them on
# their own track)
ASYNC_TID = 1


def to_chrome_trace(records: List[tuple], qid: Optional[int] = None,
                    max_events: Optional[int] = None, dropped: int = 0,
                    wall_ms: float = 0.0,
                    status: str = "success") -> Dict[str, Any]:
    """Records (utils/tracing.py tuples) -> Chrome trace JSON object.

    Truncation contract: at most ``max_events`` "X" slices are
    emitted; anything beyond (plus buffer-side drops) is announced by
    an explicit ``trace-truncated`` instant event AND a top-level
    ``truncated`` count — a bounded trace must never silently read as
    a complete one."""
    from spark_rapids_tpu_torch.utils import tracing as T
    pid = os.getpid()
    truncated = int(dropped)
    if max_events is not None and len(records) > max_events:
        truncated += len(records) - max_events
        records = records[:max_events]
    t0 = min((r[T.R_T0] for r in records), default=0)
    events: List[Dict[str, Any]] = []
    tids = {}
    for r in records:
        tid = ASYNC_TID if r[T.R_ASYNC] else r[T.R_TID]
        if not r[T.R_ASYNC]:
            tids.setdefault(tid, None)
        args: Dict[str, Any] = {}
        if r[T.R_OP]:
            args["op"] = r[T.R_OP]
        if r[T.R_SITE] is not None:
            site = r[T.R_SITE]
            args["site"] = site if isinstance(site, str) \
                else T.site_id(site)
        events.append({
            "name": r[T.R_OP] or r[T.R_POINT],
            "cat": T.phase_of(r[T.R_POINT]) if not r[T.R_ASYNC]
            else "async",
            "ph": "X",
            "ts": (r[T.R_T0] - t0) / 1e3,   # microseconds
            "dur": r[T.R_DUR] / 1e3,
            "pid": pid,
            "tid": tid,
            "args": args or {"point": r[T.R_POINT]},
        })
    meta: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": "spark-rapids-tpu-torch" +
                         (f" q{qid}" if qid is not None else "")}}]
    for tid in sorted(tids):
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": f"thread-{tid}"}})
    meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                 "tid": ASYNC_TID,
                 "args": {"name": "async-exchange"}})
    if truncated:
        meta.append({"name": "trace-truncated", "ph": "i", "s": "g",
                     "ts": 0.0, "pid": pid, "tid": 0,
                     "args": {"dropped": truncated}})
    return {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {"queryId": qid, "status": status,
                      "wallMs": round(wall_ms, 3)},
        "truncated": truncated,
    }


def write_trace(records: List[tuple], path: str,
                qid: Optional[int] = None,
                max_events: Optional[int] = None, dropped: int = 0,
                wall_ms: float = 0.0, status: str = "success") -> str:
    obj = to_chrome_trace(records, qid=qid, max_events=max_events,
                          dropped=dropped, wall_ms=wall_ms,
                          status=status)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(obj, f)
    os.replace(tmp, path)
    return path


_VALID_PH = frozenset("BEXiIMCbnePFSTfsNODv(){}")


def validate_chrome_trace(obj: Any) -> List[str]:
    """Schema check against the Chrome trace-event object format.
    Returns a list of problems (empty = valid)."""
    problems: List[str] = []
    if not isinstance(obj, dict):
        return [f"top level must be an object, got {type(obj).__name__}"]
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents must be a list"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: event must be an object")
            continue
        ph = ev.get("ph")
        if not isinstance(ph, str) or ph not in _VALID_PH:
            problems.append(f"{where}: bad phase {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            problems.append(f"{where}: missing/empty name")
        for key in ("pid", "tid"):
            if key in ev and not isinstance(ev[key], int):
                problems.append(f"{where}: {key} must be an int")
        if ph in ("X", "B", "E", "i", "I"):
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                problems.append(f"{where}: ts must be a number >= 0")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: X event needs dur >= 0")
        if "args" in ev and not isinstance(ev["args"], dict):
            problems.append(f"{where}: args must be an object")
    begins = sum(1 for e in events
                 if isinstance(e, dict) and e.get("ph") == "B")
    ends = sum(1 for e in events
               if isinstance(e, dict) and e.get("ph") == "E")
    if begins != ends:
        problems.append(f"unbalanced B/E events ({begins} vs {ends})")
    return problems


def load_trace(path: str) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def summarize(obj: Dict[str, Any], top: int = 12) -> str:
    """Top slices by total duration per name — the quick look before
    opening Perfetto."""
    totals: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    n = 0
    for ev in obj.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        n += 1
        totals[ev.get("name", "?")] += ev.get("dur", 0.0)
        counts[ev.get("name", "?")] += 1
    lines = [f"slices: {n}, truncated: {obj.get('truncated', 0)}, "
             f"query: {obj.get('otherData', {}).get('queryId')}"]
    lines.append(f"{'name':40s} {'total_ms':>10s} {'count':>7s}")
    for name in sorted(totals, key=lambda k: -totals[k])[:top]:
        lines.append(f"{name:40s} {totals[name] / 1e3:10.2f} "
                     f"{counts[name]:7d}")
    return "\n".join(lines)


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="spark_rapids_tpu_torch.tools.traceview", description=__doc__)
    ap.add_argument("trace", help="exported trace JSON file")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    try:
        obj = load_trace(args.trace)
    except (OSError, json.JSONDecodeError) as e:
        print(f"cannot load {args.trace}: {e}", file=sys.stderr)
        return 1
    problems = validate_chrome_trace(obj)
    if problems:
        for p in problems:
            print(f"INVALID: {p}", file=sys.stderr)
        return 1
    print(summarize(obj, args.top))
    print("trace OK (load it at ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
