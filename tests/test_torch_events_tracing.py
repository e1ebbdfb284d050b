"""The event log (``utils/events.py``), span tracing
(``utils/tracing.py``, ``tools/traceview.py``) and the event-log parser
(``tools/eventlog.py``) of the PyTorch port, against the JAX package's,
on the CPU.

Both packages' event logs of the same three TPC-H queries hold the same
events with the same key sets per event, and parse into the same
QueryStart/QueryEnd pairs.  Tracing on gives the same answers, bit for
bit, as tracing off; the span rollups name the reference's points (less
``jit.trace``: the port compiles nothing while a query runs), each
query's Chrome trace file validates, and exclusive times add up to the
enclosing span's duration.
"""

import glob
import json
import os
import threading

import pytest

from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.models import tpch as jtpch
from spark_rapids_tpu.tools import eventlog as jeventlog
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.models import tpch
from spark_rapids_tpu_torch.tools import eventlog
from spark_rapids_tpu_torch.tools.traceview import (
    load_trace, validate_chrome_trace)
from spark_rapids_tpu_torch.utils import tracing
from spark_rapids_tpu_torch.utils.events import EventLogger

QUERIES = ("q1", "q3", "q6")


@pytest.fixture(scope="module")
def data():
    return jtpch.gen_tables(sf=0.002)


def _run(pkg, data, root, trace=True):
    conf = {"spark.rapids.tpu.eventLog.dir": os.path.join(root, "events")}
    if trace:
        conf["spark.rapids.tpu.trace.dir"] = os.path.join(root, "traces")
    if pkg == "jax":
        s, mod = JaxSession(conf), jtpch
    else:
        s, mod = TpuSession(conf, device="cpu"), tpch
    t = mod.load(s, data)
    answers = {q: mod.QUERIES[q](t).to_pandas() for q in QUERIES}
    s.stop()
    (path,) = glob.glob(os.path.join(root, "events", "*.jsonl"))
    with open(path) as f:
        records = [json.loads(line) for line in f]
    return answers, records, path


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    out = {}
    for pkg in ("jax", "torch"):
        out[pkg] = _run(pkg, data, str(tmp_path_factory.mktemp(pkg)))
    yield out
    tracing.configure(False)


def test_event_logs_read_alike(runs):
    shape = {}
    for pkg, (_, records, _) in runs.items():
        keys = {}
        for r in records:
            keys.setdefault(r["event"], set()).update(r)
        shape[pkg] = ([r["event"] for r in records], keys)
    assert shape["torch"] == shape["jax"]
    names = shape["torch"][0]
    assert names[0] == "SessionStart" and names[-1] == "SessionEnd"
    assert names.count("QueryStart") == names.count("QueryEnd") == 3


def _own_thread_ms(trace_path):
    """Per thread, the summed duration of its outermost spans from the
    query's ``admission.wait`` on: a thread's exclusive times add up to
    its outermost spans' durations, and those never overlap."""
    events = [e for e in load_trace(trace_path)["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") != "async"]
    start = min(e["ts"] for e in events if e["name"] == "admission.wait")
    per_thread = {}
    for e in sorted(events, key=lambda e: (e["ts"], -e["dur"])):
        if e["ts"] < start:
            continue
        total, end = per_thread.get(e["tid"], (0.0, -1.0))
        if e["ts"] >= end:
            total, end = total + e["dur"], e["ts"] + e["dur"]
        per_thread[e["tid"]] = (total, max(end, e["ts"] + e["dur"]))
    return {t: total / 1e3 for t, (total, _) in per_thread.items()}


def test_logs_parse_into_the_same_queries(runs):
    apps = {"torch": eventlog.parse_event_log(runs["torch"][2]),
            "jax": jeventlog.parse_event_log(runs["jax"][2])}
    for pkg, app in apps.items():
        assert [q.query_id for q in app.queries] == [1, 2, 3], pkg
        assert all(q.succeeded for q in app.queries), pkg
        assert len(app.admission) == 3 and app.recovery == [], pkg
        for q in app.queries:
            assert set(q.admission) == {"waitMs", "weightBytes"}
            assert q.spans["events"] > 0
            # each thread's spans lie in the query's admission wait and
            # its attempt's wall; 2e-3: three figures rounded to 1e-3 ms
            bound = q.spans["wallMs"] + q.admission["waitMs"] + 2e-3
            for tid, ms in _own_thread_ms(q.spans["traceFile"]).items():
                assert ms <= bound, (pkg, q.query_id, tid)
    # the port's rollup holds only its query's spans, on one thread at a
    # time (the pipeline worker while the consumer waits); the JAX
    # package's also holds spans its thread closed after the previous
    # query had ended (that query's to_arrow), so only its threads'
    # spans in the query's own window are bounded
    for q in apps["torch"].queries:
        assert q.spans["exclusiveMs"] <= \
            q.spans["wallMs"] + q.admission["waitMs"] + 2e-3
    t, j = apps["torch"], apps["jax"]
    # the plans' root operators (the two packages describe them apart)
    assert [q.logical_plan.split("[")[0] for q in t.queries] == \
        [q.logical_plan.split("[")[0] for q in j.queries]


def test_span_rollups_name_the_references_points(runs):
    points = {}
    for pkg, (_, records, _) in runs.items():
        points[pkg] = set()
        for r in records:
            if r["event"] == "QueryEnd":
                points[pkg] |= set(r["spans"]["points"])
    assert points["torch"] == points["jax"] - {"jit.trace"}
    assert {"operator.batch", "hostsync.fetch",
            "admission.wait"} <= points["torch"]


def test_tracing_keeps_answers_bit_for_bit(runs, data, tmp_path):
    off, records, _ = _run("torch", data, str(tmp_path), trace=False)
    assert all("traceFile" not in r.get("spans", {}) for r in records)
    on = runs["torch"][0]
    for q in QUERIES:
        assert on[q].equals(off[q]), q


def test_chrome_trace_files_validate(runs):
    _, records, _ = runs["torch"]
    ends = [r for r in records if r["event"] == "QueryEnd"]
    for r in ends:
        obj = load_trace(r["spans"]["traceFile"])
        assert validate_chrome_trace(obj) == []
        assert obj["otherData"]["queryId"] == r["queryId"]
        assert obj["truncated"] == 0
        names = {e["name"] for e in obj["traceEvents"] if e["ph"] == "X"}
        assert "admission.wait" in names


def test_exclusive_times_add_up():
    tracing.configure(True)
    try:
        with tracing.span("outer", op="A"):
            with tracing.span("inner"):
                pass
            with tracing.span("inner"):
                pass
        records, dropped = tracing._drain(threading.get_ident())
    finally:
        tracing.configure(False)
    outer = [r for r in records if r[tracing.R_POINT] == "outer"]
    inner = [r for r in records if r[tracing.R_POINT] == "inner"]
    assert dropped == 0 and len(outer) == 1 and len(inner) == 2
    o = outer[0]
    assert o[tracing.R_EXCL] + sum(r[tracing.R_DUR] for r in inner) == \
        o[tracing.R_DUR]
    roll = tracing.rollup(records, o[tracing.R_DUR] / 1e6)
    assert roll["points"]["inner"]["count"] == 2
    assert roll["operators"] == {"A": {
        "count": 1, "ms": round(o[tracing.R_DUR] / 1e6, 3),
        "exclusiveMs": round(o[tracing.R_EXCL] / 1e6, 3)}}


def test_spans_between_queries_join_no_query(data, tmp_path):
    """A span its thread closes while no query runs there (the previous
    query's ``to_arrow`` fetch, say) is not drained into the next
    query's rollup, which would put it outside that query's wall."""
    from spark_rapids_tpu_torch.serving.context import QueryContext
    s = TpuSession({"spark.rapids.tpu.trace.dir": str(tmp_path)},
                   device="cpu")
    try:
        tpch.load(s, data)["lineitem"].count()
        with tracing.span("between.queries"):
            pass
        with QueryContext(s):
            records, _ = tracing._drain(threading.get_ident())
    finally:
        s.stop()
        tracing.configure(False)
    assert records == []


def test_tracing_off_records_nothing():
    tracing.configure(False)
    assert tracing.span("x") is tracing._NOOP
    with tracing.span("x"):
        pass
    assert tracing._drain(threading.get_ident()) == ([], 0)


def test_event_logger_flushes_envelopes(tmp_path):
    ev = EventLogger(str(tmp_path), "abc", conf_snapshot={"k": 1},
                     flush_ms=60_000)
    ev.emit("Admission", waitMs=0.0)
    ev.emit("QueryEnd", queryId=1)   # always flushed
    with open(ev.path) as f:
        assert [json.loads(x)["event"] for x in f] == [
            "SessionStart", "Admission", "QueryEnd"]
    ev.close()
    ev.emit("Late")                   # closed: dropped
    with open(ev.path) as f:
        assert [json.loads(x)["event"] for x in f][-1] == "SessionEnd"
    assert not EventLogger(None, "x").enabled
