"""The serving layer of the PyTorch port (``serving/``) against the JAX
package's, on the CPU.

Admission (strict FIFO, byte weights, a heavy query admitted alone, the
queue-full and timeout rejections) decides the same in both packages.
The per-query memory and sync budgets take their ladders, and a rejected
``register`` leaves the catalog's bytes as they were.  Two concurrent
queries' events each carry their own query id, and after a query no
adoption registry holds an entry for its thread.  The fair interleaver
answers right and reports on each QueryEnd; a full admission queue
refuses a third query while the first is wedged and the second waits.
The session's builder, ``active()`` and ``set_conf`` behave as the
reference's.

Threads are ordered with events, barriers, the controllers' own
snapshots and explicitly disarmed delay rules; no test reads a clock.
"""

import threading

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.config import rapids_conf as jrc
from spark_rapids_tpu.robustness import faults as JFT
from spark_rapids_tpu.robustness import inject as JI
from spark_rapids_tpu.serving import admission as JA
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.config import rapids_conf as trc
from spark_rapids_tpu_torch.memory import retry as R
from spark_rapids_tpu_torch.robustness import faults as FT
from spark_rapids_tpu_torch.robustness import inject as I
from spark_rapids_tpu_torch.robustness import watchdog as W
from spark_rapids_tpu_torch.robustness.driver import recovery_metrics
from spark_rapids_tpu_torch.serving import admission as A
from spark_rapids_tpu_torch.serving import context as qc
from spark_rapids_tpu_torch.tools.eventlog import load_logs
from spark_rapids_tpu_torch.utils import hostsync


@pytest.fixture(autouse=True)
def _clean():
    I.clear()
    JI.clear()
    recovery_metrics.reset()
    with I.scoped_rules(), JI.scoped_rules():
        yield


def _wait_until(cond):
    """Spin (yielding) until ``cond()``: an order, not a time."""
    ev = threading.Event()
    while not cond():
        ev.wait(0.005)


# ------------------------------------------------------------- admission --
def _fifo_order(mod):
    ctrl = mod.AdmissionController(max_queries=1, hbm_bytes=1 << 20)
    first = ctrl.acquire()
    order, threads = [], []
    for i in range(3):
        def run(i=i):
            t = ctrl.acquire()
            order.append(i)
            ctrl.release(t)
        th = threading.Thread(target=run)
        th.start()
        threads.append(th)
        _wait_until(lambda i=i: ctrl.snapshot()["queued"] == i + 1)
    ctrl.release(first)
    for th in threads:
        th.join()
    return order, ctrl.snapshot()["totalAdmitted"]


def test_admission_is_strict_fifo():
    assert _fifo_order(A) == _fifo_order(JA) == ([0, 1, 2], 4)


def _byte_weights(mod):
    ctrl = mod.AdmissionController(max_queries=4, hbm_bytes=100)
    big = ctrl.acquire(60)
    got = {}

    def run(name, w):
        got[name] = ctrl.acquire(w)

    t50 = threading.Thread(target=run, args=("w50", 50))
    t50.start()
    _wait_until(lambda: ctrl.snapshot()["queued"] == 1)
    # a light query behind the head waits too: strict FIFO
    t30 = threading.Thread(target=run, args=("w30", 30))
    t30.start()
    _wait_until(lambda: ctrl.snapshot()["queued"] == 2)
    blocked = dict(ctrl.snapshot())
    ctrl.release(big)
    t50.join()
    t30.join()
    after = ctrl.snapshot()
    for t in got.values():
        ctrl.release(t)
    # a query heavier than the whole pool admits alone
    heavy = ctrl.acquire(500)
    alone = ctrl.snapshot()["active"]
    ctrl.release(heavy)
    return (blocked["active"], blocked["queued"], after["active"],
            after["admittedBytes"], alone)


def test_admission_byte_weights():
    assert _byte_weights(A) == _byte_weights(JA) == (1, 2, 2, 80, 1)


def _rejections(mod, faults):
    out = []
    ctrl = mod.AdmissionController(max_queries=1, hbm_bytes=1 << 20,
                                   max_queue=1)
    holder = ctrl.acquire()
    th = threading.Thread(target=lambda: ctrl.release(ctrl.acquire()))
    th.start()
    _wait_until(lambda: ctrl.snapshot()["queued"] == 1)
    with pytest.raises(faults.AdmissionFault) as err:
        ctrl.acquire()
    out.append(err.value.reason)
    ctrl.release(holder)
    th.join()
    timed = mod.AdmissionController(max_queries=1, hbm_bytes=1 << 20,
                                    timeout_ms=50)
    holder = timed.acquire()
    with pytest.raises(faults.AdmissionFault) as err:
        timed.acquire()
    out.append(err.value.reason)
    out.append(faults.classify(err.value).severity)
    timed.release(holder)
    return out, ctrl.snapshot()["totalRejected"]


def test_admission_typed_rejections():
    assert _rejections(A, FT) == _rejections(JA, JFT) == \
        (["queue-full", "timeout", "FATAL"], 1)


# ---------------------------------------------------------------- budgets --
def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    return ColumnarBatch.from_pydict({"a": rng.integers(0, 9, n),
                                      "b": rng.normal(size=n)})


def test_memory_budget_spills_own_batches_then_rejects(tmp_path):
    small = _batch(100, 1)
    size = ColumnarBatch.from_pydict({"a": np.zeros(100, np.int64),
                                      "b": np.zeros(100)})
    from spark_rapids_tpu_torch.memory.spill import batch_bytes
    unit = batch_bytes(size)
    s = TpuSession({"spark.rapids.tpu.serving.queryMemoryBudgetBytes":
                    int(unit * 1.5),
                    "spark.rapids.tpu.eventLog.dir": str(tmp_path)},
                   device="cpu")
    cat = s.memory_catalog
    with qc.QueryContext(s) as ctx:
        a = cat.register(small)
        b = cat.register(_batch(100, 2))
        # over budget: the owner's own coldest (a) moved to the host
        assert (a.tier, b.tier) == ("HOST", "DEVICE")
        assert cat.owner_device_bytes(ctx.owner_ident) == unit
        before = cat.stats()
        with pytest.raises(FT.BudgetExhaustedFault) as err:
            cat.register(_batch(400, 3))  # alone past the budget
        after = cat.stats()
        # b moved to the host to make room, and the rejected
        # registration did not stay behind
        assert b.tier == "HOST"
        assert after["device_bytes"] == before["device_bytes"] - unit
        assert after["num_handles"] == before["num_handles"]
        assert err.value.budget == "memory"
        assert [f["action"] for f in ctx.budget_events] == ["spill",
                                                            "reject"]
        pd.testing.assert_frame_equal(a.materialize().to_pandas(),
                                      small.to_pandas())
        a.close()
        b.close()
    assert cat.stats()["num_handles"] == 0
    assert cat.owner_device_bytes(ctx.owner_ident) == 0
    s.stop()
    (app,) = load_logs(str(tmp_path))
    assert [b["action"] for b in app.budget] == ["spill", "reject"]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_sync_budget_rejects_the_query(pkg):
    conf = {"spark.rapids.tpu.serving.syncBudget": 1}
    rng = np.random.default_rng(4)
    pdf = pd.DataFrame({"k": rng.integers(0, 50, 500),
                        "v": rng.normal(size=500)})
    if pkg == "jax":
        s, mod, faults = JaxSession(conf), JF, JFT
    else:
        s, mod, faults = TpuSession(conf, device="cpu"), F, FT
    df = s.create_dataframe(pdf).groupBy("k").agg(
        mod.sum(mod.col("v")).alias("s")).orderBy("k")
    with pytest.raises(faults.BudgetExhaustedFault) as err:
        df.to_pandas()
    assert err.value.budget == "syncs"
    assert s.recovery_log == []
    s.stop()


# -------------------------------------------------------- isolation --
def _q(mod, s, pdf):
    return s.create_dataframe(pdf).filter(mod.col("k") > 2).groupBy(
        "k").agg(mod.sum(mod.col("v")).alias("s"), mod.count(
            mod.col("v")).alias("n")).orderBy("k")


@pytest.fixture(scope="module")
def pdf():
    rng = np.random.default_rng(8)
    return pd.DataFrame({"k": rng.integers(0, 30, 3000),
                         "v": rng.normal(size=3000)})


def _starts(session):
    """Record (thread, queryId) of each QueryStart the session emits."""
    seen = []
    emit = session.events.emit

    def spy(event, **fields):
        if event == "QueryStart":
            seen.append((threading.get_ident(), fields["queryId"]))
        emit(event, **fields)
    session.events.emit = spy
    return seen


def test_concurrent_queries_keep_their_own_ids(tmp_path, pdf):
    """Query A wedges on a keyed delay rule while query B runs from
    start to end on another thread: each one's events carry its own id,
    and no registry keeps an entry for either thread afterwards."""
    s = TpuSession({"spark.rapids.tpu.eventLog.dir": str(tmp_path)},
                   device="cpu")
    want = _q(F, s, pdf).to_pandas()
    starts = _starts(s)
    results, idents = {}, {}

    def run(name):
        idents[name] = threading.get_ident()
        with I.scoped_rules(key=name):
            if name == "A":
                rules["A"] = I.inject("memory.oom", kind="delay",
                                      delay_s=None, count=1,
                                      all_threads=True)
                armed.set()
            results[name] = _q(F, s, pdf).to_pandas()

    rules, armed = {}, threading.Event()
    ta = threading.Thread(target=run, args=("A",))
    ta.start()
    armed.wait()
    _wait_until(lambda: rules["A"].fired == 1)  # A is wedged mid-query
    tb = threading.Thread(target=run, args=("B",))
    tb.start()
    tb.join()  # B ran start to end while A's envelope stayed open
    I.remove(rules["A"])
    ta.join()
    s.stop()
    for name in ("A", "B"):
        pd.testing.assert_frame_equal(results[name], want)
    by_thread = {}
    for ident, qid in starts:
        by_thread.setdefault(ident, []).append(qid)
    qa, qb = by_thread[idents["A"]], by_thread[idents["B"]]
    assert len(qa) == len(qb) == 1 and qa != qb
    (app,) = load_logs(str(tmp_path))
    ends = {q.query_id: q for q in app.queries}
    assert ends[qa[0]].status == ends[qb[0]].status == "success"
    assert ends[qb[0]].end_ts < ends[qa[0]].end_ts
    assert ends[qa[0]].start_ts < ends[qb[0]].start_ts
    # containment: nothing maps to either thread any more
    for ident in idents.values():
        assert ident not in qc._contexts
        for reg in (I._adopted, W._adopted, qc._adopted,
                    hostsync.host_sync_metrics._owner,
                    R.retry_metrics._owner):
            assert ident not in reg.values()
        assert ident not in s._qid_by_ident
        assert ident not in W._pending


def test_query_exit_purges_adoptions(pdf):
    s = TpuSession({}, device="cpu")
    me = threading.get_ident()
    _q(F, s, pdf).to_pandas()
    assert qc.current() is None and me not in qc._contexts
    for reg in (I._adopted, W._adopted, qc._adopted,
                hostsync.host_sync_metrics._owner, R.retry_metrics._owner):
        assert me not in reg.values()
    assert s._qid_by_ident == {}
    s.stop()


def test_interleaved_queries_answer_and_report(tmp_path, pdf):
    s = TpuSession({"spark.rapids.tpu.serving.interleave.enabled": True,
                    "spark.rapids.tpu.serving.concurrentQueries": 2,
                    "spark.rapids.tpu.eventLog.dir": str(tmp_path),
                    "spark.rapids.sql.tpu.maxBatchRows": 256}, device="cpu")
    want = _q(F, s, pdf).to_pandas()
    go = threading.Barrier(2)
    results = {}

    def run(i):
        go.wait()
        results[i] = _q(F, s, pdf).to_pandas()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    s.stop()
    for r in results.values():
        pd.testing.assert_frame_equal(r, want)
    (app,) = load_logs(str(tmp_path))
    assert len(app.queries) == 3
    for q in app.queries:
        info = q.sharing["interleave"]
        assert info["timeslices"] >= 1 and info["quantum"] >= 1
    assert s.interleaver.snapshot()["tickets"] == 0


def test_full_queue_refuses_while_slot_is_wedged(tmp_path, pdf):
    """concurrentQueries 1, maxQueuedQueries 1: A holds the slot wedged
    on its keyed delay rule, B queues, C is refused at arrival (FATAL, no
    recovery action, an AdmissionReject event); once the rule is
    disarmed A and B answer."""
    s = TpuSession({"spark.rapids.tpu.serving.concurrentQueries": 1,
                    "spark.rapids.tpu.serving.maxQueuedQueries": 1,
                    "spark.rapids.tpu.eventLog.dir": str(tmp_path)},
                   device="cpu")
    want = _q(F, s, pdf).to_pandas()
    rules, armed, results = {}, threading.Event(), {}

    def run(name):
        with I.scoped_rules(key=name):
            if name == "A":
                rules["A"] = I.inject("memory.oom", kind="delay",
                                      delay_s=None, count=1,
                                      all_threads=True)
                armed.set()
            results[name] = _q(F, s, pdf).to_pandas()

    ta = threading.Thread(target=run, args=("A",))
    ta.start()
    armed.wait()
    _wait_until(lambda: rules["A"].fired == 1)
    tb = threading.Thread(target=run, args=("B",))
    tb.start()
    _wait_until(lambda: s.admission.snapshot()["queued"] == 1)
    with pytest.raises(FT.AdmissionFault) as err:
        _q(F, s, pdf).to_pandas()
    assert err.value.reason == "queue-full"
    assert FT.classify(err.value).fatal
    I.remove(rules["A"])
    ta.join()
    tb.join()
    s.stop()
    for name in ("A", "B"):
        pd.testing.assert_frame_equal(results[name], want)
    assert s.recovery_log == [] and recovery_metrics.snapshot() == {}
    (app,) = load_logs(str(tmp_path))
    assert [r["reason"] for r in app.rejections] == ["queue-full"]
    assert [q.status for q in app.queries] == ["success"] * 3


# ---------------------------------------------------------- session api --
def test_builder_active_and_set_conf(tmp_path):
    """``builder().config(k, v).getOrCreate()``, ``active()`` and
    ``set_conf`` as the reference has them."""
    key = "spark.rapids.tpu.serving.concurrentQueries"
    out = {}
    for pkg, cls in (("jax", JaxSession), ("torch", TpuSession)):
        b = cls.builder().config(key, 2)
        if pkg == "torch":
            b = b.device("cpu")
        s = b.getOrCreate()
        first = (cls.active() is s, s.conf.settings[key],
                 s.admission.max_queries)
        s.set_conf("spark.rapids.tpu.eventLog.dir", str(tmp_path / pkg))
        assert s.events.enabled and s.events.path.startswith(
            str(tmp_path / pkg))
        s.set_conf("spark.rapids.sql.test.enabled", True)
        rc = jrc if pkg == "jax" else trc
        second = (s.overrides.conf.get(rc.TEST_ENABLED),)
        s.stop()
        out[pkg] = first + second + (cls._active is None,)
    assert out["torch"] == out["jax"] == (True, 2, 2, True, True)
    with pytest.raises(ValueError):
        TpuSession.builder().config("spark.rapids.no.such.key", 1) \
            .device("cpu").getOrCreate()
    assert torch.device("cpu") == TpuSession.builder().device(
        "cpu").getOrCreate().device
