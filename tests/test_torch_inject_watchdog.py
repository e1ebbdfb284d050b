"""Fault injection (``robustness/inject.py``) and the watchdog
(``robustness/watchdog.py``) of the PyTorch port, against the JAX
package's, on the CPU.

The registry's points are the reference's, its count/skip/probability
rules replay the same, and scoped rules never leak.  A ``delay`` rule
wedges its caller until the watchdog trips the enclosing section's
deadline; the TimeoutFault is delivered at a cooperative checkpoint.
Through a query: the same delay rule in both packages gives a
TimeoutFault, then the ``retry`` rung, then the right answer, and the
WatchdogTrip event carries the query's id.  Threads are ordered with
events and explicit disarming, never timed; every deadline a test
relies on is at least ten times the work it bounds.
"""

import threading

import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.memory import retry as JR  # noqa: F401 - registers
from spark_rapids_tpu.robustness import inject as JI
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.memory import retry as R  # noqa: F401
from spark_rapids_tpu_torch.robustness import faults as FT
from spark_rapids_tpu_torch.robustness import inject as I
from spark_rapids_tpu_torch.robustness import watchdog as W
from spark_rapids_tpu_torch.tools.eventlog import load_logs


@pytest.fixture(autouse=True)
def _clean_registries():
    I.clear()
    JI.clear()
    W.watchdog_metrics.reset()
    with I.scoped_rules(), JI.scoped_rules():
        yield


def test_points_are_the_references():
    """Every point the port registers is one of the reference's (with
    the same default fault kind), and every point it wires is there.
    The reuse layer's points (``checkpoint.*``, ``resultcache.load``,
    ``templatecache.load``) register when their modules import, in both
    packages, and raise no fault of their own kind (None)."""
    import spark_rapids_tpu.robustness.checkpoint  # noqa: F401
    import spark_rapids_tpu.serving.reuse  # noqa: F401
    import spark_rapids_tpu_torch.serving.reuse  # noqa: F401
    ported = set(I.injection_points())
    assert ported <= set(JI.injection_points())
    assert ported >= {"io.read", "shuffle.exchange", "dist.host_sync",
                      "spill.disk", "spill.corrupt.host",
                      "spill.corrupt.disk", "udf.worker", "memory.oom",
                      "checkpoint.write", "checkpoint.restore",
                      "resultcache.load", "templatecache.load"}
    for p in ported:
        if p == "memory.oom":
            continue
        assert getattr(I._POINTS[p], "kind", None) == \
            getattr(JI._POINTS[p], "kind", None), p
    with pytest.raises(KeyError):
        I.inject("no.such.point")
    with pytest.raises(ValueError):
        I.inject("io.read", kind="explode")


def _hits(mod, **kw):
    hits = []
    with mod.injected("io.read", **kw) as rule:
        for i in range(60):
            try:
                mod.fire("io.read")
            except Exception as e:  # noqa: BLE001
                hits.append((i, e.kind, e.severity))
    return hits, rule.fired


@pytest.mark.parametrize("kw", [dict(count=2, skip=1),
                                dict(count=100, probability=0.5, seed=7)],
                         ids=["count_skip", "probability"])
def test_rules_replay_like_the_reference(kw):
    got, want = _hits(I, **kw), _hits(JI, **kw)
    assert got == want and got[1] > 0


def test_thread_scoped_rule_fires_only_on_its_thread():
    fired = {}
    with I.injected("io.read", count=5) as rule:
        def other():
            try:
                I.fire("io.read")
                fired["other"] = False
            except FT.InjectedReaderFault:
                fired["other"] = True
        t = threading.Thread(target=other)
        t.start()
        t.join()
        with pytest.raises(FT.InjectedReaderFault):
            I.fire("io.read")
    assert fired == {"other": False} and rule.fired == 1
    I.fire("io.read")  # disarmed on scope exit


def test_scoped_rules_remove_leaked_rules():
    outer = I.inject("io.read", count=5)
    with I.scoped_rules():
        I.inject("io.read", count=100, all_threads=True)
    assert I._rules == [outer]
    I.remove(outer)
    assert not I._armed


def test_corrupt_rule_flips_one_seeded_bit():
    a = np.arange(64, dtype=np.int64)
    with I.injected("spill.corrupt.host", kind="corrupt", seed=5):
        got = I.fire_mutate("spill.corrupt.host", a)
    with JI.injected("spill.corrupt.host", kind="corrupt", seed=5):
        want = JI.fire_mutate("spill.corrupt.host", a)
    diff = np.unpackbits((got ^ a).view(np.uint8))
    assert diff.sum() == 1 and np.array_equal(got, want)
    assert np.array_equal(a, np.arange(64))  # the original untouched


def test_delay_rule_trips_the_section_deadline():
    """A wedge until disarmed inside a 100 ms section: the monitor parks
    a TimeoutFault and the wedge's own checkpoint raises it."""
    with I.injected("io.read", kind="delay", delay_s=None) as rule:
        with pytest.raises(FT.TimeoutFault) as err:
            with W.section("io.reader", deadline_ms=100):
                I.fire("io.read")
    assert err.value.point == "io.reader" and rule.fired == 1
    snap = W.watchdog_metrics.snapshot()
    assert snap["trips"] == {"io.reader": 1}
    assert snap["cancels"] == {"io.reader": 1}
    W.checkpoint()  # one-shot: nothing left pending


def test_beating_section_does_not_trip():
    """A heartbeat section measures silence: beats keep it alive while
    the owner waits on another thread's progress (ordered by events)."""
    step = threading.Event()
    done = threading.Event()

    def worker():
        for _ in range(3):
            step.wait()
            step.clear()
        done.set()

    t = threading.Thread(target=worker)
    t.start()
    with W.section("pipeline.worker", deadline_ms=60_000) as sect:
        for _ in range(3):
            sect.beat()
            step.set()
            while step.is_set():
                W.checkpoint()
        done.wait()
    t.join()
    assert W.watchdog_metrics.snapshot()["trips"] == {}


def test_worker_adoption_delivers_to_the_owner():
    """A section opened on an adopted worker cancels the driving
    thread's token; the owner's checkpoint raises it."""
    owner = threading.get_ident()
    parked = threading.Event()

    def worker():
        W.adopt_thread(owner)
        try:
            with I.injected("io.read", kind="delay", delay_s=None,
                            all_threads=True):
                with W.section("io.reader", deadline_ms=100):
                    try:
                        I.fire("io.read")
                    except FT.TimeoutFault:
                        parked.set()
                        raise
        except FT.TimeoutFault:
            pass
        finally:
            W.release_thread()

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    # the worker's wedge took the token itself (it checkpoints as the
    # owner); the owner's token is clear afterwards
    assert parked.is_set()
    W.checkpoint()


def _q6_like(mod, df):
    return df.filter((mod.col("x") > 3) & (mod.col("x") < 90)).agg(
        mod.sum(mod.col("y") * mod.col("x")).alias("rev"))


def test_query_deadline_retries_in_both_packages(tmp_path):
    """TPC-H q6's shape with a delay rule (count 1, until disarmed) at
    the first guarded attempt, under a 2 s deadline budget (the query's
    work is milliseconds): a TimeoutFault, the retry rung, the right
    answer; in the port the WatchdogTrip event carries the query id."""
    rng = np.random.default_rng(9)
    pdf = pd.DataFrame({"x": rng.integers(0, 100, 4000),
                        "y": rng.normal(size=4000)})
    conf = {"spark.rapids.sql.recovery.backoffMs": 0,
            "spark.rapids.tpu.serving.deadlineBudgetMs": 2000}
    trails, answers = {}, {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            s, mod, reg = JaxSession(conf), JF, JI
        else:
            s = TpuSession(dict(conf, **{
                "spark.rapids.tpu.eventLog.dir": str(tmp_path)}),
                device="cpu")
            mod, reg = F, I
        df = _q6_like(mod, s.create_dataframe(pdf))
        want = df.to_pandas()
        s.recovery_log.clear()
        rule = reg.inject("memory.oom", kind="delay", delay_s=None, count=1)
        try:
            got = df.to_pandas()
        finally:
            reg.remove(rule)
        assert rule.fired == 1
        trails[pkg] = [(r["action"], r["fault"]) for r in s.recovery_log]
        answers[pkg] = (want, got)
        s.stop()
    assert trails["torch"] == trails["jax"] == [("retry", "timeout")]
    pd.testing.assert_frame_equal(*answers["torch"])
    np.testing.assert_allclose(answers["torch"][1]["rev"],
                               answers["jax"][1]["rev"], rtol=1e-12)
    (app,) = load_logs(str(tmp_path))
    tripped = [q for q in app.queries
               if any(w["kind"] == "trip" for w in q.watchdog)]
    assert len(tripped) == 1 and tripped[0].status.startswith(
        "failed: TimeoutFault")
    assert tripped[0].watchdog[0]["point"] == "query"
    assert [(r["action"], r["fault"]) for r in tripped[0].recovery] == \
        [("retry", "timeout")]


@pytest.mark.parametrize("key", [
    "spark.rapids.tpu.watchdog.calibration.floorMs",
    "spark.rapids.tpu.watchdog.calibration.ceilingMs",
    "spark.rapids.tpu.watchdog.calibration.marginFactor",
    "spark.rapids.tpu.watchdog.calibration.minSamples"])
def test_calibration_keys_wait_for_the_calibrator(key):
    """The JAX package's calibrated deadlines (robustness/grayfailure.py)
    are not ported, so the port rejects their keys instead of ignoring
    them."""
    from spark_rapids_tpu.config.rapids_conf import RapidsConf as JaxConf
    from spark_rapids_tpu_torch.config.rapids_conf import RapidsConf
    JaxConf({key: "8"})
    with pytest.raises(ValueError, match="unknown configuration key"):
        RapidsConf({key: "8"})
