"""Plan templates and prepared statements of the PyTorch port
(``plan/template.py``, ``api/prepared.py``, ``ops/expressions.ParamSlot``)
against the JAX package's, on the CPU.

The same seeded frames go through both packages: the same literals
hoist and the same ones are refused, with the same reasons and the same
``param_count``; a templated answer equals the reference's (float sums
within a relative 1e-12: the two packages add in different orders) and
the port's own un-templated run bit for bit.  The port has no ANSI cast,
so the ANSI refusal is held on the reference alone.
"""

import decimal

import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.columnar import dtypes as jdts
from spark_rapids_tpu.plan import template as jtemplate
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.ops.expressions import EmitContext, ParamSlot
from spark_rapids_tpu_torch.plan import template
from spark_rapids_tpu_torch.robustness import inject as I
from spark_rapids_tpu_torch.robustness.driver import recovery_metrics

TPL = {"spark.rapids.tpu.template.enabled": True}
TPL_CACHE = {"spark.rapids.tpu.template.enabled": True,
             "spark.rapids.tpu.serving.resultCache.enabled": True,
             "spark.rapids.tpu.template.resultCache.enabled": True}
REL = 1e-12


@pytest.fixture(autouse=True)
def _clean_registry():
    I.clear()
    recovery_metrics.reset()
    with I.scoped_rules():
        yield
    I.clear()


@pytest.fixture(scope="module")
def pdf():
    rng = np.random.default_rng(7)
    n = 4000
    return pd.DataFrame({
        "k": rng.integers(0, 16, n).astype(np.int64),
        "v": rng.normal(size=n),
        "q": rng.integers(1, 50, n).astype(np.float64),
    })


def _q6ish(F_, df, lo, hi):
    return (df.filter((F_.col("q") >= F_.lit(lo)) &
                      (F_.col("q") < F_.lit(hi)))
            .select((F_.col("v") * F_.col("q")).alias("rev"))
            .agg(F_.sum(F_.col("rev")).alias("revenue")))


def _sessions(conf):
    return TpuSession(dict(conf), device="cpu"), JaxSession(dict(conf))


def _stop(*sessions):
    for s in sessions:
        s.stop()


def test_hoist_shares_fingerprint_across_literals(pdf):
    s, js = _sessions(TPL)
    try:
        df, jdf = s.create_dataframe(pdf), js.create_dataframe(pdf)
        a = template.hoist_literals(_q6ish(F, df, 5.0, 20.0).plan)
        b = template.hoist_literals(_q6ish(F, df, 9.0, 33.0).plan)
        ja = jtemplate.hoist_literals(_q6ish(JF, jdf, 5.0, 20.0).plan)
        assert a.param_count == b.param_count == ja.param_count == 2
        assert a.fingerprint == b.fingerprint
        assert a.param_vector() != b.param_vector()
        assert a.param_vector() == ja.param_vector()
        assert a.values() == ja.values() == (5.0, 20.0)
        # the plans themselves stay apart
        assert template.plan_signature(_q6ish(F, df, 5.0, 20.0).plan) != \
            template.plan_signature(_q6ish(F, df, 9.0, 33.0).plan)
    finally:
        _stop(s, js)


def _refusal_cases(F_, D, df):
    return [
        (df.select(F_.lit(None, D.FLOAT64).alias("n"), F_.col("v")),
         template.REFUSE_NULL),
        (df.select(F_.lit("tag").alias("t"), F_.col("v")),
         template.REFUSE_STRING),
        (df.select(F_.lit(decimal.Decimal("1.50"),
                          D.DecimalType(4, 2)).alias("d"), F_.col("v")),
         template.REFUSE_DECIMAL),
        (df.select(F_.col("v") * F_.lit(2.0)), template.REFUSE_NAME),
        (df.limit(3), template.REFUSE_LIMIT),
        (df.orderBy(F_.col("v") * F_.lit(2.0)),
         template.REFUSE_POSITION),
    ]


@pytest.mark.parametrize("case", range(6))
def test_refusals_match_the_reference(pdf, case):
    s, js = _sessions(TPL)
    try:
        frame, reason = _refusal_cases(F, dts, s.create_dataframe(pdf))[case]
        jframe, jreason = _refusal_cases(JF, jdts,
                                         js.create_dataframe(pdf))[case]
        info = template.hoist_literals(frame.plan)
        jinfo = jtemplate.hoist_literals(jframe.plan)
        assert reason == jreason
        assert not info.hoisted and not jinfo.hoisted
        assert [r for r, _ in info.refusals] == \
            [r for r, _ in jinfo.refusals]
        assert reason in [r for r, _ in info.refusals]
        # the output names never change
        assert [n for n, _ in info.plan.schema] == \
            [n for n, _ in frame.plan.schema]
    finally:
        _stop(s, js)


def test_refused_literals_stay_in_the_fingerprint(pdf):
    s = TpuSession(dict(TPL), device="cpu")
    try:
        df = s.create_dataframe(pdf)
        d1 = template.hoist_literals(
            df.select(F.lit("x").alias("t")).plan).fingerprint
        d2 = template.hoist_literals(
            df.select(F.lit("y").alias("t")).plan).fingerprint
        assert d1 != d2
        assert template.plan_fingerprint(df.limit(3).plan) != \
            template.plan_fingerprint(df.limit(4).plan)
        # an aliased expression hoists where its unaliased form refuses
        assert template.hoist_literals(df.select(
            (F.col("v") * F.lit(2.0)).alias("x")).plan).hoisted
    finally:
        s.stop()


def test_ansi_refusal_in_the_reference():
    """The reference refuses a literal under an ANSI cast; the port has
    no ANSI cast, and its hoister refuses under any operation that
    carries ``ansi`` (the same rule)."""
    js = JaxSession(dict(TPL))
    try:
        jdf = js.create_dataframe(pd.DataFrame({"v": [1.0, 2.0]}))
        info = jtemplate.hoist_literals(jdf.select(
            (JF.col("v") + JF.lit(5.0)).cast("int", ansi=True)
            .alias("c")).plan)
        assert jtemplate.REFUSE_ANSI in [r for r, _ in info.refusals]
    finally:
        js.stop()
    h = template._Hoister()
    from spark_rapids_tpu_torch.ops.arithmetic import Add
    from spark_rapids_tpu_torch.ops.expressions import Literal
    e = Add(Literal(1.0), Literal(2.0))
    e.ansi = True
    assert h._hoist_expr(e) is e
    assert [r for r, _ in h.refusals] == [template.REFUSE_ANSI] * 2


@pytest.mark.parametrize("lo,hi", [(5.0, 20.0), (8.0, 30.0), (12.0, 49.0)])
def test_templated_answers_equal_inline_and_reference(pdf, lo, hi):
    s, js = _sessions(TPL)
    plain = TpuSession({}, device="cpu")
    try:
        got = _q6ish(F, s.create_dataframe(pdf), lo, hi).collect()[0][0]
        inline = _q6ish(F, plain.create_dataframe(pdf), lo,
                        hi).collect()[0][0]
        want = _q6ish(JF, js.create_dataframe(pdf), lo, hi).collect()[0][0]
        assert np.float64(got).tobytes() == np.float64(inline).tobytes()
        assert got == pytest.approx(want, rel=REL)
    finally:
        _stop(s, js, plain)


def test_templated_group_by_equals_inline(pdf):
    """A hoisted literal inside the aggregate's own filter and keys."""
    def q(F_, df, cut):
        return (df.filter(F_.col("q") > F_.lit(cut))
                .groupBy("k").agg(F_.sum(F_.col("v") * F_.lit(cut))
                                  .alias("s"), F_.count(F_.col("v"))
                                  .alias("n")).orderBy("k"))
    s, js = _sessions(TPL)
    plain = TpuSession({}, device="cpu")
    try:
        got = q(F, s.create_dataframe(pdf), 11.0).to_pandas()
        inline = q(F, plain.create_dataframe(pdf), 11.0).to_pandas()
        want = q(JF, js.create_dataframe(pdf), 11.0).to_pandas()
        pd.testing.assert_frame_equal(got, inline)
        np.testing.assert_array_equal(got.k, want.k)
        np.testing.assert_array_equal(got.n, want.n)
        np.testing.assert_allclose(got.s, want.s, rtol=REL)
    finally:
        _stop(s, js, plain)


def test_date_slots_bind_through_prepare():
    def frame(F_, D, s):
        dates = pd.to_datetime(
            ["2024-01-01", "2024-03-05", "2023-06-30", "2024-07-04"])
        df = s.create_dataframe(pd.DataFrame({
            "d": dates.date, "v": [1.0, 2.0, 3.0, 4.0]}))
        return (df.filter(F_.col("d") >= F_.lit("2024-01-01", D.DATE32))
                .agg(F_.sum(F_.col("v")).alias("sv")))
    s, js = _sessions(TPL)
    try:
        f, jf = frame(F, dts, s), frame(JF, jdts, js)
        info = template.hoist_literals(f.plan)
        assert info.param_count == 1 and info.slots[0].dtype.is_date
        assert f.collect() == jf.collect() == [(7.0,)]
        h, jh = s.prepare(f), js.prepare(jf)
        for day in ("2024-04-01", "2023-01-01"):
            assert h.run(p0=day) == jh.run(p0=day)
    finally:
        _stop(s, js)


def test_check_bindable_matches_the_reference():
    for value, dt, jdt in ((None, dts.FLOAT64, jdts.FLOAT64),
                           (1.5, dts.INT64, jdts.INT64),
                           (True, dts.INT64, jdts.INT64),
                           (1, dts.BOOL, jdts.BOOL),
                           ("x", dts.STRING, jdts.STRING)):
        with pytest.raises(TypeError):
            template.check_bindable(value, dt)
        with pytest.raises(TypeError):
            jtemplate.check_bindable(value, jdt)
    template.check_bindable(3, dts.INT32)
    template.check_bindable(7, dts.FLOAT64)
    template.check_bindable("2024-01-01", dts.DATE32)


def test_param_slot_refuses_unbound_emit():
    slot = ParamSlot(0, dts.FLOAT64)
    with pytest.raises(RuntimeError, match="unbound"):
        slot.emit(EmitContext([], 4, 4, "cpu"))
    slot.bind_value(2.5)
    got = slot.emit(EmitContext([], 4, 4, "cpu"))
    assert float(got.values) == 2.5


def test_prepare_requires_conf(pdf):
    s = TpuSession({}, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="template.enabled"):
            s.prepare(_q6ish(F, s.create_dataframe(pdf), 5.0, 20.0))
    finally:
        s.stop()


def test_prepared_bind_and_run_like_the_reference(pdf):
    s, js = _sessions(TPL)
    try:
        h = s.prepare(_q6ish(F, s.create_dataframe(pdf), 5.0, 20.0))
        jh = js.prepare(_q6ish(JF, js.create_dataframe(pdf), 5.0, 20.0))
        assert h.param_count == jh.param_count == 2 and not h.refusals
        assert "$p0" in h.describe()
        for args, kw in (((), {}), ((8.0, 30.0), {}), ((), {"p0": 12.0})):
            assert h.run(*args, **kw)[0][0] == \
                pytest.approx(jh.run(*args, **kw)[0][0], rel=REL)
        assert h.run_count == 3
        for args, kw, err in (((1.0,), {}, ValueError),
                              ((), {"p0": "x", "p1": 30.0}, TypeError),
                              ((), {"p7": 1.0}, TypeError),
                              ((), {"nope": 1.0}, TypeError)):
            with pytest.raises(err):
                h.run(*args, **kw)
    finally:
        _stop(s, js)


def test_prepared_repeats_plan_nothing(pdf, monkeypatch):
    """After prepare, runs call ``session.plan`` no more, and a repeated
    binding is a template-tier hit."""
    s = TpuSession(dict(TPL_CACHE), device="cpu")
    try:
        h = s.prepare(_q6ish(F, s.create_dataframe(pdf), 5.0, 20.0))
        calls = []
        real = s.plan
        monkeypatch.setattr(s, "plan", lambda *a, **k: (
            calls.append(1), real(*a, **k))[1])
        answers = {}
        for lo in (6.0, 7.0, 8.0, 6.0, 7.0):
            got = h.run_pandas(lo, 40.0).revenue[0]
            assert answers.setdefault(lo, got) == got
        assert calls == []
        snap = s.result_cache.snapshot()
        assert snap["templateHits"] == 2 and snap["templateStores"] == 3
    finally:
        s.stop()


def test_prepared_bindings_do_not_alias_in_the_exact_tier(pdf):
    """With the result cache on and the template tier off, a prepared
    handle's runs skip the exact tier: the handle's plan holds the
    literals of prepare time, so its exact key would serve every binding
    the first one's answer.  Each run equals the inline query bit for
    bit.  The JAX package keys the exact tier so, and answers a second
    binding with the first's result (a divergence kept on purpose)."""
    conf = {"spark.rapids.tpu.template.enabled": True,
            "spark.rapids.tpu.serving.resultCache.enabled": True}
    s, js = _sessions(conf)
    plain = TpuSession({}, device="cpu")
    try:
        h = s.prepare(_q6ish(F, s.create_dataframe(pdf), 5.0, 20.0))
        jh = js.prepare(_q6ish(JF, js.create_dataframe(pdf), 5.0, 20.0))
        df = plain.create_dataframe(pdf)
        los = (6.0, 9.0, 6.0)
        got = [h.run(lo, 40.0)[0][0] for lo in los]
        want = [_q6ish(F, df, lo, 40.0).collect()[0][0] for lo in los]
        assert got == want and got[0] != got[1]
        snap = s.result_cache.snapshot()
        assert snap["hits"] == 0 and snap["stores"] == 0
        jgot = [jh.run(lo, 40.0)[0][0] for lo in los[:2]]
        assert jgot[0] == pytest.approx(want[0], rel=REL)
        assert jgot[1] == jgot[0]
    finally:
        _stop(s, js, plain)


def test_template_tier_never_aliases_bindings(pdf):
    s, js = _sessions(TPL_CACHE)
    try:
        df = s.create_dataframe(pdf)
        r1 = _q6ish(F, df, 5.0, 20.0).collect()[0][0]
        r2 = _q6ish(F, df, 6.0, 20.0).collect()[0][0]
        assert r1 != r2
        snap = s.result_cache.snapshot()
        assert snap["templateHits"] == 0 and snap["templateStores"] == 2
        assert _q6ish(F, df, 5.0, 20.0).collect()[0][0] == r1
        assert s.result_cache.snapshot()["templateHits"] == 1
        jdf = js.create_dataframe(pdf)
        for lo in (5.0, 6.0, 5.0):
            _q6ish(JF, jdf, lo, 20.0).collect()
        assert js.result_cache.snapshot()["templateHits"] == 1
    finally:
        _stop(s, js)


def test_exact_tier_literal_digit_plans_never_alias(pdf):
    s = TpuSession({"spark.rapids.tpu.serving.resultCache.enabled": True},
                   device="cpu")
    try:
        df = s.create_dataframe(pdf)

        def q(mult):
            return (df.select((F.col("v") * F.lit(mult)).alias("x"))
                    .agg(F.sum(F.col("x")).alias("sx")))
        r2, r3 = q(2.0).collect()[0][0], q(3.0).collect()[0][0]
        assert r2 == pytest.approx(float(pdf.v.sum()) * 2.0, rel=1e-9)
        assert r3 == pytest.approx(float(pdf.v.sum()) * 3.0, rel=1e-9)
        assert s.result_cache.snapshot()["hits"] == 0
        assert q(2.0).collect()[0][0] == r2
        assert s.result_cache.snapshot()["hits"] == 1
    finally:
        s.stop()


def test_template_cache_corrupt_load_recomputes(pdf):
    s = TpuSession(dict(TPL_CACHE), device="cpu")
    try:
        df = s.create_dataframe(pdf)
        want = _q6ish(F, df, 5.0, 20.0).collect()[0][0]
        with I.injected("templatecache.load", kind="corrupt", count=1,
                        all_threads=True):
            assert _q6ish(F, df, 5.0, 20.0).collect()[0][0] == want
        snap = s.result_cache.snapshot()
        assert snap["invalidations"] >= 1 and snap["templateHits"] == 0
        assert _q6ish(F, df, 5.0, 20.0).collect()[0][0] == want
        assert s.result_cache.snapshot()["templateHits"] == 1
    finally:
        s.stop()


def test_template_off_stream_has_no_template(pdf, tmp_path):
    import glob
    import json
    s = TpuSession({"spark.rapids.tpu.eventLog.dir": str(tmp_path)},
                   device="cpu")
    try:
        _q6ish(F, s.create_dataframe(pdf), 5.0, 20.0).collect()
    finally:
        s.stop()
    (path,) = glob.glob(str(tmp_path / "*.jsonl"))
    with open(path) as f:
        records = [json.loads(x) for x in f]
    ends = [r for r in records if r["event"] == "QueryEnd"]
    assert ends and all("sharing" not in r for r in ends)


def test_template_plan_runs_on_the_cpu_rung(pdf):
    s = TpuSession(dict(TPL), device="cpu")
    try:
        info = template.hoist_literals(
            _q6ish(F, s.create_dataframe(pdf), 5.0, 20.0).plan)
        for lo, hi in ((5.0, 20.0), (9.0, 30.0)):
            info.bind((lo, hi))
            [batch] = list(s.plan_cpu_only(info.plan).execute())
            sub = pdf[(pdf.q >= lo) & (pdf.q < hi)]
            got = float(batch.columns["revenue"].data[0])
            assert got == pytest.approx(float((sub.v * sub.q).sum()),
                                        rel=1e-9)
    finally:
        s.stop()


def test_prepared_survives_a_recovery_redrive(pdf, tmp_path):
    path = str(tmp_path / "fact.parquet")
    pdf.to_parquet(path, index=False)
    conf = dict(TPL, **{"spark.rapids.sql.recovery.backoffMs": 1})
    s = TpuSession(conf, device="cpu")
    try:
        h = s.prepare(_q6ish(F, s.read.parquet(path), 5.0, 20.0))
        h.run()
        s.recovery_log.clear()
        with I.injected("io.read", count=1, all_threads=True) as rule:
            got = h.run(7.0, 30.0)[0][0]
            assert rule.fired == 1
        sub = pdf[(pdf.q >= 7.0) & (pdf.q < 30.0)]
        assert got == pytest.approx(float((sub.v * sub.q).sum()), rel=1e-9)
        assert [r["action"] for r in s.recovery_log] == ["retry"]
    finally:
        s.stop()


def test_template_on_a_sharded_session_runs_on_one_device(pdf):
    s = TpuSession(dict(TPL, **{
        "spark.rapids.sql.distributed.numShards": 8}), device="cpu")
    try:
        got = _q6ish(F, s.create_dataframe(pdf), 5.0, 20.0).collect()
        assert s.last_dist_explain.startswith("template:")
        plain = TpuSession({}, device="cpu")
        try:
            want = _q6ish(F, plain.create_dataframe(pdf), 5.0,
                          20.0).collect()
        finally:
            plain.stop()
        assert got == want
    finally:
        s.stop()
