"""The PyTorch port's CPU fallback operator (``exec/fallback.py``) against
the JAX package's, on the CPU.

The cases of ``tests/test_fallback_streaming.py`` run through both
packages' ``CpuFallbackExec`` on the same numpy-seeded batches: per-row
nodes stream one child batch at a time, a limit stops pulling, the
aggregate folds chunks into partial states (null keys into one group), the
join streams its probe side, and the external sort (``SORT_RUN_ROWS``
patched down so its spilled runs and k-way merge run) orders as the
one-pass sort does, descending, with nulls per key, over strings, and
cleans its directory when the consumer stops early.  Then the session
cases of ``tests/test_dataframe.py`` (a disabled sort and join, strict
test mode), and the port's own: every expression of
``tests/test_torch_strings.py`` evaluated by the fallback against the JAX
package's device answer, the string casts against the JAX package's, and
the device boundary (one counted fetch per child batch, results on the
exec's device).

Tolerances: keys, counts, strings, dates and order exactly; float sums to
a relative 1e-12 (pandas adds in another order).
"""

import datetime

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.exec.basic import TpuScanExec as JScan
from spark_rapids_tpu.exec.fallback import CpuFallbackExec as JFallback
from spark_rapids_tpu.plan import logical as JL
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch as TBatch
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.exec.basic import TpuScanExec as TScan
from spark_rapids_tpu_torch.exec.fallback import CpuFallbackExec
from spark_rapids_tpu_torch.plan import logical as TL
from spark_rapids_tpu_torch.utils.hostsync import host_sync_metrics

from test_torch_strings import EXPRS, SPARK_ORACLE, _assert_same, _table

N_BATCHES = 5
BATCH_ROWS = 100
RTOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class SpyScan(TpuExec):
    """Counts the batches downstream pulled (port side)."""

    def __init__(self, batches, schema):
        super().__init__()
        self.inner = TScan(batches, schema, 1 << 22)
        self.pulled = 0

    @property
    def schema(self):
        return self.inner.schema

    def do_execute(self):
        for b in self.inner.execute():
            self.pulled += 1
            yield b


class Pkg:
    """One package's pieces, so a case builds the same plan in both."""

    def __init__(self, port: bool):
        self.port = port
        self.F = TF if port else JF
        self.L = TL if port else JL
        self.Batch = TBatch if port else JBatch

    def scan(self, batches, schema):
        return TScan(batches, schema, 1 << 22) if self.port else \
            JScan(batches, schema)

    def fallback(self, node, children):
        return CpuFallbackExec(node, children) if self.port else \
            JFallback(node, children)


PKGS = {"port": Pkg(True), "jax": Pkg(False)}


def make_batches(P, n_batches=N_BATCHES, rows=BATCH_ROWS):
    out = []
    for i in range(n_batches):
        a = np.arange(rows, dtype=np.int64) + i * rows
        g = (np.arange(rows) + i) % 7
        out.append(P.Batch.from_pydict({"a": a, "g": g.astype(np.int64)}))
    return out


def relation(P, batches):
    return P.L.InMemoryRelation(batches, batches[0].schema)


def to_pandas(exec_node):
    import pyarrow as pa
    tables = [b.to_arrow() for b in exec_node.execute()]
    return pa.concat_tables(tables).to_pandas()


def both(build):
    """``build(P)`` -> exec, run through both packages as pandas."""
    return to_pandas(build(PKGS["port"])), to_pandas(build(PKGS["jax"]))


def test_project_streams_one_batch_per_chunk():
    batches = make_batches(PKGS["port"])
    scan = SpyScan(batches, batches[0].schema)
    node = TL.Project([TF.col("a").expr], relation(PKGS["port"], batches))
    fb = CpuFallbackExec(node, [scan])
    sizes = [b.nrows for b in fb.execute()]
    # one output batch per input batch, each bounded by the input batch
    assert len(sizes) == N_BATCHES and max(sizes) <= BATCH_ROWS
    assert scan.pulled == N_BATCHES

    def build(P):
        b = make_batches(P)
        return P.fallback(P.L.Project([(P.F.col("a") * 3 - P.F.col("g"))
                                       .alias("x").expr], relation(P, b)),
                          [P.scan(b, b[0].schema)])
    got, want = both(build)
    pd.testing.assert_frame_equal(got, want)


def test_filter_streams_and_matches_oracle():
    def build(P):
        b = make_batches(P)
        return P.fallback(P.L.Filter((P.F.col("a") < 250).expr,
                                     relation(P, b)),
                          [P.scan(b, b[0].schema)])
    got, want = both(build)
    pd.testing.assert_frame_equal(got, want)
    assert got["a"].tolist() == list(range(250))


def test_limit_short_circuits_child_pull():
    batches = make_batches(PKGS["port"])
    scan = SpyScan(batches, batches[0].schema)
    node = TL.Limit(BATCH_ROWS + 10, relation(PKGS["port"], batches))
    got = to_pandas(CpuFallbackExec(node, [scan]))
    assert len(got) == BATCH_ROWS + 10
    # the limit is met inside batch 2 of 5: the rest are never pulled
    assert scan.pulled == 2


def _agg_frame(P, batches, group=True):
    F = P.F
    aggs = [F.sum("a").alias("s").expr, F.count("a").alias("c").expr,
            F.min("a").alias("lo").expr, F.max("a").alias("hi").expr,
            F.avg("a").alias("m").expr]
    node = P.L.Aggregate([F.col("g").expr] if group else [], aggs,
                         relation(P, batches))
    return P.fallback(node, [P.scan(batches, batches[0].schema)])


def test_aggregate_chunked_partials_match_oracle():
    batches = make_batches(PKGS["port"])
    scan = SpyScan(batches, batches[0].schema)
    fb = _agg_frame(PKGS["port"], batches)
    fb.children = (scan,)
    got = to_pandas(fb).sort_values("g", ignore_index=True)
    # every batch folded into partial states (no whole-input frame)
    assert scan.pulled == N_BATCHES
    want = to_pandas(_agg_frame(PKGS["jax"], make_batches(PKGS["jax"]))) \
        .sort_values("g", ignore_index=True)
    pd.testing.assert_frame_equal(got, want, check_dtype=False)
    df = pd.DataFrame({"a": np.arange(500), "g": [
        (j + i) % 7 for i in range(5) for j in range(100)]})
    oracle = df.groupby("g", as_index=False).agg(
        s=("a", "sum"), c=("a", "count"), lo=("a", "min"), hi=("a", "max"),
        m=("a", "mean"))
    pd.testing.assert_frame_equal(got, oracle, check_dtype=False)


def test_aggregate_global_empty_input_one_row():
    def build(P):
        schema = make_batches(P, 1)[0].schema
        node = P.L.Aggregate([], [P.F.count("a").alias("c").expr,
                                  P.F.sum("a").alias("s").expr],
                             P.L.InMemoryRelation([], schema))
        return P.fallback(node, [P.scan([], schema)])
    got, want = both(build)
    assert len(got) == 1 and int(got["c"].iloc[0]) == 0
    assert pd.isna(got["s"].iloc[0]) and pd.isna(want["s"].iloc[0])
    assert int(want["c"].iloc[0]) == 0


def test_join_probe_side_streams():
    batches = make_batches(PKGS["port"])
    left_scan = SpyScan(batches, batches[0].schema)

    def build(P, left=None):
        b = make_batches(P)
        dim = P.Batch.from_pydict({"g2": np.arange(7, dtype=np.int64),
                                   "name": [f"g{i}" for i in range(7)]})
        node = P.L.Join(relation(P, b),
                        P.L.InMemoryRelation([dim], dim.schema),
                        [P.F.col("g").expr], [P.F.col("g2").expr], "inner")
        return P.fallback(node, [left or P.scan(b, b[0].schema),
                                 P.scan([dim], dim.schema)])
    got = to_pandas(build(PKGS["port"], left_scan))
    assert len(got) == N_BATCHES * BATCH_ROWS  # every row matches
    assert left_scan.pulled == N_BATCHES
    want = to_pandas(build(PKGS["jax"]))
    pd.testing.assert_frame_equal(got, want)


def test_null_group_keys_merge_across_chunks():
    """Null group keys from different chunks land in ONE group."""
    def build(P):
        b1 = P.Batch.from_pydict({"g": [1, None], "a": [10, 1]})
        b2 = P.Batch.from_pydict({"g": [None, 1], "a": [2, 30]})
        node = P.L.Aggregate([P.F.col("g").expr],
                             [P.F.sum("a").alias("s").expr],
                             P.L.InMemoryRelation([b1, b2], b1.schema))
        return P.fallback(node, [P.scan([b1, b2], b1.schema)])
    for got in both(build):
        assert len(got) == 2  # group 1 and ONE null group
        bykey = {(None if pd.isna(k) else int(k)): int(v)
                 for k, v in zip(got["g"], got["s"])}
        assert bykey == {1: 40, None: 3}


def test_host_export_never_touches_device():
    """The port's boundary: each child batch leaves through one counted
    fetch, and the results are device batches of the node's types (a
    string column with offsets, a date as int32 days, nulls as
    validity) on the exec's device; floats come back bit for bit."""
    b = TBatch.from_pydict({"d": np.array([0.05, 0.06, 0.07]),
                            "s": ["x", None, "z"], "i": [1, None, 3],
                            "t": [datetime.date(2020, 1, 2), None,
                                  datetime.date(1969, 12, 31)]})
    node = TL.Project([TF.col(c).expr for c in ("d", "s", "i", "t")],
                      TL.InMemoryRelation([b, b], b.schema))
    fb = CpuFallbackExec(node, [TScan([b, b], b.schema, 1 << 22)],
                         torch.device("cpu"))
    before = host_sync_metrics.snapshot()
    out = list(fb.execute())
    assert host_sync_metrics.snapshot() - before == 2
    for batch in out:
        cols = batch.columns
        assert all(c.device == torch.device("cpu") for c in cols.values())
        assert cols["s"].offsets is not None
        assert cols["t"].data.dtype == torch.int32
        assert cols["t"].data.tolist()[0] == 18263
        assert cols["i"].validity.tolist() == [True, False, True]
        assert cols["d"].data.tolist() == [0.05, 0.06, 0.07]
    assert _vals(out[0].to_pandas()["s"]) == ["x", None, "z"]


def _fb_sort(P, data, orders_cols, descending=None, nulls_first=True,
             run_rows=None):
    batches = [P.Batch.from_pydict(d) for d in data]
    rel = P.L.InMemoryRelation(batches, batches[0].schema)
    descending = descending or [False] * len(orders_cols)
    if not isinstance(nulls_first, (list, tuple)):
        nulls_first = [nulls_first] * len(orders_cols)
    orders = [(P.F.col(c).expr.bind(rel.schema), d, nf)
              for c, d, nf in zip(orders_cols, descending, nulls_first)]
    fb = P.fallback(P.L.Sort(orders, rel),
                    [P.scan(batches, batches[0].schema)])
    if run_rows is not None:
        fb.SORT_RUN_ROWS = run_rows
    return to_pandas(fb)


def _sort_both(data, *args, **kw):
    return (_fb_sort(PKGS["port"], data, *args, **kw),
            _fb_sort(PKGS["jax"], data, *args, **kw))


def test_sort_external_merge_matches_in_memory():
    """Tiny sorted runs (the external merge) give the one-pass sort's
    order."""
    rng = np.random.default_rng(5)
    data = [{"a": rng.integers(0, 50, 97).astype(np.int64),
             "b": rng.normal(size=97)} for _ in range(6)]
    small, jax_small = _sort_both(data, ["a", "b"])
    ext, jax_ext = _sort_both(data, ["a", "b"], run_rows=100)
    pd.testing.assert_frame_equal(small, ext)
    pd.testing.assert_frame_equal(small, jax_small)
    pd.testing.assert_frame_equal(ext, jax_ext)
    assert small["a"].is_monotonic_increasing


def _vals(col):
    return [None if v is None or (not isinstance(v, str) and pd.isna(v))
            else v for v in col]


def test_sort_external_descending_with_nulls():
    data = [{"a": [3.0, None, 1.0]}, {"a": [None, 7.0, 2.0]},
            {"a": [5.0, 0.5, None]}]
    for got in _sort_both(data, ["a"], descending=[True],
                          nulls_first=False, run_rows=3):
        assert _vals(got["a"]) == [7.0, 5.0, 3.0, 2.0, 1.0, 0.5,
                                   None, None, None]
    for got in _sort_both(data, ["a"], descending=[True],
                          nulls_first=True, run_rows=3):
        assert _vals(got["a"]) == [None, None, None, 7.0, 5.0, 3.0,
                                   2.0, 1.0, 0.5]


def test_sort_external_strings():
    data = [{"s": ["pear", "apple", None]}, {"s": ["fig", None, "plum"]}]
    for got in _sort_both(data, ["s"], run_rows=2):
        assert _vals(got["s"]) == [None, None, "apple", "fig", "pear",
                                   "plum"]


def test_sort_external_cleans_tmpdir_on_early_stop(tmp_path, monkeypatch):
    """A consumer that stops early (GeneratorExit mid-merge) leaks no
    spilled run."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    rng = np.random.default_rng(9)
    batches = [TBatch.from_pydict(
        {"a": rng.integers(0, 50, 100).astype(np.int64)})
        for _ in range(5)]
    rel = TL.InMemoryRelation(batches, batches[0].schema)
    node = TL.Sort([(TF.col("a").expr.bind(rel.schema), False, True)], rel)
    fb = CpuFallbackExec(node, [TScan(batches, batches[0].schema, 1 << 22)])
    fb.SORT_RUN_ROWS = 100
    it = fb.execute()
    next(it)          # the first merged batch
    assert list(tmp_path.glob("tpu-fbsort-*"))
    it.close()        # the consumer stops early
    assert not list(tmp_path.glob("tpu-fbsort-*")), \
        list(tmp_path.iterdir())


def test_sort_external_per_key_null_position():
    """Primary key nulls last, secondary key nulls first, in the
    one-pass and the external-merge sort."""
    data = [{"a": [1.0, None, 1.0, 2.0], "b": [5.0, 1.0, None, None]},
            {"a": [2.0, 1.0, None, 2.0], "b": [3.0, 2.0, 9.0, 1.0]}]
    for rr in (None, 3):
        for got in _sort_both(data, ["a", "b"], nulls_first=[False, True],
                              run_rows=rr):
            rows = list(zip(_vals(got["a"]), _vals(got["b"])))
            assert rows == [(1.0, None), (1.0, 2.0), (1.0, 5.0),
                            (2.0, None), (2.0, 1.0), (2.0, 3.0),
                            (None, 1.0), (None, 9.0)], (rr, rows)


def test_fallback_first_last_keep_nulls():
    """The port has no first/last yet; its fallback's null handling of
    the aggregates it has, per group against the JAX package: a sum or
    min over only nulls is null, a count of them 0, and an integer sum
    past 2^53 stays exact (the JAX package's pandas frame turns the
    nullable column float)."""
    big = 1 << 60

    def build(P):
        b1 = P.Batch.from_pydict({"g": [1, 1, 2, 3],
                                  "v": [None, 10, None, big]})
        b2 = P.Batch.from_pydict({"g": [2, 1, 3], "v": [7, None, 3]})
        aggs = [P.F.sum("v").alias("s"), P.F.min("v").alias("lo"),
                P.F.count("v").alias("n"), P.F.avg("v").alias("m")]
        node = P.L.Aggregate([P.F.col("g").expr], [a.expr for a in aggs],
                             P.L.InMemoryRelation([b1, b2], b1.schema))
        return P.fallback(node, [P.scan([b1, b2], b1.schema)])
    got, want = both(build)
    got = got.sort_values("g", ignore_index=True)
    want = want.sort_values("g", ignore_index=True)
    assert got["s"].tolist()[:2] == [10, 7]
    assert int(got["s"][2]) == big + 3
    assert float(want["s"][2]) == float(big + 3)  # the reference: inexact
    for c in ("lo", "n"):
        assert got[c].tolist()[:2] == want[c].tolist()[:2]
    np.testing.assert_allclose(got["m"], want["m"], rtol=RTOL)


# ------------------------------------------------------ session cases --

def _sessions(conf):
    return TpuSession(conf, device="cpu"), JaxSession(conf)


def test_sort_fallback():
    port, jax = _sessions({"spark.rapids.sql.exec.Sort": "false"})
    pdf = pd.DataFrame({"a": [3, 1, 2], "b": ["x", "y", "z"]})
    df = port.create_dataframe(pdf).orderBy("a")
    assert df.explain().splitlines()[0] == "CpuFallbackExec[Sort]"
    out = df.to_pandas()
    assert out["a"].tolist() == [1, 2, 3]
    assert out["b"].tolist() == ["y", "z", "x"]
    pd.testing.assert_frame_equal(
        out, jax.create_dataframe(pdf).orderBy("a").to_pandas())
    jax.stop()


def test_join_fallback():
    port, jax = _sessions({"spark.rapids.sql.exec.Join": "false"})
    outs = []
    for s in (port, jax):
        left = s.create_dataframe({"k": [1, 2, 3, None],
                                   "l": ["a", "b", "c", "d"]})
        right = s.create_dataframe({"k": [2, 3, 4, None],
                                    "r": [20, 30, 40, 50]})
        joined = left.join(right, on="k")
        if s is port:
            assert joined.explain().splitlines()[0] == \
                "CpuFallbackExec[Join]"
        outs.append(joined.to_pandas().sort_values("k", ignore_index=True))
    out, want = outs
    # a null key matches nothing (Spark); the JAX package's fallback
    # (pandas merge) matches the two null keys, so only its other rows
    # are held against the port's
    assert out["k"].tolist() == [2, 3]
    assert out["r"].tolist() == [20, 30]
    assert want["k"].isna().sum() == 1
    pd.testing.assert_frame_equal(
        out, want[want["k"].notna()].reset_index(drop=True),
        check_dtype=False)
    jax.stop()


@pytest.mark.parametrize("how", ["inner", "left", "right", "full"])
@pytest.mark.parametrize("using", [False, True])
def test_join_types_fallback_match_device(how, using):
    """Every join type the fallback runs, on keys with nulls, equals the
    port's device join (Spark's semantics: a null key matches nothing;
    a USING key of a right or full join is the left's, else the
    right's)."""
    rng = np.random.default_rng(11)
    n, m = 120, 40
    lk = [None if i % 13 == 0 else int(v)
          for i, v in enumerate(rng.integers(0, 30, n))]
    rk = [None if i % 11 == 0 else int(v)
          for i, v in enumerate(rng.integers(0, 30, m))]
    left = {"k" if using else "lk": lk, "lv": rng.normal(size=n).round(3),
            "ls": [f"l{i % 7}" for i in range(n)]}
    right = {"k" if using else "rk": rk, "rv": rng.integers(-5, 5, m),
             "rs": [None if i % 3 else f"r{i}" for i in range(m)]}

    def run(conf):
        s = TpuSession(conf, device="cpu")
        l, r = s.create_dataframe(left), s.create_dataframe(right)
        df = l.join(r, on="k", how=how) if using else \
            l.join(r, on=TF.col("lk") == TF.col("rk"), how=how)
        return df.orderBy(*df.columns), s
    fb, fs = run({"spark.rapids.sql.exec.Join": "false"})
    assert "CpuFallbackExec[Join]" in fb.explain()
    dev, _ = run({})
    got, want = fb.to_pandas(), dev.to_pandas()
    assert len(got) > 0
    pd.testing.assert_frame_equal(got, want)


def test_strict_mode_raises():
    s = TpuSession({"spark.rapids.sql.test.enabled": True}, device="cpu")
    # a LIKE pattern with the _ wildcard falls back
    df = s.create_dataframe({"a": ["axb", "ab"]}).filter(
        TF.col("a").like("a_b"))
    with pytest.raises(RuntimeError, match="Filter fell back to CPU in "
                       "strict test mode: .*'a_b'"):
        df.collect()
    allowed = TpuSession({"spark.rapids.sql.test.enabled": True,
                          "spark.rapids.sql.test.allowedNonTpu": "Filter"},
                         device="cpu")
    df = allowed.create_dataframe({"a": ["axb", "ab"]}).filter(
        TF.col("a").like("a_b"))
    assert df.collect() == [("axb",)]


# ----------------------------------------- expressions through the fallback --

@pytest.fixture(scope="module")
def table():
    return _table(n=160)


@pytest.fixture(scope="module")
def jax_projections(table):
    """The JAX package's device answer of every expression, one query."""
    s = JaxSession({})
    df = s.create_dataframe(table)
    out = df.select(*[EXPRS[n](JF).alias(n) for n in EXPRS]).to_pandas()
    s.stop()
    return out


@pytest.mark.parametrize("name", list(EXPRS))
def test_fallback_expression_matches_jax_device(name, table,
                                                jax_projections):
    """The port's fallback evaluates each expression (its Project
    switched off) as the JAX package's device does, and as the port's
    own device does (for the one expression where the JAX device is not
    Spark's, as Python does)."""
    s = TpuSession({"spark.rapids.sql.exec.Project": "false"}, device="cpu")
    df = s.create_dataframe(table).select(EXPRS[name](TF).alias(name))
    assert df.explain().splitlines()[0] == "CpuFallbackExec[Project]"
    got = df.to_pandas()
    device = TpuSession({}, device="cpu").create_dataframe(table).select(
        EXPRS[name](TF).alias(name)).to_pandas()
    _assert_same(got, device)
    if name in SPARK_ORACLE:
        assert [None if pd.isna(v) else v for v in got[name]] == \
            SPARK_ORACLE[name](table)
        return
    _assert_same(got, jax_projections[[name]])


CAST_STRINGS = ["12", "-3", "+4", "1.5", "-0.25", "abc", "", " 7", "1e3",
                "2020-01-05", "2020-02-30", "1999-12-31 23:59:59",
                "2020-01-05T10:11:12.5", "2020-01-05 10:11:12.123456",
                "true", " Yes ", "F", "0", None, "99999999999999999",
                "日本"]
CASTS = {
    "string_int": ("s", "int"), "string_bigint": ("s", "bigint"),
    "string_double": ("s", "double"), "string_date": ("s", "date"),
    "string_timestamp": ("s", "timestamp"),
    "string_boolean": ("s", "boolean"), "int_string": ("i", "string"),
    "bool_string": ("b", "string"), "date_string": ("d", "string"),
    "timestamp_string": ("ts", "string"),
    "double_string": ("f", "string"),
}


# where Spark's non-ANSI rule is not the JAX package's device parse (it
# neither trims, nor reads a fraction into an integer, nor reads an
# exponent, and it wraps an int past its range): Spark's answers, the
# port's on the card and in the fallback (ROADMAP.md queue 3)
SPARK_CASTS = {
    "string_int": {" 7": 7, "1.5": 1, "-0.25": 0,
                   "99999999999999999": None},
    "string_bigint": {" 7": 7, "1.5": 1, "-0.25": 0},
    "string_double": {" 7": 7.0, "1e3": 1000.0},
}


@pytest.mark.parametrize("name", list(CASTS))
def test_string_casts_match_jax(name):
    """Casts to and from strings: on the card (a double to a string in
    the fallback, as the JAX package tags it) and in the fallback (the
    cast switched off), each equal to the JAX package's answer, Spark's
    where the JAX package departs from it (``SPARK_CASTS``)."""
    col, target = CASTS[name]
    n = len(CAST_STRINGS)
    rng = np.random.default_rng(3)
    data = {"s": CAST_STRINGS,
            "i": [None if k % 5 == 0 else int(v) for k, v in
                  enumerate(rng.integers(-10**12, 10**12, n))],
            "b": [None if k % 4 == 0 else bool(k % 2) for k in range(n)],
            "d": [None if k % 6 == 0 else datetime.date(1960, 1, 1) +
                  datetime.timedelta(days=int(v)) for k, v in
                  enumerate(rng.integers(0, 40000, n))],
            "f": [float(v) for v in rng.normal(size=n).round(3) * 100],
            "ts": [None if k % 7 == 0 else datetime.datetime(
                2001, 2, 3, 4, 5, 6, 0 if k % 2 else 500000)
                + datetime.timedelta(seconds=int(k) * 3607)
                for k in range(n)]}
    data["f"][1] = 3.0
    data["f"][2] = float("inf")

    def build(F, s):
        df = s.create_dataframe(data)
        return df.select(F.col(col).cast(target).alias("x"))
    on_card = build(TF, TpuSession({}, device="cpu"))
    assert (on_card.explain().splitlines()[0] ==
            "CpuFallbackExec[Project]") == (name == "double_string")
    got = on_card.to_pandas()
    off = build(TF, TpuSession({"spark.rapids.sql.expression.Cast":
                                "false"}, device="cpu"))
    assert off.explain().splitlines()[0] == "CpuFallbackExec[Project]"
    _assert_same(off.to_pandas(), got)
    if name == "timestamp_string":
        # Spark trims the fraction's trailing zeros; the JAX package's
        # device writes six digits, so Python holds the port's answer
        want = [None if t is None else t.strftime("%Y-%m-%d %H:%M:%S")
                + (f".{t.microsecond:06d}".rstrip("0") if t.microsecond
                   else "") for t in data["ts"]]
        assert [None if pd.isna(v) else v for v in got["x"]] == want
        return
    jax = JaxSession({})
    want = build(JF, jax).to_pandas()
    jax.stop()
    for text, value in SPARK_CASTS.get(name, {}).items():
        i = CAST_STRINGS.index(text)
        want.loc[i, "x"] = pd.NA if value is None else value
    _assert_same(got, want)
