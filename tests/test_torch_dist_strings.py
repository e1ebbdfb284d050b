"""Dictionary-encoded strings on the port's sharded path, against the JAX
package.

Unit level: the scan's codes and sorted dictionaries against the JAX
package's ``ordered_dict_encode`` (the card-side encoder, the host
encoder and the file scan's first-seen dictionary with its rank remap),
the literal code bounds of ``_lower_cmp`` and ``_lower_in``, and the
``DictLookup`` tables of LIKE, substring, startswith and CASE WHEN.

Query level: the JAX package's string cases of ``tests/test_dist_planner.
py`` through the port's session on ``LocalShards(8)`` (numShards=8 on the
CPU) against the JAX session on ``make_mesh(8)``, each asserting that
both ran distributed; an inner join with a residual condition; and the
fallbacks that stay.  Keys, codes, counts, strings and order must be
equal; float sums within 1e-12 relative.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.columnar import dtypes as jdts
from spark_rapids_tpu.columnar.column import Column as JaxColumn
from spark_rapids_tpu.ops import predicates as JP
from spark_rapids_tpu.ops.dictionary import ordered_dict_encode as jax_ode
from spark_rapids_tpu.ops.expressions import BoundReference as JRef
from spark_rapids_tpu.ops.expressions import Literal as JLit
from spark_rapids_tpu.parallel.dist_planner import ExprLowering as JLowering
from spark_rapids_tpu.parallel.mesh import make_mesh as jax_make_mesh
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.columnar import dtypes as tdts
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.ops import dictionary as D
from spark_rapids_tpu_torch.ops import predicates as TP
from spark_rapids_tpu_torch.ops.expressions import BoundReference as TRef
from spark_rapids_tpu_torch.ops.expressions import Literal as TLit
from spark_rapids_tpu_torch.parallel.dict_lowering import (
    DictLookup, ExprLowering)

NSHARDS = 8
RTOL = 1e-12
MESH_CONF = {"spark.rapids.sql.distributed.numShards": NSHARDS}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the host: one torch thread here."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# --------------------------------------------------------------- encoders --

def _strings(kind):
    rng = np.random.default_rng(11)
    if kind == "all_null":
        return [None] * 37
    words = ["ash", "", "birch", "cédre", "日本", "oak", "a", "ab", "b\x00",
             "zz"]
    if kind == "long":
        words = words + ["x" * 300, "x" * 299 + "y", "w" * 257]
    vals = [words[i] for i in rng.integers(0, len(words), 200)]
    return [None if i % 7 == 3 else v for i, v in enumerate(vals)]


def _port_column(values):
    import pyarrow as pa
    return ColumnarBatch.from_arrow(pa.table({"s": pa.array(
        values, type=pa.string())}), device="cpu").column("s")


def _sorted_dict(values):
    """The sorted dictionary of ``values`` (the scan's encoder)."""
    return D.encode_sorted(_port_column(list(values)), len(values))[1]


def _jax_codes(values):
    import pyarrow as pa
    col = JaxColumn.from_arrow(pa.array(values, type=pa.string()))
    codes, sorted_values = jax_ode(col)
    return np.asarray(codes)[: len(values)], list(sorted_values)


def _assert_codes(codes, d, values):
    want_codes, want_values = _jax_codes(values)
    valid = np.array([v is not None for v in values])
    got = codes.numpy()
    assert d.to_pylist() == want_values
    np.testing.assert_array_equal(got[valid], want_codes[valid])
    assert (got[~valid] == 0).all()  # a null row is code 0


@pytest.mark.parametrize("kind", ["mixed", "long", "all_null"])
def test_encode_sorted_matches_jax_ordered_dict_encode(kind, monkeypatch):
    """The in-memory scan's encoder: on the card (packed words) up to 256
    bytes, past that arrow on the host."""
    values = _strings(kind)
    calls = []
    real = D.ordered_dict_table
    monkeypatch.setattr(D, "ordered_dict_table",
                        lambda col: calls.append(1) or real(col))
    codes, d = D.encode_sorted(_port_column(values), len(values))
    assert bool(calls) == (kind == "long")
    _assert_codes(codes, d, values)


@pytest.mark.parametrize("kind", ["mixed", "long", "all_null"])
def test_host_ordered_dict_table_matches_jax(kind):
    values = _strings(kind)
    col = _port_column(values)
    codes, offs, chars = D.ordered_dict_table(D.host_strings(col,
                                                             len(values)))
    d = D.SortedDictionary.from_host(offs, chars, "cpu")
    _assert_codes(torch.from_numpy(codes), d, values)


@pytest.mark.parametrize("kind", ["mixed", "long", "all_null"])
def test_stable_dictionary_rank_remap_matches_jax(kind):
    """The file scan's encoder: first-seen codes shared over batches
    (shards), then the rank remap to sorted codes."""
    values = _strings(kind)
    sd = D.StableDictionary()
    parts = []
    for lo, hi in ((0, 50), (50, 51), (51, len(values))):
        chunk = values[lo:hi]
        parts.append(sd.encode(_port_column(chunk), len(chunk),
                               null_code=0))
    rank, d = sd.sorted("cpu")
    valid = torch.tensor([v is not None for v in values])
    codes = torch.cat(parts)
    codes = torch.where(valid, rank[codes] if len(rank) else codes, 0)
    _assert_codes(codes, d, values)


def test_positions_in_and_decode():
    a = _sorted_dict(["ash", "birch", "oak", "é"])
    b = _sorted_dict(["birch", "cedar", "é"])
    assert a.positions_in(b).tolist() == [-1, 0, -1, 2]
    assert a.positions_in(D.SortedDictionary.empty("cpu")).tolist() == \
        [-1] * 4
    out = a.decode(torch.tensor([3, 0, 1]), torch.tensor([True, False,
                                                           True]))
    assert out.validity.tolist() == [True, False, True]
    offs = out.offsets.tolist()
    assert bytes(out.values[offs[0]:offs[1]].tolist()).decode() == "é"
    assert bytes(out.values[offs[2]:offs[3]].tolist()).decode() == "birch"


# ---------------------------------------------------- literal code bounds --

DICT = ["ash", "birch", "cedar", "oak"]
CMPS = ["EqualTo", "LessThan", "LessThanOrEqual", "GreaterThan",
        "GreaterThanOrEqual"]
LITERALS = ["a", "birch", "bz", "cedar", "zzz"]  # below, equal, absent ...


def _lowerings():
    jl = JLowering({0: list(DICT)})
    tl = ExprLowering({0: _sorted_dict(DICT)},
                      "cpu")
    return jl, tl


def _shape(e):
    """(class, code literals) of a lowered comparison or IN."""
    return (type(e).__name__,
            [int(c.value) for c in e.children[1:]])


@pytest.mark.parametrize("flipped", [False, True])
@pytest.mark.parametrize("op", CMPS)
def test_lower_cmp_bounds_match_jax(op, flipped):
    jl, tl = _lowerings()
    for lit in LITERALS:
        jref, tref = JRef(0, jdts.STRING, name="s"), TRef(0, tdts.STRING,
                                                          name="s")
        ja, ta = (JLit(lit), jref) if flipped else (jref, JLit(lit))
        pa_, pb = (TLit(lit), tref) if flipped else (tref, TLit(lit))
        want = jl.lower(getattr(JP, op)(ja, ta))
        got = tl.lower(getattr(TP, op)(pa_, pb))
        assert _shape(got) == _shape(want), (op, flipped, lit)


def test_lower_in_matches_jax_with_absent_literals():
    jl, tl = _lowerings()
    for opts in (["oak", "ash", "nope"], ["nope", "zzz"], ["cedar"]):
        want = jl.lower(JP.In(JRef(0, jdts.STRING, name="s"),
                              [JLit(o) for o in opts]))
        got = tl.lower(TP.In(TRef(0, tdts.STRING, name="s"),
                             [TLit(o) for o in opts]))
        assert _shape(got) == _shape(want), opts


LOOKUPS = {
    "like": lambda F: F.col("s").like("%a%"),
    "substring": lambda F: F.substring(F.col("s"), 2, 2),
    "startswith": lambda F: F.col("s").startswith("b"),
    "case_when": lambda F: F.when(F.col("s") == "oak", 1)
    .when(F.col("s") < "c", 2).otherwise(3),
}


@pytest.mark.parametrize("name", list(LOOKUPS))
def test_dict_lookup_tables_match_jax(name):
    """The table over the K dictionary values (the port's entry K, a null
    input's result, has no JAX counterpart) and the re-encoded
    dictionary of a string result."""
    values = DICT + ["bay", "c"]
    jl = JLowering({0: sorted(values)})
    tl = ExprLowering({0: _sorted_dict(values)},
                      "cpu")
    want = jl._try_dict_lower(LOOKUPS[name](JF).expr.bind(
        [("s", jdts.STRING)]))
    got = tl._try_dict_lower(LOOKUPS[name](TF).expr.bind(
        [("s", tdts.STRING)]))
    assert isinstance(got, DictLookup)
    k = len(values)
    valid = np.asarray(want.lut_valid)
    got_valid = np.ones(k, bool) if got.valid is None else \
        got.valid[:k].numpy()
    np.testing.assert_array_equal(got_valid, valid)
    np.testing.assert_array_equal(got.values[:k].numpy()[valid],
                                  np.asarray(want.lut_values)[valid])
    if want.dict_values is not None:
        assert got.out_dict.to_pylist() == list(want.dict_values)
    else:
        assert got.out_dict is None


# ----------------------------------------------- queries on both packages --

@pytest.fixture(scope="module")
def frames():
    """The JAX package's ``tests/test_dist_planner.py`` frames."""
    rng = np.random.default_rng(7)
    n = 4000
    fact = pd.DataFrame({
        "k": rng.integers(0, 50, n),
        "k2": rng.integers(0, 5, n),
        "v": rng.uniform(-10, 10, n).round(3),
        "s": rng.choice(["ash", "birch", "cedar", "oak", None], n,
                        p=[0.3, 0.3, 0.2, 0.15, 0.05]),
    })
    fact.loc[rng.choice(n, 100, replace=False), "v"] = np.nan
    dim = pd.DataFrame({
        "k": np.arange(0, 60, 2),
        "w": np.arange(0, 60, 2) * 1.5,
        "tag": [f"t{i % 3}" for i in range(30)],
    })
    return fact, dim


def _both(build, *tables, conf=None):
    """``build(F, *dataframes)`` through the JAX session on make_mesh(8)
    and the port's on numShards=8; both must run distributed."""
    js = JaxSession(dict(conf or {}), mesh=jax_make_mesh(NSHARDS))
    try:
        want = build(JF, *[js.create_dataframe(t) for t in tables]) \
            .to_pandas()
        assert js.last_dist_explain == "distributed", js.last_dist_explain
    finally:
        js.stop()
    ts = TpuSession({**MESH_CONF, **(conf or {})}, device="cpu")
    got = build(TF, *[ts.create_dataframe(t) for t in tables]).to_pandas()
    assert ts.last_dist_explain == "distributed", ts.last_dist_explain
    return got, want


def _cmp(got, want, sort_by=None):
    assert list(got.columns) == list(want.columns)
    if sort_by:
        got = got.sort_values(sort_by, ignore_index=True, kind="mergesort")
        want = want.sort_values(sort_by, ignore_index=True,
                                kind="mergesort")
    assert len(got) == len(want)
    for c in got.columns:
        g, w = got[c], want[c]
        if g.dtype.kind == "f" or w.dtype.kind == "f":
            np.testing.assert_allclose(g.to_numpy(np.float64),
                                       w.to_numpy(np.float64), rtol=RTOL,
                                       atol=0, equal_nan=True)
        else:
            pd.testing.assert_series_equal(g.reset_index(drop=True),
                                           w.reset_index(drop=True),
                                           check_dtype=False)


def test_groupby_string_key(frames):
    got, want = _both(lambda F, f: f.groupBy("s").agg(
        F.sum("v").alias("sv"), F.count("v").alias("c"),
        F.avg("v").alias("av"), F.max("k").alias("mk")).orderBy("s"),
        frames[0])
    _cmp(got, want)


@pytest.mark.parametrize("cond", ["eq", "lt", "ge", "absent", "isin"])
def test_string_literal_filters(frames, cond):
    conds = {"eq": lambda F: F.col("s") == "birch",
             "lt": lambda F: F.col("s") < "cedar",
             "ge": lambda F: F.col("s") >= "oak",
             "absent": lambda F: F.col("s") == "no-such-value",
             "isin": lambda F: F.col("s").isin("ash", "oak", "nope")}
    got, want = _both(lambda F, f: f.filter(conds[cond](F)).agg(
        F.count("k").alias("n"), F.sum("v").alias("sv")), frames[0])
    _cmp(got, want)


def test_min_max_over_strings(frames):
    got, want = _both(lambda F, f: f.groupBy("k2").agg(
        F.min("s").alias("lo"), F.max("s").alias("hi")).orderBy("k2"),
        frames[0])
    _cmp(got, want)


def test_string_min_with_result_expression(frames):
    """A result expression (sum * 2) forces the projection after the
    aggregate; min(s)'s dictionary must survive it."""
    got, want = _both(lambda F, f: f.groupBy("k2").agg(
        F.min("s").alias("lo"), (F.sum("v") * 2).alias("s2")).orderBy("k2"),
        frames[0])
    _cmp(got, want)


def test_keyless_string_min_max(frames):
    """A keyless min/max over a string is one code on shard 0."""
    got, want = _both(lambda F, f: f.agg(F.min("s").alias("lo"),
                                         F.max("s").alias("hi")), frames[0])
    _cmp(got, want)


def test_string_function_dict_lowering(frames):
    """A string-valued function of one encoded column (a CASE over it
    here) re-encodes through a lookup and stays distributed."""
    got, want = _both(lambda F, f: f.select(
        F.when(F.col("s") < "c", "low").otherwise(F.col("s")).alias("u"))
        .groupBy("u").agg(F.count().alias("n")).orderBy("u"), frames[0])
    _cmp(got, want)


def test_like_filter_distributed(frames):
    got, want = _both(lambda F, f: f.filter(F.col("s").like("%a%"))
                      .groupBy("s").agg(F.count("k").alias("n"))
                      .orderBy("s"), frames[0])
    _cmp(got, want)


def test_substring_groupby_distributed(frames):
    got, want = _both(lambda F, f: f.groupBy(
        F.substring(F.col("s"), 1, 1).alias("initial"))
        .agg(F.count("k").alias("n"), F.min("s").alias("lo"))
        .orderBy("initial"), frames[0])
    _cmp(got, want)


def test_string_join_key_distributes(frames):
    fact, dim = frames
    dim2 = dim.assign(s=np.where(np.arange(len(dim)) % 2 == 0, "ash",
                                 "oak"))
    got, want = _both(lambda F, f, d: f.join(d.select("s", "w"), "s"),
                      fact, dim2)
    _cmp(got, want, sort_by=["k", "v", "w"])


def test_string_join_keys_distributed(frames):
    lookup = pd.DataFrame({"s": ["ash", "cedar", "oak", "pine"],
                           "grp": ["soft", "soft", "hard", "soft"]})
    got, want = _both(lambda F, f, d: f.join(d, "s").groupBy("grp").agg(
        F.sum("v").alias("sv"), F.count("v").alias("n")),
        frames[0], lookup)
    _cmp(got, want, sort_by=["grp"])


@pytest.mark.parametrize("how", ["left", "semi", "anti"])
def test_string_join_types_distributed(frames, how):
    lookup = pd.DataFrame({"s": ["birch", "oak"], "w": [1.5, 2.5]})
    hows = {"semi": "left_semi", "anti": "left_anti"}.get(how, how)
    got, want = _both(lambda F, f, d: f.join(d, "s", how=hows)
                      .groupBy("k2").agg(F.count("v").alias("n")),
                      frames[0], lookup)
    _cmp(got, want, sort_by=["k2"])


def test_string_join_empty_build_dictionary(frames):
    """Probe codes remap into an empty build dictionary: every build key
    is null, nothing matches, the left join keeps every row."""
    lookup = pd.DataFrame({"s": pd.Series([None, None], dtype="string"),
                           "w": [1.5, 2.5]})
    got, want = _both(lambda F, f, d: f.join(d, "s", how="left")
                      .groupBy("k2").agg(F.count("w").alias("n"),
                                         F.count("k").alias("rows")),
                      frames[0], lookup)
    _cmp(got, want, sort_by=["k2"])


def test_inner_join_with_residual_condition(frames):
    """An inner equi-join with a residual over both sides, one of them a
    string comparison, filters after the match on the shard group."""
    fact, dim = frames

    def build(F, f, d):
        return f.join(d, on=(F.col("k") == F.col("dk"))
                      & (F.col("v") < F.col("w") / 10)
                      & (F.col("s") > "b")).select("k", "v", "s", "tag")

    ts = TpuSession(MESH_CONF, device="cpu")
    d = dim.rename(columns={"k": "dk"})
    got = build(TF, ts.create_dataframe(fact), ts.create_dataframe(d)) \
        .to_pandas()
    assert ts.last_dist_explain == "distributed"
    single = TpuSession({}, device="cpu")
    want = build(TF, single.create_dataframe(fact),
                 single.create_dataframe(d)).to_pandas()
    _cmp(got, want, sort_by=["k", "v", "s"])


def test_full_outer_using_string_keys_falls_back(frames):
    lookup = pd.DataFrame({"s": ["birch", "pine"], "w": [1.5, 2.5]})
    ts = TpuSession(MESH_CONF, device="cpu")
    got = ts.create_dataframe(frames[0]).join(
        ts.create_dataframe(lookup), "s", how="full").to_pandas()
    assert ts.last_dist_explain == (
        "fallback: full-outer USING join over string keys would coalesce "
        "codes from two dictionaries")
    single = TpuSession({}, device="cpu")
    want = single.create_dataframe(frames[0]).join(
        single.create_dataframe(lookup), "s", how="full").to_pandas()
    _cmp(got, want, sort_by=["s", "k", "v"])


def test_null_aware_lookup_keeps_single_device_answer():
    """``coalesce(s, 'none')`` is not null-propagating: its lookup's null
    entry gives 'none' for null rows, as on one device."""
    data = {"s": ["b", None, "a", None, "b"] * 7, "v": np.arange(35.0)}

    def build(F, df):
        return df.groupBy(F.coalesce(F.col("s"), F.lit("none"))
                          .alias("c")).agg(F.sum("v").alias("sv")) \
            .orderBy("c")
    ts = TpuSession(MESH_CONF, device="cpu")
    got = build(TF, ts.create_dataframe(data)).to_pandas()
    assert ts.last_dist_explain == "distributed"
    want = build(TF, TpuSession({}, device="cpu").create_dataframe(data)) \
        .to_pandas()
    _cmp(got, want)
    assert got["c"].tolist() == ["a", "b", "none"]


def test_count_over_strings_falls_back_with_reason(frames):
    """Only min and max run over codes; any other aggregate over a string
    falls back, naming itself."""
    ts = TpuSession(MESH_CONF, device="cpu")
    got = ts.create_dataframe(frames[0]).groupBy("k2").agg(
        TF.count("s").alias("n")).orderBy("k2").to_pandas()
    assert ts.last_dist_explain.startswith(
        "fallback: aggregate count over strings")
    want = TpuSession({}, device="cpu").create_dataframe(frames[0]) \
        .groupBy("k2").agg(TF.count("s").alias("n")).orderBy("k2") \
        .to_pandas()
    _cmp(got, want)


def test_null_aware_case_matches_jax_single_device():
    """``CASE WHEN s IS NULL THEN 'none' ELSE s END`` over one string
    column.  The JAX package's mesh gives its null rows a null result
    (its lookup table propagates nulls), against 'none' on its own single
    device; the port's lookup has an entry for a null input, and its
    sharded answer is the JAX package's single-device one."""
    data = pd.DataFrame({"s": ["b", None, "a", None, "b"] * 7,
                         "v": np.arange(35.0)})

    def build(F, df):
        return df.groupBy(F.when(F.col("s").isNull(), "none")
                          .otherwise(F.col("s")).alias("c")) \
            .agg(F.sum("v").alias("sv")).orderBy("c")
    js = JaxSession({})
    try:
        want = build(JF, js.create_dataframe(data)).to_pandas()
    finally:
        js.stop()
    ts = TpuSession(MESH_CONF, device="cpu")
    got = build(TF, ts.create_dataframe(data)).to_pandas()
    assert ts.last_dist_explain == "distributed"
    _cmp(got, want)
