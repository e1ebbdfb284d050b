"""The PyTorch port's string, conditional, date, cast and integral
expressions, and its string group, sort and join keys, against the JAX
package on the CPU.

Every case runs the same expression or query through both engines over
one numpy-seeded table with nulls, empty strings, non-ASCII text, zeros
and negatives.  Tolerances: strings, booleans, integers, dates, keys,
counts and row order exactly; float sums to a relative 1e-12 (the port
adds in another order).
"""

import datetime

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.ops import predicates as jax_preds
from spark_rapids_tpu.ops.expressions import Literal as JaxLiteral
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.columnar import dtypes as tdts
from spark_rapids_tpu_torch.ops import predicates as port_preds
from spark_rapids_tpu_torch.ops.expressions import Literal as PortLiteral

RTOL = 1e-12
N = 400
HASH_ON = {"spark.rapids.tpu.pallas.hash.enabled": True,
           "spark.rapids.tpu.pallas.hash.tableSlots": 1 << 12}
CONFS = {"default": {}, "hash": HASH_ON,
         "small_batches": {"spark.rapids.sql.tpu.maxBatchRows": 97}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the host: one torch thread here."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


WORDS = ["", "a", "ab", "abc", "abd", "b", "ba", "bca", "special",
         "requests", "héllo", "wörld", "日本", "日本語", "zz", "a b c",
         "PROMO x", "x BRASS", "Brand#12", "forest green", "green"]


def _table(n=N, seed=5):
    """One table as lists (None is null): strings from ``WORDS`` joined
    in ones and twos, ints with zeros and negatives, floats with NaN,
    dates around the epoch's leap years."""
    rng = np.random.default_rng(seed)

    def strings(null_frac):
        out = []
        for _ in range(n):
            if rng.random() < null_frac:
                out.append(None)
            elif rng.random() < 0.5:
                out.append(WORDS[rng.integers(len(WORDS))])
            else:
                out.append(WORDS[rng.integers(len(WORDS))] + " "
                           + WORDS[rng.integers(len(WORDS))])
        return out

    def ints(lo, hi, null_frac):
        return [None if rng.random() < null_frac else int(v)
                for v in rng.integers(lo, hi, n)]

    f = rng.normal(size=n).round(2) * 100
    f[::17] = np.nan
    days = rng.integers(-800, 20000, n)
    return {
        "s": strings(0.1), "t": strings(0.1), "u": strings(0.0),
        "i": ints(-20, 21, 0.1), "j": ints(-4, 5, 0.1),
        "k": [int(v) for v in rng.integers(0, 1 << 40, n)],
        "g": [int(v) for v in rng.integers(0, 6, n)],
        "f": [float(v) for v in f],
        "d": [datetime.date(1970, 1, 1) + datetime.timedelta(days=int(v))
              for v in days],
    }


@pytest.fixture(scope="module")
def table():
    return _table()


def _run(F, session, data, build):
    return build(F, session.create_dataframe(data)).to_pandas()


def _jax(build, data, conf=None):
    s = JaxSession(conf or {})
    try:
        return _run(JF, s, data, build)
    finally:
        s.stop()


def _port(build, data, conf=None):
    return _run(TF, TpuSession(conf or {}, device="cpu"), data, build)


def _assert_same(got, want):
    """Same columns, rows and order: floats to RTOL, the rest exactly."""
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in got.columns:
        if got[c].dtype.kind == "f":
            np.testing.assert_allclose(got[c].to_numpy(), want[c].to_numpy(),
                                       rtol=RTOL, atol=0, equal_nan=True)
        else:
            pd.testing.assert_series_equal(got[c], want[c])


# ------------------------------------------------------------ expressions --

LIKE = {
    "exact": "abc", "any": "%", "prefix": "ab%", "suffix": "%bc",
    "contains": "%b%", "prefix_suffix": "a%c", "general": "%a%b%",
    "general_anchored": "a%b%c", "general_end": "%e%s", "non_ascii": "%本%",
    "empty": "", "special_requests": "%special%requests%",
}

EXPRS = {
    **{f"like_{k}": (lambda p: lambda F: F.col("s").like(p))(p)
       for k, p in LIKE.items()},
    "startswith": lambda F: F.col("s").startswith("ab"),
    "startswith_non_ascii": lambda F: F.col("s").startswith("日本"),
    "endswith": lambda F: F.col("s").endswith("c"),
    "contains": lambda F: F.col("s").contains("re"),
    "contains_empty": lambda F: F.col("s").contains(""),
    "substring_1": lambda F: F.substring(F.col("s"), 1, 2),
    "substring_0": lambda F: F.substring(F.col("s"), 0, 3),
    "substring_neg": lambda F: F.substring(F.col("s"), -3, 2),
    "substring_past_end": lambda F: F.substring(F.col("s"), 12, 4),
    "substring_to_end": lambda F: F.substring(F.col("u"), 2),
    "lt": lambda F: F.col("s") < F.col("t"),
    "le": lambda F: F.col("s") <= F.col("t"),
    "gt": lambda F: F.col("s") > F.col("t"),
    "ge": lambda F: F.col("s") >= F.col("t"),
    "lt_literal": lambda F: F.col("s") < F.lit("b"),
    "ge_literal": lambda F: F.col("s") >= F.lit("héllo"),
    "literal_gt": lambda F: F.lit("b") > F.col("s"),
    "eq_columns": lambda F: F.col("s") == F.col("t"),
    "isin_strings": lambda F: F.col("s").isin("a", "ab", "日本", ""),
    "isin_ints": lambda F: F.col("i").isin(1, 2, -3, 0),
    "inset_ints": lambda F: F.col("i").isin(list(range(-20, 20, 2))),
    "case_string": lambda F: F.when(F.col("i") > 0, F.lit("pos"))
    .when(F.col("i") < 0, F.col("s")).otherwise(F.lit("zero")),
    "case_string_no_else": lambda F: F.when(F.col("j") > 0, F.col("t")),
    "case_numeric": lambda F: F.when(F.col("i") > 5, F.col("f"))
    .when(F.col("i") < -5, 1).otherwise(F.col("j")),
    "case_numeric_no_else": lambda F: F.when(F.col("s").like("a%"),
                                             F.col("i")),
    "coalesce_numeric": lambda F: F.coalesce(F.col("i"), F.col("j"),
                                             F.lit(0)),
    "coalesce_nullable": lambda F: F.coalesce(F.col("i"), F.col("j")),
    "year": lambda F: F.year(F.col("d")),
    "month": lambda F: F.month(F.col("d")),
    "dayofmonth": lambda F: F.dayofmonth(F.col("d")),
    "date_add": lambda F: F.date_add(F.col("d"), 45),
    "date_sub": lambda F: F.date_sub(F.col("d"), F.col("g")),
    "datediff": lambda F: F.datediff(F.col("d"),
                                     F.lit(datetime.date(1990, 6, 1))),
    "cast_int_double": lambda F: F.col("i").cast("double"),
    "cast_double_int": lambda F: F.col("f").cast("int"),
    "cast_double_bigint": lambda F: F.col("f").cast("bigint"),
    "cast_int_boolean": lambda F: F.col("j").cast("boolean"),
    "cast_boolean_int": lambda F: (F.col("i") > 0).cast("int"),
    "cast_bigint_tinyint": lambda F: (F.col("k") % 1000).cast("tinyint"),
    "cast_date_timestamp": lambda F: F.col("d").cast("timestamp"),
    "div": lambda F: F.Col(_arith(F).IntegralDivide(F.col("i").expr,
                                                    F.col("j").expr)),
    "div_literal": lambda F: F.Col(_arith(F).IntegralDivide(
        F.col("i").expr, F.lit(-3).expr)),
    "mod": lambda F: F.col("i") % F.col("j"),
    "mod_literal": lambda F: F.col("i") % -7,
    "mod_float": lambda F: F.col("f") % 7.5,
}


def _arith(F):
    from spark_rapids_tpu.ops import arithmetic as jax_arith
    from spark_rapids_tpu_torch.ops import arithmetic as port_arith
    return jax_arith if F is JF else port_arith


def spark_substring(v: str, pos: int, ln: int) -> str:
    """Spark's ``UTF8String.substringSQL`` over characters."""
    start = pos - 1 if pos > 0 else len(v) + pos if pos < 0 else 0
    end = start + ln
    start = max(start, 0)
    return v[start:end] if start < end else ""


# Where the JAX package's device answer is not Spark's, the port's is
# held against Python on the same rows: a negative substring position
# before the string's start must eat into the length (the JAX device
# clamps the start first; its own CPU fallback has Spark's rule).
SPARK_ORACLE = {
    "substring_neg": lambda t: [None if v is None else
                                spark_substring(v, -3, 2) for v in t["s"]],
}


@pytest.mark.parametrize("name", list(EXPRS))
def test_expression_matches_jax(name, table):
    def build(F, df):
        return df.select(F.col("g"), EXPRS[name](F).alias("x"))
    got = _port(build, table)
    if name in SPARK_ORACLE:
        assert got["g"].tolist() == table["g"]
        assert [None if pd.isna(v) else v for v in got["x"].tolist()] == \
            SPARK_ORACLE[name](table)
        return
    _assert_same(got, _jax(build, table))


def test_in_with_null_option_matches_jax(table):
    """No match with a null option is null, a match is true, a null
    value is null (Spark's IN)."""
    def build(F, df):
        preds, lit = (jax_preds, JaxLiteral) if F is JF else \
            (port_preds, PortLiteral)
        null = lit(None, tdts.INT64 if F is TF else _jax_dtype(tdts.INT64))
        expr = preds.In(F.col("i").expr, [lit(1), lit(-2), lit(7), null])
        return df.select(F.col("g"), F.Col(expr).alias("x"))
    got, want = _port(build, table), _jax(build, table)
    _assert_same(got, want)
    assert got["x"].isna().any() and (got["x"] == True).any()  # noqa: E712


# The JAX package evaluates none of these three (its string COALESCE,
# string IN with a null option and a string literal as a column fail in
# its own code), so the port's answer is held against Python on the same
# rows.
def _string_in_null(F, df):
    e = port_preds.In(F.col("s").expr,
                      [PortLiteral("a"), PortLiteral("zz"),
                       PortLiteral(None, tdts.STRING)])
    return df.select(F.Col(e).alias("x"))


def _string_in_null_oracle(t):
    return [True if v in ("a", "zz") else None for v in t["s"]]


ORACLE = {
    "coalesce_string": (
        lambda F, df: df.select(F.coalesce(F.col("s"), F.col("t"),
                                           F.lit("none")).alias("x")),
        lambda t: [a if a is not None else b if b is not None else "none"
                   for a, b in zip(t["s"], t["t"])]),
    "coalesce_string_nullable": (
        lambda F, df: df.select(F.coalesce(F.col("s"), F.col("t"))
                                .alias("x")),
        lambda t: [a if a is not None else b
                   for a, b in zip(t["s"], t["t"])]),
    "string_in_null_option": (_string_in_null, _string_in_null_oracle),
    "string_literal_column": (
        lambda F, df: df.select(F.lit("const é").alias("x"), "g"),
        lambda t: ["const é"] * len(t["g"])),
}


@pytest.mark.parametrize("name", list(ORACLE))
def test_string_expression_matches_python(name, table):
    build, oracle = ORACLE[name]
    got = _port(build, table)["x"]
    want = oracle(table)
    assert [None if pd.isna(v) else v for v in got.tolist()] == want


def _jax_dtype(dt):
    from spark_rapids_tpu.columnar import dtypes as jdts
    return jdts.dtype_from_name(dt.name)


def test_if_matches_jax(table):
    def build(F, df):
        preds = jax_preds if F is JF else port_preds
        e = preds.If((F.col("i") > 0).expr, F.col("s").expr,
                     F.col("t").expr)
        n = preds.If((F.col("j") > 0).expr, F.col("i").expr,
                     F.col("f").expr)
        return df.select(F.Col(e).alias("s_or_t"), F.Col(n).alias("num"))
    _assert_same(_port(build, table), _jax(build, table))


def test_inset_with_null_matches_jax(table):
    def build(F, df):
        preds = jax_preds if F is JF else port_preds
        e = preds.InSet(F.col("i").expr, [1, 2, 3, None])
        return df.select(F.Col(e).alias("x"))
    _assert_same(_port(build, table), _jax(build, table))


def test_unported_expressions_raise_by_name(table):
    """What the port's device expressions do not run (a LIKE with ``_``)
    is tagged by name and runs in the CPU fallback, with the JAX
    package's answer; casts between strings and integers have since been
    ported and run on the device, with the JAX package's answer."""
    s = TpuSession({}, device="cpu")
    df = s.create_dataframe(table)
    cases = {
        "a_c": lambda F, df: df.filter(F.col("s").like("a_c")),
        "bigint -> string": lambda F, df: df.select(
            F.col("i").cast("string").alias("x")),
        "string -> int": lambda F, df: df.select(F.col("s").cast("int")
                                                 .alias("x")),
    }
    for name, build in cases.items():
        physical = build(TF, df).explain().split("==")[0]
        if name == "a_c":
            assert "CpuFallbackExec" in physical
            assert name in s.overrides.last_explain, \
                s.overrides.last_explain
        else:
            assert "CpuFallbackExec" not in physical
        _assert_same(_port(build, table), _jax(build, table))


# ----------------------------------------------- string keys on each path --

def _group(F, df):
    return (df.groupBy("s")
            .agg(F.count().alias("n"), F.sum("i").alias("si"),
                 F.sum("f").alias("sf"), F.min("t").alias("mn"),
                 F.max("t").alias("mx"))
            .orderBy("s"))


def _group_hashed(F, df):
    # the 40-bit key makes the code space too large for the dense
    # directory: the hash path (hash on) or the sort path
    return (df.groupBy("s", "k").agg(F.count().alias("n"),
                                     F.max("u").alias("mx"))
            .orderBy("s", "k"))


def _group_sort_path(F, df):
    # a float key is not codable: the sort path
    return (df.groupBy("u", "f").agg(F.sum("i").alias("si"),
                                     F.min("s").alias("mn"))
            .orderBy("u", "f"))


def _keyless(F, df):
    return df.agg(F.min("s").alias("mn"), F.max("s").alias("mx"),
                  F.min("u").alias("mnu"), F.count("s").alias("n"))


def _sort(F, df):
    return df.select("s", "t", "i").orderBy(F.col("s").desc(), "t", "i")


def _sort_nulls_last(F, df):
    return df.select("t", "g").orderBy(F.col("t").asc_nulls_last(), "g")


def _topn(F, df):
    return df.select("u", "i").orderBy("u", F.col("i").desc()).limit(25)


def _distinct(F, df):
    return df.select("s", "g").distinct().orderBy("s", "g")


def _count(F, df):
    return df.groupBy("t").count().orderBy("t")


QUERIES = {"group": _group, "group_hashed": _group_hashed,
           "group_sort_path": _group_sort_path, "keyless": _keyless,
           "sort": _sort, "sort_nulls_last": _sort_nulls_last,
           "topn": _topn, "distinct": _distinct, "count": _count}


@pytest.mark.parametrize("conf", list(CONFS))
@pytest.mark.parametrize("query", list(QUERIES))
def test_string_keys_match_jax(query, conf, table):
    build = QUERIES[query]
    _assert_same(_port(build, table, CONFS[conf]), _jax(build, table))


def _join_data(seed=9):
    rng = np.random.default_rng(seed)
    keys = ["", "a", "ab", "héllo", "日本", "zz", None]
    left = {"key": [keys[v] for v in rng.integers(0, len(keys), 300)],
            "lv": [int(v) for v in rng.integers(0, 100, 300)]}
    right = {"key": [keys[v] for v in rng.integers(0, len(keys) - 2, 40)],
             "rv": [int(v) for v in rng.integers(0, 100, 40)]}
    return left, right


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti", "full"])
@pytest.mark.parametrize("conf", ["default", "hash"])
def test_string_join_keys_match_jax(how, conf):
    left, right = _join_data()

    def run(F, s):
        j = s.create_dataframe(left).join(s.create_dataframe(right),
                                          on="key", how=how)
        cols = ["key", "lv"] + ([] if how in ("semi", "anti") else ["rv"])
        return j.orderBy(*[F.col(c).asc_nulls_last() for c in cols]) \
            .to_pandas()
    js = JaxSession(CONFS[conf])
    try:
        want = run(JF, js)
    finally:
        js.stop()
    got = run(TF, TpuSession(CONFS[conf], device="cpu"))
    _assert_same(got, want)
    assert len(got)


def test_string_min_max_over_batches():
    """min "a" and max "c" over ["b", "a", "c"], one row per batch."""
    data = {"s": ["b", "a", "c"], "g": [1, 1, 1]}

    def build(F, df):
        return df.agg(F.min("s").alias("mn"), F.max("s").alias("mx"))
    for conf in ({}, {"spark.rapids.sql.tpu.maxBatchRows": 1}):
        got = _port(build, data, conf)
        _assert_same(got, _jax(build, data))
        assert got.iloc[0].tolist() == ["a", "c"]


def test_dataframe_count_and_with_column(table):
    def build(F, df):
        return (df.withColumn("i", F.col("i") * 2)
                .withColumn("y", F.year(F.col("d")))
                .filter(F.col("y") > 1990))
    _assert_same(_port(build, table), _jax(build, table))
    s = TpuSession({}, device="cpu")
    df = s.create_dataframe(table)
    js = JaxSession({})
    try:
        want = js.create_dataframe(table).filter(
            JF.col("s").like("%a%")).count()
    finally:
        js.stop()
    assert df.filter(TF.col("s").like("%a%")).count() == want


# ------------------------------------------------------ the host dictionary --

ENCODERS = ["rank_encode", "ordered_dict_encode", "dict_encode_stable"]


@pytest.mark.parametrize("path", ["arrow", "byte_matrix"])
@pytest.mark.parametrize("encoder", ENCODERS)
def test_dictionary_encoders_match_jax(encoder, path, table, monkeypatch):
    """Each host encoder gives the JAX package's codes over the same
    strings (nulls, empty strings, non-ASCII), through arrow and through
    the byte-matrix fallback."""
    from spark_rapids_tpu.columnar.column import Column as JaxColumn
    from spark_rapids_tpu.ops import dictionary as jax_dict
    from spark_rapids_tpu_torch.columnar.column import Column
    from spark_rapids_tpu_torch.ops import dictionary
    if path == "byte_matrix":
        monkeypatch.setattr(dictionary, "_arrow_dictionary",
                            lambda col: None)
    values = table["s"]
    host = dictionary.host_strings(Column.from_strings(values), len(values))
    jax_col = JaxColumn.from_strings(values)
    if encoder == "dict_encode_stable":
        codes, seen = {}, []
        jcodes, jseen = {}, []
        # two calls: codes stay stable across batches
        got = [dictionary.dict_encode_stable(host, codes, seen)
               for _ in range(2)]
        want = [jax_dict.dict_encode_stable(jax_col, jcodes, jseen)
                for _ in range(2)]
        if path == "arrow":
            assert seen == jseen
        # the fallback interns in string order, arrow in first-seen
        # order: the same partition of the rows either way
        for g, w in zip(got, want):
            np.testing.assert_array_equal(
                np.array(seen, dtype=object)[g],
                np.array(jseen, dtype=object)[w])
        return
    got = getattr(dictionary, encoder)(host)
    want = getattr(jax_dict, encoder)(jax_col)
    # a null row's code is any code: the callers read its validity
    valid = np.array([v is not None for v in values])
    if encoder == "ordered_dict_encode":
        got, got_values = got
        want, want_values = want
        assert got_values == want_values
    np.testing.assert_array_equal(got[valid], want[valid])


# --------------------------------------------- the dictionary on the device --

def _string_col(values):
    from spark_rapids_tpu_torch.columnar.column import Column
    return Column.from_strings(values)


DEVICE_BATCHES = [
    ["b", "a", None, "b", "", "héllo", "a", None],
    ["c", "a", "long string past eight", "", "b", "zz"],
    [None, None, "c"],
    ["x" * 30, "a", "x" * 29, "x" * 31],
]


@pytest.mark.parametrize("null_code", [None, -1])
def test_stable_dictionary_on_device_equals_host_encoder(null_code):
    """The device dictionary gives the host encoder's codes batch after
    batch (first-appearance order, the null value after a batch's other
    new values, ``null_code`` for joins), as its strings grow past one
    and two packed words, and decodes them back."""
    from spark_rapids_tpu_torch.ops import dictionary
    d = dictionary.StableDictionary()
    codes, seen = {}, []
    for values in DEVICE_BATCHES:
        c = _string_col(values)
        got = d.encode(c, len(values), null_code=null_code)
        want = dictionary.dict_encode_stable(
            dictionary.host_strings(c, len(values)), codes, seen,
            null_code)
        assert d.host_codes is None
        np.testing.assert_array_equal(got.numpy(), want)
        back = d.decode(got, c.validity)
        host = dictionary.host_strings(back, len(values))
        texts = [None if not host.valid[i] else
                 host.chars[host.offsets[i]:host.offsets[i + 1]]
                 .tobytes().decode() for i in range(len(values))]
        assert texts == values
    assert len(d) == len(seen)


def test_stable_dictionary_moves_to_the_host_past_its_width():
    from spark_rapids_tpu_torch.ops import dictionary
    d = dictionary.StableDictionary()
    first = ["a", None, "b"]
    long_ = ["b", "y" * (dictionary.MAX_PACKED_BYTES + 1), "a", None]
    codes = [d.encode(_string_col(v), len(v)).tolist()
             for v in (first, long_)]
    assert d.host_codes is not None
    assert codes == [[0, 2, 1], [1, 3, 0, 2]]
    assert d.host_values == ["a", "b", None,
                             "y" * (dictionary.MAX_PACKED_BYTES + 1)]


def test_string_sort_keys_order_as_rank_encode():
    """Packed words then length sort as Spark orders strings (bytes,
    then a prefix first), the host ranks' order."""
    from spark_rapids_tpu_torch.ops import aggregates as agg
    from spark_rapids_tpu_torch.ops import dictionary
    rng = np.random.default_rng(4)
    pool = ["", "a", "a\x00", "ab", "abcdefgh", "abcdefghi", "abcdefgh\x7f",
            "héllo", "hello", "日本", "\xff", "zzzzzzzzzzzzzzzzz", "Z"]
    values = [pool[i] for i in rng.integers(0, len(pool), 200)]
    c = _string_col(values)
    keys = dictionary.string_sort_keys(c, len(values))
    live = torch.ones(len(values), dtype=torch.bool)
    perm = agg.sort_permutation(keys, live).numpy()
    ranks = dictionary.rank_encode(dictionary.host_strings(c, len(values)))
    assert list(ranks[perm]) == sorted(ranks)
    assert [values[i] for i in perm] == sorted(
        values, key=lambda v: v.encode("utf-8"))
