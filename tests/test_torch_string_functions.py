"""The PyTorch port's string function library (``ops/stringops.py``,
``ops/predicates.py``'s ``isnan`` / ``greatest`` / ``least``) against
the JAX package and against Python on the CPU.

Every case runs one expression through both engines over the same
numpy-seeded table: ASCII and multi-byte strings, empty strings, nulls,
leading and trailing spaces, delimiters at the ends, floats with NaN and
dates across month ends and leap days.  Each answer equals Python's
(``str``, Spark's documented rule) exactly, and the JAX package's where
the JAX package keeps Spark's rule; where it does not (``ROADMAP.md``
queue 3: pads and ``locate`` count bytes or ignore the start, ``least``
takes a NaN) the case says so.  The CPU fallback's host evaluation
equals the device evaluation of every expression (the expression
switched off by ``spark.rapids.sql.expression.<Name>``), and the SQL
names resolve to the same expressions.
"""

import datetime
import math

import numpy as np
import pandas as pd
import pytest
import torch

from test_torch_strings import _assert_same, _jax, _port
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.utils.hostsync import host_sync_metrics

N = 300
WORDS = ["", "a", "ab", "abc", "héllo", "wörld", "日本語", "  pad  ", " x",
         "y ", "a-b-c", "--", "x-", "-y", "héllo-wörld", "日本-語", "Brand#13",
         "MED BOX", "special requests", "ECONOMY anodized STEEL", "13-555"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def str_table(n=N, seed=13):
    """Strings (one or two words, some null), ints, floats with NaN and
    -0.0, dates across month ends and the leap days of 2000 and 2020."""
    rng = np.random.default_rng(seed)

    def strings(null_frac):
        out = []
        for _ in range(n):
            r = rng.random()
            if r < null_frac:
                out.append(None)
            elif r < 0.6:
                out.append(WORDS[rng.integers(len(WORDS))])
            else:
                out.append(WORDS[rng.integers(len(WORDS))]
                           + WORDS[rng.integers(len(WORDS))])
        return out
    f = rng.normal(size=n).round(2) * 10
    f[::11] = np.nan
    f[5::23] = -0.0
    g = rng.normal(size=n).round(1)
    g[::7] = np.nan
    base = [datetime.date(2000, 2, 27), datetime.date(2019, 12, 30),
            datetime.date(2020, 2, 28), datetime.date(1999, 1, 31),
            datetime.date(1969, 12, 31), datetime.date(2021, 3, 31)]
    days = [base[i % len(base)] + datetime.timedelta(days=int(k))
            for i, k in enumerate(rng.integers(0, 5, n))]
    return {"s": strings(0.1), "t": strings(0.1),
            "i": [None if rng.random() < 0.1 else int(v)
                  for v in rng.integers(-300, 300, n)],
            "f": [float(v) for v in f], "h": [float(v) for v in g],
            "d": days,
            "e": [d + datetime.timedelta(days=int(k)) for d, k in
                  zip(days, rng.integers(-40, 40, n))]}


@pytest.fixture(scope="module")
def table():
    return str_table()


# ------------------------------------------------------- Spark's rules

def _pad(v, width, pad, left):
    if width <= 0:
        return ""
    if len(v) >= width or not pad:
        return v[:width]
    fill = (pad * (width // len(pad) + 1))[:width - len(v)]
    return fill + v if left else v + fill


def _substring_index(v, delim, count):
    if count == 0 or not delim:
        return ""
    hits, i = [], v.find(delim)
    while i >= 0:
        hits.append(i)
        i = v.find(delim, i + 1)
    if count > 0:
        return v if len(hits) < count else v[:hits[count - 1]]
    return v if len(hits) < -count else v[hits[count] + len(delim):]


def _locate(v, sub, start):
    if start < 1:
        return 0
    return 1 if not sub else v.find(sub, start - 1) + 1


def _initcap(v):
    out, prev = [], True
    for ch in v.lower():
        out.append(ch.upper() if prev else ch.lower())
        prev = ch == " "
    return "".join(out)


def _ascii_case(v, upper):
    return "".join(c.upper() if upper and "a" <= c <= "z" else
                   c.lower() if not upper and "A" <= c <= "Z" else c
                   for c in v)


def _s1(fn):
    """A function of column s (null stays null)."""
    return lambda t: [None if v is None else fn(v) for v in t["s"]]


def _nan_order(v):
    return (1, 0.0) if math.isnan(v) else (0, v)


def _extreme(t, cols, pick):
    out = []
    for row in zip(*[t[c] for c in cols]):
        vals = [v for v in row if v is not None]
        out.append(pick(vals, key=_nan_order) if vals else None)
    return out


# name: (expression, Python's answer, the JAX package keeps Spark's rule)
CASES = {
    "length": (lambda F: F.length("s"), _s1(len), True),
    "upper": (lambda F: F.upper("s"), _s1(lambda v: _ascii_case(v, True)),
              True),
    "lower": (lambda F: F.lower("s"),
              _s1(lambda v: _ascii_case(v, False)), True),
    "initcap": (lambda F: F.initcap("s"),
                _s1(lambda v: "".join(
                    c if ord(c) > 127 else x
                    for c, x in zip(v, _initcap(v)))), True),
    "trim": (lambda F: F.trim("s"), _s1(lambda v: v.strip(" ")), True),
    "ltrim": (lambda F: F.ltrim("s"), _s1(lambda v: v.lstrip(" ")), True),
    "rtrim": (lambda F: F.rtrim("s"), _s1(lambda v: v.rstrip(" ")), True),
    "concat": (lambda F: F.concat(F.lit("<"), "s", F.lit("|"), "t"),
               lambda t: [None if a is None or b is None else
                          f"<{a}|{b}" for a, b in zip(t["s"], t["t"])],
               True),
    "concat_trimmed": (lambda F: F.length(F.trim(F.concat(
        F.lit(" "), "s", F.lit(" ")))),
        _s1(lambda v: len((" " + v + " ").strip(" "))), True),
    "concat_ws": (lambda F: F.concat_ws("|", "s", F.lit("x"), "t"),
                  lambda t: ["|".join(v for v in (a, "x", b)
                                      if v is not None)
                             for a, b in zip(t["s"], t["t"])], True),
    "lpad_ascii": (lambda F: F.lpad("s", 6, "."),
                   _s1(lambda v: _pad(v, 6, ".", True)), False),
    "rpad_multibyte_pad": (lambda F: F.rpad("s", 7, "é-"),
                           _s1(lambda v: _pad(v, 7, "é-", False)), False),
    "lpad_zero_width": (lambda F: F.lpad("s", 0, "x"),
                        _s1(lambda v: ""), True),
    "lpad_empty_pad": (lambda F: F.lpad("s", 5, ""),
                       _s1(lambda v: _pad(v, 5, "", True)), False),
    "locate": (lambda F: F.locate("-", "s"), _s1(lambda v: _locate(
        v, "-", 1)), False),
    "locate_start": (lambda F: F.locate("-", "s", 4),
                     _s1(lambda v: _locate(v, "-", 4)), False),
    "locate_multibyte": (lambda F: F.locate("wö", "s", 2),
                         _s1(lambda v: _locate(v, "wö", 2)), False),
    "locate_empty": (lambda F: F.locate("", "s", 3),
                     _s1(lambda v: _locate(v, "", 3)), False),
    "locate_zero_start": (lambda F: F.locate("a", "s", 0),
                          _s1(lambda v: _locate(v, "a", 0)), False),
    "substring_index_2": (lambda F: F.substring_index("s", "-", 2),
                          _s1(lambda v: _substring_index(v, "-", 2)), True),
    "substring_index_neg": (lambda F: F.substring_index("s", "-", -1),
                            _s1(lambda v: _substring_index(v, "-", -1)),
                            True),
    "substring_index_overlap": (
        lambda F: F.substring_index("s", "--", 1),
        _s1(lambda v: _substring_index(v, "--", 1)), True),
    "substring_index_0": (lambda F: F.substring_index("s", "-", 0),
                          _s1(lambda v: ""), False),
    "repeat": (lambda F: F.repeat("s", 3), _s1(lambda v: v * 3), True),
    "repeat_0": (lambda F: F.repeat("s", 0), _s1(lambda v: ""), True),
    "ascii": (lambda F: F.ascii("s"), _s1(lambda v: ord(v[0]) if v else 0),
              True),
    "chr": (lambda F: F.chr("i"),
            lambda t: [None if v is None else "" if v < 0 else chr(v % 256)
                       for v in t["i"]], True),
    "isnan": (lambda F: F.isnan("f"),
              lambda t: [math.isnan(v) for v in t["f"]], True),
    "greatest": (lambda F: F.greatest("f", "h"),
                 lambda t: _extreme(t, ("f", "h"), max), True),
    "least": (lambda F: F.least("f", "h"),
              lambda t: _extreme(t, ("f", "h"), min), False),
    "greatest_dates": (lambda F: F.greatest("d", "e"),
                       lambda t: [max(a, b) for a, b in zip(t["d"], t["e"])],
                       True),
    "least_dates": (lambda F: F.least("d", "e", F.lit(
        datetime.date(2000, 3, 1))),
        lambda t: [min(a, b, datetime.date(2000, 3, 1))
                   for a, b in zip(t["d"], t["e"])], True),
}


def _values(col):
    """A result column as a list, pandas' NA as None (a float null stays
    NaN, which ``_same_as_python`` takes for null)."""
    return [None if v is None or v is pd.NA else v for v in col.tolist()]


def _same_as_python(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None or g is pd.NA or (isinstance(g, float)
                                               and math.isnan(g)), (i, g)
        elif isinstance(w, float) and math.isnan(w):
            assert isinstance(g, float) and math.isnan(g), (i, g)
        else:
            assert g == w, (i, g, w)


@pytest.mark.parametrize("name", list(CASES))
def test_string_function_parity(name, table):
    build_expr, oracle, jax_keeps_spark = CASES[name]

    def build(F, df):
        return df.select(build_expr(F).alias("x"))
    got = _port(build, table)
    _same_as_python(_values(got["x"]), oracle(table))
    if jax_keeps_spark:
        _assert_same(got, _jax(build, table))


# the SQL names the shared front end resolves, through both engines
SQL_CASES = {
    "case": "SELECT initcap(lower(s)) AS a, upper(t) AS b FROM v",
    "trim_concat": "SELECT length(trim(concat(' ', s, ' '))) AS n, "
                   "rtrim(t) AS r, ltrim(s) AS l FROM v",
    "index_repeat": "SELECT substring_index(s, '-', 1) AS a, "
                    "repeat(substring(t, 2, 1), 3) AS b, "
                    "concat_ws('|', s, t) AS c FROM v",
    "codes": "SELECT ascii(s) AS a, chr(i) AS b, char(i + 60) AS c, "
             "isnan(f) AS d, greatest(f, h) AS e FROM v",
    "locate_two": "SELECT locate('a', s) AS a FROM v",
}


@pytest.mark.parametrize("name", list(SQL_CASES))
def test_string_sql_names(name, table):
    text = SQL_CASES[name]
    port = TpuSession({}, device="cpu")
    port.create_dataframe(table).createOrReplaceTempView("v")
    got = port.sql(text)
    assert "CpuFallbackExec" not in got.explain().split("==")[0]
    jax = JaxSession({})
    try:
        jax.create_dataframe(table).createOrReplaceTempView("v")
        want = jax.sql(text).to_pandas()
    finally:
        jax.stop()
    _assert_same(got.to_pandas(), want)


def test_sql_spark_rules(table):
    """SQL ``locate(substr, str, pos)`` honours ``pos`` (the JAX package
    reads two arguments), and ``lpad`` / ``rpad`` count characters (the
    JAX package counts bytes): Spark's answers, against Python."""
    port = TpuSession({}, device="cpu")
    port.create_dataframe(table).createOrReplaceTempView("v")
    got = port.sql("SELECT locate('-', s, 4) AS p, lpad(upper(t), 8, '.') "
                   "AS l, rpad(s, 3) AS r FROM v").to_pandas()
    _same_as_python(_values(got["p"]), _s1(lambda v: _locate(v, "-", 4))(
        table))
    _same_as_python(_values(got["l"]), [
        None if v is None else _pad(_ascii_case(v, True), 8, ".", True)
        for v in table["t"]])
    _same_as_python(_values(got["r"]), _s1(lambda v: _pad(v, 3, " ",
                                                           False))(table))


# the expression class each fallback case switches off
FALLBACK_CASES = {
    "length": "Length", "upper": "Upper", "lower": "Lower",
    "initcap": "InitCap", "trim": "StringTrim", "ltrim": "StringTrimLeft",
    "rtrim": "StringTrimRight", "concat": "ConcatStrings",
    "concat_ws": "ConcatWs", "lpad_ascii": "StringLPad",
    "rpad_multibyte_pad": "StringRPad", "lpad_empty_pad": "StringLPad",
    "locate_start": "StringLocate", "locate_empty": "StringLocate",
    "substring_index_2": "SubstringIndex",
    "substring_index_neg": "SubstringIndex",
    "substring_index_overlap": "SubstringIndex", "repeat": "StringRepeat",
    "ascii": "Ascii", "chr": "Chr", "isnan": "IsNaN",
    "greatest": "Greatest", "least": "Least", "least_dates": "Least",
}


@pytest.mark.parametrize("name", list(FALLBACK_CASES))
def test_fallback_equals_device(name, table):
    """The CPU fallback's host evaluation equals the device's (upper,
    lower and initcap on ASCII rows only: the host maps all of Unicode,
    as CPU Spark does)."""
    cls = FALLBACK_CASES[name]
    build_expr = CASES[name][0]

    def build(F, df):
        return df.select(build_expr(F).alias("x"))
    data = table
    if cls in ("Upper", "Lower", "InitCap"):
        keep = [i for i, v in enumerate(table["s"])
                if v is None or v.isascii()]
        data = {k: [v[i] for i in keep] for k, v in table.items()}
    off = TpuSession({f"spark.rapids.sql.expression.{cls}": "false"},
                     device="cpu")
    df = build(__import__("spark_rapids_tpu_torch.api.functions",
                          fromlist=["F"]), off.create_dataframe(data))
    assert df.explain().splitlines()[0] == "CpuFallbackExec[Project]"
    _assert_same(df.to_pandas(), _port(build, data))


def test_host_case_mapping_is_unicode(table):
    """With ``incompatibleOps`` off the case functions run on the host
    with CPU Spark's Unicode mapping, as the JAX package's fallback."""
    conf = {"spark.rapids.sql.incompatibleOps.enabled": "false"}

    def build(F, df):
        return df.select(F.upper("s").alias("u"), F.lower("s").alias("l"),
                         F.initcap("s").alias("c"))
    port = TpuSession(conf, device="cpu")
    df = build(__import__("spark_rapids_tpu_torch.api.functions",
                          fromlist=["F"]), port.create_dataframe(table))
    assert df.explain().splitlines()[0] == "CpuFallbackExec[Project]"
    got = df.to_pandas()
    _same_as_python(_values(got["u"]), _s1(str.upper)(table))
    _same_as_python(_values(got["l"]), _s1(str.lower)(table))
    _same_as_python(_values(got["c"]), _s1(_initcap)(table))
    _assert_same(got, _jax(build, table, conf))


@pytest.mark.parametrize("name, syncs", [
    # a producer inside the bytes its input holds: no sync
    ("substring_index_2", 0), ("trim", 0), ("upper", 0),
    # one that can outgrow them: one counted fetch of its total
    ("repeat", 1), ("lpad_ascii", 1), ("concat", 1)])
def test_producer_host_syncs(name, syncs, table):
    """Each producer sizes its chars from a host bound, or fetches its
    exact total once per batch (``host_sync_metrics``)."""
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.ops.compiler import StageFn
    s = TpuSession({}, device="cpu")
    expr = CASES[name][0](F).expr.bind(
        s.create_dataframe(table).plan.schema)
    batch = ColumnarBatch.from_pydict(table)
    host_sync_metrics.reset()
    StageFn([expr], [dt for _, dt in batch.schema])(batch)
    assert host_sync_metrics.snapshot() == syncs


TAG_CASES = {
    # name: (conf, expression)
    "incompat_case": ({"spark.rapids.sql.incompatibleOps.enabled": "false"},
                      lambda F: F.initcap(F.upper("s"))),
    "incompat_regex": ({"spark.rapids.sql.incompatibleOps.enabled":
                        "false"}, lambda F: F.rlike("s", "a.b")),
    "incompat_lower": ({"spark.rapids.sql.incompatibleOps.enabled":
                        "false"}, lambda F: F.lower("s")),
    "regexp_off": ({"spark.rapids.sql.regexp.enabled": "false"},
                   lambda F: F.regexp_replace("s", "-", "+")),
    "regexp_off_keeps_replace": (
        {"spark.rapids.sql.regexp.enabled": "false"},
        lambda F: F.replace("s", "-", "+")),
    "like_underscore": ({}, lambda F: F.col("s").like("a_c")),
    "regex_outside_subset": ({}, lambda F: F.rlike("s", "(ab)+")),
    "translate_non_ascii": ({}, lambda F: F.translate("s", "é", "e")),
    "date_format_outside": ({}, lambda F: F.date_format("d", "EEE")),
    "date_format_inside": ({}, lambda F: F.date_format("d", "yyyy/MM")),
    "md5": ({}, lambda F: F.md5("s")),
    "double_to_string": ({}, lambda F: F.col("f").cast("string")),
    "length_disabled": ({"spark.rapids.sql.expression.Length": "false"},
                        lambda F: F.length("s")),
}


# the JAX package's wording of a reason -> the port's (the card is not a
# TPU; the port's LIKE reason also names what is missing)
_WORDING = (("on TPU", "on the device"), ("TPU regex", "device regex"),
            ("no TPU implementation", "no device implementation"),
            ("too general for TPU",
             "too general for the device ('_' is not ported)"))


def _reasons(explain):
    """The reasons of an explain's ``!`` lines in the port's wording."""
    out = []
    for line in explain.splitlines():
        if line.lstrip().startswith("! ") and "because " in line:
            text = line.split("because ", 1)[1]
            for a, b in _WORDING:
                if b not in text:
                    text = text.replace(a, b)
            out.append(text)
    return sorted(out)


@pytest.mark.parametrize("name", list(TAG_CASES))
def test_tags_match_jax(name, table):
    """The same nodes and expressions are tagged off as in the JAX
    package for the same conf, with its reason text, and the fallback
    then answers the same."""
    from test_torch_overrides import run_both, tagged
    conf, build_expr = TAG_CASES[name]

    def build(F, df):
        return df.select(build_expr(F).alias("x"))
    data = {k: v for k, v in table.items() if k in ("s", "f")}
    data["d"] = [None if v is None else v for v in table["d"]]
    port, df, want, jexplain = run_both(conf, build, data)
    df.explain()
    explain = port.overrides.last_explain
    assert tagged(explain) == tagged(jexplain)
    assert _reasons(explain) == _reasons(jexplain)
    # the JAX package's fallback writes 'EEE' as three day names, and
    # answers false for a null LIKE (Spark: null; the port: null)
    if not isinstance(want, Exception) and name not in (
            "double_to_string", "incompat_case", "date_format_outside",
            "like_underscore"):
        _assert_same(df.to_pandas(), want)


def test_new_functions_lower_over_the_dictionary(table):
    """On the sharded path a function of one encoded string column (the
    new string, regex and hash functions among them) becomes a lookup
    over its dictionary and the plan stays distributed, equal to one
    device; a function of a string column and another column sends the
    plan to one device with its reason."""
    from spark_rapids_tpu_torch.api import functions as F

    def build(df):
        return (df.select(
            F.upper(F.trim("s")).alias("u"),
            F.length(F.lpad("s", 6, ".")).alias("n"),
            F.rlike("s", "a.b").alias("r"),
            F.regexp_replace("s", "-", "").alias("p"),
            F.hash("s").alias("h"), "i")
            .groupBy("u", "n", "r", "p", "h")
            .agg(F.count("i").alias("c"))
            .orderBy("u", "n", "r", "p", "h"))
    one = build(TpuSession({}, device="cpu").create_dataframe(table))
    s = TpuSession({"spark.rapids.sql.distributed.numShards": 8},
                   device="cpu")
    got = build(s.create_dataframe(table)).to_pandas()
    assert s.last_dist_explain == "distributed"
    _assert_same(got, one.to_pandas())
    mixed = s.create_dataframe(table).select(
        F.hash("s", "i").alias("h")).groupBy("h").agg(
        F.count("*").alias("c")).orderBy("h")
    got = mixed.to_pandas()
    assert s.last_dist_explain.startswith("fallback: ")
    assert "Murmur3Hash" in s.last_dist_explain
    want = TpuSession({}, device="cpu").create_dataframe(table).select(
        F.hash("s", "i").alias("h")).groupBy("h").agg(
        F.count("*").alias("c")).orderBy("h").to_pandas()
    _assert_same(got, want)
