"""Casts between strings and the other types on the PyTorch port's device
(``stringops.cast_string``) against Spark's non-ANSI rules, the JAX
package and the CPU fallback, on the CPU.

The string rows of the reference's ``tests/test_cast_matrix.py`` and the
casts of ``tests/test_strings_datetime.py``: string to timestamp,
boolean, the integral types, double, float and date, and integers,
booleans, dates and timestamps to strings, each input parsed or written
exactly as Spark does (whitespace trimmed, signs, a fraction read into an
integer by truncation, exponents and Java's special literals, null on a
bad string or past the type's range); the JAX package's answer where it
keeps Spark's rule; the planner's reasons and conf gates for the casts
that stay in the fallback (a float or decimal to a string, a string to a
decimal).
"""

import datetime
import math

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.api.session import TpuSession

UTC0 = datetime.datetime(1970, 1, 1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cast(values, target, conf=None):
    """(DataFrame, the cast's values with None for null and NaN kept)."""
    s = TpuSession(conf or {}, device="cpu")
    df = s.create_dataframe({"s": values}).select(
        TF.col("s").cast(target).alias("x"))
    got = df.to_arrow().column("x").to_pylist()
    return df, [v.replace(tzinfo=None) if isinstance(v, datetime.datetime)
                else v for v in got]


def _jax_cast(values, target):
    s = JaxSession({})
    try:
        return s.create_dataframe({"s": values}).select(
            JF.col("s").cast(target).alias("x")).to_pandas()
    finally:
        s.stop()


INT_CASES = [  # (text, Spark's int, JAX keeps it)
    ("12", 12, True), ("-3", -3, True), ("+4", 4, True), ("0", 0, True),
    ("007", 7, True), (" 7", 7, False), ("\t-8 \n", -8, False),
    ("1.5", 1, False), ("-0.25", 0, False), ("1.", 1, False),
    (".5", 0, False), ("1.2.3", None, True), ("abc", None, True),
    ("", None, True), ("-", None, True), ("+", None, True),
    ("1e3", None, True), ("1 2", None, True), ("2147483647", 2147483647,
                                               True),
    ("-2147483648", -2147483648, True), ("2147483648", None, False),
    ("-2147483649", None, False), ("日本", None, True), (None, None, True),
]


@pytest.mark.parametrize("target, lo, hi", [
    ("tinyint", -128, 127), ("smallint", -(1 << 15), (1 << 15) - 1),
    ("int", -(1 << 31), (1 << 31) - 1), ("bigint", -(1 << 63),
                                          (1 << 63) - 1)])
def test_string_to_integral(target, lo, hi):
    texts = [t for t, _, _ in INT_CASES] + [
        "9223372036854775807", "-9223372036854775808",
        "9223372036854775808", "300", "-129"]
    want = []
    for t in texts:
        w = dict((a, b) for a, b, _ in INT_CASES).get(t)
        if t in ("9223372036854775807", "-9223372036854775808",
                 "9223372036854775808", "300", "-129", "2147483648",
                 "-2147483649"):
            w = int(t)
        want.append(w if w is not None and lo <= w <= hi else None)
    df, got = _cast(texts, target)
    assert "CpuFallbackExec" not in df.explain().split("==")[0]
    assert got == want
    # the JAX package agrees on the inputs it reads as Spark does
    jax = _jax_cast([t for t, _, ok in INT_CASES if ok and t is not None
                     and (t in ("2147483647", "-2147483648") and
                          target in ("int", "bigint") or
                          t not in ("2147483647", "-2147483648"))],
                    target)["x"].tolist()
    mine = [w for t, w in zip(texts, want) if t in
            [x for x, _, ok in INT_CASES if ok and x is not None and (
                x in ("2147483647", "-2147483648") and
                target in ("int", "bigint") or
                x not in ("2147483647", "-2147483648"))]]
    assert [None if pd.isna(v) else int(v) for v in jax] == mine


FLOAT_CASES = [  # (text, Spark's double, JAX keeps it)
    ("1.5", 1.5, True), ("-0.25", -0.25, True), ("12", 12.0, True),
    ("+4", 4.0, True), ("0.1", 0.1, True), ("123456.789", 123456.789,
                                            True),
    (" 7 ", 7.0, False), ("1e3", 1000.0, False), ("-2.5E-3", -0.0025,
                                                  False),
    ("1.5d", 1.5, False), ("2f", 2.0, False), (".5", 0.5, False),
    ("5.", 5.0, False), ("Infinity", math.inf, False),
    ("-infinity", -math.inf, False), ("inf", math.inf, False),
    ("NaN", math.nan, False), ("nan", math.nan, False),
    ("-NaN", math.nan, False), ("1e400", math.inf, False),
    ("abc", None, True), ("", None, True), ("1e", None, True),
    ("e5", None, True), ("1.2.3", None, True), ("--1", None, True),
    (None, None, True),
]


@pytest.mark.parametrize("target", ["double", "float"])
def test_string_to_float(target):
    texts = [t for t, _, _ in FLOAT_CASES]
    df, got = _cast(texts, target)
    assert "CpuFallbackExec" not in df.explain().split("==")[0]
    for (t, w, _), g in zip(FLOAT_CASES, got):
        if w is None:
            assert g is None, (t, g)
        elif math.isnan(w):
            assert math.isnan(g), (t, g)
        elif target == "double":
            assert g == w, (t, g, w)
        else:
            assert g == float(np.float32(w)), (t, g, w)
    keep = [t for t, _, ok in FLOAT_CASES if ok and t is not None]
    jax = _jax_cast(keep, target)["x"].tolist()
    mine = [g for (t, _, ok), g in zip(FLOAT_CASES, got)
            if ok and t is not None]
    assert [None if pd.isna(v) else float(v) for v in jax] == \
        [None if v is None else float(v) for v in mine]


DATE_CASES = [("2020-01-05", datetime.date(2020, 1, 5)),
              (" 2020-02-29 ", datetime.date(2020, 2, 29)),
              ("2021-02-29", None), ("2020-13-01", None),
              ("1999-12-31 23:59:59", None), ("2020-1-5", None),
              ("0001-01-01", datetime.date(1, 1, 1)), ("", None),
              ("abc", None), (None, None)]


def test_string_to_date():
    df, got = _cast([t for t, _ in DATE_CASES], "date")
    assert "CpuFallbackExec" not in df.explain().split("==")[0]
    assert [None if v is None else v for v in got] == \
        [w for _, w in DATE_CASES]


TS_CASES = [
    ("2021-09-15 10:30:05", "2021-09-15 10:30:05"),
    ("2021-09-15", "2021-09-15 00:00:00"),
    ("2021-09-15T23:59:59", "2021-09-15 23:59:59"),
    ("bad", None), (None, None),
    ("2021-09-15 10:30:05.25", "2021-09-15 10:30:05.250000"),
    ("1969-12-31 23:59:59", "1969-12-31 23:59:59"),
    ("2021-09-15 25:00:00", None),
    (" 2000-02-29 01:02:03.000001 ", "2000-02-29 01:02:03.000001"),
    ("2021-09-15 10:30", None), ("2021-09-15 10:30:05.1234567", None),
]


def test_string_to_timestamp():
    df, got = _cast([t for t, _ in TS_CASES], "timestamp")
    assert "CpuFallbackExec" not in df.explain().split("==")[0]
    for (t, w), g in zip(TS_CASES, got):
        if w is None:
            assert g is None, (t, g)
        else:
            assert pd.Timestamp(g) == pd.Timestamp(w), (t, g)


def test_string_to_boolean():
    vals = ["true", "FALSE", "T", "n", "YES", "0", "1", "x", "", None,
            "  y ", "tru", "no", "truee"]
    df, got = _cast(vals, "boolean")
    assert "CpuFallbackExec" not in df.explain().split("==")[0]
    assert got == [True, False, True, False, True, False, True, None,
                   None, None, True, None, False, None]
    jax = _jax_cast(vals, "boolean")["x"].tolist()
    assert got == [None if pd.isna(v) else bool(v) for v in jax]


TO_STRING = {
    "int": ([0, -1, 7, 2147483647, -2147483648, None, 120, -45], "int"),
    "bigint": ([0, -9223372036854775808, 9223372036854775807, 10**12,
                -10**17, None], "bigint"),
    "boolean": ([True, False, None, True], "boolean"),
}


@pytest.mark.parametrize("name", list(TO_STRING))
def test_values_to_string(name):
    vals, dt = TO_STRING[name]
    s = TpuSession({}, device="cpu")
    df = s.create_dataframe({"v": vals}).select(
        TF.col("v").cast(dt).cast("string").alias("x"))
    assert "CpuFallbackExec" not in df.explain().split("==")[0]
    got = df.to_pandas()["x"].tolist()
    want = [None if v is None else str(v).lower() if isinstance(v, bool)
            else str(v) for v in vals]
    assert [None if pd.isna(v) else v for v in got] == want
    js = JaxSession({})
    try:
        jw = js.create_dataframe({"v": vals}).select(
            JF.col("v").cast(dt).cast("string").alias("x")).to_pandas()
    finally:
        js.stop()
    assert [None if pd.isna(v) else v for v in jw["x"]] == want


def test_dates_and_timestamps_to_string():
    days = [datetime.date(2000, 2, 29), datetime.date(1969, 12, 31),
            datetime.date(1, 1, 1), datetime.date(9999, 12, 31)]
    us = [0, 1, 123456, -1, 1_000_000 * 86399 + 100000,
          951782400 * 10**6 + 500]
    s = TpuSession({}, device="cpu")
    got = s.create_dataframe({"d": days}).select(
        TF.col("d").cast("string").alias("x")).to_pandas()["x"].tolist()
    assert got == [d.isoformat() for d in days]
    ts = pd.to_datetime(us, unit="us").to_numpy()
    got = s.create_dataframe({"t": ts}).select(
        TF.col("t").cast("string").alias("x")).to_pandas()["x"].tolist()

    def spark(u):
        t = UTC0 + datetime.timedelta(microseconds=u)
        frac = f".{t.microsecond:06d}".rstrip("0") if t.microsecond else ""
        return t.strftime("%Y-%m-%d %H:%M:%S") + frac
    assert got == [spark(u) for u in us]


@pytest.mark.parametrize("src, dst, reason", [
    ("double", "string", "cast double -> string needs shortest-round-trip "
     "float formatting (host fallback)"),
    ("decimal(7,2)", "string", "cast decimal(7,2) -> string needs "
     "shortest-round-trip float formatting (host fallback)"),
    ("string", "decimal(7,2)", "cast string -> decimal not supported on "
     "TPU")])
def test_fallback_casts_keep_jax_reasons(src, dst, reason):
    """The casts the card does not run keep the JAX package's reasons
    and run in the fallback with Spark's answers (a decimal keeps its
    scale's digits as a string, where the JAX package writes the
    double's)."""
    import decimal
    vals = ["1.25", "-3", "abc", None] if src == "string" else \
        [1.25, -3.0, 0.1, None]
    s = TpuSession({}, device="cpu")
    df = s.create_dataframe({"v": vals}).select(
        TF.col("v").cast(src).cast(dst).alias("x"))
    assert df.explain().splitlines()[0] == "CpuFallbackExec[Project]"
    assert reason in s.overrides.last_explain
    want = {"double": ["1.25", "-3.0", "0.1", None],
            "decimal(7,2)": ["1.25", "-3.00", "0.10", None],
            "string": [decimal.Decimal("1.25"), decimal.Decimal("-3.00"),
                       None, None]}[src]
    assert df.to_arrow().column("x").to_pylist() == want


@pytest.mark.parametrize("key, target", [
    ("spark.rapids.sql.castStringToFloat.enabled", "double"),
    ("spark.rapids.sql.castStringToTimestamp.enabled", "timestamp"),
    ("spark.rapids.sql.castStringToTimestamp.enabled", "date")])
def test_cast_gates_take_effect(key, target):
    """The conf gates send the cast to the fallback, with the same
    answer as the card's."""
    vals = ["1.5", "2020-01-02", " 3 ", None, "2020-01-02 03:04:05"]
    on, got_on = _cast(vals, target)
    off, got_off = _cast(vals, target, {key: "false"})
    assert "CpuFallbackExec" not in on.explain().split("==")[0]
    assert off.explain().splitlines()[0] == "CpuFallbackExec[Project]"
    assert f"disabled by {key}" in off.session.overrides.last_explain
    assert got_on == got_off
