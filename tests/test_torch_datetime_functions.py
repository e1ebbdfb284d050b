"""The PyTorch port's date and time functions (``ops/datetime_ops.py``)
against the JAX package and Python's ``datetime`` on the CPU.

The cases of the reference's ``tests/test_strings_datetime.py`` date
half: the date parts, ``last_day``, ``next_day``, the time parts of
timestamps and dates, ``add_months``, ``months_between``, ``trunc``, the
epoch seconds, ``from_unixtime`` and ``date_format`` inside and outside
its device subset, over dates across month ends and the leap days of
2000 and 2020 and timestamps with microseconds, with nulls.  Dates,
integers and strings equal Python's exactly and the JAX package's where
it keeps Spark's rule; ``months_between`` equals Spark's rule (the JAX
package divides the day difference by 31) within 1e-15 relative.
"""

import calendar
import datetime
import math

import numpy as np
import pandas as pd
import pytest
import torch

from test_torch_strings import _assert_same, _jax, _port
from test_torch_string_functions import _same_as_python, _values
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.api.session import TpuSession

EPOCH = datetime.date(1970, 1, 1)
UTC0 = datetime.datetime(1970, 1, 1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def dt_table(n=260, seed=17):
    rng = np.random.default_rng(seed)
    base = [datetime.date(2000, 2, 28), datetime.date(2020, 1, 30),
            datetime.date(2019, 12, 31), datetime.date(1969, 12, 30),
            datetime.date(2021, 4, 29), datetime.date(1999, 2, 27)]
    d = [base[i % len(base)] + datetime.timedelta(days=int(k))
         for i, k in enumerate(rng.integers(0, 4, n))]
    e = [x + datetime.timedelta(days=int(k))
         for x, k in zip(d, rng.integers(-70, 70, n))]
    for i in range(0, n, 13):
        d[i] = None
    us = rng.integers(-10**15, 2 * 10**15, n)
    ts = pd.to_datetime(us, unit="us").to_numpy()
    return {"d": d, "e": e, "ts": ts,
            "m": [int(v) for v in rng.integers(-30, 30, n)],
            "sec": [int(v) for v in rng.integers(-10**9, 3 * 10**9, n)],
            "txt": [None if i % 11 == 0 else
                    (UTC0 + datetime.timedelta(microseconds=int(v)))
                    .strftime("%Y-%m-%d %H:%M:%S") for i, v in
                    enumerate(us)]}


@pytest.fixture(scope="module")
def table():
    return dt_table()


def _micros(v):
    if isinstance(v, np.datetime64):
        return int(v.astype("datetime64[us]").astype(np.int64))
    return (v - EPOCH).days * 86_400_000_000


def _as_dt(us):
    return UTC0 + datetime.timedelta(microseconds=us)


def _d(fn, col="d"):
    return lambda t: [None if v is None else fn(v) for v in t[col]]


def _ts(fn):
    return lambda t: [fn(_as_dt(_micros(v))) for v in t["ts"]]


_DOW = {"MO": 0, "TU": 1, "WE": 2, "TH": 3, "FR": 4, "SA": 5, "SU": 6}


def _next_day(v, name):
    name = name.upper()
    full = {n: i for i, n in enumerate(calendar.day_name)}
    key = {**{k: i for k, i in _DOW.items()},
           **{n[:3].upper(): i for n, i in full.items()},
           **{n.upper(): i for n, i in full.items()}}.get(name)
    if key is None:
        return None
    ahead = (key - v.weekday() + 7) % 7 or 7
    return v + datetime.timedelta(days=ahead)


def _add_months(v, n):
    months = v.year * 12 + v.month - 1 + n
    y, m = divmod(months, 12)
    m += 1
    return datetime.date(y, m, min(v.day, calendar.monthrange(y, m)[1]))


def months_between(ua, ub, round_off=True):
    """Spark's ``DateTimeUtils.monthsBetween`` (UTC)."""
    a, b = _as_dt(ua), _as_dt(ub)
    diff = float((a.year * 12 + a.month) - (b.year * 12 + b.month))
    last = (a.day == calendar.monthrange(a.year, a.month)[1] and
            b.day == calendar.monthrange(b.year, b.month)[1])
    if a.day == b.day or last:
        return diff
    sa = a.hour * 3600 + a.minute * 60 + a.second
    sb = b.hour * 3600 + b.minute * 60 + b.second
    out = diff + ((a.day - b.day) * 86400 + sa - sb) / (31 * 86400)
    return math.floor(out * 1e8 + 0.5) / 1e8 if round_off else out


def _trunc(v, fmt):
    unit = {"year": "y", "yyyy": "y", "yy": "y", "month": "m", "mon": "m",
            "mm": "m", "quarter": "q", "week": "w"}.get(fmt.lower())
    if unit == "y":
        return datetime.date(v.year, 1, 1)
    if unit == "m":
        return datetime.date(v.year, v.month, 1)
    if unit == "q":
        return datetime.date(v.year, (v.month - 1) // 3 * 3 + 1, 1)
    if unit == "w":
        return v - datetime.timedelta(days=v.weekday())
    return None


CASES = {
    # name: (expression, Python's answer, the JAX package keeps Spark's rule)
    "quarter": (lambda F: F.quarter("d"),
                _d(lambda v: (v.month - 1) // 3 + 1), True),
    "dayofweek": (lambda F: F.dayofweek("d"),
                  _d(lambda v: (v.weekday() + 1) % 7 + 1), True),
    "weekday": (lambda F: F.weekday("d"), _d(lambda v: v.weekday()), True),
    "dayofyear": (lambda F: F.dayofyear("d"),
                  _d(lambda v: v.timetuple().tm_yday), True),
    "last_day": (lambda F: F.last_day("d"), _d(lambda v: v.replace(
        day=calendar.monthrange(v.year, v.month)[1])), True),
    "next_day_mo": (lambda F: F.next_day("d", "MO"),
                    _d(lambda v: _next_day(v, "MO")), True),
    "next_day_three": (lambda F: F.next_day("d", "Tue"),
                       _d(lambda v: _next_day(v, "Tue")), True),
    "next_day_full": (lambda F: F.next_day("d", "wednesday"),
                      _d(lambda v: _next_day(v, "wednesday")), True),
    "next_day_bad": (lambda F: F.next_day("d", "MONX"),
                     _d(lambda v: _next_day(v, "MONX")), False),
    "hour": (lambda F: F.hour("ts"), _ts(lambda x: x.hour), True),
    "minute": (lambda F: F.minute("ts"), _ts(lambda x: x.minute), True),
    "second": (lambda F: F.second("ts"), _ts(lambda x: x.second), True),
    "hour_of_date": (lambda F: F.hour(F.col("d").cast("timestamp")),
                     _d(lambda v: 0), True),
    "add_months": (lambda F: F.add_months("d", 1),
                   _d(lambda v: _add_months(v, 1)), True),
    "add_months_neg": (lambda F: F.add_months("d", -13),
                       _d(lambda v: _add_months(v, -13)), True),
    "add_months_col": (lambda F: F.add_months("e", F.col("m")),
                       lambda t: [_add_months(v, m) for v, m in
                                  zip(t["e"], t["m"])], True),
    "months_between_dates": (
        lambda F: F.months_between("e", "d"),
        lambda t: [None if b is None else months_between(
            _micros(a), _micros(b)) for a, b in zip(t["e"], t["d"])],
        False),
    "months_between_ts": (
        lambda F: F.months_between("ts", F.col("e").cast("timestamp")),
        lambda t: [months_between(_micros(a), _micros(b))
                   for a, b in zip(t["ts"], t["e"])], False),
    "trunc_year": (lambda F: F.trunc("d", "year"),
                   _d(lambda v: _trunc(v, "year")), True),
    "trunc_month": (lambda F: F.trunc("d", "MM"),
                    _d(lambda v: _trunc(v, "MM")), True),
    "trunc_quarter": (lambda F: F.trunc("d", "quarter"),
                      _d(lambda v: _trunc(v, "quarter")), True),
    "trunc_week": (lambda F: F.trunc("d", "week"),
                   _d(lambda v: _trunc(v, "week")), True),
    "trunc_bad": (lambda F: F.trunc("d", "day"),
                  _d(lambda v: _trunc(v, "day")), False),
    "unix_timestamp_date": (lambda F: F.unix_timestamp("d"),
                            _d(lambda v: (v - EPOCH).days * 86400), True),
    "unix_timestamp_ts": (lambda F: F.unix_timestamp("ts"),
                          lambda t: [_micros(v) // 10**6 for v in t["ts"]],
                          True),
    "to_unix_timestamp_text": (
        lambda F: F.to_unix_timestamp("txt"),
        lambda t: [None if v is None else int(
            (datetime.datetime.fromisoformat(v) - UTC0).total_seconds())
            for v in t["txt"]], True),
    "from_unixtime": (lambda F: F.from_unixtime("sec"),
                      lambda t: [_as_dt(v * 10**6).strftime(
                          "%Y-%m-%d %H:%M:%S") for v in t["sec"]], False),
    "date_format_ts": (lambda F: F.date_format("ts", "yyyy-MM-dd HH:mm:ss"),
                       _ts(lambda x: x.strftime("%Y-%m-%d %H:%M:%S")),
                       True),
    "date_format_month": (lambda F: F.date_format("d", "yyyy-MM"),
                          _d(lambda v: v.strftime("%Y-%m")), True),
    "date_format_dots": (lambda F: F.date_format("d", "dd.MM.yyyy"),
                         _d(lambda v: v.strftime("%d.%m.%Y")), True),
    "date_format_quoted": (lambda F: F.date_format("d", "yyyy'-'MM"),
                           _d(lambda v: v.strftime("%Y-%m")), False),
    "date_format_names": (lambda F: F.date_format("d", "EEE, d MMM yyyy"),
                          _d(lambda v: f"{v.strftime('%a')}, {v.day} "
                             f"{v.strftime('%b %Y')}"), False),
}


@pytest.mark.parametrize("name", list(CASES))
def test_datetime_function_parity(name, table):
    build_expr, oracle, jax_keeps_spark = CASES[name]

    def build(F, df):
        return df.select(build_expr(F).alias("x"))
    got = _port(build, table)
    want = oracle(table)
    vals = _values(got["x"])
    if name.startswith("months_between"):
        for i, (g, w) in enumerate(zip(vals, want)):
            assert (g is None) == (w is None) or (w is None and
                                                  math.isnan(g)), i
            if w is not None:
                assert abs(g - w) <= 1e-15 * abs(w), (i, g, w)
        return
    vals = [v.date() if isinstance(v, pd.Timestamp) else v for v in vals]
    _same_as_python(vals, want)
    if jax_keeps_spark:
        # the JAX package takes no null in a list of dates
        nn = dict(table, d=[a if a is not None else b
                            for a, b in zip(table["d"], table["e"])])
        _assert_same(_port(build, nn), _jax(build, nn))


def test_from_unixtime_formats_jax_timestamp(table):
    """The port's from_unixtime is Spark's string; the JAX package's is
    a timestamp of the same instant."""
    got = _port(lambda F, df: df.select(F.from_unixtime("sec").alias("x")),
                table)
    want = _jax(lambda F, df: df.select(F.from_unixtime("sec").alias("x")),
                table)
    assert got["x"].tolist() == [
        pd.Timestamp(v).strftime("%Y-%m-%d %H:%M:%S") for v in want["x"]]


def test_date_format_subset_tags(table):
    """A pattern letter outside yyyy/MM/dd/HH/mm/ss (a quoted one too, as
    in the JAX package) sends the Project to the CPU fallback with the
    JAX package's reason."""
    s = TpuSession({}, device="cpu")
    df = s.create_dataframe(table)
    on = df.select(TF.date_format("d", "yyyy-MM").alias("x"))
    assert "CpuFallbackExec" not in on.explain().split("==")[0]
    for fmt in ("EEE, d MMM yyyy", "yyyy'T'MM"):
        off = df.select(TF.date_format("d", fmt).alias("x"))
        assert off.explain().splitlines()[0] == "CpuFallbackExec[Project]"
        assert (f"date_format pattern {fmt!r} outside the fixed-width "
                "device subset (yyyy/MM/dd/HH/mm/ss)") in \
            s.overrides.last_explain


FALLBACK_CASES = {
    "quarter": "Quarter", "dayofweek": "DayOfWeek", "weekday": "WeekDay",
    "dayofyear": "DayOfYear", "last_day": "LastDay",
    "next_day_three": "NextDay", "next_day_bad": "NextDay",
    "hour": "Hour", "minute": "Minute", "second": "Second",
    "add_months_col": "AddMonths", "months_between_dates": "MonthsBetween",
    "months_between_ts": "MonthsBetween", "trunc_quarter": "TruncDate",
    "trunc_week": "TruncDate", "trunc_bad": "TruncDate",
    "unix_timestamp_ts": "UnixTimestamp", "from_unixtime": "FromUnixTime",
    "date_format_ts": "DateFormatClass",
    "date_format_quoted": "DateFormatClass",
}


@pytest.mark.parametrize("name", list(FALLBACK_CASES))
def test_fallback_equals_device(name, table):
    cls = FALLBACK_CASES[name]
    build_expr = CASES[name][0]

    def build(F, df):
        return df.select(build_expr(F).alias("x"))
    off = TpuSession({f"spark.rapids.sql.expression.{cls}": "false"},
                     device="cpu")
    df = build(TF, off.create_dataframe(table))
    assert df.explain().splitlines()[0] == "CpuFallbackExec[Project]"
    got, want = df.to_pandas(), _port(build, table)
    if name.startswith("months_between"):
        np.testing.assert_allclose(got["x"].to_numpy(dtype=float),
                                   want["x"].to_numpy(dtype=float),
                                   rtol=1e-15, atol=0)
        return
    _assert_same(got, want)


def test_time_add():
    """TimeAdd (a timestamp plus an interval in microseconds), built as
    an expression as the JAX package builds it."""
    from spark_rapids_tpu_torch.ops import datetime_ops as D
    from spark_rapids_tpu_torch.ops.expressions import Literal
    s = TpuSession({}, device="cpu")
    ts = pd.to_datetime([0, 10**12, -5 * 10**11], unit="us").to_numpy()
    df = s.create_dataframe({"t": ts})
    got = df.select(TF.Col(D.TimeAdd(TF.col("t").expr,
                                     Literal(90_000_000))).alias("x"))
    out = got.to_pandas()["x"]
    assert [int(pd.Timestamp(v).value // 1000) for v in out] == \
        [90_000_000, 10**12 + 90_000_000, -5 * 10**11 + 90_000_000]
