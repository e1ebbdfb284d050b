"""CPU fallback operator.

Counterpart of ``spark_rapids_tpu/exec/fallback.py``: a logical node the
planner tagged off the device (``plan/overrides.py``) runs on the host in
pandas, between device operators, as the reference leaves an unconverted
Spark operator on the CPU.  The data crosses the device boundary once each
way (the GpuColumnarToRow / RowToColumnar transition pair):

- a child batch leaves the card through ``ColumnarBatch.to_arrow`` (one
  counted fetch in ``utils/hostsync.py`` per batch);
- a result goes back through ``ColumnarBatch.from_arrow`` and the pinned
  staging path (``columnar/column.stage_parts``) onto the exec's device:
  string columns as device string columns, dates and timestamps as their
  int32 day and int64 microsecond encodings.

Per-row nodes (Project, Filter, Limit, Union, Expand, and the probe side
of inner and left joins) stream one child batch at a time; an aggregate
folds each chunk into per-group partial states (sum, count, min, max)
merged as it goes; only a sort and the build side of a join hold a whole
child, and a sort of more than ``SORT_RUN_ROWS`` rows spills sorted runs
as parquet to a temporary directory and merges them.  A fallback node
registers nothing in the spill catalog: what it holds lives in host
frames.

Host frames keep the device's storage: integers, booleans and floats as
pandas' nullable (masked) types, so an integer column with nulls stays
exact instead of turning float; dates as int32 days and timestamps as
int64 microseconds; strings as arrow-backed pandas strings.  Expressions
evaluate over numpy arrays and their validity (``_eval``) with the
device's semantics: Kleene AND / OR, integer overflow that wraps, null
for a division by zero, Java's remainder, NaN as the largest float, LIKE
through arrow's ``match_like``, and the JAX package's string casts (its
device parse and format rules, and its CPU formatting of floats).  The
JAX package's fallback builds pandas frames with numpy types instead, so
an integer column with nulls becomes float there and loses precision past
2^53; its ``_build_batch`` then fills those nulls with 0 before the cast.

Where the JAX package raises, the port raises the same reason: a right or
full join with a residual condition, a semi or anti join, a Window or
Range node, and an expression this module cannot evaluate.
"""

from __future__ import annotations

import datetime
from typing import Iterator, List, Optional, Sequence

import numpy as np
import pandas as pd

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, empty_batch
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.exec.base import Schema, TpuExec
from spark_rapids_tpu_torch.plan import logical as L

US_PER_DAY = 86_400_000_000
US_PER_SEC = 1_000_000

# host ns a fallback node spends waiting on its children's batches, moving
# them to host frames (to_arrow and the frame), and moving its results to
# the device (from_arrow and the upload); its own pandas time is the rest
# of opTime
CHILD_TIME = "childTime"
TO_HOST_TIME = "toHostTime"
TO_DEVICE_TIME = "toDeviceTime"


# ------------------------------------------------------- arrow <-> pandas --

def _pd_types():
    import pyarrow as pa
    return {pa.bool_(): pd.BooleanDtype(), pa.int8(): pd.Int8Dtype(),
            pa.int16(): pd.Int16Dtype(), pa.int32(): pd.Int32Dtype(),
            pa.int64(): pd.Int64Dtype(), pa.float32(): pd.Float32Dtype(),
            pa.float64(): pd.Float64Dtype(),
            pa.string(): pd.StringDtype("pyarrow"),
            pa.large_string(): pd.StringDtype("pyarrow")}


def arrow_to_frame(table) -> pd.DataFrame:
    """A host frame of an arrow table in the device's storage: dates as
    int32 days, timestamps as int64 microseconds, nullable numbers."""
    import pyarrow as pa
    cols = []
    for col in table.columns:
        t = col.type
        if pa.types.is_dictionary(t):
            col = col.cast(t.value_type)
            t = col.type
        if pa.types.is_date32(t):
            col = col.cast(pa.int32())
        elif pa.types.is_timestamp(t):
            col = col.cast(pa.timestamp("us", tz=t.tz)).cast(pa.int64())
        cols.append(col)
    # positional names: a joined schema may repeat a name
    tmp = pa.table(cols, names=[f"c{i}" for i in range(len(cols))])
    df = tmp.to_pandas(types_mapper=_pd_types().get)
    for i, col in enumerate(cols):
        if pa.types.is_floating(col.type):
            # pandas' own conversion turns NaN into a null; Spark keeps
            # them apart
            df[f"c{i}"] = _float_array(col)
    df.columns = list(table.column_names)
    return df


def _float_array(col):
    """An arrow float column as a pandas FloatingArray whose mask is the
    column's nulls only (NaN stays a value)."""
    import pyarrow as pa
    import pyarrow.compute as pc
    if isinstance(col, pa.ChunkedArray):
        col = col.combine_chunks() if col.num_chunks != 1 else col.chunk(0)
    mask = pc.is_null(col).to_numpy(zero_copy_only=False)
    values = pc.fill_null(col, 0.0).to_numpy(zero_copy_only=False)
    return pd.arrays.FloatingArray(values, mask.astype(np.bool_))


def _masked(values: np.ndarray, valid: np.ndarray, dt: DataType):
    """A pandas nullable array of storage values and their validity."""
    mask = ~valid
    if dt.is_boolean:
        return pd.arrays.BooleanArray(values.astype(np.bool_), mask)
    if dt.is_floating:
        return pd.arrays.FloatingArray(values.astype(dt.storage), mask)
    return pd.arrays.IntegerArray(values.astype(dt.storage), mask)


class _V:
    """A column on the host while an expression evaluates: numpy storage
    values (a pyarrow string array for strings) and a validity mask."""

    __slots__ = ("dt", "values", "valid")

    def __init__(self, dt: DataType, values, valid: np.ndarray):
        self.dt = dt
        self.values = values
        self.valid = valid

    def __len__(self):
        return len(self.valid)

    def series(self, index=None) -> pd.Series:
        if self.dt.is_string:
            arr = _with_nulls(self.values, self.valid)
            return pd.Series(pd.array(arr, dtype=pd.StringDtype("pyarrow")),
                             index=index)
        return pd.Series(_masked(self.values, self.valid, self.dt),
                         index=index)


def _with_nulls(arr, valid: np.ndarray):
    """``arr`` with nulls where ``valid`` is False."""
    import pyarrow as pa
    import pyarrow.compute as pc
    if valid.all():
        return arr
    return pc.if_else(pa.array(valid), arr, pa.scalar(None, arr.type))


def _lstr(arr):
    """A string array as one chunk of ``large_string`` (every string
    value of an evaluation has this one type)."""
    import pyarrow as pa
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks() if arr.num_chunks != 1 else arr.chunk(0)
    return arr.cast(pa.large_string())


def _str_list(v: _V) -> list:
    return [s if ok else None
            for s, ok in zip(v.values.to_pylist(), v.valid)]


def _from_series(s: pd.Series, dt: DataType) -> _V:
    """A frame column as values and validity of type ``dt``."""
    import pyarrow as pa
    valid = ~s.isna().to_numpy(dtype=np.bool_)
    if dt.is_string:
        return _V(dt, _lstr(pa.array(s, from_pandas=True)), valid)
    return _V(dt, s.to_numpy(dtype=dt.storage, na_value=0), valid)


def _full(dt: DataType, n: int, value) -> _V:
    """A literal repeated over ``n`` rows (``None`` is null)."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.ops.expressions import literal_storage_value
    if value is None:
        valid = np.zeros(n, dtype=np.bool_)
        if dt.is_string:
            return _V(dt, pa.nulls(n, pa.large_string()), valid)
        return _V(dt, np.zeros(n, dtype=dt.storage), valid)
    valid = np.ones(n, dtype=np.bool_)
    if dt.is_string:
        return _V(dt, pa.array([str(value)] * n, type=pa.large_string()),
                  valid)
    return _V(dt, np.full(n, literal_storage_value(value, dt),
                          dtype=dt.storage), valid)


# ------------------------------------------------------ expression eval --

def _isnull(v) -> bool:
    return v is None or v is pd.NA or (
        isinstance(v, (float, np.floating)) and np.isnan(v))


def _implicit(v: _V, target: DataType) -> _V:
    """Implicit widening (``ops/expressions.cast_value``): a date meets a
    timestamp at midnight UTC."""
    if v.dt.name == target.name:
        return v
    if v.dt.is_date and target.is_timestamp:
        return _V(target, v.values.astype(np.int64) * US_PER_DAY, v.valid)
    return _V(target, v.values.astype(target.storage), v.valid)


def _align_datetime_operands(l: _V, r: _V):
    """Both operands of a comparison in one storage: numbers widen, and a
    date meets a timestamp as a timestamp (its day at midnight UTC), as
    ``ops/expressions.promote_types`` has it."""
    from spark_rapids_tpu_torch.ops.expressions import promote_types
    t = promote_types(l.dt, r.dt)
    return _implicit(l, t), _implicit(r, t)


def _compare(name: str, l: _V, r: _V) -> np.ndarray:
    """The comparison's values (validity is both operands')."""
    if l.dt.is_string:
        import pyarrow.compute as pc
        fn = {"EqualTo": pc.equal, "LessThan": pc.less,
              "LessThanOrEqual": pc.less_equal, "GreaterThan": pc.greater,
              "GreaterThanOrEqual": pc.greater_equal}[name]
        out = fn(l.values, r.values).fill_null(False)
        return out.to_numpy(zero_copy_only=False).astype(np.bool_)
    l, r = _align_datetime_operands(l, r)
    a, b = l.values, r.values
    with np.errstate(invalid="ignore"):
        if name == "EqualTo":
            out = a == b
        elif name == "LessThan":
            out = a < b
        elif name == "LessThanOrEqual":
            out = a <= b
        elif name == "GreaterThan":
            out = a > b
        else:
            out = a >= b
    if l.dt.is_floating:  # NaN = NaN, and NaN is the largest value
        na, nb = np.isnan(a), np.isnan(b)
        if name == "EqualTo":
            out = out | (na & nb)
        elif name == "LessThan":
            out = np.where(na, False, np.where(nb, True, out))
        elif name == "LessThanOrEqual":
            out = np.where(na, nb, np.where(nb, True, out))
        elif name == "GreaterThan":
            out = np.where(na, ~nb, np.where(nb, False, out))
        else:
            out = np.where(na, True, np.where(nb, False, out))
    return out


def _arith(e, l: _V, r: _V) -> _V:
    from spark_rapids_tpu_torch.ops import arithmetic as A
    t = e.operand_type()
    l, r = _implicit(l, t), _implicit(r, t)
    a, b = l.values, r.values
    valid = l.valid & r.valid
    with np.errstate(all="ignore"):
        if isinstance(e, A.Add):
            out = a + b
        elif isinstance(e, A.Subtract):
            out = a - b
        elif isinstance(e, A.Multiply):
            out = a * b
        elif isinstance(e, A.Divide):
            zero = b == 0
            out = a / np.where(zero, 1, b)
            valid = valid & ~zero
        elif isinstance(e, A.IntegralDivide):
            zero, minus_one = b == 0, b == -1
            safe = np.where(zero | minus_one, 1, b)
            q = np.floor_divide(a, safe)
            # truncate toward zero
            q = q + ((np.remainder(a, safe) != 0) &
                     ((a < 0) != (safe < 0))).astype(q.dtype)
            out = np.where(minus_one, -a, q)
            valid = valid & ~zero
        elif isinstance(e, A.Remainder):
            zero = b == 0
            safe = np.where(zero, 1, b)
            if not l.dt.is_floating:
                safe = np.where(b == -1, 1, safe)
            out = np.fmod(a, safe)
            valid = valid & ~zero
        elif isinstance(e, A.BitwiseAnd):
            out = a & b
        else:
            raise NotImplementedError(
                f"CPU fallback cannot evaluate {type(e).__name__}")
    return _V(e.dtype, np.asarray(out).astype(e.dtype.storage), valid)


def _civil_from_days(days: np.ndarray):
    """(year, month, day) of days since 1970-01-01 (proleptic Gregorian,
    the device's ``_civil_from_days``)."""
    z = days.astype(np.int64) + 719468
    era = np.floor_divide(z, 146097)
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + np.where(mp < 10, 3, -9)
    return y + (m <= 2), m, d


def _to_days(v: _V) -> np.ndarray:
    if v.dt.is_timestamp:
        return np.floor_divide(v.values, US_PER_DAY)
    return v.values.astype(np.int64)


def _eval(expr, df: pd.DataFrame) -> _V:
    """Host evaluation of a bound expression over a frame's columns."""
    import pyarrow as pa
    import pyarrow.compute as pc
    from spark_rapids_tpu_torch.exec.expand import NullLiteral
    from spark_rapids_tpu_torch.ops import arithmetic as A
    from spark_rapids_tpu_torch.ops import datetime_ops as D
    from spark_rapids_tpu_torch.ops import predicates as P
    from spark_rapids_tpu_torch.ops import stringops as S
    from spark_rapids_tpu_torch.ops.cast import Cast
    from spark_rapids_tpu_torch.ops.expressions import (
        Alias, BoundReference, Literal)

    e = expr
    n = len(df)
    if isinstance(e, Alias):
        return _eval(e.child, df)
    if isinstance(e, BoundReference):
        return _from_series(df.iloc[:, e.ordinal], e.dtype)
    if isinstance(e, Literal):
        return _full(e.dtype, n, e.value)
    if isinstance(e, NullLiteral):
        return _full(e.dtype, n, None)
    if isinstance(e, P._Comparison):
        l, r = _eval(e.left, df), _eval(e.right, df)
        return _V(e.dtype, _compare(type(e).__name__, l, r),
                  l.valid & r.valid)
    if isinstance(e, (A.Add, A.Subtract, A.Multiply, A.Divide,
                      A.IntegralDivide, A.Remainder, A.BitwiseAnd)):
        return _arith(e, _eval(e.left, df), _eval(e.right, df))
    if isinstance(e, A.ShiftRight):
        l, r = _eval(e.left, df), _eval(e.right, df)
        bits = l.values.dtype.itemsize * 8
        amount = (r.values.astype(np.int32) & (bits - 1)).astype(
            l.values.dtype)
        return _V(e.dtype, l.values >> amount, l.valid & r.valid)
    if isinstance(e, A.UnaryMinus):
        c = _eval(e.child, df)
        with np.errstate(all="ignore"):
            return _V(e.dtype, -c.values, c.valid)
    if isinstance(e, A.Abs):
        c = _eval(e.child, df)
        with np.errstate(all="ignore"):
            return _V(e.dtype, np.abs(c.values), c.valid)
    if isinstance(e, (P.And, P.Or)):
        l, r = _eval(e.left, df), _eval(e.right, df)
        lv, rv = l.valid, r.valid
        if isinstance(e, P.And):
            vals = l.values & r.values
            valid = (lv & rv) | (lv & ~l.values) | (rv & ~r.values)
        else:
            vals = l.values | r.values
            valid = (lv & rv) | (lv & l.values) | (rv & r.values)
        return _V(dts.BOOL, vals & valid, valid)
    if isinstance(e, P.Not):
        c = _eval(e.child, df)
        return _V(dts.BOOL, ~c.values & c.valid, c.valid)
    if isinstance(e, (P.IsNull, P.IsNotNull)):
        c = _eval(e.child, df)
        vals = ~c.valid if isinstance(e, P.IsNull) else c.valid.copy()
        return _V(dts.BOOL, vals, np.ones(n, dtype=np.bool_))
    if isinstance(e, P.Coalesce):
        return _select([(c.valid, c) for c in
                        (_eval(x, df) for x in e.children)], e.dtype, n)
    if isinstance(e, P.If):
        cond = _eval(e.children[0], df)
        return _select([(cond.values & cond.valid,
                         _eval(e.children[1], df)),
                        (np.ones(n, dtype=np.bool_),
                         _eval(e.children[2], df))], e.dtype, n)
    if isinstance(e, P.CaseWhen):
        arms = []
        for p, v in e.branches:
            cond = _eval(p, df)
            arms.append((cond.values & cond.valid, _eval(v, df)))
        arms.append((np.ones(n, dtype=np.bool_), _eval(e._else(), df)))
        return _select(arms, e.dtype, n)
    if isinstance(e, (P.In, P.InSet)):
        return _eval_in(e, df)
    if isinstance(e, Cast):
        return _cast(_eval(e.child, df), e.target)
    if isinstance(e, S._PatternPredicate):
        c = _eval(e.child, df)
        arr = c.values
        if isinstance(e, S.Like):
            out = pc.match_like(arr, e.pattern)
        elif isinstance(e, S.StartsWith):
            out = pc.starts_with(arr, e.pattern)
        elif isinstance(e, S.EndsWith):
            out = pc.ends_with(arr, e.pattern)
        elif isinstance(e, S.Contains):
            out = pc.match_substring(arr, e.pattern)
        else:
            out = pc.equal(arr, pa.scalar(e.pattern, arr.type))
        return _V(dts.BOOL, out.fill_null(False).to_numpy(
            zero_copy_only=False).astype(np.bool_) & c.valid, c.valid)
    if isinstance(e, S.Substring):
        c = _eval(e.child, df)
        vals = [None if s is None else _substring(s, e.pos, e.length)
                for s in _str_list(c)]
        return _V(dts.STRING, pa.array(vals, type=pa.large_string()),
                  c.valid)
    if isinstance(e, (D.Year, D.Month, D.DayOfMonth)):
        c = _eval(e.child, df)
        y, m, d = _civil_from_days(_to_days(c))
        part = {D.Year: y, D.Month: m, D.DayOfMonth: d}[type(e)]
        return _V(dts.INT32, part.astype(np.int32), c.valid)
    if isinstance(e, (D.DateAdd, D.DateSub)):
        l, r = _eval(e.left, df), _eval(e.right, df)
        out = _to_days(l).astype(np.int32) + \
            e.sign * r.values.astype(np.int32)
        return _V(dts.DATE32, out.astype(np.int32), l.valid & r.valid)
    if isinstance(e, D.DateDiff):
        l, r = _eval(e.left, df), _eval(e.right, df)
        return _V(dts.INT32, (_to_days(l) - _to_days(r)).astype(np.int32),
                  l.valid & r.valid)
    raise NotImplementedError(
        f"CPU fallback cannot evaluate {type(e).__name__}")


def _eval_pandas(expr, df: pd.DataFrame) -> pd.Series:
    """``expr`` over ``df`` as a pandas Series (nullable storage types)."""
    return _eval(expr, df).series(df.index)


def _select(arms, dt: DataType, n: int) -> _V:
    """Per row, the value of the first arm whose mask holds (CASE, IF and
    COALESCE: each arm a (mask, value) pair, the last one always
    taken)."""
    import pyarrow as pa
    import pyarrow.compute as pc
    taken = np.zeros(n, dtype=np.bool_)
    valid = np.zeros(n, dtype=np.bool_)
    if dt.is_string:
        out = pa.nulls(n, pa.large_string())
        for mask, v in arms:
            pick = mask & ~taken
            out = pc.if_else(pa.array(pick), v.values, out)
            valid = np.where(pick, v.valid, valid)
            taken |= pick
        return _V(dt, out, valid)
    out = np.zeros(n, dtype=dt.storage)
    for mask, v in arms:
        pick = mask & ~taken
        v = _implicit(v, dt) if v.dt.name != dt.name else v
        out = np.where(pick, v.values, out)
        valid = np.where(pick, v.valid, valid)
        taken |= pick
    return _V(dt, out.astype(dt.storage), valid)


def _eval_in(e, df) -> _V:
    """IN and InSet under Spark's null rule: a match is true; no match
    with a null option is null; a null value is null."""
    import pyarrow as pa
    import pyarrow.compute as pc
    from spark_rapids_tpu_torch.ops import predicates as P
    from spark_rapids_tpu_torch.ops.expressions import Literal
    c = _eval(e.children[0], df)
    n = len(c)
    if isinstance(e, P.InSet):
        options = [x for x in e.table.tolist()]
        has_null = e.has_null
    else:
        options, has_null = [], False
        for o in e.children[1:]:
            if not isinstance(o, Literal):
                raise NotImplementedError(
                    "CPU fallback cannot evaluate IN over non-literal "
                    "options")
            if o.value is None:
                has_null = True
            else:
                options.append(o.value)
    if c.dt.is_string:
        hit = pc.is_in(c.values, value_set=pa.array(
            [str(x) for x in options], type=pa.large_string()))
        hit = hit.fill_null(False).to_numpy(zero_copy_only=False)
    else:
        from spark_rapids_tpu_torch.ops.expressions import \
            literal_storage_value
        table = np.array([literal_storage_value(x, c.dt) for x in options])
        hit = np.isin(c.values, table) if len(table) else \
            np.zeros(n, dtype=np.bool_)
    hit = hit.astype(np.bool_)
    valid = c.valid & (hit | (not has_null))
    return _V(dts.BOOL, hit & valid, valid)


def _substring(v: str, pos: int, ln: int) -> str:
    """Spark ``substring`` over characters (pos 1-based; 0 reads as 1; a
    negative pos counts from the end)."""
    if ln < 0:
        return ""
    if pos > 0:
        start = pos - 1
    elif pos == 0:
        start = 0
    else:
        start = len(v) + pos
        end = start + ln
        return v[max(start, 0):max(end, 0)]
    return v[start:start + ln]


# ------------------------------------------------------------------- casts --

_BOOL_TRUE = ("true", "t", "yes", "y", "1")
_BOOL_FALSE = ("false", "f", "no", "n", "0")
_MAX_NUM_BYTES = 24


def _parse_number(s: str, integral: bool):
    """The JAX package's device parse: an optional sign, digits and at
    most one dot, at most 24 bytes; an integer target takes no dot."""
    b = s.encode("utf-8")
    if not b or len(b) > _MAX_NUM_BYTES:
        return None
    neg = b[:1] == b"-"
    body = b[1:] if b[:1] in (b"-", b"+") else b
    if not body:
        return None
    val, frac, scale, seen_dot, has_digit = 0, 0, 0, False, False
    for ch in body:
        if 48 <= ch <= 57:
            has_digit = True
            if seen_dot:
                frac = frac * 10 + (ch - 48)
                scale += 1
            else:
                val = val * 10 + (ch - 48)
        elif ch == 46 and not seen_dot:
            seen_dot = True
        else:
            return None
    if not has_digit or (integral and seen_dot):
        return None
    if integral:
        return -val if neg else val
    f = float(val) + float(frac) / (10.0 ** scale)
    return -f if neg else f


def _days_from_civil(y: int, m: int, d: int) -> int:
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


def _parse_date(s: str):
    """yyyy-MM-dd, exactly."""
    if len(s) != 10 or s[4] != "-" or s[7] != "-" or \
            not (s[:4] + s[5:7] + s[8:]).isdigit() or not s.isascii():
        return None
    try:
        return _days_from_civil(int(s[:4]), int(s[5:7]), int(s[8:]))
    except ValueError:
        return None


def _parse_timestamp(s: str):
    """'yyyy-MM-dd[( |T)HH:mm:ss[.f{1,6}]]' in UTC, as microseconds."""
    if not s.isascii():
        return None
    days = _parse_date(s[:10]) if len(s) >= 10 else None
    if days is None:
        return None
    if len(s) == 10:
        return days * US_PER_DAY
    if len(s) < 19 or s[10] not in " T" or s[13] != ":" or s[16] != ":":
        return None
    hh, mi, ss = s[11:13], s[14:16], s[17:19]
    if not (hh + mi + ss).isdigit():
        return None
    hh, mi, ss = int(hh), int(mi), int(ss)
    if hh > 23 or mi > 59 or ss > 59:
        return None
    micros = days * US_PER_DAY + (hh * 3600 + mi * 60 + ss) * US_PER_SEC
    if len(s) == 19:
        return micros
    frac = s[20:]
    if len(s) > 26 or s[19] != "." or not frac or not frac.isdigit():
        return None
    return micros + int(frac) * 10 ** (6 - len(frac))


def _parse_bool(s: str):
    b = s.encode("utf-8")
    if len(b) > 16:
        return None
    t = b.strip(bytes(range(0x21))).decode("utf-8", "replace").lower()
    if t in _BOOL_TRUE:
        return True
    if t in _BOOL_FALSE:
        return False
    return None


def _format_dates(days: np.ndarray) -> List[str]:
    """yyyy-MM-dd of days since the epoch."""
    y, m, d = _civil_from_days(days)
    return [f"{a % 10000:04d}-{b:02d}-{c:02d}"
            for a, b, c in zip(y.tolist(), m.tolist(), d.tolist())]


def _format_timestamps(us: np.ndarray) -> List[str]:
    """yyyy-MM-dd HH:mm:ss[.f] of microseconds since the epoch, the
    fraction's trailing zeros cut (Spark's cast to string)."""
    days = np.floor_divide(us, US_PER_DAY)
    secs, micros = np.divmod(us - days * US_PER_DAY, US_PER_SEC)
    out = []
    for date, sec, frac in zip(_format_dates(days), secs.tolist(),
                               micros.tolist()):
        text = f"{date} {sec // 3600:02d}:{(sec // 60) % 60:02d}:" \
            f"{sec % 60:02d}"
        out.append(text + "." + f"{frac:06d}".rstrip("0") if frac
                   else text)
    return out


def _format_float(v: float) -> str:
    """The JAX package's CPU formatting of a float (Java's for the common
    cases)."""
    import math
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "Infinity" if v > 0 else "-Infinity"
    if v == int(v) and abs(v) < 1e16:
        return f"{v:.1f}"
    return str(v)


def _cast(c: _V, t: DataType) -> _V:
    """Non-ANSI cast (Spark's default): a value that does not parse is
    null."""
    import pyarrow as pa
    src = c.dt
    if src.name == t.name:
        return c
    n = len(c)
    if src.is_string:
        parse = (lambda s: _parse_number(s, True)) if t.is_integral else \
            (lambda s: _parse_number(s, False)) if t.is_floating else \
            _parse_date if t.is_date else \
            _parse_timestamp if t.is_timestamp else \
            _parse_bool if t.is_boolean else None
        if parse is None:
            raise NotImplementedError(f"CPU fallback cast {src} -> {t}")
        got = [None if s is None else parse(s) for s in _str_list(c)]
        valid = np.array([g is not None for g in got], dtype=np.bool_)
        vals = np.array([0 if g is None else g for g in got],
                        dtype=np.float64 if t.is_floating else object)
        if not t.is_floating:
            vals = np.array([int(x) & ((1 << 64) - 1) for x in vals],
                            dtype=np.uint64).view(np.int64) \
                if len(vals) else np.zeros(0, dtype=np.int64)
        return _V(t, vals.astype(t.storage), valid)
    if t.is_string:
        if src.is_date:
            text = _format_dates(c.values)
        elif src.is_timestamp:
            text = _format_timestamps(c.values)
        elif src.is_boolean:
            text = ["true" if x else "false" for x in c.values.tolist()]
        elif src.is_floating:
            text = [_format_float(x) for x in c.values.tolist()]
        else:
            text = [str(x) for x in c.values.tolist()]
        vals = [x if ok else None for x, ok in zip(text, c.valid)]
        return _V(t, pa.array(vals, type=pa.large_string()), c.valid)
    v = c.values
    with np.errstate(all="ignore"):
        if t.is_boolean:
            out = v != 0
        elif src.is_boolean:
            out = v.astype(t.storage)
        elif src.is_floating and t.is_integral:
            f = np.trunc(np.where(np.isnan(v), 0.0, v)).astype(np.float64)
            i64 = np.clip(f, -9.2233720368547e18,
                          9.2233720368547e18).astype(np.int64)
            i64 = np.where(f >= float(1 << 63), (1 << 63) - 1, i64)
            i64 = np.where(f <= -float(1 << 63), -(1 << 63), i64)
            out = _saturate(i64, t)
        elif src.is_date and t.is_timestamp:
            out = v.astype(np.int64) * US_PER_DAY
        elif src.is_timestamp and t.is_date:
            out = np.floor_divide(v, US_PER_DAY)
        elif src.is_integral and t.is_timestamp:
            out = v.astype(np.int64) * US_PER_SEC
        elif src.is_timestamp and t.is_integral:
            out = _saturate(np.floor_divide(v, US_PER_SEC), t)
        elif src.is_timestamp and t.is_floating:
            out = v.astype(t.storage) / US_PER_SEC
        elif src.is_floating and t.is_timestamp:
            out = np.trunc(v.astype(np.float64) * US_PER_SEC)
        else:
            out = v
    return _V(t, np.asarray(out).astype(t.storage), c.valid)


def _saturate(v: np.ndarray, t: DataType) -> np.ndarray:
    info = np.iinfo(t.storage)
    return np.clip(v, info.min, info.max)


# ------------------------------------------------------------- sort keys --

class _Neg:
    """Order-inverting wrapper so descending keys ride the ascending
    k-way merge (for any comparable type)."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, o):
        return o.v < self.v

    def __eq__(self, o):
        return self.v == o.v


# ------------------------------------------------------ aggregate partials --

def _agg_partial(funcs, keys: List[_V], children: List[Optional[_V]],
                 n: int) -> pd.DataFrame:
    """One chunk's per-group partial states: the keys as ``k<i>`` and per
    aggregate its buffers (``s<j>`` a sum or min or max, ``n<j>`` the
    count of non-null inputs)."""
    cols = {f"k{i}": k.series() for i, k in enumerate(keys)}
    spec = {}
    for j, (func, c) in enumerate(zip(funcs, children)):
        valid = np.ones(n, dtype=np.bool_) if c is None else c.valid
        cols[f"n{j}"] = valid.astype(np.int64)
        spec[f"n{j}"] = "sum"
        if func.name == "count":
            continue
        if func.name == "avg":
            cols[f"s{j}"] = _V(dts.FLOAT64, c.values.astype(np.float64),
                               c.valid).series()
            spec[f"s{j}"] = "sum"
        else:
            cols[f"s{j}"] = (_V(func.result_dtype,
                                c.values.astype(func.result_dtype.storage),
                                c.valid) if func.name == "sum"
                             else c).series()
            spec[f"s{j}"] = "sum" if func.name == "sum" else func.name
    frame = pd.DataFrame(cols)
    return _merge_partials(frame, len(keys), spec)


def _merge_partials(frame: pd.DataFrame, nkeys: int, spec) -> pd.DataFrame:
    """Partial states reduced per group: sums and counts add, min and max
    take theirs.  A sum over no non-null input stays null."""
    if nkeys == 0:
        row = {}
        for col, how in spec.items():
            s = frame[col]
            row[col] = getattr(s, how)(skipna=True, **(
                {"min_count": 1} if how == "sum" else {}))
        return pd.DataFrame({k: pd.array([v], dtype=frame[k].dtype)
                             if not _isnull(v) else
                             pd.array([None], dtype=frame[k].dtype)
                             for k, v in row.items()})
    by = [f"k{i}" for i in range(nkeys)]
    g = frame.groupby(by, dropna=False, sort=False)
    parts = []
    for col, how in spec.items():
        if how == "sum":
            parts.append(g[col].sum(min_count=1))
        else:
            parts.append(getattr(g[col], how)())
    out = pd.concat(parts, axis=1).reset_index()
    return out[list(frame.columns)]


# --------------------------------------------------------------- the exec --

def host_runnable(node: L.LogicalPlan) -> bool:
    """Whether ``CpuFallbackExec`` has a branch for ``node`` (the
    optimizer reverts only such nodes)."""
    from spark_rapids_tpu_torch.exec.expand import Expand
    if isinstance(node, L.Join):
        return node.join_type in ("inner", "left", "cross") or (
            node.join_type in ("right", "full") and node.condition is None)
    if isinstance(node, L.Aggregate):
        from spark_rapids_tpu_torch.plan.overrides import aggregate_outputs
        aggs = aggregate_outputs(list(node.group_exprs),
                                 list(node.agg_exprs))[0]
        return all(a.func.name in _HOST_AGGREGATES for a in aggs)
    return isinstance(node, (L.Project, L.Filter, L.Limit, L.Union, Expand,
                             L.FileRelation, L.InMemoryRelation, L.Sort))


_HOST_AGGREGATES = ("count", "sum", "min", "max", "avg")


class CpuFallbackExec(TpuExec):
    """One logical node run on the host in pandas (see the module's
    docstring); its output batches land on ``device``."""

    # inputs up to this many rows sort in one pass; larger ones run the
    # external merge sort over spilled runs
    SORT_RUN_ROWS = 1 << 20

    def __init__(self, node: L.LogicalPlan, children: Sequence[TpuExec],
                 device="cpu", reasons: Sequence[str] = ()):
        super().__init__(*children)
        self.node = node
        self.device = device
        self.reasons = list(reasons)
        for name in (CHILD_TIME, TO_HOST_TIME, TO_DEVICE_TIME):
            self._register_metric(name)

    def host_ns(self) -> int:
        """This node's own host time in pandas: opTime less the waits on
        its children and the two transfers."""
        m = self.metrics
        return m["opTime"].value - sum(
            m[k].value for k in (CHILD_TIME, TO_HOST_TIME, TO_DEVICE_TIME))

    @property
    def schema(self) -> Schema:
        return self.node.schema

    def describe(self):
        return f"CpuFallbackExec[{type(self.node).__name__}]"

    # -- the boundary --------------------------------------------------------
    def _child_frames(self, i: int) -> Iterator[pd.DataFrame]:
        """Child i's output, one host frame per batch; at least one
        (possibly empty) frame, so a typed empty batch is still emitted."""
        empty = True
        it = self.children[i].execute()
        while True:
            with self.timer(CHILD_TIME):
                b = next(it, None)
            if b is None:
                break
            empty = False
            with self.timer(TO_HOST_TIME):
                frame = arrow_to_frame(b.to_arrow())
            yield frame
        if empty:
            yield arrow_to_frame(
                empty_batch(self.children[i].schema).to_arrow())

    def _child_frame(self, i: int) -> pd.DataFrame:
        """Child i whole (a sort's run or a join's build side)."""
        frames = list(self._child_frames(i))
        if len(frames) == 1:
            return frames[0]
        return pd.concat(frames, ignore_index=True)

    def _build_batch(self, out: pd.DataFrame) -> ColumnarBatch:
        """A host frame (its columns in schema order) as a batch on the
        exec's device, through arrow and the pinned staging path."""
        import pyarrow as pa
        with self.timer(TO_DEVICE_TIME):
            arrays = []
            for j, (name, dt) in enumerate(self.node.schema):
                arrays.append(_to_arrow(_from_series(out.iloc[:, j], dt)))
            table = pa.table(arrays, names=[f"c{j}" for j in
                                            range(len(arrays))])
            batch = ColumnarBatch.from_arrow(table, device=self.device)
        cols = dict(zip([n for n, _ in self.node.schema],
                        batch.columns.values()))
        return ColumnarBatch(cols, batch.nrows)

    @staticmethod
    def _frame_of(vals: List[_V]) -> pd.DataFrame:
        return pd.DataFrame({i: v.series() for i, v in enumerate(vals)})

    # -- the nodes -----------------------------------------------------------
    def do_execute(self) -> Iterator[ColumnarBatch]:
        from spark_rapids_tpu_torch.exec.expand import Expand
        node = self.node
        if isinstance(node, L.Project):
            for df in self._child_frames(0):
                yield self._build_batch(self._frame_of(
                    [_eval(e, df) for e in node.exprs]))
            return
        if isinstance(node, L.Filter):
            for df in self._child_frames(0):
                c = _eval(node.condition, df)
                yield self._build_batch(df[c.values & c.valid])
            return
        if isinstance(node, L.Limit):
            remaining = node.n
            for df in self._child_frames(0):
                take = df.head(max(remaining, 0))
                remaining -= len(take)
                yield self._build_batch(take)
                if remaining <= 0:
                    break
            return
        if isinstance(node, L.Union):
            for i in range(len(self.children)):
                for df in self._child_frames(i):
                    # positional: the child's columns under this schema
                    yield self._build_batch(df)
            return
        if isinstance(node, Expand):
            # chunk-major, projection-inner, as the device Expand orders
            # its batches
            for df in self._child_frames(0):
                for proj in node.projections:
                    yield self._build_batch(self._frame_of(
                        [_eval(e, df) for e in proj]))
            return
        if isinstance(node, L.FileRelation):
            yield from self._scan_files(node)
            return
        if isinstance(node, L.InMemoryRelation):
            for b in node.batches:
                yield self._build_batch(arrow_to_frame(b.to_arrow()))
            if not node.batches:
                yield self._build_batch(arrow_to_frame(
                    empty_batch(node.schema).to_arrow()))
            return
        if isinstance(node, L.Join):
            yield from self._execute_join(node)
            return
        if isinstance(node, L.Aggregate):
            yield self._build_batch(self._aggregate_frame(node))
            return
        if isinstance(node, L.Sort):
            yield from self._execute_sort(node)
            return
        reasons = f": {'; '.join(self.reasons)}" if self.reasons else ""
        raise NotImplementedError(
            f"no CPU fallback for {type(node).__name__}{reasons}")

    def _scan_files(self, node: L.FileRelation) -> Iterator[ColumnarBatch]:
        """A scan whose format is switched off: arrow record batches
        straight from the dataset, one at a time (CPU Spark reading it)."""
        from spark_rapids_tpu_torch.io.readers import _dataset
        from spark_rapids_tpu_torch.plan.overrides import _check_no_options
        _check_no_options(node)
        if node.file_meta:
            raise NotImplementedError(
                "CPU fallback scan does not expose file metadata "
                "columns; re-enable the columnar scan")
        import pyarrow as pa
        names = [n for n, _ in node.schema]
        got_any = False
        for rb in _dataset(node.paths, node.file_format).to_batches(
                columns=names):
            got_any = True
            yield self._build_batch(arrow_to_frame(
                pa.Table.from_batches([rb])))
        if not got_any:
            yield self._build_batch(arrow_to_frame(
                empty_batch(node.schema).to_arrow()))

    # -- sort --------------------------------------------------------------
    def _keyed(self, df: pd.DataFrame, orders) -> pd.DataFrame:
        """``df`` with its sort keys appended as ``__k<i>``."""
        keys = {f"__k{i}": _eval(e, df).series(df.index)
                for i, (e, _, _) in enumerate(orders)}
        return df.assign(**keys) if keys else df

    def _execute_sort(self, node: L.Sort) -> Iterator[ColumnarBatch]:
        """External merge sort: bounded sorted runs, each spilled to a
        parquet file once the input passes ``SORT_RUN_ROWS``, then a k-way
        merge, so even a fallback sort never holds its whole input
        (CPU Spark's UnsafeExternalSorter role)."""
        import shutil
        import tempfile

        from spark_rapids_tpu_torch.utils.hostsort import sort_per_key_nulls
        by = [f"__k{i}" for i in range(len(node.orders))]
        ascending = [not d for _, d, _ in node.orders]
        nulls_first = [nf for _, _, nf in node.orders]
        width = len(node.schema)

        def sort_frame(df):
            return sort_per_key_nulls(df, by, ascending, nulls_first)

        pend: List[pd.DataFrame] = []
        pend_rows = 0
        runs: List[str] = []
        tmpdir = None
        try:
            for df in self._child_frames(0):
                pend.append(self._positional(self._keyed(df, node.orders)))
                pend_rows += len(df)
                if pend_rows >= self.SORT_RUN_ROWS:
                    if tmpdir is None:
                        tmpdir = tempfile.mkdtemp(prefix="tpu-fbsort-")
                    run = sort_frame(pd.concat(pend, ignore_index=True))
                    path = f"{tmpdir}/run-{len(runs)}.parquet"
                    _write_run(run, path)
                    runs.append(path)
                    pend, pend_rows = [], 0
            tail = sort_frame(pd.concat(pend, ignore_index=True)) \
                if pend else None
            if not runs:
                yield self._build_batch(tail.iloc[:, :width])
                return
            yield from self._sort_merge(runs, tail, by, ascending,
                                        nulls_first, width)
        finally:
            # also on an early-stopped consumer or a failed merge
            if tmpdir is not None:
                shutil.rmtree(tmpdir, ignore_errors=True)

    @staticmethod
    def _positional(df: pd.DataFrame) -> pd.DataFrame:
        """Column names that parquet can hold (unique, strings)."""
        out = df.copy(deep=False)
        out.columns = [c if str(c).startswith("__k") else f"c{i}"
                       for i, c in enumerate(df.columns)]
        return out

    def _sort_merge(self, runs, tail, by, ascending, nulls_first, width
                    ) -> Iterator[ColumnarBatch]:
        import heapq

        import pyarrow as pa
        import pyarrow.parquet as pq
        null_ranks = [0 if nf else 1 for nf in nulls_first]

        def keyify(kr):
            out = []
            for v, asc, nr in zip(kr, ascending, null_ranks):
                if _isnull(v):
                    out.append((nr, 0))
                else:
                    out.append((1 - nr, v if asc else _Neg(v)))
            return tuple(out)

        def rows_of(source):
            """(key, row) pairs streamed from one sorted run."""
            if isinstance(source, str):
                frames = (arrow_to_frame(pa.Table.from_batches([b]))
                          for b in pq.ParquetFile(source).iter_batches(
                              batch_size=1 << 16))
            else:
                frames = iter([source])
            for fr in frames:
                keys = fr[by].itertuples(index=False, name=None)
                full = fr.itertuples(index=False, name=None)
                for kr, row in zip(keys, full):
                    yield keyify(kr), row

        sources = list(runs) + ([tail] if tail is not None else [])
        cols = list(tail.columns) if tail is not None else \
            pq.ParquetFile(runs[0]).schema_arrow.names
        merged = heapq.merge(*[rows_of(s) for s in sources],
                             key=lambda kv: kv[0])
        buf = []
        template = tail if tail is not None else \
            arrow_to_frame(pq.read_table(runs[0]).slice(0, 0))
        for _, row in merged:
            buf.append(row)
            if len(buf) >= (1 << 16):
                yield self._build_batch(_rows_frame(buf, cols, template)
                                        .iloc[:, :width])
                buf = []
        yield self._build_batch(_rows_frame(buf, cols, template)
                                .iloc[:, :width])

    # -- join --------------------------------------------------------------
    def _execute_join(self, node: L.Join) -> Iterator[ColumnarBatch]:
        how = {"inner": "inner", "left": "left", "right": "right",
               "full": "outer", "cross": "cross"}.get(node.join_type)
        if how is None:
            raise NotImplementedError(
                f"CPU fallback join type {node.join_type}")
        if node.condition is not None and how in ("right", "outer"):
            raise NotImplementedError(
                "CPU fallback right/full join with residual "
                "condition not supported")
        if how in ("inner", "left", "cross"):
            # one output per probe chunk: the build side materializes,
            # the probe side streams
            right = self._child_frame(1)
            for left in self._child_frames(0):
                yield self._build_batch(
                    self._join_frames(node, left, right, how))
            return
        # right and full joins account for build-side matches globally
        yield self._build_batch(self._join_frames(
            node, self._child_frame(0), self._child_frame(1), how))

    def _join_frames(self, node: L.Join, left: pd.DataFrame,
                     right: pd.DataFrame, how: str) -> pd.DataFrame:
        """The joined rows as a frame in ``node.schema``'s column order,
        built from row pairs so that Spark's rules hold for every join
        type on one path: null keys never match (pandas ``merge`` pairs
        them), a residual applies to a match (a left row whose matches
        all fail it is null-extended, not dropped), and the two sides'
        columns stay positional, whatever their names."""
        li, ri = _key_pairs(node, left, right, how)
        if node.condition is not None:
            c = _eval(node.condition, _gather(left, right, li, ri))
            keep = c.values & c.valid
            li, ri = li[keep], ri[keep]
        if how in ("left", "outer"):
            li, ri = _with_unmatched(li, ri, len(left))
        if how in ("right", "outer"):
            ri, li = _with_unmatched(ri, li, len(right))
        out = _gather(left, right, li, ri)
        if not node.using:
            return out
        nl = len(left.columns)
        lnames = [n for n, _ in node.left.schema]
        rnames = [n for n, _ in node.right.schema]
        keyset = set(node.using)
        cols = []
        for i, n in enumerate(lnames):
            if n in keyset:
                col = out.iloc[:, i]
                if how in ("right", "outer"):
                    # a USING key is the left's, else the right's
                    col = col.fillna(out.iloc[:, nl + rnames.index(n)])
                cols.append(col)
        cols += [out.iloc[:, i] for i, n in enumerate(lnames)
                 if n not in keyset]
        cols += [out.iloc[:, nl + i] for i, n in enumerate(rnames)
                 if n not in keyset]
        return pd.DataFrame(dict(enumerate(cols)))

    # -- aggregate ---------------------------------------------------------
    def _aggregate_frame(self, node: L.Aggregate) -> pd.DataFrame:
        """Fold the child's chunks into per-group partial states (the
        GpuHashAggregate partial/merge split, on the host), merged each
        time their rows pass ``SORT_RUN_ROWS``; then finalize, and
        evaluate the outputs that combine aggregates over the (keys,
        aggregates) frame."""
        from spark_rapids_tpu_torch.plan.overrides import aggregate_outputs
        group = list(node.group_exprs)
        agg_list, out_named, _ = aggregate_outputs(group,
                                                   list(node.agg_exprs))
        funcs = [a.func for a in agg_list]
        for f in funcs:
            if f.name not in _HOST_AGGREGATES:
                raise NotImplementedError(f"CPU fallback aggregate {f.name}")
        spec = {}
        for j, f in enumerate(funcs):
            spec[f"n{j}"] = "sum"
            if f.name != "count":
                spec[f"s{j}"] = f.name if f.name in ("min", "max") \
                    else "sum"
        nkeys = len(group)
        partials: List[pd.DataFrame] = []
        rows = 0
        for df in self._child_frames(0):
            if not len(df):
                continue
            keys = [_eval(g, df) for g in group]
            children = [None if f.child is None else _eval(f.child, df)
                        for f in funcs]
            partials.append(_agg_partial(funcs, keys, children, len(df)))
            rows += len(partials[-1])
            if rows >= self.SORT_RUN_ROWS and len(partials) > 1:
                partials = [_merge_partials(
                    pd.concat(partials, ignore_index=True), nkeys, spec)]
                rows = len(partials[0])
        if not partials:
            if nkeys:
                merged = None
            else:
                # a global aggregate answers one row on empty input
                merged = pd.DataFrame(
                    {c: pd.array([0 if c.startswith("n") else None],
                                 dtype="Float64" if c.startswith("s")
                                 else "Int64") for c in spec})
        elif len(partials) == 1:
            merged = partials[0]
        else:
            merged = _merge_partials(pd.concat(partials, ignore_index=True),
                                     nkeys, spec)
        # the (keys, aggregates) frame the outputs read
        inner = []
        if merged is None:
            inner = [_full(g.dtype, 0, None) for g in group] + \
                [_full(a.dtype, 0, None) for a in agg_list]
        else:
            inner = [_from_series(merged[f"k{i}"], g.dtype)
                     for i, g in enumerate(group)]
            for j, (f, a) in enumerate(zip(funcs, agg_list)):
                cnt = _from_series(merged[f"n{j}"], dts.INT64)
                if f.name == "count":
                    inner.append(_V(dts.INT64, cnt.values,
                                    np.ones(len(cnt), dtype=np.bool_)))
                    continue
                s = _from_series(merged[f"s{j}"], a.dtype if f.name != "avg"
                                 else dts.FLOAT64)
                has = cnt.values > 0
                if f.name == "avg":
                    with np.errstate(all="ignore"):
                        vals = s.values / np.where(has, cnt.values, 1)
                    inner.append(_V(dts.FLOAT64, vals, has))
                else:
                    inner.append(_V(a.dtype, s.values, s.valid & has))
        frame = self._frame_of(inner)
        return self._frame_of(inner[:nkeys] +
                              [_eval(e, frame) for _, e in out_named])


def _key_pairs(node: L.Join, left: pd.DataFrame, right: pd.DataFrame,
               how: str):
    """(left rows, right rows) of every pair whose keys are equal and not
    null (every pair for a cross join, or a join with no equality key)."""
    if how == "cross" or not node.left_keys:
        nl, nr = len(left), len(right)
        return (np.repeat(np.arange(nl), nr), np.tile(np.arange(nr), nl))

    def keyed(frame, exprs, row):
        keys = [_eval(e, frame) for e in exprs]
        valid = np.logical_and.reduce([k.valid for k in keys])
        narrow = pd.DataFrame({f"k{i}": k.series()
                               for i, k in enumerate(keys)})
        narrow[row] = np.arange(len(frame))
        return narrow[valid]
    pairs = keyed(left, node.left_keys, "__l").merge(
        keyed(right, node.right_keys, "__r"),
        on=[f"k{i}" for i in range(len(node.left_keys))], how="inner",
        sort=False)
    return pairs["__l"].to_numpy(), pairs["__r"].to_numpy()


def _with_unmatched(mine: np.ndarray, other: np.ndarray, n: int):
    """The pairs, and each of this side's ``n`` rows without a pair
    paired with -1 (a null-extended row)."""
    seen = np.zeros(n, dtype=np.bool_)
    seen[mine[mine >= 0]] = True
    lone = np.flatnonzero(~seen)
    return (np.concatenate([mine, lone]),
            np.concatenate([other, np.full(len(lone), -1, np.int64)]))


def _gather(left: pd.DataFrame, right: pd.DataFrame, li: np.ndarray,
            ri: np.ndarray) -> pd.DataFrame:
    """Left's columns at ``li`` then right's at ``ri``, positionally; a
    row number -1 reads nulls."""
    cols = [left.iloc[:, j].array.take(li, allow_fill=True)
            for j in range(len(left.columns))]
    cols += [right.iloc[:, j].array.take(ri, allow_fill=True)
             for j in range(len(right.columns))]
    return pd.DataFrame({j: pd.Series(c) for j, c in enumerate(cols)})


def _write_run(run: pd.DataFrame, path: str) -> None:
    import pyarrow as pa
    import pyarrow.parquet as pq
    pq.write_table(pa.Table.from_pandas(run, preserve_index=False), path)


def _rows_frame(rows, cols, template: pd.DataFrame) -> pd.DataFrame:
    """Merged row tuples as a frame typed like ``template``."""
    out = pd.DataFrame(rows, columns=cols) if rows else \
        pd.DataFrame({c: [] for c in cols})
    return pd.DataFrame({c: pd.array(out[c].tolist(),
                                     dtype=template[c].dtype)
                         for c in cols})


def _to_arrow(v: _V):
    """A host column as an arrow array of its device type."""
    import pyarrow as pa
    at = dts.to_arrow_type(v.dt)
    if v.dt.is_string:
        return _with_nulls(v.values, v.valid).cast(pa.string())
    mask = None if v.valid.all() else ~v.valid
    if v.dt.is_date:
        return pa.array(v.values.astype(np.int32), type=pa.int32(),
                        mask=mask).cast(pa.date32())
    if v.dt.is_timestamp:
        return pa.array(v.values.astype(np.int64), type=pa.int64(),
                        mask=mask).cast(at)
    return pa.array(v.values.astype(v.dt.storage), type=at, mask=mask)
