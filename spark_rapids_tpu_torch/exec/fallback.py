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
int64 microseconds; strings as arrow-backed pandas strings; arrays
(``array<string>`` too) as arrow-backed pandas lists.  Expressions
evaluate over numpy arrays and their validity (``_eval``) with the
device's semantics: Kleene AND / OR, integer overflow that wraps, null
for a division by zero, Java's remainder, NaN as the largest float, LIKE
through arrow's ``match_like``, the string casts (Spark's non-ANSI parse
rules, as the card's, and the JAX package's CPU formatting of floats),
and the string, regex, hash and date library (``_eval_library``) with CPU
Spark's semantics: case mapping over all of Unicode, any pattern through
Python's ``re`` (Java's ASCII classes), ``md5`` through ``hashlib``, a
host Murmur3, ``date_format`` over the common Java pattern letters;
``get_json_object`` and ``split`` to an array of strings on the host
(``ops/json_ops.py``), and the array, map and time-window expressions
through their device emit over CPU tensors, as the decimals; a black-box
Python UDF row by row (a Project whose UDF sits in another UDF's
arguments runs here, as in the JAX package).  A Generate
explodes through arrow's list kernels.  The
JAX package's fallback builds pandas frames with numpy types instead, so
an integer column with nulls becomes float there and loses precision past
2^53; its ``_build_batch`` then fills those nulls with 0 before the cast.

Where the JAX package raises, the port raises the same reason: a right or
full join with a residual condition, a semi or anti join, a Window or
Range node, and an expression this module cannot evaluate.
"""

from __future__ import annotations

import datetime
import os
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
# them to host frames (to_arrow and the frame; an aggregate's frames are
# made on its threads, in its own time), and moving its results to the
# device (from_arrow and the upload); its own pandas time is the rest of
# opTime
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
    int32 days, timestamps as int64 microseconds, decimals as their
    unscaled int64, nullable numbers."""
    import pyarrow as pa
    cols = []
    for col in table.columns:
        t = col.type
        if pa.types.is_dictionary(t):
            col = col.cast(t.value_type)
            t = col.type
        if pa.types.is_decimal(t):
            col = _decimal_as_int64(col)
        elif pa.types.is_date32(t):
            col = col.cast(pa.int32())
        elif pa.types.is_timestamp(t):
            col = col.cast(pa.timestamp("us", tz=t.tz)).cast(pa.int64())
        cols.append(col)
    # positional names: a joined schema may repeat a name
    tmp = pa.table(cols, names=[f"c{i}" for i in range(len(cols))])
    types = _pd_types()

    def mapper(t):
        if pa.types.is_list(t) or pa.types.is_large_list(t):
            return pd.ArrowDtype(t)
        return types.get(t)
    df = tmp.to_pandas(types_mapper=mapper)
    for i, col in enumerate(cols):
        if pa.types.is_floating(col.type):
            # pandas' own conversion turns NaN into a null; Spark keeps
            # them apart
            df[f"c{i}"] = _float_array(col)
    df.columns = list(table.column_names)
    return df


def _decimal_as_int64(col):
    """A decimal128 column as its unscaled int64 values (nulls kept), with
    no Python object per row."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.columnar.column import decimal_unscaled
    chunks = col.chunks if isinstance(col, pa.ChunkedArray) else [col]
    return pa.chunked_array(
        [pa.array(decimal_unscaled(c), type=pa.int64(),
                  mask=c.is_null().to_numpy(zero_copy_only=False)
                  if c.null_count else None) for c in chunks],
        type=pa.int64())


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
        if self.dt.is_array:
            return pd.Series(pd.arrays.ArrowExtensionArray(
                _with_nulls(self.values, self.valid)), index=index)
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
    if dt.is_array:
        arr = s.array
        arr = arr._pa_array if isinstance(
            arr, pd.arrays.ArrowExtensionArray) else pa.array(
            [None if not ok else list(v) for v, ok in zip(s, valid)])
        return _V(dt, _list_array(arr, dt), valid)
    return _V(dt, s.to_numpy(dtype=dt.storage, na_value=0), valid)


def _list_array(arr, dt: DataType):
    """An arrow list array (or chunked array) as one chunk of ``dt``'s
    arrow list type."""
    import pyarrow as pa
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks() if arr.num_chunks != 1 else arr.chunk(0)
    return arr.cast(dts.to_arrow_type(dt))


def _take(v: _V, idx: np.ndarray) -> _V:
    """The rows ``idx`` of a host column."""
    import pyarrow as pa
    if isinstance(v.values, (pa.Array, pa.ChunkedArray)):
        return _V(v.dt, v.values.take(pa.array(idx, pa.int64())),
                  v.valid[idx])
    return _V(v.dt, v.values[idx], v.valid[idx])


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


def _colval(v: _V):
    """A host column as a ColVal over CPU tensors (views of its arrays;
    an array column as its flat elements and int32 offsets, a null row
    empty)."""
    import torch
    from spark_rapids_tpu_torch.ops.expressions import ColVal
    valid = torch.from_numpy(np.ascontiguousarray(v.valid))
    if v.dt.is_array:
        import pyarrow.compute as pc
        arr = _with_nulls(v.values, v.valid)
        lens = pc.list_value_length(arr).fill_null(0).to_numpy(
            zero_copy_only=False)
        offsets = np.zeros(len(lens) + 1, dtype=np.int32)
        np.cumsum(lens, out=offsets[1:])
        flat = pc.list_flatten(arr)
        elems = flat.to_numpy(zero_copy_only=False).astype(
            v.dt.storage) if len(flat) else np.zeros(0, v.dt.storage)
        return ColVal(v.dt, torch.from_numpy(np.ascontiguousarray(elems)),
                      valid, torch.from_numpy(offsets))
    return ColVal(v.dt, torch.from_numpy(np.ascontiguousarray(v.values)),
                  valid)


def _from_colval(c, n: int) -> _V:
    """A ColVal over CPU tensors back as a host column of ``n`` rows."""
    import torch
    if c.dtype.is_array:
        from spark_rapids_tpu_torch.columnar.column import Column
        valid = np.ones(n, dtype=np.bool_) if c.validity is None else \
            c.validity.expand(n).numpy().astype(np.bool_)
        arr = Column.to_arrow(c.dtype, c.values.numpy(), None, n,
                              c.offsets.numpy())
        return _V(c.dtype, arr, valid.copy())
    vals = c.values.expand(n) if c.values.dim() == 0 else c.values
    valid = np.ones(n, dtype=np.bool_) if c.validity is None else \
        c.validity.expand(n).numpy() if c.validity.dim() == 0 else \
        c.validity.numpy()
    return _V(c.dtype, vals.to(dts.torch_dtype(c.dtype)).numpy().copy(),
              np.asarray(valid, dtype=np.bool_).copy())


def _via_torch(fn, n: int, *vs: _V) -> _V:
    """``fn`` (the device's evaluation over ColVals) run over host columns
    on CPU tensors: the decimal operations, so that the fallback's
    decimals round, rescale and null on overflow bit for bit as the
    card's do, in int64 and without a Python object per row."""
    return _from_colval(fn(*[_colval(v) for v in vs]), n)


def _implicit(v: _V, target: DataType) -> _V:
    """Implicit widening (``ops/expressions.cast_value``): a date meets a
    timestamp at midnight UTC; a decimal rescales, or meets a double as
    its value."""
    if v.dt.name == target.name:
        return v
    if v.dt.is_decimal or target.is_decimal:
        return _cast(v, target)
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
    from spark_rapids_tpu_torch.ops import decimal_ops as D
    if isinstance(e, A._DecimalAwareBinary) and e._exact_decimal():
        return _via_torch(lambda a, b: D.emit_binary(e._dec_op, a, b,
                                                     e.dtype),
                          len(l), l, r)
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
    from spark_rapids_tpu_torch.ops import decimal_ops as DEC
    from spark_rapids_tpu_torch.ops import predicates as P
    from spark_rapids_tpu_torch.ops import stringops as S
    from spark_rapids_tpu_torch.ops.cast import Cast
    from spark_rapids_tpu_torch.ops.expressions import (
        Alias, BoundReference, Literal, ParamSlot)

    e = expr
    n = len(df)
    if isinstance(e, Alias):
        return _eval(e.child, df)
    if isinstance(e, BoundReference):
        return _from_series(df.iloc[:, e.ordinal], e.dtype)
    if isinstance(e, (Literal, ParamSlot)):
        # a hoisted literal (plan/template.py) evaluates its current
        # binding, the value the device would have used
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
    if isinstance(e, DEC.CheckOverflow) and not e.null_on_overflow:
        c = _eval(e.child, df)
        out = _via_torch(lambda a: DEC.rescale_checked(a, e.target), n, c)
        if (c.valid & ~out.valid).any():
            raise ArithmeticError(
                f"decimal value does not fit {e.target} (ANSI "
                "CheckOverflow)")
        return out
    if isinstance(e, _device_evaluated()):
        return _via_torch(lambda *cs: _emit_over(e, cs, n), n,
                          *[_eval(c, df) for c in e.children])
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
    from spark_rapids_tpu_torch.udf.python_exec import PythonUDF
    if isinstance(e, PythonUDF):
        return _eval_python_udf(e, df)
    out = _eval_library(e, df)
    if out is None:
        out = _eval_nested(e, df)
    if out is not None:
        return out
    raise NotImplementedError(
        f"CPU fallback cannot evaluate {type(e).__name__}")


def _py_values(v: _V) -> list:
    """A host column's rows as Python values, as arrow gives them (the
    black-box UDF's argument convention: ``None`` for null, a date as a
    ``datetime.date``)."""
    from spark_rapids_tpu_torch.columnar.column import Column
    if isinstance(v.values, (list, tuple)):
        return [x if ok else None for x, ok in zip(v.values, v.valid)]
    if v.dt.is_string or v.dt.is_array:
        return _with_nulls(v.values, v.valid).to_pylist()
    return Column.to_arrow(v.dt, v.values, v.valid, len(v)).to_pylist()


def _eval_python_udf(e, df: pd.DataFrame) -> _V:
    """A black-box Python UDF over the frame, row by row: the CPU branch
    of a projection whose UDF sits in another UDF's arguments (the JAX
    fallback's ``PythonUDF`` evaluation); a null argument gives null."""
    import pyarrow as pa
    n = len(df)
    args = [_py_values(_eval(c, df)) for c in e.children]
    if args:
        out = [None if any(a is None for a in row) else e.fn(*row)
               for row in zip(*args)]
    else:
        out = [e.fn() for _ in range(n)]
    dt = e.dtype
    valid = np.array([x is not None for x in out], dtype=np.bool_)
    if dt.is_string:
        return _V(dt, pa.array([None if x is None else str(x) for x in out],
                               type=pa.large_string()), valid)
    if dt.is_array:
        return _V(dt, _list_array(pa.array(out), dt), valid)
    if dt.is_decimal or dt.is_datetime:
        arr = pa.array(out, type=dts.to_arrow_type(dt))
        return _from_colval(_device_column(arr), n)
    return _V(dt, np.array([0 if x is None else x for x in out],
                           dtype=dt.storage), valid)


def _device_column(arr):
    """An arrow array as a ColVal over CPU tensors (the storage the
    device uses: days, microseconds, unscaled decimals)."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.columnar.batch import _column_from_arrow
    from spark_rapids_tpu_torch.ops.expressions import ColVal
    c = _column_from_arrow(pa.chunked_array([arr]), "cpu")
    return ColVal(c.dtype, c.data, c.validity, c.offsets)


# ------------------------------------------- the string, date and hash library

def _strings(vals, valid: np.ndarray) -> _V:
    import pyarrow as pa
    vals = [v if ok else None for v, ok in zip(vals, valid)]
    return _V(dts.STRING, pa.array(vals, type=pa.large_string()),
              np.asarray(valid, dtype=np.bool_))


def _map_strings(c: _V, fn, dt: DataType = dts.STRING) -> _V:
    """``fn`` over each non-null string of ``c`` (a None result is
    null)."""
    got = [None if s is None else fn(s) for s in _str_list(c)]
    valid = np.array([g is not None for g in got], dtype=np.bool_)
    if dt.is_string:
        return _strings(got, valid)
    return _V(dt, np.array([0 if g is None else g for g in got],
                           dtype=dt.storage), valid)


def _initcap(v: str) -> str:
    out, prev_space = [], True
    for ch in v:
        out.append(ch.upper() if prev_space else ch.lower())
        prev_space = ch == " "
    return "".join(out)


def _pad(v: str, width: int, pad: str, left: bool) -> str:
    """Spark's lpad / rpad over characters."""
    if width <= 0:
        return ""
    if len(v) >= width or not pad:
        return v[:width]
    fill = (pad * (width // len(pad) + 1))[:width - len(v)]
    return fill + v if left else v + fill


def _find_all(v: str, sub: str):
    """Every start of ``sub`` in ``v``, overlapping ones too (Spark's
    substring_index steps one character past each)."""
    out, i = [], v.find(sub)
    while i >= 0:
        out.append(i)
        i = v.find(sub, i + 1)
    return out


def _substring_index(v: str, delim: str, count: int) -> str:
    if count == 0 or not delim:
        return ""
    hits = _find_all(v, delim)
    if count > 0:
        return v if len(hits) < count else v[:hits[count - 1]]
    if len(hits) < -count:
        return v
    return v[hits[count] + len(delim):]


def _locate(v: str, sub: str, start: int) -> int:
    if start < 1:
        return 0
    if not sub:
        return 1
    return v.find(sub, start - 1) + 1


def _java_replacement(text: str):
    """A Java regex replacement as a function of the match: ``$n`` is
    group n, ``\\x`` a literal x."""
    parts, i = [], 0
    while i < len(text):
        ch = text[i]
        if ch == "\\" and i + 1 < len(text):
            parts.append(text[i + 1])
            i += 2
        elif ch == "$" and i + 1 < len(text) and text[i + 1].isdigit():
            j = i + 1
            while j < len(text) and text[j].isdigit():
                j += 1
            parts.append(int(text[i + 1:j]))
            i = j
        else:
            parts.append(ch)
            i += 1
    return lambda m: "".join(p if isinstance(p, str) else (m.group(p) or "")
                             for p in parts)


def _translate_table(src: str, dst: str) -> dict:
    table = {}
    for i, ch in enumerate(src):
        if ord(ch) not in table:
            table[ord(ch)] = dst[i] if i < len(dst) else None
    return table


def _mm3_rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & 0xFFFFFFFF


def _mm3_k1(k: int) -> int:
    k = (k * 0xCC9E2D51) & 0xFFFFFFFF
    return (_mm3_rotl(k, 15) * 0x1B873593) & 0xFFFFFFFF


def _mm3_h1(h: int, k: int) -> int:
    return (_mm3_rotl(h ^ k, 13) * 5 + 0xE6546B64) & 0xFFFFFFFF


def _mm3_fmix(h: int, n: int) -> int:
    h ^= n
    h = ((h ^ (h >> 16)) * 0x85EBCA6B) & 0xFFFFFFFF
    h = ((h ^ (h >> 13)) * 0xC2B2AE35) & 0xFFFFFFFF
    return h ^ (h >> 16)


def _murmur3_value(value, dt: DataType, seed: int) -> int:
    """Spark's Murmur3_x86_32 of one non-null value of type ``dt`` (its
    storage value) over ``seed``."""
    import struct
    if dt.is_string:
        b = value.encode("utf-8")
        h = seed
        n4 = len(b) - len(b) % 4
        for i in range(0, n4, 4):
            h = _mm3_h1(h, _mm3_k1(int.from_bytes(b[i:i + 4], "little")))
        for x in b[n4:]:
            h = _mm3_h1(h, _mm3_k1((x - 256 if x >= 128 else x)
                                   & 0xFFFFFFFF))
        return _mm3_fmix(h, len(b))
    if dt.name == "float":
        v = float(value)
        bits = 0x7FC00000 if v != v else \
            struct.unpack("<I", struct.pack("<f", 0.0 if v == 0 else v))[0]
        return _mm3_fmix(_mm3_h1(seed, _mm3_k1(bits)), 4)
    if dt.name == "double":
        v = float(value)
        value = 0x7FF8000000000000 if v != v else struct.unpack(
            "<q", struct.pack("<d", 0.0 if v == 0 else v))[0]
        dt = dts.INT64
    if dt.name in ("bigint", "timestamp") or dt.is_decimal:
        v = int(value) & 0xFFFFFFFFFFFFFFFF
        h = _mm3_h1(seed, _mm3_k1(v & 0xFFFFFFFF))
        h = _mm3_h1(h, _mm3_k1(v >> 32))
        return _mm3_fmix(h, 8)
    return _mm3_fmix(_mm3_h1(seed, _mm3_k1(int(value) & 0xFFFFFFFF)), 4)


def _murmur3(cols: List[_V], n: int, seed: int) -> np.ndarray:
    hs = []
    lists = [_str_list(c) if c.dt.is_string else c.values.tolist()
             for c in cols]
    for r in range(n):
        h = seed & 0xFFFFFFFF
        for c, vals in zip(cols, lists):
            if c.valid[r]:
                h = _murmur3_value(vals[r], c.dt, h)
        hs.append(h - (1 << 32) if h >= 1 << 31 else h)
    return np.array(hs, dtype=np.int32)


_JAVA_FIELDS = (("yyyy", "%Y"), ("yy", "%y"), ("MMMM", "%B"), ("MMM", "%b"),
                ("MM", "%m"), ("dd", "%d"), ("HH", "%H"), ("hh", "%I"),
                ("mm", "%M"), ("ss", "%S"), ("EEEE", "%A"), ("EEE", "%a"),
                ("E", "%a"), ("DDD", "%j"), ("a", "%p"))


def java_date_format(us: int, fmt: str) -> str:
    """A Java date pattern over UTC microseconds: the common letters
    (year, month, day, hour, minute, second, fraction S..., day and
    month names, day of year, am/pm), quoted text and '' as a quote."""
    t = datetime.datetime(1970, 1, 1) + datetime.timedelta(microseconds=us)
    out, i = [], 0
    while i < len(fmt):
        ch = fmt[i]
        if ch == "'":
            j = fmt.find("'", i + 1)
            if j == i + 1:
                out.append("'")
                i += 2
                continue
            j = len(fmt) if j < 0 else j
            out.append(fmt[i + 1:j])
            i = j + 1
            continue
        if ch == "S":
            j = i
            while j < len(fmt) and fmt[j] == "S":
                j += 1
            out.append(f"{t.microsecond:06d}"[:j - i].ljust(j - i, "0"))
            i = j
            continue
        for tok, code in _JAVA_FIELDS:
            if fmt.startswith(tok, i):
                text = t.strftime(code)
                if tok == "yyyy":
                    text = f"{t.year:04d}"
                out.append(text)
                i += len(tok)
                break
        else:
            single = {"y": f"{t.year}", "M": f"{t.month}", "d": f"{t.day}",
                      "H": f"{t.hour}", "m": f"{t.minute}",
                      "s": f"{t.second}"}
            out.append(single.get(ch, ch))
            i += 1
    return "".join(out)


def _micros(v: _V) -> np.ndarray:
    if v.dt.is_date:
        return v.values.astype(np.int64) * US_PER_DAY
    return v.values.astype(np.int64)


def _month_days(y: np.ndarray, m: np.ndarray) -> np.ndarray:
    import calendar
    return np.array([calendar.monthrange(int(a), int(b))[1]
                     for a, b in zip(y, m)], dtype=np.int64)


def _civil_days(y: np.ndarray, m: np.ndarray, d: np.ndarray) -> np.ndarray:
    base = datetime.date(1970, 1, 1).toordinal()
    return np.array([datetime.date(int(a), int(b), int(c)).toordinal() - base
                     for a, b, c in zip(y, m, d)], dtype=np.int64)


def _months_between(ua: int, ub: int, round_off: bool) -> float:
    """Spark's ``DateTimeUtils.monthsBetween`` in UTC."""
    import calendar
    import math
    da, db = ua // US_PER_DAY, ub // US_PER_DAY
    a = datetime.date.fromordinal(719163 + da)
    b = datetime.date.fromordinal(719163 + db)
    diff = float((a.year * 12 + a.month) - (b.year * 12 + b.month))
    a_last = a.day == calendar.monthrange(a.year, a.month)[1]
    b_last = b.day == calendar.monthrange(b.year, b.month)[1]
    if a.day == b.day or (a_last and b_last):
        return diff
    secs = (a.day - b.day) * 86400 + (ua - da * US_PER_DAY) // US_PER_SEC \
        - (ub - db * US_PER_DAY) // US_PER_SEC
    out = diff + secs / (31 * 86400)
    return math.floor(out * 1e8 + 0.5) / 1e8 if round_off else out


def _eval_library(e, df: pd.DataFrame) -> Optional[_V]:
    """Host evaluation of the string, regex, hash and date functions
    with CPU Spark's semantics (case mapping over all of Unicode, Python's
    ``re`` for any pattern), or None for another class."""
    import hashlib
    import re
    import pyarrow.compute as pc
    from spark_rapids_tpu_torch.ops import datetime_ops as D
    from spark_rapids_tpu_torch.ops import misc_exprs as ME
    from spark_rapids_tpu_torch.ops import predicates as P
    from spark_rapids_tpu_torch.ops import regexops as RX
    from spark_rapids_tpu_torch.ops import stringops as S

    n = len(df)
    if isinstance(e, (S.Length, S.OctetLength)):
        c = _eval(e.child, df)
        fn = pc.utf8_length if isinstance(e, S.Length) else pc.binary_length
        vals = fn(c.values).fill_null(0).to_numpy(zero_copy_only=False)
        return _V(dts.INT32, vals.astype(np.int32), c.valid)
    if isinstance(e, (S.Upper, S.Lower, S.InitCap)):
        fn = {S.Upper: str.upper, S.Lower: str.lower,
              S.InitCap: lambda v: _initcap(v.lower())}[type(e)]
        return _map_strings(_eval(e.child, df), fn)
    if isinstance(e, (S.StringTrim, S.StringTrimLeft, S.StringTrimRight)):
        fn = {S.StringTrim: lambda v: v.strip(" "),
              S.StringTrimLeft: lambda v: v.lstrip(" "),
              S.StringTrimRight: lambda v: v.rstrip(" ")}[type(e)]
        return _map_strings(_eval(e.child, df), fn)
    if isinstance(e, S.StringLocate):
        c = _eval(e.child, df)
        return _map_strings(c, lambda v: _locate(v, e.substr, e.start),
                            dts.INT32)
    if isinstance(e, S.ConcatStrings):
        parts = [_eval(c, df) for c in e.children]
        lists = [_str_list(p) for p in parts]
        valid = np.logical_and.reduce([p.valid for p in parts])
        return _strings(["".join(row) if ok else None
                         for row, ok in zip(zip(*lists), valid)], valid)
    if isinstance(e, RX.ConcatWs):
        lists = [_str_list(_eval(c, df)) for c in e.children]
        return _strings([e.sep.join(v for v in row if v is not None)
                         for row in zip(*lists)], np.ones(n, np.bool_))
    if isinstance(e, S.StringRepeat):
        return _map_strings(_eval(e.child, df), lambda v: v * e.times)
    if isinstance(e, (S.StringLPad, S.StringRPad)):
        left = isinstance(e, S.StringLPad)
        return _map_strings(_eval(e.child, df),
                            lambda v: _pad(v, e.width, e.pad, left))
    if isinstance(e, S.SubstringIndex):
        return _map_strings(_eval(e.child, df), lambda v: _substring_index(
            v, e.delim, e.count))
    if isinstance(e, S.Ascii):
        return _map_strings(_eval(e.child, df),
                            lambda v: ord(v[0]) if v else 0, dts.INT32)
    if isinstance(e, S.Chr):
        c = _eval(e.child, df)
        vals = ["" if x < 0 else chr(x % 256)
                for x in c.values.astype(np.int64).tolist()]
        return _strings(vals, c.valid)
    # Java's \w, \d and \s are ASCII classes, as under re.ASCII
    if isinstance(e, RX.RLike):
        rx = re.compile(e.pattern, re.ASCII)
        return _map_strings(_eval(e.child, df),
                            lambda v: bool(rx.search(v)), dts.BOOL)
    if isinstance(e, RX.RegExpReplace):
        rx = re.compile(e.pattern, re.ASCII)
        repl = _java_replacement(e.replacement)
        return _map_strings(_eval(e.child, df), lambda v: rx.sub(repl, v))
    if isinstance(e, RX.StringReplace):
        if not e.search:
            return _eval(e.child, df)
        return _map_strings(_eval(e.child, df),
                            lambda v: v.replace(e.search, e.replacement))
    if isinstance(e, RX.Translate):
        table = _translate_table(e.from_str, e.to_str)
        return _map_strings(_eval(e.child, df), lambda v: v.translate(table))
    if isinstance(e, RX.SplitPart):
        rx = re.compile(e.delim, re.ASCII)

        def part(v):
            parts = rx.split(v)
            return parts[e.index] if 0 <= e.index < len(parts) else None
        return _map_strings(_eval(e.child, df), part)
    if isinstance(e, ME.Md5):
        return _map_strings(_eval(e.child, df), lambda v: hashlib.md5(
            v.encode("utf-8")).hexdigest())
    if isinstance(e, ME.Murmur3Hash):
        cols = [_eval(c, df) for c in e.children]
        return _V(dts.INT32, _murmur3(cols, n, e.seed),
                  np.ones(n, dtype=np.bool_))
    if isinstance(e, P.IsNaN):
        c = _eval(e.child, df)
        nan = np.isnan(c.values) if c.dt.is_floating else \
            np.zeros(n, dtype=np.bool_)
        return _V(dts.BOOL, nan & c.valid, np.ones(n, dtype=np.bool_))
    if isinstance(e, (P.Greatest, P.Least)):
        t = e.dtype
        cols = [_eval(c, df) for c in e.children]
        if t.is_string:
            lists = [_str_list(c) for c in cols]
            pick = max if isinstance(e, P.Greatest) else min
            got = []
            for row in zip(*lists):
                vals = [v.encode("utf-8") for v in row if v is not None]
                got.append(pick(vals).decode("utf-8") if vals else None)
            return _strings(got, np.array([g is not None for g in got],
                                          dtype=np.bool_))
        cols = [_implicit(c, t) for c in cols]
        name = "GreaterThan" if isinstance(e, P.Greatest) else "LessThan"
        out = cols[0].values.copy()
        valid = cols[0].valid.copy()
        for c in cols[1:]:
            beats = _compare(name, _V(t, c.values, c.valid),
                             _V(t, out, valid))
            take = c.valid & (~valid | beats)
            out = np.where(take, c.values, out)
            valid = valid | c.valid
        return _V(t, out.astype(t.storage), valid)
    if isinstance(e, (D.Quarter, D.DayOfWeek, D.WeekDay, D.DayOfYear)):
        c = _eval(e.child, df)
        days = _to_days(c)
        y, m, d = _civil_from_days(days)
        if isinstance(e, D.Quarter):
            out = (m - 1) // 3 + 1
        elif isinstance(e, D.DayOfWeek):
            out = (days + 4) % 7 + 1
        elif isinstance(e, D.WeekDay):
            out = (days + 3) % 7
        else:
            out = days - _civil_days(y, np.ones_like(m), np.ones_like(d)) + 1
        return _V(dts.INT32, np.asarray(out).astype(np.int32), c.valid)
    if isinstance(e, D.LastDay):
        c = _eval(e.child, df)
        y, m, d = _civil_from_days(_to_days(c))
        out = _to_days(c) - d + _month_days(y, m)
        return _V(dts.DATE32, out.astype(np.int32), c.valid)
    if isinstance(e, D.NextDay):
        c = _eval(e.child, df)
        if e.target is None:
            return _V(dts.DATE32, np.zeros(n, np.int32),
                      np.zeros(n, np.bool_))
        days = _to_days(c)
        ahead = (e.target - (days + 3) % 7 + 7) % 7
        out = days + np.where(ahead == 0, 7, ahead)
        return _V(dts.DATE32, out.astype(np.int32), c.valid)
    if isinstance(e, (D.Hour, D.Minute, D.Second)):
        c = _eval(e.child, df)
        us = _micros(c)
        out = {D.Hour: (us % US_PER_DAY) // 3_600_000_000,
               D.Minute: (us % 3_600_000_000) // 60_000_000,
               D.Second: (us % 60_000_000) // US_PER_SEC}[type(e)]
        return _V(dts.INT32, out.astype(np.int32), c.valid)
    if isinstance(e, D.AddMonths):
        l, r = _eval(e.left, df), _eval(e.right, df)
        y, m, d = _civil_from_days(_to_days(l))
        months = y * 12 + (m - 1) + r.values.astype(np.int64)
        ny, nm = months // 12, months % 12 + 1
        valid = l.valid & r.valid
        nd = np.minimum(d, _month_days(np.where(valid, ny, 1970),
                                       np.where(valid, nm, 1)))
        out = np.where(valid, _civil_days(np.where(valid, ny, 1970),
                                          np.where(valid, nm, 1),
                                          np.where(valid, nd, 1)), 0)
        return _V(dts.DATE32, out.astype(np.int32), valid)
    if isinstance(e, D.MonthsBetween):
        a, b = _eval(e.left, df), _eval(e.right, df)
        valid = a.valid & b.valid
        out = [_months_between(x, y, e.round_off) if ok else 0.0
               for x, y, ok in zip(_micros(a).tolist(),
                                   _micros(b).tolist(), valid)]
        return _V(dts.FLOAT64, np.array(out, dtype=np.float64), valid)
    if isinstance(e, D.TruncDate):
        c = _eval(e.child, df)
        days = _to_days(c)
        y, m, d = _civil_from_days(days)
        unit = D._TRUNC_FORMATS.get(e.fmt)
        one = np.ones_like(m)
        if unit is None:
            return _V(dts.DATE32, np.zeros(n, np.int32),
                      np.zeros(n, np.bool_))
        if unit == "week":
            out = days - (days + 3) % 7
        else:
            mm = {"year": one, "month": m,
                  "quarter": (m - 1) // 3 * 3 + 1}[unit]
            out = _civil_days(y, mm, one)
        return _V(dts.DATE32, np.asarray(out).astype(np.int32), c.valid)
    if isinstance(e, D.UnixTimestamp):
        c = _eval(e.child, df)
        return _V(dts.INT64, np.floor_divide(_micros(c), US_PER_SEC),
                  c.valid)
    if isinstance(e, D.TimeAdd):
        l, r = _eval(e.left, df), _eval(e.right, df)
        return _V(dts.TIMESTAMP_US, _micros(l) + r.values.astype(np.int64),
                  l.valid & r.valid)
    if isinstance(e, (D.DateFormatClass, D.FromUnixTime)):
        c = _eval(e.child, df)
        if isinstance(e, D.FromUnixTime):
            us, fmt = c.values.astype(np.int64) * US_PER_SEC, \
                "yyyy-MM-dd HH:mm:ss"
        else:
            us, fmt = _micros(c), e.fmt
        return _strings([java_date_format(x, fmt) if ok else None
                         for x, ok in zip(us.tolist(), c.valid)], c.valid)
    return None


def _eval_nested(e, df: pd.DataFrame) -> Optional[_V]:
    """Host evaluation of the collection, map, time-window and JSON
    expressions, or None for another class: JSON and split on the host
    (``eval_host``), a string reverse by characters (CPU Spark's), the
    rest through their device emit over CPU tensors."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.ops import collections_ops as C
    from spark_rapids_tpu_torch.ops import datetime_ops as D
    from spark_rapids_tpu_torch.ops import json_ops as J
    from spark_rapids_tpu_torch.ops import nested_ops as NO
    n = len(df)
    if isinstance(e, (J.GetJsonObject, J.StringSplit)):
        c = _eval(e.children[0], df)
        vals = [e.eval_host(x) if x is not None else None
                for x in _str_list(c)]
        valid = np.array([x is not None for x in vals], dtype=np.bool_)
        if isinstance(e, J.GetJsonObject):
            return _strings(vals, valid)
        return _V(e.dtype, pa.array(vals, pa.list_(pa.string())), valid)
    if isinstance(e, C.Reverse) and e.dtype.is_string:
        return _map_strings(_eval(e.child, df), lambda v: v[::-1])
    if e.children and isinstance(e, (C.Size, C.ArrayContains,
                                     C.GetArrayItem, C.SortArray,
                                     C._ArrayExtreme, C.Reverse, C.Slice)) \
            and e.children[0].dtype.is_array and \
            e.children[0].dtype.element.is_string:
        return _string_array_expr(e, df)
    if isinstance(e, C.CreateArray):
        children = [_eval(c, df) for c in e.children]
        if not all(c.valid.all() for c in children):
            raise ValueError("null array elements not supported")
        for c in children:
            c.valid = np.ones(n, dtype=np.bool_)
        return _from_colval(_emit_over(e, [_colval(c) for c in children],
                                       n, drop_validity=True), n)
    if isinstance(e, (C.Size, C.ArrayContains, C.GetArrayItem, C.SortArray,
                      C._ArrayExtreme, C.Reverse, C.Slice, C.ArrayRepeat,
                      NO.GetMapValue, D.TimeWindow)):
        return _from_colval(_emit_over(
            e, [_colval(_eval(c, df)) for c in e.children], n), n)
    return None


def _string_array_expr(e, df: pd.DataFrame) -> _V:
    """A collection expression over an ``array<string>`` (split's),
    row by row in Python with Spark's semantics."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.ops import collections_ops as C
    arr = _eval(e.children[0], df)
    lists = _with_nulls(arr.values, arr.valid).to_pylist()
    args = [_eval(c, df) for c in e.children[1:]]
    arg = None if not args else (
        _str_list(args[0]) if args[0].dt.is_string else
        [v if ok else None for v, ok in zip(args[0].values.tolist(),
                                            args[0].valid)])

    def one(i, v):
        if isinstance(e, C.Size):
            return -1 if v is None else len(v)
        if v is None or (arg is not None and arg[i] is None):
            return None
        if isinstance(e, C.ArrayContains):
            return arg[i] in v
        if isinstance(e, C.GetArrayItem):
            j = int(arg[i])
            if isinstance(e, C.ElementAt):
                j = j - 1 if j > 0 else len(v) + j
            return v[j] if 0 <= j < len(v) else None
        if isinstance(e, C.SortArray):
            return sorted(v, reverse=not e.ascending)
        if isinstance(e, C.Reverse):
            return v[::-1]
        if isinstance(e, C.Slice):
            st = e.start - 1 if e.start > 0 else len(v) + e.start
            return [] if st < 0 else v[st:st + e.length]
        if not v:
            return None
        return max(v) if e.is_max else min(v)

    vals = [one(i, v) for i, v in enumerate(lists)]
    valid = np.array([v is not None for v in vals], dtype=np.bool_)
    if e.dtype.is_string:
        return _strings(vals, valid)
    if e.dtype.is_array:
        return _V(e.dtype, pa.array(vals, pa.list_(pa.string())), valid)
    filled = [0 if v is None else v for v in vals]
    return _V(e.dtype, np.array(filled, dtype=e.dtype.storage), valid)


def _emit_over(e, children, n: int, drop_validity: bool = False):
    """The device's emit of ``e`` over its evaluated ``children``."""
    from spark_rapids_tpu_torch.ops.expressions import (
        BoundReference, ColVal, EmitContext)
    if drop_validity:
        children = [ColVal(c.dtype, c.values, None, c.offsets)
                    for c in children]
    refs = [BoundReference(i, c.dtype) for i, c in enumerate(children)]
    return e.with_children(refs).emit(
        EmitContext(list(children), n, n, "cpu"))


def _device_evaluated():
    """Expression classes the fallback evaluates through their device
    emit over CPU tensors (``_via_torch``): the decimal plumbing and the
    numeric function library, whose int64 rounding, Java shifts and
    float functions then match the card's rules exactly, a user's torch
    function (``TorchUDF``) and the UDF compiler's Python-semantics
    operators."""
    from spark_rapids_tpu_torch.ops import arithmetic as A
    from spark_rapids_tpu_torch.ops import decimal_ops as DEC
    from spark_rapids_tpu_torch.udf.compiler import PY_EXPRESSIONS
    from spark_rapids_tpu_torch.udf.python_exec import TorchUDF
    return (DEC.PromotePrecision, DEC.CheckOverflow, DEC.MakeDecimal,
            DEC.UnscaledValue, A.Pmod, A.UnaryPositive, A._MathUnary,
            A._FloorCeil, A._MathBinary, A._RoundBase, A.BitwiseOr,
            A.BitwiseXor, A.BitwiseNot, A.ShiftLeft, A.ShiftRightUnsigned,
            TorchUDF) + PY_EXPRESSIONS


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
    from spark_rapids_tpu_torch.ops.expressions import Literal, ParamSlot
    c = _eval(e.children[0], df)
    n = len(c)
    if isinstance(e, P.InSet):
        options = [x for x in e.table.tolist()]
        has_null = e.has_null
    else:
        options, has_null = [], False
        for o in e.children[1:]:
            if not isinstance(o, (Literal, ParamSlot)):
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
# the longest trimmed string a number parses from (the device's window)
_MAX_NUM_BYTES = 40
_WS = bytes(range(0x21))
_INT_LIMITS = {"tinyint": 1 << 7, "smallint": 1 << 15, "int": 1 << 31,
               "bigint": 1 << 63}
_FLOAT_SPECIAL = {"inf": float("inf"), "+inf": float("inf"),
                  "infinity": float("inf"), "+infinity": float("inf"),
                  "-inf": float("-inf"), "-infinity": float("-inf"),
                  "nan": float("nan")}


def _cast_bytes(s: str) -> bytes:
    """A string's UTF-8 bytes with whitespace and control bytes (<=
    0x20) trimmed from both ends, as Spark's casts trim."""
    return s.encode("utf-8").strip(_WS)


def _parse_integral(s: str, name: str):
    """Spark's non-ANSI string -> integral (``UTF8String.toLong``): a sign,
    digits and an optional '.' whose digits are dropped; null past the
    type's range."""
    b = _cast_bytes(s)
    if not b or len(b) > _MAX_NUM_BYTES or b in (b"-", b"+"):
        return None
    neg = b[:1] == b"-"
    body = b[1:] if b[:1] in (b"-", b"+") else b
    whole, _, frac = body.partition(b".")
    if not (whole.isdigit() or not whole) or \
            not (frac.isdigit() or not frac):
        return None
    v = int(whole or b"0")
    v = -v if neg else v
    lim = _INT_LIMITS[name]
    return v if -lim <= v < lim else None


def _parse_float(s: str):
    """Spark's string -> double: Java's decimal literal (an exponent and
    a d/f suffix allowed) or the special literals inf, infinity and nan
    (any case; Java's +NaN and -NaN)."""
    import re
    b = _cast_bytes(s)
    if not b or len(b) > _MAX_NUM_BYTES:
        return None
    t = b.decode("utf-8", "replace")
    if t.lower() in _FLOAT_SPECIAL:
        return _FLOAT_SPECIAL[t.lower()]
    if t in ("+NaN", "-NaN"):
        return float("nan")
    if not re.fullmatch(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?[dDfF]?", t):
        return None
    return float(t.rstrip("dDfF"))


def _days_from_civil(y: int, m: int, d: int) -> int:
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


def _parse_date(s: str):
    """yyyy-MM-dd after trimming, exactly."""
    s = _cast_bytes(s).decode("utf-8", "replace")
    if len(s) != 10 or s[4] != "-" or s[7] != "-" or \
            not (s[:4] + s[5:7] + s[8:]).isdigit() or not s.isascii():
        return None
    try:
        return _days_from_civil(int(s[:4]), int(s[5:7]), int(s[8:]))
    except ValueError:
        return None


def _parse_timestamp(s: str):
    """'yyyy-MM-dd[( |T)HH:mm:ss[.f{1,6}]]' after trimming, in UTC, as
    microseconds."""
    s = _cast_bytes(s).decode("utf-8", "replace")
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
    t = _cast_bytes(s).decode("utf-8", "replace").lower()
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
    if src.is_string and t.is_decimal:
        import decimal
        q = decimal.Decimal(1)
        got = []
        for s in _str_list(c):
            try:
                got.append(None if s is None else int(
                    decimal.Decimal(s.strip()).scaleb(t.scale).quantize(
                        q, rounding=decimal.ROUND_HALF_UP)))
            except (decimal.InvalidOperation, ValueError):
                got.append(None)
        valid = np.array([g is not None and abs(g) < 10 ** t.precision
                          for g in got], dtype=np.bool_)
        vals = np.array([g if ok else 0 for g, ok in zip(got, valid)],
                        dtype=np.int64)
        return _V(t, vals, valid)
    if src.is_decimal and t.is_string:
        import decimal
        text = [str(decimal.Decimal(int(x)).scaleb(-src.scale))
                for x in c.values.tolist()]
        vals = [x if ok else None for x, ok in zip(text, c.valid)]
        return _V(t, pa.array(vals, type=pa.large_string()), c.valid)
    if src.is_decimal or t.is_decimal:
        from spark_rapids_tpu_torch.ops.cast import cast_colval
        return _via_torch(lambda a: cast_colval(a, t), n, c)
    if src.is_string:
        parse = (lambda s: _parse_integral(s, t.name)) if t.is_integral \
            else _parse_float if t.is_floating else \
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

def _exact_sum(func) -> bool:
    """Whether ``func`` sums a decimal: its partial sums are kept as two
    int64 words (``_split_words``), exact for any input."""
    return func.name in ("sum", "avg") and func.child is not None and \
        func.child.dtype.is_decimal


_LO32 = (1 << 32) - 1


def _split_words(v: np.ndarray):
    """int64 values as (high, low) 32-bit words, each summed in int64
    without overflow over fewer than 2^31 rows."""
    v = v.astype(np.int64)
    return v >> 32, v & _LO32


def _join_words(hi: np.ndarray, lo: np.ndarray):
    """(hi * 2^32 + lo as int64, whether it fits int64)."""
    hi = hi + (lo >> 32)
    lo = lo & _LO32
    ok = (hi >= -(1 << 31)) & (hi < (1 << 31))
    return np.where(ok, (hi << 32) | lo, 0), ok


def _decimal_avg(total: np.ndarray, ok: np.ndarray, cnt: np.ndarray,
                 in_scale: int, out: DataType):
    """HALF_UP ``total / cnt`` of unscaled sums at ``in_scale``, as
    unscaled values at ``out``'s scale, and their validity (overflow is
    null).  Exact: in int64 where ``total * 10^k`` fits, else in Python
    ints (the rare groups with a sum past 2^63 / 10^k)."""
    k = out.scale - in_scale
    f = 10 ** k
    has = ok & (cnt > 0)
    c = np.where(cnt > 0, cnt, 1).astype(np.int64)
    small = has & (np.abs(total) <= ((1 << 63) - 1) // f)
    num = np.where(small, total, 0) * f
    q = np.abs(num) // c
    q = np.where(2 * (np.abs(num) - q * c) >= c, q + 1, q)
    vals = np.where(num < 0, -q, q)
    for i in np.flatnonzero(has & ~small):
        t = int(total[i]) * f
        qi, ri = divmod(abs(t), int(c[i]))
        qi += 2 * ri >= int(c[i])
        vals[i] = -qi if t < 0 else qi
    bound = 10 ** out.precision
    valid = has & (vals > -bound) & (vals < bound)
    return np.where(valid, vals, 0), valid


def _agg_partial(funcs, keys: List[_V], children: List[Optional[_V]],
                 n: int):
    """One chunk's per-group partial states: the keys as ``k<i>`` and per
    aggregate its buffers (``s<j>`` a sum or min or max, ``n<j>`` the
    count of non-null inputs; a decimal sum keeps its high words in
    ``s<j>`` and its low words in ``l<j>``), and whether they are
    reduced.  A chunk whose first ``_SAMPLE_ROWS`` rows hold nearly as
    many groups as rows is not reduced here: its rows are their own
    partial states, grouped once with the others at the merge."""
    cols = {f"k{i}": k.series() for i, k in enumerate(keys)}
    spec = _partial_spec(funcs)
    for j, (func, c) in enumerate(zip(funcs, children)):
        valid = np.ones(n, dtype=np.bool_) if c is None else c.valid
        cols[f"n{j}"] = valid.astype(np.int64)
        if func.name == "count":
            continue
        if _exact_sum(func):
            hi, lo = _split_words(c.values)
            cols[f"s{j}"] = _V(dts.INT64, hi, c.valid).series()
            cols[f"l{j}"] = _V(dts.INT64, lo, c.valid).series()
        elif func.name == "avg":
            cols[f"s{j}"] = _V(dts.FLOAT64, c.values.astype(np.float64),
                               c.valid).series()
        else:
            cols[f"s{j}"] = (_V(func.result_dtype,
                                c.values.astype(func.result_dtype.storage),
                                c.valid) if func.name == "sum"
                             else c).series()
    frame = pd.DataFrame(cols)
    if keys and n >= 4 * _SAMPLE_ROWS:
        by = [f"k{i}" for i in range(len(keys))]
        seen = frame.iloc[:_SAMPLE_ROWS].groupby(
            by, dropna=False, sort=False).ngroups
        if seen > _SKIP_SHARE * _SAMPLE_ROWS:
            return frame, False
    return _merge_partials(frame, len(keys), spec), True


# rows of a chunk sampled to decide whether grouping it pays, and the
# share of them as groups past which it does not
_SAMPLE_ROWS = 1 << 16
_SKIP_SHARE = 0.5


def _partial_spec(funcs):
    """Partial column -> how partials merge (``sum``, ``min``, ``max``)."""
    spec = {}
    for j, f in enumerate(funcs):
        spec[f"n{j}"] = "sum"
        if f.name != "count":
            spec[f"s{j}"] = f.name if f.name in ("min", "max") else "sum"
        if _exact_sum(f):
            spec[f"l{j}"] = "sum"
    return spec


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


# threads of the fallback's host work (pandas' grouping runs outside the
# GIL)
_HOST_THREADS = min(8, os.cpu_count() or 1)
# parts of a large merge, grouped on those threads: a fixed number, so the
# merged frame's row order does not depend on the machine
_MERGE_PARTS = 8


def _host_pool():
    from concurrent.futures import ThreadPoolExecutor
    return ThreadPoolExecutor(max_workers=_HOST_THREADS,
                              thread_name_prefix="fallback-agg")


def _merge_parallel(pool, partials: List[pd.DataFrame], nkeys: int,
                    spec) -> pd.DataFrame:
    """:func:`_merge_partials` of the concatenated ``partials``, split by
    one key column's value into ``_MERGE_PARTS`` parts grouped on the
    pool: a group's rows share that value, so each part holds whole
    groups.  The column is the key with the most distinct values in a
    sample (so the parts come out even); the split, and so the result's
    row order, depends on the data alone, not on the pool's threads."""
    frame = pd.concat(partials, ignore_index=True) if len(partials) > 1 \
        else partials[0]
    if nkeys == 0 or len(frame) < 4 * _SAMPLE_ROWS:
        return _merge_partials(frame, nkeys, spec)
    head = frame.iloc[:_SAMPLE_ROWS]
    by = max(range(nkeys), key=lambda i: head[f"k{i}"].nunique(dropna=False))
    codes = pd.factorize(frame[f"k{by}"], use_na_sentinel=False)[0]
    part = codes % _MERGE_PARTS
    order = np.argsort(part, kind="stable")
    bounds = np.searchsorted(part[order], np.arange(_MERGE_PARTS + 1))
    rows = [order[a:b] for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
    merged = list(pool.map(
        lambda idx: _merge_partials(frame.take(idx), nkeys, spec), rows))
    return pd.concat(merged, ignore_index=True)


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
        return all(a.func.name in _HOST_AGGREGATES or
                   getattr(a.func, "single_pass", False) for a in aggs)
    return isinstance(node, (L.Project, L.Filter, L.Limit, L.Union, Expand,
                             L.FileRelation, L.InMemoryRelation, L.Sort,
                             L.Generate))


_HOST_AGGREGATES = ("count", "sum", "min", "max", "avg")


class CpuFallbackExec(TpuExec):
    """One logical node run on the host in pandas (see the module's
    docstring); its output batches land on ``device``."""

    # inputs up to this many rows sort in one pass; larger ones run the
    # external merge sort over spilled runs
    SORT_RUN_ROWS = 1 << 20
    # an aggregate holds this many partial rows before it merges them
    # (host memory: a few GiB at most), then twice the merged groups
    MERGE_ROWS = 1 << 25

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
        for table in self._child_tables(i):
            with self.timer(TO_HOST_TIME):
                frame = arrow_to_frame(table)
            yield frame

    def _child_tables(self, i: int):
        """Child i's output as arrow tables on the host, one per batch (at
        least one, possibly empty)."""
        empty = True
        it = self.children[i].execute()
        while True:
            with self.timer(CHILD_TIME):
                b = next(it, None)
            if b is None:
                break
            empty = False
            with self.timer(TO_HOST_TIME):
                table = b.to_arrow()
            yield table
        if empty:
            yield empty_batch(self.children[i].schema).to_arrow()

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
        if isinstance(node, L.Generate):
            for df in self._child_frames(0):
                yield self._build_batch(self._frame_of(
                    self._explode(node, df)))
            return
        reasons = f": {'; '.join(self.reasons)}" if self.reasons else ""
        raise NotImplementedError(
            f"no CPU fallback for {type(node).__name__}{reasons}")

    @staticmethod
    def _explode(node: L.Generate, df: pd.DataFrame) -> List[_V]:
        """A Generate over one frame: arrow's list kernels give each
        element's source row; null and empty arrays give no row."""
        import pyarrow as pa
        import pyarrow.compute as pc
        gens = [_eval(node.generator, df)] + (
            [] if node.generator2 is None else [_eval(node.generator2, df)])
        lists = [_with_nulls(g.values, g.valid) for g in gens]
        parents = pc.list_parent_indices(lists[0]).to_numpy(
            zero_copy_only=False).astype(np.int64)
        m = len(parents)
        out = [_take(_eval(e, df), parents) for e in node.required]
        if node.position:
            first = np.searchsorted(parents, parents, side="left")
            out.append(_V(dts.INT32,
                          (np.arange(m) - first).astype(np.int32),
                          np.ones(m, dtype=np.bool_)))
        for g, arr in zip(gens, lists):
            flat = pc.list_flatten(arr)
            edt = g.dt.element
            vals = _lstr(flat) if edt.is_string else flat.to_numpy(
                zero_copy_only=False).astype(edt.storage)
            out.append(_V(edt, vals, np.ones(m, dtype=np.bool_)))
        return out

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
        from spark_rapids_tpu_torch.columnar.nested import shred_table
        from spark_rapids_tpu_torch.io.readers import _file_column
        names = [n for n, _ in node.schema]
        got_any = False
        for rb in _dataset(node.paths, node.file_format).to_batches(
                columns=list(dict.fromkeys(_file_column(n)
                                           for n in names))):
            got_any = True
            table = shred_table(pa.Table.from_batches([rb]))
            yield self._build_batch(arrow_to_frame(table.select(names)))
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
        GpuHashAggregate partial/merge split, on the host), merged when
        their rows pass ``MERGE_ROWS`` and then twice the last merge's
        groups (so the work stays linear in the input); then finalize, and
        evaluate the outputs that combine aggregates over the (keys,
        aggregates) frame."""
        from spark_rapids_tpu_torch.plan.overrides import aggregate_outputs
        group = list(node.group_exprs)
        agg_list, out_named, _ = aggregate_outputs(group,
                                                   list(node.agg_exprs))
        funcs = [a.func for a in agg_list]
        if any(getattr(f, "single_pass", False) for f in funcs):
            return self._collect_frame(node, group, agg_list, out_named)
        for f in funcs:
            if f.name not in _HOST_AGGREGATES:
                raise NotImplementedError(f"CPU fallback aggregate {f.name}")
        spec = _partial_spec(funcs)
        nkeys = len(group)
        partials: List[pd.DataFrame] = []
        rows, merge_at, reduced = 0, self.MERGE_ROWS, True

        def partial(table):
            df = arrow_to_frame(table)
            if not len(df):
                return None, True
            keys = [_eval(g, df) for g in group]
            children = [None if f.child is None else _eval(f.child, df)
                        for f in funcs]
            return _agg_partial(funcs, keys, children, len(df))

        # chunks become frames and reduce on a thread pool (arrow's
        # conversion and pandas' grouping release the GIL) while the next
        # chunks come from the card; their partials are taken in input
        # order, so the result does not depend on the threads
        with _host_pool() as pool:
            pending: List = []
            for table in self._child_tables(0):
                if table.num_rows:
                    pending.append(pool.submit(partial, table))
                while pending and (len(pending) > _HOST_THREADS or
                                   pending[0].done()):
                    part, done = pending.pop(0).result()
                    if part is None:
                        continue
                    partials.append(part)
                    reduced = reduced and done
                    rows += len(part)
                    if rows >= merge_at and len(partials) > 1:
                        partials = [_merge_parallel(pool, partials, nkeys,
                                                    spec)]
                        rows, reduced = len(partials[0]), True
                        # merge again only once the partials have doubled:
                        # a merged frame of many groups is not re-grouped
                        # per chunk
                        merge_at = max(self.MERGE_ROWS, 2 * rows)
            for fut in pending:
                part, done = fut.result()
                if part is not None:
                    partials.append(part)
                    reduced = reduced and done
            if len(partials) > 1 or (partials and not reduced):
                partials = [_merge_parallel(pool, partials, nkeys, spec)]
        if not partials:
            if nkeys:
                merged = None
            else:
                # a global aggregate answers one row on empty input
                merged = pd.DataFrame(
                    {c: pd.array([0 if c.startswith("n") else None],
                                 dtype="Float64" if c.startswith("s")
                                 else "Int64") for c in spec})
        else:
            merged = partials[0]
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
                has = cnt.values > 0
                if _exact_sum(f):
                    hi = _from_series(merged[f"s{j}"], dts.INT64).values
                    lo = _from_series(merged[f"l{j}"], dts.INT64).values
                    total, ok = _join_words(hi, lo)
                    if f.name == "avg":
                        vals, valid = _decimal_avg(
                            total, ok, cnt.values, f.child.dtype.scale,
                            a.dtype)
                    else:
                        bound = 10 ** a.dtype.precision
                        valid = ok & has & (total > -bound) & \
                            (total < bound)
                        vals = np.where(valid, total, 0)
                    inner.append(_V(a.dtype, vals, valid))
                    continue
                s = _from_series(merged[f"s{j}"], a.dtype if f.name != "avg"
                                 else dts.FLOAT64)
                if f.name == "avg":
                    with np.errstate(all="ignore"):
                        vals = s.values / np.where(has, cnt.values, 1)
                    inner.append(_V(dts.FLOAT64, vals, has))
                else:
                    inner.append(_V(a.dtype, s.values, s.valid & has))
        frame = self._frame_of(inner)
        return self._frame_of(inner[:nkeys] +
                              [_eval(e, frame) for _, e in out_named])


    def _collect_frame(self, node: L.Aggregate, group, agg_list,
                       out_named) -> pd.DataFrame:
        """An aggregate with collect_list / collect_set over the whole
        child in pandas: groups in ascending key order (nulls last), a
        list keeps its group's non-null values in input order, a set its
        distinct non-null values ascending; count, sum, min, max and avg
        beside them through pandas' grouping."""
        import pyarrow as pa
        df = self._child_frame(0)
        n = len(df)
        keys = [_eval(g, df) for g in group]
        if keys:
            kf = pd.DataFrame({i: k.series() for i, k in enumerate(keys)})
            gid = kf.groupby(list(range(len(keys))), sort=True,
                             dropna=False).ngroup().to_numpy()
        else:
            gid = np.zeros(n, dtype=np.int64)
        ng = int(gid.max()) + 1 if n else (0 if keys else 1)
        order = np.argsort(gid, kind="stable")
        first = np.full(ng, -1, dtype=np.int64)
        first[gid[order][::-1]] = order[::-1]
        inner = [_take(k, first) for k in keys]
        for a in agg_list:
            f = a.func
            c = None if f.child is None else _eval(f.child, df)
            if getattr(f, "single_pass", False):
                vals = c.series().to_numpy(dtype=object, na_value=None)
                lists: List[list] = [[] for _ in range(ng)]
                for i in order:
                    if c.valid[i]:
                        lists[gid[i]].append(vals[i])
                if f.dedup:
                    lists = [sorted(set(x), key=lambda v: (
                        isinstance(v, float) and np.isnan(v), v))
                        for x in lists]
                inner.append(_V(a.dtype, pa.array(
                    lists, dts.to_arrow_type(a.dtype)),
                    np.ones(ng, dtype=np.bool_)))
                continue
            if f.name not in _HOST_AGGREGATES:
                raise NotImplementedError(f"CPU fallback aggregate {f.name}")
            series = pd.Series(np.ones(n)) if c is None else c.series()
            grouped = series.groupby(gid)
            how = {"avg": "mean"}.get(f.name, f.name)
            got = getattr(grouped, how)().reindex(range(ng))
            if f.name == "count":
                got = got.fillna(0)
            inner.append(_from_series(got.reset_index(drop=True), a.dtype))
        frame = self._frame_of(inner)
        nkeys = len(group)
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
    if v.dt.is_array:
        return _with_nulls(v.values, v.valid).cast(at)
    mask = None if v.valid.all() else ~v.valid
    if v.dt.is_date:
        return pa.array(v.values.astype(np.int32), type=pa.int32(),
                        mask=mask).cast(pa.date32())
    if v.dt.is_timestamp:
        return pa.array(v.values.astype(np.int64), type=pa.int64(),
                        mask=mask).cast(at)
    if v.dt.is_decimal:
        from spark_rapids_tpu_torch.columnar.column import decimal_array
        return decimal_array(v.values, v.valid, v.dt)
    return pa.array(v.values.astype(v.dt.storage), type=at, mask=mask)
