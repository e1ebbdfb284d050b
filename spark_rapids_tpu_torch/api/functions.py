"""PySpark-flavoured column DSL.

Counterpart of ``spark_rapids_tpu/api/functions.py``, cut to what the
ported slices run: column references, literals (numbers, bools, strings,
dates, decimals), arithmetic (``%`` and unary minus too), ``abs``, the
math functions, ``floor``/``ceil``, ``round``/``bround``, ``pmod``,
``pow``, ``atan2``, ``hypot``, the bitwise operators and shifts,
comparisons, logic, null tests, ``isnan``, ``greatest``/``least``, casts,
``isin``, the string predicates (``startswith``, ``endswith``,
``contains``, ``like``, ``rlike``), the string functions (``length``,
case mapping, trims, pads, ``concat``/``concat_ws``, ``locate``,
``repeat``, ``substring``/``substring_index``, ``ascii``/``chr``,
``regexp_replace``, ``replace``, ``translate``, ``split``, which is an
array of strings on the host and ``split(...).getItem(n)`` on the card),
``get_json_object``, the nested types (``array``, ``struct``,
``create_map``, ``size``, ``element_at``, ``array_contains``,
``sort_array``, ``array_min``/``array_max``, ``reverse``, ``slice``,
``array_repeat``, ``map_keys``/``map_values``, ``getItem``/``getField``
and ``[]`` on arrays, maps and structs, ``explode``/``posexplode`` in a
select, ``collect_list``/``collect_set``), time windows (``window``),
``hash``/``md5``, ``monotonically_increasing_id``/``spark_partition_id``,
``when``/``otherwise``, ``coalesce``, the date parts, date and time
arithmetic and formatting (``date_format``, ``unix_timestamp``,
``from_unixtime``, ``months_between``, ``trunc`` ...),
``input_file_name`` and ``_metadata`` field access over file scans, sort
keys, the sum / avg / count / min / max / first / last aggregates and the
variance family, ``grouping``/``grouping_id`` (rollup, cube, grouping
sets), window functions (``Window`` specs, ``.over``: the ranking
functions, ``lead``/``lag`` and the ``window_*`` aggregates), and user
code: ``udf`` (compiled from bytecode, else a black box; ``pandas_udf``
is ``udf``, as in the JAX package), ``tpu_udf`` (a torch function as an
expression) and ``pandas_agg_udf`` (grouped-aggregate and window pandas
UDFs).
"""

from __future__ import annotations

from typing import Optional, Union

from spark_rapids_tpu_torch.columnar.dtypes import DataType, dtype_from_name
from spark_rapids_tpu_torch.ops import aggregates as agg
from spark_rapids_tpu_torch.ops import arithmetic as arith
from spark_rapids_tpu_torch.ops import datetime_ops as D
from spark_rapids_tpu_torch.ops import misc_exprs as ME
from spark_rapids_tpu_torch.ops import predicates as preds
from spark_rapids_tpu_torch.ops import regexops as RX
from spark_rapids_tpu_torch.ops import stringops as S
from spark_rapids_tpu_torch.ops.cast import Cast
from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.ops.expressions import (
    Alias, Expression, Literal, UnresolvedColumn)
from spark_rapids_tpu_torch.plan.logical import AggregateExpression

ColumnLike = Union["Col", str, int, float, bool]


def _expr(c: ColumnLike) -> Expression:
    if isinstance(c, Col):
        return c.expr
    if isinstance(c, Expression):
        return c
    if isinstance(c, str):
        return UnresolvedColumn(c)
    return Literal(c)


def _lit_expr(c) -> Expression:
    """Like _expr, but a bare value is always a literal."""
    if isinstance(c, Col):
        return c.expr
    if isinstance(c, Expression):
        return c
    return Literal(c)


class Col:
    """Python operators over expression trees."""

    def __init__(self, expr: Expression):
        self.expr = expr

    def __add__(self, o):
        return Col(arith.Add(self.expr, _lit_expr(o)))

    def __radd__(self, o):
        return Col(arith.Add(_lit_expr(o), self.expr))

    def __sub__(self, o):
        return Col(arith.Subtract(self.expr, _lit_expr(o)))

    def __rsub__(self, o):
        return Col(arith.Subtract(_lit_expr(o), self.expr))

    def __mul__(self, o):
        return Col(arith.Multiply(self.expr, _lit_expr(o)))

    def __rmul__(self, o):
        return Col(arith.Multiply(_lit_expr(o), self.expr))

    def __truediv__(self, o):
        return Col(arith.Divide(self.expr, _lit_expr(o)))

    def __rtruediv__(self, o):
        return Col(arith.Divide(_lit_expr(o), self.expr))

    def __mod__(self, o):
        return Col(arith.Remainder(self.expr, _lit_expr(o)))

    def __neg__(self):
        return Col(arith.UnaryMinus(self.expr))

    def __eq__(self, o):  # type: ignore[override]
        return Col(preds.EqualTo(self.expr, _lit_expr(o)))

    def __ne__(self, o):  # type: ignore[override]
        return Col(preds.Not(preds.EqualTo(self.expr, _lit_expr(o))))

    def __lt__(self, o):
        return Col(preds.LessThan(self.expr, _lit_expr(o)))

    def __le__(self, o):
        return Col(preds.LessThanOrEqual(self.expr, _lit_expr(o)))

    def __gt__(self, o):
        return Col(preds.GreaterThan(self.expr, _lit_expr(o)))

    def __ge__(self, o):
        return Col(preds.GreaterThanOrEqual(self.expr, _lit_expr(o)))

    def __and__(self, o):
        return Col(preds.And(self.expr, _lit_expr(o)))

    def __or__(self, o):
        return Col(preds.Or(self.expr, _lit_expr(o)))

    def bitwiseAND(self, o):
        return Col(arith.BitwiseAnd(self.expr, _lit_expr(o)))

    def bitwiseOR(self, o):
        return Col(arith.BitwiseOr(self.expr, _lit_expr(o)))

    def bitwiseXOR(self, o):
        return Col(arith.BitwiseXor(self.expr, _lit_expr(o)))

    def __invert__(self):
        return Col(preds.Not(self.expr))

    def alias(self, name: str) -> "Col":
        return Col(Alias(self.expr, name))

    def isNull(self) -> "Col":
        return Col(preds.IsNull(self.expr))

    def isNotNull(self) -> "Col":
        return Col(preds.IsNotNull(self.expr))

    def cast(self, dtype: Union[str, DataType]) -> "Col":
        if isinstance(dtype, str):
            dtype = dtype_from_name(dtype)
        return Col(Cast(self.expr, dtype))

    def isin(self, *values) -> "Col":
        if len(values) == 1 and isinstance(values[0], (list, tuple, set)):
            values = tuple(values[0])
        # a large non-string literal set is one sorted-table lookup
        if len(values) > 16 and not any(isinstance(v, str)
                                        for v in values):
            return Col(preds.InSet(self.expr, list(values)))
        return Col(preds.In(self.expr, [Literal(v) for v in values]))

    def startswith(self, prefix: str) -> "Col":
        return Col(S.StartsWith(self.expr, prefix))

    def endswith(self, suffix: str) -> "Col":
        return Col(S.EndsWith(self.expr, suffix))

    def contains(self, needle: str) -> "Col":
        return Col(S.Contains(self.expr, needle))

    def like(self, pattern: str) -> "Col":
        return Col(S.Like(self.expr, pattern))

    def rlike(self, pattern: str) -> "Col":
        return Col(RX.RLike(self.expr, pattern))

    def substr(self, pos: int, length: int = 2**31 - 1) -> "Col":
        return Col(S.Substring(self.expr, pos, length))

    def getItem(self, key) -> "Col":
        """A struct field (a str key), ``split(c, d)[n]`` (the device's
        ``SplitPart``), an array's n-th element (0-based) or, on a map
        column, the value of key ``key``."""
        if isinstance(key, str):
            return self.getField(key)
        from spark_rapids_tpu_torch.ops.collections_ops import GetArrayItem
        from spark_rapids_tpu_torch.ops.json_ops import StringSplit
        if isinstance(self.expr, StringSplit) and self.expr.limit == -1:
            return Col(RX.SplitPart(self.expr.children[0],
                                    self.expr.pattern, int(key)))
        return Col(GetArrayItem(self.expr, _lit_expr(key)))

    __getitem__ = getItem

    def getField(self, field: str) -> "Col":
        """A field of a struct column (its shredded flat column)."""
        from spark_rapids_tpu_torch.ops.nested_ops import GetStructField
        return Col(GetStructField(self.expr, field))

    def between(self, lo, hi) -> "Col":
        return Col(preds.And(
            preds.GreaterThanOrEqual(self.expr, _lit_expr(lo)),
            preds.LessThanOrEqual(self.expr, _lit_expr(hi))))

    def asc(self) -> "SortKey":
        return SortKey(self.expr, descending=False, nulls_first=True)

    def desc(self) -> "SortKey":
        return SortKey(self.expr, descending=True, nulls_first=False)

    def asc_nulls_first(self) -> "SortKey":
        return SortKey(self.expr, descending=False, nulls_first=True)

    def asc_nulls_last(self) -> "SortKey":
        return SortKey(self.expr, descending=False, nulls_first=False)

    def desc_nulls_first(self) -> "SortKey":
        return SortKey(self.expr, descending=True, nulls_first=True)

    def desc_nulls_last(self) -> "SortKey":
        return SortKey(self.expr, descending=True, nulls_first=False)

    def __repr__(self):
        return f"Col({self.expr})"


class SortKey:
    """One ``orderBy`` key: an expression, its direction and where its
    nulls go (Spark's defaults: first ascending, last descending)."""

    def __init__(self, expr: Expression, descending: bool,
                 nulls_first: bool):
        self.expr = expr
        self.descending = descending
        self.nulls_first = nulls_first

    def nullsFirst(self) -> "SortKey":
        return SortKey(self.expr, self.descending, True)

    def nullsLast(self) -> "SortKey":
        return SortKey(self.expr, self.descending, False)


def col(name: str) -> Col:
    return Col(UnresolvedColumn(name))


def lit(value, dtype: Optional[DataType] = None) -> Col:
    return Col(Literal(value, dtype))


def input_file_name() -> Col:
    """The path of the file each row was read from (resolves against the
    file scan, which then adds the column)."""
    from spark_rapids_tpu_torch.plan.logical import FileRelation
    return Col(UnresolvedColumn(FileRelation.INPUT_FILE_COL))


def when(condition: Col, value) -> "CaseBuilder":
    return CaseBuilder([(condition.expr, _lit_expr(value))])


class CaseBuilder(Col):
    """``when(...).when(...).otherwise(...)``."""

    def __init__(self, branches):
        self.branches = branches
        super().__init__(preds.CaseWhen(branches))

    def when(self, condition: Col, value) -> "CaseBuilder":
        return CaseBuilder(self.branches + [(condition.expr,
                                             _lit_expr(value))])

    def otherwise(self, value) -> Col:
        return Col(preds.CaseWhen(self.branches, _lit_expr(value)))


def abs(c) -> Col:  # noqa: A001 - pyspark.sql.functions.abs
    return Col(arith.Abs(_expr(c)))


def coalesce(*cols) -> Col:
    return Col(preds.Coalesce(*[_expr(c) for c in cols]))


def substring(c, pos: int, length_: int = 2**31 - 1) -> Col:
    return Col(S.Substring(_expr(c), pos, length_))


def isnan(c) -> Col:
    return Col(preds.IsNaN(_expr(c)))


def greatest(*cols) -> Col:
    return Col(preds.Greatest(*[_expr(c) for c in cols]))


def least(*cols) -> Col:
    return Col(preds.Least(*[_expr(c) for c in cols]))


# ------------------------------------------------------------------ strings

def length(c) -> Col:
    return Col(S.Length(_expr(c)))


def octet_length(c) -> Col:
    return Col(S.OctetLength(_expr(c)))


def upper(c) -> Col:
    return Col(S.Upper(_expr(c)))


def lower(c) -> Col:
    return Col(S.Lower(_expr(c)))


def initcap(c) -> Col:
    return Col(S.InitCap(_expr(c)))


def concat(*cols) -> Col:
    return Col(S.ConcatStrings(*[_expr(c) for c in cols]))


def concat_ws(sep: str, *cols) -> Col:
    return Col(RX.ConcatWs(sep, *[_expr(c) for c in cols]))


def trim(c) -> Col:
    return Col(S.StringTrim(_expr(c)))


def ltrim(c) -> Col:
    return Col(S.StringTrimLeft(_expr(c)))


def rtrim(c) -> Col:
    return Col(S.StringTrimRight(_expr(c)))


def lpad(c, width: int, pad: str = " ") -> Col:
    return Col(S.StringLPad(_expr(c), width, pad))


def rpad(c, width: int, pad: str = " ") -> Col:
    return Col(S.StringRPad(_expr(c), width, pad))


def locate(substr: str, c, start: int = 1) -> Col:
    return Col(S.StringLocate(substr, _expr(c), start))


def substring_index(c, delim: str, count: int) -> Col:
    return Col(S.SubstringIndex(_expr(c), delim, count))


def repeat(c, n: int) -> Col:
    return Col(S.StringRepeat(_expr(c), n))


def ascii(c) -> Col:  # noqa: A001
    return Col(S.Ascii(_expr(c)))


def chr(c) -> Col:  # noqa: A001
    return Col(S.Chr(_expr(c)))


def rlike(c, pattern: str) -> Col:
    return Col(RX.RLike(_expr(c), pattern))


def regexp_replace(c, pattern: str, replacement: str) -> Col:
    return Col(RX.RegExpReplace(_expr(c), pattern, replacement))


def replace(c, search: str, replacement: str = "") -> Col:
    return Col(RX.StringReplace(_expr(c), search, replacement))


def translate(c, from_str: str, to_str: str) -> Col:
    return Col(RX.Translate(_expr(c), from_str, to_str))


def split(c, pattern: str, limit: int = -1) -> Col:
    """split(str, regex) -> array<string>, evaluated on the host (the CPU
    fallback); ``split(...).getItem(n)`` is the device's ``SplitPart``."""
    from spark_rapids_tpu_torch.ops.json_ops import StringSplit
    return Col(StringSplit(_expr(c), pattern, limit))


def get_json_object(c, path: str) -> Col:
    """A JSONPath subset ($.field, $.a.b, $[n]) of a JSON string column,
    evaluated on the host (the CPU fallback)."""
    from spark_rapids_tpu_torch.ops.json_ops import GetJsonObject
    return Col(GetJsonObject(_expr(c), path))


# ------------------------------------------------------ hashes and ids

def hash(*cols) -> Col:  # noqa: A001 - Spark calls it hash()
    return Col(ME.Murmur3Hash(*[_expr(c) for c in cols]))


def md5(c) -> Col:
    return Col(ME.Md5(_expr(c)))


def monotonically_increasing_id() -> Col:
    return Col(ME._BatchIdMarker("mid"))


def spark_partition_id() -> Col:
    return Col(ME._BatchIdMarker("pid"))


# ---------------------------------------------------------------- date/time

def year(c) -> Col:
    return Col(D.Year(_expr(c)))


def month(c) -> Col:
    return Col(D.Month(_expr(c)))


def dayofmonth(c) -> Col:
    return Col(D.DayOfMonth(_expr(c)))


def dayofweek(c) -> Col:
    return Col(D.DayOfWeek(_expr(c)))


def weekday(c) -> Col:
    return Col(D.WeekDay(_expr(c)))


def dayofyear(c) -> Col:
    return Col(D.DayOfYear(_expr(c)))


def quarter(c) -> Col:
    return Col(D.Quarter(_expr(c)))


def hour(c) -> Col:
    return Col(D.Hour(_expr(c)))


def minute(c) -> Col:
    return Col(D.Minute(_expr(c)))


def second(c) -> Col:
    return Col(D.Second(_expr(c)))


def last_day(c) -> Col:
    return Col(D.LastDay(_expr(c)))


def next_day(c, day_of_week: str) -> Col:
    return Col(D.NextDay(_expr(c), day_of_week))


def date_add(c, days) -> Col:
    return Col(D.DateAdd(_expr(c), _lit_expr(days)))


def date_sub(c, days) -> Col:
    return Col(D.DateSub(_expr(c), _lit_expr(days)))


def datediff(end, start) -> Col:
    return Col(D.DateDiff(_expr(end), _expr(start)))


def add_months(c, months) -> Col:
    return Col(D.AddMonths(_expr(c), _lit_expr(months)))


def months_between(a, b, roundOff: bool = True) -> Col:
    return Col(D.MonthsBetween(_expr(a), _expr(b), roundOff))


def trunc(c, fmt: str) -> Col:
    return Col(D.TruncDate(_expr(c), fmt))


def unix_timestamp(c) -> Col:
    return Col(D.UnixTimestamp(_expr(c)))


def to_unix_timestamp(c) -> Col:
    return Col(D.ToUnixTimestamp(_expr(c)))


def from_unixtime(c) -> Col:
    return Col(D.FromUnixTime(_expr(c)))


def date_format(c, fmt: str) -> Col:
    """Format a date or timestamp: on the device for fixed-width
    patterns (yyyy/MM/dd/HH/mm/ss and separators), other patterns in the
    CPU fallback."""
    return Col(D.DateFormatClass(_expr(c), fmt))


# ------------------------------------------------------------ math functions

def _unary_fn(cls):
    def fn(c) -> Col:
        return Col(cls(_expr(c)))
    fn.__name__ = cls.__name__.lower()
    return fn


# the double-typed math unaries (the reference's CudfUnaryMathExpression
# family), floor / ceil and the bitwise not
sqrt = _unary_fn(arith.Sqrt)
cbrt = _unary_fn(arith.Cbrt)
exp = _unary_fn(arith.Exp)
expm1 = _unary_fn(arith.Expm1)
log = _unary_fn(arith.Log)
log2 = _unary_fn(arith.Log2)
log10 = _unary_fn(arith.Log10)
log1p = _unary_fn(arith.Log1p)
sin = _unary_fn(arith.Sin)
cos = _unary_fn(arith.Cos)
tan = _unary_fn(arith.Tan)
cot = _unary_fn(arith.Cot)
asin = _unary_fn(arith.Asin)
acos = _unary_fn(arith.Acos)
atan = _unary_fn(arith.Atan)
sinh = _unary_fn(arith.Sinh)
cosh = _unary_fn(arith.Cosh)
tanh = _unary_fn(arith.Tanh)
asinh = _unary_fn(arith.Asinh)
acosh = _unary_fn(arith.Acosh)
atanh = _unary_fn(arith.Atanh)
degrees = _unary_fn(arith.ToDegrees)
radians = _unary_fn(arith.ToRadians)
rint = _unary_fn(arith.Rint)
signum = _unary_fn(arith.Signum)
floor = _unary_fn(arith.Floor)
ceil = _unary_fn(arith.Ceil)
ceiling = ceil
bitwise_not = _unary_fn(arith.BitwiseNot)
bitwiseNOT = bitwise_not
ln = log


def _col_or_lit(v) -> Expression:
    """pyspark's coercion: a str or Col is a column, else a literal."""
    if isinstance(v, (str, Col)):
        return _expr(v)
    return _lit_expr(v)


def atan2(y, x) -> Col:
    return Col(arith.Atan2(_col_or_lit(y), _col_or_lit(x)))


def hypot(a, b) -> Col:
    return Col(arith.Hypot(_col_or_lit(a), _col_or_lit(b)))


def logarithm(base, x) -> Col:
    """``log(base, x)`` (SQL's two-argument ``log``)."""
    return Col(arith.Logarithm(_col_or_lit(base), _col_or_lit(x)))


def pow(base, exp) -> Col:  # noqa: A001
    return Col(arith.Pow(_expr(base), _lit_expr(exp)))


def pmod(dividend, divisor) -> Col:
    return Col(arith.Pmod(_col_or_lit(dividend), _col_or_lit(divisor)))


def round(c, scale: int = 0) -> Col:  # noqa: A001
    return Col(arith.Round(_expr(c), scale))


def bround(c, scale: int = 0) -> Col:
    return Col(arith.BRound(_expr(c), scale))


def shiftleft(c, n: int) -> Col:
    return Col(arith.ShiftLeft(_expr(c), _lit_expr(n)))


def shiftright(c, n: int) -> Col:
    return Col(arith.ShiftRight(_expr(c), _lit_expr(n)))


def shiftrightunsigned(c, n: int) -> Col:
    return Col(arith.ShiftRightUnsigned(_expr(c), _lit_expr(n)))



def _agg(func_cls, c, **kw) -> Col:
    return Col(AggregateExpression(func_cls(_expr(c), **kw)))


def sum(c) -> Col:  # noqa: A001
    return _agg(agg.Sum, c)


def count(c="*") -> Col:
    # not `c == "*"`: Col.__eq__ builds an expression
    if (isinstance(c, str) and c == "*") or \
            (isinstance(c, Col) and isinstance(c.expr, Literal)):
        return Col(AggregateExpression(agg.Count(None)))
    return _agg(agg.Count, c)


def avg(c) -> Col:
    return _agg(agg.Average, c)


def min(c) -> Col:  # noqa: A001
    return _agg(agg.Min, c)


def max(c) -> Col:  # noqa: A001
    return _agg(agg.Max, c)


def first(c, ignore_nulls: bool = False) -> Col:
    return _agg(agg.First, c, ignore_nulls=ignore_nulls)


def last(c, ignore_nulls: bool = False) -> Col:
    return _agg(agg.Last, c, ignore_nulls=ignore_nulls)


def stddev(c) -> Col:
    """Sample standard deviation (Spark stddev / stddev_samp)."""
    return _agg(agg.StddevSamp, c)


stddev_samp = stddev


def stddev_pop(c) -> Col:
    return _agg(agg.StddevPop, c)


def variance(c) -> Col:
    """Sample variance (Spark variance / var_samp)."""
    return _agg(agg.VarianceSamp, c)


var_samp = variance


def var_pop(c) -> Col:
    return _agg(agg.VariancePop, c)


def collect_list(c) -> Col:
    return _agg(agg.CollectList, c)


def collect_set(c) -> Col:
    return _agg(agg.CollectSet, c)


# ------------------------------------------------- nested types, windows

class _ExplodeMarker(Expression):
    """A select-time marker that ``DataFrame.select`` turns into a
    Generate node (Spark plans explode/posexplode the same way)."""

    def __init__(self, child: Expression, position: bool):
        self.children = (child,)
        self.position = position

    @property
    def dtype(self):
        return self.children[0].dtype.element

    def with_children(self, children):
        return _ExplodeMarker(children[0], self.position)

    @property
    def name(self) -> str:
        return "col"


def explode(c) -> Col:
    return Col(_ExplodeMarker(_expr(c), position=False))


def posexplode(c) -> Col:
    return Col(_ExplodeMarker(_expr(c), position=True))


def array(*cols) -> Col:
    from spark_rapids_tpu_torch.ops.collections_ops import CreateArray
    return Col(CreateArray(*[_expr(c) for c in cols]))


def size(c) -> Col:
    from spark_rapids_tpu_torch.ops.collections_ops import Size
    return Col(Size(_expr(c)))


def array_contains(c, value) -> Col:
    from spark_rapids_tpu_torch.ops.collections_ops import ArrayContains
    return Col(ArrayContains(_expr(c), _lit_expr(value)))


def get_array_item(c, index) -> Col:
    from spark_rapids_tpu_torch.ops.collections_ops import GetArrayItem
    return Col(GetArrayItem(_expr(c), _lit_expr(index)))


def element_at(c, index) -> Col:
    """1-based array element (negative from the end), or a map's value
    at a key."""
    from spark_rapids_tpu_torch.ops.collections_ops import ElementAt
    return Col(ElementAt(_expr(c), _lit_expr(index)))


def sort_array(c, asc: bool = True) -> Col:
    from spark_rapids_tpu_torch.ops.collections_ops import SortArray
    return Col(SortArray(_expr(c), asc))


def array_min(c) -> Col:
    from spark_rapids_tpu_torch.ops.collections_ops import ArrayMin
    return Col(ArrayMin(_expr(c)))


def array_max(c) -> Col:
    from spark_rapids_tpu_torch.ops.collections_ops import ArrayMax
    return Col(ArrayMax(_expr(c)))


def slice(c, start: int, length: int) -> Col:  # noqa: A001
    from spark_rapids_tpu_torch.ops.collections_ops import Slice
    return Col(Slice(_expr(c), start, length))


def array_repeat(c, times: int) -> Col:
    """A bare string is a column reference (as in PySpark); repeat a
    literal string with ``F.lit``."""
    from spark_rapids_tpu_torch.ops.collections_ops import ArrayRepeat
    return Col(ArrayRepeat(_expr(c), times))


def reverse(c) -> Col:
    """reverse() of an array (element order) or a string (byte-wise on
    the card: the ASCII-only incompatible class)."""
    from spark_rapids_tpu_torch.ops.collections_ops import Reverse
    return Col(Reverse(_expr(c)))


def struct(*cols) -> Col:
    """struct(c1, c2, ...): each field named by its column's name or
    alias."""
    from spark_rapids_tpu_torch.ops.nested_ops import CreateNamedStruct
    pairs = []
    for c in cols:
        e = _expr(c)
        if isinstance(e, Alias):
            pairs.append((e.alias, e.children[0]))
        else:
            pairs.append((e.name, e))
    return Col(CreateNamedStruct(pairs))


def create_map(*entries) -> Col:
    """create_map(k1, v1, k2, v2, ...)."""
    from spark_rapids_tpu_torch.ops.nested_ops import CreateMap
    return Col(CreateMap(*[_lit_expr(e) for e in entries]))


def map_keys(c) -> Col:
    from spark_rapids_tpu_torch.ops.nested_ops import MapKeys
    return Col(MapKeys(_expr(c)))


def map_values(c) -> Col:
    from spark_rapids_tpu_torch.ops.nested_ops import MapValues
    return Col(MapValues(_expr(c)))


def get_map_value(c, key) -> Col:
    from spark_rapids_tpu_torch.ops.nested_ops import GetMapValue
    return Col(GetMapValue(_expr(c), _lit_expr(key)))


def _parse_duration_us(s: str) -> int:
    import re
    m = re.fullmatch(
        r"\s*(\d+)\s*(microsecond|millisecond|second|minute|hour|day|"
        r"week)s?\s*", s)
    if not m:
        raise ValueError(f"cannot parse duration {s!r}")
    unit = {"microsecond": 1, "millisecond": 1_000, "second": 1_000_000,
            "minute": 60_000_000, "hour": 3_600_000_000,
            "day": 86_400_000_000, "week": 604_800_000_000}[m.group(2)]
    return int(m.group(1)) * unit


def window(c, window_duration: str, slide_duration: Optional[str] = None,
           start_time: str = "0 seconds") -> Col:
    """Tumbling or sliding time windows: a (start, end) struct column
    named ``window``, for a groupBy (the reference's GpuTimeWindow)."""
    from spark_rapids_tpu_torch.ops.nested_ops import CreateNamedStruct
    win = _parse_duration_us(window_duration)
    slide = _parse_duration_us(slide_duration) if slide_duration else win
    start = _parse_duration_us(start_time)
    e = _expr(c)
    return Col(Alias(CreateNamedStruct(
        [("start", D.TimeWindow(e, win, slide, start, "start")),
         ("end", D.TimeWindow(e, win, slide, start, "end"))]), "window"))


# ------------------------------------------------------------------- windows

class Window:
    """Window spec (the ``pyspark.sql.Window`` surface)."""

    unboundedPreceding = None
    unboundedFollowing = None
    currentRow = 0

    def __init__(self, partition=(), orders=(), frame=None):
        self._partition = list(partition)
        self._orders = list(orders)
        self._frame = frame

    @classmethod
    def partitionBy(cls, *cols) -> "Window":
        return cls(partition=[_expr(c) for c in cols])

    def orderBy(self, *keys) -> "Window":
        orders = []
        for k in keys:
            if isinstance(k, SortKey):
                orders.append((k.expr, k.descending, k.nulls_first))
            else:
                orders.append((_expr(k), False, True))
        return Window(self._partition, orders, self._frame)

    def rowsBetween(self, start, end) -> "Window":
        from spark_rapids_tpu_torch.exec.window import Frame
        return Window(self._partition, self._orders,
                      Frame("rows", start, end))

    def rangeBetween(self, start, end) -> "Window":
        from spark_rapids_tpu_torch.exec.window import Frame
        return Window(self._partition, self._orders,
                      Frame("range", start, end))

    def _spec(self):
        from spark_rapids_tpu_torch.exec.window import WindowSpec
        return WindowSpec(self._partition, self._orders, self._frame)


class _WindowFunc(Col):
    """A window function waiting for ``.over(window)``."""

    def __init__(self, kind: str, child=None, offset: int = 1,
                 default=None):
        self._kind = kind
        self._child = child
        self._offset = offset
        self._default = default

    def over(self, window: Window) -> Col:
        from spark_rapids_tpu_torch.exec.window import WindowExpression
        return Col(WindowExpression(
            self._kind, window._spec(),
            child=None if self._child is None else _expr(self._child),
            offset=self._offset,
            default=None if self._default is None
            else _lit_expr(self._default)))


def row_number() -> _WindowFunc:
    return _WindowFunc("row_number")


def rank() -> _WindowFunc:
    return _WindowFunc("rank")


def dense_rank() -> _WindowFunc:
    return _WindowFunc("dense_rank")


def percent_rank() -> _WindowFunc:
    return _WindowFunc("percent_rank")


def lead(c, offset: int = 1, default=None) -> _WindowFunc:
    return _WindowFunc("lead", c, offset, default)


def lag(c, offset: int = 1, default=None) -> _WindowFunc:
    return _WindowFunc("lag", c, offset, default)


def window_sum(c) -> _WindowFunc:
    return _WindowFunc("sum", c)


def window_count(c="*") -> _WindowFunc:
    return _WindowFunc(
        "count", None if isinstance(c, str) and c == "*" else c)


def window_min(c) -> _WindowFunc:
    return _WindowFunc("min", c)


def window_max(c) -> _WindowFunc:
    return _WindowFunc("max", c)


def window_avg(c) -> _WindowFunc:
    return _WindowFunc("avg", c)


# ------------------------------------------------------------ grouping sets

class _GroupingIdMarker(Expression):
    """Placeholder for ``grouping_id()``: ``GroupedData.agg`` rewrites it
    to the grouping-id column the Expand produces."""

    children = ()

    @property
    def dtype(self):
        return dts.INT64

    @property
    def nullable(self):
        return False

    @property
    def name(self):
        return "grouping_id()"

    def emit(self, ctx):
        raise RuntimeError(
            "grouping_id() is only valid in rollup/cube/groupingSets "
            "aggregations")

    def cache_key(self):
        return ("_GroupingIdMarker",)


class _GroupingMarker(Expression):
    """Placeholder for ``grouping(col)`` (1 when the column is
    aggregated away in this output row, else 0)."""

    def __init__(self, child: Expression):
        self.children = (child,)

    def with_children(self, children):
        return _GroupingMarker(children[0])

    @property
    def dtype(self):
        return dts.INT32

    @property
    def nullable(self):
        return False

    @property
    def name(self):
        return f"grouping({self.children[0].name})"

    def emit(self, ctx):
        raise RuntimeError(
            "grouping() is only valid in rollup/cube/groupingSets "
            "aggregations")

    def cache_key(self):
        return ("_GroupingMarker", self.children[0].cache_key())


def grouping_id() -> Col:
    """Bit vector of the aggregated-away grouping columns (bit i,
    MSB-first over the grouping columns, is 1 when column i is rolled
    up in this row)."""
    return Col(_GroupingIdMarker())


def grouping(c) -> Col:
    """1 when the grouping column is aggregated away in this row, else 0
    (int32, as in the JAX package, where Spark returns tinyint)."""
    return Col(_GroupingMarker(_expr(c)))


# --------------------------------------------------------------------- udfs

def _return_type(rt) -> DataType:
    return dtype_from_name(rt) if isinstance(rt, str) else rt


def udf(f=None, returnType="string"):
    """A Python UDF (``F.udf(fn, "double")`` or ``@F.udf(returnType=...)``).

    The udf-compiler analog: when the call's node binds it, the function's
    bytecode compiles to an expression tree over the typed arguments
    (``udf/compiler.py``, computing what the function computes in
    Python); otherwise it runs as a host black box, row by row
    (``TpuArrowEvalPythonExec``).  A compiled function's result has the
    type its expression gives, as in the JAX package; ``returnType`` types
    the black box's."""

    def wrap(fn):
        rt = _return_type(returnType)

        def call(*cols) -> Col:
            from spark_rapids_tpu_torch.udf.python_exec import UDFCall
            return Col(UDFCall(fn, rt, [_expr(c) for c in cols]))

        call.__name__ = getattr(fn, "__name__", "udf")
        call.fn = fn
        return call

    if f is not None:
        return wrap(f)
    return wrap


# as in the JAX package, a scalar pandas UDF is a row-wise UDF
pandas_udf = udf


def tpu_udf(f=None, returnType="double"):
    """A user torch function as a columnar expression (the RapidsUDF
    analog, ``RapidsUDF.java:40``; the name is the JAX package's):
    ``fn(*tensors) -> tensor`` over the argument columns' values, run
    inside the enclosing stage (``udf/python_exec.TorchUDF``)."""

    def wrap(fn):
        rt = _return_type(returnType)

        def call(*cols) -> Col:
            from spark_rapids_tpu_torch.udf.python_exec import TorchUDF
            return Col(TorchUDF(fn, rt, [_expr(c) for c in cols]))

        call.__name__ = getattr(fn, "__name__", "tpu_udf")
        call.fn = fn
        return call

    if f is not None:
        return wrap(f)
    return wrap


class _PandasAggCall(Col):
    """A grouped-aggregate pandas UDF call: ``GroupedData.agg`` routes it
    into an AggInPandas node (it is never evaluated as an expression)."""

    def __init__(self, fn, return_type, arg_name: str):
        self.fn = fn
        self.return_type = return_type
        self.arg_name = arg_name
        self.out_name = f"{getattr(fn, '__name__', 'udf')}({arg_name})"

    @property
    def expr(self):
        raise TypeError("grouped-agg pandas UDFs are only valid inside "
                        "groupBy().agg()")

    @expr.setter
    def expr(self, v):  # pragma: no cover
        pass

    def alias(self, name: str) -> "_PandasAggCall":
        out = _PandasAggCall(self.fn, self.return_type, self.arg_name)
        out.out_name = name
        return out

    def over(self, window: "Window") -> "_PandasWindowCall":
        """The window form: one call per frame, its value for the frame's
        anchor row (GpuWindowInPandasExec)."""
        return _PandasWindowCall(self, window)


class _PandasWindowCall(Col):
    """A pandas UDF over a window: ``DataFrame.select`` routes it into a
    WindowInPandas node."""

    def __init__(self, call: _PandasAggCall, window: "Window"):
        self.call = call
        self.window = window
        self.out_name = call.out_name

    @property
    def expr(self):
        raise TypeError("windowed pandas UDFs are only valid in select()")

    @expr.setter
    def expr(self, v):  # pragma: no cover
        pass

    def alias(self, name: str) -> "_PandasWindowCall":
        out = _PandasWindowCall(self.call, self.window)
        out.out_name = name
        return out

    def spec_data(self):
        """(partition names, [(order name, descending, nulls first)],
        frame): the host execution needs plain column names, one null
        order, and a rows frame or the running range frame."""
        from spark_rapids_tpu_torch.exec.window import Frame

        def name_of(e, what):
            if isinstance(e, UnresolvedColumn):
                return e.col_name
            raise ValueError(f"windowed pandas UDFs: {what} must be plain "
                             f"columns, got {e}")

        w = self.window
        parts = [name_of(e, "partitionBy") for e in w._partition]
        orders = [(name_of(e, "orderBy"), d, nf) for e, d, nf in w._orders]
        if len({nf for _, _, nf in orders}) > 1:
            # pandas sorts with one na_position
            raise ValueError(
                "windowed pandas UDFs require a consistent nulls-first/"
                "nulls-last across orderBy keys")
        frame = w._frame
        if frame is None:
            frame = Frame("range", None, 0) if orders else \
                Frame("rows", None, None)
        elif frame.kind == "range":
            if not (frame.lo is None and frame.hi in (0, None)):
                raise ValueError(
                    "windowed pandas UDFs support rows-based frames and "
                    "the running range frame only")
            if not orders:
                raise ValueError("a range window frame requires orderBy")
        return parts, orders, frame


def pandas_agg_udf(f=None, returnType="double"):
    """A grouped-aggregate pandas UDF (Spark's ``pandas_udf`` of type
    GROUPED_AGG): ``fn(pd.Series) -> scalar``, one call per group
    (GpuAggregateInPandasExec); ``.over(window)`` makes it a window
    pandas UDF."""

    def wrap(fn):
        rt = _return_type(returnType)

        def call(col_name) -> _PandasAggCall:
            if not isinstance(col_name, str):
                raise TypeError("grouped-agg pandas UDFs take a column "
                                "NAME argument")
            return _PandasAggCall(fn, rt, col_name)

        call.__name__ = getattr(fn, "__name__", "udf")
        call.fn = fn
        return call

    if f is not None:
        return wrap(f)
    return wrap
