"""PySpark-flavoured column DSL.

Counterpart of ``spark_rapids_tpu/api/functions.py``, cut to what the
ported slices run: column references, literals (numbers, bools, strings,
dates), arithmetic (``%`` and unary minus too), ``abs``, comparisons,
logic, null tests, casts, ``isin``, the string predicates
(``startswith``, ``endswith``, ``contains``, ``like``),
``when``/``otherwise``, ``coalesce``, ``substring``, the date parts and
date arithmetic, ``input_file_name`` and ``_metadata`` field access over
file scans, sort keys, the sum / avg / count / min / max
aggregates, ``grouping``/``grouping_id`` (rollup, cube, grouping sets),
and window functions (``Window`` specs, ``.over``: the ranking
functions, ``lead``/``lag`` and the ``window_*`` aggregates).
"""

from __future__ import annotations

from typing import Optional, Union

from spark_rapids_tpu_torch.columnar.dtypes import DataType, dtype_from_name
from spark_rapids_tpu_torch.ops import aggregates as agg
from spark_rapids_tpu_torch.ops import arithmetic as arith
from spark_rapids_tpu_torch.ops import datetime_ops as D
from spark_rapids_tpu_torch.ops import predicates as preds
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

    def getField(self, field: str) -> "Col":
        """A field of a struct column.  The port has no struct columns;
        the one struct it reads, a file scan's ``_metadata``, is held as
        flat ``_metadata.<field>`` columns, which this names."""
        if not isinstance(self.expr, UnresolvedColumn):
            raise NotImplementedError(
                "getField on a computed struct: struct columns are not "
                "ported")
        return Col(UnresolvedColumn(f"{self.expr.col_name}.{field}"))

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


def year(c) -> Col:
    return Col(D.Year(_expr(c)))


def month(c) -> Col:
    return Col(D.Month(_expr(c)))


def dayofmonth(c) -> Col:
    return Col(D.DayOfMonth(_expr(c)))


def date_add(c, days) -> Col:
    return Col(D.DateAdd(_expr(c), _lit_expr(days)))


def date_sub(c, days) -> Col:
    return Col(D.DateSub(_expr(c), _lit_expr(days)))


def datediff(end, start) -> Col:
    return Col(D.DateDiff(_expr(end), _expr(start)))


def _agg(func_cls, c) -> Col:
    return Col(AggregateExpression(func_cls(_expr(c))))


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
