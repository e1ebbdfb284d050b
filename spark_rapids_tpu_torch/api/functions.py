"""PySpark-flavoured column DSL.

Counterpart of ``spark_rapids_tpu/api/functions.py``, cut to what the
ported slices run: column references, literals (numbers, bools, strings,
dates), arithmetic (``%`` too), comparisons, logic, null
tests, casts, ``isin``, the string predicates (``startswith``,
``endswith``, ``contains``, ``like``), ``when``/``otherwise``,
``coalesce``, ``substring``, the date parts and date arithmetic, sort
keys, and the sum / avg / count / min / max aggregates.
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
