"""PySpark-flavoured column DSL.

Counterpart of ``spark_rapids_tpu/api/functions.py``, cut to what this
slice runs: column references, literals, arithmetic, comparisons, logic,
null tests, and the sum / avg / count / min / max aggregates.
"""

from __future__ import annotations

from typing import Optional, Union

from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops import aggregates as agg
from spark_rapids_tpu_torch.ops import arithmetic as arith
from spark_rapids_tpu_torch.ops import predicates as preds
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

    def between(self, lo, hi) -> "Col":
        return Col(preds.And(
            preds.GreaterThanOrEqual(self.expr, _lit_expr(lo)),
            preds.LessThanOrEqual(self.expr, _lit_expr(hi))))

    def __repr__(self):
        return f"Col({self.expr})"


def col(name: str) -> Col:
    return Col(UnresolvedColumn(name))


def lit(value, dtype: Optional[DataType] = None) -> Col:
    return Col(Literal(value, dtype))


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
