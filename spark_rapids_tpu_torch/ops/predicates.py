"""Comparison, logic and null-test expressions.

Counterpart of ``spark_rapids_tpu/ops/predicates.py``, numeric operands
only.  Spark semantics kept: AND/OR use Kleene three-valued logic (null AND
false = false); float comparisons treat NaN = NaN as true and NaN as the
largest value; -0.0 compares equal to 0.0.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.ops.expressions import (
    BinaryExpression, ColVal, EmitContext, UnaryExpression)


def _is_float(v) -> bool:
    return v.dtype.is_floating_point


class _Comparison(BinaryExpression):
    @property
    def dtype(self):
        return dts.BOOL


class EqualTo(_Comparison):
    def eval_values(self, l, r):
        eq = l == r
        if _is_float(l):
            eq = eq | (torch.isnan(l) & torch.isnan(r))
        return eq, None


class LessThan(_Comparison):
    def eval_values(self, l, r):
        lt = l < r
        if _is_float(l):  # NaN is largest
            lt = torch.where(torch.isnan(l), False,
                             torch.where(torch.isnan(r), True, lt))
        return lt, None


class LessThanOrEqual(_Comparison):
    def eval_values(self, l, r):
        le = l <= r
        if _is_float(l):
            le = torch.where(torch.isnan(l), torch.isnan(r),
                             torch.where(torch.isnan(r), True, le))
        return le, None


class GreaterThan(_Comparison):
    def eval_values(self, l, r):
        gt = l > r
        if _is_float(l):
            gt = torch.where(torch.isnan(l), ~torch.isnan(r),
                             torch.where(torch.isnan(r), False, gt))
        return gt, None


class GreaterThanOrEqual(_Comparison):
    def eval_values(self, l, r):
        ge = l >= r
        if _is_float(l):
            ge = torch.where(torch.isnan(l), True,
                             torch.where(torch.isnan(r), False, ge))
        return ge, None


class And(BinaryExpression):
    """Kleene AND: false dominates null."""

    @property
    def dtype(self):
        return dts.BOOL

    def emit(self, ctx: EmitContext) -> ColVal:
        l = self.left.emit(ctx)
        r = self.right.emit(ctx)
        values = torch.logical_and(l.values, r.values)
        if l.validity is None and r.validity is None:
            return ColVal(dts.BOOL, values)
        true = torch.ones((), dtype=torch.bool, device=ctx.device)
        lv = l.validity if l.validity is not None else true
        rv = r.validity if r.validity is not None else true
        validity = (lv & rv) | (lv & ~l.values) | (rv & ~r.values)
        return ColVal(dts.BOOL, values, validity)


class Or(BinaryExpression):
    """Kleene OR: true dominates null."""

    @property
    def dtype(self):
        return dts.BOOL

    def emit(self, ctx: EmitContext) -> ColVal:
        l = self.left.emit(ctx)
        r = self.right.emit(ctx)
        values = torch.logical_or(l.values, r.values)
        if l.validity is None and r.validity is None:
            return ColVal(dts.BOOL, values)
        true = torch.ones((), dtype=torch.bool, device=ctx.device)
        lv = l.validity if l.validity is not None else true
        rv = r.validity if r.validity is not None else true
        validity = (lv & rv) | (lv & l.values) | (rv & r.values)
        return ColVal(dts.BOOL, values, validity)


class Not(UnaryExpression):
    @property
    def dtype(self):
        return dts.BOOL

    def eval_values(self, v, cv):
        return torch.logical_not(v)


class IsNull(UnaryExpression):
    @property
    def dtype(self):
        return dts.BOOL

    @property
    def nullable(self):
        return False

    def emit(self, ctx: EmitContext) -> ColVal:
        c = self.child.emit(ctx)
        if c.validity is None:
            return ColVal(dts.BOOL, torch.zeros(
                c.values.shape, dtype=torch.bool, device=ctx.device))
        return ColVal(dts.BOOL, torch.logical_not(c.validity))


class IsNotNull(UnaryExpression):
    @property
    def dtype(self):
        return dts.BOOL

    @property
    def nullable(self):
        return False

    def emit(self, ctx: EmitContext) -> ColVal:
        c = self.child.emit(ctx)
        if c.validity is None:
            return ColVal(dts.BOOL, torch.ones(
                c.values.shape, dtype=torch.bool, device=ctx.device))
        return ColVal(dts.BOOL, c.validity)
