"""Comparison, logic and null-test expressions.

Counterpart of ``spark_rapids_tpu/ops/predicates.py``.  Numeric, date and
timestamp operands compare through their storage (a date meets a
timestamp as a timestamp); strings support equality (``==`` and ``!=``)
through ``stringops.string_equal``, and their ordering comparisons are
not ported yet.  Spark semantics kept: AND/OR use Kleene three-valued
logic (null AND false = false); float comparisons treat NaN = NaN as true
and NaN as the largest value; -0.0 compares equal to 0.0.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.ops.expressions import (
    BinaryExpression, ColVal, EmitContext, UnaryExpression,
    combine_validity)


def _is_float(v) -> bool:
    return v.dtype.is_floating_point


class _Comparison(BinaryExpression):
    # strings: only equality is ported (stringops.string_equal)
    _string_equality = False

    @property
    def dtype(self):
        return dts.BOOL

    def emit(self, ctx: EmitContext) -> ColVal:
        if self.left.dtype.is_string and self.right.dtype.is_string:
            if not self._string_equality:
                raise NotImplementedError(
                    f"{type(self).__name__} on strings is not ported")
            from spark_rapids_tpu_torch.ops import stringops
            l = self.left.emit(ctx)
            r = self.right.emit(ctx)
            return ColVal(dts.BOOL, stringops.string_equal(l, r, ctx),
                          combine_validity(l.validity, r.validity))
        return super().emit(ctx)


class EqualTo(_Comparison):
    _string_equality = True

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


def _row_shape(c: ColVal, ctx: EmitContext):
    """Shape of one value per row of ``c``: a string column's values are
    its chars, so its rows come from the context."""
    return (ctx.capacity,) if c.offsets is not None else c.values.shape


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
                _row_shape(c, ctx), dtype=torch.bool, device=ctx.device))
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
                _row_shape(c, ctx), dtype=torch.bool, device=ctx.device))
        return ColVal(dts.BOOL, c.validity)
