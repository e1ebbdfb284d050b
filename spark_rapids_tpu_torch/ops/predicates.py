"""Comparison, logic and null-test expressions.

Counterpart of ``spark_rapids_tpu/ops/predicates.py``.  Numeric, date and
timestamp operands compare through their storage (a date meets a
timestamp as a timestamp); strings compare byte-wise through
``stringops`` (UTF-8 byte order is Spark's string order).  Also ``In`` /
``InSet`` (Spark's null rule: no match and a null option give null),
``If`` / ``CaseWhen`` (a null predicate takes the else branch) and
``Coalesce``, ``IsNaN`` and ``Greatest`` / ``Least``; string-valued
CASE, COALESCE, GREATEST and LEAST go through ``stringops.string_select``.  Spark semantics kept: AND/OR use Kleene
three-valued logic (null AND false = false); float comparisons treat
NaN = NaN as true and NaN as the largest value; -0.0 compares equal to
0.0.  ``greatest`` and ``least`` skip nulls (null only when every argument
is) and order NaN above every number, so ``greatest`` of a NaN is NaN and
``least`` takes a NaN only when every argument is one (Spark's rule; the
JAX package's ``Least`` takes ``jnp.minimum``, which returns the NaN).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops.expressions import (
    BinaryExpression, ColVal, EmitContext, Expression, Literal,
    UnaryExpression, cast_value, combine_validity, promote_types)


def _is_float(v) -> bool:
    return v.dtype.is_floating_point


class _Comparison(BinaryExpression):
    # the stringops comparator of string operands
    _string_op = ""

    @property
    def dtype(self):
        return dts.BOOL

    def emit(self, ctx: EmitContext) -> ColVal:
        if self.left.dtype.is_string and self.right.dtype.is_string:
            from spark_rapids_tpu_torch.ops import stringops
            l = self.left.emit(ctx)
            r = self.right.emit(ctx)
            vals = getattr(stringops, self._string_op)(l, r, ctx)
            return ColVal(dts.BOOL, vals,
                          combine_validity(l.validity, r.validity))
        return super().emit(ctx)


class EqualTo(_Comparison):
    _string_op = "string_equal"

    def eval_values(self, l, r):
        eq = l == r
        if _is_float(l):
            eq = eq | (torch.isnan(l) & torch.isnan(r))
        return eq, None


class LessThan(_Comparison):
    _string_op = "string_lt"

    def eval_values(self, l, r):
        lt = l < r
        if _is_float(l):  # NaN is largest
            lt = torch.where(torch.isnan(l), False,
                             torch.where(torch.isnan(r), True, lt))
        return lt, None


class LessThanOrEqual(_Comparison):
    _string_op = "string_le"

    def eval_values(self, l, r):
        le = l <= r
        if _is_float(l):
            le = torch.where(torch.isnan(l), torch.isnan(r),
                             torch.where(torch.isnan(r), True, le))
        return le, None


class GreaterThan(_Comparison):
    _string_op = "string_gt"

    def eval_values(self, l, r):
        gt = l > r
        if _is_float(l):
            gt = torch.where(torch.isnan(l), ~torch.isnan(r),
                             torch.where(torch.isnan(r), False, gt))
        return gt, None


class GreaterThanOrEqual(_Comparison):
    _string_op = "string_ge"

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


class IsNaN(UnaryExpression):
    """isnan(x): true for a NaN; a null is false (never null)."""

    @property
    def dtype(self):
        return dts.BOOL

    @property
    def nullable(self):
        return False

    def emit(self, ctx: EmitContext) -> ColVal:
        c = self.child.emit(ctx)
        v = c.values
        nan = torch.isnan(v) if _is_float(v) else \
            torch.zeros(v.shape, dtype=torch.bool, device=v.device)
        if nan.dim() == 0:
            nan = nan.expand(ctx.capacity)
        if c.validity is not None:
            nan = torch.logical_and(nan, c.validity)
        return ColVal(dts.BOOL, nan)


# ------------------------------------------------------- conditional values --

def _cond_mask(p: ColVal, ctx: EmitContext) -> torch.Tensor:
    """A predicate as a full bool mask; null reads as false."""
    cond = p.values
    if p.validity is not None:
        cond = torch.logical_and(cond, p.validity)
    if cond.dim() == 0:
        cond = cond.expand(ctx.capacity)
    return cond


def _full_validity(v, ctx: EmitContext) -> torch.Tensor:
    if v is None:
        return torch.ones(ctx.capacity, dtype=torch.bool, device=ctx.device)
    return v.expand(ctx.capacity) if v.dim() == 0 else v


class Coalesce(Expression):
    """The first non-null argument per row."""

    def __init__(self, *children: Expression):
        self.children = tuple(children)

    def with_children(self, children):
        return Coalesce(*children)

    @property
    def dtype(self) -> DataType:
        t = self.children[0].dtype
        for c in self.children[1:]:
            t = promote_types(t, c.dtype)
        return t

    @property
    def nullable(self):
        return all(c.nullable for c in self.children)

    def emit(self, ctx: EmitContext) -> ColVal:
        t = self.dtype
        if t.is_string:
            from spark_rapids_tpu_torch.ops.stringops import string_select
            vals = [c.emit(ctx) for c in self.children]
            masks = [_full_validity(v.validity, ctx) for v in vals]
            return string_select(masks, vals, ctx.capacity, ctx.device)
        out = cast_value(self.children[-1].emit(ctx), t)
        for child in reversed(self.children[:-1]):
            c = cast_value(child.emit(ctx), t)
            if c.validity is None:
                out = c
                continue
            values = torch.where(c.validity, c.values, out.values)
            validity = None if out.validity is None else \
                torch.logical_or(c.validity, out.validity)
            out = ColVal(t, values, validity)
        return out


class If(Expression):
    """if(pred, a, b); a null predicate takes ``b`` (Spark)."""

    def __init__(self, pred: Expression, if_true: Expression,
                 if_false: Expression):
        self.children = (pred, if_true, if_false)

    def with_children(self, children):
        return If(*children)

    @property
    def dtype(self) -> DataType:
        return promote_types(self.children[1].dtype, self.children[2].dtype)

    @property
    def nullable(self):
        return any(c.nullable for c in self.children)

    def emit(self, ctx: EmitContext) -> ColVal:
        t = self.dtype
        cond = _cond_mask(self.children[0].emit(ctx), ctx)
        if t.is_string:
            from spark_rapids_tpu_torch.ops.stringops import string_select
            return string_select(
                [cond, _full_validity(None, ctx)],
                [self.children[1].emit(ctx), self.children[2].emit(ctx)],
                ctx.capacity, ctx.device)
        a = cast_value(self.children[1].emit(ctx), t)
        b = cast_value(self.children[2].emit(ctx), t)
        values = torch.where(cond, a.values, b.values)
        if a.validity is None and b.validity is None:
            return ColVal(t, values)
        true = torch.ones((), dtype=torch.bool, device=ctx.device)
        av = a.validity if a.validity is not None else true
        bv = b.validity if b.validity is not None else true
        return ColVal(t, values, torch.where(cond, av, bv))


class CaseWhen(Expression):
    """CASE WHEN p1 THEN v1 ... [ELSE e] END: a chain of Ifs, or one
    ``string_select`` over every branch for a string result."""

    def __init__(self, branches: Sequence[tuple],
                 else_value: Optional[Expression] = None):
        self.branches = [(p, v) for p, v in branches]
        self.else_value = else_value
        flat = [e for pv in self.branches for e in pv]
        if else_value is not None:
            flat.append(else_value)
        self.children = tuple(flat)

    def with_children(self, children):
        n = len(self.branches)
        branches = [(children[2 * i], children[2 * i + 1])
                    for i in range(n)]
        els = children[2 * n] if self.else_value is not None else None
        return CaseWhen(branches, els)

    def _else(self) -> Expression:
        if self.else_value is not None:
            return self.else_value
        return Literal(None, self.branches[0][1].dtype)

    def _as_if_chain(self) -> Expression:
        out = self._else()
        for pred, val in reversed(self.branches):
            out = If(pred, val, out)
        return out

    @property
    def dtype(self) -> DataType:
        return self._as_if_chain().dtype

    @property
    def nullable(self):
        return self.else_value is None or self._as_if_chain().nullable

    def emit(self, ctx: EmitContext) -> ColVal:
        if not self.dtype.is_string:
            return self._as_if_chain().emit(ctx)
        from spark_rapids_tpu_torch.ops.stringops import string_select
        masks = [_cond_mask(p.emit(ctx), ctx) for p, _ in self.branches]
        vals = [v.emit(ctx) for _, v in self.branches]
        els = self._else().emit(ctx)
        masks.append(_full_validity(None, ctx))
        return string_select(masks, vals + [els], ctx.capacity, ctx.device)

    def cache_key(self):
        return ("CaseWhen", tuple(c.cache_key() for c in self.children),
                self.else_value is not None)


def _null_rule(v: ColVal, hit, has_null_option, ctx: EmitContext) -> ColVal:
    """IN's result: a match is true; no match with a null option is
    null; else false.  A null value is null."""
    if hit.dim() == 0:
        hit = hit.expand(ctx.capacity)
    validity = torch.logical_or(hit, torch.logical_not(has_null_option))
    if v.validity is not None:
        validity = torch.logical_and(v.validity, validity)
    return ColVal(dts.BOOL, hit, validity)


class In(Expression):
    """value IN (literals...), one equality per option."""

    def __init__(self, value: Expression, options: Sequence[Expression]):
        self.children = (value,) + tuple(options)

    def with_children(self, children):
        return In(children[0], children[1:])

    @property
    def dtype(self):
        return dts.BOOL

    def emit(self, ctx: EmitContext) -> ColVal:
        v = self.children[0].emit(ctx)
        is_string = self.children[0].dtype.is_string
        hit = torch.zeros((), dtype=torch.bool, device=ctx.device)
        has_null = torch.zeros((), dtype=torch.bool, device=ctx.device)
        for opt in self.children[1:]:
            o = opt.emit(ctx)
            if isinstance(opt, Literal) and opt.value is None:
                has_null = torch.ones((), dtype=torch.bool,
                                      device=ctx.device)
                continue
            if is_string:
                from spark_rapids_tpu_torch.ops import stringops
                eq = stringops.string_equal(v, o, ctx)
            else:
                eq = v.values == o.values.to(v.values.dtype)
            if o.validity is not None:
                eq = torch.logical_and(eq, o.validity)
                has_null = torch.logical_or(
                    has_null, torch.logical_not(o.validity))
            hit = torch.logical_or(hit, eq)
        return _null_rule(v, hit, has_null, ctx)


class InSet(Expression):
    """value IN (a large literal set): the distinct values sit in a
    sorted device table and membership is one ``searchsorted`` and one
    gather per row (string sets compare each literal's bytes)."""

    def __init__(self, child: Expression, values):
        self.children = (child,)
        values = list(values)
        vals = [v for v in values if v is not None]
        self.has_null = len(vals) != len(values)
        self.table = np.unique(np.asarray(vals)) if vals else \
            np.zeros(0, dtype=np.int64)

    def with_children(self, children):
        vals = list(self.table.tolist())
        if self.has_null:
            vals.append(None)
        return InSet(children[0], vals)

    @property
    def dtype(self):
        return dts.BOOL

    def emit(self, ctx: EmitContext) -> ColVal:
        v = self.children[0].emit(ctx)
        dt = self.children[0].dtype
        if len(self.table) == 0:
            hit = torch.zeros(ctx.capacity, dtype=torch.bool,
                              device=ctx.device)
        elif dt.is_string:
            from spark_rapids_tpu_torch.ops import stringops
            hit = torch.zeros(ctx.capacity, dtype=torch.bool,
                              device=ctx.device)
            for s in self.table.tolist():
                hit = hit | stringops.EqualsLiteral(
                    self.children[0], str(s)).emit(ctx).values
        else:
            table = torch.from_numpy(np.ascontiguousarray(
                self.table.astype(dt.storage))).to(ctx.device)
            vals = v.values.expand(ctx.capacity) if v.values.dim() == 0 \
                else v.values
            idx = torch.searchsorted(table, vals).clamp(
                0, len(self.table) - 1)
            hit = table[idx] == vals
        has_null = torch.tensor(self.has_null, device=ctx.device)
        return _null_rule(v, hit, has_null, ctx)

    def cache_key(self):
        return ("InSet", self.children[0].cache_key(), self.has_null,
                self.table.tobytes())

    def __str__(self):
        return f"{self.children[0]} INSET[{len(self.table)}]"


class _Extremum(Expression):
    """greatest / least: per row the largest (smallest) non-null argument
    under Spark's order (NaN above every number); null when every
    argument is null."""

    # the comparison whose NaN-aware values pick a new argument over the
    # running best
    _order = None

    def __init__(self, *children: Expression):
        if len(children) < 2:
            raise ValueError(f"{type(self).__name__.lower()} needs at "
                             "least two arguments")
        self.children = tuple(children)

    def with_children(self, children):
        return type(self)(*children)

    @property
    def dtype(self) -> DataType:
        t = self.children[0].dtype
        for c in self.children[1:]:
            t = promote_types(t, c.dtype)
        return t

    @property
    def nullable(self):
        return all(c.nullable for c in self.children)

    def emit(self, ctx: EmitContext) -> ColVal:
        t = self.dtype
        if t.is_string:
            return self._emit_strings(ctx)
        out = None
        for child in self.children:
            c = cast_value(child.emit(ctx), t)
            if out is None:
                out = ColVal(t, c.values.expand(ctx.capacity)
                             if c.values.dim() == 0 else c.values,
                             c.validity)
                continue
            cv = _full_validity(c.validity, ctx)
            ov = _full_validity(out.validity, ctx)
            beats, _ = self._order.eval_values(None, c.values, out.values)
            take = cv & (~ov | beats)
            out = ColVal(t, torch.where(take, c.values, out.values),
                         None if c.validity is None and out.validity is None
                         else ov | cv)
        return out

    def _emit_strings(self, ctx: EmitContext) -> ColVal:
        from spark_rapids_tpu_torch.ops import stringops
        op = "string_gt" if isinstance(self, Greatest) else "string_lt"
        out = None
        for child in self.children:
            c = child.emit(ctx)
            if out is None:
                out = c if not stringops.is_literal(c, ctx.capacity) else \
                    stringops.string_literal_column(c, ctx.capacity)
                continue
            cv = _full_validity(c.validity, ctx)
            ov = _full_validity(out.validity, ctx)
            take = cv & (~ov | getattr(stringops, op)(c, out, ctx))
            out = stringops.string_select([take, ov | cv], [c, out],
                                          ctx.capacity, ctx.device)
        return out


class Greatest(_Extremum):
    _order = GreaterThan


class Least(_Extremum):
    _order = LessThan
