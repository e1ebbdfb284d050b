"""Arithmetic expressions.

Counterpart of ``spark_rapids_tpu/ops/arithmetic.py``, cut to ``+``,
``-``, ``*``, ``/``, ``div``, ``%``, unary minus, ``abs``, and the
bitwise AND and right shift that ``grouping()`` reads its bit with.  ANSI mode is off, as in the JAX
package's defaults: integer overflow wraps, division by zero yields null.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops.expressions import (
    BinaryExpression, ColVal, EmitContext, UnaryExpression,
    combine_validity)


class Add(BinaryExpression):
    def eval_values(self, l, r):
        return l + r, None


class Subtract(BinaryExpression):
    def eval_values(self, l, r):
        return l - r, None


class Multiply(BinaryExpression):
    def eval_values(self, l, r):
        return l * r, None


class Divide(BinaryExpression):
    """Spark `/`: double division; x / 0 -> null."""

    def operand_type(self) -> DataType:
        return dts.FLOAT64

    def eval_values(self, l, r):
        zero = r == 0
        safe = torch.where(zero, torch.ones_like(r), r)
        return l / safe, torch.logical_not(zero)


class IntegralDivide(BinaryExpression):
    """Spark ``div``: long division truncating toward zero; x div 0 is
    null."""

    def operand_type(self) -> DataType:
        return dts.INT64

    def eval_values(self, l, r):
        zero = r == 0
        # x div -1 is -x (wrapping at the minimum, where the hardware's
        # division traps)
        minus_one = r == -1
        safe = torch.where(zero | minus_one, torch.ones_like(r), r)
        q = torch.div(l, safe, rounding_mode="trunc")
        return torch.where(minus_one, -l, q), torch.logical_not(zero)


class Remainder(BinaryExpression):
    """Spark ``%``: the sign follows the dividend (Java); x % 0 is
    null."""

    def eval_values(self, l, r):
        zero = r == 0
        safe = torch.where(zero, torch.ones_like(r), r)
        if not l.dtype.is_floating_point:
            # x % -1 is 0, as x % 1 (the hardware traps at the minimum)
            safe = torch.where(r == -1, torch.ones_like(r), safe)
        return torch.fmod(l, safe), torch.logical_not(zero)


class UnaryMinus(UnaryExpression):
    def eval_values(self, v, cv):
        return -v


class Abs(UnaryExpression):
    """``abs``; the integer minimum wraps to itself, as in Java."""

    def eval_values(self, v, cv):
        return torch.abs(v)


class BitwiseAnd(BinaryExpression):
    def eval_values(self, l, r):
        return l & r, None


class ShiftRight(BinaryExpression):
    """Java ``>>``: the shift amount masked by the value's bit width;
    the result keeps the left operand's type."""

    def operand_type(self) -> DataType:
        return self.left.dtype

    def emit(self, ctx: EmitContext) -> ColVal:
        l = self.left.emit(ctx)
        r = self.right.emit(ctx)
        bits = l.values.element_size() * 8
        amount = (r.values.to(torch.int32) & (bits - 1)).to(l.values.dtype)
        return ColVal(self.dtype, l.values >> amount,
                      combine_validity(l.validity, r.validity))
