"""Arithmetic expressions.

Counterpart of ``spark_rapids_tpu/ops/arithmetic.py``, cut to the numeric
operators this slice's queries use.  ANSI mode is off, as in the JAX
package's defaults: integer overflow wraps, division by zero yields null.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops.expressions import BinaryExpression


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
