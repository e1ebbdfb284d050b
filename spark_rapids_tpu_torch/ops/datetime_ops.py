"""Date parts and date arithmetic.

Counterpart of the parts of ``spark_rapids_tpu/ops/datetime_ops.py`` the
22 TPC-H queries and the date API need: ``Year``, ``Month`` and
``DayOfMonth`` through the civil-from-days algorithm (branch-free integer
math, proleptic Gregorian, UTC as in the JAX package), and ``DateAdd``,
``DateSub`` and ``DateDiff``.  A timestamp reads as its UTC day.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.ops.cast import US_PER_DAY
from spark_rapids_tpu_torch.ops.expressions import (
    BinaryExpression, ColVal, EmitContext, UnaryExpression,
    combine_validity)


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _civil_from_days(z: torch.Tensor):
    """Days since 1970-01-01 -> (year, month, day), int64."""
    z = z.to(torch.int64) + 719468
    era = _fdiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097                                  # [0, 146096]
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))  # [0, 365]
    mp = _fdiv(5 * doy + 2, 153)                             # [0, 11]
    d = doy - _fdiv(153 * mp + 2, 5) + 1                     # [1, 31]
    m = torch.where(mp < 10, mp + 3, mp - 9)                 # [1, 12]
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def _to_days(c: ColVal) -> torch.Tensor:
    if c.dtype.is_timestamp:
        return _fdiv(c.values, US_PER_DAY)
    return c.values.to(torch.int64)


class _DatePart(UnaryExpression):
    @property
    def dtype(self):
        return dts.INT32

    def eval_values(self, v, cv):
        y, m, d = _civil_from_days(_to_days(cv))
        return self.part(y, m, d).to(torch.int32)


class Year(_DatePart):
    def part(self, y, m, d):
        return y


class Month(_DatePart):
    def part(self, y, m, d):
        return m


class DayOfMonth(_DatePart):
    def part(self, y, m, d):
        return d


class _DateShift(BinaryExpression):
    """date plus or minus n days, as a DATE."""
    sign = 1

    @property
    def dtype(self):
        return dts.DATE32

    def emit(self, ctx: EmitContext) -> ColVal:
        l = self.left.emit(ctx)
        r = self.right.emit(ctx)
        out = _to_days(l).to(torch.int32) + \
            self.sign * r.values.to(torch.int32)
        return ColVal(dts.DATE32, out,
                      combine_validity(l.validity, r.validity))


class DateAdd(_DateShift):
    sign = 1


class DateSub(_DateShift):
    sign = -1


class DateDiff(BinaryExpression):
    """datediff(end, start) in days."""

    @property
    def dtype(self):
        return dts.INT32

    def emit(self, ctx: EmitContext) -> ColVal:
        l = self.left.emit(ctx)
        r = self.right.emit(ctx)
        return ColVal(dts.INT32, (_to_days(l) - _to_days(r)).to(torch.int32),
                      combine_validity(l.validity, r.validity))
