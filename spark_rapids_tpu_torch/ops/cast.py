"""Cast between the numeric, bool, date and timestamp types.

Counterpart of the non-string part of ``spark_rapids_tpu/ops/cast.py``,
with Spark's non-ANSI semantics:

* float -> integral truncates and saturates like Java's ``toInt`` (NaN is
  0, +/-Inf the type's MIN/MAX);
* integral -> integral wraps (narrowing keeps the low bits);
* bool <-> numeric as 1/0 and != 0;
* date <-> timestamp through UTC midnight;
* integral <-> timestamp counts seconds since the epoch;
* decimal -> decimal rescales HALF_UP, decimal -> integral truncates
  toward zero and wraps, decimal -> float divides by the scale's power
  of ten, integral -> decimal scales up, float -> decimal rounds
  ``v * 10^scale`` half to even (the JAX package's rule) and saturates
  no further: a value past the target's precision (or a NaN or an
  infinity) is null, as Spark's CheckOverflow makes it.  Every decimal
  step but the float ones stays in int64.

Casts to and from strings run in ``stringops.cast_string`` (they need the
chars and offsets layout): strings parse to the integral, float, boolean,
date and timestamp types, and integers, booleans, dates and timestamps
format to strings.  :func:`cast_supported` keeps the JAX package's
reasons for the rest: a string to a decimal, and a float or decimal to a
string (shortest round-trip formatting), which the CPU fallback runs.
ANSI casts are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops import decimal_ops as D
from spark_rapids_tpu_torch.ops.expressions import (
    ColVal, EmitContext, Expression, combine_validity)

US_PER_DAY = 86_400_000_000
US_PER_SEC = 1_000_000

_INT_RANGE = {
    "tinyint": (-(1 << 7), (1 << 7) - 1),
    "smallint": (-(1 << 15), (1 << 15) - 1),
    "int": (-(1 << 31), (1 << 31) - 1),
    "bigint": (-(1 << 63), (1 << 63) - 1),
}


def cast_supported(src: DataType, dst: DataType) -> Optional[str]:
    """None when the port runs the cast; else why not."""
    if src.name == dst.name:
        return None
    if src.is_string and dst.is_decimal:
        return "cast string -> decimal not supported on TPU"
    if dst.is_string and (src.is_floating or src.is_decimal):
        return (f"cast {src} -> string needs shortest-round-trip "
                "float formatting (host fallback)")
    return None


def _saturate_int(v: torch.Tensor, target: DataType) -> torch.Tensor:
    lo, hi = _INT_RANGE[target.name]
    return v.clamp(lo, hi).to(dts.torch_dtype(target))


class _Rows:
    """The one field of an EmitContext a string cast reads."""

    def __init__(self, capacity: int):
        self.capacity = capacity


def cast_colval(c: ColVal, target: DataType, ctx=None) -> ColVal:
    """``c`` cast to ``target`` (values only; nulls stay null).  A string
    cast needs the batch's rows: ``ctx``, or the column's own."""
    src = c.dtype
    if src.name == target.name:
        return c
    reason = cast_supported(src, target)
    if reason is not None:
        raise NotImplementedError(reason)
    if src.is_string or target.is_string:
        from spark_rapids_tpu_torch.ops import stringops
        if ctx is None:
            ctx = _Rows(c.offsets.shape[0] - 1 if c.offsets is not None
                        else c.values.shape[0])
        return stringops.cast_string(c, target, ctx)
    v = c.values
    storage = dts.torch_dtype(target)
    if target.is_boolean:
        out = v != 0
    elif src.is_boolean and not target.is_decimal:
        out = v.to(storage)
    elif src.is_floating and target.is_integral:
        t = torch.trunc(torch.where(torch.isnan(v), torch.zeros_like(v), v))
        t = t.to(torch.float64)
        top = float(1 << 63)
        i64 = t.clamp(-9.2233720368547e18, 9.2233720368547e18).to(
            torch.int64)
        i64 = torch.where(t >= top, (1 << 63) - 1, i64)
        i64 = torch.where(t <= -top, -(1 << 63), i64)
        out = _saturate_int(i64, target)
    elif src.is_date and target.is_timestamp:
        out = v.to(torch.int64) * US_PER_DAY
    elif src.is_timestamp and target.is_date:
        out = torch.div(v, US_PER_DAY, rounding_mode="floor").to(torch.int32)
    elif src.is_integral and target.is_timestamp:
        out = v.to(torch.int64) * US_PER_SEC
    elif src.is_timestamp and target.is_integral:
        out = _saturate_int(torch.div(v, US_PER_SEC, rounding_mode="floor"),
                            target)
    elif src.is_timestamp and target.is_floating:
        out = v.to(storage) / US_PER_SEC
    elif src.is_floating and target.is_timestamp:
        out = torch.trunc(v.to(torch.float64) * US_PER_SEC).to(torch.int64)
    elif src.is_decimal or target.is_decimal:
        return _cast_decimal(c, target)
    else:
        out = v.to(storage)  # integral widen/wrap, to float, date <-> int
    return ColVal(target, out, c.validity)


def _cast_decimal(c: ColVal, target: DataType) -> ColVal:
    """A cast from or to a decimal (bool and timestamp ends excluded,
    which :func:`cast_colval` handles before)."""
    src = c.dtype
    v = c.values
    if src.is_decimal and target.is_decimal:
        return D.rescale_checked(c, target)
    if src.is_decimal:
        if target.is_integral:
            q = torch.div(v, 10 ** src.scale, rounding_mode="trunc")
            return ColVal(target, q.to(dts.torch_dtype(target)), c.validity)
        scaled = D.to_double(v, src.scale)
        return ColVal(target, scaled.to(dts.torch_dtype(target)),
                      c.validity)
    if src.is_integral or src.is_boolean:
        out, ok = D._scale_up_guarded(v.to(torch.int64),
                                      10 ** target.scale)
    else:
        f = torch.round(v.to(torch.float64) * (10 ** target.scale))
        lim = float(10 ** target.precision)
        ok = torch.isfinite(f) & (f > -lim) & (f < lim)
        out = torch.where(ok, f, torch.zeros_like(f)).to(torch.int64)
    ok = D.overflow_validity(out, target.precision) if ok is None else \
        ok & D.overflow_validity(out, target.precision)
    return ColVal(target, out, combine_validity(c.validity, ok))


class Cast(Expression):
    """Non-ANSI cast (Spark's default)."""

    def __init__(self, child: Expression, target: DataType):
        self.children = (child,)
        self.target = target

    @property
    def child(self):
        return self.children[0]

    def with_children(self, children):
        return Cast(children[0], self.target)

    @property
    def dtype(self) -> DataType:
        return self.target

    def emit(self, ctx: EmitContext) -> ColVal:
        return cast_colval(self.child.emit(ctx), self.target, ctx)

    def cache_key(self):
        return ("Cast", self.target.name, self.child.cache_key())

    def __str__(self):
        return f"cast({self.child} as {self.target})"
