"""Cast between the numeric, bool, date and timestamp types.

Counterpart of the non-string part of ``spark_rapids_tpu/ops/cast.py``,
with Spark's non-ANSI semantics:

* float -> integral truncates and saturates like Java's ``toInt`` (NaN is
  0, +/-Inf the type's MIN/MAX);
* integral -> integral wraps (narrowing keeps the low bits);
* bool <-> numeric as 1/0 and != 0;
* date <-> timestamp through UTC midnight;
* integral <-> timestamp counts seconds since the epoch.

Casts to and from strings (the JAX package's ``stringops.cast_string``)
are not ported: :func:`cast_supported` names them and ``Cast`` raises
``NotImplementedError``.  ANSI casts are not ported either.
"""

from __future__ import annotations

from typing import Optional

import torch

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops.expressions import (
    ColVal, EmitContext, Expression)

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
    if src.is_string or dst.is_string:
        return (f"cast {src} -> {dst}: casts to and from strings are not "
                "ported")
    return None


def _saturate_int(v: torch.Tensor, target: DataType) -> torch.Tensor:
    lo, hi = _INT_RANGE[target.name]
    return v.clamp(lo, hi).to(dts.torch_dtype(target))


def cast_colval(c: ColVal, target: DataType) -> ColVal:
    """``c`` cast to ``target`` (values only; nulls stay null)."""
    src = c.dtype
    if src.name == target.name:
        return c
    reason = cast_supported(src, target)
    if reason is not None:
        raise NotImplementedError(reason)
    v = c.values
    storage = dts.torch_dtype(target)
    if target.is_boolean:
        out = v != 0
    elif src.is_boolean:
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
    else:
        out = v.to(storage)  # integral widen/wrap, to float, date <-> int
    return ColVal(target, out, c.validity)


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
        return cast_colval(self.child.emit(ctx), self.target)

    def cache_key(self):
        return ("Cast", self.target.name, self.child.cache_key())

    def __str__(self):
        return f"cast({self.child} as {self.target})"
