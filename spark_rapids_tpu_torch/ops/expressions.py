"""Expression trees and the column-value representation.

Counterpart of ``spark_rapids_tpu/ops/expressions.py``.  The JAX package
evaluates an operator's expression forest inside one ``jax.jit`` trace;
PyTorch runs eagerly, so ``Expression.emit(ctx)`` here computes tensors
directly, one torch op per node, on the context's device.

Null semantics follow Spark SQL: null-propagating binary ops, Kleene logic
for AND/OR, null on division by zero.  Validity is a bool tensor (or None =
all valid) carried beside the values.  Literals carry their Spark type: a
Python float is a DOUBLE literal and becomes a float64 tensor, never
torch's default float32, an int is a BIGINT that an int column meets
through :func:`promote_types`, a ``datetime.date`` is a DATE (int32 days),
a str is a STRING (its UTF-8 bytes with offsets ``[0, len]``) and a
``decimal.Decimal`` a DECIMAL whose precision and scale its digits give
(its unscaled int64 value).
"""

from __future__ import annotations

import dataclasses
import datetime
import decimal
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.columnar.dtypes import DataType


@dataclasses.dataclass
class ColVal:
    """A column value during evaluation: values + optional validity.

    ``values`` is a (capacity,) tensor, or a 0-dim tensor for scalar
    literals; torch broadcasting does the rest.  For strings ``values``
    holds the uint8 chars and ``offsets`` the int32 row offsets (a string
    literal's offsets are ``[0, len]``)."""
    dtype: DataType
    values: Any
    validity: Optional[Any] = None   # bool tensor, None = all valid
    offsets: Optional[Any] = None    # strings only


def combine_validity(*vs: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """AND together validity masks, treating None as all-valid."""
    present = [v for v in vs if v is not None]
    if not present:
        return None
    out = present[0]
    for v in present[1:]:
        out = torch.logical_and(out, v)
    return out


class EmitContext:
    """Per-batch state handed to ``Expression.emit``.

    ``inputs``: ColVal per input ordinal (the operator's child output).
    ``nrows``: the batch's row count (int or 0-dim device tensor).
    ``capacity``: rows in each input buffer.
    ``checks`` / ``extra_check_mask``: the JAX package's ANSI check channel
    and its fused-stage masking.  No expression of this slice records a
    check; the channel keeps the fused-stage rule in one place
    (:func:`fold_conjuncts`) for the slices that bring ANSI casts."""

    def __init__(self, inputs: Sequence[ColVal], nrows, capacity: int,
                 device):
        self.inputs = list(inputs)
        self.nrows = nrows
        self.capacity = capacity
        self.device = torch.device(device)
        self.checks = []
        self.extra_check_mask = None

    def add_check(self, message: str, failed) -> None:
        self.checks.append((message, failed))

    def row_mask(self) -> torch.Tensor:
        """bool[capacity], True for rows < nrows."""
        return torch.arange(self.capacity, device=self.device) < self.nrows

    def check_mask(self) -> torch.Tensor:
        """Rows whose failures checks may report: live rows, minus rows a
        fused upstream filter already dropped."""
        m = self.row_mask()
        if self.extra_check_mask is not None:
            m = torch.logical_and(m, self.extra_check_mask)
        return m


def fold_conjuncts(ctx: EmitContext, conds) -> torch.Tensor:
    """AND a BOTTOM-FIRST conjunct list into one keep mask with progressive
    check masking: each conjunct (and anything emitted afterwards under
    ``ctx``) only checks rows the conjuncts below it kept, exactly the
    rows the unfused filter stages would have evaluated.  Leaves
    ``ctx.extra_check_mask`` set to the returned mask."""
    mask = ctx.row_mask()
    for p in conds:
        ctx.extra_check_mask = mask
        pred = p.emit(ctx)
        keep = pred.values
        if keep.dim() == 0:
            keep = keep.expand(ctx.capacity)
        if pred.validity is not None:
            keep = torch.logical_and(keep, pred.validity)
        mask = torch.logical_and(mask, keep)
    ctx.extra_check_mask = mask
    return mask


class Expression:
    """Base class.  Subclasses define ``children``; immutable after bind."""

    children: Tuple["Expression", ...] = ()

    @property
    def dtype(self) -> DataType:
        raise NotImplementedError

    @property
    def nullable(self) -> bool:
        return any(c.nullable for c in self.children)

    def bind(self, schema: Sequence[Tuple[str, DataType]]) -> "Expression":
        """Resolve column names to ordinals recursively."""
        return self.with_children([c.bind(schema) for c in self.children])

    def with_children(self, children: Sequence["Expression"]) -> "Expression":
        if not self.children:
            return self
        raise NotImplementedError(
            f"{type(self).__name__} must implement with_children")

    def emit(self, ctx: EmitContext) -> ColVal:
        raise NotImplementedError(type(self).__name__)

    @property
    def name(self) -> str:
        """Output name when projected without an alias."""
        return str(self)

    def cache_key(self) -> Tuple:
        """Structural identity (group-key matching in the planner)."""
        return (type(self).__name__,
                tuple(c.cache_key() for c in self.children))

    def __str__(self) -> str:
        args = ", ".join(str(c) for c in self.children)
        return f"{type(self).__name__}({args})"


# ------------------------------------------------------------------- leaves --

class UnresolvedColumn(Expression):
    def __init__(self, col_name: str):
        self.col_name = col_name

    @property
    def dtype(self) -> DataType:
        raise RuntimeError(f"unresolved column {self.col_name}")

    @property
    def nullable(self) -> bool:
        raise RuntimeError(f"unresolved column {self.col_name}")

    def bind(self, schema) -> Expression:
        for i, (name, dt) in enumerate(schema):
            if name == self.col_name:
                return BoundReference(i, dt, name=name)
        # a bare reference to a shredded map column reads its key array
        # (size(m) ...); a whole struct or map projection expands
        # earlier, in select()
        from spark_rapids_tpu_torch.columnar.nested import (
            MAP_KEY_SUFFIX, is_shredded_map)
        flat = [n for n, _ in schema]
        if is_shredded_map(self.col_name, flat):
            return UnresolvedColumn(self.col_name + MAP_KEY_SUFFIX).bind(
                schema)
        members = [n for n in flat if n.startswith(self.col_name + ".")]
        if members:
            raise KeyError(
                f"column {self.col_name!r} is a shredded struct "
                f"({members}); access fields via getField or select it "
                "whole")
        raise KeyError(f"column {self.col_name!r} not in schema {flat}")

    @property
    def name(self) -> str:
        return self.col_name

    def cache_key(self):
        return ("UnresolvedColumn", self.col_name)

    def __str__(self):
        return f"'{self.col_name}"


class BoundReference(Expression):
    """Input column by ordinal."""

    def __init__(self, ordinal: int, dtype: DataType, name: str = "",
                 nullable: bool = True):
        self.ordinal = ordinal
        self._dtype = dtype
        self._name = name
        self._nullable = nullable

    @property
    def dtype(self) -> DataType:
        return self._dtype

    @property
    def nullable(self) -> bool:
        return self._nullable

    @property
    def name(self) -> str:
        return self._name or f"c{self.ordinal}"

    def emit(self, ctx: EmitContext) -> ColVal:
        return ctx.inputs[self.ordinal]

    def cache_key(self):
        return ("BoundReference", self.ordinal, self._dtype.name)

    def __str__(self):
        return f"input[{self.ordinal}, {self._dtype}]"


def _infer_literal_type(value) -> DataType:
    if value is None:
        raise ValueError("null literal needs an explicit dtype")
    if isinstance(value, (bool, np.bool_)):
        return dts.BOOL
    if isinstance(value, (int, np.integer)):
        return dts.INT32 if isinstance(value, np.int32) else dts.INT64
    if isinstance(value, (float, np.floating)):
        return dts.FLOAT64
    if isinstance(value, str):
        return dts.STRING
    if isinstance(value, (np.datetime64, datetime.datetime)):
        return dts.TIMESTAMP_US
    if isinstance(value, datetime.date):
        return dts.DATE32
    if isinstance(value, decimal.Decimal):
        return decimal_literal_type(value)
    raise ValueError(f"cannot infer a literal type for {value!r}")


def decimal_literal_type(value: decimal.Decimal) -> DataType:
    """Spark's type of a decimal literal: as many digits as it has, its
    exponent's scale (an integer's exponent widens the precision)."""
    _, digits, exp = value.as_tuple()
    if not isinstance(exp, int):
        raise ValueError(f"decimal literal {value!r} is not finite")
    scale = max(-exp, 0)
    precision = max(len(digits) + max(exp, 0), scale, 1)
    return dts.DecimalType(precision, scale)


def literal_storage_value(value, dtype: DataType):
    """Host value -> its storage value: dates as int32 days since the
    epoch, timestamps as int64 microseconds (the JAX package's
    conversion), decimals as their unscaled int64."""
    if dtype.is_timestamp and not isinstance(value, (int, np.integer)):
        return int(np.datetime64(value, "us").astype(np.int64))
    if dtype.is_date and not isinstance(value, (int, np.integer)):
        return int(np.datetime64(value, "D").astype(np.int32))
    if dtype.is_decimal:
        # the unscaled value, HALF_UP at the type's scale
        return int(decimal.Decimal(value).scaleb(dtype.scale).quantize(
            decimal.Decimal(1), rounding=decimal.ROUND_HALF_UP))
    return value


class Literal(Expression):
    def __init__(self, value, dtype: Optional[DataType] = None):
        self.value = value
        self._dtype = dtype if dtype is not None else \
            _infer_literal_type(value)

    @property
    def dtype(self) -> DataType:
        return self._dtype

    @property
    def nullable(self) -> bool:
        return self.value is None

    def emit(self, ctx: EmitContext) -> ColVal:
        tdt = dts.torch_dtype(self._dtype)
        null = torch.zeros((), dtype=torch.bool, device=ctx.device) \
            if self.value is None else None
        if self._dtype.is_string:
            # a one-row string: its chars and offsets [0, len]
            text = "" if self.value is None else str(self.value)
            data = np.frombuffer(text.encode("utf-8"),
                                 dtype=np.uint8).copy()
            return ColVal(self._dtype,
                          torch.from_numpy(data).to(ctx.device), null,
                          offsets=torch.tensor([0, len(data)],
                                               dtype=torch.int32,
                                               device=ctx.device))
        if self.value is None:
            return ColVal(self._dtype,
                          torch.zeros((), dtype=tdt, device=ctx.device),
                          null)
        return ColVal(self._dtype, torch.tensor(
            literal_storage_value(self.value, self._dtype), dtype=tdt,
            device=ctx.device))

    @property
    def name(self) -> str:
        return str(self.value)

    def cache_key(self):
        return ("Literal", self._dtype.name, self.value)

    def __str__(self):
        return f"lit({self.value!r})"


class ParamSlot(Expression):
    """A hoisted literal: a typed parameter position in a plan template
    (``plan/template.py``).

    ``cache_key`` is value-free, so two bindings of one template share
    every key.  The current binding lives on the slot (``bind_value``,
    under the prepared handle's lock).  The port's stages are eager, so
    the slot emits exactly what ``Literal.emit`` emits for its bound
    value at each batch, and a templated answer has the inline literal's
    bits (the JAX package threads the values into its traced stages as
    arguments instead).  An unbound slot raises, never answering with a
    stale value; no literal the hoister takes is null, so None is
    unbound."""

    def __init__(self, index: int, dtype: DataType, value=None):
        self.index = index
        self._dtype = dtype
        self.value = value

    @property
    def dtype(self) -> DataType:
        return self._dtype

    @property
    def nullable(self) -> bool:
        return False

    def bind_value(self, value) -> None:
        self.value = value

    def emit(self, ctx: EmitContext) -> ColVal:
        if self.value is None:
            raise RuntimeError(
                f"ParamSlot ${self.index} evaluated unbound: no "
                "parameter value was bound to it")
        return Literal(self.value, self._dtype).emit(ctx)

    @property
    def name(self) -> str:
        return f"$p{self.index}"

    def cache_key(self):
        return ("Param", self.index, self._dtype.name)

    def __str__(self):
        return f"$p{self.index}:{self._dtype.name}"


class Alias(Expression):
    def __init__(self, child: Expression, alias: str):
        self.children = (child,)
        self.alias = alias

    @property
    def child(self) -> Expression:
        return self.children[0]

    @property
    def dtype(self) -> DataType:
        return self.child.dtype

    @property
    def nullable(self) -> bool:
        return self.child.nullable

    def with_children(self, children):
        return Alias(children[0], self.alias)

    def emit(self, ctx: EmitContext) -> ColVal:
        return self.child.emit(ctx)

    @property
    def name(self) -> str:
        return self.alias

    def cache_key(self):
        return ("Alias", self.alias, self.child.cache_key())

    def __str__(self):
        return f"{self.child} AS {self.alias}"


# ----------------------------------------------------------- op scaffolding --

class UnaryExpression(Expression):
    """Null-propagating unary op."""

    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def child(self) -> Expression:
        return self.children[0]

    def with_children(self, children):
        return type(self)(children[0])

    @property
    def dtype(self) -> DataType:
        return self.child.dtype

    def emit(self, ctx: EmitContext) -> ColVal:
        c = self.child.emit(ctx)
        return ColVal(self.dtype, self.eval_values(c.values, c), c.validity)

    def eval_values(self, v, cv: ColVal):
        raise NotImplementedError


class BinaryExpression(Expression):
    """Null-propagating binary op with implicit numeric promotion."""

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    @property
    def left(self) -> Expression:
        return self.children[0]

    @property
    def right(self) -> Expression:
        return self.children[1]

    def with_children(self, children):
        return type(self)(children[0], children[1])

    def operand_type(self) -> DataType:
        return promote_types(self.left.dtype, self.right.dtype)

    @property
    def dtype(self) -> DataType:
        return self.operand_type()

    def emit(self, ctx: EmitContext) -> ColVal:
        t = self.operand_type()
        l = cast_value(self.left.emit(ctx), t)
        r = cast_value(self.right.emit(ctx), t)
        values, extra_validity = self.eval_values(l.values, r.values)
        validity = combine_validity(l.validity, r.validity, extra_validity)
        return ColVal(self.dtype, values, validity)

    def eval_values(self, l, r):
        """Return (values, extra validity mask or None)."""
        raise NotImplementedError


def substitute_bound(expr: Expression,
                     replacements: Sequence[Expression]) -> Expression:
    """Replace each BoundReference(i) with replacements[i] (expression
    composition through an intermediate Project, for stage fusion)."""
    if isinstance(expr, BoundReference):
        return replacements[expr.ordinal]
    if not expr.children:
        return expr
    return expr.with_children(
        [substitute_bound(c, replacements) for c in expr.children])


_NUMERIC_ORDER = ["tinyint", "smallint", "int", "bigint", "float", "double"]


def promote_types(a: DataType, b: DataType) -> DataType:
    """Spark's widening for binary arithmetic and comparison: numeric
    widening; a decimal meets a float as a double, and a decimal or an
    integer as the decimal both fit (``decimal_ops.binary_result``'s
    comparison rule); a date meets a timestamp as a timestamp; a date
    meets a date, and a string a string, unchanged."""
    if a.name == b.name:
        return a
    if a.name in _NUMERIC_ORDER and b.name in _NUMERIC_ORDER:
        return dts.dtype_from_name(
            _NUMERIC_ORDER[max(_NUMERIC_ORDER.index(a.name),
                               _NUMERIC_ORDER.index(b.name))])
    if a.is_decimal or b.is_decimal:
        if a.is_floating or b.is_floating:
            return dts.FLOAT64  # decimal promotes to double
        if (a.is_decimal or a.is_integral) and \
                (b.is_decimal or b.is_integral):
            from spark_rapids_tpu_torch.ops.decimal_ops import binary_result
            return binary_result("cmp", a, b)
    if a.is_datetime and b.is_datetime:
        return dts.TIMESTAMP_US
    raise TypeError(f"cannot promote {a} and {b}")


_MICROS_PER_DAY = 86_400_000_000


def cast_value(v: ColVal, target: DataType) -> ColVal:
    """Implicit promotion: a widening cast of the storage, a date to a
    timestamp (days to microseconds at midnight UTC), or a number to a
    decimal or from a decimal to a double (``ops/cast.py``'s casts, as
    the JAX package's ``cast_value`` takes them).  Explicit casts are
    ``ops/cast.py``'s."""
    if v.dtype.name == target.name:
        return v
    if v.dtype.is_decimal or target.is_decimal:
        from spark_rapids_tpu_torch.ops.cast import cast_colval
        return cast_colval(v, target)
    if promote_types(v.dtype, target).name != target.name:
        raise TypeError(f"implicit cast {v.dtype} -> {target} narrows")
    if v.dtype.is_date and target.is_timestamp:
        return ColVal(target, v.values.to(torch.int64) * _MICROS_PER_DAY,
                      v.validity)
    return ColVal(target, v.values.to(dts.torch_dtype(target)), v.validity)
