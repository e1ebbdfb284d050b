"""Array (collection) expressions.

Counterpart of ``spark_rapids_tpu/ops/collections_ops.py`` (the
reference's ``collectionOperations.scala`` and the complex-type creator
and extractor rules).  An array value is its flat element values plus
int32 row offsets, the string chars layout over typed elements, so these
are the string kernels' tricks over elements, each a few whole-tensor
torch operations with no per-row loop:

* each element's row comes from one ``searchsorted`` over the offsets;
* per-row reductions over elements are ``scatter_reduce`` / ``index_add``
  over those rows (dead elements past the last row go to a spare row);
* ``SortArray`` is one stable sort keyed (row, element), so every row's
  segment sorts in the same pass.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.columnar.dtypes import ArrayType, DataType
from spark_rapids_tpu_torch.ops.expressions import (
    ColVal, EmitContext, Expression, UnaryExpression, combine_validity,
    promote_types)


def element_rows(c: ColVal, capacity: int) -> torch.Tensor:
    """Row (int64) of every element position of the flat buffer."""
    pos = torch.arange(c.values.shape[0], device=c.values.device,
                       dtype=torch.int32)
    row = torch.searchsorted(c.offsets, pos, right=True) - 1
    return row.clamp(0, max(capacity - 1, 0))


def live_elements(c: ColVal, capacity: int) -> torch.Tensor:
    """bool per element position: inside some row (not padding)."""
    pos = torch.arange(c.values.shape[0], device=c.values.device)
    return pos < c.offsets[capacity]


def row_lengths(c: ColVal) -> torch.Tensor:
    return c.offsets[1:] - c.offsets[:-1]


def _rows_of(v: ColVal, capacity: int) -> torch.Tensor:
    """A per-row operand as a (capacity,) tensor (a literal repeats)."""
    x = v.values
    return x.expand(capacity) if x.dim() == 0 else x


def _gather_elements(c: ColVal, pos: torch.Tensor) -> torch.Tensor:
    """``c.values[pos]`` with ``pos`` clamped into the buffer (an empty
    buffer reads zeros); the caller masks what is out of range."""
    n = int(c.values.shape[0])
    if n == 0:
        return torch.zeros(pos.shape, dtype=c.values.dtype,
                           device=c.values.device)
    return c.values[pos.clamp(0, n - 1).to(torch.int64)]


class _ArrayInput:
    """Binds its first child and refuses a non-array there (Spark's
    analyzer rejects ``size('text')`` as a type mismatch)."""

    def bind(self, schema):
        bound = Expression.bind(self, schema)
        dt = bound.children[0].dtype
        if not dt.is_array:
            raise TypeError(f"{type(self).__name__} needs an array (or "
                            f"map) argument, got {dt}")
        return bound


def _offsets_of(lengths: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(lengths.shape[0] + 1, dtype=torch.int64,
                      device=lengths.device)
    torch.cumsum(lengths.to(torch.int64), 0, out=out[1:])
    return out.to(torch.int32)


class CreateArray(Expression):
    """array(e1, e2, ...): row i -> [e1[i], e2[i], ...].  A null element
    has no device representation: a child that is null on a live row
    raises (the JAX package tags any nullable child off the device, and
    its CPU fallback then raises on such a row too)."""

    def __init__(self, *children: Expression):
        if not children:
            raise ValueError("array() needs at least one element")
        self.children = tuple(children)

    @property
    def _element_dtype(self) -> DataType:
        dt = self.children[0].dtype
        for c in self.children[1:]:
            dt = promote_types(dt, c.dtype)
        return dt

    @property
    def dtype(self) -> DataType:
        return ArrayType(self._element_dtype)

    @property
    def nullable(self) -> bool:
        return False

    def with_children(self, children):
        return CreateArray(*children)

    def emit(self, ctx: EmitContext) -> ColVal:
        from spark_rapids_tpu_torch.ops.expressions import cast_value
        elem = self._element_dtype
        vals, validity = [], None
        for c in self.children:
            cv = cast_value(c.emit(ctx), elem)
            validity = combine_validity(validity, cv.validity)
            vals.append(_rows_of(cv, ctx.capacity))
        if validity is not None:
            # a null element has no representation: refuse it (one
            # counted fetch, only when a child carries nulls)
            from spark_rapids_tpu_torch.utils import hostsync
            if bool(hostsync.fetch((~validity & ctx.row_mask()).any())):
                raise ValueError("array(): a null element (null array "
                                 "elements are not supported)")
        k = len(vals)
        flat = torch.stack(vals, dim=1).reshape(-1)
        offsets = (torch.arange(ctx.capacity + 1, device=ctx.device,
                                dtype=torch.int32) * k)
        return ColVal(self.dtype, flat, None, offsets)


class Size(_ArrayInput, UnaryExpression):
    """size(array): the element count; -1 for a null input (Spark's
    default ``spark.sql.legacy.sizeOfNull=true``)."""

    @property
    def dtype(self) -> DataType:
        return dts.INT32

    @property
    def nullable(self) -> bool:
        return False

    def emit(self, ctx: EmitContext) -> ColVal:
        c = self.child.emit(ctx)
        lens = row_lengths(c).to(torch.int32)
        if c.validity is not None:
            lens = torch.where(c.validity, lens, -1)
        return ColVal(dts.INT32, lens, None)


class ArrayContains(_ArrayInput, Expression):
    """array_contains(arr, value)."""

    def __init__(self, child: Expression, value: Expression):
        self.children = (child, value)

    @property
    def dtype(self) -> DataType:
        return dts.BOOL

    def with_children(self, children):
        return ArrayContains(children[0], children[1])

    def emit(self, ctx: EmitContext) -> ColVal:
        c = self.children[0].emit(ctx)
        v = self.children[1].emit(ctx)
        cap = ctx.capacity
        row = element_rows(c, cap)
        live = live_elements(c, cap)
        target = v.values if v.values.dim() == 0 else v.values[row]
        hit = live & (c.values == target)
        seg = torch.where(live, row, cap)
        found = torch.zeros(cap + 1, dtype=torch.int32, device=ctx.device)
        found.index_add_(0, seg, hit.to(torch.int32))
        # Spark: a null array or a null value gives null (the JAX package
        # reads the array's validity only)
        return ColVal(dts.BOOL, found[:cap] > 0,
                      combine_validity(c.validity, v.validity))


class GetArrayItem(Expression):
    """arr[i] (Spark's 0-based GetArrayItem); null out of range.  On a
    shredded map column ``m[k]`` is a key lookup (``GetMapValue``)."""

    def __init__(self, child: Expression, index: Expression):
        self.children = (child, index)

    @property
    def dtype(self) -> DataType:
        return self.children[0].dtype.element

    @property
    def nullable(self) -> bool:
        return True

    def with_children(self, children):
        return type(self)(children[0], children[1])

    def bind(self, schema):
        from spark_rapids_tpu_torch.columnar.nested import is_shredded_map
        from spark_rapids_tpu_torch.ops.expressions import UnresolvedColumn
        from spark_rapids_tpu_torch.ops.nested_ops import GetMapValue
        base = self.children[0]
        if isinstance(base, UnresolvedColumn) and \
                is_shredded_map(base.col_name, [n for n, _ in schema]):
            return GetMapValue(base, self.children[1]).bind(schema)
        return _ArrayInput.bind(self, schema)

    def _zero_based(self, idx: torch.Tensor, lens: torch.Tensor):
        return idx

    def emit(self, ctx: EmitContext) -> ColVal:
        c = self.children[0].emit(ctx)
        i = self.children[1].emit(ctx)
        cap = ctx.capacity
        lens = row_lengths(c).to(torch.int64)
        idx = self._zero_based(_rows_of(i, cap).to(torch.int64), lens)
        in_range = (idx >= 0) & (idx < lens)
        vals = _gather_elements(c, c.offsets[:-1].to(torch.int64) + idx)
        validity = combine_validity(c.validity, in_range, i.validity)
        return ColVal(self.dtype, vals, validity)


class ElementAt(GetArrayItem):
    """element_at(arr, i): 1-based, a negative index counts from the end.
    On a shredded map column it is the key lookup (through the inherited
    bind), as Spark's ElementAt is over both container kinds."""

    def _zero_based(self, idx, lens):
        return torch.where(idx > 0, idx - 1, lens + idx)


class SortArray(_ArrayInput, Expression):
    """sort_array(arr, asc): every row's elements sorted by one stable
    sort keyed (row, element), Spark's order (NaN largest, -0.0 equal to
    0.0)."""

    def __init__(self, child: Expression, ascending: bool = True):
        self.children = (child,)
        self.ascending = ascending

    @property
    def child(self) -> Expression:
        return self.children[0]

    @property
    def dtype(self) -> DataType:
        return self.child.dtype

    def with_children(self, children):
        return SortArray(children[0], self.ascending)

    def cache_key(self):
        return ("SortArray", self.ascending, self.child.cache_key())

    def emit(self, ctx: EmitContext) -> ColVal:
        from spark_rapids_tpu_torch.ops.aggregates import _order_keys
        c = self.child.emit(ctx)
        cap = ctx.capacity
        # dead elements (padding past the last row) sort after every row
        row = torch.where(live_elements(c, cap), element_rows(c, cap), cap)
        perm = torch.arange(c.values.shape[0], device=ctx.device)
        for k in _order_keys(c.values, not self.ascending) + [row]:
            perm = perm[torch.argsort(k[perm], stable=True)]
        return ColVal(c.dtype, c.values[perm], c.validity, c.offsets)


class _ArrayExtreme(_ArrayInput, UnaryExpression):
    """array_min / array_max: one segmented reduction over (row,
    element).  An empty array gives null; a float NaN follows Spark's
    total order (any NaN is the max; NaN is the min only of an all-NaN
    row)."""

    is_max = False

    @property
    def dtype(self) -> DataType:
        return self.child.dtype.element

    def emit(self, ctx: EmitContext) -> ColVal:
        from spark_rapids_tpu_torch.ops.aggregates import (
            _minmax_view, _sentinel)
        c = self.child.emit(ctx)
        cap = ctx.capacity
        v = c.values
        live = live_elements(c, cap)
        seg = torch.where(live, element_rows(c, cap), cap)
        lens = row_lengths(c)[:cap]
        kind = "max" if self.is_max else "min"
        data = _minmax_view(v)
        if v.dtype.is_floating_point:
            nan = torch.isnan(v)
            data = _ordered_bits(torch.where(
                nan, float("-inf") if self.is_max else float("inf"), v))
            nan_cnt = torch.zeros(cap + 1, dtype=torch.int64,
                                  device=ctx.device).index_add_(
                0, seg, (nan & live).to(torch.int64))[:cap]
        out = torch.full((cap + 1,), _sentinel(kind, data.dtype),
                         dtype=data.dtype, device=ctx.device)
        out.scatter_reduce_(0, seg, data, "amax" if self.is_max else "amin")
        out = out[:cap]
        if v.dtype.is_floating_point:
            out = _ordered_bits(out).view(v.dtype)
            nan_val = torch.full_like(out, float("nan"))
            out = torch.where((nan_cnt == lens) & (lens > 0), nan_val, out)
            if self.is_max:
                out = torch.where(nan_cnt > 0, nan_val, out)
        return ColVal(self.dtype, out.to(v.dtype),
                      combine_validity(c.validity, lens > 0))


def _ordered_bits(v: torch.Tensor) -> torch.Tensor:
    """A float tensor's bits as integers in the floats' order, with -0.0
    just below 0.0 (a min keeps -0.0, a max 0.0, whatever order the
    elements reduce in, as the JAX package's reductions do); applied to
    such integers it gives the float bits back."""
    if v.dtype.is_floating_point:
        v = v.view(torch.int64 if v.dtype == torch.float64 else torch.int32)
    low = torch.iinfo(v.dtype).max
    return torch.where(v < 0, v ^ low, v)


class ArrayMin(_ArrayExtreme):
    is_max = False


class ArrayMax(_ArrayExtreme):
    is_max = True


class Reverse(UnaryExpression):
    """reverse() over arrays (element order) and strings (bytes: the
    ASCII-only incompatible class, as the engine's other byte-wise
    string kernels)."""

    @property
    def dtype(self) -> DataType:
        return self.child.dtype

    def emit(self, ctx: EmitContext) -> ColVal:
        from spark_rapids_tpu_torch.ops.stringops import as_column
        c = self.child.emit(ctx)
        if c.dtype.is_string:
            c = as_column(c, ctx.capacity)
        cap = ctx.capacity
        v = c.values
        if v.shape[0] == 0:
            return c
        row = element_rows(c, cap)
        i = torch.arange(v.shape[0], device=v.device)
        offs = c.offsets.to(torch.int64)
        j = torch.where(live_elements(c, cap),
                        offs[row] + offs[row + 1] - 1 - i, i)
        return ColVal(c.dtype, v[j], c.validity, c.offsets)


class Slice(_ArrayInput, UnaryExpression):
    """slice(arr, start, length) with literal bounds (1-based start, a
    negative start counts from the end; Spark's semantics, and the
    reference's GpuSlice takes literal bounds in the common case)."""

    def __init__(self, child: Expression, start: int, length: int):
        super().__init__(child)
        if start == 0:
            raise ValueError("slice start must not be 0 (SQL is 1-based)")
        if length < 0:
            raise ValueError("slice length must be >= 0")
        self.start = int(start)
        self.length = int(length)

    def with_children(self, children):
        return Slice(children[0], self.start, self.length)

    def cache_key(self):
        return ("Slice", self.start, self.length, self.child.cache_key())

    @property
    def dtype(self) -> DataType:
        return self.child.dtype

    def emit(self, ctx: EmitContext) -> ColVal:
        c = self.child.emit(ctx)
        cap = ctx.capacity
        lens = row_lengths(c).to(torch.int64)
        if self.start > 0:
            s_raw = torch.full((cap,), self.start - 1, dtype=torch.int64,
                               device=ctx.device)
        else:
            s_raw = lens + self.start
        # Spark: a negative start before the array's first element gives
        # the empty array
        s = torch.minimum(s_raw.clamp(min=0), lens)
        out_len = torch.minimum(torch.full_like(lens, self.length), lens - s)
        out_len = torch.where((s_raw < 0) | ~ctx.row_mask(), 0, out_len)
        out_offsets = _offsets_of(out_len)
        ecap = int(c.values.shape[0])
        pos = torch.arange(ecap, device=ctx.device, dtype=torch.int32)
        row = (torch.searchsorted(out_offsets, pos, right=True) - 1) \
            .clamp(0, max(cap - 1, 0))
        src = c.offsets[row].to(torch.int64) + s[row] + \
            (pos - out_offsets[row])
        vals = torch.where(pos < out_offsets[cap], _gather_elements(c, src),
                           torch.zeros((), dtype=c.values.dtype,
                                       device=ctx.device))
        return ColVal(c.dtype, vals, c.validity, out_offsets)


class ArrayRepeat(Expression):
    """array_repeat(value, n) with a literal count: every row's array has
    n copies of its value."""

    def __init__(self, child: Expression, times: int):
        self.children = (child,)
        self.times = max(int(times), 0)

    @property
    def child(self) -> Expression:
        return self.children[0]

    def with_children(self, children):
        return ArrayRepeat(children[0], self.times)

    def cache_key(self):
        return ("ArrayRepeat", self.times, self.child.cache_key())

    @property
    def dtype(self) -> DataType:
        return ArrayType(self.child.dtype)

    @property
    def nullable(self) -> bool:
        return self.child.nullable

    def emit(self, ctx: EmitContext) -> ColVal:
        c = self.child.emit(ctx)
        cap = ctx.capacity
        n = self.times
        lens = torch.where(ctx.row_mask(), n, 0)
        offsets = _offsets_of(lens)
        vals = _rows_of(c, cap).repeat_interleave(n)
        validity = c.validity
        if validity is not None and validity.dim() == 0:
            validity = validity.expand(cap)
        return ColVal(ArrayType(c.dtype), vals, validity, offsets)
