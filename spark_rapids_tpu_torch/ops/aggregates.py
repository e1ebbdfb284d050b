"""Aggregation: aggregate functions, keyless reduction and three group-by
paths (sort, dense coded directory, hash table).

Counterpart of ``spark_rapids_tpu/ops/aggregates.py``.  Aggregate functions
keep the update/merge/finalize split: ``update_inputs`` maps raw input to
typed buffer columns, buffers re-reduce across batches with
:func:`merge_kind`, ``finalize`` computes the result.

Group-by paths, picked per batch by ``exec/aggregate.py``:

- coded: fixed-width integral keys whose key-space product is at most
  ``MAX_CODED_GROUPS`` are addressed directly by a radix code (digit 0 is
  the null slot), one segment reduction per buffer into the code table;
- hashed: the same radix code through an open-addressing table
  (``kernels.hash_insert``) when the key space is larger;
- sort: lexicographic sort, boundary flags, segment reduction; exact for
  every key type, and the fallback after a hash overflow.

All three give the same groups in the same order (ascending keys, nulls
first) and, for integer and integer-valued sums, the same bits.  Segment
sums use ``index_add_``, which on CUDA adds floats with atomics in an
order that changes from run to run; float sums therefore agree with
another order to a relative 1e-12 (the tests' bound), and counts and keys
exactly.  The port leaves ``torch.use_deterministic_algorithms`` at its
default (off).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops import kernels
from spark_rapids_tpu_torch.ops.compiler import widen
from spark_rapids_tpu_torch.ops.expressions import (
    ColVal, Expression, combine_validity)
from spark_rapids_tpu_torch.utils import hostsync

_INT64_MAX = (1 << 63) - 1
_U32 = 0xFFFFFFFF


# --------------------------------------------------------- aggregate functions

@dataclasses.dataclass(frozen=True)
class BufferSpec:
    """One reduction buffer: its reduction kind and type."""
    kind: str          # 'sum' | 'min' | 'max'
    dtype: DataType


def merge_kind(update_kind: str) -> str:
    """Reduction applied when re-reducing partial buffer rows."""
    return {"sum": "sum", "min": "min", "max": "max"}[update_kind]


class AggregateFunction:
    """Base: declares buffers, the update transform and finalize."""

    name = "agg"

    def __init__(self, child: Optional[Expression]):
        self.child = child

    def buffers(self) -> List[BufferSpec]:
        raise NotImplementedError

    def update_inputs(self, c: Optional[ColVal], capacity: int,
                      device) -> List[ColVal]:
        """Map the evaluated child column to one ColVal per buffer."""
        raise NotImplementedError

    def finalize(self, bufs: List[ColVal]) -> ColVal:
        raise NotImplementedError

    @property
    def result_dtype(self) -> DataType:
        raise NotImplementedError

    @property
    def result_nullable(self) -> bool:
        return True

    def cache_key(self):
        return (type(self).__name__,
                self.child.cache_key() if self.child is not None else None)


def _sum_result_type(t: DataType) -> DataType:
    if t.is_floating:
        return dts.FLOAT64
    if t.is_integral:
        return dts.INT64
    raise TypeError(f"sum over {t} is not supported")


class Sum(AggregateFunction):
    name = "sum"

    @property
    def result_dtype(self):
        return _sum_result_type(self.child.dtype)

    def buffers(self):
        return [BufferSpec("sum", self.result_dtype)]

    def update_inputs(self, c, capacity, device):
        t = self.result_dtype
        return [ColVal(t, c.values.to(dts.torch_dtype(t)), c.validity)]

    def finalize(self, bufs):
        return bufs[0]


class Count(AggregateFunction):
    """count(expr); count(None) is count(*)."""

    name = "count"

    @property
    def result_dtype(self):
        return dts.INT64

    @property
    def result_nullable(self):
        return False

    def buffers(self):
        return [BufferSpec("sum", dts.INT64)]

    def update_inputs(self, c, capacity, device):
        if c is None or c.validity is None:
            return [ColVal(dts.INT64, torch.ones(capacity, dtype=torch.int64,
                                                 device=device))]
        return [ColVal(dts.INT64, c.validity.to(torch.int64))]

    def finalize(self, bufs):
        v = bufs[0]
        if v.validity is not None:  # count is 0, never null
            return ColVal(dts.INT64, torch.where(
                v.validity, v.values, torch.zeros_like(v.values)))
        return v


class Min(AggregateFunction):
    name = "min"

    @property
    def result_dtype(self):
        return self.child.dtype

    def buffers(self):
        return [BufferSpec("min", self.child.dtype)]

    def update_inputs(self, c, capacity, device):
        return [c]

    def finalize(self, bufs):
        return bufs[0]


class Max(Min):
    name = "max"

    def buffers(self):
        return [BufferSpec("max", self.child.dtype)]


class Average(AggregateFunction):
    name = "avg"

    @property
    def result_dtype(self):
        return dts.FLOAT64

    def buffers(self):
        return [BufferSpec("sum", dts.FLOAT64), BufferSpec("sum", dts.INT64)]

    def update_inputs(self, c, capacity, device):
        n = c.validity.to(torch.int64) if c.validity is not None else \
            torch.ones(capacity, dtype=torch.int64, device=device)
        return [ColVal(dts.FLOAT64, c.values.to(torch.float64), c.validity),
                ColVal(dts.INT64, n)]

    def finalize(self, bufs):
        s, n = bufs
        cnt = torch.where(n.values == 0, torch.ones_like(n.values), n.values)
        validity = combine_validity(s.validity, n.values > 0)
        return ColVal(dts.FLOAT64, s.values / cnt, validity)


# ------------------------------------------------------------------ helpers --

def _row_mask(nrows, capacity: int, device, row_mask=None) -> torch.Tensor:
    """bool[capacity] of live rows: ``row_mask`` overrides the prefix."""
    if row_mask is not None:
        return row_mask
    return torch.arange(capacity, device=device) < nrows


def _sentinel(kind: str, dtype: torch.dtype):
    """Identity of a min/max reduction in ``dtype``."""
    if dtype.is_floating_point:
        info = torch.finfo(dtype)
    else:
        info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


# ---------------------------------------------------------------- sort path --

def _order_keys(v: torch.Tensor, desc: bool = False) -> List[torch.Tensor]:
    """Sort-key pieces (least-significant first) for Spark's order of one
    column: floats sort as a normalized value plus a more significant NaN
    flag (NaN largest, -0.0 == 0.0), negated for descending; integers,
    dates and bools descend through bitwise-not, which reverses
    two's-complement order."""
    if v.dtype.is_floating_point:
        nan = torch.isnan(v)
        zero = torch.zeros((), dtype=v.dtype, device=v.device)
        f = torch.where((v == 0) | nan, zero, v)
        flag = nan.to(torch.int8)
        return [-f, -flag] if desc else [f, flag]
    if v.dtype == torch.bool:
        v = v.to(torch.int8)
    return [~v] if desc else [v]


def _sortable_keys(keys: Sequence[ColVal], valid_rows,
                   descending: Optional[Sequence[bool]] = None,
                   nulls_first: Optional[Sequence[bool]] = None
                   ) -> List[torch.Tensor]:
    """Sort keys, least-significant first; dead rows sort last.  Nulls
    go first ascending and last descending unless ``nulls_first`` says
    otherwise (Spark's defaults).  Null rows' values canonicalize to 0
    before the order keys are built, so all nulls of a column form one
    group."""
    n = len(keys)
    descending = list(descending or [False] * n)
    nulls_first = list(nulls_first or [not d for d in descending])
    lex: List[torch.Tensor] = []
    for c, desc, nf in zip(reversed(list(keys)), reversed(descending),
                           reversed(nulls_first)):
        v = c.values
        if c.validity is not None:
            v = torch.where(c.validity, v, torch.zeros_like(v))
        lex.extend(_order_keys(v, desc))
        if c.validity is not None:
            null_key = (~c.validity).to(torch.int8)
            lex.append(-null_key if nf else null_key)
    lex.append((~valid_rows).to(torch.int8))
    return lex


def sort_permutation(keys: Sequence[ColVal], valid_rows,
                     descending: Optional[Sequence[bool]] = None,
                     nulls_first: Optional[Sequence[bool]] = None
                     ) -> torch.Tensor:
    """Stable lexicographic sort permutation (int64): one stable argsort
    pass per key piece, least significant first.  Defaults sort every
    key ascending with nulls first (the group-by's order)."""
    perm = torch.arange(valid_rows.shape[0], device=valid_rows.device)
    for k in _sortable_keys(keys, valid_rows, descending, nulls_first):
        perm = perm[torch.argsort(k[perm], stable=True)]
    return perm


def _keys_equal_prev(sorted_keys: Sequence[ColVal],
                     capacity: int, device) -> torch.Tensor:
    """bool[capacity]: row i has the same keys as row i-1 (nulls equal,
    NaN equal to NaN, -0.0 equal to 0.0)."""
    eq = torch.ones(capacity, dtype=torch.bool, device=device)
    for c in sorted_keys:
        v = c.values
        prev = torch.roll(v, 1)
        same = v == prev
        if v.dtype.is_floating_point:
            same = same | (torch.isnan(v) & torch.isnan(prev))
        if c.validity is not None:
            pv = torch.roll(c.validity, 1)
            same = torch.where(c.validity & pv, same,
                               ~(c.validity | pv))
        eq = eq & same
    if capacity:
        eq[0] = False
    return eq


def _segment_reduce(kind: str, c: ColVal, seg_ids, num_segments: int,
                    valid_rows):
    """Reduce one buffer column by segment; ``seg_ids == num_segments`` is
    the trash segment.  Returns (values, non-null counts)."""
    ns = num_segments
    dev = c.values.device
    contrib = valid_rows if c.validity is None else \
        valid_rows & c.validity
    counts = torch.zeros(ns + 1, dtype=torch.int64, device=dev).index_add_(
        0, seg_ids, contrib.to(torch.int64))[:ns]
    v = c.values
    if kind == "sum":
        vals = torch.where(contrib, v, torch.zeros_like(v))
        out = torch.zeros(ns + 1, dtype=v.dtype, device=dev).index_add_(
            0, seg_ids, vals)
    elif kind in ("min", "max"):
        s = _sentinel(kind, v.dtype)
        vals = torch.where(contrib, v, torch.full_like(v, s))
        out = torch.full((ns + 1,), s, dtype=v.dtype, device=dev)
        out.scatter_reduce_(0, seg_ids, vals,
                            "amin" if kind == "min" else "amax")
    else:
        raise ValueError(f"unknown reduce kind {kind}")
    return out[:ns], counts


def groupby_aggregate(keys: Sequence[ColVal],
                      buffer_inputs: Sequence[Tuple[str, ColVal]],
                      nrows, capacity: int, row_mask=None):
    """Sort-based group-by.  Returns (out_keys, out_buffers, num_groups):
    outputs have ``capacity`` rows, of which the first ``num_groups`` (a
    0-dim device tensor) are groups in ascending key order."""
    device = (keys[0].values if keys else buffer_inputs[0][1].values).device
    keys = [widen(c, capacity) for c in keys]
    buffer_inputs = [(k, widen(c, capacity)) for k, c in buffer_inputs]
    live = _row_mask(nrows, capacity, device, row_mask)
    n_live = live.sum()
    perm = sort_permutation(keys, live)
    # after the sort the live rows form a prefix of length n_live
    valid_sorted = torch.arange(capacity, device=device) < n_live
    from spark_rapids_tpu_torch.ops import selection
    sorted_keys = selection.gather(keys, perm)
    sorted_bufs = selection.gather([c for _, c in buffer_inputs], perm)
    boundary = ~_keys_equal_prev(sorted_keys, capacity, device) & \
        valid_sorted
    num_groups = boundary.sum()
    seg_ids = torch.cumsum(boundary, 0) - 1
    seg_ids = torch.where(valid_sorted, seg_ids, capacity)
    out_bufs = []
    for (kind, _), sc in zip(buffer_inputs, sorted_bufs):
        vals, counts = _segment_reduce(kind, sc, seg_ids, capacity,
                                       valid_sorted)
        out_bufs.append(ColVal(sc.dtype, vals, counts > 0))
    # representative (first) row of each group for the key values
    first = torch.full((capacity + 1,), capacity, dtype=torch.int64,
                       device=device)
    first.scatter_reduce_(0, seg_ids, torch.arange(capacity, device=device),
                          "amin")
    first = first[:capacity].clamp(0, max(capacity - 1, 0))
    out_keys = selection.gather(sorted_keys, first)
    return out_keys, out_bufs, num_groups


# ------------------------------------------------- coded (sort-free) path --

MAX_CODED_GROUPS = 1 << 21


def coded_key_eligible(dtypes) -> bool:
    """Keys a radix code can address: fixed-width, non-float (integers,
    bools, dates and timestamps)."""
    return all(not dt.is_floating and not dt.has_offsets for dt in dtypes)


def key_range_probe(keys: Sequence[ColVal], live):
    """Per-key (min, max) over live valid rows as two int64[nkeys]
    tensors; an all-dead key reports (dtype max, dtype min)."""
    mins, maxs = [], []
    for c in keys:
        v = c.values
        if v.dtype == torch.bool:
            v = v.to(torch.int32)
        info = torch.iinfo(v.dtype)
        valid = live if c.validity is None else live & c.validity
        if v.shape[0] == 0:
            mins.append(torch.tensor(info.max, device=v.device))
            maxs.append(torch.tensor(info.min, device=v.device))
            continue
        mins.append(torch.where(valid, v, info.max).min().to(torch.int64))
        maxs.append(torch.where(valid, v, info.min).max().to(torch.int64))
    return torch.stack(mins).to(torch.int64), torch.stack(maxs).to(torch.int64)


def coded_slot_ranges(mins: np.ndarray, maxs: np.ndarray):
    """Host-side: per-key slot count (digit 0 is always the null slot) and
    the key-space size; None when the space exceeds ``MAX_CODED_GROUPS``."""
    slots = []
    total = 1
    for mn, mx in zip(mins.tolist(), maxs.tolist()):
        rn = max(0, int(mx) - int(mn) + 1)
        slots.append(rn + 1)
        total *= rn + 1
        if total > MAX_CODED_GROUPS:
            return None
    return slots, total


MAX_HASHED_KEYSPACE = 1 << 62


def hashed_slot_ranges(mins: np.ndarray, maxs: np.ndarray):
    """Host-side analog of :func:`coded_slot_ranges` for the hash path:
    the radix code only has to stay injective in int64, so the bound is
    the key-space product staying under 2**62.  None past it."""
    slots = []
    total = 1
    for mn, mx in zip(mins.tolist(), maxs.tolist()):
        rn = max(0, int(mx) - int(mn) + 1)
        slots.append(rn + 1)
        total *= rn + 1
        if total > MAX_HASHED_KEYSPACE:
            return None
    return slots, total


def _radix_code(keys: Sequence[ColVal], mins: Sequence[int],
                slot_ranges: Sequence[int], capacity: int, device):
    """Row codes: digit 0 = null, 1.. = value - min + 1, mixed with
    strides from the last key (least significant).  Returns (code int64,
    strides per key)."""
    code = torch.zeros(capacity, dtype=torch.int64, device=device)
    stride = 1
    strides_rev = []
    for i in reversed(range(len(keys))):
        c = keys[i]
        v = c.values.to(torch.int64)
        rn = slot_ranges[i] - 1
        d = torch.clamp(v - mins[i], 0, max(rn - 1, 0)) + 1
        if c.validity is not None:
            d = torch.where(c.validity, d, torch.zeros_like(d))
        code = code + d * stride
        strides_rev.append(stride)
        stride *= slot_ranges[i]
    return code, strides_rev[::-1]


def _key_columns_from_codes(keys, codes, mins, slot_ranges, strides):
    """Key values (and validity: digit 0 is null) decoded from codes."""
    out = []
    for i, c in enumerate(keys):
        digit = torch.remainder(
            torch.div(codes, max(strides[i], 1), rounding_mode="floor"),
            max(slot_ranges[i], 1))
        vals = mins[i] + digit - 1
        vd = (digit > 0) if c.validity is not None else None
        if c.values.dtype == torch.bool:
            vals = vals != 0
        out.append(ColVal(c.dtype, vals.to(c.values.dtype), vd))
    return out


def _segment_reduce_coded(kind: str, c: ColVal, code, ns: int, counts_of):
    """One buffer reduction for the coded and hashed paths.  Null rows go
    to the TRASH SEGMENT ``ns - 1`` instead of masking the values.
    ``counts_of(validity, bcode)`` returns per-slot live counts."""
    vals = c.values
    if c.validity is not None:
        bcode = torch.where(c.validity, code, ns - 1)
    else:
        bcode = code
    counts = counts_of(c.validity, bcode)
    dev = vals.device
    if kind == "sum":
        out = torch.zeros(ns, dtype=vals.dtype, device=dev).index_add_(
            0, bcode, vals)
    elif kind in ("min", "max"):
        s = _sentinel(kind, vals.dtype)
        out = torch.full((ns,), s, dtype=vals.dtype, device=dev)
        out.scatter_reduce_(0, bcode, vals,
                            "amin" if kind == "min" else "amax")
    else:
        raise ValueError(f"unknown reduce kind {kind}")
    return out[: ns - 1], counts


def _slot_reductions(buffer_inputs, code, ns: int, device):
    """Per-slot (values, counts) of every buffer over ``ns`` slots (the
    last one the trash).  Same-dtype, validity-free ``sum`` buffers stack
    into ONE 2-D ``index_add_`` whose extra ones column also yields the
    per-slot live counts (the JAX package's batched sum scatter)."""
    results: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
    groups: Dict[torch.dtype, List[int]] = {}
    for j, (kind, c) in enumerate(buffer_inputs):
        if kind == "sum" and c.validity is None:
            groups.setdefault(c.values.dtype, []).append(j)
    slot_counts = None
    for dt, idxs in groups.items():
        cols = [buffer_inputs[j][1].values for j in idxs]
        exact_ones = dt == torch.float64 or not dt.is_floating_point
        fuse_counts = exact_ones and slot_counts is None
        if len(idxs) < 2 and not fuse_counts:
            continue
        if fuse_counts:
            cols.append(torch.ones_like(cols[0]))
        summed = torch.zeros((ns, len(cols)), dtype=dt,
                             device=device).index_add_(
            0, code, torch.stack(cols, dim=1))
        if fuse_counts:
            slot_counts = summed[:, -1].to(torch.int64)
        for col_i, j in enumerate(idxs):
            results[j] = summed[: ns - 1, col_i]
    if slot_counts is None:
        slot_counts = torch.bincount(code, minlength=ns)
    counts_cache: Dict[int, torch.Tensor] = {}

    def counts_of(validity, bcode):
        if validity is None:
            return slot_counts[: ns - 1]
        got = counts_cache.get(id(validity))
        if got is None:
            got = torch.bincount(bcode, minlength=ns)[: ns - 1]
            counts_cache[id(validity)] = got
        return got

    out = []
    for j, (kind, c) in enumerate(buffer_inputs):
        if j in results:
            out.append((results[j], slot_counts[: ns - 1]))
        else:
            out.append(_segment_reduce_coded(kind, c, code, ns, counts_of))
    return out, slot_counts[: ns - 1]


def groupby_aggregate_coded(keys: Sequence[ColVal],
                            buffer_inputs: Sequence[Tuple[str, ColVal]],
                            nrows, capacity: int, mins: Sequence[int],
                            slot_ranges: Sequence[int], k_bucket: int,
                            row_mask=None):
    """Sort-free group-by: keys fixed-width integral with key-space
    product <= ``k_bucket``.  ``mins``/``slot_ranges`` are host ints from
    the probe.  Groups come out ascending with nulls first, identical to
    the sort path's order, in ``k_bucket``-row outputs with a device
    count."""
    device = keys[0].values.device
    keys = [widen(c, capacity) for c in keys]
    buffer_inputs = [(k, widen(c, capacity)) for k, c in buffer_inputs]
    live = _row_mask(nrows, capacity, device, row_mask)
    code, strides = _radix_code(keys, mins, slot_ranges, capacity, device)
    code = torch.where(live, torch.clamp(code, 0, k_bucket), k_bucket)
    ns = k_bucket + 1
    reduced, slot_counts = _slot_reductions(buffer_inputs, code, ns, device)
    occupied = slot_counts > 0
    num_groups = occupied.sum()
    pos = torch.cumsum(occupied, 0) - 1
    # occupied slot -> dense position; unoccupied -> trash row k_bucket
    out_idx = torch.where(occupied, pos, k_bucket)

    def compact(dtype, vals, validity):
        dv = torch.zeros(k_bucket + 1, dtype=vals.dtype, device=device)
        dv.scatter_(0, out_idx, vals)
        if validity is None:
            return ColVal(dtype, dv[:k_bucket])
        dvalid = torch.zeros(k_bucket + 1, dtype=torch.bool, device=device)
        dvalid.scatter_(0, out_idx, validity)
        return ColVal(dtype, dv[:k_bucket], dvalid[:k_bucket])

    slots = torch.arange(k_bucket, device=device)
    out_keys = [compact(k.dtype, k.values, k.validity) for k in
                _key_columns_from_codes(keys, slots, mins, slot_ranges,
                                        strides)]
    out_bufs = [compact(c.dtype, vals, counts > 0)
                for (_, c), (vals, counts) in zip(buffer_inputs, reduced)]
    return out_keys, out_bufs, num_groups


def groupby_aggregate_hashed(keys: Sequence[ColVal],
                             buffer_inputs: Sequence[Tuple[str, ColVal]],
                             nrows, capacity: int, mins: Sequence[int],
                             slot_ranges: Sequence[int], table_slots: int,
                             row_mask=None):
    """Hash group-by: the coded path's injective radix code, addressed
    through a ``table_slots``-entry open-addressing table
    (``kernels.hash_insert``) instead of a dense code table.

    Returns ``(out_keys, out_bufs, num_groups, overflow)`` after one
    counted fetch of (overflow, group count).  On overflow (a probe chain
    past the cap, or more groups than slots) the outputs are None: the
    caller re-runs the exact sort path.  Otherwise outputs have exactly
    ``num_groups`` rows, bit-identical to the coded/sort paths: occupied
    slots compact in stored-code-ascending order, which does not depend on
    the table's layout."""
    device = keys[0].values.device
    keys = [widen(c, capacity) for c in keys]
    buffer_inputs = [(k, widen(c, capacity)) for k, c in buffer_inputs]
    live = _row_mask(nrows, capacity, device, row_mask)
    code, strides = _radix_code(keys, mins, slot_ranges, capacity, device)
    lo = kernels._to_i32_wrapping(code & _U32)
    hi = (code >> 32).to(torch.int32)
    slot, tlo, thi, occupied, overflow = kernels.hash_insert(
        lo, hi, live, table_slots)
    ovf_h, ng = hostsync.fetch(overflow, occupied.sum())
    if bool(ovf_h):
        return None, None, 0, True
    ng = int(ng)
    T = table_slots
    slot_code = (thi.to(torch.int64) << 32) | (tlo.to(torch.int64) & _U32)
    # occupied slots in stored-code-ascending order (radix codes are
    # < 2**62, so the int64-max filler of empty slots sorts last)
    order = torch.argsort(torch.where(occupied, slot_code, _INT64_MAX))
    occ_slots = order[:ng]
    out_keys = _key_columns_from_codes(keys, slot_code[occ_slots], mins,
                                       slot_ranges, strides)
    reduced, _ = _slot_reductions(buffer_inputs, slot.to(torch.int64),
                                  T + 1, device)
    out_bufs = [ColVal(c.dtype, vals[occ_slots], counts[occ_slots] > 0)
                for (_, c), (vals, counts) in zip(buffer_inputs, reduced)]
    return out_keys, out_bufs, ng, False


# ----------------------------------------------------------- keyless path --

def reduce_aggregate(buffer_inputs: Sequence[Tuple[str, ColVal]],
                     nrows, capacity: int, device,
                     row_mask=None) -> List[ColVal]:
    """Grand-total (no keys) reduction: one output row per buffer.

    When every buffer is a float ``sum``, all of them go through
    ``kernels.masked_multi_reduce`` in one pass (the hand-written kernel
    on CUDA, its plain version on the CPU).  Otherwise each buffer is a
    masked torch reduction."""
    if not buffer_inputs:
        return []
    valid_rows = _row_mask(nrows, capacity, device, row_mask)
    if all(k == "sum" and c.dtype.is_floating for k, c in buffer_inputs):
        vals = [widen(c, capacity).values.to(torch.float64).contiguous()
                for _, c in buffer_inputs]
        valids = [None if c.validity is None else
                  widen(c, capacity).validity.contiguous()
                  for _, c in buffer_inputs]
        sums, cnts = kernels.masked_multi_reduce(vals, valids,
                                                 valid_rows.contiguous())
        return [ColVal(c.dtype, sums[i:i + 1].to(c.values.dtype),
                       cnts[i:i + 1] > 0)
                for i, (_, c) in enumerate(buffer_inputs)]
    outs: List[ColVal] = []
    for kind, c in buffer_inputs:
        c = widen(c, capacity)
        v = c.values
        contrib = valid_rows if c.validity is None else \
            valid_rows & c.validity
        count = contrib.sum()
        if kind == "sum":
            out = torch.where(contrib, v, torch.zeros_like(v)).sum(
                dtype=v.dtype)
        elif kind in ("min", "max"):
            s = _sentinel(kind, v.dtype)
            masked = torch.where(contrib, v, torch.full_like(v, s))
            if capacity == 0:
                out = torch.tensor(s, dtype=v.dtype, device=device)
            else:
                out = masked.min() if kind == "min" else masked.max()
        else:
            raise ValueError(f"unknown reduce kind {kind}")
        outs.append(ColVal(c.dtype, out.reshape(1), (count > 0).reshape(1)))
    return outs
