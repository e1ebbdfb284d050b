"""Window functions over sorted segments.

Counterpart of ``spark_rapids_tpu/ops/window.py``: one sort by (partition
keys, order keys), then every window function is segment arithmetic on
the sorted arrays:

* ranking (row_number / rank / dense_rank / percent_rank) from positions
  and order-key run boundaries;
* ROWS-frame and running RANGE-frame sums, counts and averages from
  prefix sums differenced at the clamped frame edges;
* running min/max from a segmented scan;
* whole-partition aggregates from segment reductions gathered back;
* lead/lag from shifted gathers with segment-bound nulling.

The JAX package finds each row's partition and run bounds with
associative max/min scans.  Torch has no segmented scan, and a full-length
``cummax`` is slow on the card, so here a bound is a table lookup: the
boundary rows scatter their positions to their segment (or run) number,
and every row reads its own segment's start and the next segment's
start.  The live rows form a prefix of the sorted arrays (the sort puts
dead rows last), so the last segment ends at the last live row.

Float prefix sums and the running min/max take the blocked segmented scan
of ``ops/aggregates`` (restarting at each partition, in an order fixed by
the input alone), so repeated runs on the card give the same bits;
``torch.cumsum`` of floats on CUDA does not promise that.  Integer prefix
sums are exact in any order and take ``torch.cumsum``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.ops.aggregates import (
    _minmax_view, _segmented_scan, _sentinel, fixed_order_sums)
from spark_rapids_tpu_torch.ops.expressions import ColVal


def _starts_table(boundary: torch.Tensor, ids: torch.Tensor, nrows: int,
                  capacity: int) -> torch.Tensor:
    """int64[capacity + 2]: the sorted position where segment ``k``
    starts, ``nrows`` past the last one (and for the dead rows' id
    ``capacity``)."""
    table = torch.full((capacity + 2,), nrows, dtype=torch.int64,
                       device=boundary.device)
    pos = torch.arange(capacity, device=boundary.device)
    # boundary rows write their position; the others write into the
    # trash entry past the end
    table.scatter_(0, torch.where(boundary, ids, capacity + 1), pos)
    table[capacity:] = nrows
    return table


class SortedPartitions:
    """Segment structure of the sorted rows, shared by every function.

    ``seg_id``    int64[cap]  partition number per sorted row (``cap`` for
                              dead rows)
    ``seg_start`` int64[cap]  position of this row's partition start
    ``seg_end``   int64[cap]  inclusive end of this row's partition
    ``pos``       int64[cap]
    ``live``      bool[cap]
    ``run_start`` int64[cap]  start of this row's order-key run
    ``run_end``   int64[cap]  inclusive end of the order-key run
    ``run_id_in_seg`` int64[cap] dense run index within the partition
    """

    def __init__(self, seg_boundary, run_boundary, nrows: int,
                 capacity: int):
        device = seg_boundary.device
        pos = torch.arange(capacity, device=device)
        live = pos < nrows
        self.pos = pos
        self.live = live
        self.capacity = capacity
        seg_id = torch.cumsum(seg_boundary.to(torch.int64), 0) - 1
        self.seg_id = torch.where(live, seg_id,
                                  torch.full_like(seg_id, capacity))
        starts = _starts_table(seg_boundary, self.seg_id, nrows, capacity)
        self.seg_start = starts[self.seg_id]
        self.seg_end = starts[self.seg_id + 1] - 1
        rb = run_boundary | seg_boundary
        run_counter = torch.cumsum(rb.to(torch.int64), 0) - 1
        run_id = torch.where(live, run_counter,
                             torch.full_like(run_counter, capacity))
        rstarts = _starts_table(rb, run_id, nrows, capacity)
        self.run_start = rstarts[run_id]
        self.run_end = rstarts[run_id + 1] - 1
        safe_start = self.seg_start.clamp(0, max(capacity - 1, 0))
        self.run_id_in_seg = run_counter - run_counter[safe_start] \
            if capacity else run_counter


def row_number(sp: SortedPartitions) -> ColVal:
    return ColVal(dts.INT32, (sp.pos - sp.seg_start + 1).to(torch.int32))


def rank(sp: SortedPartitions) -> ColVal:
    return ColVal(dts.INT32,
                  (sp.run_start - sp.seg_start + 1).to(torch.int32))


def dense_rank(sp: SortedPartitions) -> ColVal:
    return ColVal(dts.INT32, (sp.run_id_in_seg + 1).to(torch.int32))


def percent_rank(sp: SortedPartitions) -> ColVal:
    n = (sp.seg_end - sp.seg_start).to(torch.float64)
    r = (sp.run_start - sp.seg_start).to(torch.float64)
    return ColVal(dts.FLOAT64, torch.where(
        n > 0, r / torch.clamp(n, min=1), torch.zeros_like(n)))


def lead_lag(sp: SortedPartitions, c: ColVal, offset: int,
             default: Optional[ColVal] = None) -> ColVal:
    """lead(+offset) / lag(-offset) within the partition."""
    from spark_rapids_tpu_torch.ops import selection
    capacity = sp.capacity
    tgt = sp.pos + offset
    in_seg = (tgt >= sp.seg_start) & (tgt <= sp.seg_end)
    safe = tgt.clamp(0, max(capacity - 1, 0))
    got = selection.gather([c], safe)[0]
    values, validity = got.values, got.validity
    if c.offsets is not None:
        if default is not None:
            raise NotImplementedError(
                "lead/lag of a string column with a default value is not "
                "ported")
        base = validity if validity is not None else \
            torch.ones(capacity, dtype=torch.bool, device=tgt.device)
        return ColVal(c.dtype, values, base & in_seg, got.offsets)
    if default is not None:
        dvals = default.values.to(values.dtype).expand(values.shape)
        values = torch.where(in_seg, values, dvals)
        if default.validity is not None or validity is not None:
            dv = default.validity if default.validity is not None else \
                torch.ones((), dtype=torch.bool, device=tgt.device)
            sv = validity if validity is not None else \
                torch.ones(capacity, dtype=torch.bool, device=tgt.device)
            validity = torch.where(in_seg, sv, dv.expand(capacity))
    else:
        base = validity if validity is not None else \
            torch.ones(capacity, dtype=torch.bool, device=tgt.device)
        validity = base & in_seg
    return ColVal(c.dtype, values, validity)


# ------------------------------------------------------------- frame helpers

UNBOUNDED = None


def _frame_edges(sp: SortedPartitions, lo, hi, rows: bool):
    """Inclusive [lo_idx, hi_idx] per sorted row for a ROWS frame, or the
    running-with-ties RANGE frame when rows=False (lo=None, hi=0)."""
    if rows:
        lo_idx = sp.seg_start if lo is UNBOUNDED else \
            torch.maximum(sp.seg_start, sp.pos + lo)
        hi_idx = sp.seg_end if hi is UNBOUNDED else \
            torch.minimum(sp.seg_end, sp.pos + hi)
    else:
        lo_idx = sp.seg_start if lo is UNBOUNDED else sp.run_start
        hi_idx = sp.seg_end if hi is UNBOUNDED else sp.run_end
    return lo_idx, hi_idx


def _segment_prefix(sp: SortedPartitions, vals: torch.Tensor
                    ) -> torch.Tensor:
    """Inclusive prefix sums restarting at each partition: floats in a
    fixed order (the blocked segmented scan), integers by ``cumsum``
    less the sum before the partition."""
    if vals.dtype.is_floating_point:
        return _segmented_scan(sp.seg_id, vals)
    full = torch.cumsum(vals, 0)
    before = torch.where(sp.seg_start > 0,
                         full[(sp.seg_start - 1).clamp(min=0)],
                         torch.zeros_like(full))
    return full - before


def frame_sum(sp: SortedPartitions, c: ColVal, lo, hi, rows: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum, non-null count) of ``c`` over each row's frame: prefix sums
    within the partition, differenced at the clamped frame edges."""
    capacity = sp.capacity
    valid = sp.live if c.validity is None else sp.live & c.validity
    vals = torch.where(valid, c.values, torch.zeros_like(c.values))
    prefix = _segment_prefix(sp, vals)
    cprefix = _segment_prefix(sp, valid.to(torch.int64))
    lo_idx, hi_idx = _frame_edges(sp, lo, hi, rows)
    empty = lo_idx > hi_idx
    top = max(capacity - 1, 0)
    hi_safe = hi_idx.clamp(0, top)
    below_idx = (lo_idx - 1).clamp(0, top)
    # the frame starts at its partition's start: nothing to subtract
    inner = lo_idx > sp.seg_start

    def window(p):
        below = torch.where(inner, p[below_idx], torch.zeros_like(p))
        return torch.where(empty, torch.zeros_like(p), p[hi_safe] - below)
    return window(prefix), window(cprefix)


def running_minmax(sp: SortedPartitions, c: ColVal, kind: str
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(value, non-null count) of min/max over unbounded-preceding
    frames: a segmented scan restarting at each partition."""
    valid = sp.live if c.validity is None else sp.live & c.validity
    w = _minmax_view(c.values)
    sent = _sentinel(kind, c.values.dtype)
    vals = torch.where(valid, w, torch.full_like(w, sent))
    op = torch.minimum if kind == "min" else torch.maximum
    out = _segmented_scan(sp.seg_id, vals, op, sent)
    counts = _segment_prefix(sp, valid.to(torch.int64))
    return out.to(c.values.dtype), counts


def partition_reduce(sp: SortedPartitions, c: ColVal, kind: str
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(value, count) of a whole-partition aggregate, broadcast to its
    rows."""
    capacity = sp.capacity
    valid = sp.live if c.validity is None else sp.live & c.validity
    seg = sp.seg_id
    counts = torch.zeros(capacity + 1, dtype=torch.int64,
                         device=seg.device).index_add_(
        0, seg, valid.to(torch.int64))
    if kind == "sum":
        vals = torch.where(valid, c.values, torch.zeros_like(c.values))
        red = fixed_order_sums(seg, vals, capacity + 1)
    else:
        w = _minmax_view(c.values)
        s = _sentinel(kind, c.values.dtype)
        vals = torch.where(valid, w, torch.full_like(w, s))
        red = torch.full((capacity + 1,), s, dtype=w.dtype,
                         device=seg.device)
        red.scatter_reduce_(0, seg, vals,
                            "amin" if kind == "min" else "amax")
        red = red.to(c.values.dtype)
    safe_seg = seg.clamp(0, max(capacity - 1, 0))
    return red[safe_seg], counts[safe_seg]
