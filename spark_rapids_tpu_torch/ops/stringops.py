"""String equality over the chars+offsets layout.

Counterpart of the part of ``spark_rapids_tpu/ops/stringops.py`` that a
string-literal filter and a string equality need: ``row_lengths``,
``byte_to_row`` and both forms of ``string_equal`` (a column against a
literal, and column against column).  Ordering comparisons, ``like``,
substrings, case mapping and the other string functions come with a later
slice.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch.ops.expressions import ColVal, EmitContext


def row_lengths(c: ColVal) -> torch.Tensor:
    """Byte length per row."""
    return c.offsets[1:] - c.offsets[:-1]


def byte_to_row(c: ColVal, capacity: int) -> torch.Tensor:
    """Row index (int64) of every byte position in the chars buffer."""
    pos = torch.arange(c.values.shape[0], device=c.values.device)
    row = torch.searchsorted(c.offsets.to(torch.int64), pos, right=True) - 1
    return row.clamp(0, max(capacity - 1, 0))


def string_equal(l: ColVal, r: ColVal, ctx: EmitContext) -> torch.Tensor:
    """Per-row equality of two string values; either may be a literal
    (offsets of length 2).  Returns bool values; nulls are the caller's
    validity."""
    l_scalar = l.offsets.shape[0] == 2 and ctx.capacity != 1
    r_scalar = r.offsets.shape[0] == 2 and ctx.capacity != 1
    if l_scalar and not r_scalar:
        return string_equal(r, l, ctx)
    lens_l = row_lengths(l)
    ccap = l.values.shape[0]
    if r_scalar:
        # compare byte by byte over the literal's (small, host-known)
        # length; rows of another length are already unequal
        rlen = int(r.values.shape[0])
        ok = lens_l == rlen
        if ccap == 0:
            return ok
        starts = l.offsets[:-1].to(torch.int64)
        for i in range(rlen):
            idx = (starts + i).clamp(0, ccap - 1)
            ok = ok & (l.values[idx] == r.values[i])
        return ok
    same_len = lens_l == row_lengths(r)
    if ccap == 0 or r.values.shape[0] == 0:
        return same_len  # no bytes to compare on one side
    row = byte_to_row(l, ctx.capacity)
    pos = torch.arange(ccap, device=l.values.device)
    k = pos - l.offsets.to(torch.int64)[row]
    r_idx = (r.offsets.to(torch.int64)[row] + k).clamp(
        0, r.values.shape[0] - 1)
    total = l.offsets[ctx.capacity].to(torch.int64)
    byte_bad = (l.values != r.values[r_idx]) & (pos < total)
    bad = torch.zeros(ctx.capacity, dtype=torch.int32,
                      device=l.values.device).index_add_(
        0, row, byte_bad.to(torch.int32))
    return same_len & (bad == 0)
