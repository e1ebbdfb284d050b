"""Row selection: permutation gather and mask compaction.

Counterpart of ``spark_rapids_tpu/ops/selection.py``.  ``compact`` keeps
the JAX package's sort-free formulation (a prefix sum gives each kept row
its target, one scatter builds the permutation).  A string gather rebuilds
offsets from the gathered lengths and maps every output byte to its
source byte with one searchsorted, as the JAX package does (an array
column takes the same path, element for byte); its chars buffer is sized
on the host, so the kept row count and the chars it needs come back in
one counted fetch.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.ops.expressions import ColVal
from spark_rapids_tpu_torch.ops.stringops import row_lengths


def gathered_char_count(offsets: torch.Tensor,
                        indices: torch.Tensor) -> torch.Tensor:
    """Total chars (0-dim device int64) a gather of ``indices`` makes."""
    offsets = offsets.to(torch.int64)
    return (offsets[indices + 1] - offsets[indices]).sum()


def _gather_string(c: ColVal, indices: torch.Tensor,
                   char_capacity: int) -> ColVal:
    offsets = c.offsets.to(torch.int64)
    lengths = offsets[indices + 1] - offsets[indices]
    device = c.values.device
    new_offsets = torch.zeros(indices.shape[0] + 1, dtype=torch.int64,
                              device=device)
    torch.cumsum(lengths, 0, out=new_offsets[1:])
    validity = None if c.validity is None else c.validity[indices]
    if char_capacity == 0 or c.values.shape[0] == 0:
        chars = torch.zeros(char_capacity, dtype=c.values.dtype,
                            device=device)
    else:
        pos = torch.arange(char_capacity, device=device)
        # row containing each output byte (last offset <= pos)
        row = torch.searchsorted(new_offsets, pos, right=True) - 1
        row = row.clamp(0, max(indices.shape[0] - 1, 0))
        src = offsets[indices[row]] + (pos - new_offsets[row])
        src = src.clamp(0, c.values.shape[0] - 1)
        chars = torch.where(pos < new_offsets[-1], c.values[src],
                            torch.zeros((), dtype=c.values.dtype,
                                        device=device))
    return ColVal(c.dtype, chars, validity, new_offsets.to(torch.int32))


def gather(cols: Sequence[ColVal], indices: torch.Tensor,
           char_capacity: Optional[int] = None) -> List[ColVal]:
    """Rows of every column at ``indices`` (int64, in range).

    ``char_capacity`` sizes the chars buffer of each gathered string
    column (at least the chars the gather makes; the rest is padding).
    None sizes it exactly, with one counted fetch of every string
    column's total."""
    strings = [c for c in cols if c.offsets is not None]
    if strings and char_capacity is None:
        from spark_rapids_tpu_torch.utils import hostsync
        totals = hostsync.fetch_all(
            [gathered_char_count(c.offsets, indices) for c in strings])
        char_capacity = max(int(t) for t in totals)
    outs = []
    for c in cols:
        if c.offsets is not None:
            outs.append(_gather_string(c, indices, char_capacity))
        else:
            outs.append(ColVal(c.dtype, c.values[indices],
                               None if c.validity is None
                               else c.validity[indices]))
    return outs


def compact_plan(keep: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(permutation whose first ``count`` entries are the rows where
    ``keep`` is True, in order; count as a 0-dim device tensor), with no
    host sync, so a caller can fetch several counts at once."""
    capacity = keep.shape[0]
    pos = torch.cumsum(keep, 0) - 1
    tgt = torch.where(keep, pos, capacity)  # dropped rows scatter to trash
    perm = torch.zeros(capacity + 1, dtype=torch.int64, device=keep.device)
    perm.scatter_(0, tgt, torch.arange(capacity, device=keep.device))
    return perm, keep.sum()


def compact(cols: Sequence[ColVal], keep: torch.Tensor
            ) -> Tuple[List[ColVal], int]:
    """Move rows where ``keep`` is True to the front, preserving order,
    and cut the columns to the kept count.  ``keep`` must already exclude
    padding rows.  Returns (columns, kept row count).  The kept count and
    the chars that kept string rows hold come back in one counted
    fetch."""
    from spark_rapids_tpu_torch.utils import hostsync
    perm, new_nrows = compact_plan(keep)
    chars = [(row_lengths(c) * keep).sum() for c in cols
             if c.offsets is not None]
    n, *totals = hostsync.fetch_all([new_nrows] + chars)
    n = int(n)
    char_capacity = max((int(t) for t in totals), default=None)
    return gather(cols, perm[:n], char_capacity=char_capacity), n

