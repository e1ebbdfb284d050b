"""Row selection: permutation gather and mask compaction.

Counterpart of ``spark_rapids_tpu/ops/selection.py`` for fixed-width
columns.  ``compact`` keeps the JAX package's sort-free formulation (a
prefix sum gives each kept row its target, one scatter builds the
permutation), so the only host wait is the one counted fetch of the kept
row count that sizes the exact-length output.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.ops.expressions import ColVal


def gather(cols: Sequence[ColVal], indices: torch.Tensor) -> List[ColVal]:
    """Rows of every column at ``indices`` (int64, in range)."""
    return [ColVal(c.dtype, c.values[indices],
                   None if c.validity is None else c.validity[indices])
            for c in cols]


def compact(cols: Sequence[ColVal], keep: torch.Tensor
            ) -> Tuple[List[ColVal], int]:
    """Move rows where ``keep`` is True to the front, preserving order,
    and cut the columns to the kept count.  ``keep`` must already exclude
    padding rows.  Returns (columns, kept row count)."""
    from spark_rapids_tpu_torch.utils import hostsync
    capacity = keep.shape[0]
    pos = torch.cumsum(keep, 0) - 1
    new_nrows = keep.sum()
    tgt = torch.where(keep, pos, capacity)  # dropped rows scatter to trash
    perm = torch.zeros(capacity + 1, dtype=torch.int64, device=keep.device)
    perm.scatter_(0, tgt, torch.arange(capacity, device=keep.device))
    n = int(hostsync.fetch(new_nrows))
    return gather(cols, perm[:n]), n
