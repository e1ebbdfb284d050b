"""Device-side batch concatenation.

Counterpart of ``spark_rapids_tpu/ops/concat.py``: same-schema batches
append on the device, with no host round trip for the data.  Deferred row
counts resolve in one counted fetch (exact-length outputs need them).
"""

from __future__ import annotations

from typing import Sequence

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import Column, RowCount


def concat_batches(batches: Sequence[ColumnarBatch]) -> ColumnarBatch:
    """Concatenate same-schema batches into one exact-length batch."""
    batches = [b for b in batches
               if not (b.row_count.is_concrete and b.nrows == 0)] \
        or list(batches[:1])
    if len(batches) == 1:
        return batches[0]
    RowCount.materialize_all([b.row_count for b in batches])
    total = sum(b.nrows for b in batches)
    out_cols = {}
    for name in batches[0].names:
        cols = [b.column(name) for b in batches]
        data = torch.cat([c.data[: b.nrows] for c, b in zip(cols, batches)])
        validity = None
        if any(c.validity is not None for c in cols):
            validity = torch.cat([
                c.validity[: b.nrows] if c.validity is not None else
                torch.ones(b.nrows, dtype=torch.bool, device=c.device)
                for c, b in zip(cols, batches)])
        out_cols[name] = Column(cols[0].dtype, data, total,
                                validity=validity)
    return ColumnarBatch(out_cols, total)
