"""Device-side batch concatenation.

Counterpart of ``spark_rapids_tpu/ops/concat.py``: same-schema batches
append on the device, with no host round trip for the data.  Deferred row
counts, and the chars each string column holds, resolve in one counted
fetch (exact-length outputs need them).
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
    string_names = [n for n, c in batches[0].columns.items()
                    if c.offsets is not None]
    char_ends = {}
    if string_names:
        from spark_rapids_tpu_torch.utils import hostsync
        ends = hostsync.fetch_all([b.column(n).offsets[b.nrows]
                                   for n in string_names for b in batches])
        it = iter(int(e) for e in ends)
        char_ends = {n: [next(it) for _ in batches] for n in string_names}
    out_cols = {}
    for name in batches[0].names:
        cols = [b.column(name) for b in batches]
        validity = None
        if any(c.validity is not None for c in cols):
            validity = torch.cat([
                c.validity[: b.nrows] if c.validity is not None else
                torch.ones(b.nrows, dtype=torch.bool, device=c.device)
                for c, b in zip(cols, batches)])
        offsets = None
        if name in char_ends:
            ends = char_ends[name]
            data = torch.cat([c.data[:e] for c, e in zip(cols, ends)])
            parts, base = [], 0
            for c, b, e in zip(cols, batches, ends):
                parts.append(c.offsets[: b.nrows] + base)
                base += e
            if base >= (1 << 31):
                raise ValueError(f"column {name!r}: {base} chars do not "
                                 "fit int32 offsets")
            parts.append(torch.tensor([base], dtype=torch.int32,
                                      device=data.device))
            offsets = torch.cat(parts)
        else:
            data = torch.cat([c.data[: b.nrows]
                              for c, b in zip(cols, batches)])
        out_cols[name] = Column(cols[0].dtype, data, total,
                                validity=validity, offsets=offsets)
    return ColumnarBatch(out_cols, total)
