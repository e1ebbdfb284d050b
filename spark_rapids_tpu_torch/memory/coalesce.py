"""Batch coalescing: the coalesce goals and the concatenating iterator.

Counterpart of ``spark_rapids_tpu/memory/coalesce.py``: accumulate small
batches until a size goal is met, concatenating on the device.  The JAX
package registers pending batches in its spill catalog; the port has no
spill catalog yet, so pending batches stay on the device until the goal
is met.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch


class CoalesceGoal:
    pass


@dataclasses.dataclass(frozen=True)
class TargetSize(CoalesceGoal):
    bytes: int = 1 << 31


@dataclasses.dataclass(frozen=True)
class TargetRows(CoalesceGoal):
    rows: int


def coalesce_iterator(batches: Iterator[ColumnarBatch],
                      goal: CoalesceGoal) -> Iterator[ColumnarBatch]:
    """Concatenate consecutive batches up to ``goal``: a TargetSize emits
    a batch before the next input would take it past the goal's bytes; a
    TargetRows emits one as soon as it holds at least the goal's rows
    (each batch's row count is fetched).  Only batches known to be empty
    are dropped; under a TargetSize a count still on the device is never
    fetched here."""
    from spark_rapids_tpu_torch.ops.concat import concat_batches
    pending, pending_bytes, rows = [], 0, 0
    for batch in batches:
        if batch.row_count.is_concrete and batch.nrows == 0:
            continue
        if isinstance(goal, TargetSize):
            size = batch.device_size_bytes()
            if pending and pending_bytes + size > goal.bytes:
                yield concat_batches(pending)
                pending, pending_bytes = [], 0
            pending.append(batch)
            pending_bytes += size
            continue
        pending.append(batch)
        rows += batch.nrows
        if rows >= goal.rows:
            yield concat_batches(pending)
            pending, rows = [], 0
    if pending:
        yield concat_batches(pending)
