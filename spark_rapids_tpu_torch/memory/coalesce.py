"""Batch coalescing: the coalesce goals and the concatenating iterator.

Counterpart of ``spark_rapids_tpu/memory/coalesce.py``
(GpuCoalesceBatches.scala: CoalesceGoal, TargetSize, RequireSingleBatch):
accumulate small batches until a goal is met, concatenating on the device.
Pending batches are registered in the spill catalog, so a long
accumulation (a join's build side under ``RequireSingleBatch``) can move
to the host or disk while it waits; they come back for the concatenation,
which runs under ``memory/retry.with_retry_no_split``.
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


class RequireSingleBatch(CoalesceGoal):
    """Every input batch in one output batch."""

    def __repr__(self) -> str:
        return "RequireSingleBatch()"


def coalesce_iterator(batches: Iterator[ColumnarBatch], goal: CoalesceGoal,
                      catalog=None) -> Iterator[ColumnarBatch]:
    """Concatenate consecutive batches up to ``goal``: a TargetSize emits
    a batch before the next input would take it past the goal's bytes; a
    TargetRows emits one as soon as it holds at least the goal's rows
    (each batch's row count is fetched); RequireSingleBatch emits one
    batch at the end.  Only batches known to be empty are dropped; under
    a byte goal a count still on the device is never fetched here.  Each
    pending batch is registered in ``catalog`` (the session's by default)
    until it is emitted, and closed if the generator is closed early."""
    from spark_rapids_tpu_torch.memory.retry import with_retry_no_split
    from spark_rapids_tpu_torch.memory.spill import (
        AGGREGATE_INTERMEDIATE_PRIORITY, default_catalog)
    from spark_rapids_tpu_torch.ops.concat import concat_batches
    catalog = catalog or default_catalog()
    pending, pending_bytes, rows = [], 0, 0

    def concat():
        got = [h.materialize() for h in pending]
        return concat_batches(got) if len(got) > 1 else got[0]

    def flush():
        # the restore and the concatenation are the peak allocation: a
        # device OOM spills and retries them, the pending batches still
        # registered
        nonlocal pending, pending_bytes, rows
        out = with_retry_no_split(concat, catalog=catalog)
        for h in pending:
            h.close()
        pending, pending_bytes, rows = [], 0, 0
        return out

    try:
        for batch in batches:
            if batch.row_count.is_concrete and batch.nrows == 0:
                continue
            if isinstance(goal, TargetSize):
                size = batch.device_size_bytes()
                if pending and pending_bytes + size > goal.bytes:
                    yield flush()
                pending_bytes += size
            pending.append(catalog.register(
                batch, AGGREGATE_INTERMEDIATE_PRIORITY))
            if isinstance(goal, TargetRows):
                rows += batch.nrows
                if rows >= goal.rows:
                    yield flush()
        if pending:
            yield flush()
    finally:
        # an early close (LIMIT, a consumer's error) leaves no pending
        # registration behind
        for h in pending:
            h.close()
