"""Basic physical operators: scan, range, union, project, filter,
coalesce, limit.

Counterpart of ``spark_rapids_tpu/exec/basic.py``.  Project and filter
each own a stage function (``ops/compiler.py``) that evaluates their whole
expression forest per batch, under ``memory/retry.with_retry``: a device
OOM spills the catalog and retries, then splits the batch in half.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import torch

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import Column
from spark_rapids_tpu_torch.exec.base import (
    NUM_INPUT_BATCHES, NUM_INPUT_ROWS, Schema, TpuExec)
from spark_rapids_tpu_torch.memory.coalesce import (
    CoalesceGoal, TargetRows, coalesce_iterator)
from spark_rapids_tpu_torch.memory.retry import with_retry
from spark_rapids_tpu_torch.ops.compiler import FilterStageFn, StageFn
from spark_rapids_tpu_torch.ops.expressions import BoundReference, Expression

RANGE_BATCH_ROWS = 1 << 20


class TpuCoalesceBatchesExec(TpuExec):
    """Accumulate undersized upstream batches and emit them concatenated,
    up to a ``memory/coalesce.py`` goal: ``goal_rows=n`` is
    ``goal=TargetRows(n)``."""

    def __init__(self, child: TpuExec, goal_rows: int = 0,
                 goal: Optional[CoalesceGoal] = None):
        super().__init__(child)
        if (goal is None) == (goal_rows <= 0):
            raise ValueError("give exactly one of goal_rows and goal")
        self.goal = goal if goal is not None else TargetRows(int(goal_rows))

    @property
    def child(self) -> TpuExec:
        return self.children[0]

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def describe(self):
        return f"TpuCoalesceBatchesExec[{self.goal}]"

    def do_execute(self) -> Iterator[ColumnarBatch]:
        yield from coalesce_iterator(self.child.execute(), self.goal,
                                     catalog=self.spill_catalog())


class TpuScanExec(TpuExec):
    """In-memory relation scan: cuts each batch into batches of at most
    ``max_rows`` rows (slices are views, no copy)."""

    def __init__(self, batches: Sequence[ColumnarBatch], schema: Schema,
                 max_rows: int):
        super().__init__()
        self.batches = list(batches)
        self._schema = list(schema)
        self.max_rows = int(max_rows)

    @property
    def schema(self) -> Schema:
        return self._schema

    def do_execute(self) -> Iterator[ColumnarBatch]:
        for b in self.batches:
            n = b.nrows
            if n <= self.max_rows:
                yield b
                continue
            yield from slice_batch(b, list(range(0, n, self.max_rows)) + [n])

    def describe(self):
        rows = sum(b.nrows for b in self.batches)
        return f"TpuScanExec[{rows} rows, {self.max_rows} per batch]"


def slice_batch(batch: ColumnarBatch, row_bounds) -> list:
    """The rows between consecutive ``row_bounds`` of a batch, as batches
    of views (a string slice's offsets rebased to its chars: one counted
    fetch for every string column)."""
    bounds = _string_bounds(batch, row_bounds)
    out = []
    for i in range(len(row_bounds) - 1):
        off, m = row_bounds[i], row_bounds[i + 1] - row_bounds[i]
        cols = {name: _slice(c, off, m, bounds.get(name), i)
                for name, c in batch.columns.items()}
        out.append(ColumnarBatch(cols, m))
    return out


def _string_bounds(batch: ColumnarBatch, row_bounds):
    """Per string column, its char offsets at ``row_bounds`` (host ints,
    one counted fetch for all columns), so slices rebase to 0."""
    names = [n for n, c in batch.columns.items() if c.offsets is not None]
    if not names:
        return {}
    from spark_rapids_tpu_torch.utils import hostsync
    idx = torch.tensor(row_bounds, device=batch.device)
    got = hostsync.fetch_all([batch.column(n).offsets[idx] for n in names])
    return {n: [int(x) for x in g] for n, g in zip(names, got)}


def _slice(c: Column, off: int, m: int, char_bounds, i: int) -> Column:
    """Rows [off, off + m) of a column (views, no copy, except a string
    slice's rebased offsets)."""
    validity = None if c.validity is None else c.validity[off:off + m]
    if c.offsets is None:
        return Column(c.dtype, c.data[off:off + m], m, validity)
    c0, c1 = char_bounds[i], char_bounds[i + 1]
    return Column(c.dtype, c.data[c0:c1], m, validity,
                  offsets=c.offsets[off:off + m + 1] - c0)


class TpuRangeExec(TpuExec):
    """``range(start, end, step)`` as a bigint ``id`` column, made on the
    device in batches of at most ``RANGE_BATCH_ROWS`` rows."""

    def __init__(self, start: int, end: int, step: int, device):
        super().__init__()
        self.start, self.end, self.step = start, end, step
        self.device = device

    @property
    def schema(self) -> Schema:
        return [("id", dts.INT64)]

    def do_execute(self) -> Iterator[ColumnarBatch]:
        total = max(0, -(-(self.end - self.start) // self.step))
        for off in range(0, total, RANGE_BATCH_ROWS):
            n = min(RANGE_BATCH_ROWS, total - off)
            vals = self.start + (off + torch.arange(
                n, dtype=torch.int64, device=self.device)) * self.step
            yield ColumnarBatch({"id": Column(dts.INT64, vals, n)}, n)

    def describe(self):
        return f"TpuRangeExec[{self.start}, {self.end}, {self.step}]"


class TpuUnionExec(TpuExec):
    """UNION ALL: each child's batches in turn, renamed to the first
    child's column names."""

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def do_execute(self) -> Iterator[ColumnarBatch]:
        names = [n for n, _ in self.schema]
        for child in self.children:
            for batch in child.execute():
                yield ColumnarBatch(
                    dict(zip(names, batch.columns.values())),
                    batch.row_count)


class TpuLocalLimitExec(TpuExec):
    """The first ``n`` rows of the child's output, in order."""

    def __init__(self, n: int, child: TpuExec):
        super().__init__(child)
        self.n = n

    @property
    def child(self) -> TpuExec:
        return self.children[0]

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def do_execute(self) -> Iterator[ColumnarBatch]:
        remaining = self.n
        for batch in self.child.execute():
            if remaining <= 0:
                return
            if batch.nrows <= remaining:
                remaining -= batch.nrows
                yield batch
                continue
            cols = {name: Column(c.dtype, c.data, remaining, c.validity,
                                 c.offsets)
                    for name, c in batch.columns.items()}
            yield ColumnarBatch(cols, remaining)
            return

    def describe(self):
        return f"TpuLocalLimitExec[{self.n}]"


class TpuProjectExec(TpuExec):
    def __init__(self, exprs: Sequence[Expression], child: TpuExec):
        super().__init__(child)
        self.exprs = list(exprs)
        self._fn = StageFn(self.exprs, [dt for _, dt in child.schema])

    @property
    def child(self) -> TpuExec:
        return self.children[0]

    @property
    def schema(self) -> Schema:
        return [(e.name, e.dtype) for e in self.exprs]

    def do_execute(self) -> Iterator[ColumnarBatch]:
        names = [e.name for e in self.exprs]
        yield from with_retry(
            self.child.execute(),
            lambda batch: ColumnarBatch(dict(zip(names, self._fn(batch))),
                                        batch.row_count),
            catalog=self.spill_catalog())

    def describe(self):
        return f"TpuProjectExec[{', '.join(e.name for e in self.exprs)}]"


class TpuFilterExec(TpuExec):
    """Predicate + compaction; empty results are dropped."""

    def __init__(self, condition: Expression, child: TpuExec):
        super().__init__(child)
        self.condition = condition
        in_schema = child.schema
        passthrough = [BoundReference(i, dt, name=n)
                       for i, (n, dt) in enumerate(in_schema)]
        self._fn = FilterStageFn(condition, passthrough,
                                 [dt for _, dt in in_schema])
        self._register_metric(NUM_INPUT_ROWS)
        self._register_metric(NUM_INPUT_BATCHES)

    @property
    def child(self) -> TpuExec:
        return self.children[0]

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def _tallied(self):
        for batch in self.child.execute():
            self.metrics[NUM_INPUT_ROWS] += batch.row_count
            self.metrics[NUM_INPUT_BATCHES] += 1
            yield batch

    def do_execute(self) -> Iterator[ColumnarBatch]:
        names = [n for n, _ in self.schema]
        for cols, n in with_retry(self._tallied(), self._fn,
                                  catalog=self.spill_catalog()):
            if n:
                yield ColumnarBatch(dict(zip(names, cols)), n)

    def describe(self):
        return f"TpuFilterExec[{self.condition}]"
