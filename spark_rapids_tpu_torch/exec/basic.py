"""Basic physical operators: scan, range, union, project, filter,
coalesce, limit.

Counterpart of ``spark_rapids_tpu/exec/basic.py``.  Project and filter
each own a stage function (``ops/compiler.py``) that evaluates their whole
expression forest per batch.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import torch

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import Column
from spark_rapids_tpu_torch.exec.base import (
    NUM_INPUT_BATCHES, NUM_INPUT_ROWS, Schema, TpuExec)
from spark_rapids_tpu_torch.ops.compiler import FilterStageFn, StageFn
from spark_rapids_tpu_torch.ops.expressions import BoundReference, Expression

RANGE_BATCH_ROWS = 1 << 20


class TpuCoalesceBatchesExec(TpuExec):
    """Accumulate undersized upstream batches until they hold at least
    ``goal_rows`` rows, then emit them as one batch."""

    def __init__(self, child: TpuExec, goal_rows: int):
        super().__init__(child)
        self.goal_rows = int(goal_rows)

    @property
    def child(self) -> TpuExec:
        return self.children[0]

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def describe(self):
        return f"TpuCoalesceBatchesExec[{self.goal_rows} rows]"

    def do_execute(self) -> Iterator[ColumnarBatch]:
        from spark_rapids_tpu_torch.ops.concat import concat_batches
        pending, rows = [], 0
        for batch in self.child.execute():
            pending.append(batch)
            rows += batch.nrows
            if rows >= self.goal_rows:
                yield concat_batches(pending)
                pending, rows = [], 0
        if pending:
            yield concat_batches(pending)


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
            starts = list(range(0, n, self.max_rows))
            bounds = _string_bounds(b, starts + [n])
            for i, off in enumerate(starts):
                m = min(self.max_rows, n - off)
                cols = {name: _slice(c, off, m, bounds.get(name), i)
                        for name, c in b.columns.items()}
                yield ColumnarBatch(cols, m)

    def describe(self):
        rows = sum(b.nrows for b in self.batches)
        return f"TpuScanExec[{rows} rows, {self.max_rows} per batch]"


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
        for batch in self.child.execute():
            yield ColumnarBatch(dict(zip(names, self._fn(batch))),
                                batch.row_count)

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

    def do_execute(self) -> Iterator[ColumnarBatch]:
        names = [n for n, _ in self.schema]
        for batch in self.child.execute():
            self.metrics[NUM_INPUT_ROWS] += batch.row_count
            self.metrics[NUM_INPUT_BATCHES] += 1
            cols, n = self._fn(batch)
            if n:
                yield ColumnarBatch(dict(zip(names, cols)), n)

    def describe(self):
        return f"TpuFilterExec[{self.condition}]"
