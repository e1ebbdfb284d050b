"""Basic physical operators: scan, project, filter, coalesce.

Counterpart of ``spark_rapids_tpu/exec/basic.py``.  Project and filter
each own a stage function (``ops/compiler.py``) that evaluates their whole
expression forest per batch.
"""

from __future__ import annotations

from typing import Iterator, Sequence

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import Column
from spark_rapids_tpu_torch.exec.base import (
    NUM_INPUT_BATCHES, NUM_INPUT_ROWS, Schema, TpuExec)
from spark_rapids_tpu_torch.ops.compiler import FilterStageFn, StageFn
from spark_rapids_tpu_torch.ops.expressions import BoundReference, Expression


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
            for off in range(0, n, self.max_rows):
                m = min(self.max_rows, n - off)
                cols = {name: Column(
                    c.dtype, c.data[off:off + m], m,
                    None if c.validity is None
                    else c.validity[off:off + m])
                    for name, c in b.columns.items()}
                yield ColumnarBatch(cols, m)

    def describe(self):
        rows = sum(b.nrows for b in self.batches)
        return f"TpuScanExec[{rows} rows, {self.max_rows} per batch]"


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
