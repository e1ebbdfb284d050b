"""TpuExec: base class of the columnar physical operators, with metrics.

Counterpart of ``spark_rapids_tpu/exec/base.py``.  Operators produce an
iterator of device-resident ColumnarBatches; crossing to the host happens
only at collect.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, List, Tuple

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.dtypes import DataType

Schema = List[Tuple[str, DataType]]

NUM_OUTPUT_ROWS = "numOutputRows"
NUM_OUTPUT_BATCHES = "numOutputBatches"
OP_TIME = "opTime"
NUM_INPUT_ROWS = "numInputRows"
NUM_INPUT_BATCHES = "numInputBatches"
AGG_TIME = "computeAggTime"
CONCAT_TIME = "concatTime"
SORT_TIME = "sortTime"
JOIN_TIME = "joinTime"
# file scans (io/readers.py): host ns waiting for decoded tables, host ns
# of their uploads, bytes arrow decoded
DECODE_TIME = "decodeTime"
UPLOAD_TIME = "uploadTime"
BYTES_DECODED = "bytesDecoded"
# the pipeline (exec/pipeline.py)
PIPELINE_FILL_RATIO = "pipelineFillRatio"
HOST_SYNC_COUNT = "hostSyncCount"
UPLOAD_OVERLAP_MS = "uploadOverlapMs"


class TpuMetric:
    """One counter.  Accepts lazy ``RowCount`` additions: device-resident
    counts accumulate unresolved and resolve in one counted fetch when
    ``value`` is first read, so row tallies never force a per-batch
    sync."""

    __slots__ = ("name", "_value", "_pending")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._pending = None

    @property
    def value(self):
        if self._pending:
            from spark_rapids_tpu_torch.columnar.column import RowCount
            RowCount.materialize_all(self._pending)
            self._value += sum(int(rc) for rc in self._pending)
            self._pending = None
        return self._value

    @value.setter
    def value(self, v) -> None:
        self._value = v
        self._pending = None

    def add(self, v) -> None:
        from spark_rapids_tpu_torch.columnar.column import RowCount
        if isinstance(v, RowCount):
            if v.is_concrete:
                self._value += int(v)
            else:
                if self._pending is None:
                    self._pending = []
                self._pending.append(v)
            return
        self._value += v

    def __iadd__(self, v):
        self.add(v)
        return self


class MetricTimer:
    """Adds the host wall time of a ``with`` block, in ns, to a metric.
    Device work is asynchronous, so this is enqueue time unless the block
    ends in a sync."""

    def __init__(self, metric: TpuMetric):
        self.metric = metric

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.metric.add(time.perf_counter_ns() - self._t0)
        return False


class TpuExec:
    """Base physical operator."""

    # the spill catalog the operator's state registers in: the session's,
    # set by the planner (``plan/overrides.TpuOverrides``); an operator
    # built outside a session uses ``memory/spill.default_catalog()``
    catalog = None

    def __init__(self, *children: "TpuExec"):
        self.children: Tuple[TpuExec, ...] = tuple(children)
        self.metrics: Dict[str, TpuMetric] = {}
        for name in (NUM_OUTPUT_ROWS, NUM_OUTPUT_BATCHES, OP_TIME):
            self._register_metric(name)

    def _register_metric(self, name: str) -> TpuMetric:
        return self.metrics.setdefault(name, TpuMetric(name))

    def spill_catalog(self):
        if self.catalog is None:
            from spark_rapids_tpu_torch.memory.spill import default_catalog
            return default_catalog()
        return self.catalog

    def timer(self, name: str) -> MetricTimer:
        return MetricTimer(self.metrics[name])

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    def execute(self) -> Iterator[ColumnarBatch]:
        """Produce batches, updating numOutputRows/Batches and opTime (the
        host time of each pull, child pulls included)."""
        it = self.do_execute()
        timer = self.metrics[OP_TIME]
        while True:
            t0 = time.perf_counter_ns()
            try:
                batch = next(it)
            except StopIteration:
                timer.add(time.perf_counter_ns() - t0)
                return
            timer.add(time.perf_counter_ns() - t0)
            self.metrics[NUM_OUTPUT_ROWS] += batch.row_count
            self.metrics[NUM_OUTPUT_BATCHES] += 1
            yield batch

    def do_execute(self) -> Iterator[ColumnarBatch]:
        raise NotImplementedError

    def node_name(self) -> str:
        return type(self).__name__

    def describe(self) -> str:
        return self.node_name()

    def tree_string(self, depth: int = 0) -> str:
        lines = ["  " * depth + self.describe()]
        for c in self.children:
            lines.append(c.tree_string(depth + 1))
        return "\n".join(lines)
