"""Generate (explode / posexplode) physical operator.

Counterpart of ``spark_rapids_tpu/exec/generate.py`` (the reference's
``GpuGenerateExec``).  The flat element buffer of the exploded array
already is the output's column: one ``searchsorted`` over the offsets
maps every element to its source row, the pass-through columns gather by
that map (string and array columns rebuild their offsets in
``selection.gather``), and the position is the element's index minus its
row's first offset.  An exploded map (``generator2``, the value array
with the key array's offsets) gives ``key`` and ``value`` columns.  Each
batch fetches its element count in one counted sync.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import torch

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import Column
from spark_rapids_tpu_torch.exec.base import (
    NUM_INPUT_BATCHES, NUM_INPUT_ROWS, Schema, TpuExec)
from spark_rapids_tpu_torch.memory.retry import with_retry
from spark_rapids_tpu_torch.ops import selection
from spark_rapids_tpu_torch.ops.compiler import StageFn
from spark_rapids_tpu_torch.ops.expressions import ColVal, Expression
from spark_rapids_tpu_torch.utils import hostsync


def generate_schema(generator: Expression, required: Sequence[Expression],
                    position: bool, col_name: str, pos_name: str,
                    generator2: Optional[Expression]) -> Schema:
    """The output columns of an explode: the pass-through columns, then
    the position, then the element (or a map's key and value)."""
    out = [(e.name, e.dtype) for e in required]
    if position:
        out.append((pos_name, dts.INT32))
    if generator2 is not None:
        out.append(("key", generator.dtype.element))
        out.append(("value", generator2.dtype.element))
    else:
        out.append((col_name, generator.dtype.element))
    return out


class TpuGenerateExec(TpuExec):
    def __init__(self, generator: Expression, required: Sequence[Expression],
                 position: bool, child: TpuExec, col_name: str = "col",
                 pos_name: str = "pos",
                 generator2: Optional[Expression] = None):
        super().__init__(child)
        self.generator = generator
        self.generator2 = generator2
        self.required = list(required)
        self.position = position
        self.col_name = col_name
        self.pos_name = pos_name
        gens = [generator] + ([generator2] if generator2 is not None
                              else [])
        self._n_gens = len(gens)
        self._eval_fn = StageFn(gens + self.required,
                                [dt for _, dt in child.schema])
        self._register_metric(NUM_INPUT_ROWS)
        self._register_metric(NUM_INPUT_BATCHES)

    @property
    def child(self) -> TpuExec:
        return self.children[0]

    @property
    def schema(self) -> Schema:
        return generate_schema(self.generator, self.required, self.position,
                               self.col_name, self.pos_name,
                               self.generator2)

    def describe(self):
        kind = "posexplode" if self.position else "explode"
        return f"TpuGenerateExec[{kind}({self.generator.name})]"

    def _explode(self, batch: ColumnarBatch) -> ColumnarBatch:
        cols = self._eval_fn(batch)
        arr, req = cols[0], cols[self._n_gens:]
        rc = batch.row_count
        device = arr.data.device
        n = rc.device_tensor(device)
        total = int(hostsync.fetch(arr.offsets[n]))
        pos = torch.arange(total, device=device, dtype=torch.int32)
        row = torch.searchsorted(arr.offsets, pos, right=True) - 1
        gathered = selection.gather(
            [ColVal(c.dtype, c.data, c.validity, c.offsets) for c in req],
            row)
        out = {e.name: Column(g.dtype, g.values, total, validity=g.validity,
                              offsets=g.offsets)
               for e, g in zip(self.required, gathered)}
        if self.position:
            out[self.pos_name] = Column(dts.INT32,
                                        pos - arr.offsets[row], total)
        element = self.generator.dtype.element
        if self._n_gens == 2:
            out["key"] = Column(element, arr.data[:total], total)
            out["value"] = Column(self.generator2.dtype.element,
                                  cols[1].data[:total], total)
        else:
            out[self.col_name] = Column(element, arr.data[:total], total)
        return ColumnarBatch(out, total)

    def _tallied(self) -> Iterator[ColumnarBatch]:
        for batch in self.child.execute():
            self.metrics[NUM_INPUT_ROWS] += batch.row_count
            self.metrics[NUM_INPUT_BATCHES] += 1
            yield batch

    def do_execute(self) -> Iterator[ColumnarBatch]:
        for out in with_retry(self._tallied(), self._explode,
                              catalog=self.spill_catalog()):
            if out.nrows:
                yield out
