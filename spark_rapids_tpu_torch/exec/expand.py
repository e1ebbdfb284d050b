"""Expand: one output row per projection list per input row.

Counterpart of ``spark_rapids_tpu/exec/expand.py``, the lowering target of
ROLLUP / CUBE / GROUPING SETS.  Spark plans ``GROUP BY ROLLUP(a, b)`` as::

    Aggregate(keys = [a, b, spark_grouping_id])
      Expand(projections = [[a, b, 0], [a, null, 1], [null, null, 3]])

Each projection of each input batch is emitted as its own output batch,
never over a concatenated input: the hash aggregate above takes many
batches natively, so memory stays one input batch times one projection.
A projection's pass-through columns are the input's own tensors (no
copy); a rolled-up key is a typed null column.

``grouping_id`` bits match Spark: bit i (MSB-first over the grouping
columns) is 1 when grouping column i is aggregated away in that row.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.dtypes import DataType, torch_dtype
from spark_rapids_tpu_torch.exec.base import Schema, TpuExec
from spark_rapids_tpu_torch.ops.compiler import StageFn
from spark_rapids_tpu_torch.ops.expressions import (
    ColVal, Expression, Literal)
from spark_rapids_tpu_torch.plan import logical as L

GROUPING_ID_COL = "spark_grouping_id"


class NullLiteral(Expression):
    """A typed NULL column (a rolled-up key slot): zero values of the
    key's type under an all-false validity."""

    def __init__(self, dtype: DataType):
        self._dtype = dtype
        self.children = ()

    @property
    def dtype(self) -> DataType:
        return self._dtype

    @property
    def nullable(self) -> bool:
        return True

    @property
    def name(self) -> str:
        return "NULL"

    def emit(self, ctx) -> ColVal:
        invalid = torch.zeros(ctx.capacity, dtype=torch.bool,
                              device=ctx.device)
        if self._dtype.is_string:
            return ColVal(self._dtype,
                          torch.zeros(0, dtype=torch.uint8,
                                      device=ctx.device), invalid,
                          torch.zeros(ctx.capacity + 1, dtype=torch.int32,
                                      device=ctx.device))
        return ColVal(self._dtype,
                      torch.zeros(ctx.capacity,
                                  dtype=torch_dtype(self._dtype),
                                  device=ctx.device), invalid)

    def cache_key(self):
        return ("NullLiteral", self._dtype.name)

    def __str__(self):
        return f"NULL:{self._dtype.name}"


class Expand(L.LogicalPlan):
    """``projections[k][j]`` supplies output column j of replica k; every
    projection list has the same arity and column types."""

    def __init__(self, projections: Sequence[Sequence[Expression]],
                 names: Sequence[str], child: L.LogicalPlan):
        self.projections = [[e.bind(child.schema) for e in p]
                            for p in projections]
        self.names = list(names)
        self.children = (child,)
        first = self.projections[0]
        for p in self.projections[1:]:
            if len(p) != len(first):
                raise ValueError("expand projections differ in arity")

    @property
    def child(self):
        return self.children[0]

    @property
    def schema(self) -> Schema:
        return [(name, self.projections[0][j].dtype)
                for j, name in enumerate(self.names)]


class TpuExpandExec(TpuExec):
    """One stage function per projection, each applied to every input
    batch and emitted as its own output batch."""

    def __init__(self, node: Expand, child: TpuExec):
        super().__init__(child)
        self.node = node
        in_dtypes = [dt for _, dt in child.schema]
        self._fns = [StageFn(list(p), in_dtypes) for p in node.projections]

    @property
    def child(self) -> TpuExec:
        return self.children[0]

    @property
    def schema(self) -> Schema:
        return self.node.schema

    def describe(self):
        return f"TpuExpandExec[{len(self._fns)} projections]"

    def do_execute(self) -> Iterator[ColumnarBatch]:
        names = self.node.names
        for batch in self.child.execute():
            for fn in self._fns:
                yield ColumnarBatch(dict(zip(names, fn(batch))),
                                    batch.row_count)


def grouping_set_projections(group_exprs: Sequence[Expression],
                             sets: Sequence[Sequence[int]],
                             passthrough: Sequence[Expression]
                             ) -> List[List[Expression]]:
    """Expand projections for grouping sets: per replica, the live
    grouping expressions (the others a typed null), the pass-through
    expressions the aggregate reads, and the grouping-id literal."""
    n = len(group_exprs)
    out: List[List[Expression]] = []
    for live in sets:
        live_set = set(live)
        proj: List[Expression] = []
        gid = 0
        for i, e in enumerate(group_exprs):
            if i in live_set:
                proj.append(e)
            else:
                proj.append(NullLiteral(e.dtype))
                gid |= 1 << (n - 1 - i)
        proj.extend(passthrough)
        proj.append(Literal(np.int64(gid)))
        out.append(proj)
    return out


def rollup_sets(n: int) -> List[List[int]]:
    """ROLLUP(a, b, ...) -> [(0..n-1), (0..n-2), ..., ()]."""
    return [list(range(k)) for k in range(n, -1, -1)]


def cube_sets(n: int) -> List[List[int]]:
    """CUBE over n columns: all 2^n subsets in Spark's order."""
    out = []
    for mask in range((1 << n) - 1, -1, -1):
        out.append([i for i in range(n) if mask & (1 << (n - 1 - i))])
    return out
