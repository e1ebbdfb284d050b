"""Sort and TopN physical operators.

Counterpart of ``spark_rapids_tpu/exec/sort.py``.  ``TpuSortExec`` sorts
in memory: it concatenates its whole input on the device, sorts it with
the stable lexicographic permutation the group-by uses
(``ops/aggregates.sort_permutation``: Spark's order, NaN largest, -0.0 ==
0.0, nulls first ascending and last descending unless a key says
otherwise), and gathers every column once.  The JAX package's out-of-core
merge path (spill-backed runs) is not ported: that is the memory slice's
work, and an input larger than the card's memory fails here.

``TpuTopNExec`` (the planner's rewrite of ``Limit(Sort)``) streams: each
batch is sorted and cut to its first n rows, and the kept heads are
concatenated and re-reduced every 8 batches, so it never holds more than
about nine heads plus a batch.  Cutting a batch to ``min(n, rows)`` needs
its row count on the host: a batch from a scan, filter or join carries a
host count; a device-resident count (an aggregate's groups) resolves
through one counted fetch.

A string sort key becomes its packed words and its length on the device
(``dictionary.string_sort_keys``), which sort as the strings do; a
string longer than ``dictionary.MAX_PACKED_BYTES`` takes the JAX
package's order-preserving int32 ranks on the host
(``dictionary.rank_encode``), exact within the batch being sorted.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec.base import SORT_TIME, Schema, TpuExec
from spark_rapids_tpu_torch.ops import aggregates as agg
from spark_rapids_tpu_torch.ops import dictionary, selection
from spark_rapids_tpu_torch.ops.compiler import (
    StageFn, batch_to_colvals, colvals_to_columns)
from spark_rapids_tpu_torch.ops.concat import concat_batches
from spark_rapids_tpu_torch.ops.expressions import ColVal, Expression

# orders: (expr, descending, nulls_first)
Order = Tuple[Expression, bool, bool]


def _string_keys(c, capacity: int) -> List[ColVal]:
    """A string key as sort keys in string order, most significant
    first (nulls keep the validity; padding rows sort anywhere, the live
    mask puts them last)."""
    keys = dictionary.string_sort_keys(c, capacity)
    if keys is not None:
        return keys
    ranks = dictionary.rank_encode(dictionary.host_strings(c, capacity))
    return [ColVal(dts.INT32, torch.from_numpy(ranks.astype(np.int32)).to(
        c.data.device), c.validity)]


class TpuSortExec(TpuExec):
    def __init__(self, orders: Sequence[Order], child: TpuExec):
        super().__init__(child)
        self.orders = list(orders)
        self._key_fn = StageFn([e for e, _, _ in self.orders],
                               [dt for _, dt in child.schema])
        self._register_metric(SORT_TIME)

    @property
    def child(self) -> TpuExec:
        return self.children[0]

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def describe(self):
        parts = [f"{e.name} {'DESC' if d else 'ASC'}"
                 for e, d, _ in self.orders]
        return f"TpuSortExec[{', '.join(parts)}]"

    def sorted_head(self, batch: ColumnarBatch, limit=None
                    ) -> ColumnarBatch:
        """``batch`` sorted, cut to its first ``limit`` rows (all rows
        when None), as an exact-length batch."""
        n = batch.nrows
        take = n if limit is None else min(limit, n)
        keys, descending, nulls_first = [], [], []
        for c, (_, d, nf) in zip(self._key_fn(batch), self.orders):
            parts = _string_keys(c, batch.capacity) if c.dtype.is_string \
                else [ColVal(c.dtype, c.data, c.validity)]
            keys.extend(parts)
            descending.extend([d] * len(parts))
            nulls_first.extend([nf] * len(parts))
        live = torch.arange(batch.capacity, device=batch.device) < n
        perm = agg.sort_permutation(keys, live, descending=descending,
                                    nulls_first=nulls_first)
        outs = selection.gather(
            batch_to_colvals(batch, [dt for _, dt in self.schema]),
            perm[:take])
        names = [nm for nm, _ in self.schema]
        return ColumnarBatch(
            dict(zip(names, colvals_to_columns(outs, take, take))), take)

    def do_execute(self) -> Iterator[ColumnarBatch]:
        batches = list(self.child.execute())
        if not batches:
            return
        with self.timer(SORT_TIME):
            out = self.sorted_head(concat_batches(batches))
        yield out


class TpuTopNExec(TpuExec):
    """TakeOrderedAndProject: the first ``n`` rows in ``orders``."""

    def __init__(self, n: int, orders: Sequence[Order], child: TpuExec):
        super().__init__(child)
        self.n = n
        self.orders = list(orders)
        self._inner = TpuSortExec(orders, child)
        self._register_metric(SORT_TIME)

    @property
    def child(self) -> TpuExec:
        return self.children[0]

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def describe(self):
        return f"TpuTopNExec[{self.n}]"

    def do_execute(self) -> Iterator[ColumnarBatch]:
        pending: List[ColumnarBatch] = []
        head = self._inner.sorted_head
        for batch in self.child.execute():
            if batch.nrows == 0:
                continue
            with self.timer(SORT_TIME):
                pending.append(head(batch, self.n))
                if len(pending) > 8:
                    pending = [head(concat_batches(pending), self.n)]
        if not pending:
            return
        with self.timer(SORT_TIME):
            out = head(concat_batches(pending), self.n)
        yield out
