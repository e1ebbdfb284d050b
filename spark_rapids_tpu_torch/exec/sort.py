"""Sort and TopN physical operators.

Counterpart of ``spark_rapids_tpu/exec/sort.py``.  ``TpuSortExec`` sorts
with the stable lexicographic permutation the group-by uses
(``ops/aggregates.sort_permutation``: Spark's order, NaN largest, -0.0 ==
0.0, nulls first ascending and last descending unless a key says
otherwise) and gathers every column once.  Its input batches are
registered in the spill catalog as they arrive.  Then:

* in core (one batch, or at most
  ``spark.rapids.sql.sort.outOfCoreThresholdBytes`` in all): the batches
  come back, concatenate and sort, each step under
  ``memory/retry.with_retry_no_split``;
* out of core (GpuOutOfCoreSortIterator, GpuSortExec.scala:225): each
  input batch is sorted into a run, cut into spillable chunks of
  ``outOfCoreWindowRows`` rows; each merge step sorts the carry together
  with one refilled chunk per run that needs one, and emits every row up
  to the earliest live run boundary.  The boundary needs no key
  comparison: each run's last resident row carries its run number as a
  tag through the sort, and only runs whose tagged row went out are
  refilled, so the carry holds at most one window per live run.  The
  output is several batches, each sorted and in order.  The counters
  ``outOfCoreRuns`` and ``outOfCoreMergeSteps`` say that it ran.

``TpuTopNExec`` (the planner's rewrite of ``Limit(Sort)``) streams: each
batch is sorted and cut to its first n rows, and the kept heads are
concatenated and re-reduced every 8 batches, so it never holds more than
about nine heads plus a batch.  Cutting a batch to ``min(n, rows)`` needs
its row count on the host: a batch from a scan, filter or join carries a
host count; a device-resident count (an aggregate's groups) resolves
through one counted fetch.

A string sort key becomes its packed words and its length on the device
(``dictionary.string_sort_keys``), which sort as the strings do in any
batch; a string longer than ``dictionary.MAX_PACKED_BYTES`` takes the JAX
package's order-preserving int32 ranks on the host
(``dictionary.rank_encode``), exact within the batch being sorted (a
merge step's batch included).
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import Column
from spark_rapids_tpu_torch.exec.base import SORT_TIME, Schema, TpuExec
from spark_rapids_tpu_torch.exec.basic import slice_batch
from spark_rapids_tpu_torch.memory.retry import (
    with_retry, with_retry_no_split)
from spark_rapids_tpu_torch.ops import aggregates as agg
from spark_rapids_tpu_torch.ops import dictionary, selection
from spark_rapids_tpu_torch.ops.compiler import (
    StageFn, batch_to_colvals, colvals_to_columns)
from spark_rapids_tpu_torch.ops.concat import concat_batches
from spark_rapids_tpu_torch.ops.expressions import ColVal, Expression

# orders: (expr, descending, nulls_first)
Order = Tuple[Expression, bool, bool]

OOC_RUNS = "outOfCoreRuns"
OOC_MERGE_STEPS = "outOfCoreMergeSteps"


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
    def __init__(self, orders: Sequence[Order], child: TpuExec,
                 ooc_threshold_bytes: int = 256 << 20,
                 ooc_window_rows: int = 1 << 16):
        super().__init__(child)
        self.orders = list(orders)
        self.ooc_threshold_bytes = ooc_threshold_bytes
        self.ooc_window_rows = ooc_window_rows
        self._key_fn = StageFn([e for e, _, _ in self.orders],
                               [dt for _, dt in child.schema])
        for name in (SORT_TIME, OOC_RUNS, OOC_MERGE_STEPS):
            self._register_metric(name)

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

    def _perm(self, batch: ColumnarBatch) -> torch.Tensor:
        """The batch's rows in sort order (live rows first)."""
        keys, descending, nulls_first = [], [], []
        for c, (_, d, nf) in zip(self._key_fn(batch), self.orders):
            parts = _string_keys(c, batch.capacity) if c.dtype.is_string \
                else [ColVal(c.dtype, c.data, c.validity)]
            keys.extend(parts)
            descending.extend([d] * len(parts))
            nulls_first.extend([nf] * len(parts))
        live = torch.arange(batch.capacity, device=batch.device) < \
            batch.nrows
        return agg.sort_permutation(keys, live, descending=descending,
                                    nulls_first=nulls_first)

    def _gather(self, batch: ColumnarBatch, idx: torch.Tensor
                ) -> ColumnarBatch:
        """The rows at ``idx`` as an exact-length batch."""
        take = int(idx.shape[0])
        outs = selection.gather(
            batch_to_colvals(batch, [dt for _, dt in self.schema]), idx)
        names = [nm for nm, _ in self.schema]
        return ColumnarBatch(
            dict(zip(names, colvals_to_columns(outs, take, take))), take)

    def sorted_head(self, batch: ColumnarBatch, limit=None
                    ) -> ColumnarBatch:
        """``batch`` sorted, cut to its first ``limit`` rows (all rows
        when None), as an exact-length batch."""
        n = batch.nrows
        take = n if limit is None else min(limit, n)
        return self._gather(batch, self._perm(batch)[:take])

    def do_execute(self) -> Iterator[ColumnarBatch]:
        catalog = self.spill_catalog()
        handles = []
        try:
            for b in self.child.execute():
                handles.append(catalog.register(b))
            if not handles:
                return
            if len(handles) > 1 and sum(h.size_bytes for h in handles) > \
                    self.ooc_threshold_bytes:
                yield from self._out_of_core(handles, catalog)
                return

            # the restore and the concatenation are this operator's peak
            # allocation: they need the spill-retry guard as much as the
            # sort itself
            def gather_input():
                got = [h.materialize() for h in handles]
                return concat_batches(got) if len(got) > 1 else got[0]

            with self.timer(SORT_TIME):
                merged = with_retry_no_split(gather_input, catalog=catalog)
                for h in handles:
                    h.close()
                out = with_retry_no_split(lambda: self.sorted_head(merged),
                                          catalog=catalog)
            del merged
            yield out
        finally:
            for h in handles:
                h.close()

    # ------------------------------------------------------- out of core --
    def _out_of_core(self, handles, catalog) -> Iterator[ColumnarBatch]:
        window = self.ooc_window_rows
        runs = []   # [chunk handles, index of the next chunk]
        try:
            with self.timer(SORT_TIME):
                def restored():
                    # a restore is an allocation too: it retries after a
                    # spill (pulled here, not upstream of with_retry,
                    # where a raise would end the generator)
                    for h in handles:
                        b = with_retry_no_split(h.materialize,
                                                catalog=catalog)
                        h.close()
                        yield b

                def build_run(b):
                    # an OOM here splits the input batch: each half is a
                    # run of its own, which the merge does not mind
                    sb = self.sorted_head(b)
                    n = sb.nrows
                    chunks = []
                    try:
                        for piece in slice_batch(
                                sb, list(range(0, n, window)) + [n]):
                            chunks.append(catalog.register(_owned(piece)))
                    except BaseException:
                        # a retry runs the whole function again
                        for ch in chunks:
                            ch.close()
                        raise
                    if chunks:
                        runs.append([chunks, 0])

                for _ in with_retry(restored(), build_run, catalog=catalog):
                    pass
            self.metrics[OOC_RUNS] += len(runs)
            yield from self._merge_runs(runs, catalog)
        finally:
            for chunks, _ in runs:
                for ch in chunks:
                    ch.close()

    def _merge_runs(self, runs, catalog) -> Iterator[ColumnarBatch]:
        from spark_rapids_tpu_torch.utils import hostsync
        carry, carry_tags = None, None
        need = range(len(runs))
        while True:
            with self.timer(SORT_TIME):
                parts = [] if carry is None else [carry]
                tags = [] if carry is None else [carry_tags]
                for rid in sorted(need):
                    chunks, nxt = runs[rid]
                    if nxt >= len(chunks):
                        continue
                    runs[rid][1] = nxt + 1
                    win = with_retry_no_split(chunks[nxt].materialize,
                                              catalog=catalog)
                    chunks[nxt].close()
                    tag = torch.full((win.nrows,), -1, dtype=torch.int32,
                                     device=win.device)
                    if nxt + 1 < len(chunks):
                        # the run's last resident row: its boundary
                        tag[-1] = rid
                    parts.append(win)
                    tags.append(tag)
                if not parts:
                    return
                self.metrics[OOC_MERGE_STEPS] += 1

                def step():
                    merged = concat_batches(parts) if len(parts) > 1 \
                        else parts[0]
                    n = merged.nrows
                    perm = self._perm(merged)[:n]
                    sorted_tags = torch.cat(tags)[perm]
                    pos = torch.arange(n, device=perm.device)
                    first = torch.where(sorted_tags >= 0, pos, n).min()
                    # the earliest boundary and its run, in one fetch
                    got = hostsync.fetch(
                        first, sorted_tags[first.clamp(max=n - 1)])
                    return self._gather(merged, perm), sorted_tags, got

                batch, sorted_tags, (first, first_tag) = \
                    with_retry_no_split(step, catalog=catalog)
                n = batch.nrows
                if int(first) >= n:
                    # no live boundary left: every row is final
                    out, carry = batch, None
                    need = ()
                else:
                    safe = int(first) + 1
                    # refill exactly the run whose boundary row went out
                    need = (int(first_tag),)
                    if safe < n:
                        out, carry = slice_batch(batch, [0, safe, n])
                        carry_tags = sorted_tags[safe:]
                    else:
                        out, carry = batch, None
            if out.nrows:
                yield out
            if not need and carry is None:
                return


def _owned(batch: ColumnarBatch) -> ColumnarBatch:
    """A batch of views as a batch owning copies of just its rows, so the
    buffers it was cut from can go once every piece is registered."""
    cols = {name: Column(c.dtype, c.data.clone(), c.row_count,
                         validity=None if c.validity is None
                         else c.validity.clone(),
                         offsets=c.offsets.clone() if c.offsets is not None
                         else None)
            for name, c in batch.columns.items()}
    return ColumnarBatch(cols, batch.row_count)


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
