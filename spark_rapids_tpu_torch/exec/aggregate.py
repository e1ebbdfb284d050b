"""Hash-aggregate physical operator: partial -> merge -> finalize.

Counterpart of ``spark_rapids_tpu/exec/aggregate.py``.  Per input batch the
*update* aggregation runs (with a fused upstream filter as its row mask);
the partial batches then concatenate on the device and one *merge*
aggregation re-reduces them and finalizes.

Grouped stages take the JAX package's ladder: probe the key ranges (one
counted fetch), then the dense coded directory when the key space fits,
else the hash table when ``spark.rapids.tpu.pallas.hash.enabled`` is on,
else the sort path.  A hash overflow discards the hash output and runs the
exact sort path, counted in ``hashOverflowFallbacks``.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, empty_batch
from spark_rapids_tpu_torch.columnar.column import RowCount, bucket_capacity
from spark_rapids_tpu_torch.exec.base import (
    AGG_TIME, CONCAT_TIME, NUM_INPUT_BATCHES, NUM_INPUT_ROWS, Schema, TpuExec)
from spark_rapids_tpu_torch.exec.fusion import fusion_metrics
from spark_rapids_tpu_torch.ops import aggregates as agg
from spark_rapids_tpu_torch.ops.compiler import (
    batch_context, batch_to_colvals, check_raise, colvals_to_columns, widen)
from spark_rapids_tpu_torch.ops.concat import concat_batches
from spark_rapids_tpu_torch.ops.expressions import (
    ColVal, EmitContext, Expression, fold_conjuncts)
from spark_rapids_tpu_torch.plan.logical import AggregateExpression
from spark_rapids_tpu_torch.utils import hostsync


class TpuHashAggregateExec(TpuExec):
    def __init__(self, group_exprs: Sequence[Expression],
                 agg_exprs: Sequence[Tuple[str, AggregateExpression]],
                 child: TpuExec, device,
                 pre_filter: Optional[Sequence[Expression]] = None,
                 hash_table_slots: Optional[int] = None):
        """``pre_filter``: the fused upstream Filter conjuncts, bottom-first;
        they become the update stage's row mask (no compaction at all).
        ``hash_table_slots``: size of the hash group-by table, or None when
        the hash path is off."""
        super().__init__(child)
        self.group_exprs = list(group_exprs)
        self.agg_exprs = list(agg_exprs)
        self.device = device
        self.pre_filters = list(pre_filter or [])
        self.hash_table_slots = hash_table_slots
        self.funcs = [ae.func for _, ae in agg_exprs]
        for name in (NUM_INPUT_ROWS, NUM_INPUT_BATCHES, AGG_TIME,
                     CONCAT_TIME):
            self._register_metric(name)
        self._in_dtypes = [dt for _, dt in child.schema]
        self._buf_specs: List[agg.BufferSpec] = []
        self._buf_slices: List[slice] = []
        for f in self.funcs:
            specs = f.buffers()
            self._buf_slices.append(
                slice(len(self._buf_specs), len(self._buf_specs) + len(specs)))
            self._buf_specs.extend(specs)
        self._merge_kinds = tuple(agg.merge_kind(s.kind)
                                  for s in self._buf_specs)
        self._coded_eligible = bool(self.group_exprs) and \
            agg.coded_key_eligible([e.dtype for e in self.group_exprs])

    @property
    def child(self) -> TpuExec:
        return self.children[0]

    @property
    def schema(self) -> Schema:
        out = [(e.name, e.dtype) for e in self.group_exprs]
        out += [(name, ae.dtype) for name, ae in self.agg_exprs]
        return out

    @property
    def _partial_schema(self) -> Schema:
        keys = [(f"_k{i}", e.dtype) for i, e in enumerate(self.group_exprs)]
        bufs = [(f"_b{j}", spec.dtype)
                for j, spec in enumerate(self._buf_specs)]
        return keys + bufs

    def describe(self):
        fused = ", fused filter" if self.pre_filters else ""
        return (f"TpuHashAggregateExec[keys="
                f"{[e.name for e in self.group_exprs]}, aggs="
                f"{[n for n, _ in self.agg_exprs]}{fused}]")

    # ---------------------------------------------------------- update stage
    def _eval_update_inputs(self, ctx: EmitContext
                            ) -> List[Tuple[str, ColVal]]:
        pairs: List[Tuple[str, ColVal]] = []
        for f in self.funcs:
            c = None if f.child is None else \
                widen(f.child.emit(ctx), ctx.capacity)
            for spec, cv in zip(f.buffers(), f.update_inputs(
                    c, ctx.capacity, ctx.device)):
                pairs.append((spec.kind, cv))
        return pairs

    def _partial(self, batch: ColumnarBatch) -> ColumnarBatch:
        """Update aggregation of one batch: keys, buffer inputs and the
        fused filter mask are evaluated once, then reduced."""
        ctx = batch_context(batch, self._in_dtypes)
        mask = fold_conjuncts(ctx, self.pre_filters) if self.pre_filters \
            else ctx.row_mask()
        keys = [widen(e.emit(ctx), ctx.capacity) for e in self.group_exprs]
        bufs = self._eval_update_inputs(ctx)
        check_raise(ctx)
        if not keys:
            outs = agg.reduce_aggregate(bufs, ctx.nrows, ctx.capacity,
                                        ctx.device, row_mask=mask)
            return self._batch(self._partial_schema, outs, 1)
        key_out, buf_out, n = self._grouped(keys, bufs, ctx.nrows,
                                            ctx.capacity, mask)
        return self._batch(self._partial_schema, key_out + buf_out, n)

    def _grouped(self, keys, bufs, nrows, capacity, mask):
        """coded -> hashed -> sort."""
        if self._coded_eligible:
            mins, maxs = agg.key_range_probe(keys, mask)
            mins_h, maxs_h = hostsync.fetch(mins, maxs)
            lo = np.minimum(mins_h, maxs_h).tolist()
            pick = agg.coded_slot_ranges(mins_h, maxs_h)
            if pick is not None:
                slots, total = pick
                return agg.groupby_aggregate_coded(
                    keys, bufs, nrows, capacity, lo, slots,
                    bucket_capacity(total, minimum=64), row_mask=mask)
            got = self._try_hashed(keys, bufs, nrows, capacity, mask, lo,
                                   mins_h, maxs_h)
            if got is not None:
                return got
        return agg.groupby_aggregate(keys, bufs, nrows, capacity,
                                     row_mask=mask)

    def _try_hashed(self, keys, bufs, nrows, capacity, mask, lo, mins_h,
                    maxs_h):
        """Hash-table attempt.  None means run the sort path: hash path
        off, key space past 2**62, or table overflow (counted)."""
        if self.hash_table_slots is None:
            return None
        pick = agg.hashed_slot_ranges(mins_h, maxs_h)
        if pick is None:
            return None
        slots, _ = pick
        out_keys, out_bufs, n, overflow = agg.groupby_aggregate_hashed(
            keys, bufs, nrows, capacity, lo, slots, self.hash_table_slots,
            row_mask=mask)
        fusion_metrics.bump("hashKernelLaunches")
        if overflow:
            fusion_metrics.bump("hashOverflowFallbacks")
            return None
        return out_keys, out_bufs, n

    # ----------------------------------------------------------- merge stage
    def _merge(self, partials: List[ColumnarBatch]) -> ColumnarBatch:
        with self.timer(CONCAT_TIME):
            merged = concat_batches(partials)
        nkeys = len(self.group_exprs)
        cols = batch_to_colvals(merged, [dt for _, dt in
                                         self._partial_schema])
        keys, bufs = cols[:nkeys], cols[nkeys:]
        merge_inputs = list(zip(self._merge_kinds, bufs))
        rc = merged.row_count
        nrows = int(rc) if rc.is_concrete else rc.device_tensor(self.device)
        capacity = merged.capacity
        if keys:
            mask = agg._row_mask(nrows, capacity, self.device)
            key_out, buf_out, n = self._grouped(keys, merge_inputs, nrows,
                                                capacity, mask)
        else:
            key_out, n = [], 1
            buf_out = agg.reduce_aggregate(merge_inputs, nrows, capacity,
                                           self.device)
        results = [f.finalize(buf_out[sl])
                   for f, sl in zip(self.funcs, self._buf_slices)]
        return self._batch(self.schema, list(key_out) + results, n)

    @staticmethod
    def _batch(schema, outs: List[ColVal], n) -> ColumnarBatch:
        capacity = max(o.values.shape[0] if o.values.dim() else 1
                       for o in outs)
        outs = [ColVal(dt, o.values, o.validity)
                for (_, dt), o in zip(schema, outs)]
        n = RowCount.wrap(n)
        cols = colvals_to_columns(outs, n, capacity)
        return ColumnarBatch(dict(zip([nm for nm, _ in schema], cols)), n)

    def do_execute(self) -> Iterator[ColumnarBatch]:
        partials = []
        for batch in self.child.execute():
            self.metrics[NUM_INPUT_ROWS] += batch.row_count
            self.metrics[NUM_INPUT_BATCHES] += 1
            with self.timer(AGG_TIME):
                partials.append(self._partial(batch))
        if not partials:
            if self.group_exprs:
                return
            # a keyless aggregate of no rows is one row (sum null, count 0)
            partials = [empty_batch(self._partial_schema, self.device)]
        with self.timer(AGG_TIME):
            yield self._merge(partials)

