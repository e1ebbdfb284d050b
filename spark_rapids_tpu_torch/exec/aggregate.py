"""Hash-aggregate physical operator: partial -> merge -> finalize.

Counterpart of ``spark_rapids_tpu/exec/aggregate.py``.  Per input batch the
*update* aggregation runs (with a fused upstream filter as its row mask),
under ``memory/retry.with_retry``; each partial batch is registered in the
spill catalog.  While the partials hold more than
``spark.rapids.sql.agg.mergeChunkRows`` rows, a tree merge re-reduces
them a group at a time into still-partial batches (each compacted to its
live rows, then registered), so the device never holds every partial at
once; then the partials concatenate and one *merge* aggregation
re-reduces them and finalizes.  A tree merge adds float partials in
another grouping than the one-concatenation merge, so its sums may differ
from that path's in the last bits; they are the same on every run.

Grouped stages take the JAX package's ladder: probe the key ranges (one
counted fetch), then the dense coded directory when the key space fits,
else the hash table when ``spark.rapids.tpu.pallas.hash.enabled`` is on,
else the sort path.  A hash overflow discards the hash output and runs the
exact sort path, counted in ``hashOverflowFallbacks``.

String group keys take the string dictionary
(``dictionary.StableDictionary``, the JAX package's
``_StringKeyEncoder``; on the card for strings of at most 256 bytes):
per operator, codes stable across batches (a null interns as a code of
its own), so the partial batches carry int32 codes, every path (coded,
hash, sort) groups them as integers, and the merge's output decodes them
on the card.  A string min/max buffer takes
batch-local order-preserving codes (``dictionary.ordered_dict_encode``)
for each reduction: the partials decode their winners to strings, and
the merge re-encodes them over every partial, so comparisons across
batches stay exact.  Groups with string keys come out in code order.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, empty_batch
from spark_rapids_tpu_torch.columnar.column import RowCount, bucket_capacity
from spark_rapids_tpu_torch.exec.base import (
    AGG_TIME, CONCAT_TIME, NUM_INPUT_BATCHES, NUM_INPUT_ROWS, Schema, TpuExec)
from spark_rapids_tpu_torch.memory.retry import (
    with_retry, with_retry_no_split)
from spark_rapids_tpu_torch.exec.fusion import fusion_metrics
from spark_rapids_tpu_torch.ops import aggregates as agg
from spark_rapids_tpu_torch.ops import dictionary
from spark_rapids_tpu_torch.ops.compiler import (
    batch_context, batch_to_colvals, check_raise, colvals_to_columns, widen)
from spark_rapids_tpu_torch.ops.concat import concat_batches
from spark_rapids_tpu_torch.ops.expressions import (
    ColVal, EmitContext, Expression, fold_conjuncts)
from spark_rapids_tpu_torch.plan.logical import AggregateExpression
from spark_rapids_tpu_torch.utils import hostsync


# merge steps of the tree merge (0 when the partials fit one chunk)
TREE_MERGE_STEPS = "treeMergeSteps"


def _head(c: ColVal, n: int) -> ColVal:
    """The first ``n`` rows of a fixed-width output (a keyless output's
    one row stays as it is)."""
    if c.offsets is not None or c.values.dim() == 0:
        return c
    return ColVal(c.dtype, c.values[:n],
                  None if c.validity is None else c.validity[:n])


def _ordered_codes(c: ColVal, capacity: int):
    """(int64 codes ColVal, sorted distinct values) of a string buffer
    input: order-preserving, so min/max over codes is min/max over the
    strings."""
    host = dictionary.host_strings(c, capacity)
    codes, values = dictionary.ordered_dict_encode(host)
    return ColVal(dts.INT64, torch.from_numpy(codes).to(c.values.device),
                  c.validity), values


def _rows(c: ColVal) -> int:
    if c.offsets is not None:
        return int(c.offsets.shape[0]) - 1
    return int(c.values.shape[0]) if c.values.dim() else 1


class TpuHashAggregateExec(TpuExec):
    def __init__(self, group_exprs: Sequence[Expression],
                 agg_exprs: Sequence[Tuple[str, AggregateExpression]],
                 child: TpuExec, device,
                 pre_filter: Optional[Sequence[Expression]] = None,
                 hash_table_slots: Optional[int] = None,
                 merge_chunk_rows: int = 1 << 22):
        """``pre_filter``: the fused upstream Filter conjuncts, bottom-first;
        they become the update stage's row mask (no compaction at all).
        ``hash_table_slots``: size of the hash group-by table, or None when
        the hash path is off.  ``merge_chunk_rows``: the tree merge's
        chunk."""
        super().__init__(child)
        self.merge_chunk_rows = int(merge_chunk_rows)
        self.group_exprs = list(group_exprs)
        self.agg_exprs = list(agg_exprs)
        self.device = device
        self.pre_filters = list(pre_filter or [])
        self.hash_table_slots = hash_table_slots
        self.funcs = [ae.func for _, ae in agg_exprs]
        self._encoders = {i: dictionary.StableDictionary()
                          for i, e in enumerate(self.group_exprs)
                          if e.dtype.is_string}
        for name in (NUM_INPUT_ROWS, NUM_INPUT_BATCHES, AGG_TIME,
                     CONCAT_TIME, TREE_MERGE_STEPS):
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
        # buffer positions of string min/max (order-preserving codes)
        self._string_bufs = {j for j, spec in enumerate(self._buf_specs)
                             if spec.dtype.is_string}
        self._coded_eligible = bool(self.group_exprs) and \
            agg.coded_key_eligible([dt for _, dt in
                                    self._partial_schema[:len(
                                        self.group_exprs)]])

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
        """String keys travel as their int32 codes."""
        keys = [(f"_k{i}", dts.INT32 if i in self._encoders else e.dtype)
                for i, e in enumerate(self.group_exprs)]
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
        keys = [ColVal(dts.INT32, self._encoders[i].encode(
            k, ctx.capacity).to(torch.int32)) if i in self._encoders else k
            for i, k in enumerate(keys)]
        bufs = self._eval_update_inputs(ctx)
        check_raise(ctx)
        key_out, buf_out, n = self._reduce(keys, bufs, ctx.nrows,
                                           ctx.capacity, mask)
        return self._batch(self._partial_schema, key_out + buf_out, n)

    def _reduce(self, keys, bufs, nrows, capacity, mask):
        """Grouped or keyless reduction of one batch of buffer inputs;
        string min/max buffers reduce as order-preserving codes and come
        back as strings."""
        dicts = {}
        for j in self._string_bufs:
            kind, c = bufs[j]
            codes, dicts[j] = _ordered_codes(c, capacity)
            bufs[j] = (kind, codes)
        if keys:
            key_out, buf_out, n = self._grouped(keys, bufs, nrows,
                                                capacity, mask)
        else:
            key_out, n = [], 1
            buf_out = agg.reduce_aggregate(bufs, nrows, capacity,
                                           self.device, row_mask=mask)
        if dicts:
            n = int(RowCount.wrap(n))
            key_out = [_head(k, n) for k in key_out]
            buf_out = [dictionary.decode(dicts[j], _head(b, n).values,
                                         _head(b, n).validity)
                       if j in dicts else _head(b, n)
                       for j, b in enumerate(buf_out)]
        return key_out, buf_out, n

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
    def _merge_reduce(self, merged: ColumnarBatch):
        """(keys, buffers, n) of the merge aggregation of concatenated
        partials, still in the partial layout."""
        nkeys = len(self.group_exprs)
        cols = batch_to_colvals(merged, [dt for _, dt in
                                         self._partial_schema])
        keys, bufs = cols[:nkeys], cols[nkeys:]
        merge_inputs = list(zip(self._merge_kinds, bufs))
        rc = merged.row_count
        nrows = int(rc) if rc.is_concrete else rc.device_tensor(self.device)
        capacity = merged.capacity
        mask = agg._row_mask(nrows, capacity, self.device) if keys \
            else None
        return self._reduce(keys, merge_inputs, nrows, capacity, mask)

    def _merge(self, partials: List[ColumnarBatch]) -> ColumnarBatch:
        with self.timer(CONCAT_TIME):
            merged = concat_batches(partials)
        key_out, buf_out, n = self._merge_reduce(merged)
        if self._encoders:
            n = int(RowCount.wrap(n))
            key_out = [self._encoders[i].decode(_head(k, n).values)
                       if i in self._encoders else _head(k, n)
                       for i, k in enumerate(key_out)]
            buf_out = [_head(b, n) for b in buf_out]
        results = [f.finalize(buf_out[sl])
                   for f, sl in zip(self.funcs, self._buf_slices)]
        return self._batch(self.schema, list(key_out) + results, n)

    @staticmethod
    def _batch(schema, outs: List[ColVal], n) -> ColumnarBatch:
        capacity = max(_rows(o) for o in outs)
        outs = [ColVal(dt, o.values, o.validity, o.offsets)
                for (_, dt), o in zip(schema, outs)]
        n = RowCount.wrap(n)
        cols = colvals_to_columns(outs, n, capacity)
        return ColumnarBatch(dict(zip([nm for nm, _ in schema], cols)), n)

    def _tallied(self) -> Iterator[ColumnarBatch]:
        for batch in self.child.execute():
            self.metrics[NUM_INPUT_ROWS] += batch.row_count
            self.metrics[NUM_INPUT_BATCHES] += 1
            yield batch

    def _update(self, batch: ColumnarBatch) -> ColumnarBatch:
        with self.timer(AGG_TIME):
            return self._partial(batch)

    def _tree_merge(self, handles, catalog):
        """Merge partial handles a group at a time (at least two, up to a
        chunk of rows, in registration order) until their rows fit one
        ``merge_chunk_rows`` chunk; each step's output is compacted to its
        live rows and registered at the end of the list."""
        chunk = self.merge_chunk_rows
        if len(handles) > 1 and \
                sum(h.nrows_bound for h in handles) > chunk:
            # the sizing needs the counts: one fetch for all of them
            RowCount.materialize_all([h.row_count for h in handles])
        while len(handles) > 1 and \
                sum(h.nrows_bound for h in handles) > chunk:
            group, rows = [], 0
            while handles and (len(group) < 2 or
                               rows + handles[0].nrows <= chunk):
                h = handles.pop(0)
                group.append(h)
                rows += h.nrows
                if rows >= chunk and len(group) >= 2:
                    break

            def step():
                with self.timer(CONCAT_TIME):
                    merged = concat_batches([h.materialize()
                                             for h in group])
                with self.timer(AGG_TIME):
                    key_out, buf_out, n = self._merge_reduce(merged)
                    # the compaction sizes the registration: a counted
                    # sync when the count is on the device
                    n = int(RowCount.wrap(n))
                    outs = [_compact(c, n) for c in key_out + buf_out]
                return self._batch(self._partial_schema, outs, n)

            out = with_retry_no_split(step, catalog=catalog)
            for h in group:
                h.close()
            handles.append(catalog.register(out))
            self.metrics[TREE_MERGE_STEPS] += 1
        return handles

    def do_execute(self) -> Iterator[ColumnarBatch]:
        catalog = self.spill_catalog()
        handles = []
        try:
            for partial in with_retry(self._tallied(), self._update,
                                      catalog=catalog):
                handles.append(catalog.register(partial))
            if not handles and self.group_exprs:
                return
            if handles:
                handles = self._tree_merge(handles, catalog)
            else:
                # a keyless aggregate of no rows is one row (sum null,
                # count 0)
                handles = [catalog.register(
                    empty_batch(self._partial_schema, self.device))]

            def merge():
                partials = [h.materialize() for h in handles]
                with self.timer(AGG_TIME):
                    return self._merge(partials)

            out = with_retry_no_split(merge, catalog=catalog)
        finally:
            for h in handles:
                h.close()
        yield out


def _compact(c: ColVal, n: int) -> ColVal:
    """The first ``n`` rows of a fixed-width output as a copy of their
    own, so the longer buffer can go (strings are already exact)."""
    if c.offsets is not None or c.values.dim() == 0:
        return c
    return ColVal(c.dtype, c.values[:n].clone(),
                  None if c.validity is None else c.validity[:n].clone())
