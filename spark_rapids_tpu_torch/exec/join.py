"""Join physical operator.

Counterpart of ``spark_rapids_tpu/exec/join.py``: the build side is
collected and concatenated on the device, the probe side streams, phase A
(``ops/joins.py``) matches each probe batch against the build, and phase
B emits the joined rows in chunks of at most
``spark.rapids.sql.join.outputBatchRows``.  Join types: inner, left,
right (the sides swap so the preserved side streams as the probe), full,
semi (left semi), anti (left anti) and cross.

With the hash path on (``spark.rapids.tpu.pallas.hash.enabled``), a
single-key join whose build side passes the gate takes the hash phase A
(``hash_insert`` + ``hash_probe``) for every probe batch, counted in
``hashKernelLaunches``; a table overflow discards that output, counts
``hashOverflowFallbacks`` and reruns the sort-merge phase.  Results are
identical either way.

String join keys take one string dictionary for both sides
(``dictionary.StableDictionary``, the JAX package's ``_JoinKeyEncoder``;
on the card for strings of at most 256 bytes): both sides
encode through one dictionary, so code equality is string equality, and
the codes (int64, nulls kept null) join as integers on every path.

A residual (non-equi) condition is a filter the planner puts over an
inner join (``plan/overrides.py``).  Memory: the build side goes through
``memory/coalesce.coalesce_iterator`` with ``RequireSingleBatch`` (its
pending batches registered in the spill catalog, their concatenation
under ``with_retry_no_split``); each probe batch's phase A runs under
``with_retry`` (a device OOM spills, then splits the probe batch: the
build-matched flags of a full join OR together across the halves), and
each emitted chunk under ``with_retry_no_split``.  Host syncs per probe
batch: the overflow flag of a hash phase A and the output total, each one
counted fetch, plus one for the chars of gathered string columns.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import torch

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, empty_batch
from spark_rapids_tpu_torch.columnar.column import Column, bucket_capacity
from spark_rapids_tpu_torch.exec.base import JOIN_TIME, Schema, TpuExec
from spark_rapids_tpu_torch.exec.fusion import fusion_metrics
from spark_rapids_tpu_torch.memory.coalesce import (
    RequireSingleBatch, coalesce_iterator)
from spark_rapids_tpu_torch.memory.retry import (
    with_retry, with_retry_no_split)
from spark_rapids_tpu_torch.ops import dictionary
from spark_rapids_tpu_torch.ops import joins as J
from spark_rapids_tpu_torch.ops import selection
from spark_rapids_tpu_torch.ops.compiler import StageFn
from spark_rapids_tpu_torch.ops.expressions import ColVal, Expression
from spark_rapids_tpu_torch.utils import hostsync


def _to_colvals(batch: ColumnarBatch) -> List[ColVal]:
    return [ColVal(c.dtype, c.data, c.validity, c.offsets)
            for c in batch.columns.values()]


def _to_columns(cols: Sequence[ColVal], nrows: int) -> List[Column]:
    return [Column(c.dtype, c.values, nrows, validity=c.validity,
                   offsets=c.offsets) for c in cols]


def _null_column(dt, n: int, device) -> ColVal:
    """An all-null column of ``n`` rows."""
    invalid = torch.zeros(n, dtype=torch.bool, device=device)
    if dt.is_string:
        return ColVal(dt, torch.zeros(0, dtype=torch.uint8, device=device),
                      invalid, torch.zeros(n + 1, dtype=torch.int32,
                                           device=device))
    from spark_rapids_tpu_torch.columnar.dtypes import torch_dtype
    return ColVal(dt, torch.zeros(n, dtype=torch_dtype(dt), device=device),
                  invalid)


class TpuHashJoinExec(TpuExec):
    def __init__(self, left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression], join_type: str,
                 left: TpuExec, right: TpuExec, device,
                 using: Optional[List[str]] = None,
                 max_output_rows: int = 1 << 22,
                 hash_enabled: bool = False):
        super().__init__(left, right)
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.join_type = join_type
        self.device = device
        self.using = using
        self.max_output_rows = max_output_rows
        self.hash_enabled = hash_enabled
        self._swap = join_type == "right"
        self._register_metric(JOIN_TIME)
        self._lkey_fn = StageFn(self.left_keys,
                                [dt for _, dt in left.schema])
        self._rkey_fn = StageFn(self.right_keys,
                                [dt for _, dt in right.schema])

    # ------------------------------------------------------------------ plan --
    @property
    def left(self) -> TpuExec:
        return self.children[0]

    @property
    def right(self) -> TpuExec:
        return self.children[1]

    @property
    def schema(self) -> Schema:
        lschema, rschema = self.left.schema, self.right.schema
        if self.join_type in ("semi", "anti"):
            return list(lschema)
        if self.using:
            keyset = set(self.using)
            out = [(n, dt) for n, dt in lschema if n in keyset]
            out += [(n, dt) for n, dt in lschema if n not in keyset]
            out += [(n, dt) for n, dt in rschema if n not in keyset]
            return out
        return list(lschema) + list(rschema)

    def describe(self):
        return (f"TpuHashJoinExec[{self.join_type}, "
                f"{[e.name for e in self.left_keys]}]")

    # ------------------------------------------------------------------ exec --
    def _keys(self, batch: ColumnarBatch, fn: StageFn) -> List[ColVal]:
        return [ColVal(dts.INT64, self._encoders[i].encode(
            c, c.capacity, null_code=-1), c.validity) if c.dtype.is_string
            else ColVal(c.dtype, c.data, c.validity)
            for i, c in enumerate(fn(batch))]

    def do_execute(self) -> Iterator[ColumnarBatch]:
        if self.join_type == "cross":
            yield from self._execute_cross()
            return
        probe_exec, build_exec = (self.right, self.left) if self._swap \
            else (self.left, self.right)
        probe_fn, build_fn = (self._rkey_fn, self._lkey_fn) if self._swap \
            else (self._lkey_fn, self._rkey_fn)
        self._encoders = [dictionary.StableDictionary()
                          for _ in self.left_keys]
        catalog = self.spill_catalog()
        build = self._build_side(build_exec, catalog)
        if build is None or build.capacity == 0:
            # one padding row keeps every phase-A tensor non-empty
            build = empty_batch(build_exec.schema, self.device, capacity=1)
        build_keys = with_retry_no_split(lambda: self._keys(build, build_fn),
                                         catalog=catalog)
        build_payload = _to_colvals(build)
        build_rows = build.nrows
        # the hash gate sizes the table from the bucketed build capacity,
        # as the JAX package's column lengths are bucketed capacities
        b_cap = bucket_capacity(build_rows)
        outer = self.join_type in ("left", "right", "full")
        b_matched_acc = None

        def match_hash(probe_keys, probe_rows):
            """Hash phase A, or None to run the sort merge (hash path off,
            gate closed, or a table overflow whose output is discarded)."""
            if not (self.hash_enabled and J.hash_join_eligible(
                    build_keys, probe_keys, b_cap)):
                return None
            m = J.hash_join_match(build_keys, probe_keys, build_rows,
                                  probe_rows,
                                  J.hash_join_table_slots(b_cap))
            fusion_metrics.bump("hashKernelLaunches")
            if bool(hostsync.fetch(m.pop("overflow"))):
                fusion_metrics.bump("hashOverflowFallbacks")
                return None
            return m

        def match_one(batch):
            nonlocal b_matched_acc
            n = batch.nrows
            if n == 0:
                return batch, None
            with self.timer(JOIN_TIME):
                probe_keys = self._keys(batch, probe_fn)
                m = match_hash(probe_keys, n)
                if m is None:
                    m = J.join_match(build_keys, probe_keys, build_rows, n)
                if self.join_type == "full":
                    bm = m["build_matched"]
                    b_matched_acc = bm if b_matched_acc is None else \
                        b_matched_acc | bm
            return batch, m

        for batch, m in with_retry(probe_exec.execute(), match_one,
                                   catalog=catalog):
            if m is None:
                continue
            n = batch.nrows
            if self.join_type in ("semi", "anti"):
                with self.timer(JOIN_TIME):
                    out = with_retry_no_split(
                        lambda: self._emit_semi_anti(batch, m, n),
                        catalog=catalog)
                if out is not None:
                    yield out
                continue
            with self.timer(JOIN_TIME):
                _, starts, ends, total = with_retry_no_split(
                    lambda: J.join_out_starts(m["probe_count"], n, outer),
                    catalog=catalog)
                total = int(hostsync.fetch(total))
            # chunks stream one at a time: peak memory stays bounded by
            # max_output_rows; a chunk is already that bound, so an OOM
            # spills and retries it whole
            for off in range(0, total, self.max_output_rows):
                n_out = min(self.max_output_rows, total - off)
                with self.timer(JOIN_TIME):
                    out = with_retry_no_split(
                        lambda: self._emit_chunk(batch, build_payload, m,
                                                 starts, ends, off, n_out),
                        catalog=catalog)
                yield out
        if self.join_type == "full":
            if b_matched_acc is None:
                # no probe rows: every build row is unmatched
                b_matched_acc = torch.zeros(build.capacity,
                                            dtype=torch.bool,
                                            device=self.device)
            with self.timer(JOIN_TIME):
                out = with_retry_no_split(
                    lambda: self._emit_unmatched_build(
                        build_rows, build_payload, b_matched_acc),
                    catalog=catalog)
            if out is not None:
                yield out

    @staticmethod
    def _build_side(build_exec: TpuExec, catalog
                    ) -> Optional[ColumnarBatch]:
        """The whole build side as one batch (None when it has none):
        its batches wait in the spill catalog until the concatenation,
        the join's largest allocation, which the coalesce runs under
        ``with_retry_no_split``."""
        coalesced = coalesce_iterator(build_exec.execute(),
                                      RequireSingleBatch(), catalog=catalog)
        try:
            return next(coalesced, None)
        finally:
            coalesced.close()

    def _emit_chunk(self, probe_batch, build_payload, m, starts, ends,
                    offset, n_out) -> ColumnarBatch:
        # starts/ends use the outer-adjusted counts (row emission), while
        # `matched` tests the RAW match count, so outer rows get a null
        # build side
        p, brow, matched, _ = J.join_gather_indices(
            starts - offset, ends - offset, m["probe_count"],
            m["probe_bstart"], m["sorted_to_build"], n_out, n_out)
        probe_cols = selection.gather(_to_colvals(probe_batch), p)
        build_cols = J.gather_build_side(build_payload, brow, matched)
        return self._assemble(probe_cols, build_cols, n_out,
                              probe_valid=None)

    def _emit_semi_anti(self, batch, m, n) -> Optional[ColumnarBatch]:
        count = m["probe_count"]
        in_range = torch.arange(count.shape[0], device=count.device) < n
        keep = (count > 0) if self.join_type == "semi" else (count == 0)
        cols, kept = selection.compact(_to_colvals(batch), keep & in_range)
        if kept == 0:
            return None
        names = [nm for nm, _ in self.schema]
        return ColumnarBatch(dict(zip(names, _to_columns(cols, kept))),
                             kept)

    def _emit_unmatched_build(self, build_rows, build_payload, matched_acc
                              ) -> Optional[ColumnarBatch]:
        in_range = torch.arange(matched_acc.shape[0],
                                device=matched_acc.device) < build_rows
        cols, n = selection.compact(build_payload, ~matched_acc & in_range)
        if n == 0:
            return None
        null_left = [_null_column(dt, n, self.device)
                     for _, dt in self.left.schema]
        return self._assemble(null_left, cols, n, probe_valid=False)

    def _assemble(self, probe_cols: List[ColVal], build_cols: List[ColVal],
                  n_out: int, probe_valid) -> ColumnarBatch:
        """Stitch left and right columns into the output schema (USING-key
        deduplication and full-outer key coalescing)."""
        lschema, rschema = self.left.schema, self.right.schema
        if self._swap:
            lmap = {nm: c for (nm, _), c in zip(lschema, build_cols)}
            rmap = {nm: c for (nm, _), c in zip(rschema, probe_cols)}
        else:
            lmap = {nm: c for (nm, _), c in zip(lschema, probe_cols)}
            rmap = {nm: c for (nm, _), c in zip(rschema, build_cols)}
        out_cols: Dict[str, Column] = {}
        for nm, dt in self.schema:
            if self.using and nm in self.using:
                # the preserved (probe) side supplies the key
                c = rmap[nm] if self._swap else lmap[nm]
                if self.join_type == "full":
                    rc = rmap.get(nm)
                    if rc is not None:
                        if dt.is_string:
                            # unmatched-build batches carry the key in
                            # the right map
                            c = rc if probe_valid is False else c
                        else:
                            lv = c.validity if c.validity is not None \
                                else torch.ones_like(c.values,
                                                     dtype=torch.bool)
                            c = ColVal(
                                dt, torch.where(lv, c.values, rc.values),
                                None if c.validity is None or
                                rc.validity is None else
                                c.validity | rc.validity)
                elif probe_valid is False:
                    c = rmap.get(nm, c)
            elif nm in lmap:
                c = lmap[nm]
            else:
                c = rmap[nm]
            out_cols[nm] = Column(c.dtype, c.values, n_out,
                                  validity=c.validity, offsets=c.offsets)
        return ColumnarBatch(out_cols, n_out)

    def _execute_cross(self) -> Iterator[ColumnarBatch]:
        build = self._build_side(self.right, self.spill_catalog())
        if build is None:
            return
        bn = build.nrows
        build_payload = _to_colvals(build)
        for batch in self.left.execute():
            total = batch.nrows * bn
            for off in range(0, total, self.max_output_rows):
                n_out = min(self.max_output_rows, total - off)
                with self.timer(JOIN_TIME):
                    j = torch.arange(n_out, device=self.device) + off
                    probe_cols = selection.gather(_to_colvals(batch),
                                                  j // bn)
                    build_cols = selection.gather(build_payload, j % bn)
                    out = self._assemble(probe_cols, build_cols, n_out,
                                         None)
                yield out
