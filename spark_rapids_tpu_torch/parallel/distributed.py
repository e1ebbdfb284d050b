"""Distributed query steps over a shard group.

Counterpart of ``spark_rapids_tpu/parallel/distributed.py``: the keyless
and keyed aggregates and the equi-join over the shards of a
:class:`~spark_rapids_tpu_torch.parallel.mesh.ShardGroup`.  Where the JAX
package runs one compiled SPMD program per phase, the port runs each
phase's per-shard work as a loop over the local shards; the phase
boundaries (the host syncs) are the JAX package's.

- Keyless aggregate: a local reduce per shard (``reduce_aggregate``, the
  ``masked_multi_reduce`` kernel for float sums), every shard's one-row
  partials all-gathered, and one grand-total merge (the same reduction
  over the partials) whose row lands on shard 0.
- Keyed aggregate, in two phases: the local partial group-by (the sort
  path, as the JAX package's distributed aggregate uses) and a histogram
  of its groups over ``4 * nshards`` hash buckets; one host sync of the
  histograms; ``coalesce_buckets`` packs buckets onto shards; the partials
  exchange by ``lut[bucket]``; the received partials merge and finalise.
- Join: broadcast (the build side all-gathered) at or below
  ``spark.rapids.sql.join.broadcastThresholdRows`` build rows, else a
  shuffle: a stats histogram of both sides by key hash, one host sync,
  both sides exchanged by ``hash_partition_ids(keys, nshards)``, then the
  local sort-merge match (``ops/joins.join_match``) and gather.

Shards hold exactly their rows, so nothing is sized from the histograms:
they are the stage statistics each operator keeps in ``last_stats``
(the JAX package sizes its padded all-to-all slots from them).  Not
ported: skew mitigation, the cost model, wire fusion, asynchronous
exchange windows, checkpoints and output-factor retries.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.dtypes import DataType, torch_dtype
from spark_rapids_tpu_torch.ops import aggregates as agg
from spark_rapids_tpu_torch.ops import joins as J
from spark_rapids_tpu_torch.ops import selection
from spark_rapids_tpu_torch.ops.compiler import check_raise, widen
from spark_rapids_tpu_torch.ops.expressions import (
    ColVal, EmitContext, Expression, fold_conjuncts)
from spark_rapids_tpu_torch.ops.kernels import histogram
from spark_rapids_tpu_torch.parallel.mesh import Shard, ShardGroup
from spark_rapids_tpu_torch.parallel.partitioning import hash_partition_ids
from spark_rapids_tpu_torch.parallel.shuffle import all_gather_cols, exchange
from spark_rapids_tpu_torch.utils import hostsync


def host_sync(group: ShardGroup, per_shard):
    """``group.host_sync(per_shard)`` as a phase boundary: inside a
    ``dist.host_sync`` watchdog section (a rank that never arrives
    becomes a TimeoutFault once the gather returns, not an unnoticed
    wait) and past the ``dist.host_sync`` injection point."""
    from spark_rapids_tpu_torch.robustness import watchdog
    from spark_rapids_tpu_torch.robustness.inject import fire
    with watchdog.section("dist.host_sync"):
        fire("dist.host_sync")
        return group.host_sync(per_shard)


def coalesce_buckets(counts, nshards: int):
    """Greedy balanced assignment of hash buckets to shards from the
    materialized [src_shard, bucket] histogram (the AQE partition
    coalescing / skew-spreading step).  Returns (lut int32[buckets],
    dst_counts [src_shard, dst_shard])."""
    totals = counts.sum(axis=0)
    buckets = counts.shape[1]
    load = np.zeros(nshards, dtype=np.int64)
    lut = np.zeros(buckets, dtype=np.int32)
    for b in np.argsort(-totals, kind="stable"):
        dst = int(np.argmin(load))
        lut[b] = dst
        load[dst] += int(totals[b])
    dst_counts = np.zeros((counts.shape[0], nshards), dtype=np.int64)
    for b in range(buckets):
        dst_counts[:, lut[b]] += counts[:, b]
    return lut, dst_counts


def cut(cols: Sequence[ColVal], n: int) -> Shard:
    """The first ``n`` rows of every column (views)."""
    return [ColVal(c.dtype, c.values[:n],
                   None if c.validity is None else c.validity[:n])
            for c in cols]


def _pad_one(cols: Sequence[ColVal], n: int) -> Shard:
    """Columns of an empty side get one dead row, so the join's phase A
    never indexes an empty tensor."""
    if n > 0:
        return list(cols)
    return [ColVal(c.dtype, torch.zeros(1, dtype=c.values.dtype,
                                        device=c.values.device))
            for c in cols]


class DistributedAggregate:
    """filter? -> partial aggregate -> exchange by key hash -> final
    aggregate.  Outputs stay sharded: each shard owns the groups whose
    bucket the LUT assigned to it (a keyless result is one row on shard
    0)."""

    def __init__(self, group: ShardGroup, in_dtypes: Sequence[DataType],
                 group_exprs: Sequence[Expression],
                 funcs: Sequence[agg.AggregateFunction],
                 filter_cond=None):
        """``filter_cond``: a predicate or the fused upstream conjuncts in
        bottom-first chain order; they become the update stage's row
        mask."""
        self.group = group
        self.nshards = group.nshards
        # finer buckets than shards, packed onto shards from the histogram
        self.buckets = 4 * self.nshards
        self.in_dtypes = list(in_dtypes)
        self.group_exprs = list(group_exprs)
        self.funcs = list(funcs)
        self.filter_conds = list(filter_cond) if isinstance(
            filter_cond, (list, tuple)) else (
            [filter_cond] if filter_cond is not None else [])
        self._buf_specs: List[agg.BufferSpec] = []
        self._buf_slices: List[slice] = []
        for f in self.funcs:
            specs = f.buffers()
            self._buf_slices.append(
                slice(len(self._buf_specs), len(self._buf_specs) + len(specs)))
            self._buf_specs.extend(specs)
        self.last_stats: Optional[dict] = None

    def _local_partials(self, cols: Shard, n: int):
        """Row mask, keys and update-buffer inputs of one shard."""
        device = self.group.device
        ctx = EmitContext(cols, n, n, device)
        mask = fold_conjuncts(ctx, self.filter_conds) \
            if self.filter_conds else None
        keys = [widen(e.emit(ctx), n) for e in self.group_exprs]
        bufs = []
        for f in self.funcs:
            c = None if f.child is None else widen(f.child.emit(ctx), n)
            for spec, cv in zip(f.buffers(), f.update_inputs(c, n, device)):
                bufs.append((spec.kind, widen(cv, n)))
        check_raise(ctx)
        return mask, keys, bufs

    def _merge_inputs(self, bufs: Sequence[ColVal]):
        return [(agg.merge_kind(s.kind), c)
                for s, c in zip(self._buf_specs, bufs)]

    def _finalize(self, bufs: Sequence[ColVal]) -> List[ColVal]:
        return [f.finalize(list(bufs[sl]))
                for f, sl in zip(self.funcs, self._buf_slices)]

    def __call__(self, shards: Sequence[Shard], nrows: Sequence[int]
                 ) -> Tuple[List[Shard], List[int]]:
        """``shards[i]`` (exactly ``nrows[i]`` rows) is local shard
        ``group.local_shards[i]``.  Returns the output shards (group keys,
        then one column per aggregate function) and their row counts."""
        if not self.group_exprs:
            return self._keyless(shards, nrows)
        return self._keyed(shards, nrows)

    def _keyless(self, shards, nrows):
        device = self.group.device
        partials = []
        for cols, n in zip(shards, nrows):
            mask, _, bufs = self._local_partials(cols, n)
            partials.append(agg.reduce_aggregate(bufs, n, n, device,
                                                 row_mask=mask))
        gathered = all_gather_cols(partials, self.group)
        merged = agg.reduce_aggregate(self._merge_inputs(gathered),
                                      self.nshards, self.nshards, device)
        results = self._finalize(merged)
        self.last_stats = {"keyless": True}
        outs, counts = [], []
        for s in self.group.local_shards:
            k = 1 if s == 0 else 0
            outs.append(cut(results, k))
            counts.append(k)
        return outs, counts

    def _keyed(self, shards, nrows):
        device = self.group.device
        partial_cols, bids, hists = [], [], []
        for cols, n in zip(shards, nrows):
            mask, keys, bufs = self._local_partials(cols, n)
            pkeys, pbufs, n_groups = agg.groupby_aggregate(
                keys, bufs, n, n, row_mask=mask)
            b = hash_partition_ids(pkeys, self.buckets)
            live = torch.arange(n, device=device) < n_groups
            hists.append(histogram(b, live, self.buckets))
            partial_cols.append(list(pkeys) + list(pbufs))
            bids.append(b)
        # phase boundary: the stage statistics
        counts = host_sync(self.group, hists).astype(np.int64)
        lut, dst_counts = coalesce_buckets(counts, self.nshards)
        self.last_stats = {
            "bucket_counts": counts,         # [src_shard, bucket]
            "bucket_map": lut,               # bucket -> dst shard
            "partition_counts": dst_counts,  # [src_shard, dst_shard]
        }
        lut_t = torch.from_numpy(lut).to(device)
        n_groups = counts[self.group.local_shards].sum(axis=1).tolist()
        pids = [lut_t[b.to(torch.int64)] for b in bids]
        recv = exchange(partial_cols, pids, n_groups, self.nshards,
                        self.group)
        nkeys = len(self.group_exprs)
        outs, finals = [], []
        for r in recv:
            m = r[0].values.shape[0]
            fkeys, fbufs, fn = agg.groupby_aggregate(
                r[:nkeys], self._merge_inputs(r[nkeys:]), m, m)
            outs.append(list(fkeys) + self._finalize(fbufs))
            finals.append(fn)
        sizes = [int(v) for v in hostsync.fetch_all(finals)]
        return [cut(o, k) for o, k in zip(outs, sizes)], sizes


class DistributedHashJoin:
    """Equi-join over the shard group, by broadcast or by shuffle.

    Output shards: probe columns then build columns (semi and anti: probe
    columns only); a full join appends the build rows that matched
    nothing, with null probe columns.  Right joins are planned as left
    joins with the sides swapped.  ``broadcast_threshold_rows`` (default
    the conf's) picks the strategy: broadcast at or below it, else
    shuffle, so a negative threshold always shuffles."""

    def __init__(self, group: ShardGroup,
                 probe_dtypes: Sequence[DataType],
                 build_dtypes: Sequence[DataType],
                 probe_key_idx: Sequence[int],
                 build_key_idx: Sequence[int],
                 join_type: str = "inner",
                 broadcast_threshold_rows: Optional[int] = None):
        from spark_rapids_tpu_torch.config import rapids_conf as rc
        if join_type not in ("inner", "left", "semi", "anti", "full"):
            raise ValueError(
                "distributed join supports inner/left/semi/anti/full "
                f"(got {join_type!r}); lower right joins by swapping "
                "sides")
        self.group = group
        self.nshards = group.nshards
        self.probe_dtypes = list(probe_dtypes)
        self.build_dtypes = list(build_dtypes)
        self.probe_key_idx = list(probe_key_idx)
        self.build_key_idx = list(build_key_idx)
        self.join_type = join_type
        self.broadcast_threshold_rows = \
            rc.BROADCAST_JOIN_THRESHOLD_ROWS.default \
            if broadcast_threshold_rows is None else broadcast_threshold_rows
        self.last_stats: Optional[dict] = None

    def resolve_strategy(self, total_build: int) -> str:
        if self.join_type == "full":
            # a replicated build side would emit its unmatched rows once
            # per shard: full outer must co-partition
            return "shuffle"
        return "broadcast" if total_build <= self.broadcast_threshold_rows \
            else "shuffle"

    def __call__(self, probe: Sequence[Shard], probe_n: Sequence[int],
                 build: Sequence[Shard], build_n: Sequence[int]
                 ) -> Tuple[List[Shard], List[int]]:
        total_build = int(self.group.all_counts(build_n).sum())
        strategy = self.resolve_strategy(total_build)
        stats = {"strategy": strategy, "build_rows": total_build}
        if strategy == "broadcast":
            whole = all_gather_cols(list(build), self.group)
            pairs = [(p, pn, whole, total_build)
                     for p, pn in zip(probe, probe_n)]
        else:
            device = self.group.device
            ppids, bpids, hists = [], [], []
            for p, pn, b, bn in zip(probe, probe_n, build, build_n):
                pp = hash_partition_ids([p[i] for i in self.probe_key_idx],
                                        self.nshards)
                bp = hash_partition_ids([b[i] for i in self.build_key_idx],
                                        self.nshards)
                hists.append((
                    histogram(pp, torch.ones(pn, dtype=torch.bool,
                                             device=device), self.nshards),
                    histogram(bp, torch.ones(bn, dtype=torch.bool,
                                             device=device), self.nshards)))
                ppids.append(pp)
                bpids.append(bp)
            pcounts, bcounts = host_sync(self.group, hists)
            stats.update(probe_counts=pcounts.astype(np.int64),
                         build_counts=bcounts.astype(np.int64))
            rp = exchange(probe, ppids, probe_n, self.nshards, self.group)
            rb = exchange(build, bpids, build_n, self.nshards, self.group)
            pairs = [(p, p[0].values.shape[0], b, b[0].values.shape[0])
                     for p, b in zip(rp, rb)]
        self.last_stats = stats
        return self._local_joins(pairs)

    def _local_joins(self, pairs):
        """Phase A on every local shard, one fetch of every shard's output
        sizes, then phase B."""
        device = self.group.device
        outer = self.join_type in ("left", "full")
        plans, sizes = [], []
        for p, pn, b, bn in pairs:
            p, b = _pad_one(p, pn), _pad_one(b, bn)
            m = J.join_match([b[i] for i in self.build_key_idx],
                             [p[i] for i in self.probe_key_idx], bn, pn)
            plan = {"p": p, "b": b, "pn": pn, "bn": bn, "m": m}
            if self.join_type in ("semi", "anti"):
                has = m["probe_count"] > 0
                live = torch.arange(has.shape[0], device=device) < pn
                keep = (has if self.join_type == "semi" else ~has) & live
                plan["perm"], n_keep = selection.compact_plan(keep)
                sizes.append(n_keep)
            else:
                _, starts, ends, total = J.join_out_starts(
                    m["probe_count"], pn, outer)
                plan["starts"], plan["ends"] = starts, ends
                sizes.append(total)
                if self.join_type == "full":
                    live_b = torch.arange(b[0].values.shape[0],
                                          device=device) < bn
                    plan["uperm"], n_un = selection.compact_plan(
                        ~m["build_matched"] & live_b)
                    sizes.append(n_un)
            plans.append(plan)
        host = iter(int(v) for v in hostsync.fetch_all(sizes))
        outs, counts = [], []
        for plan in plans:
            p, m = plan["p"], plan["m"]
            if self.join_type in ("semi", "anti"):
                k = next(host)
                outs.append(selection.gather(p, plan["perm"][:k]))
                counts.append(k)
                continue
            total = next(host)
            pi, brow, matched, _ = J.join_gather_indices(
                plan["starts"], plan["ends"], m["probe_count"],
                m["probe_bstart"], m["sorted_to_build"], total, total)
            cols = selection.gather(p, pi) + \
                J.gather_build_side(plan["b"], brow, matched)
            if self.join_type == "full":
                u = next(host)
                un = selection.gather(plan["b"], plan["uperm"][:u])
                nulls = [ColVal(c.dtype,
                                torch.zeros(u, dtype=torch_dtype(c.dtype),
                                            device=device),
                                torch.zeros(u, dtype=torch.bool,
                                            device=device)) for c in p]
                cols = [J._concat_col(a, b) for a, b in zip(cols, nulls + un)]
                total += u
            outs.append(cols)
            counts.append(total)
        return outs, counts

