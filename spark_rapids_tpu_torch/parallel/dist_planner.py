"""Distributed planner: run logical plans over the session's shard group.

Counterpart of ``spark_rapids_tpu/parallel/dist_planner.py``.  When the
session holds a shard group (``spark.rapids.sql.distributed.numShards``
or a ``process_group``), every collected plan is offered here first; a
plan this planner can lower runs as a chain of :class:`ShardedFrame`
transforms, anything else falls back to the single-device engine with the
reason on ``session.last_dist_explain``, as in the JAX package.

The planner is an eager executor with a dry mode: the same recursion
first runs with ``dry=True`` (schemas only, no data), so an unsupported
plan falls back before any scan runs; the second pass executes.

Lowered here: the in-memory scan of numeric, boolean, date and timestamp
columns (shard ``s`` takes the contiguous ``base + (s < rem)`` rows, as in
the JAX package), Filter, Project, Filter/Project chains fused into one
stage and into the aggregate above them, Aggregate, equi-Join, Sort,
Limit over Sort (TopN), Limit, and ``collect``.  String columns raise
``NotDistributable``: the JAX package dictionary-encodes them at the scan,
which is not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import Column
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.config import rapids_conf as rc
from spark_rapids_tpu_torch.ops import selection
from spark_rapids_tpu_torch.ops.compiler import check_raise, widen
from spark_rapids_tpu_torch.ops.expressions import (
    Alias, BoundReference, ColVal, EmitContext, Expression, fold_conjuncts,
    substitute_bound)
from spark_rapids_tpu_torch.parallel.distributed import (
    DistributedAggregate, DistributedHashJoin, cut)
from spark_rapids_tpu_torch.parallel.distsort import (
    DistributedSort, DistributedTopN)
from spark_rapids_tpu_torch.parallel.mesh import Shard, ShardGroup
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.utils import hostsync


class NotDistributable(Exception):
    """The plan (or an expression) has no lowering onto the shard group;
    the query falls back to the single-device engine with this reason."""


class ShardedFrame:
    """Per-shard column lists (exact length) and host row counts, for the
    shards this process holds (``group.local_shards``).  A dry frame (the
    support pre-flight) has schema only."""

    def __init__(self, group: ShardGroup, names: List[str],
                 dtypes: List[DataType],
                 shards: Optional[List[Shard]] = None,
                 nrows: Optional[List[int]] = None):
        self.group = group
        self.names = list(names)
        self.dtypes = list(dtypes)
        self.shards = shards
        self.nrows = nrows

    @property
    def dry(self) -> bool:
        return self.shards is None

    @property
    def schema(self) -> List[Tuple[str, DataType]]:
        return list(zip(self.names, self.dtypes))


def _check_supported(exprs: Sequence[Expression]) -> None:
    """Every expression node must be fixed-width: strings have no
    encoding on the sharded path yet."""
    def walk(e):
        if e.dtype.is_string:
            raise NotDistributable(
                f"string expression {e.name!r} has no sharded lowering "
                "(dictionary-encoded strings are not ported)")
        for c in e.children:
            walk(c)
    for e in exprs:
        walk(e)


def _refs(schema) -> List[Expression]:
    return [BoundReference(i, dt, name=n)
            for i, (n, dt) in enumerate(schema)]


def _coalesce(a: ColVal, b: ColVal) -> ColVal:
    """Full-outer USING key: the left value where present, else the
    right."""
    if a.validity is None:
        return a
    vals = torch.where(a.validity, a.values, b.values)
    valid = None if b.validity is None else a.validity | b.validity
    return ColVal(a.dtype, vals, valid)


class DistPlanner:
    """Eager recursive executor with a dry pre-flight mode."""

    def __init__(self, session, group: ShardGroup):
        self.session = session
        self.group = group
        self.conf = session.conf
        self.device = group.device
        self.fusion = bool(self.conf.get(rc.FUSION_ENABLED))
        self.broadcast_rows = self.conf.get(rc.BROADCAST_JOIN_THRESHOLD_ROWS)
        # each exchange-bearing operator's last_stats, in execution order
        self.stats: List[Tuple[str, dict]] = []

    # -- recursion --------------------------------------------------------
    def run(self, plan: L.LogicalPlan, dry: bool) -> ShardedFrame:
        if isinstance(plan, L.InMemoryRelation):
            return self._scan(plan, dry)
        if isinstance(plan, L.Aggregate):
            return self._aggregate(plan, dry)
        if isinstance(plan, (L.Filter, L.Project)):
            return self._chain(plan, dry)
        if isinstance(plan, L.Join):
            return self._join(plan, dry)
        if isinstance(plan, L.Sort):
            return self._sort(plan, dry)
        if isinstance(plan, L.Limit):
            if isinstance(plan.child, L.Sort):
                return self._topn(plan, dry)
            return self._limit(plan, dry)
        raise NotDistributable(
            f"{type(plan).__name__} has no distributed lowering")

    def _frame(self, schema, shards=None, nrows=None) -> ShardedFrame:
        return ShardedFrame(self.group, [n for n, _ in schema],
                            [dt for _, dt in schema], shards, nrows)

    # -- scan -------------------------------------------------------------
    def _scan(self, plan: L.InMemoryRelation, dry: bool) -> ShardedFrame:
        for name, dt in plan.schema:
            if dt.is_string:
                raise NotDistributable(
                    f"scan column {name!r} is a string: dictionary-encoded "
                    "strings are not ported to the sharded path")
        if dry:
            return self._frame(plan.schema)
        from spark_rapids_tpu_torch.ops.concat import concat_batches
        batches = plan.batches
        merged = (concat_batches(batches) if len(batches) > 1
                  else batches[0]) if batches else None
        total = merged.nrows if merged is not None else 0
        nshards = self.group.nshards
        base, rem = divmod(total, nshards)
        counts = [base + (1 if s < rem else 0) for s in range(nshards)]
        offsets = [sum(counts[:s]) for s in range(nshards)]
        shards, nrows = [], []
        for s in self.group.local_shards:
            off, n = offsets[s], counts[s]
            cols = []
            for name, dt in plan.schema:
                if merged is None:
                    from spark_rapids_tpu_torch.columnar.dtypes import \
                        torch_dtype
                    cols.append(ColVal(dt, torch.zeros(
                        0, dtype=torch_dtype(dt), device=self.device)))
                    continue
                c = merged.column(name)
                if c.device != self.device:
                    raise NotDistributable(
                        f"scan column {name!r} is on {c.device}, the shard "
                        f"group on {self.device}")
                cols.append(ColVal(dt, c.data[off:off + n],
                                   None if c.validity is None
                                   else c.validity[off:off + n]))
            shards.append(cols)
            nrows.append(n)
        return self._frame(plan.schema, shards, nrows)

    # -- per-shard stages -------------------------------------------------
    def _stage(self, f: ShardedFrame, exprs: Sequence[Expression],
               conds: Sequence[Expression], schema) -> ShardedFrame:
        """``exprs`` over every shard, with the ``conds`` (bottom-first)
        as one row mask and one compaction: one stage for a fused
        Filter/Project chain.  Every shard's kept count comes back in one
        counted fetch."""
        outs, plans = [], []
        for cols, n in zip(f.shards, f.nrows):
            ctx = EmitContext(cols, n, n, self.device)
            keep = fold_conjuncts(ctx, conds) if conds else None
            vals = [widen(e.emit(ctx), n) for e in exprs]
            check_raise(ctx)
            outs.append(vals)
            if keep is not None:
                plans.append(selection.compact_plan(keep))
        if not conds:
            return self._frame(schema, outs, list(f.nrows))
        kept = [int(k) for k in hostsync.fetch_all([k for _, k in plans])]
        shards = [selection.gather(vals, perm[:k])
                  for vals, (perm, _), k in zip(outs, plans, kept)]
        return self._frame(schema, shards, kept)

    def _chain_members(self, plan):
        members = []
        node = plan
        while isinstance(node, (L.Filter, L.Project)):
            members.append(node)
            node = node.child
        return members, node

    def _chain(self, plan, dry: bool) -> ShardedFrame:
        """A Filter/Project chain: one fused stage when fusion is on (a
        single member is its own stage), else one stage per member."""
        from spark_rapids_tpu_torch.exec.fusion import compose_chain
        members, tail = self._chain_members(plan)
        if not self.fusion:
            members, tail = [plan], plan.child
        exprs, conds = None, []
        for node in members:
            exprs, conds = compose_chain(exprs, conds, node,
                                         node.child.schema)
        _check_supported(list(exprs) + list(conds))
        f = self.run(tail, dry)
        if dry:
            return self._frame(plan.schema)
        return self._stage(f, exprs, conds, plan.schema)

    # -- aggregate --------------------------------------------------------
    def _aggregate(self, plan: L.Aggregate, dry: bool) -> ShardedFrame:
        """Aggregate, with the Filter/Project chain below it folded in:
        projections substitute into the key and aggregate expressions,
        predicates become the partial aggregate's row mask."""
        from spark_rapids_tpu_torch.plan.overrides import aggregate_outputs
        group = list(plan.group_exprs)
        aggs = list(plan.agg_exprs)
        conds: List[Expression] = []
        tail = plan.child
        while self.fusion and isinstance(tail, (L.Filter, L.Project)):
            if isinstance(tail, L.Project):
                repl = tail.exprs
                group = [substitute_bound(e, repl) for e in group]
                aggs = [substitute_bound(e, repl) for e in aggs]
                conds = [substitute_bound(c, repl) for c in conds]
            else:
                conds = [tail.condition] + conds
            tail = tail.child
        try:
            agg_list, out_named, trivial = aggregate_outputs(group, aggs)
        except ValueError as e:
            raise NotDistributable(str(e)) from e
        _check_supported(group + list(agg_list) + conds)
        f = self.run(tail, dry)
        if dry:
            return self._frame(plan.schema)
        dist = DistributedAggregate(self.group, f.dtypes, group,
                                    [a.func for a in agg_list],
                                    filter_cond=conds or None)
        shards, nrows = dist(f.shards, f.nrows)
        self.stats.append(("aggregate", dist.last_stats))
        nkeys = len(group)
        if trivial:
            return self._frame(plan.schema, shards, nrows)
        agg_schema = plan.schema[:nkeys] + [
            (f"_a{i}", a.dtype) for i, a in enumerate(agg_list)]
        proj = _refs(agg_schema[:nkeys]) + [
            Alias(rewritten, name) for name, rewritten in out_named]
        return self._stage(self._frame(agg_schema, shards, nrows), proj, [],
                           plan.schema)

    # -- join -------------------------------------------------------------
    def _key_columns(self, f: ShardedFrame, keys: Sequence[Expression]):
        """(frame, key ordinals): a bare column key is read in place, any
        other key expression is materialized as a trailing column."""
        if all(isinstance(k, BoundReference) for k in keys):
            return f, [k.ordinal for k in keys]
        extra = [(f"__k{i}", k.dtype) for i, k in enumerate(keys)]
        g = self._stage(f, _refs(f.schema) + list(keys), [],
                        f.schema + extra)
        return g, list(range(len(f.names), len(f.names) + len(keys)))

    def _join(self, plan: L.Join, dry: bool) -> ShardedFrame:
        if not plan.left_keys or plan.join_type == "cross":
            raise NotDistributable(
                "cross joins have no distributed lowering")
        _check_supported(plan.left_keys + plan.right_keys)
        left = self.run(plan.left, dry)
        right = self.run(plan.right, dry)
        if dry:
            return self._frame(plan.schema)
        swapped = plan.join_type == "right"
        join_type = "left" if swapped else plan.join_type
        if swapped:
            probe, build = right, left
            pkeys, bkeys = plan.right_keys, plan.left_keys
        else:
            probe, build = left, right
            pkeys, bkeys = plan.left_keys, plan.right_keys
        probe_m, pk_idx = self._key_columns(probe, pkeys)
        build_m, bk_idx = self._key_columns(build, bkeys)
        dist = DistributedHashJoin(
            self.group, probe_m.dtypes, build_m.dtypes, pk_idx, bk_idx,
            join_type, broadcast_threshold_rows=self.broadcast_rows)
        outs, nrows = dist(probe_m.shards, probe_m.nrows, build_m.shards,
                           build_m.nrows)
        self.stats.append((f"join:{plan.join_type}", dist.last_stats))
        np_, nb = len(probe.names), len(build.names)
        shards = []
        for out in outs:
            if plan.join_type in ("semi", "anti"):
                shards.append(out[:np_])
                continue
            pcols = out[:np_]
            bcols = out[len(probe_m.names): len(probe_m.names) + nb]
            lcols, rcols = (bcols, pcols) if swapped else (pcols, bcols)
            shards.append(self._stitch(plan, left.names, right.names,
                                       lcols, rcols, swapped))
        return self._frame(plan.schema, shards, nrows)

    @staticmethod
    def _stitch(plan: L.Join, lnames, rnames, lcols, rcols, swapped):
        """Output columns in the join's schema order: USING joins keep one
        key column, which the preserved side supplies (both sides
        coalesced for a full join)."""
        if not plan.using:
            return list(lcols) + list(rcols)
        keyset = set(plan.using)
        out = []
        for i, n in enumerate(lnames):
            if n not in keyset:
                continue
            lc, rc_ = lcols[i], rcols[rnames.index(n)]
            if plan.join_type == "full":
                out.append(_coalesce(lc, rc_))
            else:
                out.append(rc_ if swapped else lc)
        out += [c for n, c in zip(lnames, lcols) if n not in keyset]
        out += [c for n, c in zip(rnames, rcols) if n not in keyset]
        return out

    # -- sort / limit / topn ---------------------------------------------
    def _orders(self, orders):
        keys = [e for e, _, _ in orders]
        _check_supported(keys)
        return keys, [d for _, d, _ in orders], [nf for _, _, nf in orders]

    def _sort(self, plan: L.Sort, dry: bool) -> ShardedFrame:
        keys, desc, nf = self._orders(plan.orders)
        f = self.run(plan.child, dry)
        if dry:
            return f
        dist = DistributedSort(self.group, f.dtypes, keys, desc, nf)
        shards, nrows = dist(f.shards, f.nrows)
        self.stats.append(("sort", dist.last_stats))
        return self._frame(f.schema, shards, nrows)

    def _topn(self, plan: L.Limit, dry: bool) -> ShardedFrame:
        sort = plan.child
        keys, desc, nf = self._orders(sort.orders)
        f = self.run(sort.child, dry)
        if dry:
            return f
        dist = DistributedTopN(self.group, f.dtypes, keys, desc, nf, plan.n)
        shards, nrows = dist(f.shards, f.nrows)
        self.stats.append(("topn", dist.last_stats))
        return self._frame(f.schema, shards, nrows)

    def _limit(self, plan: L.Limit, dry: bool) -> ShardedFrame:
        f = self.run(plan.child, dry)
        if dry:
            return f
        counts = self.group.all_counts(f.nrows)
        shards, nrows = [], []
        for cols, s in zip(f.shards, self.group.local_shards):
            before = int(counts[:s].sum())
            take = max(0, min(int(counts[s]), plan.n - before))
            shards.append(cut(cols, take))
            nrows.append(take)
        return self._frame(f.schema, shards, nrows)

    # -- collect ----------------------------------------------------------
    def collect(self, f: ShardedFrame) -> ColumnarBatch:
        """Every shard's rows, in shard order, as one batch on the
        session's device."""
        total = int(self.group.all_counts(f.nrows).sum())
        cols = self.group.all_gather(f.shards) if f.names else []
        out: Dict[str, Column] = {}
        for (name, dt), c in zip(f.schema, cols):
            out[name] = Column(dt, c.values.contiguous(), total,
                               validity=None if c.validity is None
                               else c.validity.contiguous())
        return ColumnarBatch(out, total)


def try_distributed(session, plan: L.LogicalPlan):
    """Entry point from DataFrame execution: a list holding one batch when
    the plan ran on the session's shard group, else None (single-device
    fallback, reason on ``session.last_dist_explain``)."""
    group = getattr(session, "shards", None)
    if group is None:
        return None
    session.last_dist_stats = None
    if not session.conf.get(rc.DISTRIBUTED_ENABLED):
        session.last_dist_explain = "distributed disabled by conf"
        return None
    planner = DistPlanner(session, group)
    try:
        planner.run(plan, dry=True)  # support pre-flight: no data moves
        batch = planner.collect(planner.run(plan, dry=False))
    except NotDistributable as e:
        session.last_dist_explain = f"fallback: {e}"
        return None
    session.last_dist_explain = "distributed"
    session.last_dist_stats = planner.stats
    return [batch]
