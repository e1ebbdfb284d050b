"""Distributed planner: run logical plans over the session's shard group.

Counterpart of ``spark_rapids_tpu/parallel/dist_planner.py``.  When the
session holds a shard group (``spark.rapids.sql.distributed.numShards``
or a ``process_group``), every collected plan is offered here first; a
plan this planner can lower runs as a chain of :class:`ShardedFrame`
transforms, anything else falls back to the single-device engine with the
reason on ``session.last_dist_explain``, as in the JAX package.

The planner is an eager executor with a dry mode: the same recursion
first runs with ``dry=True`` (schemas and empty dictionaries only, no
data), so an unsupported plan falls back before any scan runs; the second
pass executes.

Strings travel as int64 codes into one sorted dictionary per column on
the session's device (``parallel/dict_lowering.py``): the scan encodes
the string columns the plan reads, expressions lower to code space,
joins on string keys remap the probe side's codes into the build side's
dictionary, and ``collect`` decodes.

Lowered here: the scans (an in-memory relation, shard ``s`` taking the
contiguous ``base + (s < rem)`` rows as in the JAX package; parquet and
ORC files sharded by their footers' row counts; anything else read once
and scattered), Filter, Project, Filter/Project chains fused into one
stage and into the aggregate above them, Aggregate, equi-Join (with a
residual on inner joins), Sort, Limit over Sort (TopN), Limit, Union of
fixed-width columns, and ``collect``.  Columns the plan never reads
(``plan/overrides._pushdown_pass``) are not encoded or moved: they
travel as zero-stride placeholders.  Not lowered: Window, Expand and
Generate, Union over strings, a full outer USING join on string keys,
user code (a Python or torch UDF, a pandas node) and a cached plan.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import Column
from spark_rapids_tpu_torch.columnar.dtypes import DataType, torch_dtype
from spark_rapids_tpu_torch.config import rapids_conf as rc
from spark_rapids_tpu_torch.ops import dictionary, selection
from spark_rapids_tpu_torch.ops.compiler import check_raise, widen
from spark_rapids_tpu_torch.ops.dictionary import (
    SortedDictionary, StableDictionary)
from spark_rapids_tpu_torch.ops.expressions import (
    Alias, BoundReference, ColVal, EmitContext, Expression, fold_conjuncts,
    substitute_bound)
from spark_rapids_tpu_torch.parallel.dict_lowering import (
    ExprLowering, NotDistributable, check_supported, phys_dtype)
from spark_rapids_tpu_torch.parallel.distributed import (
    DistributedAggregate, DistributedHashJoin, cut)
from spark_rapids_tpu_torch.parallel.distsort import (
    DistributedSort, DistributedTopN)
from spark_rapids_tpu_torch.parallel.mesh import Shard, ShardGroup
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.utils import hostsync

__all__ = ["DistPlanner", "NotDistributable", "ShardedFrame",
           "try_distributed"]


class _UnsplittableScan(Exception):
    """The file list cannot be sharded (a format without footer row
    counts, no listable files, a group of several processes): the scan
    reads the relation once and scatters it instead."""


def _file_row_bound(path: str, fmt: str) -> Optional[int]:
    """A file's row count from its footer (parquet, ORC), an upper bound
    on its rows after pushdown; None when it cannot be read."""
    try:
        if fmt == "parquet":
            import pyarrow.parquet as pq
            return int(pq.ParquetFile(path).metadata.num_rows)
        if fmt == "orc":
            from pyarrow import orc
            return int(orc.ORCFile(path).nrows)
    except Exception:
        return None
    return None


class ShardedFrame:
    """Per-shard column lists (exact length) and host row counts, for the
    shards this process holds (``group.local_shards``).  ``dtypes`` are
    the logical types; an ordinal in ``enc`` is a string column travelling
    as int64 codes into its dictionary, and an ordinal in ``pruned`` is a
    column no operator above reads, carried as a zero-stride placeholder.
    A dry frame (the support pre-flight) has no data and empty
    dictionaries."""

    def __init__(self, group: ShardGroup, names: List[str],
                 dtypes: List[DataType],
                 shards: Optional[List[Shard]] = None,
                 nrows: Optional[List[int]] = None,
                 enc: Optional[Dict[int, SortedDictionary]] = None,
                 pruned: Set[int] = frozenset()):
        self.group = group
        self.names = list(names)
        self.dtypes = list(dtypes)
        self.shards = shards
        self.nrows = nrows
        self.enc = dict(enc or {})
        self.pruned = frozenset(pruned)

    @property
    def dry(self) -> bool:
        return self.shards is None

    @property
    def schema(self) -> List[Tuple[str, DataType]]:
        return list(zip(self.names, self.dtypes))

    @property
    def phys_dtypes(self) -> List[DataType]:
        return [phys_dtype(dt) for dt in self.dtypes]

    @property
    def live(self) -> List[int]:
        """Ordinals of the columns that hold data."""
        return [i for i in range(len(self.names)) if i not in self.pruned]


def _refs(schema) -> List[Expression]:
    return [BoundReference(i, dt, name=n)
            for i, (n, dt) in enumerate(schema)]


def _placeholder(dt: DataType, n: int, device) -> ColVal:
    """A pruned column of ``n`` rows: one zero, broadcast."""
    pdt = phys_dtype(dt)
    return ColVal(pdt, torch.zeros((), dtype=torch_dtype(pdt),
                                   device=device).expand(n))


def _bare_ordinal(e: Expression) -> Optional[int]:
    inner = e.children[0] if isinstance(e, Alias) else e
    return inner.ordinal if isinstance(inner, BoundReference) else None


def _coalesce(a: ColVal, b: ColVal) -> ColVal:
    """Full-outer USING key: the left value where present, else the
    right."""
    if a.validity is None:
        return a
    vals = torch.where(a.validity, a.values, b.values)
    valid = None if b.validity is None else a.validity | b.validity
    return ColVal(a.dtype, vals, valid)


def _concat_cols(parts: Sequence[ColVal], dtype: DataType) -> ColVal:
    """One column of several parts, in order (a Union's shard, a file
    shard's batches)."""
    tdt = torch_dtype(dtype)
    if len(parts) == 1 and parts[0].values.dtype == tdt:
        return ColVal(dtype, parts[0].values, parts[0].validity)
    vals = torch.cat([p.values.to(tdt).reshape(-1) for p in parts])
    valid = None
    if any(p.validity is not None for p in parts):
        valid = torch.cat([
            p.validity if p.validity is not None else torch.ones(
                p.values.shape[0], dtype=torch.bool, device=p.values.device)
            for p in parts])
    return ColVal(dtype, vals, valid)


class DistPlanner:
    """Eager recursive executor with a dry pre-flight mode."""

    def __init__(self, session, group: ShardGroup, resume: bool = False):
        self.session = session
        self.group = group
        self.conf = session.conf
        self.device = group.device
        self.fusion = bool(self.conf.get(rc.FUSION_ENABLED))
        self.broadcast_rows = self.conf.get(rc.BROADCAST_JOIN_THRESHOLD_ROWS)
        # each exchange-bearing operator's last_stats, in execution order
        self.stats: List[Tuple[str, dict]] = []
        # stage-checkpoint lineage (robustness/checkpoint.py): the
        # manager the query's envelope installed (None when off), and
        # whether this attempt restores from it (a retry-class
        # re-attempt; every attempt for the shared stage store, whose
        # stage ids fold in the input fingerprint)
        self._ckpt = getattr(session, "checkpoints", None)
        self._fp_inputs = bool(getattr(self._ckpt, "always_resume", False))
        self._resume = self._ckpt is not None and self._ckpt.enabled and \
            (bool(resume) or self._fp_inputs)
        # each scan's input fingerprint, once per planner run
        self._fp_memo: Dict[int, str] = {}

    @staticmethod
    def _checkpointable(plan: L.LogicalPlan) -> bool:
        """Stage boundaries worth checkpointing: every exchange consumer
        (no sharded Window yet), and top-N (a Limit over a Sort, one
        distributed pass of its own)."""
        if isinstance(plan, (L.Aggregate, L.Join, L.Sort)):
            return True
        return isinstance(plan, L.Limit) and isinstance(plan.child, L.Sort)

    def _count_stages(self, plan: L.LogicalPlan) -> int:
        """Exchange stages inside a subtree: what a resume of its
        checkpoint saves (CheckpointResume.stagesSaved)."""
        n = 1 if self._checkpointable(plan) else 0
        return n + sum(self._count_stages(c) for c in plan.children)

    # -- recursion --------------------------------------------------------
    def run(self, plan: L.LogicalPlan, dry: bool) -> ShardedFrame:
        """Execute (or dry-run) one subtree, splicing in and registering
        stage checkpoints at exchange boundaries: on a resume attempt a
        completed subtree restores from the lineage log (its scans,
        stages and exchanges never run), and each freshly completed
        stage registers its frame for the next attempt.  A checkpoint
        that fails its stamp or was evicted is dropped by the manager and
        the subtree re-runs here."""
        if not dry and isinstance(plan, (L.Aggregate, L.Join, L.Sort)):
            # fair-interleaver stage boundary: a sharded query's
            # "batches" are its exchange stages (serving/scheduler.py; a
            # no-op unless the interleave knob is on)
            from spark_rapids_tpu_torch.serving.scheduler import (
                yield_current)
            yield_current(self.session)
        if dry or self._ckpt is None or not self._ckpt.enabled or \
                not self._checkpointable(plan):
            return self._dispatch(plan, dry)
        from spark_rapids_tpu_torch.robustness import checkpoint as cp
        from spark_rapids_tpu_torch.utils import tracing
        sid = cp.stage_id(plan, self.group, memo=self._fp_memo,
                          inputs=self._fp_inputs)
        if self._resume:
            frame = self._ckpt.restore(sid, self.group)
            if frame is not None:
                return frame
        if tracing._armed:
            # one span per stage, keyed by its stage id
            with tracing.span("stage.dist", site=sid,
                              op=type(plan).__name__):
                frame = self._dispatch(plan, dry)
        else:
            frame = self._dispatch(plan, dry)
        # the JAX package resolves its async exchange window here, so no
        # unverified exchange enters the log; the port's exchanges are
        # synchronous (parallel/exchange_async.py is not ported)
        self._ckpt.save(sid, frame, stages=self._count_stages(plan),
                        pins=cp.inmemory_batches(plan)
                        if self._fp_inputs else ())
        return frame

    def _dispatch(self, plan: L.LogicalPlan, dry: bool) -> ShardedFrame:
        if isinstance(plan, (L.InMemoryRelation, L.FileRelation, L.Range)):
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
        if isinstance(plan, L.Union):
            return self._union(plan, dry)
        raise NotDistributable(
            f"{type(plan).__name__} has no distributed lowering")

    def _frame(self, schema, shards=None, nrows=None, enc=None,
               pruned=frozenset()) -> ShardedFrame:
        return ShardedFrame(self.group, [n for n, _ in schema],
                            [dt for _, dt in schema], shards, nrows, enc,
                            pruned)

    def _lowering(self, f: ShardedFrame) -> ExprLowering:
        return ExprLowering(f.enc, self.device, f.dry, f.pruned, self.conf)

    # -- scan -------------------------------------------------------------
    def _scan(self, plan: L.LogicalPlan, dry: bool) -> ShardedFrame:
        schema = list(plan.schema)
        required = getattr(plan, "required_columns", None)
        read = [i for i, (n, _) in enumerate(schema)
                if required is None or n in required]
        pruned = frozenset(range(len(schema))) - set(read)
        if dry:
            return self._frame(schema, enc={
                i: SortedDictionary.empty(self.device) for i in read
                if schema[i][1].is_string}, pruned=pruned)
        if isinstance(plan, L.InMemoryRelation):
            return self._scatter(schema, plan.batches, read, pruned)
        if isinstance(plan, L.FileRelation) and \
                plan.file_format in ("parquet", "orc"):
            try:
                return self._scan_sharded_files(plan, schema, read, pruned)
            except _UnsplittableScan:
                pass
        return self._scatter(schema, list(self._relation_exec(plan)
                                          .execute()), read, pruned)

    def _relation_exec(self, plan):
        """The single-device scan of a file relation or a range, planned
        without the pushdown pass (which ran over the whole plan and set
        the relation's columns and filters)."""
        if isinstance(plan, L.FileRelation):
            return self.session.overrides._file_scan(plan)
        from spark_rapids_tpu_torch.exec.basic import TpuRangeExec
        return TpuRangeExec(plan.start, plan.end, plan.step, self.device)

    def _scatter(self, schema, batches, read, pruned) -> ShardedFrame:
        """Rows held in one place, scattered: shard ``s`` takes the
        contiguous ``base + (s < rem)`` rows.  Every string column read
        encodes over all the rows (``encode_sorted``), so every process
        of a group derives the same dictionaries from the same rows."""
        from spark_rapids_tpu_torch.ops.concat import concat_batches
        names = [schema[i][0] for i in read]
        parts = [ColumnarBatch({n: b.column(n) for n in names}, b.row_count)
                 for b in batches]
        merged = (concat_batches(parts) if len(parts) > 1 else parts[0]) \
            if parts and names else None
        total = sum(b.nrows for b in batches)
        nshards = self.group.nshards
        base, rem = divmod(total, nshards)
        counts = [base + (1 if s < rem else 0) for s in range(nshards)]
        offsets = [sum(counts[:s]) for s in range(nshards)]
        whole: Dict[int, ColVal] = {}
        enc: Dict[int, SortedDictionary] = {}
        for i in read:
            name, dt = schema[i]
            if merged is None:  # no rows
                whole[i] = ColVal(phys_dtype(dt), torch.zeros(
                    0, dtype=torch_dtype(phys_dtype(dt)), device=self.device))
                if dt.is_string:
                    enc[i] = SortedDictionary.empty(self.device)
                continue
            c = merged.column(name)
            if c.device != self.device:
                raise NotDistributable(
                    f"scan column {name!r} is on {c.device}, the shard "
                    f"group on {self.device}")
            validity = None if c.validity is None else c.validity[:total]
            if dt.is_string:
                values, enc[i] = dictionary.encode_sorted(c, total)
            else:
                values = c.data[:total]
            whole[i] = ColVal(phys_dtype(dt), values, validity)
        shards, nrows = [], []
        for s in self.group.local_shards:
            off, n = offsets[s], counts[s]
            cols = []
            for i, (_, dt) in enumerate(schema):
                if i in pruned:
                    cols.append(_placeholder(dt, n, self.device))
                    continue
                c = whole[i]
                cols.append(ColVal(c.dtype, c.values[off:off + n],
                                   None if c.validity is None
                                   else c.validity[off:off + n]))
            shards.append(cols)
            nrows.append(n)
        return self._frame(schema, shards, nrows, enc, pruned)

    def _scan_sharded_files(self, plan: L.FileRelation, schema, read,
                            pruned) -> ShardedFrame:
        """The file list sharded over the group: files go to shards
        longest first by their footers' row counts, and each shard reads
        its own files through the port's scan (the relation's pushed
        filters and columns), one shard after another, so the host holds
        at most one shard's decoded rows.  Each string column shares one
        first-seen dictionary across the shards (``StableDictionary``,
        on the card up to 256-byte strings), remapped at the end to the
        sorted codes the rest of the path expects."""
        from spark_rapids_tpu_torch.io.readers import _dataset
        group = self.group
        if len(group.local_shards) != group.nshards:
            raise _UnsplittableScan("a group of several processes")
        files = list(getattr(_dataset(plan.paths, plan.file_format),
                             "files", None) or [])
        if not files:
            raise _UnsplittableScan("no listable files")
        bounds = [_file_row_bound(f, plan.file_format) for f in files]
        if any(b is None for b in bounds):
            raise _UnsplittableScan("row counts unavailable")
        nshards = group.nshards
        shard_files: List[List[str]] = [[] for _ in range(nshards)]
        shard_bound = np.zeros(nshards, dtype=np.int64)
        for i in sorted(range(len(files)), key=lambda i: -bounds[i]):
            s = int(np.argmin(shard_bound))
            shard_files[s].append(files[i])
            shard_bound[s] += bounds[i]
        dicts = {i: StableDictionary() for i in read
                 if schema[i][1].is_string}
        shards, nrows = [], []
        peak = 0
        for s in range(nshards):
            batches = []
            if shard_files[s]:
                sub = L.FileRelation(shard_files[s], plan.file_format,
                                     plan._schema, plan.options,
                                     plan.bucket_spec)
                sub.pushed_filters = list(plan.pushed_filters)
                sub.required_columns = plan.required_columns
                sub.file_meta = set(plan.file_meta)
                batches = list(self.session.overrides._file_scan(sub)
                               .execute())
            rows = sum(b.nrows for b in batches)
            peak = max(peak, rows)
            cols = []
            for i, (name, dt) in enumerate(schema):
                if i in pruned:
                    cols.append(_placeholder(dt, rows, self.device))
                    continue
                vals, valid = [], []
                for b in batches:
                    c, nb = b.column(name), b.nrows
                    vals.append(dicts[i].encode(c, nb, null_code=0)
                                if i in dicts else c.data[:nb])
                    valid.append(None if c.validity is None
                                 else c.validity[:nb])
                cols.append(_concat_cols(
                    [ColVal(phys_dtype(dt), v, m)
                     for v, m in zip(vals, valid)], phys_dtype(dt))
                    if batches else ColVal(phys_dtype(dt), torch.zeros(
                        0, dtype=torch_dtype(phys_dtype(dt)),
                        device=self.device)))
            shards.append(cols)
            nrows.append(rows)
            del batches  # this shard's decoded tables are placed
        enc = {}
        for i, d in dicts.items():
            rank, enc[i] = d.sorted(self.device)
            for cols in shards:
                c = cols[i]
                if not len(enc[i]):
                    continue
                codes = rank[c.values]
                if c.validity is not None:
                    codes = torch.where(c.validity, codes,
                                        torch.zeros_like(codes))
                cols[i] = ColVal(c.dtype, codes, c.validity)
        self._note_scan(files=len(files), peak_host_rows=int(peak),
                        total_rows=int(sum(nrows)),
                        shard_bound_rows=int(shard_bound.max()))
        return self._frame(schema, shards, nrows, enc, pruned)

    def _note_scan(self, **scan) -> None:
        """Fold one sharded file scan into ``session.last_scan_stats``
        (the query's scans: files and rows summed, the largest shard's
        decoded rows and footer rows the maxima)."""
        st = self.session.last_scan_stats
        if st is None:
            st = self.session.last_scan_stats = {
                "sharded_files": True, "scans": 0, "files": 0,
                "peak_host_rows": 0, "total_rows": 0,
                "shard_bound_rows": 0}
        st["scans"] += 1
        for key in ("files", "total_rows"):
            st[key] += scan[key]
        for key in ("peak_host_rows", "shard_bound_rows"):
            st[key] = max(st[key], scan[key])

    # -- per-shard stages -------------------------------------------------
    def _lower_outputs(self, low: ExprLowering, f: ShardedFrame,
                       exprs: Sequence[Expression]):
        """(lowered exprs with None for a pruned column passed through,
        their dictionaries, the pruned output ordinals)."""
        out, enc, pruned = [], {}, set()
        for i, e in enumerate(exprs):
            o = _bare_ordinal(e)
            if o is not None and o in f.pruned:
                out.append(None)
                pruned.add(i)
                continue
            le = low.lower(e)
            out.append(le)
            d = low.out_dict(le)
            if d is not None:
                enc[i] = d
        return out, enc, pruned

    def _stage(self, f: ShardedFrame, exprs: Sequence[Optional[Expression]],
               conds: Sequence[Expression], schema, enc,
               pruned=frozenset()) -> ShardedFrame:
        """Lowered ``exprs`` (None: a placeholder) over every shard, with
        the lowered ``conds`` (bottom-first) as one row mask and one
        compaction: one stage for a fused Filter/Project chain.  Every
        shard's kept count comes back in one counted fetch."""
        dtypes = [dt for _, dt in schema]
        outs, plans = [], []
        for cols, n in zip(f.shards, f.nrows):
            ctx = EmitContext(cols, n, n, self.device)
            keep = fold_conjuncts(ctx, conds) if conds else None
            vals = [None if e is None else widen(e.emit(ctx), n)
                    for e in exprs]
            check_raise(ctx)
            outs.append(vals)
            if keep is not None:
                plans.append(selection.compact_plan(keep))
        if conds:
            kept = [int(k) for k in hostsync.fetch_all([k for _, k in plans])]
            outs = [self._gather_live(vals, perm[:k])
                    for vals, (perm, _), k in zip(outs, plans, kept)]
        else:
            kept = list(f.nrows)
        shards = [[_placeholder(dt, k, self.device) if v is None else v
                   for v, dt in zip(vals, dtypes)]
                  for vals, k in zip(outs, kept)]
        return self._frame(schema, shards, kept, enc, pruned)

    @staticmethod
    def _gather_live(vals, idx):
        live = [v for v in vals if v is not None]
        got = iter(selection.gather(live, idx))
        return [None if v is None else next(got) for v in vals]

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
        f = self.run(tail, dry)
        low = self._lowering(f)
        lexprs, enc, pruned = self._lower_outputs(low, f, exprs)
        lconds = [low.lower(c) for c in conds]
        check_supported([e for e in lexprs if e is not None] + lconds,
                        self.conf)
        if dry:
            return self._frame(plan.schema, enc=enc, pruned=pruned)
        return self._stage(f, lexprs, lconds, plan.schema, enc, pruned)

    # -- aggregate --------------------------------------------------------
    def _aggregate(self, plan: L.Aggregate, dry: bool) -> ShardedFrame:
        """Aggregate, with the Filter/Project chain below it folded in:
        projections substitute into the key and aggregate expressions,
        predicates become the partial aggregate's row mask.  Encoded group
        keys and min/max over codes keep their dictionaries, through the
        result projection too; a keyless min/max over a string is one
        code on shard 0, decoded at collect."""
        from spark_rapids_tpu_torch.ops import aggregates as agg
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
        f = self.run(tail, dry)
        low = self._lowering(f)
        lgroup = [low.lower(e) for e in group]
        laggs = [low.lower_agg(a) for a in agg_list]
        lconds = [low.lower(c) for c in conds]
        check_supported(lgroup + laggs + lconds, self.conf)
        nkeys = len(group)
        agg_enc = {}
        for i, ge in enumerate(lgroup):
            d = low.out_dict(ge)
            if d is not None:
                agg_enc[i] = d
        for j, a in enumerate(laggs):
            if isinstance(a.func, (agg.Min, agg.Max)) and \
                    a.func.child is not None:
                d = low.out_dict(a.func.child)
                if d is not None:
                    agg_enc[nkeys + j] = d
        agg_schema = plan.schema[:nkeys] + [
            (f"_a{i}", a.dtype) for i, a in enumerate(agg_list)]
        if trivial:
            out_schema, proj, penc = plan.schema, None, agg_enc
        else:
            proj = _refs(agg_schema[:nkeys]) + [
                Alias(rewritten, name) for name, rewritten in out_named]
            agg_low = ExprLowering(agg_enc, self.device, dry)
            proj = [agg_low.lower(e) for e in proj]
            check_supported(proj, self.conf)
            penc = {i: agg_low.out_dict(e) for i, e in enumerate(proj)
                    if agg_low.out_dict(e) is not None}
            out_schema = plan.schema
        if dry:
            return self._frame(out_schema, enc=penc)
        dist = DistributedAggregate(self.group, f.phys_dtypes, lgroup,
                                    [a.func for a in laggs],
                                    filter_cond=lconds or None)
        shards, nrows = dist(f.shards, f.nrows)
        self.stats.append(("aggregate", dist.last_stats))
        if trivial:
            return self._frame(plan.schema, shards, nrows, agg_enc)
        return self._stage(self._frame(agg_schema, shards, nrows, agg_enc),
                           proj, [], plan.schema, penc)

    # -- join -------------------------------------------------------------
    def _with_keys(self, f: ShardedFrame, keys: Sequence[Expression],
                   copy: bool):
        """(frame of ``f``'s live columns and the key columns, key
        ordinals in it): a bare column key is read in place unless
        ``copy`` (a string key's codes are remapped), any other key is
        materialized as a trailing column."""
        live = f.live
        base = [BoundReference(i, f.phys_dtypes[i], name=f.names[i])
                for i in live]
        schema = [(f.names[i], f.dtypes[i]) for i in live]
        if not copy and all(isinstance(k, BoundReference) for k in keys):
            pos = {o: j for j, o in enumerate(live)}
            idx = [pos[k.ordinal] for k in keys]
            exprs = base
        else:
            exprs = base + list(keys)
            schema = schema + [(f"__k{i}", k.dtype)
                               for i, k in enumerate(keys)]
            idx = list(range(len(live), len(live) + len(keys)))
        if len(exprs) == len(base) and len(live) == len(f.names):
            return f, idx
        return self._stage(f, exprs, [], schema, {}), idx

    def _join(self, plan: L.Join, dry: bool) -> ShardedFrame:
        if not plan.left_keys or plan.join_type == "cross":
            raise NotDistributable(
                "cross joins have no distributed lowering")
        if plan.condition is not None and plan.join_type != "inner":
            raise NotDistributable(
                "residual conditions only distribute for inner joins")
        if plan.condition is not None and plan.using:
            raise NotDistributable(
                "residual conditions with USING joins not supported")
        str_keys = [i for i, (lk, rk) in enumerate(
            zip(plan.left_keys, plan.right_keys))
            if lk.dtype.is_string or rk.dtype.is_string]
        if str_keys and plan.using and plan.join_type == "full":
            raise NotDistributable(
                "full-outer USING join over string keys would coalesce "
                "codes from two dictionaries")
        left = self.run(plan.left, dry)
        right = self.run(plan.right, dry)
        low_l, low_r = self._lowering(left), self._lowering(right)
        lkeys = [low_l.lower(e) for e in plan.left_keys]
        rkeys = [low_r.lower(e) for e in plan.right_keys]
        check_supported(lkeys + rkeys, self.conf)
        for i in str_keys:
            if low_l.out_dict(lkeys[i]) is None or \
                    low_r.out_dict(rkeys[i]) is None:
                raise NotDistributable(
                    "string join key has no dictionary on the shard group")
        semi = plan.join_type in ("semi", "anti")
        nleft = len(left.names)
        if semi:
            out_schema, out_enc, out_pruned = left.schema, dict(left.enc), \
                set(left.pruned)
        else:
            out_schema = left.schema + right.schema
            out_enc = dict(left.enc)
            out_enc.update({nleft + o: d for o, d in right.enc.items()})
            out_pruned = set(left.pruned) | {nleft + o for o in right.pruned}
        cond = None
        if plan.condition is not None:
            cond = ExprLowering(out_enc, self.device, dry,
                                out_pruned).lower(plan.condition)
            check_supported([cond], self.conf)
        layout = self._using_layout(plan, left.names, right.names) \
            if plan.using and not semi else None
        if dry:
            if layout is None:
                return self._frame(plan.schema, enc=out_enc,
                                   pruned=out_pruned)
            enc, pruned = self._layout_meta(layout, out_enc, out_pruned)
            return self._frame(plan.schema, enc=enc, pruned=pruned)

        swapped = plan.join_type == "right"
        join_type = "left" if swapped else plan.join_type
        if swapped:
            probe, build, pkeys, bkeys = right, left, rkeys, lkeys
            low_p, low_b = low_r, low_l
        else:
            probe, build, pkeys, bkeys = left, right, lkeys, rkeys
            low_p, low_b = low_l, low_r
        probe_m, pk_idx = self._with_keys(probe, pkeys, bool(str_keys))
        build_m, bk_idx = self._with_keys(build, bkeys, False)
        if str_keys:
            # the probe side's key codes re-code into the build side's
            # dictionary; a value the build side lacks becomes -1, which
            # no build code equals
            for i in str_keys:
                maps = low_p.out_dict(pkeys[i]).positions_in(
                    low_b.out_dict(bkeys[i]))
                j = pk_idx[i]
                for cols in probe_m.shards:
                    c = cols[j]
                    codes = maps[c.values.clamp(0, max(len(maps) - 1, 0))] \
                        if len(maps) else torch.full_like(c.values, -1)
                    cols[j] = ColVal(c.dtype, codes, c.validity)
        dist = DistributedHashJoin(
            self.group, probe_m.phys_dtypes, build_m.phys_dtypes, pk_idx,
            bk_idx, join_type, broadcast_threshold_rows=self.broadcast_rows)
        outs, nrows = dist(probe_m.shards, probe_m.nrows, build_m.shards,
                           build_m.nrows)
        self.stats.append((f"join:{plan.join_type}", dist.last_stats))
        np_live, nb_live = len(probe.live), len(build.live)
        shards = []
        for out, n in zip(outs, nrows):
            pcols = self._expand_live(probe, out[:np_live], n)
            if semi:
                shards.append(pcols)
                continue
            off = len(probe_m.names)
            bcols = self._expand_live(build, out[off:off + nb_live], n)
            shards.append(bcols + pcols if swapped else pcols + bcols)
        frame = self._frame(out_schema, shards, nrows, out_enc, out_pruned)
        if cond is not None:
            frame = self._stage(frame, self._pass_through(frame), [cond],
                                frame.schema, out_enc, out_pruned)
        if layout is None:
            return frame
        enc, pruned = self._layout_meta(layout, out_enc, out_pruned)
        out_shards = []
        for cols, n in zip(frame.shards, frame.nrows):
            out_shards.append([
                _coalesce(cols[a], cols[b]) if kind == "coalesce"
                else cols[a] for kind, a, b in layout])
        return self._frame(plan.schema, out_shards, frame.nrows, enc, pruned)

    def _pass_through(self, f: ShardedFrame) -> List[Optional[Expression]]:
        """Lowered references to every column of ``f`` (None for a
        pruned one)."""
        return [None if i in f.pruned else
                BoundReference(i, phys_dtype(dt), name=n)
                for i, (n, dt) in enumerate(f.schema)]

    def _expand_live(self, f: ShardedFrame, cols, n) -> List[ColVal]:
        """``f``'s live columns back in its full column order, with
        placeholders where it pruned."""
        it = iter(cols)
        return [_placeholder(dt, n, self.device) if i in f.pruned
                else next(it) for i, dt in enumerate(f.dtypes)]

    @staticmethod
    def _using_layout(plan: L.Join, lnames, rnames):
        """Where each output column of a USING join comes from, over the
        left + right columns: ``("col", i, None)``, or ``("coalesce", l,
        r)`` for a full join's key.  The preserved side supplies a key:
        the right side for right joins, both coalesced for full joins."""
        keyset = set(plan.using)
        nleft = len(lnames)
        out = []
        for i, n in enumerate(lnames):
            if n not in keyset:
                continue
            ri = nleft + rnames.index(n)
            if plan.join_type == "full":
                out.append(("coalesce", i, ri))
            elif plan.join_type == "right":
                out.append(("col", ri, None))
            else:
                out.append(("col", i, None))
        out += [("col", i, None) for i, n in enumerate(lnames)
                if n not in keyset]
        out += [("col", nleft + i, None) for i, n in enumerate(rnames)
                if n not in keyset]
        return out

    @staticmethod
    def _layout_meta(layout, enc, pruned):
        """The dictionaries and pruned ordinals of a USING join's output
        (a full join's string keys never reach here)."""
        out_enc, out_pruned = {}, set()
        for j, (kind, a, b) in enumerate(layout):
            if a in enc:
                out_enc[j] = enc[a]
            if a in pruned and (kind == "col" or b in pruned):
                out_pruned.add(j)
        return out_enc, out_pruned

    # -- sort / limit / topn ---------------------------------------------
    def _ordered(self, f: ShardedFrame, orders, make):
        """Run a sort-like operator over ``f``'s live columns with its
        order keys lowered; placeholders return for the pruned ones."""
        low = self._lowering(f)
        keys = [low.lower(e) for e, _, _ in orders]
        check_supported(keys, self.conf)
        if f.dry:
            return f
        live = f.live
        if len(live) != len(f.names):
            pos = {o: j for j, o in enumerate(live)}
            keys = [substitute_bound(k, [
                BoundReference(pos.get(i, 0), dt, name=n)
                for i, (n, dt) in enumerate(zip(f.names, f.phys_dtypes))])
                for k in keys]
        dist = make([f.phys_dtypes[i] for i in live], keys,
                    [d for _, d, _ in orders], [nf for _, _, nf in orders])
        shards, nrows = dist([[cols[i] for i in live] for cols in f.shards],
                             f.nrows)
        out = [self._expand_live(f, cols, n)
               for cols, n in zip(shards, nrows)]
        return self._frame(f.schema, out, nrows, f.enc, f.pruned), dist

    def _sort(self, plan: L.Sort, dry: bool) -> ShardedFrame:
        f = self.run(plan.child, dry)
        got = self._ordered(f, plan.orders, lambda dts_, k, d, nf:
                            DistributedSort(self.group, dts_, k, d, nf))
        if dry:
            return got
        frame, dist = got
        self.stats.append(("sort", dist.last_stats))
        return frame

    def _topn(self, plan: L.Limit, dry: bool) -> ShardedFrame:
        sort = plan.child
        f = self.run(sort.child, dry)
        got = self._ordered(f, sort.orders, lambda dts_, k, d, nf:
                            DistributedTopN(self.group, dts_, k, d, nf,
                                            plan.n))
        if dry:
            return got
        frame, dist = got
        self.stats.append(("topn", dist.last_stats))
        return frame

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
        return self._frame(f.schema, shards, nrows, f.enc, f.pruned)

    # -- union ------------------------------------------------------------
    def _union(self, plan: L.Union, dry: bool) -> ShardedFrame:
        """Union keeps rows where they are: shard i's output is shard i's
        rows of every child in turn (no exchange).  String columns would
        need their dictionaries aligned across children, so a union over
        strings falls back, as in the JAX package."""
        schema = plan.schema
        if any(dt.is_string for _, dt in schema):
            raise NotDistributable(
                "union over string columns needs dictionary alignment "
                "(not yet distributed)")
        frames = [self.run(c, dry) for c in plan.children]
        if any(fr.pruned for fr in frames):
            raise NotDistributable("a union's child had columns pruned")
        if dry:
            return self._frame(schema)
        shards, nrows = [], []
        for s in range(len(self.group.local_shards)):
            shards.append([_concat_cols([fr.shards[s][j] for fr in frames],
                                        dt)
                           for j, (_, dt) in enumerate(schema)])
            nrows.append(sum(fr.nrows[s] for fr in frames))
        return self._frame(schema, shards, nrows)

    # -- collect ----------------------------------------------------------
    def collect(self, f: ShardedFrame) -> ColumnarBatch:
        """Every shard's rows, in shard order, as one batch on the
        session's device; encoded columns decode by a gather from their
        dictionaries on the device."""
        if f.pruned:
            raise RuntimeError(
                f"columns {sorted(f.names[i] for i in f.pruned)} reached "
                "the result although the scan pruned them")
        total = int(self.group.all_counts(f.nrows).sum())
        cols = self.group.all_gather(f.shards) if f.names else []
        out: Dict[str, Column] = {}
        for i, ((name, dt), c) in enumerate(zip(f.schema, cols)):
            if i in f.enc:
                s = f.enc[i].decode(c.values, c.validity)
                out[name] = Column(dt, s.values, total, validity=s.validity,
                                   offsets=s.offsets)
                continue
            out[name] = Column(dt, c.values.contiguous(), total,
                               validity=None if c.validity is None
                               else c.validity.contiguous())
        return ColumnarBatch(out, total)


def _nested_reason(node: L.LogicalPlan) -> List[str]:
    """Arrays (maps are two arrays) and explodes run on one device: the
    sharded operators move no offsets column.  A struct is flat columns
    and shards as they do."""
    if isinstance(node, L.Generate):
        return ["nested data (explode) runs on one device"]
    # a scan moves only the columns the plan reads (the pushdown pass)
    read = getattr(node, "required_columns", None)
    arrays = [n for n, dt in node.schema if dt.is_array and
              (read is None or n in read)]
    if arrays:
        return [f"nested data (array columns {arrays}) runs on one device"]
    return []


def _user_code_reason(node: L.LogicalPlan, cache_manager) -> List[str]:
    """User code and reuse run on one device: a Python or torch UDF in
    the node's expressions, a pandas node, or a cached plan (as the JAX
    planner keeps UDFs off the sharded path)."""
    from spark_rapids_tpu_torch.plan.overrides import (
        PANDAS_NODES, _node_expressions)
    from spark_rapids_tpu_torch.udf.python_exec import PythonUDF, TorchUDF
    if isinstance(node, PANDAS_NODES):
        return [f"pandas UDF node {type(node).__name__} runs on one device"]
    if cache_manager is not None and cache_manager.lookup(node) is not None:
        return ["a cached plan runs on one device"]

    def udfs(e):
        if isinstance(e, (PythonUDF, TorchUDF)):
            yield type(e).__name__
        for c in e.children:
            yield from udfs(c)
    found = sorted({u for e in _node_expressions(node) for u in udfs(e)})
    if found:
        return [f"user code ({', '.join(found)}) runs on one device"]
    return []


def try_distributed(session, plan: L.LogicalPlan, resume: bool = False):
    """Entry point from DataFrame execution: a list holding one batch when
    the plan ran on the session's shard group, else None: the plan runs
    on one device, through the CPU fallback where the planner tags it
    off, with the reason on ``session.last_dist_explain``.  A plan node
    that does not run on the device (a per-exec disable, a disabled file
    format, a residual on a join that is not inner), user code (a Python
    or torch UDF, a pandas node) and a cached plan send the whole plan
    there; an expression is tagged after it is lowered, so one over an
    encoded string column still runs distributed as a lookup over its
    dictionary.  ``resume``: a recovery re-attempt, which splices the
    stage checkpoints the failed attempt recorded."""
    from spark_rapids_tpu_torch.plan.overrides import (
        _pushdown_pass, node_reasons)
    group = getattr(session, "shards", None)
    if group is None:
        return None
    session.last_dist_stats = None
    session.last_scan_stats = None
    if not session.conf.get(rc.DISTRIBUTED_ENABLED):
        session.last_dist_explain = "distributed disabled by conf"
        return None
    cache_manager = getattr(session, "cache_manager", None)
    _pushdown_pass(plan, cache_manager)
    stack = [plan]
    while stack:
        node = stack.pop()
        reasons = node_reasons(node, session.conf) + \
            _nested_reason(node) + _user_code_reason(node, cache_manager)
        if reasons:
            session.last_dist_explain = (
                f"fallback: {type(node).__name__}: " + "; ".join(reasons))
            return None
        stack.extend(node.children)
    planner = DistPlanner(session, group, resume=resume)
    try:
        planner.run(plan, dry=True)  # support pre-flight: no data moves
        batch = planner.collect(planner.run(plan, dry=False))
    except NotDistributable as e:
        session.last_dist_explain = f"fallback: {e}"
        session.last_scan_stats = None
        return None
    session.last_dist_explain = "distributed"
    session.last_dist_stats = planner.stats
    return [batch]
