"""The planner: logical plan -> physical operators.

Counterpart of ``spark_rapids_tpu/plan/overrides.py``, cut to the
converters of the ported slices (in-memory and file relations, Range,
Project, Filter, Aggregate, Join, Sort, Limit, Union, Expand, Window),
``_plan_aggregate``, the pushdown pass into file scans, the
``Limit(Sort) -> TopN`` rewrite and the fusion pass the JAX planner
applies: a
Project/Filter chain under an Aggregate folds into the aggregate (its
predicates become the row mask), and any other chain of two or more
members collapses into one FusedStageExec.  There is no CPU fallback: a
node or expression this port cannot run raises ``NotImplementedError``
with its name, before anything runs (``check_ported``).
"""

from __future__ import annotations

from typing import List, Optional

from spark_rapids_tpu_torch.config import rapids_conf as rc
from spark_rapids_tpu_torch.exec.aggregate import TpuHashAggregateExec
from spark_rapids_tpu_torch.exec.basic import (
    TpuCoalesceBatchesExec, TpuFilterExec, TpuLocalLimitExec,
    TpuProjectExec, TpuRangeExec, TpuScanExec, TpuUnionExec)
from spark_rapids_tpu_torch.exec.expand import Expand, TpuExpandExec
from spark_rapids_tpu_torch.exec.join import TpuHashJoinExec
from spark_rapids_tpu_torch.exec.sort import TpuSortExec, TpuTopNExec
from spark_rapids_tpu_torch.exec.window import (
    TpuWindowExec, WindowExpression, group_by_spec)
from spark_rapids_tpu_torch.exec.fusion import (
    FusedStageExec, compose_chain, fusion_metrics)
from spark_rapids_tpu_torch.ops.cast import Cast, cast_supported
from spark_rapids_tpu_torch.ops.expressions import (
    Alias, BoundReference, Expression, UnresolvedColumn, substitute_bound)
from spark_rapids_tpu_torch.ops.stringops import Like
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.logical import AggregateExpression


def aggregate_outputs(group_exprs, agg_out_exprs):
    """Split an Aggregate's outputs into bare aggregate calls and result
    expressions over the aggregate's (keys, aggregates) frame.  Returns
    ``(agg_list, out_named, trivial)``: the AggregateExpressions in
    order, ``(name, expression over the frame)`` per output, and whether
    every output is a bare aggregate (no result projection needed)."""
    nkeys = len(group_exprs)
    agg_list: List[AggregateExpression] = []
    group_keys = [ge.cache_key() for ge in group_exprs]

    def extract(e):
        if isinstance(e, AggregateExpression):
            idx = len(agg_list)
            agg_list.append(e)
            return BoundReference(nkeys + idx, e.dtype, name=f"_a{idx}",
                                  nullable=e.nullable)
        # a subtree equal to a group expression reads the key column
        ck = e.cache_key()
        if ck in group_keys:
            ki = group_keys.index(ck)
            ge = group_exprs[ki]
            return BoundReference(ki, ge.dtype, name=ge.name,
                                  nullable=ge.nullable)
        if not e.children:
            if isinstance(e, BoundReference):
                raise ValueError(
                    f"column {e.name!r} in aggregate output is neither "
                    "an aggregate nor in the GROUP BY")
            return e
        return e.with_children([extract(c) for c in e.children])

    out_named = []
    trivial = True
    for e in agg_out_exprs:
        inner = e.children[0] if isinstance(e, Alias) else e
        if not isinstance(inner, AggregateExpression):
            trivial = False
        out_named.append((e.name, extract(inner)))
    return agg_list, out_named, trivial


def _plan_aggregate(group_exprs, agg_out_exprs, child_exec, device,
                    pre_filter=None, hash_table_slots=None,
                    merge_chunk_rows=1 << 22):
    """The aggregate exec, plus a result projection when outputs combine
    aggregates in larger expressions (sum(a) / sum(b), ...)."""
    nkeys = len(group_exprs)
    agg_list, out_named, trivial = aggregate_outputs(group_exprs,
                                                     agg_out_exprs)
    if trivial:
        return TpuHashAggregateExec(
            group_exprs,
            [(name, a) for (name, _), a in zip(out_named, agg_list)],
            child_exec, device, pre_filter=pre_filter,
            hash_table_slots=hash_table_slots,
            merge_chunk_rows=merge_chunk_rows)
    agg_exec = TpuHashAggregateExec(
        group_exprs, [(f"_a{i}", a) for i, a in enumerate(agg_list)],
        child_exec, device, pre_filter=pre_filter,
        hash_table_slots=hash_table_slots,
        merge_chunk_rows=merge_chunk_rows)
    proj = [BoundReference(i, dt, name=n)
            for i, (n, dt) in enumerate(agg_exec.schema[:nkeys])]
    proj += [Alias(rewritten, name) for name, rewritten in out_named]
    return TpuProjectExec(proj, agg_exec)


def _node_expressions(node: L.LogicalPlan) -> List[Expression]:
    if isinstance(node, Expand):
        return [e for p in node.projections for e in p]
    if isinstance(node, L.Window):
        return [e for _, e in node.window_exprs]
    if isinstance(node, L.Project):
        return list(node.exprs)
    if isinstance(node, L.Filter):
        return [node.condition]
    if isinstance(node, L.Aggregate):
        return list(node.group_exprs) + list(node.agg_exprs)
    if isinstance(node, L.Join):
        out = list(node.left_keys) + list(node.right_keys)
        return out + ([node.condition] if node.condition is not None
                      else [])
    if isinstance(node, L.Sort):
        return [e for e, _, _ in node.orders]
    return []


def check_ported(plan: L.LogicalPlan) -> None:
    """Raise ``NotImplementedError`` naming the first node or expression
    of the plan that the port does not run: a residual condition on a
    join that is not inner, a window function or frame outside the
    ported set, a cast to or from a string, a LIKE pattern with ``_``.
    The JAX package sends these to its CPU fallback, which the port does
    not have."""
    if isinstance(plan, L.Join) and plan.condition is not None and \
            plan.join_type != "inner":
        raise NotImplementedError(
            f"a residual (non-equi) condition on a {plan.join_type} join: "
            "only inner joins take one (the outer, semi and anti residual "
            "semantics need the nested-loop join, which is not ported)")

    def walk(e: Expression):
        if isinstance(e, WindowExpression):
            reason = e.supported_reason()
            if reason is not None:
                raise NotImplementedError(f"window {e.kind}: {reason}")
        if isinstance(e, Cast):
            reason = cast_supported(e.child.dtype, e.target)
            if reason is not None:
                raise NotImplementedError(reason)
        if isinstance(e, Like) and e._plan is None:
            raise NotImplementedError(
                f"LIKE pattern {e.pattern!r}: '_' is not ported")
        for c in e.children:
            walk(c)
    for e in _node_expressions(plan):
        walk(e)
    for child in plan.children:
        check_ported(child)


def _names(exprs, schema) -> Optional[set]:
    """Names of the child columns ``exprs`` read, or None when a
    reference does not name a column of ``schema`` (then nothing below
    is pruned)."""
    names = {n for n, _ in schema}
    out: set = set()

    def walk(e):
        if isinstance(e, (BoundReference, UnresolvedColumn)):
            out.add(e.name)
        for c in e.children:
            walk(c)
    for e in exprs:
        walk(e)
    return out if out <= names else None


def _pushdown_pass(plan: L.LogicalPlan) -> None:
    """Column pruning and filter pushdown into the plan's FileRelations,
    set afresh on every planning (``required_columns`` back to None and
    ``pushed_filters`` emptied where nothing applies).  An
    InMemoryRelation gets its ``required_columns`` the same way (no
    filters): the sharded scan encodes and moves only those columns, and
    the single-device scan does not read them.

    As in the JAX package, filters push down until a Project or an
    Aggregate, and a Project or Aggregate above decides the columns a
    scan reads.  The port also prunes through a Project's unread outputs
    and through joins (each side reads what the join's consumers, keys
    and condition name on it), which the JAX pass does not.  A relation
    reached twice in one plan reads the union of both requirements and
    takes no filter unless both paths push the same ones.  The JAX pass
    treats a cached plan node as a barrier; the port has no cache, and
    the barrier comes with it."""
    found = {}

    def visit(node, required, filters):
        if isinstance(node, (L.FileRelation, L.InMemoryRelation)):
            seen = found.get(id(node))
            if seen is None:
                found[id(node)] = [node, required, list(filters)]
                return
            seen[1] = None if seen[1] is None or required is None \
                else seen[1] | required
            if [f.cache_key() for f in seen[2]] != \
                    [f.cache_key() for f in filters]:
                seen[2] = []
            return
        if isinstance(node, L.Filter):
            req = None
            if required is not None:
                cond = _names([node.condition], node.child.schema)
                req = None if cond is None else required | cond
            visit(node.child, req, filters + [node.condition])
            return
        if isinstance(node, L.Project):
            exprs = node.exprs if required is None else \
                [e for e in node.exprs if e.name in required]
            visit(node.child, _names(exprs, node.child.schema), [])
            return
        if isinstance(node, L.Aggregate):
            visit(node.child, _names(
                list(node.group_exprs) + list(node.agg_exprs),
                node.child.schema), [])
            return
        if isinstance(node, L.Join):
            for side, keys in ((node.left, node.left_keys),
                               (node.right, node.right_keys)):
                req = None
                if required is not None:
                    own = _names(keys, side.schema)
                    cond = set() if node.condition is None else _names(
                        [node.condition],
                        list(node.left.schema) + list(node.right.schema))
                    if own is not None and cond is not None:
                        names = {n for n, _ in side.schema}
                        req = (required | own | cond) & names
                visit(side, req, [])
            return
        for c in node.children:
            visit(c, None, [])

    visit(plan, None, [])
    for node, required, filters in found.values():
        node.required_columns = None if required is None else set(required)
        if isinstance(node, L.FileRelation):
            node.pushed_filters = filters


def _check_format_enabled(node: L.FileRelation, conf) -> None:
    """The per-format scan switches: a disabled format raises naming its
    key (the JAX package reads it on its CPU fallback, which the port
    does not have)."""
    for entries in (rc.FORMAT_ENABLED, rc.FORMAT_READ_ENABLED):
        entry = entries.get(node.file_format)
        if entry is None:
            raise NotImplementedError(
                f"file format {node.file_format!r} is not ported")
        if not conf.get(entry):
            raise NotImplementedError(
                f"{node.file_format} scan disabled by {entry.key}")


class TpuOverrides:
    """Logical plan -> TpuExec tree on one device, its operators bound to
    ``catalog`` (the session's spill catalog)."""

    def __init__(self, conf: rc.RapidsConf, device, catalog=None):
        self.conf = conf
        self.device = device
        self.catalog = catalog
        self.fusion_enabled = conf.get(rc.FUSION_ENABLED)
        self.hash_enabled = conf.get(rc.PALLAS_HASH_ENABLED)
        self.hash_table_slots = conf.get(rc.PALLAS_HASH_TABLE_SLOTS) \
            if self.hash_enabled else None
        self._chain_nodes: set = set()

    def apply(self, plan: L.LogicalPlan):
        check_ported(plan)
        _pushdown_pass(plan)
        self._chain_nodes = set()
        return self._bind(self._convert(plan))

    def _bind(self, root):
        """Every operator of the tree registers its state in, and
        recovers from a device OOM through, this planner's catalog."""
        stack = [root]
        while stack:
            node = stack.pop()
            node.catalog = self.catalog
            stack.extend(node.children)
        return root

    def _file_scan(self, node: L.FileRelation):
        """The file scan, under a coalesce to ``batchSizeBytes`` where a
        PERFILE reader emits one undersized batch per file."""
        from spark_rapids_tpu_torch.io.readers import make_file_scan_exec
        _check_format_enabled(node, self.conf)
        if node.options:
            raise NotImplementedError(
                f"reader options {sorted(node.options)} are not supported "
                f"by the PyTorch port's readers")
        scan = make_file_scan_exec(node, self.conf, self.device)
        if len(node.paths) > 1 and scan.reader_type == "PERFILE":
            from spark_rapids_tpu_torch.memory.coalesce import TargetSize
            return self._bind(TpuCoalesceBatchesExec(
                scan, goal=TargetSize(self.conf.get(rc.BATCH_SIZE_BYTES))))
        return self._bind(scan)

    def _scan_rows(self, schema) -> int:
        """Rows per scanned batch: maxBatchRows, and no more than
        batchSizeBytes of column data."""
        row_bytes = max(1, sum(dt.storage.itemsize for _, dt in schema))
        by_bytes = max(1, self.conf.get(rc.BATCH_SIZE_BYTES) // row_bytes)
        return min(self.conf.get(rc.BATCH_ROW_CAPACITY), by_bytes)

    def _convert(self, node: L.LogicalPlan):
        if isinstance(node, L.Aggregate):
            fused = self._try_fuse_aggregate(node)
            if fused is not None:
                return fused
        # Limit(Sort) -> TopN (the TakeOrderedAndProject rewrite)
        if isinstance(node, L.Limit) and isinstance(node.child, L.Sort):
            return TpuTopNExec(node.n, node.child.orders,
                               self._convert(node.child.child))
        if isinstance(node, (L.Project, L.Filter)):
            fused = self._try_fuse_chain(node)
            if fused is not None:
                return fused
        children = [self._convert(c) for c in node.children]
        if isinstance(node, L.InMemoryRelation):
            return TpuScanExec(node.batches, node.schema,
                               self._scan_rows(node.schema))
        if isinstance(node, L.FileRelation):
            return self._file_scan(node)
        if isinstance(node, L.Range):
            return TpuRangeExec(node.start, node.end, node.step,
                                self.device)
        if isinstance(node, L.Union):
            return TpuUnionExec(*children)
        if isinstance(node, Expand):
            return TpuExpandExec(node, children[0])
        if isinstance(node, L.Window):
            return self._window(node, children[0])
        if isinstance(node, L.Project):
            return TpuProjectExec(node.exprs, children[0])
        if isinstance(node, L.Filter):
            return TpuFilterExec(node.condition, children[0])
        if isinstance(node, L.Aggregate):
            return _plan_aggregate(
                node.group_exprs, node.agg_exprs, children[0], self.device,
                hash_table_slots=self.hash_table_slots,
                merge_chunk_rows=self.conf.get(rc.AGG_MERGE_CHUNK_ROWS))
        if isinstance(node, L.Join):
            join_type = node.join_type
            if node.condition is not None and not node.left_keys:
                # a pure non-equi inner join: the cross product, then the
                # filter
                join_type = "cross"
            join = TpuHashJoinExec(
                node.left_keys, node.right_keys, join_type,
                children[0], children[1], self.device, using=node.using,
                max_output_rows=self.conf.get(rc.JOIN_OUTPUT_BATCH_ROWS),
                hash_enabled=self.hash_enabled)
            if node.condition is not None:
                # the residual, evaluated over the joined rows
                return TpuFilterExec(node.condition, join)
            return join
        if isinstance(node, L.Sort):
            return self._sort(node.orders, children[0])
        if isinstance(node, L.Limit):
            return TpuLocalLimitExec(node.n, children[0])
        raise NotImplementedError(
            f"{type(node).__name__} is not ported to the PyTorch engine")

    def _sort(self, orders, child_exec) -> TpuSortExec:
        return TpuSortExec(
            orders, child_exec,
            ooc_threshold_bytes=self.conf.get(rc.SORT_OOC_THRESHOLD),
            ooc_window_rows=self.conf.get(rc.SORT_OOC_WINDOW_ROWS))

    def _window_one_spec(self, window_exprs, child_exec):
        """One window operator over one spec; with partition or order
        keys, a sort on (partition keys ascending, order keys) under it,
        as Spark plans WindowExec over a SortExec: the sort brings the
        out-of-core merge, and the window then streams chunks
        (``presorted``)."""
        spec = window_exprs[0][1].spec
        if spec.partition_exprs or spec.orders:
            orders = [(e, False, True) for e in spec.partition_exprs] + \
                list(spec.orders)
            return TpuWindowExec(
                window_exprs, self._sort(orders, child_exec), self.device,
                presorted=True,
                batch_rows=self.conf.get(rc.WINDOW_BATCH_ROWS))
        return TpuWindowExec(window_exprs, child_exec, self.device)

    def _window(self, node: L.Window, child_exec):
        """Several specs chain one operator each (later ones carry the
        earlier outputs as payload; the child's ordinals do not move, as
        outputs append at the end), then a projection restores the
        node's column order."""
        exprs = node.window_exprs
        groups = group_by_spec(exprs)
        if len(groups) == 1:
            return self._window_one_spec(exprs, child_exec)
        nchild = len(child_exec.schema)
        cur = child_exec
        appended_pos = {}
        base = nchild
        for grp in groups:
            cur = self._window_one_spec([(n, we) for _, n, we in grp], cur)
            for i, (j, _, _) in enumerate(grp):
                appended_pos[j] = base + i
            base += len(grp)
        perm = list(range(nchild)) + \
            [appended_pos[j] for j in range(len(exprs))]
        cur_schema = cur.schema
        projs = []
        for want, p in zip([n for n, _ in node.schema], perm):
            pname, pdt = cur_schema[p]
            projs.append(Alias(BoundReference(p, pdt, pname), want))
        return TpuProjectExec(projs, cur)

    def _try_fuse_chain(self, node) -> Optional[FusedStageExec]:
        """Collapse a maximal Project/Filter run into one FusedStageExec."""
        if id(node) in self._chain_nodes:
            return None  # inner member of an already-detected chain
        exprs = None
        conds: List[Expression] = []
        cur = node
        members: List[str] = []
        ids: List[int] = []
        while isinstance(cur, (L.Project, L.Filter)):
            exprs, conds = compose_chain(exprs, conds, cur,
                                         cur.child.schema)
            members.append(type(cur).__name__)
            ids.append(id(cur))
            cur = cur.child
        if len(members) < 2:
            return None
        self._chain_nodes.update(ids)
        fusion_metrics.bump("fusibleChains")
        if not self.fusion_enabled:
            return None
        fusion_metrics.bump("fusedStages")
        fusion_metrics.bump("fusedOperators", len(members))
        return FusedStageExec(exprs, conds, self._convert(cur), members)

    def _try_fuse_aggregate(self, node: L.Aggregate):
        """Fold the Project/Filter chain under an Aggregate into it:
        projections compose into the key/aggregate expressions, predicates
        become its row mask (bottom-first)."""
        group = list(node.group_exprs)
        aggs = list(node.agg_exprs)
        conds: List[Expression] = []
        cur = node.child
        hops = 0
        ids: List[int] = []
        while isinstance(cur, (L.Project, L.Filter)):
            if isinstance(cur, L.Project):
                repl = cur.exprs
                group = [substitute_bound(e, repl) for e in group]
                aggs = [substitute_bound(e, repl) for e in aggs]
                conds = [substitute_bound(c, repl) for c in conds]
            else:
                conds = [cur.condition] + conds
            ids.append(id(cur))
            cur = cur.child
            hops += 1
        if hops == 0:
            return None
        fusion_metrics.bump("fusibleChains")
        if not self.fusion_enabled:
            self._chain_nodes.update(ids)
            return None
        fusion_metrics.bump("fusedStages")
        fusion_metrics.bump("fusedOperators", hops + 1)
        return _plan_aggregate(
            group, aggs, self._convert(cur), self.device,
            pre_filter=conds or None, hash_table_slots=self.hash_table_slots,
            merge_chunk_rows=self.conf.get(rc.AGG_MERGE_CHUNK_ROWS))
