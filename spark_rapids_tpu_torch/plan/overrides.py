"""The planner: tagging, then logical plan -> physical operators.

Counterpart of ``spark_rapids_tpu/plan/overrides.py``, cut to the
expression classes and plan nodes the ported slices have.  As in the JAX
package (and the reference's ``RapidsMeta``), every logical node and every
expression is wrapped in a meta that collects "will not run on the device
because ..." reasons (``PlanMeta.tag`` / ``ExprMeta.tag``): a per-op
disable (``spark.rapids.sql.exec.<Name>``,
``spark.rapids.sql.expression.<Name>``), a disabled file format, a cast or
LIKE pattern the device does not run, a window function or frame outside
the ported set, a residual condition on a join that is not inner, a float
aggregate under ``variableFloatAgg.enabled=false``, or a type outside the
expression's signature.  With ``spark.rapids.sql.optimizer.enabled`` the
cost-based optimizer (``plan/cbo.py``) may add reasons.  A node without
reasons converts to its device operator; any other node becomes a
``CpuFallbackExec`` (``exec/fallback.py``) that runs it in pandas between
device operators, or raises in strict test mode
(``spark.rapids.sql.test.enabled``).  ``last_explain`` holds the tagged
tree (``spark.rapids.sql.explain`` prints it) and ``last_cbo`` the
optimizer's decisions.

The converters cover in-memory and file relations, Range, Project,
Filter, Aggregate, Join, Sort, Limit, Union, Expand and Window;
``_plan_aggregate``, the pushdown pass into scans, the
``Limit(Sort) -> TopN`` rewrite and the fusion pass follow the JAX
planner: a Project/Filter chain under an Aggregate folds into the
aggregate (its predicates become the row mask), and any other chain of
two or more members collapses into one FusedStageExec.  Both rewrites take
only members that run on the device, so a CPU Filter never folds into a
device aggregate.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Type

from spark_rapids_tpu_torch.config import rapids_conf as rc
from spark_rapids_tpu_torch.exec.aggregate import TpuHashAggregateExec
from spark_rapids_tpu_torch.exec.basic import (
    TpuCoalesceBatchesExec, TpuFilterExec, TpuLocalLimitExec,
    TpuProjectExec, TpuRangeExec, TpuScanExec, TpuUnionExec)
from spark_rapids_tpu_torch.exec.expand import (
    Expand, NullLiteral, TpuExpandExec)
from spark_rapids_tpu_torch.exec.join import TpuHashJoinExec
from spark_rapids_tpu_torch.exec.sort import TpuSortExec, TpuTopNExec
from spark_rapids_tpu_torch.exec.window import (
    TpuWindowExec, WindowExpression, group_by_spec)
from spark_rapids_tpu_torch.exec.fusion import (
    FusedStageExec, compose_chain, fusion_metrics)
from spark_rapids_tpu_torch.ops import arithmetic as A
from spark_rapids_tpu_torch.ops import datetime_ops as D
from spark_rapids_tpu_torch.ops import predicates as P
from spark_rapids_tpu_torch.ops import stringops as S
from spark_rapids_tpu_torch.ops.cast import Cast, cast_supported
from spark_rapids_tpu_torch.ops.expressions import (
    Alias, BoundReference, Expression, Literal, UnresolvedColumn,
    substitute_bound)
from spark_rapids_tpu_torch.parallel.dict_lowering import DictLookup
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan import typechecks as ts
from spark_rapids_tpu_torch.plan.logical import AggregateExpression


# ------------------------------------------------------ expression registry --

class ExprRule:
    def __init__(self, cls: Type[Expression], sig: ts.TypeSig):
        self.cls = cls
        self.sig = sig


_EXPR_RULES: Dict[Type[Expression], ExprRule] = {}


def expr_rule(cls, sig=ts.COMMON):
    _EXPR_RULES[cls] = ExprRule(cls, sig)


# a class the port lacks gets its rule when it is ported
for _c in (Alias, BoundReference, Literal, UnresolvedColumn, Cast,
           WindowExpression, NullLiteral,
           # the sharded path's lookup over a string dictionary
           # (parallel/dict_lowering.py), tagged after lowering
           DictLookup,
           S.EqualsLiteral, S.StartsWith, S.EndsWith, S.Contains, S.Like,
           S.Substring,
           D.Year, D.Month, D.DayOfMonth, D.DateAdd, D.DateSub, D.DateDiff,
           P.EqualTo, P.LessThan, P.LessThanOrEqual, P.GreaterThan,
           P.GreaterThanOrEqual, P.And, P.Or, P.Not, P.IsNull, P.IsNotNull,
           P.Coalesce, P.If, P.CaseWhen, P.In, P.InSet):
    expr_rule(_c)
expr_rule(AggregateExpression, ts.ALL)
for _c in (A.Add, A.Subtract, A.Multiply, A.Divide, A.IntegralDivide,
           A.Remainder, A.UnaryMinus, A.Abs, A.BitwiseAnd, A.ShiftRight):
    expr_rule(_c, ts.NUMERIC)

# the plan nodes with a device operator (TpuOverrides._convert_node)
_PLAN_CONVERTERS = (L.InMemoryRelation, L.FileRelation, L.Range, L.Union,
                    Expand, L.Window, L.Project, L.Filter, L.Aggregate,
                    L.Join, L.Sort, L.Limit)

_FORMAT_GATES = {fmt: (rc.FORMAT_ENABLED[fmt], rc.FORMAT_READ_ENABLED[fmt])
                 for fmt in rc.FORMAT_ENABLED}


def valid_op_names():
    """Known per-op conf suffixes: expression class names and plan node
    names (``RapidsConf``'s unknown-key check reads them)."""
    return {c.__name__ for c in _EXPR_RULES} | \
        {c.__name__ for c in _PLAN_CONVERTERS}


# --------------------------------------------------------------- the metas --

class BaseMeta:
    def __init__(self, wrapped, conf: rc.RapidsConf):
        self.wrapped = wrapped
        self.conf = conf
        self.reasons: List[str] = []
        self.child_metas: List[BaseMeta] = []

    def will_not_work(self, reason: str) -> None:
        self.reasons.append(reason)

    @property
    def can_replace(self) -> bool:
        return not self.reasons and all(
            c.can_replace for c in self.child_metas)

    def explain_lines(self, depth: int = 0, all_nodes: bool = True
                      ) -> List[str]:
        status = "will run on the device" if not self.reasons else \
            "will NOT run on the device because " + "; ".join(self.reasons)
        lines = []
        if all_nodes or self.reasons:
            lines.append("  " * depth + f"{'*' if not self.reasons else '!'}"
                         f" {type(self.wrapped).__name__} {status}")
        for c in self.child_metas:
            lines.extend(c.explain_lines(depth + 1, all_nodes))
        return lines


class ExprMeta(BaseMeta):
    def __init__(self, expr: Expression, conf: rc.RapidsConf):
        super().__init__(expr, conf)
        self.child_metas = [ExprMeta(c, conf) for c in expr.children]

    def tag(self) -> None:
        expr = self.wrapped
        name = type(expr).__name__
        if not self.conf.op_enabled("expression", name):
            self.will_not_work(
                f"expression {name} disabled by "
                f"spark.rapids.sql.expression.{name}")
        rule = _EXPR_RULES.get(type(expr))
        if isinstance(expr, AggregateExpression):
            self._tag_aggregate(expr)
        if isinstance(expr, Cast):
            self._tag_cast(expr)
        if isinstance(expr, S.Like) and expr._plan is None:
            self.will_not_work(
                f"LIKE pattern {expr.pattern!r} too general for the "
                "device ('_' is not ported)")
        if isinstance(expr, WindowExpression):
            reason = expr.supported_reason()
            if reason:
                self.will_not_work(reason)
        elif rule is None and type(expr).emit is Expression.emit:
            self.will_not_work(
                f"expression {name} has no device implementation")
        else:
            # a class without a rule that brings its own ``emit`` (an
            # expression written against the engine) runs as it is
            sig = rule.sig if rule is not None else ts.ALL
            try:
                reason = sig.reason_if_unsupported(
                    expr.dtype, f"expression {name}")
                if reason and not isinstance(expr, (BoundReference, Alias,
                                                    Literal)):
                    self.will_not_work(reason)
            except (RuntimeError, TypeError, ValueError) as e:
                self.will_not_work(str(e))
        for c in self.child_metas:
            c.tag()

    def _tag_aggregate(self, expr: AggregateExpression) -> None:
        func = expr.func
        child = func.child
        try:
            if child is not None and child.dtype.has_offsets and \
                    func.name not in ("count", "min", "max"):
                # string min/max run over order-preserving dictionary
                # codes; sum/avg of a string has no numeric meaning
                self.will_not_work(
                    f"aggregate {func.name} over {child.dtype.name} values "
                    "falls back to CPU")
            if func.name in ("sum", "avg") and child is not None and \
                    child.dtype.is_floating and \
                    not self.conf.get(rc.VARIABLE_FLOAT_AGG):
                self.will_not_work(
                    f"float {func.name} reorders additions across chunks "
                    "and spark.rapids.sql.variableFloatAgg.enabled is "
                    "false")
        except (RuntimeError, TypeError, ValueError) as e:
            self.will_not_work(str(e))

    def _tag_cast(self, expr: Cast) -> None:
        try:
            src, dst = expr.child.dtype, expr.target
        except (RuntimeError, TypeError, ValueError):
            return
        reason = cast_supported(src, dst)
        if reason:
            self.will_not_work(reason)
        gates = ((src.is_string and dst.is_floating,
                  rc.CAST_STRING_TO_FLOAT),
                 (src.is_floating and dst.is_string,
                  rc.CAST_FLOAT_TO_STRING),
                 (src.is_string and dst.is_datetime,
                  rc.CAST_STRING_TO_TIMESTAMP))
        for hit, entry in gates:
            if hit and not self.conf.get(entry):
                self.will_not_work(
                    f"cast {src.name}->{dst.name} disabled by {entry.key}")


def node_reasons(node: L.LogicalPlan, conf: rc.RapidsConf) -> List[str]:
    """The reasons a plan node does not run on the device that come from
    the node itself, not from its expressions (the sharded planner checks
    these before it lowers anything)."""
    name = type(node).__name__
    out = []
    if not conf.op_enabled("exec", name):
        out.append(f"{name} disabled by spark.rapids.sql.exec.{name}")
    if isinstance(node, L.FileRelation):
        gates = _FORMAT_GATES.get(node.file_format)
        if gates is None:
            out.append(f"file format {node.file_format!r} is not ported")
        for entry in gates or ():
            if not conf.get(entry):
                out.append(f"{node.file_format} scan disabled by "
                           f"{entry.key}")
    if not isinstance(node, _PLAN_CONVERTERS):
        out.append(f"{name} has no device implementation")
    if isinstance(node, L.Join) and node.condition is not None and \
            node.join_type != "inner":
        out.append(
            "non-equi join conditions only supported for inner joins on "
            f"the device (the {node.join_type} join's residual semantics "
            "need the nested-loop join)")
    return out


class PlanMeta(BaseMeta):
    """Wraps a logical node; the planner below converts it."""

    def __init__(self, plan: L.LogicalPlan, conf: rc.RapidsConf):
        super().__init__(plan, conf)
        self.child_metas = [PlanMeta(c, conf) for c in plan.children]
        self.expr_metas: List[ExprMeta] = [
            ExprMeta(e, conf) for e in _node_expressions(plan)]

    def tag(self) -> None:
        for reason in node_reasons(self.wrapped, self.conf):
            self.will_not_work(reason)
        for em in self.expr_metas:
            em.tag()
            if not em.can_replace:
                self.will_not_work(
                    f"expression {type(em.wrapped).__name__} cannot run on "
                    f"the device: {'; '.join(_deep_reasons(em))}")
        for c in self.child_metas:
            c.tag()

    def explain_lines(self, depth: int = 0, all_nodes: bool = True):
        lines = super().explain_lines(depth, all_nodes)
        for em in self.expr_metas:
            if em.reasons:
                lines.extend(em.explain_lines(depth + 1, False))
        return lines


def _deep_reasons(meta: BaseMeta) -> List[str]:
    """Every reason in an expression meta tree (the inner reason, a per-op
    disable say, is what the user needs to see)."""
    out = list(meta.reasons)
    for c in meta.child_metas:
        out.extend(_deep_reasons(c))
    return out


def tag_expression(e: Expression, conf: rc.RapidsConf) -> List[str]:
    """Every reason ``e`` does not run on the device ([] when it does)."""
    em = ExprMeta(e, conf)
    em.tag()
    return _deep_reasons(em)


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




class TpuOverrides:
    """Logical plan -> TpuExec tree on one device, with the CPU fallback;
    its operators bound to ``catalog`` (the session's spill catalog)."""

    def __init__(self, conf: rc.RapidsConf, device, catalog=None):
        self.conf = conf
        self.device = device
        self.catalog = catalog
        self.fusion_enabled = conf.get(rc.FUSION_ENABLED)
        self.hash_enabled = conf.get(rc.PALLAS_HASH_ENABLED)
        self.hash_table_slots = conf.get(rc.PALLAS_HASH_TABLE_SLOTS) \
            if self.hash_enabled else None
        self._chain_nodes: set = set()
        self.last_explain: str = ""
        self.last_cbo: List[str] = []

    def tag(self, plan: L.LogicalPlan) -> PlanMeta:
        """The plan's tagged meta tree (the optimizer's reasons
        included); sets ``last_explain`` and ``last_cbo`` and prints the
        explain that ``spark.rapids.sql.explain`` asks for."""
        meta = PlanMeta(plan, self.conf)
        meta.tag()
        self.last_cbo = []
        if self.conf.get(rc.CBO_ENABLED):
            import torch

            from spark_rapids_tpu_torch.plan.cbo import CostBasedOptimizer
            cbo = CostBasedOptimizer(self.conf,
                                     torch.device(self.device).type)
            cbo.optimize(meta)
            self.last_cbo = cbo.explain
        self.last_explain = "\n".join(meta.explain_lines())
        mode = self.conf.explain
        if mode == "ALL":
            print(self.last_explain)
        elif mode == "NOT_ON_TPU":
            lines = meta.explain_lines(all_nodes=False)
            if lines:
                print("\n".join(lines))
        return meta

    def apply(self, plan: L.LogicalPlan):
        _pushdown_pass(plan)
        meta = self.tag(plan)
        self._chain_nodes = set()
        return self._bind(self._convert(meta))

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
        _check_no_options(node)
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

    def _convert(self, meta: PlanMeta):
        node = meta.wrapped
        if isinstance(node, L.Aggregate) and not meta.reasons:
            fused = self._try_fuse_aggregate(meta)
            if fused is not None:
                return fused
        # Limit(Sort) -> TopN (the TakeOrderedAndProject rewrite), when
        # both run on the device
        if isinstance(node, L.Limit) and not meta.reasons and \
                isinstance(node.child, L.Sort) and \
                not meta.child_metas[0].reasons:
            sort_meta = meta.child_metas[0]
            return TpuTopNExec(node.n, node.child.orders,
                               self._convert(sort_meta.child_metas[0]))
        if isinstance(node, (L.Project, L.Filter)) and not meta.reasons:
            fused = self._try_fuse_chain(meta)
            if fused is not None:
                return fused
        children = [self._convert(c) for c in meta.child_metas]
        if not meta.reasons:
            return self._convert_node(node, children)
        name = type(node).__name__
        if self.conf.get(rc.TEST_ENABLED):
            allowed = [a.strip() for a in
                       self.conf.get(rc.TEST_ALLOWED_NON_TPU).split(",")]
            if name not in allowed:
                raise RuntimeError(
                    f"{name} fell back to CPU in strict test mode: "
                    f"{'; '.join(meta.reasons)}")
        from spark_rapids_tpu_torch.exec.fallback import CpuFallbackExec
        return CpuFallbackExec(node, children, self.device,
                               reasons=meta.reasons)

    def _convert_node(self, node: L.LogicalPlan, children):
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
        assert isinstance(node, L.Limit), type(node)
        return TpuLocalLimitExec(node.n, children[0])

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

    @staticmethod
    def _fusible_member(meta: PlanMeta) -> bool:
        """A chain member the fuser can take: a Project or Filter that
        runs on the device."""
        return isinstance(meta.wrapped, (L.Project, L.Filter)) and \
            not meta.reasons

    def _try_fuse_chain(self, meta: PlanMeta) -> Optional[FusedStageExec]:
        """Collapse a maximal run of device Project/Filter members into
        one FusedStageExec; a member that falls back ends the run."""
        if id(meta.wrapped) in self._chain_nodes:
            return None  # inner member of an already-detected chain
        exprs = None
        conds: List[Expression] = []
        cur = meta
        members: List[str] = []
        ids: List[int] = []
        while self._fusible_member(cur):
            node = cur.wrapped
            exprs, conds = compose_chain(exprs, conds, node,
                                         node.child.schema)
            members.append(type(node).__name__)
            ids.append(id(node))
            cur = cur.child_metas[0]
        if len(members) < 2:
            return None
        self._chain_nodes.update(ids)
        fusion_metrics.bump("fusibleChains")
        if not self.fusion_enabled:
            return None
        fusion_metrics.bump("fusedStages")
        fusion_metrics.bump("fusedOperators", len(members))
        return FusedStageExec(exprs, conds, self._convert(cur), members)

    def _try_fuse_aggregate(self, meta: PlanMeta):
        """Fold the device Project/Filter chain under an Aggregate into
        it: projections compose into the key/aggregate expressions,
        predicates become its row mask (bottom-first)."""
        node: L.Aggregate = meta.wrapped
        group = list(node.group_exprs)
        aggs = list(node.agg_exprs)
        conds: List[Expression] = []
        cur = meta.child_metas[0]
        hops = 0
        ids: List[int] = []
        while self._fusible_member(cur):
            inner = cur.wrapped
            if isinstance(inner, L.Project):
                repl = inner.exprs
                group = [substitute_bound(e, repl) for e in group]
                aggs = [substitute_bound(e, repl) for e in aggs]
                conds = [substitute_bound(c, repl) for c in conds]
            else:
                conds = [inner.condition] + conds
            ids.append(id(inner))
            cur = cur.child_metas[0]
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


def _check_no_options(node: L.FileRelation) -> None:
    """Reader options (a CSV's ``header``, ``sep`` ...) are not honoured
    by the port's readers, device or CPU: setting one raises rather than
    reading the files some other way."""
    if node.options:
        raise NotImplementedError(
            f"reader options {sorted(node.options)} are not supported "
            f"by the PyTorch port's readers")
