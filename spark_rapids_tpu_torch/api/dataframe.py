"""DataFrame and GroupedData.

Counterpart of ``spark_rapids_tpu/api/dataframe.py``, cut to select
(window functions lift into a Window node), filter, withColumn,
withColumnRenamed, groupBy/agg/count, rollup/cube/groupingSets,
keyless agg, distinct, joins on column names or on expression
conditions, crossJoin, orderBy/sort, limit, union, temp views, count,
collect and to_pandas.  A DataFrame is a logical plan; collecting it
offers the plan to the distributed planner
when the session holds a shard group, else (or when the planner declines)
plans the query on the session's device, runs the operators and fetches
the result in one counted sync.
"""

from __future__ import annotations

from typing import List, Optional, Union

from spark_rapids_tpu_torch.api.functions import Col, SortKey, _expr
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, empty_batch
from spark_rapids_tpu_torch.exec.window import WindowExpression
from spark_rapids_tpu_torch.memory.retry import retry_metrics
from spark_rapids_tpu_torch.ops import predicates as preds
from spark_rapids_tpu_torch.ops.expressions import (
    Alias, Expression, UnresolvedColumn)
from spark_rapids_tpu_torch.parallel.dist_planner import try_distributed
from spark_rapids_tpu_torch.plan import logical as L


def _contains_window(e: Expression) -> bool:
    if isinstance(e, WindowExpression):
        return True
    return any(_contains_window(c) for c in e.children)


def _conjuncts(e: Expression) -> List[Expression]:
    if isinstance(e, preds.And):
        return _conjuncts(e.children[0]) + _conjuncts(e.children[1])
    return [e]


class DataFrame:
    def __init__(self, session, plan: L.LogicalPlan):
        self.session = session
        self.plan = plan
        self._last_exec = None

    @property
    def schema(self):
        return self.plan.schema

    @property
    def columns(self) -> List[str]:
        return [n for n, _ in self.plan.schema]

    def select(self, *cols: Union[Col, str]) -> "DataFrame":
        exprs = [_expr(c) for c in cols]
        needs = _file_meta_needs(exprs, self.plan.schema)
        if needs:
            return self._with_file_meta(needs).select(*cols)
        exprs = _expand_metadata(exprs, self.plan.schema)
        win_idx = {i for i, e in enumerate(exprs) if _contains_window(e)}
        if not win_idx:
            return DataFrame(self.session, L.Project(exprs, self.plan))
        # lift every WindowExpression (top-level or inside arithmetic,
        # e.g. rev * 100 / sum(rev) over (...)) into a hidden column of
        # one Window node, then project the rewritten expressions
        child_names = self.columns
        prefix = "__w"
        while any(n.startswith(prefix) for n in child_names):
            prefix += "_"
        wexprs: List = []

        def extract(e):
            if isinstance(e, WindowExpression):
                h = f"{prefix}{len(wexprs)}"
                wexprs.append((h, e))
                return UnresolvedColumn(h)
            if not e.children:
                return e
            return e.with_children([extract(c) for c in e.children])

        final: List[Expression] = []
        for i, e in enumerate(exprs):
            if i not in win_idx:
                final.append(e)
                continue
            out_name = e.name if not isinstance(e, Alias) else None
            r = extract(e)
            # a bare window (or windowed arithmetic) keeps its output
            # name; an Alias keeps its own
            final.append(r if out_name is None else Alias(r, out_name))
        wplan = L.Window(wexprs, self.plan)
        return DataFrame(self.session, L.Project(final, wplan))

    def filter(self, condition: Col) -> "DataFrame":
        cond = _expr(condition)
        needs = _file_meta_needs([cond], self.plan.schema)
        if needs:
            return self._with_file_meta(needs).filter(condition)
        return DataFrame(self.session, L.Filter(cond, self.plan))

    def _with_file_meta(self, needs: set) -> "DataFrame":
        attached = _attach_file_meta(self.plan, needs)
        if attached is None:
            raise ValueError(
                "input_file_name()/_metadata are only available above a "
                "file scan (optionally through filter/limit/sort)")
        return DataFrame(self.session, attached)

    def withColumn(self, name: str, c: Col) -> "DataFrame":
        """Replace the column ``name`` in place, or append it."""
        wrapped = Alias(_expr(c), name)
        names = [n for n, _ in self.plan.schema]
        exprs: List[Expression] = [
            wrapped if n == name else UnresolvedColumn(n) for n in names]
        if name not in names:
            exprs.append(wrapped)
        return self.select(*exprs)

    def distinct(self) -> "DataFrame":
        """An Aggregate over every column, with no aggregates."""
        return DataFrame(self.session, L.Aggregate(
            [UnresolvedColumn(n) for n, _ in self.plan.schema], [],
            self.plan))

    def count(self) -> int:
        from spark_rapids_tpu_torch.api import functions as F
        return int(self.agg(F.count().alias("n")).collect()[0][0])

    def withColumnRenamed(self, old: str, new: str) -> "DataFrame":
        exprs = [Alias(UnresolvedColumn(n), new) if n == old
                 else UnresolvedColumn(n) for n, _ in self.plan.schema]
        return DataFrame(self.session, L.Project(exprs, self.plan))

    def groupBy(self, *cols: Union[Col, str]) -> "GroupedData":
        return GroupedData(self, [_expr(c) for c in cols])

    group_by = groupBy

    def rollup(self, *cols: Union[Col, str]) -> "GroupedData":
        """GROUP BY ROLLUP: subtotals (a, b) -> (a) -> (), lowered
        through Expand."""
        from spark_rapids_tpu_torch.exec.expand import rollup_sets
        exprs = [_expr(c) for c in cols]
        return GroupedData(self, exprs, sets=rollup_sets(len(exprs)))

    def cube(self, *cols: Union[Col, str]) -> "GroupedData":
        """GROUP BY CUBE: all 2^n subsets of the grouping columns."""
        from spark_rapids_tpu_torch.exec.expand import cube_sets
        exprs = [_expr(c) for c in cols]
        return GroupedData(self, exprs, sets=cube_sets(len(exprs)))

    def groupingSets(self, sets, *cols: Union[Col, str]) -> "GroupedData":
        """GROUPING SETS: ``sets`` lists lists of column names, each a
        subset of ``cols``."""
        exprs = [_expr(c) for c in cols]
        names = [e.name for e in exprs]
        idx_sets = []
        for st in sets:
            idx = []
            for item in st:
                nm = item if isinstance(item, str) else _expr(item).name
                if nm not in names:
                    raise ValueError(
                        f"grouping set column {nm!r} is not in the "
                        f"grouping columns {names}")
                idx.append(names.index(nm))
            idx_sets.append(idx)
        return GroupedData(self, exprs, sets=idx_sets)

    def agg(self, *aggs: Col) -> "DataFrame":
        return GroupedData(self, []).agg(*aggs)

    def join(self, other: "DataFrame", on, how: str = "inner"
             ) -> "DataFrame":
        """Join on column names present on both sides (USING semantics:
        one output column per key), or on a condition (a Col, or a list
        of Cols ANDed together).  A condition's equi conjuncts (a left
        expression == a right expression) become the join keys and the
        rest its residual; the two sides must then have distinct column
        names.  ``how="cross"`` with ``on=None`` is the cross join."""
        how = {"left_outer": "left", "right_outer": "right",
               "outer": "full", "full_outer": "full", "leftsemi": "semi",
               "left_semi": "semi", "leftanti": "anti",
               "left_anti": "anti"}.get(how, how)
        if how not in ("inner", "left", "right", "full", "semi", "anti",
                       "cross"):
            raise ValueError(f"unknown join type {how!r}")
        if how == "cross" and on is None:
            return self.crossJoin(other)
        if isinstance(on, str) or (isinstance(on, (list, tuple)) and on and
                                   all(isinstance(k, str) for k in on)):
            keys = [on] if isinstance(on, str) else list(on)
            lk = [UnresolvedColumn(k) for k in keys]
            rk = [UnresolvedColumn(k) for k in keys]
            return DataFrame(self.session, L.Join(
                self.plan, other.plan, lk, rk, how, using=keys))
        if isinstance(on, (list, tuple)):
            # the PySpark form: a list of conditions, ANDed
            exprs = [_expr(c) for c in on]
            if not exprs:
                raise ValueError("join needs a condition or column names")
            combined = exprs[0]
            for c in exprs[1:]:
                combined = preds.And(combined, c)
            on = Col(combined)
        cond = _expr(on)
        lnames = set(self.columns)
        rnames = set(other.columns)
        dup = lnames & rnames
        if dup:
            raise ValueError(
                f"expression joins need distinct column names on the two "
                f"sides; duplicated: {sorted(dup)}")

        def side_of(e):
            refs = _references(e)
            if refs and refs <= lnames:
                return "l"
            if refs and refs <= rnames:
                return "r"
            return None

        lk, rk, residual = [], [], []
        for c in _conjuncts(cond):
            if isinstance(c, preds.EqualTo):
                a, b = c.children
                sa, sb = side_of(a), side_of(b)
                if sa == "l" and sb == "r":
                    lk.append(a)
                    rk.append(b)
                    continue
                if sa == "r" and sb == "l":
                    lk.append(b)
                    rk.append(a)
                    continue
            residual.append(c)
        condition = None
        if residual:
            condition = residual[0]
            for c in residual[1:]:
                condition = preds.And(condition, c)
        if how == "cross":
            # a cross join under a condition is the inner join on it
            how = "inner"
        return DataFrame(self.session, L.Join(
            self.plan, other.plan, lk, rk, how, condition=condition))

    def crossJoin(self, other: "DataFrame") -> "DataFrame":
        return DataFrame(self.session, L.Join(
            self.plan, other.plan, [], [], "cross"))

    def orderBy(self, *keys: Union[Col, str, SortKey]) -> "DataFrame":
        orders = []
        for k in keys:
            if isinstance(k, SortKey):
                orders.append((k.expr, k.descending, k.nulls_first))
            else:
                orders.append((_expr(k), False, True))
        return DataFrame(self.session, L.Sort(orders, self.plan))

    sort = orderBy

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(self.session, L.Limit(n, self.plan))

    def union(self, other: "DataFrame") -> "DataFrame":
        """UNION ALL (by position, under this DataFrame's names)."""
        return DataFrame(self.session, L.Union([self.plan, other.plan]))

    def createOrReplaceTempView(self, name: str) -> None:
        self.session.register_view(name, self)

    def _execute_batches(self) -> List[ColumnarBatch]:
        """Run the plan: distributed when the session's shard group takes
        it, else on the session's device, through the asynchronous
        pipeline unless ``spark.rapids.tpu.pipeline.enabled`` is off."""
        from spark_rapids_tpu_torch.config import rapids_conf as rc
        got = try_distributed(self.session, self.plan)
        if got is not None:
            return got
        exec_plan = self.session.plan(self.plan)
        self._last_exec = exec_plan
        conf = self.session.conf
        # the planner bound the operators to this session's catalog
        cat = self.session.memory_catalog
        host0, disk0 = cat.spilled_to_host_total, cat.spilled_to_disk_total
        retry0 = retry_metrics.snapshot_local()
        try:
            if not conf.get(rc.PIPELINE_ENABLED):
                self.session.last_pipeline_stats = None
                return list(exec_plan.execute())
            from spark_rapids_tpu_torch.exec.pipeline import (
                PipelineStats, pipelined)
            stats = PipelineStats(conf.get(rc.PIPELINE_DEPTH))
            try:
                return list(pipelined(exec_plan.execute(), stats.depth,
                                      stats, self.session.device, cat))
            finally:
                self.session.last_pipeline_stats = stats
        finally:
            # this query's share of the session's spill counters and of
            # this thread's OOM recoveries
            retry1 = retry_metrics.snapshot_local()
            self.session.last_memory_stats = {
                "spilledToHostBytes": cat.spilled_to_host_total - host0,
                "spilledToDiskBytes": cat.spilled_to_disk_total - disk0,
                **{k: retry1[k] - retry0[k] for k in retry1}}

    @property
    def write(self):
        from spark_rapids_tpu_torch.io.writers import DataFrameWriter
        return DataFrameWriter(self)

    def to_arrow(self):
        import pyarrow as pa
        batches = self._execute_batches()
        if not batches:
            return empty_batch(self.plan.schema,
                               self.session.device).to_arrow()
        return pa.concat_tables(b.to_arrow() for b in batches)

    def to_pandas(self):
        return self.to_arrow().to_pandas()

    def collect(self) -> List[tuple]:
        table = self.to_arrow()
        cols = [table.column(i).to_pylist()
                for i in range(table.num_columns)]
        return list(zip(*cols)) if cols else []

    def explain(self) -> str:
        """The physical plan this DataFrame runs as (on one device), then
        the logical plan and the planner's tagging: each node marked
        ``*`` runs on the device, each marked ``!`` falls back to the CPU
        with its reasons (``session.overrides.last_explain``).  With the
        cost-based optimizer on, its decisions follow."""
        exec_plan = self.session.plan(self.plan)
        ov = self.session.overrides
        parts = [exec_plan.tree_string(), "== Logical Plan ==",
                 self.plan.tree_string(), "== Overrides ==",
                 ov.last_explain]
        if ov.last_cbo:
            parts += ["== Cost-Based Optimizer =="] + list(ov.last_cbo)
        return "\n".join(parts)


def _file_meta_needs(exprs, schema) -> set:
    """The file-metadata column groups these expressions reference that
    the schema does not hold yet."""
    present = {n for n, _ in schema}
    needs = set()
    for e in exprs:
        for r in _references(e):
            if r == L.FileRelation.INPUT_FILE_COL and r not in present:
                needs.add("input_file")
            elif (r == "_metadata" or r.startswith("_metadata.")) and \
                    L.FileRelation.META_COLUMNS[0] not in present:
                needs.add("metadata")
    return needs


def _attach_file_meta(plan: L.LogicalPlan, needs: set):
    """The plan rebuilt with the metadata columns enabled on its
    FileRelation leaf, or None.  The columns append to the end of the
    scan's schema, so the bound ordinals of a Filter, Limit or Sort
    between stay valid; any other node in between is refused (as in
    Spark, metadata columns resolve against the scan)."""
    import copy
    if isinstance(plan, L.FileRelation):
        new = copy.copy(plan)
        new.pushed_filters = list(plan.pushed_filters)
        new.file_meta = set(plan.file_meta) | needs
        return new
    if isinstance(plan, (L.Filter, L.Limit, L.Sort)):
        child = _attach_file_meta(plan.children[0], needs)
        if child is None:
            return None
        new = copy.copy(plan)
        new.children = (child,)
        return new
    return None


def _expand_metadata(exprs, schema) -> List[Expression]:
    """A bare ``_metadata`` reference selects its four fields.  The port
    has no struct columns: they come out as the flat columns
    ``_metadata.file_path``, ``_metadata.file_name``,
    ``_metadata.file_size`` and ``_metadata.file_modification_time``
    (the JAX package's shredded layout of the struct)."""
    out = []
    for e in exprs:
        if isinstance(e, UnresolvedColumn) and e.col_name == "_metadata" \
                and "_metadata" not in {n for n, _ in schema}:
            out.extend(UnresolvedColumn(n)
                       for n in L.FileRelation.META_COLUMNS)
        else:
            out.append(e)
    return out


def _references(e: Expression) -> set:
    """Names of the unresolved columns an expression reads."""
    if isinstance(e, UnresolvedColumn):
        return {e.col_name}
    out = set()
    for c in e.children:
        out |= _references(c)
    return out


class GroupedData:
    def __init__(self, df: DataFrame, group_exprs: List[Expression],
                 sets: Optional[List[List[int]]] = None):
        self.df = df
        self.group_exprs = group_exprs
        self.sets = sets  # rollup / cube / grouping sets: index lists

    def agg(self, *aggs: Col) -> DataFrame:
        if self.sets is not None:
            return self._agg_grouping_sets(aggs)
        return DataFrame(self.df.session, L.Aggregate(
            self.group_exprs, [_expr(a) for a in aggs], self.df.plan))

    def _agg_grouping_sets(self, aggs) -> DataFrame:
        """Rollup / cube / grouping sets: an Expand (one projection per
        set, the rolled-up keys nulled, plus the grouping-id literal),
        an Aggregate keyed on (keys..., grouping id), and a projection
        that resolves ``grouping()`` / ``grouping_id()``."""
        import numpy as np
        from spark_rapids_tpu_torch.api.functions import (
            _GroupingIdMarker, _GroupingMarker)
        from spark_rapids_tpu_torch.columnar import dtypes as dts
        from spark_rapids_tpu_torch.exec.expand import (
            GROUPING_ID_COL, Expand, grouping_set_projections)
        from spark_rapids_tpu_torch.ops import arithmetic as arith
        from spark_rapids_tpu_torch.ops.cast import Cast
        from spark_rapids_tpu_torch.ops.expressions import Literal

        child = self.df.plan
        child_names = [n for n, _ in child.schema]
        n = len(self.group_exprs)
        # a bare column groups as itself; a computed key is materialized
        # as a hidden column first
        group_cols: List[str] = []
        pre_exprs: List[Expression] = []
        for i, e in enumerate(self.group_exprs):
            if isinstance(e, UnresolvedColumn) and \
                    e.col_name in child_names:
                group_cols.append(e.col_name)
            else:
                hidden = e.name if e.name not in child_names \
                    else f"__gs{i}"
                pre_exprs.append(Alias(e, hidden))
                group_cols.append(hidden)
        base = child
        if pre_exprs:
            base = L.Project(
                [UnresolvedColumn(c) for c in child_names] + pre_exprs,
                child)
        base_names = [nm for nm, _ in base.schema]
        # the key slots are copies of the grouping columns (nulled per
        # set); the base columns pass through, so an aggregate over a
        # grouping column still sees the real values
        key_exprs = [UnresolvedColumn(c).bind(base.schema)
                     for c in group_cols]
        projections = grouping_set_projections(
            key_exprs, self.sets,
            [UnresolvedColumn(nm) for nm in base_names])
        key_slots = [f"__gk{i}" for i in range(n)]
        expand = Expand(
            projections, key_slots + base_names + [GROUPING_ID_COL], base)
        gid_ref = UnresolvedColumn(GROUPING_ID_COL)

        def rewrite(e: Expression) -> Expression:
            if isinstance(e, _GroupingIdMarker):
                return gid_ref
            if isinstance(e, _GroupingMarker):
                target = e.children[0].name
                if target not in group_cols:
                    raise ValueError(
                        f"grouping({target}) references a non-grouping "
                        f"column; grouping columns: {group_cols}")
                bit = n - 1 - group_cols.index(target)
                return Cast(arith.BitwiseAnd(
                    arith.ShiftRight(gid_ref, Literal(bit)),
                    Literal(np.int64(1))), dts.INT32)
            if not e.children:
                return e
            return e.with_children([rewrite(c) for c in e.children])

        def has_marker(e):
            if isinstance(e, (_GroupingIdMarker, _GroupingMarker)):
                return True
            return any(has_marker(c) for c in e.children)

        agg_items: List[Expression] = []
        final_tail: List[Expression] = []
        for a in aggs:
            e = _expr(a)
            if has_marker(e):
                r = rewrite(e)
                final_tail.append(r if isinstance(r, Alias)
                                  else Alias(r, e.name))
            else:
                agg_items.append(e)
                final_tail.append(UnresolvedColumn(e.name))
        agg_plan = L.Aggregate(
            [Alias(UnresolvedColumn(s), c)
             for s, c in zip(key_slots, group_cols)] + [gid_ref],
            agg_items, expand)
        final = [UnresolvedColumn(c) for c in group_cols] + final_tail
        return DataFrame(self.df.session, L.Project(final, agg_plan))

    def count(self) -> DataFrame:
        from spark_rapids_tpu_torch.api import functions as F
        return self.agg(F.count().alias("count"))
