"""DataFrame and GroupedData.

Counterpart of ``spark_rapids_tpu/api/dataframe.py``, cut to select
(window functions lift into a Window node, explode/posexplode into a
Generate node, struct and map outputs expand into their shredded flat
columns), filter, withColumn,
withColumnRenamed, groupBy/agg/count, rollup/cube/groupingSets,
keyless agg, distinct, joins on column names or on expression
conditions, crossJoin, orderBy/sort, limit, union, temp views, count,
collect and to_pandas (shredded struct and map columns reassemble in
``to_arrow``), and a groupBy over ``window(...)`` (a sliding window
through an Expand, as Spark's TimeWindowing rule), and user code and
reuse: ``cache``/``persist``/``unpersist``, ``mapInPandas``,
``groupBy().applyInPandas``, grouped-aggregate pandas UDFs in ``agg``,
window pandas UDFs in ``select``, ``cogroup`` and ``pivot`` (the values
listed).  A DataFrame is a
logical plan; collecting it
offers the plan to the distributed planner
when the session holds a shard group, else (or when the planner declines)
plans the query on the session's device, runs the operators and fetches
the result in one counted sync.

Every action (``collect``, ``to_pandas``, ``to_arrow``, a write) runs in
the query envelope of ``_execute_batches``: a per-query context, plan
templates and the result cache when they are on, admission, a stage
lineage log on a sharded session, the recovery driver, a watchdog query
scope per attempt, and QueryStart/QueryEnd records when the session has
an event log.
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


def _has_udf_call(e: Expression) -> bool:
    from spark_rapids_tpu_torch.udf.python_exec import UDFCall
    return isinstance(e, UDFCall) or any(_has_udf_call(c)
                                         for c in e.children)


def _parse_schema(schema):
    """``"a int, b string"`` or ``[(name, DataType)]`` -> a schema."""
    from spark_rapids_tpu_torch.columnar.dtypes import dtype_from_name
    if isinstance(schema, str):
        out = []
        for part in schema.split(","):
            name, tname = part.strip().split(None, 1)
            out.append((name, dtype_from_name(tname)))
        return out
    return list(schema)


class PivotedGroupedData:
    """``groupBy(k).pivot(p, [v1, v2]).agg(...)``: each aggregate over x
    becomes, per pivot value v, the same aggregate over ``CASE WHEN p = v
    THEN x END`` (every aggregate ignores nulls), so no new operator is
    needed and the answer is GpuPivotFirst's."""

    def __init__(self, df: "DataFrame", group_exprs, pivot_expr, values):
        self.df = df
        self.group_exprs = group_exprs
        self.pivot_expr = pivot_expr
        self.values = values

    def agg(self, *aggs: Col) -> "DataFrame":
        import copy
        from spark_rapids_tpu_torch.ops.expressions import Literal
        from spark_rapids_tpu_torch.plan.logical import AggregateExpression
        agg_exprs = [_expr(a) for a in aggs]
        out: List[Expression] = []
        for v in self.values:
            for e in agg_exprs:
                alias = e.alias if isinstance(e, Alias) else None
                inner = e.children[0] if isinstance(e, Alias) else e
                if not isinstance(inner, AggregateExpression):
                    raise ValueError("pivot aggregates must be aggregate "
                                     "expressions")
                func = copy.copy(inner.func)
                cond = preds.EqualTo(self.pivot_expr, Literal(v))
                if func.child is not None:
                    child_name = func.child.name
                    func.child = preds.CaseWhen([(cond, func.child)])
                else:
                    # count(*): count the rows where p = v
                    child_name = "*"
                    func.child = preds.CaseWhen([(cond, Literal(1))])
                if len(agg_exprs) == 1:
                    name = str(v)
                else:
                    name = f"{v}_{alias}" if alias else \
                        f"{v}_{func.name}({child_name})"
                out.append(Alias(AggregateExpression(func), name))
        return DataFrame(self.df.session, L.Aggregate(
            self.group_exprs, out, self.df.plan))

    def sum(self, c) -> "DataFrame":  # noqa: A003
        from spark_rapids_tpu_torch.api import functions as F
        return self.agg(F.sum(c))

    def count(self) -> "DataFrame":
        from spark_rapids_tpu_torch.api import functions as F
        return self.agg(F.count(Col(self.pivot_expr)))

    def min(self, c) -> "DataFrame":  # noqa: A003
        from spark_rapids_tpu_torch.api import functions as F
        return self.agg(F.min(c))

    def max(self, c) -> "DataFrame":  # noqa: A003
        from spark_rapids_tpu_torch.api import functions as F
        return self.agg(F.max(c))

    def avg(self, c) -> "DataFrame":
        from spark_rapids_tpu_torch.api import functions as F
        return self.agg(F.avg(c))


class CoGroupedData:
    """``a.groupBy(k).cogroup(b.groupBy(k2)).applyInPandas(fn, schema)``:
    ``fn(left_group, right_group)`` per key of the union of keys
    (GpuFlatMapCoGroupsInPandasExec)."""

    def __init__(self, left: "GroupedData", right: "GroupedData"):
        self.left = left
        self.right = right

    def applyInPandas(self, fn, schema) -> "DataFrame":
        return DataFrame(self.left.df.session, L.CoGroupMapInPandas(
            fn, _parse_schema(schema),
            [e.name for e in self.left.group_exprs],
            [e.name for e in self.right.group_exprs],
            self.left.df.plan, self.right.df.plan))


class DataFrame:
    def __init__(self, session, plan: L.LogicalPlan):
        self.session = session
        self.plan = plan
        self._last_exec = None
        # plan-template state (plan/template.py): the TemplateInfo of the
        # current execution (set afresh per _execute_batches), and the
        # PreparedStatement this frame runs for, whose template and
        # physical plan its runs reuse
        self._template = None
        self._prepared = None

    @property
    def schema(self):
        return self.plan.schema

    @property
    def columns(self) -> List[str]:
        return [n for n, _ in self.plan.schema]

    def select(self, *cols: Union[Col, str]) -> "DataFrame":
        from spark_rapids_tpu_torch.ops.nested_ops import (
            expand_nested_projections)
        routed = self._route_pandas_windows(cols)
        if routed is not None:
            return routed
        exprs = [_expr(c) for c in cols]
        routed = self._route_batch_ids(exprs)
        if routed is not None:
            return routed
        needs = _file_meta_needs(exprs, self.plan.schema)
        if needs:
            return self._with_file_meta(needs).select(*cols)
        exprs = expand_nested_projections(exprs, self.plan.schema)
        gen = self._route_generate(exprs)
        if gen is not None:
            return gen
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

    def _route_pandas_windows(self, cols) -> Optional["DataFrame"]:
        """Window pandas UDF calls become a WindowInPandas node, then the
        requested columns are selected over it.  Their result columns take
        internal names, so replacing an existing column (withColumn)
        never duplicates a schema entry."""
        from spark_rapids_tpu_torch.api.functions import _PandasWindowCall

        def call_of(c):
            if isinstance(c, _PandasWindowCall):
                return c, c.out_name
            return None, None

        marked = [call_of(c) for c in cols]
        if not any(m for m, _ in marked):
            return None
        prefix = "_pw"
        while any(n.startswith(prefix) for n in self.columns):
            prefix += "_"
        calls, final = [], []
        for c, (m, out_name) in zip(cols, marked):
            if m is None:
                final.append(c)
                continue
            internal = f"{prefix}{len(calls)}"
            calls.append((internal, m.call.fn, m.call.arg_name,
                          m.call.return_type, m.spec_data()))
            final.append(Col(Alias(UnresolvedColumn(internal), out_name)))
        base = DataFrame(self.session, L.WindowInPandas(calls, self.plan))
        return base.select(*final)

    def _route_generate(self, exprs) -> Optional["DataFrame"]:
        """F.explode / F.posexplode in a select become a Generate node
        (Spark plans Generate the same way): the other expressions pass
        through, repeated for each element."""
        from spark_rapids_tpu_torch.api.functions import _ExplodeMarker

        def marker_of(e):
            inner = e.children[0] if isinstance(e, Alias) else e
            return inner if isinstance(inner, _ExplodeMarker) else None

        gens = [(i, e, marker_of(e)) for i, e in enumerate(exprs)
                if marker_of(e) is not None]
        if not gens:
            return None
        if len(gens) > 1:
            raise ValueError("only one explode per select is supported")
        i, e, m = gens[0]
        required = [x for j, x in enumerate(exprs) if j != i]
        col_name = e.alias if isinstance(e, Alias) else "col"
        return DataFrame(self.session, L.Generate(
            m.children[0], required, m.position, self.plan,
            col_name=col_name))

    def _route_batch_ids(self, exprs) -> Optional["DataFrame"]:
        """monotonically_increasing_id() / spark_partition_id() need the
        batch they are in: a BatchId node adds their columns and the
        markers read them."""
        from spark_rapids_tpu_torch.ops.misc_exprs import _BatchIdMarker

        def has_marker(e):
            return isinstance(e, _BatchIdMarker) or any(
                has_marker(c) for c in e.children)

        def rewrite(e):
            if isinstance(e, _BatchIdMarker):
                return UnresolvedColumn("__mid" if e.kind == "mid"
                                        else "__pid")
            if not e.children:
                return e
            return e.with_children([rewrite(c) for c in e.children])

        if not any(has_marker(e) for e in exprs):
            return None
        out = []
        for e in exprs:
            r = rewrite(e)
            if isinstance(r, UnresolvedColumn) and r.col_name in (
                    "__mid", "__pid"):
                r = Alias(r, e.name)
            out.append(r)
        return DataFrame(self.session, L.Project(out, L.BatchId(self.plan)))

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
        from spark_rapids_tpu_torch.api.functions import _PandasWindowCall
        if isinstance(c, _PandasWindowCall):
            wrapped = c.alias(name)
            names = self.columns
            cols = [wrapped if n == name else n for n in names]
            if name not in names:
                cols.append(wrapped)
            return self.select(*cols)
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
        """A struct key (``F.window(...)``, ``F.struct(...)``) groups by
        one key per field, named ``<struct>.<field>`` so that the output
        reassembles the struct; a sliding window must be the only key."""
        from spark_rapids_tpu_torch.ops.datetime_ops import TimeWindow
        from spark_rapids_tpu_torch.ops.nested_ops import CreateNamedStruct
        exprs: List[Expression] = []
        for c in cols:
            e = _expr(c)
            inner = e
            while isinstance(inner, Alias):
                inner = inner.children[0]
            if not isinstance(inner, CreateNamedStruct):
                exprs.append(e)
                continue
            first = inner.pairs[0][1]
            if isinstance(first, TimeWindow) and \
                    first.slide_us < first.window_us:
                if len(cols) != 1:
                    raise ValueError("sliding window(...) must be the only "
                                     "grouping column")
                return self._group_by_sliding_window(e, first)
            name = e.name if isinstance(e, Alias) else "struct"
            exprs.extend(Alias(fe, f"{name}.{fn}") for fn, fe in inner.pairs)
        return GroupedData(self, exprs)

    def _group_by_sliding_window(self, aliased, tw) -> "GroupedData":
        """Sliding windows: a row falls in up to ceil(window / slide)
        overlapping windows.  An Expand makes one copy of each row per
        overlap, a filter keeps the copies whose window holds the
        timestamp, and the group keys are (start, end) (Spark's
        TimeWindowing rule)."""
        from spark_rapids_tpu_torch.exec.expand import Expand
        from spark_rapids_tpu_torch.ops.datetime_ops import TimeWindow
        name = aliased.name if isinstance(aliased, Alias) else "window"
        s_col, e_col = f"{name}.start", f"{name}.end"
        k = -(-tw.window_us // tw.slide_us)
        base_names = [n for n, _ in self.plan.schema]
        projections = []
        for i in range(k):
            shift = i * tw.slide_us
            proj: List[Expression] = [UnresolvedColumn(n)
                                      for n in base_names]
            for field, col in (("start", s_col), ("end", e_col)):
                proj.append(Alias(TimeWindow(tw.child, tw.window_us,
                                             tw.slide_us, tw.start_us,
                                             field, shift), col))
            projections.append(proj)
        expand = Expand(projections, base_names + [s_col, e_col],
                        self.plan)
        cond = preds.GreaterThan(UnresolvedColumn(e_col), tw.child)
        return GroupedData(DataFrame(self.session, L.Filter(cond, expand)),
                           [UnresolvedColumn(s_col),
                            UnresolvedColumn(e_col)])

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

    # ---------------------------------------------------------- caching --
    def cache(self) -> "DataFrame":
        """Mark this plan for caching: the first action that runs it
        materializes it as compressed host frames, and every later query
        holding this plan reads them (``exec/cache.py``)."""
        self.session.cache_manager.register(self.plan)
        return self

    persist = cache

    def unpersist(self) -> "DataFrame":
        self.session.cache_manager.unregister(self.plan)
        return self

    @property
    def is_cached(self) -> bool:
        return self.session.cache_manager.lookup(self.plan) is not None

    def mapInPandas(self, fn, schema) -> "DataFrame":
        """``fn(iterator of pandas frames) -> iterator of frames`` over
        the batches, its output coerced to ``schema``."""
        return DataFrame(self.session, L.MapInPandas(
            fn, _parse_schema(schema), self.plan))

    # ------------------------------------------------------------ actions --
    def _execute_batches(self) -> List[ColumnarBatch]:
        """Run the plan inside the query envelope (reference
        ``api/dataframe.py:600-753``): a ``QueryContext`` (the per-query
        scope for event attribution, checkpoint lineage, budgets and
        injection scoping, whose exit purges stale thread-ident
        adoptions); plan templates (``spark.rapids.tpu.template.enabled``
        hoists the literals, a prepared statement brings its own
        template); the result cache, asked before admission and again
        after a real admission wait (a twin ahead in the queue may have
        stored the answer); admission (a typed ``AdmissionFault`` rejects
        this query only); the shared stage store or a per-query lineage
        log on a sharded session; then the recovery driver, which
        re-drives classified transient faults down the ladder (retry ->
        spill -> smaller batches -> one device -> CPU) and re-raises
        fatal ones untouched.  A fresh answer is stored on success."""
        import contextlib

        import torch

        from spark_rapids_tpu_torch.config import rapids_conf as rc
        from spark_rapids_tpu_torch.robustness.checkpoint import (
            CheckpointManager)
        from spark_rapids_tpu_torch.robustness.driver import QueryRetryDriver
        from spark_rapids_tpu_torch.serving.context import QueryContext
        from spark_rapids_tpu_torch.serving.reuse import in_tick_execution
        # a new thread's current CUDA device is cuda:0: a query driven
        # from any thread runs with the session's device current, and
        # issues its work to that device's default stream, which every
        # query of the session shares (exec/pipeline.py)
        session = self.session
        dev = session.device
        on_device = torch.cuda.device(dev) if dev.type == "cuda" \
            else contextlib.nullcontext()
        with on_device, QueryContext(session) as ctx:
            tick = in_tick_execution()
            prep = self._prepared
            info = None
            if prep is not None:
                info = self._template = prep.info
            elif not tick and session.conf.get(rc.TEMPLATE_ENABLED):
                from spark_rapids_tpu_torch.plan.template import (
                    hoist_literals)
                info = hoist_literals(self.plan)
                self._template = info if info.hoisted else None
            else:
                self._template = None
            if info is not None:
                # the template's facts ride the QueryEnd sharing dict
                # (only with templates on: the stream is otherwise as it
                # was)
                ctx.sharing["template"] = {
                    "fingerprint": info.fingerprint[:16],
                    "params": info.param_count,
                    "refusals": sorted({r for r, _ in info.refusals}),
                }
            cache = getattr(session, "result_cache", None)
            if tick:
                cache = None
            use_template_cache = (
                cache is not None and self._template is not None
                and session.conf.get(rc.TEMPLATE_RESULT_CACHE_ENABLED))
            if prep is not None and not use_template_cache:
                # a prepared frame's plan still holds the literals of
                # prepare time, whatever the binding: its exact key would
                # alias every binding to the first one's answer
                cache = None
            pend = None
            if use_template_cache:
                # a template plan's exact key carries no binding, so a
                # templated run keys the template tier only
                pend = cache.offer_template(self._template)
            elif cache is not None:
                pend = cache.offer(self.plan)
            if pend is not None and pend.hit:
                return self._answer_from_cache(pend)
            ctx.admit()
            if pend is not None and ctx.admission_wait_ms > 0.5:
                # this query queued: an identical query ahead of it may
                # have stored the answer meanwhile; its miss is counted
                pend = cache.offer_template(self._template, count_miss=False) \
                    if use_template_cache else \
                    cache.offer(self.plan, count_miss=False)
                if pend.hit:
                    return self._answer_from_cache(pend)
            driver = QueryRetryDriver(session)
            # the shared stage store rides as this query's checkpoint
            # manager when on; else a per-query lineage log
            shared = getattr(session, "shared_stages", None)
            use_shared = (shared is not None and shared.enabled
                          and not tick
                          and getattr(session, "shards", None) is not None
                          and session.checkpoints is None)
            mgr = None
            if use_shared:
                session.checkpoints = shared
            else:
                mgr = CheckpointManager.for_query(session)
            try:
                batches = driver.run(self._attempt_batches)
                if pend is not None:
                    cache.store(pend, batches)
                return batches
            except Exception as exc:
                # a fatal or exhausted ladder still writes its recovery,
                # watchdog and checkpoint trail, so a post-mortem sees
                # what was tried
                self._flush_fatal_trail(driver, exc)
                raise
            finally:
                if use_shared:
                    # detach only: the store's entries outlive the query;
                    # drain a tally no QueryEnd took (events off)
                    shared.take_query_stats()
                    if session.checkpoints is shared:
                        session.checkpoints = None
                elif mgr is not None:
                    mgr.finish()

    def _answer_from_cache(self, pend) -> List[ColumnarBatch]:
        """A result-cache hit: a complete (trivial) QueryStart/QueryEnd
        pair, so the event stream sees the query, then the stored
        batches, on the host: no operator runs."""
        events = getattr(self.session, "events", None)
        note = "template-cache hit" if pend.tier == "template" \
            else "result-cache hit"
        if events is not None and events.enabled:
            qid = next(self.session._query_ids)
            self.session._current_qid = qid
            events.emit("QueryStart", queryId=qid,
                        logicalPlan=self.plan.tree_string(),
                        physicalPlan="ResultCache", explain=note)
            events.emit("QueryEnd", queryId=qid, status="success",
                        durationMs=0.0, metrics={}, spill={}, retry={},
                        sharing=self._sharing_info(), explain=note)
        self.session.last_dist_explain = note
        return pend.batches

    def _flush_fatal_trail(self, driver, exc: BaseException) -> None:
        ev = getattr(self.session, "events", None)
        if ev is None or not ev.enabled:
            return
        from spark_rapids_tpu_torch.robustness.watchdog import (
            watchdog_metrics)
        mgr = getattr(self.session, "checkpoints", None)
        try:
            ev.emit(
                "QueryFatal",
                queryId=getattr(self.session, "_current_qid", None),
                error=f"{type(exc).__name__}: {exc}",
                recovery=list(getattr(driver, "trail", [])),
                watchdog=watchdog_metrics.snapshot(),
                checkpoint=mgr.snapshot() if mgr is not None else {})
        except Exception:
            pass  # the post-mortem record must never mask the fault

    def _attempt_batches(self, mode) -> List[ColumnarBatch]:
        """One attempt in a watchdog query scope: a stale cancellation
        token of an earlier attempt is cleared, and the query's deadline
        (``serving.deadlineBudgetMs``, else
        ``watchdog.queryDeadlineMs``) bounds this attempt's wall time:
        an overrun is a retryable TimeoutFault at the next checkpoint."""
        from spark_rapids_tpu_torch.robustness import watchdog
        from spark_rapids_tpu_torch.serving import context as qc
        ctx = qc.current()
        deadline = ctx.deadline_budget_ms \
            if ctx is not None and ctx.deadline_budget_ms else None
        with watchdog.query_scope(self.session, deadline_ms=deadline):
            return self._attempt_batches_impl(mode)

    def _admission_info(self) -> dict:
        """What admission cost this query (QueryEnd payload)."""
        from spark_rapids_tpu_torch.serving import context as qc
        ctx = qc.current()
        return ctx.admission_info() if ctx is not None else {}

    def _sharing_info(self) -> dict:
        """The QueryEnd ``sharing`` dict: the result cache's hit and miss
        notes (a store lands after the envelope and rides its
        ResultCacheStore event), the template's facts, the shared stage
        store's write and splice tallies for this query, and the
        interleaver's wait and slice accounting.  Empty, and so absent
        from the event, with every reuse setting off."""
        from spark_rapids_tpu_torch.serving import context as qc
        ctx = qc.current()
        out = {}
        if ctx is not None:
            out.update(ctx.sharing)
            t = ctx.interleave_ticket
            if t is not None:
                out["interleave"] = t.info()
        shared = getattr(self.session, "shared_stages", None)
        if shared is not None and shared.enabled:
            out.update(shared.take_query_stats())
        return out

    def _attempt_batches_impl(self, mode) -> List[ColumnarBatch]:
        import time as _time
        from spark_rapids_tpu_torch.api.session import TpuSession
        # conf resolved at call time follows the session EXECUTING the
        # query, not the last-constructed one
        TpuSession._active = self.session
        # a failure before this attempt draws its qid must not inherit
        # the previous query's id on its RecoveryAction events
        self.session._current_qid = None
        group = getattr(self.session, "shards", None)
        if group is not None and \
                (not mode.use_mesh or mode.batch_scale != 1.0):
            self.session.last_dist_explain = (
                "demoted: single-device replan (query recovery)"
                if mode.batch_scale == 1.0 else
                "demoted: single-device split-batch replan "
                "(query recovery)")
        template = self._template
        if group is not None and template is not None:
            # the sharded path's stages thread no parameters: a templated
            # plan runs on one device (as in the JAX package)
            self.session.last_dist_explain = (
                "template: single-process execution "
                "(parameterized kernels)")
        if mode.use_mesh and mode.batch_scale == 1.0 and \
                not mode.cpu_only and group is not None and \
                template is None:
            # a sharded session offers the plan to the distributed
            # planner first; a plan it declines falls through to the
            # single-device engine, which opens its own envelope.  The
            # split rung skips this: the sharded plan has no batch knob
            from spark_rapids_tpu_torch.parallel.shuffle import (
                shuffle_metrics)
            from spark_rapids_tpu_torch.utils import tracing
            events = getattr(self.session, "events", None)
            t0 = _time.perf_counter()
            wire0 = shuffle_metrics.snapshot()
            # the envelope opens BEFORE execution, so what the attempt
            # emits on the way (RecoveryAction, WatchdogTrip) carries
            # this attempt's qid
            qid = None
            if events is not None and events.enabled:
                qid = next(self.session._query_ids)
                self.session._current_qid = qid
                events.emit(
                    "QueryStart", queryId=qid,
                    logicalPlan=self.plan.tree_string(),
                    physicalPlan="DistributedPlan",
                    explain="distributed attempt")

            def _end(status, shuffle):
                # the span drain runs for every exit, events on or off
                wall_ms = (_time.perf_counter() - t0) * 1e3
                spans = tracing.finish_query(self.session, qid,
                                             wall_ms, status)
                if qid is not None:
                    sh = self._sharing_info()
                    # the lineage log's counters, where one is attached
                    mgr = self.session.checkpoints
                    ck = {"checkpoint": mgr.snapshot()} \
                        if mgr is not None else {}
                    events.emit(
                        "QueryEnd", queryId=qid, status=status,
                        durationMs=round(wall_ms, 3),
                        metrics={}, spill={}, retry={},
                        distributed=True, shuffle=shuffle,
                        fusion={}, spans=spans,
                        admission=self._admission_info(),
                        **({"sharing": sh} if sh else {}), **ck,
                        explain=self.session.last_dist_explain)

            try:
                dist = try_distributed(self.session, self.plan,
                                       resume=mode.resume)
            except Exception as exc:
                _end(f"failed: {type(exc).__name__}: {exc}", {})
                raise
            if dist is not None:
                wire1 = shuffle_metrics.snapshot()
                _end("success", {k: wire1[k] - wire0[k] for k in wire1})
                return dist
            _end("success", {})
        overrides = None
        if mode.batch_scale != 1.0:
            # split rung: re-plan with the scan and coalesce batch sizes
            # scaled down, through a one-off planner (batch sizes are
            # captured into the operators at plan time), so the
            # session's conf never changes under concurrent queries
            from spark_rapids_tpu_torch.config import rapids_conf as rc
            from spark_rapids_tpu_torch.plan.overrides import TpuOverrides
            conf = self.session.conf
            for entry in (rc.READER_BATCH_SIZE_ROWS, rc.BATCH_SIZE_BYTES):
                conf = conf.set(entry.key, max(
                    1, int(conf.get(entry) * mode.batch_scale)))
            overrides = TpuOverrides(
                conf, self.session.device, self.session.memory_catalog,
                semaphore=self.session.semaphore,
                cache_manager=self.session.cache_manager)
        return self._run_single_process(mode, overrides)

    def _drive(self, exec_plan) -> List[ColumnarBatch]:
        """Materialize the plan's batches through the asynchronous
        pipeline unless ``spark.rapids.tpu.pipeline.enabled`` is off.
        With the fair interleaver on, every batch pull passes its
        round-robin gate (on the pipeline's worker when pipelined: the
        thread that dispatches)."""
        from spark_rapids_tpu_torch.config import rapids_conf as rc
        conf = self.session.conf
        source = exec_plan.execute()
        sched = getattr(self.session, "interleaver", None)
        if sched is not None:
            from spark_rapids_tpu_torch.serving import context as qc
            ctx = qc.current()
            ticket = getattr(ctx, "interleave_ticket", None) \
                if ctx is not None else None
            if ticket is not None:
                source = sched.interleaved(source, ticket)
        if not conf.get(rc.PIPELINE_ENABLED):
            self.session.last_pipeline_stats = None
            return list(source)
        from spark_rapids_tpu_torch.exec.pipeline import (
            PipelineStats, pipelined)
        stats = PipelineStats(conf.get(rc.PIPELINE_DEPTH))
        try:
            return list(pipelined(source, stats.depth, stats,
                                  self.session.device,
                                  self.session.memory_catalog))
        finally:
            self.session.last_pipeline_stats = stats

    def _run_single_process(self, mode,
                            overrides=None) -> List[ColumnarBatch]:
        """Plan on the session's device (the whole plan on the CPU
        fallback on the ``cpu`` rung) and drive it, in the
        QueryStart/QueryEnd envelope when an event log is set (reference
        ``api/dataframe.py:838-1180``)."""
        import time as _time
        from spark_rapids_tpu_torch.utils import tracing
        template = self._template
        logical = template.plan if template is not None else self.plan
        prep = self._prepared
        if mode.cpu_only:
            exec_plan = self.session.plan_cpu_only(logical)
        elif prep is not None and template is not None and \
                overrides is None:
            # a prepared run on the first rung: the handle's physical
            # plan, no planning pass (a rung that re-plans, split or
            # cpu, plans afresh)
            exec_plan = prep.exec_plan
        else:
            exec_plan = self.session.plan(logical, overrides=overrides)
        self._last_exec = exec_plan
        events = getattr(self.session, "events", None)
        logging = events is not None and events.enabled
        qid = None
        if logging:
            qid = next(self.session._query_ids)
            # the recovery driver stamps RecoveryAction events with the
            # qid of the attempt that failed
            self.session._current_qid = qid
            events.emit("QueryStart", queryId=qid,
                        logicalPlan=self.plan.tree_string(),
                        physicalPlan=exec_plan.tree_string(),
                        explain=(overrides or
                                 self.session.overrides).last_explain)
        # the planner bound the operators to this session's catalog
        cat = self.session.memory_catalog
        host0, disk0 = cat.spilled_to_host_total, cat.spilled_to_disk_total
        # this thread's view: concurrent queries on other threads must
        # not count into this query's
        retry0 = retry_metrics.snapshot_local()
        t0 = _time.perf_counter()
        status = "success"
        try:
            return self._drive(exec_plan)
        except Exception as e:
            status = f"failed: {type(e).__name__}: {e}"
            raise
        finally:
            spill = {
                "spilledToHostBytes": cat.spilled_to_host_total - host0,
                "spilledToDiskBytes": cat.spilled_to_disk_total - disk0}
            retry1 = retry_metrics.snapshot_local()
            retry = {k: retry1[k] - retry0[k] for k in retry1}
            self.session.last_memory_stats = {**spill, **retry}
            wall_ms = (_time.perf_counter() - t0) * 1e3
            # the span drain runs with or without an event log, so trace
            # files exist for logless sessions too
            spans = tracing.finish_query(self.session, qid, wall_ms,
                                         status)
            if logging:
                ps = self.session.last_pipeline_stats
                sh = self._sharing_info()
                events.emit(
                    "QueryEnd", queryId=qid, status=status,
                    durationMs=round(wall_ms, 3),
                    metrics=exec_plan.collect_metrics(), spill=spill,
                    retry=retry,
                    pipeline=ps.as_dict() if ps is not None else {},
                    fusion={}, spans=spans,
                    admission=self._admission_info(),
                    **({"sharing": sh} if sh else {}))

    @property
    def write(self):
        from spark_rapids_tpu_torch.io.writers import DataFrameWriter
        return DataFrameWriter(self)

    def to_arrow(self):
        """The result as an arrow table; shredded struct and map columns
        reassemble here (``columnar/nested.assemble_table``)."""
        import pyarrow as pa
        from spark_rapids_tpu_torch.columnar import nested
        batches = self._execute_batches()
        if not batches:
            table = empty_batch(self.plan.schema,
                                self.session.device).to_arrow()
        else:
            table = pa.concat_tables(b.to_arrow() for b in batches)
        return nested.assemble_table(table)

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
        from spark_rapids_tpu_torch.api.functions import _PandasAggCall
        if self.sets is not None:
            return self._agg_grouping_sets(aggs)
        pandas_aggs = [a for a in aggs if isinstance(a, _PandasAggCall)]
        if pandas_aggs:
            if len(pandas_aggs) != len(aggs):
                raise ValueError("cannot mix grouped-agg pandas UDFs with "
                                 "built-in aggregates")
            return DataFrame(self.df.session, L.AggInPandas(
                [e.name for e in self.group_exprs],
                [(a.out_name, a.fn, a.arg_name, a.return_type)
                 for a in pandas_aggs], self.df.plan))
        df, group_exprs, agg_exprs = self._extract_udf_calls(
            [_expr(a) for a in aggs])
        return DataFrame(self.df.session, L.Aggregate(
            group_exprs, agg_exprs, df.plan))

    def _extract_udf_calls(self, agg_exprs):
        """UDF calls in the keys or inside the aggregates move into a
        projection below the aggregate, as Spark's
        ExtractPythonUDFFromAggregate rule moves them: a black-box call
        then runs in ``TpuArrowEvalPythonExec`` and the aggregate on the
        device."""
        from spark_rapids_tpu_torch.udf.python_exec import UDFCall
        exprs = list(self.group_exprs) + list(agg_exprs)
        if not any(_has_udf_call(e) for e in exprs):
            return self.df, self.group_exprs, agg_exprs
        names = self.df.columns
        prefix = "__udf"
        while any(n.startswith(prefix) for n in names):
            prefix += "_"
        pre: List[Expression] = []

        def lift(e):
            if isinstance(e, UDFCall):
                hidden = f"{prefix}{len(pre)}"
                pre.append(Alias(e, hidden))
                return UnresolvedColumn(hidden)
            if not e.children:
                return e
            return e.with_children([lift(c) for c in e.children])

        def keep_name(e):
            if not _has_udf_call(e):
                return e
            if isinstance(e, Alias):
                return Alias(lift(e.children[0]), e.alias)
            return Alias(lift(e), e.name)

        group = [keep_name(e) for e in self.group_exprs]
        aggs = [keep_name(e) for e in agg_exprs]
        base = self.df.select(*([UnresolvedColumn(n) for n in names] + pre))
        return base, group, aggs

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

    def _simple(self, fname, *cols) -> DataFrame:
        from spark_rapids_tpu_torch.api import functions as F
        fn = getattr(F, fname)
        keys = {e.name for e in self.group_exprs}
        names = cols or [n for n, dt in self.df.plan.schema
                         if (dt.is_integral or dt.is_floating or
                             dt.is_decimal) and n not in keys]
        return self.agg(*[fn(c).alias(f"{fname}({c})") for c in names])

    def sum(self, *cols) -> DataFrame:  # noqa: A003
        return self._simple("sum", *cols)

    def avg(self, *cols) -> DataFrame:
        return self._simple("avg", *cols)

    mean = avg

    def min(self, *cols) -> DataFrame:  # noqa: A003
        return self._simple("min", *cols)

    def max(self, *cols) -> DataFrame:  # noqa: A003
        return self._simple("max", *cols)

    def pivot(self, col, values) -> PivotedGroupedData:
        """One output column per listed pivot value (GpuPivotFirst,
        AggregateFunctions.scala:530).  The values must be listed: Spark's
        form without them needs a distinct scan first."""
        if values is None:
            raise ValueError("pivot needs its values listed")
        return PivotedGroupedData(self.df, self.group_exprs, _expr(col),
                                  list(values))

    def applyInPandas(self, fn, schema) -> DataFrame:
        """``fn(group frame) -> frame`` per group of the keys."""
        return DataFrame(self.df.session, L.MapInPandas(
            fn, _parse_schema(schema), self.df.plan,
            group_names=[e.name for e in self.group_exprs]))

    def cogroup(self, other: "GroupedData") -> CoGroupedData:
        return CoGroupedData(self, other)
