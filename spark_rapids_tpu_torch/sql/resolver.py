"""Lower the SQL AST onto the DataFrame algebra.

Counterpart of ``spark_rapids_tpu/sql/resolver.py``, retargeted onto the
port's ``api``: every SQL construct becomes the equivalent programmatic
call, so the planner, the fused stages and the operators apply alike to
SQL and DataFrame queries.  Output names, hidden names (``__a{i}``,
``__g{i}``, ``__o{i}``) and the ``alias__col`` renames of duplicate
right-side columns are the JAX package's, letter for letter.

A function or construct the port does not run raises
``NotImplementedError`` naming it (the JAX package would run it, or send
it to its CPU fallback): never a silent wrong answer.

Aggregation lowering: each aggregate subtree in the projection/HAVING
gets a hidden name, the query groups by its keys with those aggregates,
and the outer expressions re-project against the hidden columns — which
is how ``sum(x) + 1`` or HAVING conditions compose without special
cases.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Dict, List, Optional, Tuple

from spark_rapids_tpu_torch.sql import parser as A

AGG_FNS = {"sum", "count", "avg", "mean", "min", "max", "first", "last",
           "collect_list", "collect_set", "stddev", "stddev_samp",
           "stddev_pop", "variance", "var_samp", "var_pop"}

WINDOW_RANK_FNS = {"row_number", "rank", "dense_rank", "percent_rank"}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch engine")


class Scope:
    """Name resolution for one FROM clause.

    Each source maps its ORIGINAL (SQL-visible) column names to the
    flat engine names (which differ after join-deduplication renames).
    A bare name appearing in two sources is ambiguous even when one
    side was renamed — matching Spark's analyzer."""

    def __init__(self):
        self.sources: List[Tuple[Optional[str], Dict[str, str]]] = []

    def add(self, alias: Optional[str], columns,
            renames: Optional[Dict[str, str]] = None):
        renames = renames or {}
        self.sources.append(
            (alias, {c: renames.get(c, c) for c in columns}))

    def all_columns(self) -> List[str]:
        out = []
        for _, m in self.sources:
            out.extend(v for v in m.values() if v not in out)
        return out

    def mapping_of(self, alias: str) -> Optional[Dict[str, str]]:
        for a, m in self.sources:
            if a == alias:
                return m
        return None

    def resolve(self, parts: Tuple[str, ...]) -> Tuple[str, Tuple[str, ...]]:
        """(qualified) name -> (flat column name, remaining struct path)."""
        if len(parts) >= 2 and self.mapping_of(parts[0]) is not None:
            alias, name, rest = parts[0], parts[1], parts[2:]
            m = self.mapping_of(alias)
            if name not in m:
                raise KeyError(
                    f"column {name!r} not found in {alias!r} "
                    f"(has {sorted(m)})")
            return m[name], rest
        name, rest = parts[0], parts[1:]
        hits = [(a, m[name]) for a, m in self.sources if name in m]
        flats = {f for _, f in hits}
        if len(hits) > 1 and len(flats) > 1:
            raise ValueError(
                f"column {name!r} is ambiguous "
                f"(in {[a for a, _ in hits]}); qualify it")
        if hits:
            return hits[0][1], rest
        if self.sources:
            all_cols = self.all_columns()
            if name not in all_cols and any(
                    c.startswith(name + ".") for c in all_cols):
                # a shredded struct or map: its fields are the flat
                # columns "name.field" (the JAX resolver raises here)
                return name, rest
            if name not in all_cols:
                raise KeyError(
                    f"column {name!r} not found; available: {all_cols}")
        return name, rest


class Resolver:
    def __init__(self, session):
        self.session = session
        from spark_rapids_tpu_torch.api import functions as F
        self.F = F

    # ------------------------------------------------------------ entry --
    def run(self, stmt: A.SelectStmt):
        df = self._select(stmt)
        while stmt.union_all is not None:
            stmt = stmt.union_all
            df = df.union(self._select(stmt))
        return df

    # ----------------------------------------------------------- select --
    def _select(self, stmt: A.SelectStmt):
        F = self.F
        scope = Scope()
        if stmt.from_ is None:
            df = self.session.range(1)
            scope.add(None, ["id"])
        else:
            df = self._from_item(stmt.from_, scope)
        for j in stmt.joins:
            df = self._join(df, j, scope)
        if stmt.where is not None:
            # top-level conjuncts that are IN (subquery) become
            # semi/anti joins (Spark's RewritePredicateSubquery); the
            # rest filter normally
            residual = None
            for conj in self._split_conjuncts(stmt.where):
                if isinstance(conj, A.InSubquery):
                    df = self._in_subquery_join(df, conj, scope)
                    continue
                c = self._expr(conj, scope)
                residual = c if residual is None else (residual & c)
            if residual is not None:
                df = df.filter(residual)

        aggs: Dict[str, object] = {}   # hidden name -> Col aggregate
        agg_keys: Dict[str, str] = {}  # structural key -> hidden name

        def lift_aggs(node):
            """Replace aggregate subtrees with hidden column refs.
            Under ROLLUP/CUBE/GROUPING SETS, grouping()/grouping_id()
            calls lift the same way — GroupedData.agg resolves their
            markers against the Expand-produced grouping-id column."""
            if isinstance(node, A.ScalarSubquery):
                return node  # opaque: its aggregates are its own
            if isinstance(node, A.FuncCall) and node.window is None \
                    and stmt.group_sets is not None \
                    and node.name in ("grouping", "grouping_id"):
                key = repr(node)
                if key not in agg_keys:
                    hidden = f"__a{len(aggs)}"
                    agg_keys[key] = hidden
                    if node.name == "grouping_id":
                        aggs[hidden] = self.F.grouping_id().alias(hidden)
                    else:
                        aggs[hidden] = self.F.grouping(
                            self._expr(node.args[0], scope)).alias(hidden)
                return A.ColRef((agg_keys[key],))
            if isinstance(node, A.FuncCall) and node.window is None \
                    and node.name in AGG_FNS:
                key = repr(node)
                if key not in agg_keys:
                    hidden = f"__a{len(aggs)}"
                    agg_keys[key] = hidden
                    aggs[hidden] = self._agg_call(node, scope).alias(hidden)
                return A.ColRef((agg_keys[key],))
            for f in getattr(node, "__dataclass_fields__", {}):
                v = getattr(node, f)
                if isinstance(v, list):
                    setattr(node, f, [lift_aggs(x) if hasattr(
                        x, "__dataclass_fields__") else x for x in v])
                elif hasattr(v, "__dataclass_fields__"):
                    setattr(node, f, lift_aggs(v))
            return node

        projections = self._expand_stars(stmt.projections, scope)
        has_aggs = stmt.group_by or any(
            self._contains_agg(p.expr) for p in projections) or (
            stmt.having is not None and self._contains_agg(stmt.having))
        group_alias: Dict[str, str] = {}  # flat group key -> out alias

        if has_aggs:
            # group keys: plain column refs group directly; computed
            # keys materialize as hidden columns first
            key_cols: List[str] = []
            pre_exprs = []
            # a struct key (window(...), struct(...)) groups through
            # DataFrame.groupBy, which shreds it (and expands a sliding
            # window); the JAX resolver materializes it and fails
            struct_keys: Dict[str, object] = {}
            for i, g in enumerate(stmt.group_by):
                if isinstance(g, A.FuncCall) and g.window is None and \
                        g.name in ("window", "struct"):
                    hidden = f"__g{i}"
                    struct_keys[hidden] = self._expr(g, scope).alias(hidden)
                    key_cols.append(hidden)
                elif isinstance(g, A.ColRef):
                    name, rest = scope.resolve(g.parts)
                    if rest:
                        raise ValueError(
                            "GROUP BY struct fields: alias the field in "
                            "a subquery first")
                    key_cols.append(name)
                else:
                    hidden = f"__g{i}"
                    pre_exprs.append(
                        self._expr(g, scope).alias(hidden))
                    key_cols.append(hidden)
            if pre_exprs:
                df = df.select(*[F.col(c) for c in scope.all_columns()],
                               *pre_exprs)
                scope.add(None, [k for k in key_cols
                                 if k.startswith("__g")])
            # re-projected GROUP BY expressions (SELECT cust/2 ... GROUP
            # BY cust/2) resolve to the materialized key column by
            # structural match, before aggregate lifting
            gmap = {repr(g): k for g, k in zip(stmt.group_by, key_cols)}

            def replace_group_exprs(node):
                if isinstance(node, A.ScalarSubquery):
                    return node  # opaque: its expressions are its own
                if hasattr(node, "__dataclass_fields__"):
                    if repr(node) in gmap:
                        return A.ColRef((gmap[repr(node)],))
                    for f in node.__dataclass_fields__:
                        v = getattr(node, f)
                        if isinstance(v, list):
                            setattr(node, f, [
                                replace_group_exprs(x) if hasattr(
                                    x, "__dataclass_fields__") else x
                                for x in v])
                        elif hasattr(v, "__dataclass_fields__"):
                            setattr(node, f, replace_group_exprs(v))
                return node

            proj_asts = [lift_aggs(replace_group_exprs(p.expr))
                         for p in projections]
            having_ast = lift_aggs(replace_group_exprs(stmt.having)) \
                if stmt.having is not None else None
            if not aggs and not key_cols:
                raise ValueError("grouped query with no aggregates")
            if stmt.group_sets is not None:
                df = df.groupingSets(
                    [[key_cols[i] for i in s] for s in stmt.group_sets],
                    *key_cols).agg(*aggs.values())
            else:
                df = df.group_by(*[struct_keys.get(k, k)
                                   for k in key_cols]).agg(*aggs.values())
            # post-agg scope: original aliases keep their surviving
            # group keys so qualified refs (c.name) still resolve; the
            # anonymous source holds only the hidden names
            post_scope = Scope()
            key_set = set(key_cols)
            for alias, m in scope.sources:
                kept = {o: f for o, f in m.items() if f in key_set}
                if kept:
                    post_scope.sources.append((alias, kept))
            post_scope.add(None, [k for k in key_cols
                                  if k.startswith("__g")]
                           + list(aggs.keys()))
            if having_ast is not None:
                df = df.filter(self._expr(having_ast, post_scope))
            out_cols = []
            out_names = []
            for p, ast in zip(projections, proj_asts):
                name = p.alias or self._default_name(p.expr)
                out_cols.append(self._expr(ast, post_scope).alias(name))
                out_names.append(name)
                # a bare projection of a group key under an alias
                # (SELECT ca.ca_state state ... GROUP BY ca.ca_state):
                # remember flat-key -> output-alias so a qualified
                # ORDER BY ref to the key can find its output column
                if isinstance(ast, A.ColRef) and len(ast.parts) == 1 \
                        and ast.parts[0] in key_cols:
                    group_alias.setdefault(ast.parts[0], name)
            df = df.select(*out_cols)
        else:
            if stmt.having is not None:
                raise ValueError("HAVING requires GROUP BY/aggregates")
            raw_cols = []
            out_names = []
            for p in projections:
                name = p.alias or self._default_name(p.expr)
                raw_cols.append(self._expr(p.expr, scope))
                out_names.append(name)
            # ORDER BY may mix output aliases with input columns the
            # projection drops (Spark allows both): materialize the
            # outputs alongside the inputs, sort once, then project
            if stmt.order_by and not stmt.distinct and any(
                    self._order_name(o, out_names) is None
                    for o in stmt.order_by):
                F = self.F
                # outputs materialize under hidden names so input
                # columns stay addressable for the sort (an alias may
                # shadow the input name it sorts by)
                prefix = "__o"
                in_names = scope.all_columns()
                while any(n.startswith(prefix) for n in in_names):
                    prefix += "_"
                hidden = [f"{prefix}{i}" for i in range(len(raw_cols))]
                ext = df.select(
                    *[F.col(c) for c in in_names],
                    *[c.alias(h) for c, h in zip(raw_cols, hidden)])
                keys = []
                for o in stmt.order_by:
                    name = self._order_name(o, out_names)
                    if name is not None:
                        keys.append(self._sortkey_for(
                            F.col(hidden[out_names.index(name)]), o))
                    else:
                        keys.append(self._order_sortkey(o, scope))
                df = ext.orderBy(*keys).select(
                    *[F.col(h).alias(n)
                      for h, n in zip(hidden, out_names)])
                stmt = dataclasses.replace(stmt, order_by=[])
            else:
                df = df.select(*[c.alias(n) for c, n in
                                 zip(raw_cols, out_names)])

        if stmt.distinct:
            df = df.distinct()
        if stmt.order_by:
            # DISTINCT also lacks a pre-projection fallback, so
            # qualified refs may match outputs there too — but only
            # when the qualifier really owns the named column
            df = df.orderBy(*[
                self._order_key(o, out_names,
                                grouped=has_aggs or stmt.distinct,
                                scope=scope, key_alias=group_alias)
                for o in stmt.order_by])
        if stmt.limit is not None:
            df = df.limit(stmt.limit)
        return df

    @staticmethod
    def _split_conjuncts(node):
        if isinstance(node, A.BinOp) and node.op == "and":
            yield from Resolver._split_conjuncts(node.left)
            yield from Resolver._split_conjuncts(node.right)
        else:
            yield node

    def _in_subquery_join(self, df, node: A.InSubquery, scope: Scope):
        """x IN (SELECT k FROM ...) -> semi join; NOT IN -> null-aware
        anti (SQL three-valued semantics: a NULL anywhere in the
        subquery makes NOT IN unknown for every row)."""
        F = self.F
        sub = self._select(node.query)
        sub_cols = [n for n, _ in sub.schema]
        if len(sub_cols) != 1:
            raise ValueError(
                "IN (subquery) must select exactly one column")
        key = self._expr(node.child, scope)
        rname = sub_cols[0]
        if rname in {n for n, _ in df.schema}:
            new = "__in_sub"
            sub = sub.withColumnRenamed(rname, new)
            rname = new
        if node.negated:
            # one aggregate pass answers both probes: count(*) for
            # emptiness, count(col) for null presence
            n_all, n_nonnull = sub.agg(
                F.count("*").alias("n"),
                F.count(F.col(rname)).alias("nn")).collect()[0]
            if n_all == 0:
                return df  # empty list: NOT IN is true for every row
            if n_nonnull < n_all:
                return df.limit(0)  # NULL present: never true
            return df.filter(key.isNotNull()).join(
                sub, on=key == F.col(rname), how="anti")
        return df.join(sub, on=key == F.col(rname), how="semi")

    # ------------------------------------------------------------- from --
    def _from_item(self, item, scope: Scope):
        if isinstance(item, A.SubqueryRef):
            sub = self._select(item.query)
            scope.add(item.alias, [n for n, _ in sub.schema])
            return sub
        df = self.session.table(item.name)
        cols = [n for n, _ in df.schema]
        scope.add(item.alias or item.name, cols)
        return df

    def _join(self, left, j: A.JoinClause, scope: Scope):
        right_scope = Scope()
        right = self._from_item(j.right, right_scope)
        ralias, rmap = right_scope.sources[0]
        rcols = list(rmap)
        if j.how == "cross":
            scope.add(ralias, rcols)
            out = left.join(right, on=None, how="cross")
            return out if j.on is None else out.filter(
                self._expr(j.on, scope))
        if j.using is not None:
            if j.how in ("semi", "anti"):
                # output is left-only; right columns leave scope
                scope.add(ralias, [])
                return left.join(right, on=j.using, how=j.how)
            # rename right-side non-key duplicates so qualified refs
            # (tb.v) resolve to the RIGHT side's values, not the left's
            lcols = set(scope.all_columns())
            dup = [c for c in rcols
                   if c not in j.using and c in lcols]
            renames = {}
            if dup:
                prefix = ralias or "r"
                renames = {c: f"{prefix}__{c}" for c in dup}
                for old, new in renames.items():
                    right = right.withColumnRenamed(old, new)
            scope.add(ralias, [c for c in rcols if c not in j.using],
                      renames=renames)
            return left.join(right, on=j.using, how=j.how)
        if j.on is None:
            raise ValueError("JOIN requires ON or USING")
        # deduplicate overlapping column names so the flat engine can
        # hold both sides; qualified refs resolve through the rename map
        lcols = set(scope.all_columns())
        dup = [c for c in rcols if c in lcols]
        keep_right = j.how not in ("semi", "anti")
        renames = {}
        if dup:
            prefix = ralias or "r"
            renames = {c: f"{prefix}__{c}" for c in dup}
            for old, new in renames.items():
                right = right.withColumnRenamed(old, new)
        if keep_right:
            scope.add(ralias, rcols, renames=renames)
            return left.join(right, on=self._expr(j.on, scope),
                             how=j.how)
        # semi/anti resolve the ON condition over both sides before
        # the scope narrows back to the left
        cond_scope = Scope()
        cond_scope.sources = list(scope.sources)
        cond_scope.add(ralias, rcols, renames=renames)
        return left.join(right, on=self._expr(j.on, cond_scope),
                         how=j.how)

    # ------------------------------------------------------ expressions --
    def _expand_stars(self, projections, scope: Scope):
        out = []
        for p in projections:
            if isinstance(p.expr, A.Star):
                if p.expr.table is None:
                    cols = scope.all_columns()
                else:
                    m = scope.mapping_of(p.expr.table)
                    if m is None:
                        raise KeyError(f"unknown table {p.expr.table!r}")
                    cols = list(m.values())
                out.extend(A.Projection(A.ColRef((c,)), None)
                           for c in cols)
            else:
                out.append(p)
        return out

    def _contains_agg(self, node) -> bool:
        if isinstance(node, A.ScalarSubquery):
            return False  # opaque: its aggregates are its own
        if isinstance(node, A.FuncCall) and node.window is None and \
                node.name in AGG_FNS:
            return True
        for f in getattr(node, "__dataclass_fields__", {}):
            v = getattr(node, f)
            if isinstance(v, list):
                if any(self._contains_agg(x) for x in v
                       if hasattr(x, "__dataclass_fields__")):
                    return True
            elif hasattr(v, "__dataclass_fields__") and \
                    self._contains_agg(v):
                return True
        return False

    def _default_name(self, ast) -> str:
        if isinstance(ast, A.ColRef):
            return ast.parts[-1]
        if isinstance(ast, A.FuncCall):
            return ast.name
        return "col"

    def _order_name(self, o: A.OrderItem, out_names: List[str],
                    allow_qualified: bool = False,
                    scope: Optional[Scope] = None,
                    key_alias: Optional[Dict[str, str]] = None
                    ) -> Optional[str]:
        """Output-column name an ORDER BY item refers to, or None when
        it must resolve against the pre-projection input.  In grouped/
        DISTINCT queries (``allow_qualified``) there is no input to
        fall back to, so a qualified ref (c.name) matches the output
        column its last part named — after validating the qualifier
        actually owns that column in ``scope``.  ``key_alias`` maps a
        GROUP BY key's flat column to the alias its projection gave it
        (SELECT ca.ca_state state ... ORDER BY ca.ca_state — Spark
        resolves the qualified ref against the grouping expression)."""
        if isinstance(o.expr, A.Lit) and isinstance(o.expr.value, int):
            pos = o.expr.value
            if not 1 <= pos <= len(out_names):
                raise ValueError(
                    f"ORDER BY position {pos} out of range "
                    f"(1..{len(out_names)})")
            return out_names[pos - 1]
        if isinstance(o.expr, A.ColRef):
            if len(o.expr.parts) == 1:
                # bare names resolve against the output; QUALIFIED refs
                # (t.c) name the input relation and fall through to
                # pre-projection resolution (Spark's behavior)
                if o.expr.parts[0] in out_names:
                    return o.expr.parts[0]
            elif allow_qualified:
                parts = o.expr.parts
                if len(parts) != 2:
                    raise ValueError(
                        f"ORDER BY {'.'.join(parts)}: multi-part "
                        "references are not supported in grouped/"
                        "DISTINCT queries; alias the expression")
                if scope is not None:
                    m = scope.mapping_of(parts[0])
                    if m is None:
                        raise KeyError(
                            f"unknown relation {parts[0]!r} in "
                            "ORDER BY")
                    flat = m.get(parts[1])
                    if flat is None:
                        raise KeyError(
                            f"column {parts[1]!r} not in relation "
                            f"{parts[0]!r}")
                    # provenance check: the qualifier's FLAT column
                    # (post join-dedup rename) must itself be the
                    # output — b.v must not silently sort by a's v
                    if flat in out_names:
                        return flat
                    # ... or a GROUP BY key whose aliased output is
                    # projected (Spark resolves a qualified ORDER BY
                    # ref against the grouping expressions)
                    if key_alias and flat in key_alias:
                        return key_alias[flat]
                    raise KeyError(
                        f"ORDER BY {parts[0]}.{parts[1]}: that "
                        "relation's column is not among the outputs")
                if parts[-1] in out_names:
                    return parts[-1]
        return None

    def _order_key(self, o: A.OrderItem, out_names: List[str],
                   grouped: bool = False,
                   scope: Optional[Scope] = None,
                   key_alias: Optional[Dict[str, str]] = None):
        """Post-projection sort key.  Qualified refs (t.c) may match
        output columns by last part only in GROUPED/DISTINCT queries,
        where no input relation survives to resolve them against."""
        F = self.F
        name = self._order_name(o, out_names, allow_qualified=grouped,
                                scope=scope, key_alias=key_alias)
        if name is None:
            raise ValueError(
                "ORDER BY supports output columns/aliases/positions "
                "(or input columns for non-aggregate queries)")
        c = F.col(name)
        if o.desc:
            return c.desc_nulls_first() if o.nulls_first else c.desc()
        if o.nulls_first is False:
            return c.asc_nulls_last()
        return c.asc()

    def _agg_call(self, node: A.FuncCall, scope: Scope):
        F = self.F
        if node.distinct:
            raise ValueError(f"{node.name.upper()}(DISTINCT ...) is not "
                             "supported; use a subquery with DISTINCT")
        fn = {"sum": F.sum, "count": F.count, "avg": F.avg,
              "mean": F.avg, "min": F.min, "max": F.max,
              "first": F.first, "last": F.last,
              "collect_list": F.collect_list,
              "collect_set": F.collect_set,
              "stddev": F.stddev, "stddev_samp": F.stddev_samp,
              "stddev_pop": F.stddev_pop, "variance": F.variance,
              "var_samp": F.var_samp, "var_pop": F.var_pop}.get(node.name)
        if fn is None:
            raise _not_ported(f"the aggregate {node.name}()")
        if node.name == "count" and (not node.args or
                                     isinstance(node.args[0], A.Star)):
            return F.count("*")
        return fn(self._expr(node.args[0], scope))

    def _window_call(self, node: A.FuncCall, scope: Scope):
        F = self.F
        w = node.window
        win = F.Window.partitionBy(
            *[self._expr(e, scope) for e in w.partition_by])
        if w.order_by:
            win = win.orderBy(*[self._order_sortkey(o, scope)
                                for o in w.order_by])
        if w.rows is not None:
            win = win.rowsBetween(w.rows[0], w.rows[1])
        if node.name in ("lead", "lag") and any(
                not isinstance(a, A.Lit) for a in node.args[1:]):
            raise ValueError(f"{node.name}: offset and default must be "
                             "literals")
        if node.name in WINDOW_RANK_FNS:
            return getattr(F, node.name)().over(win)
        if node.name in ("lead", "lag"):
            off = node.args[1].value if len(node.args) > 1 else 1
            default = node.args[2].value if len(node.args) > 2 else None
            return getattr(F, node.name)(
                self._expr(node.args[0], scope), off, default).over(win)
        wfn = {"sum": F.window_sum, "count": F.window_count,
               "min": F.window_min, "max": F.window_max,
               "avg": F.window_avg, "mean": F.window_avg}.get(node.name)
        if wfn is None:
            raise _not_ported(f"the window function {node.name}()")
        if node.name == "count" and (not node.args or
                                     isinstance(node.args[0], A.Star)):
            return wfn("*").over(win)
        return wfn(self._expr(node.args[0], scope)).over(win)

    def _order_sortkey(self, o: A.OrderItem, scope: Scope):
        return self._sortkey_for(self._expr(o.expr, scope), o)

    @staticmethod
    def _sortkey_for(c, o: A.OrderItem):
        if o.desc:
            return c.desc_nulls_first() if o.nulls_first else c.desc()
        if o.nulls_first is False:
            return c.asc_nulls_last()
        return c.asc()

    def _func(self, node: A.FuncCall, scope: Scope):
        F = self.F
        if node.window is not None:
            return self._window_call(node, scope)
        if node.name in AGG_FNS:
            return self._agg_call(node, scope)
        args = [self._expr(a, scope) for a in node.args]
        n = node.name

        def lit_arg(i):
            a = node.args[i]
            if not isinstance(a, A.Lit):
                raise ValueError(f"{n}: argument {i + 1} must be a "
                                 "literal")
            return a.value

        simple = {
            "exp": F.exp, "expm1": F.expm1, "ln": F.log,
            "asinh": F.asinh, "acosh": F.acosh, "atanh": F.atanh,
            "log2": F.log2, "log10": F.log10, "log1p": F.log1p,
            "sin": F.sin, "cos": F.cos, "tan": F.tan, "cot": F.cot,
            "asin": F.asin, "acos": F.acos, "atan": F.atan,
            "atan2": F.atan2, "sinh": F.sinh, "cosh": F.cosh,
            "tanh": F.tanh, "degrees": F.degrees, "radians": F.radians,
            "rint": F.rint, "signum": F.signum, "sign": F.signum,
            "cbrt": F.cbrt, "floor": F.floor, "ceil": F.ceil,
            "ceiling": F.ceil, "pmod": F.pmod, "sqrt": F.sqrt,
            "pow": F.pow, "power": F.pow, "hypot": F.hypot,
            "abs": F.abs, "coalesce": F.coalesce, "year": F.year,
            "month": F.month, "day": F.dayofmonth,
            "dayofmonth": F.dayofmonth, "datediff": F.datediff,
            "isnan": F.isnan, "greatest": F.greatest, "least": F.least,
            "length": F.length, "upper": F.upper, "lower": F.lower,
            "initcap": F.initcap, "concat": F.concat, "trim": F.trim,
            "ltrim": F.ltrim, "rtrim": F.rtrim,
            "dayofweek": F.dayofweek, "weekday": F.weekday,
            "dayofyear": F.dayofyear, "quarter": F.quarter,
            "hour": F.hour, "minute": F.minute, "second": F.second,
            "last_day": F.last_day, "unix_timestamp": F.unix_timestamp,
            "from_unixtime": F.from_unixtime,
            "months_between": F.months_between, "ascii": F.ascii,
            "char": F.chr, "chr": F.chr, "md5": F.md5, "hash": F.hash,
            "to_unix_timestamp": F.to_unix_timestamp,
            "size": F.size, "array": F.array, "element_at": F.element_at,
            "map_keys": F.map_keys, "map_values": F.map_values,
            "array_min": F.array_min, "array_max": F.array_max,
            "reverse": F.reverse, "struct": F.struct,
        }
        if n in simple:
            return simple[n](*args)
        if n in ("round", "bround"):
            fn = F.round if n == "round" else F.bround
            return fn(args[0], int(lit_arg(1)) if len(args) > 1 else 0)
        if n in ("shiftleft", "shiftright", "shiftrightunsigned"):
            return getattr(F, n)(args[0], int(lit_arg(1)))
        if n == "log":
            # one argument: the natural log; two: log(base, x) (Spark)
            return F.log(args[0]) if len(args) == 1 else \
                F.logarithm(args[0], args[1])
        if n in ("substring", "substr"):
            return F.substring(args[0], int(lit_arg(1)),
                               int(lit_arg(2)) if len(args) > 2
                               else 2 ** 31 - 1)
        if n == "date_add":
            return F.date_add(args[0], int(lit_arg(1)))
        if n == "date_sub":
            return F.date_sub(args[0], int(lit_arg(1)))
        if n == "next_day":
            return F.next_day(args[0], str(lit_arg(1)))
        if n == "add_months":
            return F.add_months(args[0], int(lit_arg(1)))
        if n == "trunc":
            return F.trunc(args[0], lit_arg(1))
        if n == "date_format":
            return F.date_format(args[0], lit_arg(1))
        if n == "concat_ws":
            return F.concat_ws(lit_arg(0), *args[1:])
        if n in ("lpad", "rpad"):
            return getattr(F, n)(args[0], int(lit_arg(1)),
                                 lit_arg(2) if len(args) > 2 else " ")
        if n == "locate":
            # locate(substr, str[, pos]): Spark's start position (the
            # JAX package reads only two arguments)
            return F.locate(lit_arg(0), args[1],
                            int(lit_arg(2)) if len(args) > 2 else 1)
        if n == "repeat":
            return F.repeat(args[0], int(lit_arg(1)))
        if n == "substring_index":
            return F.substring_index(args[0], lit_arg(1), int(lit_arg(2)))
        if n == "regexp_replace":
            return F.regexp_replace(args[0], lit_arg(1), lit_arg(2))
        if n == "replace":
            return F.replace(args[0], lit_arg(1),
                             lit_arg(2) if len(args) > 2 else "")
        if n == "translate":
            return F.translate(args[0], lit_arg(1), lit_arg(2))
        if n == "slice":
            return F.slice(args[0], int(lit_arg(1)), int(lit_arg(2)))
        if n == "array_repeat":
            return F.array_repeat(args[0], int(lit_arg(1)))
        if n == "get_json_object":
            return F.get_json_object(args[0], lit_arg(1))
        if n == "split":
            return F.split(args[0], lit_arg(1),
                           int(lit_arg(2)) if len(args) > 2 else -1)
        if n == "window":
            return F.window(args[0], lit_arg(1),
                            lit_arg(2) if len(args) > 2 else None)
        raise ValueError(f"unknown SQL function {n!r}")

    def _expr(self, node, scope: Scope):
        F = self.F
        if isinstance(node, A.Lit):
            if node.kind == "date":
                return F.lit(datetime.date.fromisoformat(node.value))
            if node.kind == "timestamp":
                import pandas as pd
                return F.lit(pd.Timestamp(node.value, tz="UTC")
                             .to_pydatetime())
            return F.lit(node.value)
        if isinstance(node, A.ColRef):
            name, rest = scope.resolve(node.parts)
            c = F.col(name)
            for field in rest:
                c = c.getField(field)
            return c
        if isinstance(node, A.BinOp):
            left = self._expr(node.left, scope)
            right = self._expr(node.right, scope)
            op = node.op
            if op == "and":
                return left & right
            if op == "or":
                return left | right
            if op == "=":
                return left == right
            if op in ("<>", "!="):
                return left != right
            if op == "<":
                return left < right
            if op == "<=":
                return left <= right
            if op == ">":
                return left > right
            if op == ">=":
                return left >= right
            if op == "+":
                return left + right
            if op == "-":
                return left - right
            if op == "*":
                return left * right
            if op == "/":
                return left / right
            if op == "%":
                return left % right
            raise ValueError(f"unknown operator {op!r}")
        if isinstance(node, A.UnOp):
            c = self._expr(node.child, scope)
            return ~c if node.op == "NOT" else -c
        if isinstance(node, A.IsNull):
            c = self._expr(node.child, scope)
            return c.isNotNull() if node.negated else c.isNull()
        if isinstance(node, A.Between):
            c = self._expr(node.child, scope)
            e = c.between(self._expr(node.lo, scope),
                          self._expr(node.hi, scope))
            return ~e if node.negated else e
        if isinstance(node, A.InList):
            c = self._expr(node.child, scope)
            vals = []
            for it in node.items:
                if not isinstance(it, A.Lit):
                    raise ValueError("IN list items must be literals")
                vals.append(it.value)
            e = c.isin(*vals)
            return ~e if node.negated else e
        if isinstance(node, A.LikeOp):
            c = self._expr(node.child, scope)
            e = c.like(node.pattern)
            return ~e if node.negated else e
        if isinstance(node, A.CaseExpr):
            if not node.whens:
                raise ValueError("CASE needs at least one WHEN")
            b = F.when(self._expr(node.whens[0][0], scope),
                       self._expr(node.whens[0][1], scope))
            for cond, val in node.whens[1:]:
                b = b.when(self._expr(cond, scope),
                           self._expr(val, scope))
            if node.else_ is not None and not (
                    isinstance(node.else_, A.Lit)
                    and node.else_.value is None):
                return b.otherwise(self._expr(node.else_, scope))
            # ELSE NULL == no else: CaseWhen emits a typed null from the
            # first branch's dtype post-bind
            return b
        if isinstance(node, A.CastExpr):
            from spark_rapids_tpu_torch.columnar.dtypes import (
                dtype_from_name)
            try:
                target = dtype_from_name(node.type_name)
            except ValueError:
                raise _not_ported(f"CAST to {node.type_name}") from None
            return self._expr(node.child, scope).cast(target)
        if isinstance(node, A.FuncCall):
            return self._func(node, scope)
        if isinstance(node, A.ScalarSubquery):
            # uncorrelated: runs once at resolve time, inlines the value
            # (Spark executes uncorrelated scalar subqueries the same
            # way — once, before the main query)
            sub = self._select(node.query)
            rows = sub.collect()
            if len(sub.schema) != 1 or len(rows) > 1:
                raise ValueError(
                    "scalar subquery must return at most one row, one "
                    f"column (got {len(rows)} rows x "
                    f"{len(sub.schema)} cols)")
            # the value keeps the subquery's type (a decimal sum stays
            # its decimal(p,s), which the value's digits would not give);
            # an empty scalar subquery yields NULL (SQL semantics)
            return F.lit(rows[0][0] if rows else None, sub.schema[0][1])
        if isinstance(node, A.InSubquery):
            raise ValueError(
                "IN (subquery) is only supported as a top-level WHERE "
                "conjunct")
        if isinstance(node, A.Star):
            raise ValueError("* is only valid as a projection or in "
                             "count(*)")
        raise ValueError(f"cannot resolve {node!r}")


def resolve(session, stmt: A.SelectStmt):
    return Resolver(session).run(stmt)
