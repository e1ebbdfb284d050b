"""DataFrame and GroupedData.

Counterpart of ``spark_rapids_tpu/api/dataframe.py``, cut to select,
filter, withColumn, withColumnRenamed, groupBy/agg/count, keyless agg,
distinct, equi-joins on column names, crossJoin, orderBy/sort, limit,
count, collect and to_pandas.
Expression-form join conditions are not ported yet.  A DataFrame is a
logical plan; collecting it offers the plan to the distributed planner
when the session holds a shard group, else (or when the planner declines)
plans the query on the session's device, runs the operators and fetches
the result in one counted sync.
"""

from __future__ import annotations

from typing import List, Union

from spark_rapids_tpu_torch.api.functions import Col, SortKey, _expr
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, empty_batch
from spark_rapids_tpu_torch.ops.expressions import (
    Alias, Expression, UnresolvedColumn)
from spark_rapids_tpu_torch.parallel.dist_planner import try_distributed
from spark_rapids_tpu_torch.plan import logical as L


class DataFrame:
    def __init__(self, session, plan: L.LogicalPlan):
        self.session = session
        self.plan = plan
        self._last_exec = None

    def select(self, *cols: Union[Col, str]) -> "DataFrame":
        return DataFrame(self.session,
                         L.Project([_expr(c) for c in cols], self.plan))

    def filter(self, condition: Col) -> "DataFrame":
        return DataFrame(self.session, L.Filter(_expr(condition), self.plan))

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

    def agg(self, *aggs: Col) -> "DataFrame":
        return GroupedData(self, []).agg(*aggs)

    def join(self, other: "DataFrame", on, how: str = "inner"
             ) -> "DataFrame":
        """Equi-join on column names present on both sides (USING
        semantics: one output column per key)."""
        how = {"left_outer": "left", "right_outer": "right",
               "outer": "full", "full_outer": "full", "leftsemi": "semi",
               "left_semi": "semi", "leftanti": "anti",
               "left_anti": "anti"}.get(how, how)
        if how not in ("inner", "left", "right", "full", "semi", "anti"):
            raise ValueError(f"unknown join type {how!r}")
        keys = [on] if isinstance(on, str) else list(on)
        if not keys or not all(isinstance(k, str) for k in keys):
            raise NotImplementedError(
                "join conditions other than column names are not ported")
        lk = [UnresolvedColumn(k) for k in keys]
        rk = [UnresolvedColumn(k) for k in keys]
        return DataFrame(self.session, L.Join(
            self.plan, other.plan, lk, rk, how, using=keys))

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

    def _execute_batches(self) -> List[ColumnarBatch]:
        got = try_distributed(self.session, self.plan)
        if got is not None:
            return got
        exec_plan = self.session.plan(self.plan)
        self._last_exec = exec_plan
        return list(exec_plan.execute())

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
        """The physical plan this DataFrame runs as."""
        return self.session.plan(self.plan).tree_string()


class GroupedData:
    def __init__(self, df: DataFrame, group_exprs: List[Expression]):
        self.df = df
        self.group_exprs = group_exprs

    def agg(self, *aggs: Col) -> DataFrame:
        return DataFrame(self.df.session, L.Aggregate(
            self.group_exprs, [_expr(a) for a in aggs], self.df.plan))

    def count(self) -> DataFrame:
        from spark_rapids_tpu_torch.api import functions as F
        return self.agg(F.count().alias("count"))
