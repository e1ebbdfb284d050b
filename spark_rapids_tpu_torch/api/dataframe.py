"""DataFrame and GroupedData.

Counterpart of ``spark_rapids_tpu/api/dataframe.py``, cut to select,
filter, groupBy/agg, keyless agg, collect and to_pandas.  A DataFrame is a
logical plan; collecting it plans the query on the session's device, runs
the operators and fetches the result in one counted sync.
"""

from __future__ import annotations

from typing import List, Union

from spark_rapids_tpu_torch.api.functions import Col, _expr
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, empty_batch
from spark_rapids_tpu_torch.ops.expressions import Expression
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

    def groupBy(self, *cols: Union[Col, str]) -> "GroupedData":
        return GroupedData(self, [_expr(c) for c in cols])

    def agg(self, *aggs: Col) -> "DataFrame":
        return GroupedData(self, []).agg(*aggs)

    def _execute_batches(self) -> List[ColumnarBatch]:
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
