"""Logical plan nodes.

Counterpart of ``spark_rapids_tpu/plan/logical.py``, cut to the nodes this
slice plans: an in-memory relation, Project, Filter and Aggregate.  The
DataFrame API builds them and ``plan/overrides.py`` lowers them to
physical operators.
"""

from __future__ import annotations

import copy
from typing import List, Sequence, Tuple

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops.aggregates import AggregateFunction
from spark_rapids_tpu_torch.ops.expressions import (
    ColVal, EmitContext, Expression)

Schema = List[Tuple[str, DataType]]


class AggregateExpression(Expression):
    """Expression wrapper around an AggregateFunction."""

    def __init__(self, func: AggregateFunction):
        self.func = func
        self.children = (func.child,) if func.child is not None else ()

    def with_children(self, children):
        f = copy.copy(self.func)
        f.child = children[0] if children else None
        return AggregateExpression(f)

    @property
    def dtype(self) -> DataType:
        return self.func.result_dtype

    @property
    def nullable(self) -> bool:
        return self.func.result_nullable

    @property
    def name(self) -> str:
        arg = self.func.child.name if self.func.child is not None else "*"
        return f"{self.func.name}({arg})"

    def emit(self, ctx: EmitContext) -> ColVal:
        raise RuntimeError("AggregateExpression is planned by "
                           "TpuHashAggregateExec, never emitted directly")

    def cache_key(self):
        return ("AggregateExpression", self.func.cache_key())

    def __str__(self):
        return self.name


class LogicalPlan:
    children: Tuple["LogicalPlan", ...] = ()

    @property
    def schema(self) -> Schema:
        raise NotImplementedError



class InMemoryRelation(LogicalPlan):
    def __init__(self, batches: Sequence[ColumnarBatch], schema: Schema):
        self.batches = list(batches)
        self._schema = list(schema)

    @property
    def schema(self) -> Schema:
        return self._schema


class Project(LogicalPlan):
    def __init__(self, exprs: Sequence[Expression], child: LogicalPlan):
        self.exprs = [e.bind(child.schema) for e in exprs]
        self.children = (child,)

    @property
    def child(self):
        return self.children[0]

    @property
    def schema(self) -> Schema:
        return [(e.name, e.dtype) for e in self.exprs]


class Filter(LogicalPlan):
    def __init__(self, condition: Expression, child: LogicalPlan):
        self.condition = condition.bind(child.schema)
        self.children = (child,)

    @property
    def child(self):
        return self.children[0]

    @property
    def schema(self) -> Schema:
        return self.child.schema


class Aggregate(LogicalPlan):
    """``group_exprs`` may be empty (grand-total reduction)."""

    def __init__(self, group_exprs: Sequence[Expression],
                 agg_exprs: Sequence[Expression], child: LogicalPlan):
        self.group_exprs = [e.bind(child.schema) for e in group_exprs]
        self.agg_exprs = [e.bind(child.schema) for e in agg_exprs]
        self.children = (child,)

    @property
    def child(self):
        return self.children[0]

    @property
    def schema(self) -> Schema:
        out = [(e.name, e.dtype) for e in self.group_exprs]
        out += [(e.name, e.dtype) for e in self.agg_exprs]
        return out
