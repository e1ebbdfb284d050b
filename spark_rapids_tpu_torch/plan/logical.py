"""Logical plan nodes.

Counterpart of ``spark_rapids_tpu/plan/logical.py``, cut to the nodes the
ported slices plan: an in-memory relation, a file relation, Range,
Project (also the plan node of ``withColumnRenamed``), Filter,
Aggregate, Join (equi-join keys and an optional residual condition),
Sort, Limit, Union and Window (``exec/expand.py`` holds Expand, as in
the JAX package).  The
DataFrame API builds them and ``plan/overrides.py`` lowers them to
physical operators.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence, Tuple

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

    def describe(self) -> str:
        return f"{type(self).__name__}[{', '.join(n for n, _ in self.schema)}]"

    def tree_string(self, depth: int = 0) -> str:
        lines = ["  " * depth + self.describe()]
        for c in self.children:
            lines.append(c.tree_string(depth + 1))
        return "\n".join(lines)



class InMemoryRelation(LogicalPlan):
    """Batches already on a device.  The planner's pushdown pass sets
    ``required_columns`` (the columns the plan reads, None = all); only the
    sharded scan reads it, to encode and move no other column."""

    def __init__(self, batches: Sequence[ColumnarBatch], schema: Schema):
        self.batches = list(batches)
        self._schema = list(schema)
        self.required_columns = None

    @property
    def schema(self) -> Schema:
        return self._schema


class FileRelation(LogicalPlan):
    """Files of one format read as a table (``session.read``).  The
    planner's pushdown pass sets ``pushed_filters`` and
    ``required_columns`` before each planning; the DataFrame layer sets
    ``file_meta`` when a query references the per-file metadata
    columns."""

    INPUT_FILE_COL = "__input_file_name"
    META_COLUMNS = ("_metadata.file_path", "_metadata.file_name",
                    "_metadata.file_size",
                    "_metadata.file_modification_time")

    def __init__(self, paths: Sequence[str], file_format: str,
                 schema: Schema, options: Optional[dict] = None,
                 bucket_spec=None):
        self.paths = list(paths)
        self.file_format = file_format
        self._schema = list(schema)
        self.options = dict(options or {})
        self.pushed_filters: List[Expression] = []
        self.required_columns = None  # None = all
        # subset of {"input_file", "metadata"}
        self.file_meta = set()
        # {"column", "num_buckets"} from the _bucket_spec.json sidecar
        self.bucket_spec = bucket_spec

    @property
    def schema(self) -> Schema:
        from spark_rapids_tpu_torch.columnar.dtypes import (
            INT64, STRING, TIMESTAMP_US)
        out = list(self._schema)
        if "input_file" in self.file_meta:
            out.append((self.INPUT_FILE_COL, STRING))
        if "metadata" in self.file_meta:
            out += list(zip(self.META_COLUMNS,
                            (STRING, STRING, INT64, TIMESTAMP_US)))
        return out


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


class Join(LogicalPlan):
    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression], join_type: str,
                 condition: Optional[Expression] = None,
                 using: Optional[Sequence[str]] = None):
        self.left_keys = [e.bind(left.schema) for e in left_keys]
        self.right_keys = [e.bind(right.schema) for e in right_keys]
        self.join_type = join_type
        self.using = list(using) if using else None
        self.children = (left, right)
        # the residual (non-equi) condition binds against the left and
        # right columns, not ``schema``: a semi/anti join's schema drops
        # the right side, which the residual may still read (the planner
        # then refuses the join with its reason)
        self.condition = condition.bind(
            list(left.schema) + list(right.schema)) \
            if condition is not None else None

    @property
    def left(self):
        return self.children[0]

    @property
    def right(self):
        return self.children[1]

    @property
    def schema(self) -> Schema:
        left = self.left.schema
        right = self.right.schema
        if self.join_type in ("semi", "anti"):
            return list(left)
        if self.using:
            keyset = set(self.using)
            out = [(n, dt) for n, dt in left if n in keyset]
            out += [(n, dt) for n, dt in left if n not in keyset]
            out += [(n, dt) for n, dt in right if n not in keyset]
            return out
        return list(left) + list(right)


class Sort(LogicalPlan):
    def __init__(self, orders: Sequence[Tuple[Expression, bool, bool]],
                 child: LogicalPlan):
        """orders: (expr, descending, nulls_first)"""
        self.orders = [(e.bind(child.schema), d, nf) for e, d, nf in orders]
        self.children = (child,)

    @property
    def child(self):
        return self.children[0]

    @property
    def schema(self) -> Schema:
        return self.child.schema


class Limit(LogicalPlan):
    def __init__(self, n: int, child: LogicalPlan):
        self.n = int(n)
        self.children = (child,)

    @property
    def child(self):
        return self.children[0]

    @property
    def schema(self) -> Schema:
        return self.child.schema


class Union(LogicalPlan):
    """UNION ALL: the children's rows one after the other, under the
    first child's names (every child has the same column types)."""

    def __init__(self, children: Sequence[LogicalPlan]):
        self.children = tuple(children)
        first = self.children[0].schema
        for c in self.children[1:]:
            if [dt.name for _, dt in c.schema] != \
                    [dt.name for _, dt in first]:
                raise ValueError("union children schemas differ")

    @property
    def schema(self) -> Schema:
        return self.children[0].schema


class Range(LogicalPlan):
    """``range(start, end, step)``: one bigint column ``id``."""

    def __init__(self, start: int, end: int, step: int = 1):
        from spark_rapids_tpu_torch.columnar import dtypes as dts
        self.start, self.end, self.step = start, end, step
        self._schema = [("id", dts.INT64)]

    @property
    def schema(self) -> Schema:
        return self._schema


class Window(LogicalPlan):
    """Append window-function columns to the child's."""

    def __init__(self, window_exprs: Sequence[Tuple[str, Expression]],
                 child: LogicalPlan):
        # (output name, WindowExpression) pairs bound to the child
        self.window_exprs = [(n, e.bind(child.schema))
                             for n, e in window_exprs]
        self.children = (child,)

    @property
    def child(self):
        return self.children[0]

    @property
    def schema(self) -> Schema:
        return list(self.child.schema) + \
            [(n, e.dtype) for n, e in self.window_exprs]
