"""Logical plan nodes.

Counterpart of ``spark_rapids_tpu/plan/logical.py``, cut to the nodes the
ported slices plan: an in-memory relation, a file relation, Range,
Project (also the plan node of ``withColumnRenamed``), Filter,
Aggregate, Join (equi-join keys and an optional residual condition),
Sort, Limit, Union, Window, Generate and the pandas nodes (MapInPandas,
AggInPandas, WindowInPandas, CoGroupMapInPandas; ``exec/expand.py`` holds
Expand, as in the JAX package).  The
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

    def tree_string(self) -> str:
        from spark_rapids_tpu_torch.utils.trees import render_tree
        return render_tree(self)



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


class BatchId(LogicalPlan):
    """Appends the per-batch id columns that monotonically_increasing_id()
    and spark_partition_id() read (``ops/misc_exprs.TpuBatchIdExec``)."""

    def __init__(self, child: LogicalPlan):
        self.children = (child,)

    @property
    def child(self):
        return self.children[0]

    @property
    def schema(self) -> Schema:
        from spark_rapids_tpu_torch.columnar.dtypes import INT32, INT64
        return list(self.child.schema) + [("__mid", INT64),
                                          ("__pid", INT32)]

    def describe(self):
        return "BatchId"


class Generate(LogicalPlan):
    """explode / posexplode of one array generator over the child (the
    reference's GpuGenerateExec); ``required`` are the child expressions
    repeated for each element.  A generator naming a shredded map column
    explodes into ``key`` and ``value`` (Spark's map explode): the two
    arrays share their offsets, so both ride one row expansion."""

    def __init__(self, generator: Expression, required, position: bool,
                 child: LogicalPlan, col_name: str = "col",
                 pos_name: str = "pos"):
        from spark_rapids_tpu_torch.columnar.nested import (
            MAP_KEY_SUFFIX, MAP_VALUE_SUFFIX, is_shredded_map)
        from spark_rapids_tpu_torch.ops.expressions import UnresolvedColumn
        names = [n for n, _ in child.schema]
        self.map_mode = isinstance(generator, UnresolvedColumn) and \
            is_shredded_map(generator.col_name, names)
        if self.map_mode:
            base = generator.col_name
            self.generator = UnresolvedColumn(
                base + MAP_KEY_SUFFIX).bind(child.schema)
            self.generator2 = UnresolvedColumn(
                base + MAP_VALUE_SUFFIX).bind(child.schema)
        else:
            self.generator = generator.bind(child.schema)
            self.generator2 = None
        self.required = [e.bind(child.schema) for e in required]
        self.position = position
        self.col_name = col_name
        self.pos_name = pos_name
        taken = {e.name for e in self.required}
        clash = {"key", "value"} if self.map_mode else {col_name}
        if position:
            clash |= {pos_name}
        if taken & clash:
            raise ValueError(
                f"explode output name(s) {sorted(taken & clash)} collide "
                "with pass-through columns; alias the explode (e.g. "
                ".alias('elem'))")
        self.children = (child,)

    @property
    def child(self):
        return self.children[0]

    @property
    def schema(self) -> Schema:
        from spark_rapids_tpu_torch.exec.generate import generate_schema
        return generate_schema(self.generator, self.required, self.position,
                               self.col_name, self.pos_name,
                               self.generator2)

    def describe(self):
        kind = "posexplode" if self.position else "explode"
        return f"Generate[{kind}({self.generator.name})]"


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


class MapInPandas(LogicalPlan):
    """``df.mapInPandas(fn, schema)``, or with ``group_names``
    ``groupBy(keys).applyInPandas(fn, schema)``."""

    def __init__(self, fn, out_schema: Schema, child: LogicalPlan,
                 group_names: Optional[Sequence[str]] = None):
        self.fn = fn
        self._schema = list(out_schema)
        self.group_names = list(group_names) if group_names else None
        self.children = (child,)

    @property
    def child(self):
        return self.children[0]

    @property
    def schema(self) -> Schema:
        return self._schema

    def describe(self):
        kind = "FlatMapGroupsInPandas" if self.group_names \
            else "MapInPandas"
        return f"{kind}[{getattr(self.fn, '__name__', 'fn')}]"


class AggInPandas(LogicalPlan):
    """``groupBy().agg(grouped-aggregate pandas UDFs)``."""

    def __init__(self, group_names: Sequence[str], aggs: Sequence[tuple],
                 child: LogicalPlan):
        self.group_names = list(group_names)
        self.aggs = list(aggs)  # (name, fn, arg_name, dtype)
        self.children = (child,)

    @property
    def child(self):
        return self.children[0]

    @property
    def schema(self) -> Schema:
        child_schema = dict(self.child.schema)
        return [(n, child_schema[n]) for n in self.group_names] + \
            [(name, dt) for name, _, _, dt in self.aggs]

    def describe(self):
        return f"AggInPandas[{[n for n, *_ in self.aggs]}]"


class WindowInPandas(LogicalPlan):
    """Pandas UDFs over window frames: the child's columns plus one
    column per call."""

    def __init__(self, calls: Sequence[tuple], child: LogicalPlan):
        # (out_name, fn, arg_name, dtype, (partition_names, orders, frame))
        self.calls = list(calls)
        self.children = (child,)
        child_names = {n for n, _ in child.schema}
        for out_name, _, arg, _, (parts, orders, _) in self.calls:
            if out_name in child_names:
                raise ValueError(
                    f"windowed pandas UDF output {out_name!r} collides "
                    "with a child column (select() assigns internal "
                    "names: build it through select)")
            for c in [arg] + list(parts) + [n for n, _, _ in orders]:
                if c not in child_names:
                    raise KeyError(f"windowed pandas UDF references "
                                   f"unknown column {c!r}")

    @property
    def child(self):
        return self.children[0]

    @property
    def schema(self) -> Schema:
        return list(self.child.schema) + \
            [(name, dt) for name, _, _, dt, _ in self.calls]

    def describe(self):
        return f"WindowInPandas[{[n for n, *_ in self.calls]}]"


class CoGroupMapInPandas(LogicalPlan):
    """``a.groupBy(k).cogroup(b.groupBy(k2)).applyInPandas(fn, schema)``."""

    def __init__(self, fn, out_schema: Schema, left_names, right_names,
                 left: LogicalPlan, right: LogicalPlan):
        self.fn = fn
        self._schema = list(out_schema)
        self.left_names = list(left_names)
        self.right_names = list(right_names)
        self.children = (left, right)

    @property
    def schema(self) -> Schema:
        return self._schema

    def describe(self):
        return "CoGroupMapInPandas"
