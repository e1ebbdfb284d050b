"""Python user code in the engine: UDF expressions and the pandas execs.

Counterpart of ``spark_rapids_tpu/udf/python_exec.py`` (the reference's
``GpuUserDefinedFunction`` / ``RapidsUDF`` and the pandas exec family,
SURVEY section 2.7):

- ``UDFCall``: what ``F.udf(fn)(cols)`` returns.  When its node binds it
  (the arguments' types known), ``udf/compiler.compile_udf`` turns the
  function into an expression tree; a function it does not compile binds
  to a ``PythonUDF``, the black box;
- ``TorchUDF`` (the JAX package's ``JaxUDF``, the reference's
  ``RapidsUDF``): a user function over the argument tensors, evaluated
  inside the stage like any expression;
- ``TpuArrowEvalPythonExec``: a projection holding black-box UDFs.  Per
  batch, stage A evaluates the UDF arguments on the device, one counted
  fetch brings them to the host, the functions run row by row (inline, or
  on the worker pool, ``udf/worker_pool.py``) with the session's
  admission semaphore released, the results go up to the device, and
  stage B evaluates the projection with each call replaced by its result
  column;
- the pandas execs: ``mapInPandas``, ``groupBy().applyInPandas``,
  grouped-aggregate and window pandas UDFs, and ``cogroup``.  Their
  groups are split on the host with pandas, as in the JAX package.

A black-box function receives its arguments as Python values as arrow
gives them: ``datetime.date`` for a date, ``decimal.Decimal`` for a
decimal (the JAX package passes a date as its day number).
"""

from __future__ import annotations

import time
from typing import Callable, Iterator, List, Sequence

import numpy as np
import pandas as pd
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, empty_batch
from spark_rapids_tpu_torch.columnar.column import Column
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.exec.base import Schema, TpuExec
from spark_rapids_tpu_torch.ops.expressions import (
    BoundReference, ColVal, EmitContext, Expression, combine_validity)

# host ns of a Python exec: fetching the argument columns (stage A's output
# through one counted fetch), running the Python code, and uploading
# the results
ARG_FETCH_TIME = "argFetchTime"
PYTHON_TIME = "pythonTime"
RESULT_UPLOAD_TIME = "resultUploadTime"


class UDFCall(Expression):
    """``F.udf(fn)(*cols)`` before its node binds it: binding compiles the
    function over the typed arguments, or makes the black box."""

    def __init__(self, fn: Callable, return_type: DataType,
                 args: Sequence[Expression], name: str = ""):
        self.fn = fn
        self.return_type = return_type
        self.children = tuple(args)
        self._name = name or getattr(fn, "__name__", "udf")

    def with_children(self, children):
        return UDFCall(self.fn, self.return_type, children, self._name)

    def bind(self, schema) -> Expression:
        from spark_rapids_tpu_torch.udf.compiler import compile_udf
        args = [c.bind(schema) for c in self.children]
        compiled = compile_udf(self.fn, args)
        if compiled is not None:
            return compiled
        return PythonUDF(self.fn, self.return_type, args, self._name)

    @property
    def dtype(self) -> DataType:
        raise RuntimeError(f"UDF {self._name} is not bound yet")

    @property
    def name(self) -> str:
        return f"{self._name}({', '.join(c.name for c in self.children)})"

    def cache_key(self):
        return ("UDFCall", id(self.fn),
                tuple(c.cache_key() for c in self.children))


class PythonUDF(Expression):
    """A UDF the compiler did not take: it runs on the host (the
    reference's CPU fallback of an uncompiled UDF).  It has no device
    ``emit``: the planner routes its projection to
    ``TpuArrowEvalPythonExec`` or, nested in another UDF's arguments, to
    the CPU fallback."""

    def __init__(self, fn: Callable, return_type: DataType,
                 args: Sequence[Expression], name: str = ""):
        self.fn = fn
        self.return_type = return_type
        self.children = tuple(args)
        self._name = name or getattr(fn, "__name__", "udf")

    def with_children(self, children):
        return PythonUDF(self.fn, self.return_type, children, self._name)

    @property
    def dtype(self) -> DataType:
        return self.return_type

    @property
    def name(self) -> str:
        return f"{self._name}({', '.join(c.name for c in self.children)})"

    def cache_key(self):
        return ("PythonUDF", id(self.fn),
                tuple(c.cache_key() for c in self.children))


class TorchUDF(Expression):
    """A user function over tensors as a columnar expression (the
    RapidsUDF analog, ``RapidsUDF.java:40``; the JAX package's
    ``JaxUDF``).  ``fn(*values)`` receives one tensor per argument, each
    of the batch's capacity (rows past the count and null rows hold
    arbitrary values, so ``fn`` must be elementwise-safe over them), and
    returns one tensor of that length; a row's result is null where any
    argument is null."""

    def __init__(self, fn: Callable, return_type: DataType,
                 args: Sequence[Expression], name: str = ""):
        self.fn = fn
        self.return_type = return_type
        self.children = tuple(args)
        self._name = name or getattr(fn, "__name__", "tpu_udf")

    def with_children(self, children):
        return TorchUDF(self.fn, self.return_type, children, self._name)

    @property
    def dtype(self) -> DataType:
        return self.return_type

    @property
    def name(self) -> str:
        return f"{self._name}({', '.join(c.name for c in self.children)})"

    def emit(self, ctx: EmitContext) -> ColVal:
        if self.return_type.has_offsets:
            raise TypeError(f"tpu_udf {self._name}: a {self.return_type} "
                            "result is not supported")
        args, validity = [], None
        for c in self.children:
            cv = c.emit(ctx)
            if cv.offsets is not None:
                raise TypeError(f"tpu_udf {self._name}: argument "
                                f"{c.name} is a {c.dtype} column")
            v = cv.values
            if v.dim() == 0:
                v = v.expand(ctx.capacity)
            args.append(v)
            validity = combine_validity(validity, cv.validity)
        out = self.fn(*args)
        if not isinstance(out, torch.Tensor) or \
                tuple(out.shape) != (ctx.capacity,):
            raise ValueError(
                f"tpu_udf {self._name} must return a ({ctx.capacity},) "
                f"tensor, got {getattr(out, 'shape', type(out))}")
        if validity is not None and validity.dim() == 0:
            validity = validity.expand(ctx.capacity)
        return ColVal(self.return_type,
                      out.to(dts.torch_dtype(self.return_type)), validity)

    def cache_key(self):
        return ("TorchUDF", id(self.fn),
                tuple(c.cache_key() for c in self.children))


def find_python_udfs(expr: Expression) -> List[PythonUDF]:
    out = []
    if isinstance(expr, PythonUDF):
        out.append(expr)
    for c in expr.children:
        out.extend(find_python_udfs(c))
    return out


def replace_udfs(expr: Expression, mapping) -> Expression:
    if isinstance(expr, PythonUDF):
        return mapping[id(expr)]
    if not expr.children:
        return expr
    return expr.with_children(
        [replace_udfs(c, mapping) for c in expr.children])


def python_values(col) -> list:
    """An arrow column's rows as Python values, as ``to_pylist`` gives
    them (None for null), converted in bulk where arrow can: strings and
    numbers through numpy."""
    import pyarrow as pa
    t = col.type
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return col.to_numpy(zero_copy_only=False).tolist()
    if pa.types.is_integer(t) or pa.types.is_floating(t) or \
            pa.types.is_boolean(t):
        if col.null_count == 0:
            return col.to_numpy(zero_copy_only=False).tolist()
        out = col.fill_null(False if pa.types.is_boolean(t) else 0) \
            .to_numpy(zero_copy_only=False).tolist()
        for i in np.flatnonzero(col.is_null().to_numpy(
                zero_copy_only=False)):
            out[i] = None
        return out
    return col.to_pylist()


def _held(semaphore):
    """Release the session's admission semaphore while Python runs (no
    device work happens then); the returned function re-acquires it."""
    if semaphore is None or getattr(semaphore._held, "count", 0) == 0:
        return lambda: None
    semaphore.release_if_held()
    return semaphore.acquire_if_necessary


def values_column(values: list, dt: DataType, capacity: int,
                  device) -> Column:
    """Host results as a column of ``capacity`` rows (None is null; rows
    past the values are null padding)."""
    n = len(values)
    pad = capacity - n
    if dt.is_string:
        col = Column.from_strings(
            [None if v is None else str(v) for v in values] + [None] * pad,
            device=device)
        return col
    if dt.is_decimal or dt.is_datetime or dt.is_array:
        import pyarrow as pa
        from spark_rapids_tpu_torch.columnar.batch import _column_from_arrow
        arr = pa.array(list(values) + [None] * pad,
                       type=dts.to_arrow_type(dt))
        return _column_from_arrow(pa.chunked_array([arr]), device)
    validity = np.zeros(capacity, dtype=np.bool_)
    validity[:n] = [v is not None for v in values]
    filled = np.zeros(capacity, dtype=dt.storage)
    filled[:n] = [0 if v is None else v for v in values]
    return Column.from_numpy(filled, dtype=dt, validity=validity,
                             device=device)


class TpuArrowEvalPythonExec(TpuExec):
    """A projection holding black-box Python UDFs (the reference's
    ``GpuArrowEvalPythonExec``, python/GpuArrowEvalPythonExec.scala).
    Streams one batch at a time."""

    def __init__(self, exprs: Sequence[Expression], child: TpuExec,
                 num_workers: int = 0, semaphore=None):
        from spark_rapids_tpu_torch.ops.compiler import StageFn
        super().__init__(child)
        for m in (ARG_FETCH_TIME, PYTHON_TIME, RESULT_UPLOAD_TIME):
            self._register_metric(m)
        self.exprs = list(exprs)
        self.num_workers = int(num_workers)
        self.semaphore = semaphore
        self._udfs: List[PythonUDF] = []
        seen = set()
        for e in self.exprs:
            for u in find_python_udfs(e):
                if id(u) not in seen:
                    seen.add(id(u))
                    self._udfs.append(u)
        if not self._udfs:
            raise ValueError("no PythonUDF in the projection")
        if any(find_python_udfs(a) for u in self._udfs for a in u.children):
            # the planner sends nested black boxes to the CPU fallback
            raise ValueError("nested PythonUDFs are not supported here")
        in_dtypes = [dt for _, dt in child.schema]
        # result columns take names no child column starts with
        prefix = "_udf"
        while any(n.startswith(prefix) for n, _ in child.schema):
            prefix += "_"
        self._prefix = prefix
        self._args_per_udf = [list(u.children) for u in self._udfs]
        self._stage_a = StageFn(
            [a for args in self._args_per_udf for a in args], in_dtypes)
        n = len(child.schema)
        mapping = {id(u): BoundReference(n + j, u.return_type,
                                         name=f"{prefix}{j}")
                   for j, u in enumerate(self._udfs)}
        self._stage_b = StageFn(
            [replace_udfs(e, mapping) for e in self.exprs],
            in_dtypes + [u.return_type for u in self._udfs])

    @property
    def child(self) -> TpuExec:
        return self.children[0]

    @property
    def schema(self) -> Schema:
        return [(e.name, e.dtype) for e in self.exprs]

    def describe(self):
        return ("TpuArrowEvalPythonExec["
                f"{', '.join(u._name for u in self._udfs)}]")

    def _evaluate(self, u: PythonUDF, arg_lists: list, nrows: int) -> list:
        if not arg_lists:
            return [u.fn() for _ in range(nrows)]
        if self.num_workers >= 1:
            from spark_rapids_tpu_torch.udf import worker_pool as WP
            # the cheap declines first: no row tuples for a pool that
            # will not run
            if WP.worth_trying(u.fn, nrows, self.num_workers):
                out = WP.eval_rows(u.fn, list(zip(*arg_lists)),
                                   self.num_workers)
                if out is not None:
                    return out
        return [None if any(v is None for v in row) else u.fn(*row)
                for row in zip(*arg_lists)]

    def do_execute(self) -> Iterator[ColumnarBatch]:
        for batch in self.child.execute():
            arg_cols = self._stage_a(batch)
            t0 = time.perf_counter_ns()
            table = ColumnarBatch(
                {f"a{i}": c for i, c in enumerate(arg_cols)},
                batch.row_count).to_arrow() if arg_cols else None
            n = batch.nrows
            columns = [python_values(table.column(i))
                       for i in range(table.num_columns)] if table else []
            t1 = time.perf_counter_ns()
            self.metrics[ARG_FETCH_TIME].add(t1 - t0)
            if n == 0:
                outs = [[] for _ in self._udfs]
            else:
                reacquire = _held(self.semaphore)
                try:
                    outs, k = [], 0
                    for u, args in zip(self._udfs, self._args_per_udf):
                        outs.append(self._evaluate(
                            u, columns[k:k + len(args)], n))
                        k += len(args)
                finally:
                    reacquire()
            t2 = time.perf_counter_ns()
            self.metrics[PYTHON_TIME].add(t2 - t1)
            cols = dict(batch.columns)
            for j, (u, out) in enumerate(zip(self._udfs, outs)):
                c = values_column(out, u.return_type, batch.capacity,
                                  batch.device)
                cols[f"{self._prefix}{j}"] = Column(
                    c.dtype, c.data, batch.row_count, validity=c.validity,
                    offsets=c.offsets)
            self.metrics[RESULT_UPLOAD_TIME].add(
                time.perf_counter_ns() - t2)
            outs = self._stage_b(ColumnarBatch(cols, batch.row_count))
            yield ColumnarBatch({e.name: c for e, c in zip(self.exprs, outs)},
                                batch.row_count)


# ------------------------------------------------------------ pandas execs --

def norm_key(key) -> tuple:
    """A pandas group key with NaN members as None, so null keys of two
    sides cogroup together (NaN != NaN)."""
    key = key if isinstance(key, tuple) else (key,)
    return tuple(None if (isinstance(x, float) and pd.isna(x)) or
                 x is pd.NA else x for x in key)


def child_pandas(node: TpuExec) -> pd.DataFrame:
    """Every batch of ``node`` in one pandas frame (an empty frame of the
    node's columns when it yields none)."""
    import pyarrow as pa
    tables = [b.to_arrow() for b in node.execute()]
    if not tables:
        return empty_batch(node.schema).to_pandas()
    return pa.concat_tables(tables).to_pandas()


def frame_to_batch(df: pd.DataFrame, schema: Schema,
                   device) -> ColumnarBatch:
    """A batch of ``df``'s columns coerced to the declared ``schema``
    (pandas loses types on empty, object and nullable columns), each
    through arrow: NaN and None are null, a float truncates to a
    declared integer type, a value converts to a declared string."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.columnar.batch import _column_from_arrow
    cols = {}
    for name, dt in schema:
        target = dts.to_arrow_type(dt)
        arr = pa.array(df[name], from_pandas=True)
        if not arr.type.equals(target):
            arr = arr.cast(target, safe=False)
        if not isinstance(arr, pa.ChunkedArray):
            arr = pa.chunked_array([arr])
        cols[name] = _column_from_arrow(arr, device, name)
    if not cols:
        raise ValueError("a pandas UDF's schema has no columns")
    return ColumnarBatch(cols, len(df))


class _PandasExec(TpuExec):
    """The shared part of the pandas execs: the session's semaphore
    (released while the user's pandas code runs), the device results go
    to, and the host time of the user's code (``pythonTime``)."""

    def __init__(self, *children, device="cpu", semaphore=None):
        super().__init__(*children)
        self._register_metric(PYTHON_TIME)
        self.device = torch.device(device)
        self.semaphore = semaphore

    def _run_user(self, fn):
        t0 = time.perf_counter_ns()
        reacquire = _held(self.semaphore)
        try:
            return fn()
        finally:
            reacquire()
            self.metrics[PYTHON_TIME].add(time.perf_counter_ns() - t0)


class TpuMapInPandasExec(_PandasExec):
    """``df.mapInPandas(fn, schema)`` (GpuMapInPandasExec): ``fn`` gets an
    iterator of one pandas frame per input batch and yields frames."""

    def __init__(self, fn: Callable, out_schema: Schema, child: TpuExec,
                 device="cpu", semaphore=None):
        super().__init__(child, device=device, semaphore=semaphore)
        self.fn = fn
        self._schema = list(out_schema)

    @property
    def schema(self) -> Schema:
        return self._schema

    def describe(self):
        return f"TpuMapInPandasExec[{getattr(self.fn, '__name__', 'fn')}]"

    def do_execute(self) -> Iterator[ColumnarBatch]:
        names = [n for n, _ in self._schema]
        for batch in self.children[0].execute():
            pdf = batch.to_pandas()
            outs = self._run_user(lambda: list(self.fn(iter([pdf]))))
            for out in outs:
                if len(out):
                    yield frame_to_batch(out[names].reset_index(drop=True),
                                         self._schema, self.device)


class TpuFlatMapGroupsInPandasExec(_PandasExec):
    """``groupBy(keys).applyInPandas(fn, schema)``
    (GpuFlatMapGroupsInPandasExec): the child's rows split by key on the
    host, ``fn`` per group."""

    def __init__(self, fn: Callable, out_schema: Schema,
                 group_names: List[str], child: TpuExec, device="cpu",
                 semaphore=None):
        super().__init__(child, device=device, semaphore=semaphore)
        self.fn = fn
        self.group_names = list(group_names)
        self._schema = list(out_schema)

    @property
    def schema(self) -> Schema:
        return self._schema

    def describe(self):
        return (f"TpuFlatMapGroupsInPandasExec["
                f"{getattr(self.fn, '__name__', 'fn')}]")

    def do_execute(self) -> Iterator[ColumnarBatch]:
        df = child_pandas(self.children[0])
        if df.empty:
            return
        names = [n for n, _ in self._schema]

        def run():
            outs = []
            for _, group in df.groupby(self.group_names, dropna=False,
                                       sort=False):
                out = self.fn(group)
                if len(out):
                    outs.append(out[names])
            return outs
        outs = self._run_user(run)
        if outs:
            yield frame_to_batch(pd.concat(outs, ignore_index=True),
                                 self._schema, self.device)


class TpuAggregateInPandasExec(_PandasExec):
    """``groupBy().agg(grouped-agg pandas UDFs)``
    (GpuAggregateInPandasExec): per group each UDF gets its argument
    Series and returns one value.  A keyless aggregate over no rows still
    calls each UDF once, on empty Series (Spark's one row)."""

    def __init__(self, group_names: Sequence[str], aggs: Sequence[tuple],
                 child: TpuExec, device="cpu", semaphore=None):
        """aggs: (out_name, fn, arg_name, return dtype)."""
        super().__init__(child, device=device, semaphore=semaphore)
        self.group_names = list(group_names)
        self.aggs = list(aggs)

    @property
    def child(self) -> TpuExec:
        return self.children[0]

    @property
    def schema(self) -> Schema:
        child_schema = dict(self.child.schema)
        return [(n, child_schema[n]) for n in self.group_names] + \
            [(name, dt) for name, _, _, dt in self.aggs]

    def describe(self):
        return f"TpuAggregateInPandasExec[{[n for n, *_ in self.aggs]}]"

    def do_execute(self) -> Iterator[ColumnarBatch]:
        df = child_pandas(self.child)
        if df.empty and self.group_names:
            return

        def run():
            rows = []
            if self.group_names:
                for key, group in df.groupby(self.group_names,
                                             dropna=False, sort=False):
                    row = dict(zip(self.group_names, norm_key(key)))
                    for name, fn, arg, _ in self.aggs:
                        row[name] = fn(group[arg])
                    rows.append(row)
            else:
                rows.append({name: fn(df[arg])
                             for name, fn, arg, _ in self.aggs})
            return rows
        rows = self._run_user(run)
        out = pd.DataFrame(rows, columns=[n for n, _ in self.schema])
        yield frame_to_batch(out, self.schema, self.device)


class TpuWindowInPandasExec(_PandasExec):
    """Pandas UDFs over window frames (GpuWindowInPandasExec).  Per
    partition the UDF sees its frame's argument Series and returns the
    anchor row's value: one call for a whole-partition frame (broadcast),
    one per peer group for the running range frame, one per row for a
    bounded rows frame.  The rows keep their input order."""

    def __init__(self, calls: Sequence[tuple], child: TpuExec,
                 device="cpu", semaphore=None):
        """calls: (out_name, fn, arg_name, dtype, (partition_names,
        [(order_name, descending, nulls_first)], frame))."""
        super().__init__(child, device=device, semaphore=semaphore)
        self.calls = list(calls)

    @property
    def child(self) -> TpuExec:
        return self.children[0]

    @property
    def schema(self) -> Schema:
        return list(self.child.schema) + \
            [(name, dt) for name, _, _, dt, _ in self.calls]

    def describe(self):
        return f"TpuWindowInPandasExec[{[n for n, *_ in self.calls]}]"

    @staticmethod
    def _eval_one_group(g: pd.DataFrame, fn, arg: str, orders,
                        frame) -> pd.Series:
        if orders:
            from spark_rapids_tpu_torch.utils.hostsort import (
                sort_per_key_nulls)
            g = sort_per_key_nulls(
                g, [n for n, _, _ in orders], [not d for _, d, _ in orders],
                [nf for _, _, nf in orders], reset_index=False)
        s = g[arg].reset_index(drop=True)
        n = len(s)
        out = np.empty(n, dtype=object)
        if frame.lo is None and frame.hi is None:
            out[:] = fn(s)
        elif frame.kind == "range":
            # the running range frame: tied order keys (nulls tie with
            # nulls) share their frame's end
            keys = g[[name for name, _, _ in orders]].reset_index(drop=True)
            changed = keys.ne(keys.shift()) & \
                ~(keys.isna() & keys.shift().isna())
            run_id = changed.any(axis=1).cumsum()
            start = 0
            for _, idx in keys.groupby(run_id, sort=False).groups.items():
                e = idx[-1] + 1
                out[start:e] = fn(s.iloc[:e])
                start = e
        else:
            lo, hi = frame.lo, frame.hi
            for i in range(n):
                a = 0 if lo is None else max(0, i + lo)
                # a negative upper bound near the start is an empty frame
                b = n if hi is None else min(n, max(0, i + hi + 1))
                out[i] = fn(s.iloc[a:b])
        return pd.Series(out, index=g.index)

    def do_execute(self) -> Iterator[ColumnarBatch]:
        df = child_pandas(self.child)
        if df.empty:
            yield empty_batch(self.schema, self.device)
            return

        def run():
            for out_name, fn, arg, _, (parts, orders, frame) in self.calls:
                if parts:
                    pieces = [self._eval_one_group(g, fn, arg, orders, frame)
                              for _, g in df.groupby(parts, dropna=False,
                                                     sort=False)]
                    df[out_name] = pd.concat(pieces).reindex(df.index)
                else:
                    df[out_name] = self._eval_one_group(
                        df, fn, arg, orders, frame).reindex(df.index)
        self._run_user(run)
        yield frame_to_batch(df[[n for n, _ in self.schema]], self.schema,
                             self.device)


class TpuFlatMapCoGroupsInPandasExec(_PandasExec):
    """``cogroup().applyInPandas`` (GpuFlatMapCoGroupsInPandasExec): both
    sides grouped on the host, ``fn(left_group, right_group)`` per key of
    the union of keys (null keys pair with null keys)."""

    def __init__(self, fn: Callable, out_schema: Schema,
                 left_names: Sequence[str], right_names: Sequence[str],
                 left: TpuExec, right: TpuExec, device="cpu",
                 semaphore=None):
        super().__init__(left, right, device=device, semaphore=semaphore)
        self.fn = fn
        self._schema = list(out_schema)
        self.left_names = list(left_names)
        self.right_names = list(right_names)

    @property
    def schema(self) -> Schema:
        return self._schema

    def describe(self):
        return "TpuFlatMapCoGroupsInPandasExec"

    def do_execute(self) -> Iterator[ColumnarBatch]:
        left = child_pandas(self.children[0])
        right = child_pandas(self.children[1])
        names = [n for n, _ in self._schema]

        def run():
            lgroups = {norm_key(k): g for k, g in left.groupby(
                self.left_names, dropna=False, sort=False)}
            rgroups = {norm_key(k): g for k, g in right.groupby(
                self.right_names, dropna=False, sort=False)}
            keys = list(lgroups) + [k for k in rgroups if k not in lgroups]
            outs = []
            for k in keys:
                res = self.fn(
                    lgroups.get(k, left.iloc[0:0]).reset_index(drop=True),
                    rgroups.get(k, right.iloc[0:0]).reset_index(drop=True))
                if len(res):
                    outs.append(res[names])
            return outs
        outs = self._run_user(run)
        if not outs:
            yield empty_batch(self._schema, self.device)
            return
        yield frame_to_batch(pd.concat(outs, ignore_index=True),
                             self._schema, self.device)
