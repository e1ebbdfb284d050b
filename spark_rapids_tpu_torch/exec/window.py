"""Window physical operator and the window expression classes.

Counterpart of ``spark_rapids_tpu/exec/window.py``.  Every supported frame
is computed from one sort plus segment arithmetic (``ops/window.py``).
The planner puts a ``TpuSortExec`` on (partition keys, order keys) under
the operator, as the JAX package's planner does, and the operator then
takes its whole input at once: it concatenates the sorted batches, finds
the partition and order-key run boundaries, and evaluates every function
of its spec over the sorted segments.  Without a sort under it (a window
with neither partition nor order keys) it sorts nothing: the whole input
is one partition.  Output rows come in (partition, order) sorted order,
as Spark's WindowExec emits them.

String partition and order keys become stable integer codes through the
string dictionary (``dictionary.StableDictionary``, the JAX package's
``_StringKeyEncoder``): equal strings get equal codes, which is all a
boundary needs.

Not ported: the JAX package's chunked path over presorted input, which
streams key-aligned chunks of ``spark.rapids.sql.window.batchRows`` rows
and carries running state across them; an input larger than the card's
memory fails here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import Column
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.exec.base import SORT_TIME, Schema, TpuExec
from spark_rapids_tpu_torch.ops import dictionary
from spark_rapids_tpu_torch.ops import window as W
from spark_rapids_tpu_torch.ops.compiler import StageFn, widen
from spark_rapids_tpu_torch.ops.concat import concat_batches
from spark_rapids_tpu_torch.ops.expressions import (
    ColVal, EmitContext, Expression)


@dataclasses.dataclass
class Frame:
    kind: str = "range"          # 'rows' | 'range'
    lo: Optional[int] = None     # None = unbounded preceding
    hi: Optional[int] = 0        # 0 = current row; None = unbounded following


class WindowSpec:
    def __init__(self, partition_exprs: Sequence[Expression] = (),
                 orders: Sequence[Tuple[Expression, bool, bool]] = (),
                 frame: Optional[Frame] = None):
        self.partition_exprs = list(partition_exprs)
        self.orders = list(orders)
        if frame is None:
            # Spark's default: a running RANGE frame when ordered, else
            # the whole partition
            frame = Frame("range", None, 0) if self.orders else \
                Frame("rows", None, None)
        self.frame = frame

    def bind(self, schema) -> "WindowSpec":
        return WindowSpec([e.bind(schema) for e in self.partition_exprs],
                          [(e.bind(schema), d, nf)
                           for e, d, nf in self.orders], self.frame)

    def cache_key(self):
        return (tuple(e.cache_key() for e in self.partition_exprs),
                tuple((e.cache_key(), d, nf) for e, d, nf in self.orders),
                (self.frame.kind, self.frame.lo, self.frame.hi))


class WindowExpression(Expression):
    """func OVER spec."""

    def __init__(self, kind: str, spec: WindowSpec,
                 child: Optional[Expression] = None, offset: int = 1,
                 default: Optional[Expression] = None):
        self.kind = kind  # row_number|rank|dense_rank|percent_rank|
        #                   lead|lag|sum|count|min|max|avg
        self.spec = spec
        self.child_expr = child
        self.offset = offset
        self.default = default
        kids = [e for e, _, _ in spec.orders] + list(spec.partition_exprs)
        if child is not None:
            kids.append(child)
        if default is not None:
            kids.append(default)
        self.children = tuple(kids)

    def bind(self, schema):
        return WindowExpression(
            self.kind, self.spec.bind(schema),
            self.child_expr.bind(schema) if self.child_expr is not None
            else None,
            self.offset,
            self.default.bind(schema) if self.default is not None else None)

    @property
    def dtype(self) -> DataType:
        if self.kind in ("row_number", "rank", "dense_rank"):
            return dts.INT32
        if self.kind == "percent_rank":
            return dts.FLOAT64
        if self.kind == "count":
            return dts.INT64
        if self.kind == "avg":
            return dts.FLOAT64
        if self.kind == "sum":
            return dts.FLOAT64 if self.child_expr.dtype.is_floating \
                else dts.INT64
        return self.child_expr.dtype

    @property
    def nullable(self) -> bool:
        return self.kind not in ("row_number", "rank", "dense_rank",
                                 "percent_rank", "count")

    @property
    def name(self) -> str:
        return f"{self.kind}()"

    def emit(self, ctx):
        raise RuntimeError("WindowExpression must be planned by "
                           "TpuWindowExec")

    def cache_key(self):
        return ("WindowExpression", self.kind, self.offset,
                self.spec.cache_key(),
                self.child_expr.cache_key() if self.child_expr else None,
                self.default.cache_key() if self.default is not None
                else None)

    def supported_reason(self) -> Optional[str]:
        """Why this window function does not run, or None.  The JAX
        package sends these to its CPU fallback; the port raises
        ``NotImplementedError`` with the reason at plan time."""
        f = self.spec.frame
        if self.kind in ("row_number", "rank", "dense_rank", "percent_rank",
                         "lead", "lag"):
            if not self.spec.orders and self.kind != "row_number":
                return f"{self.kind} requires an ORDER BY"
            return None
        if self.kind in ("sum", "count", "avg"):
            if f.kind == "range" and not (f.lo is None and f.hi in (0, None)):
                return "range frames with value offsets not supported"
            if self.child_expr is not None and \
                    self.child_expr.dtype.is_string:
                return f"window {self.kind} of a string is not supported"
            return None
        if self.kind in ("min", "max"):
            whole = f.lo is None and f.hi is None
            running = f.lo is None and f.hi == 0
            if not (whole or running):
                return f"{self.kind} supports only running or " \
                    "whole-partition frames"
            if self.child_expr.dtype.is_string:
                return f"window {self.kind} of a string is not ported"
            return None
        return f"unknown window function {self.kind}"


def group_by_spec(window_exprs):
    """[(orig_idx, name, we)] groups, one per distinct window spec, in
    first-appearance order (the planner chains one operator per group)."""
    groups, by_key = [], {}
    for j, (name, we) in enumerate(window_exprs):
        k = we.spec.cache_key()
        if k not in by_key:
            by_key[k] = len(groups)
            groups.append([])
        groups[by_key[k]].append((j, name, we))
    return groups


def eval_window_expr(we: WindowExpression, sp: W.SortedPartitions,
                     c: Optional[ColVal], device) -> ColVal:
    f = we.spec.frame
    kind = we.kind
    capacity = sp.capacity
    if kind == "row_number":
        return W.row_number(sp)
    if kind == "rank":
        return W.rank(sp)
    if kind == "dense_rank":
        return W.dense_rank(sp)
    if kind == "percent_rank":
        return W.percent_rank(sp)
    if kind in ("lead", "lag"):
        off = we.offset if kind == "lead" else -we.offset
        # defaults are literals: emitted on their own
        dflt = None
        if we.default is not None:
            dflt = we.default.emit(EmitContext([], 0, capacity, device))
        return W.lead_lag(sp, c, off, dflt)

    rows = f.kind == "rows"
    result_dt = we.dtype
    if kind in ("sum", "count", "avg"):
        if kind == "count":
            # only the validity counts (the input may be a string)
            cin = ColVal(dts.INT64, torch.ones(capacity, dtype=torch.int64,
                                               device=device),
                         None if c is None else c.validity)
        else:
            cin = c
        vals = cin.values
        if kind == "sum":
            vals = vals.to(dts.torch_dtype(result_dt))
        elif kind == "avg":
            vals = vals.to(torch.float64)
        cv = ColVal(cin.dtype, vals, cin.validity)
        running = f.lo is None and f.hi == 0
        if not rows and running:
            # a running RANGE frame takes the whole tie run
            s, n = W.frame_sum(sp, cv, None, 0, rows=False)
        else:
            s, n = W.frame_sum(sp, cv, f.lo, f.hi, rows=True)
        if kind == "count":
            return ColVal(dts.INT64, n)
        if kind == "avg":
            return ColVal(dts.FLOAT64,
                          s / torch.clamp(n, min=1).to(torch.float64),
                          n > 0)
        return ColVal(result_dt, s, n > 0)
    if kind in ("min", "max"):
        if f.lo is None and f.hi is None:
            v, n = W.partition_reduce(sp, c, kind)
            return ColVal(result_dt, v, n > 0)
        v, n = W.running_minmax(sp, c, kind)
        if f.kind == "range":
            v = v[sp.run_end.clamp(0, max(capacity - 1, 0))]
            n = n[sp.run_end.clamp(0, max(capacity - 1, 0))]
        return ColVal(result_dt, v, n > 0)
    raise ValueError(kind)


def _boundaries(cols: List[ColVal], live: torch.Tensor, capacity: int
                ) -> torch.Tensor:
    """True where any key differs from the previous row (and at the first
    live row); nulls equal each other, NaN equals NaN, -0.0 equals 0.0."""
    pos = torch.arange(capacity, device=live.device)
    if not cols:
        return (pos == 0) & live
    same = torch.ones(capacity, dtype=torch.bool, device=live.device)
    for c in cols:
        v = c.values
        prev = torch.roll(v, 1)
        if v.dtype.is_floating_point:
            eq = (v == prev) | (torch.isnan(v) & torch.isnan(prev))
        else:
            eq = v == prev
        if c.validity is not None:
            pv = torch.roll(c.validity, 1)
            eq = torch.where(c.validity & pv, eq, ~(c.validity | pv))
        same = same & eq
    boundary = ~same
    if capacity:
        boundary[0] = True
    return boundary & live


class TpuWindowExec(TpuExec):
    def __init__(self, window_exprs: Sequence[Tuple[str, WindowExpression]],
                 child: TpuExec, device):
        """The child's output comes sorted by (partition keys, order
        keys): the planner's sort under it, or no keys at all."""
        super().__init__(child)
        self.window_exprs = list(window_exprs)
        self.device = device
        self._register_metric(SORT_TIME)
        spec = self.window_exprs[0][1].spec
        for _, we in self.window_exprs[1:]:
            if we.spec.cache_key() != spec.cache_key():
                raise ValueError("one TpuWindowExec handles one window spec")
        self.spec = spec
        in_dtypes = [dt for _, dt in child.schema]
        # partition keys, order keys, then the functions' inputs
        self._pre_exprs: List[Expression] = list(spec.partition_exprs) + \
            [e for e, _, _ in spec.orders]
        self._n_keys = len(self._pre_exprs)
        self._extra_ofs: Dict[int, int] = {}
        for i, (_, we) in enumerate(self.window_exprs):
            if we.child_expr is not None:
                self._extra_ofs[i] = len(self._pre_exprs) - self._n_keys
                self._pre_exprs.append(we.child_expr)
        self._pre_fn = StageFn(self._pre_exprs, in_dtypes)

    @property
    def child(self) -> TpuExec:
        return self.children[0]

    @property
    def schema(self) -> Schema:
        return list(self.child.schema) + \
            [(name, we.dtype) for name, we in self.window_exprs]

    def describe(self):
        return (f"TpuWindowExec[{[n for n, _ in self.window_exprs]} over "
                f"part={[e.name for e in self.spec.partition_exprs]}]")

    def _key_colvals(self, cols: List[Column], n: int) -> List[ColVal]:
        """Keys as boundary detection compares them: a string key as
        stable codes (a null keeps its validity)."""
        out = []
        for c in cols:
            if c.dtype.is_string:
                codes = dictionary.StableDictionary().encode(
                    c, n, null_code=-1)
                out.append(ColVal(dts.INT64, codes,
                                  None if c.validity is None
                                  else c.validity[:n]))
            else:
                out.append(ColVal(c.dtype, c.data[:n],
                                  None if c.validity is None
                                  else c.validity[:n]))
        return out

    def do_execute(self) -> Iterator[ColumnarBatch]:
        batches = list(self.child.execute())
        if not batches:
            return
        merged = concat_batches(batches)
        n = merged.nrows
        with self.timer(SORT_TIME):
            pre = self._pre_fn(merged)
            payload = [ColVal(c.dtype, c.data, c.validity, c.offsets)
                       for c in merged.columns.values()]
            extras = [_head(ColVal(c.dtype, c.data, c.validity, c.offsets),
                            n) for c in pre[self._n_keys:]]
            payload = [_head(c, n) for c in payload]
            np_ = len(self.spec.partition_exprs)
            keys = self._key_colvals(pre[:self._n_keys], n)
            live = torch.ones(n, dtype=torch.bool, device=self.device)
            seg_boundary = _boundaries(keys[:np_], live, n)
            run_boundary = _boundaries(keys[np_:], live, n) \
                if self.spec.orders else \
                torch.zeros(n, dtype=torch.bool, device=self.device)
            sp = W.SortedPartitions(seg_boundary, run_boundary, n, n)
            outs = []
            for i, (_, we) in enumerate(self.window_exprs):
                c = extras[self._extra_ofs[i]] if i in self._extra_ofs \
                    else None
                outs.append(widen(eval_window_expr(we, sp, c, self.device),
                                  n))
        names = [nm for nm, _ in self.schema]
        cols = {nm: Column(o.dtype, o.values, n, validity=o.validity,
                           offsets=o.offsets)
                for nm, o in zip(names, payload + outs)}
        yield ColumnarBatch(cols, n)


def _head(c: ColVal, n: int) -> ColVal:
    """The first ``n`` rows of a column (a string keeps its chars)."""
    validity = None if c.validity is None else c.validity[:n]
    if c.offsets is not None:
        return ColVal(c.dtype, c.values, validity, c.offsets[:n + 1])
    return ColVal(c.dtype, c.values[:n], validity)
