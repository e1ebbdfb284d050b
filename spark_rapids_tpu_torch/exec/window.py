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

Chunked path (the planner's windows with partition keys, over their
sort: ``presorted``): the operator streams chunks of about
``spark.rapids.sql.window.batchRows`` rows instead of concatenating its
whole input (the reference's GpuKeyBatchingIterator and running-window
path, GpuWindowExec.scala:423-446).  A chunk ends at the last partition
boundary within the target.  A partition longer than the target, when
every function of the operator has a running frame (row_number, or
sum/count/avg/min/max from unbounded preceding to the current row),
splits inside itself and carries its running state (device scalars) into
the next chunk; RANGE frames split only where the order key changes, so
a tie run never straddles two chunks.  Otherwise the chunk grows until
the partition ends.  Prefix sums still restart at each partition; the
carry adds to the rows of a chunk's first partition only, so a float
running sum adds in another grouping than the whole-input path (the same
on every run).  ``windowChunks`` counts the chunks.
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
from spark_rapids_tpu_torch.exec.basic import slice_batch
from spark_rapids_tpu_torch.ops import dictionary
from spark_rapids_tpu_torch.ops import window as W
from spark_rapids_tpu_torch.ops.compiler import StageFn, widen
from spark_rapids_tpu_torch.ops.concat import concat_batches
from spark_rapids_tpu_torch.ops.expressions import (
    ColVal, EmitContext, Expression)

WINDOW_CHUNKS = "windowChunks"

# functions that carry running state across chunks
_RUNNING_KINDS = ("sum", "count", "avg", "min", "max")


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
                 child: TpuExec, device, presorted: bool = False,
                 batch_rows: int = 1 << 20):
        """The child's output comes sorted by (partition keys, order
        keys): the planner's sort under it, or no keys at all.
        ``presorted`` with partition keys takes the chunked path, chunks
        of about ``batch_rows`` rows."""
        super().__init__(child)
        self.window_exprs = list(window_exprs)
        self.device = device
        self.presorted = presorted
        self.batch_rows = int(batch_rows)
        self._register_metric(SORT_TIME)
        self._register_metric(WINDOW_CHUNKS)
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
        codes of the operator's dictionary for that key, stable across
        chunks (a null keeps its validity)."""
        out = []
        for i, c in enumerate(cols):
            if c.dtype.is_string:
                codes = self._dicts.setdefault(
                    i, dictionary.StableDictionary()).encode(
                    c, n, null_code=-1)
                out.append(ColVal(dts.INT64, codes,
                                  None if c.validity is None
                                  else c.validity[:n]))
            else:
                out.append(ColVal(c.dtype, c.data[:n],
                                  None if c.validity is None
                                  else c.validity[:n]))
        return out

    def _stage(self, batch: ColumnarBatch, n: int):
        """(keys, function inputs, payload) of a batch's first n rows."""
        pre = self._pre_fn(batch)
        payload = [_head(ColVal(c.dtype, c.data, c.validity, c.offsets), n)
                   for c in batch.columns.values()]
        extras = [_head(ColVal(c.dtype, c.data, c.validity, c.offsets), n)
                  for c in pre[self._n_keys:]]
        return self._key_colvals(pre[:self._n_keys], n), extras, payload

    def _segments(self, keys: List[ColVal], n: int) -> W.SortedPartitions:
        np_ = len(self.spec.partition_exprs)
        live = torch.ones(n, dtype=torch.bool, device=self.device)
        seg_boundary = _boundaries(keys[:np_], live, n)
        run_boundary = _boundaries(keys[np_:], live, n) \
            if self.spec.orders else \
            torch.zeros(n, dtype=torch.bool, device=self.device)
        return W.SortedPartitions(seg_boundary, run_boundary, n, n)

    def _evaluate(self, batch: ColumnarBatch, n: int, carry=None):
        """The output batch of a batch's first n rows (sorted), and with
        ``carry`` (one running state per function, or None) the state at
        its last row, after the carry is added to its first partition's
        rows."""
        keys, extras, payload = self._stage(batch, n)
        sp = self._segments(keys, n)
        outs, states = [], []
        first_part = sp.seg_id == 0
        for i, (_, we) in enumerate(self.window_exprs):
            c = extras[self._extra_ofs[i]] if i in self._extra_ofs \
                else None
            if carry is None:
                outs.append(widen(eval_window_expr(we, sp, c, self.device),
                                  n))
                continue
            state = _running_state(we, sp, c)
            if carry[i] is not None:
                state = _add_carry(we, state, carry[i], first_part)
            outs.append(widen(_running_output(we, state), n))
            states.append(tuple(t[n - 1] for t in state))
        names = [nm for nm, _ in self.schema]
        cols = {nm: Column(o.dtype, o.values, n, validity=o.validity,
                           offsets=o.offsets)
                for nm, o in zip(names, payload + outs)}
        return ColumnarBatch(cols, n), keys, states

    def do_execute(self) -> Iterator[ColumnarBatch]:
        self._dicts = {}
        if self.presorted and self.spec.partition_exprs:
            yield from self._chunked_execute()
            return
        batches = list(self.child.execute())
        if not batches:
            return
        merged = concat_batches(batches)
        with self.timer(SORT_TIME):
            out, _, _ = self._evaluate(merged, merged.nrows)
        yield out

    # ------------------------------------------------------- chunked path --
    def _running_capable(self) -> bool:
        """Every function can carry running state across chunks (needed
        to split a partition larger than one chunk)."""
        for _, we in self.window_exprs:
            f = we.spec.frame
            if we.kind == "row_number" or (
                    we.kind in _RUNNING_KINDS and f.lo is None and
                    f.hi == 0):
                continue
            return False
        return True

    def _needs_run_aligned_split(self) -> bool:
        """A running RANGE frame takes the whole order-key tie run, so a
        split inside a partition lands where the order key changes."""
        return any(we.spec.frame.kind == "range"
                   for _, we in self.window_exprs
                   if we.kind != "row_number")

    def _boundary_indices(self, keys: List[ColVal], n: int,
                          cutoff: Optional[int] = None,
                          with_runs: bool = False) -> Tuple[int, int]:
        """(first, last) partition starts after row 0 within rows
        [0, cutoff] (0 when there is none), in one counted fetch; with
        ``with_runs``, order-key run starts count too."""
        from spark_rapids_tpu_torch.utils import hostsync
        np_ = len(self.spec.partition_exprs)
        live = torch.ones(n, dtype=torch.bool, device=self.device)
        b = _boundaries(keys[:np_], live, n)
        if with_runs:
            b = b | _boundaries(keys[np_:], live, n)
        b[0] = False
        pos = torch.arange(n, device=self.device)
        if cutoff is not None:
            b = b & (pos <= cutoff)
        first, last = hostsync.fetch(torch.where(b, pos, n).min(),
                                     torch.where(b, pos, 0).max())
        first = int(first)
        return (0 if first >= n else first), int(last)

    def _first_boundary(self, chunk: ColumnarBatch, rows: int) -> int:
        """The first partition start after row 0 among the buffer's
        ``rows`` (0 when there is none), looked for in head windows that
        double from two chunks: a partition of P rows past one chunk is
        staged at most about 4P times, not once per row still buffered."""
        k = self.batch_rows
        while True:
            k = min(2 * k, rows)
            m = min(rows, k + 1)
            keys, _, _ = self._stage(_head_batch(chunk, m), m)
            first, _ = self._boundary_indices(keys, m)
            if first or m == rows:
                return first

    def _key_at(self, keys: List[ColVal], i: int):
        """Host (value, valid) per partition key at row i (one counted
        fetch; string keys are the operator's stable codes)."""
        from spark_rapids_tpu_torch.utils import hostsync
        part = keys[:len(self.spec.partition_exprs)]
        got = hostsync.fetch_all(
            [k.values[i:i + 1] for k in part] +
            [k.validity[i:i + 1] for k in part if k.validity is not None])
        vals, valids = got[:len(part)], iter(got[len(part):])
        out = []
        for k, v in zip(part, vals):
            valid = True if k.validity is None else bool(next(valids)[0])
            out.append((v[0].item(), valid))
        return out

    @staticmethod
    def _keys_equal(a, b) -> bool:
        for (va, na), (vb, nb) in zip(a, b):
            if na != nb:
                return False
            if na and va != vb and not (va != va and vb != vb):  # NaN
                return False
        return True

    def _chunked_execute(self) -> Iterator[ColumnarBatch]:
        buf: List[ColumnarBatch] = []
        rows = 0
        # the open partition's running state per function, and (when the
        # next chunk might start a new partition) its key on the host
        carry, carry_key = None, None
        running_ok = self._running_capable()
        run_aligned = self._needs_run_aligned_split()

        def process(chunk, n_emit: int, ends_open: bool, whole: bool):
            """Evaluate chunk[:n_emit]; ``ends_open``: its last partition
            goes on past n_emit; ``whole``: n_emit is every row of the
            chunk, so only the next chunk can tell."""
            nonlocal carry, carry_key
            self.metrics[WINDOW_CHUNKS] += 1
            with self.timer(SORT_TIME):
                if carry_key is not None:
                    keys, _, _ = self._stage(_head_batch(chunk, 1), 1)
                    if not self._keys_equal(self._key_at(keys, 0),
                                            carry_key):
                        # the carried partition ended at the chunk edge
                        carry = None
                    carry_key = None
                use = carry if carry is not None else \
                    ([None] * len(self.window_exprs) if ends_open else None)
                out, keys, states = self._evaluate(
                    _head_batch(chunk, n_emit), n_emit, use)
                if ends_open:
                    carry = states
                    if whole:
                        carry_key = self._key_at(keys, n_emit - 1)
                else:
                    carry = None
            return out

        for batch in self.child.execute():
            if batch.nrows == 0:
                continue
            buf.append(batch)
            rows += batch.nrows
            while rows >= self.batch_rows:
                chunk = concat_batches(buf) if len(buf) > 1 else buf[0]
                # the boundaries within [0, batch_rows] decide the split:
                # only those rows are staged
                m = min(rows, self.batch_rows + 1)
                keys, _, _ = self._stage(_head_batch(chunk, m), m)
                first, last = self._boundary_indices(keys, m,
                                                     self.batch_rows)
                if last > 0:
                    # complete partitions up to the last boundary
                    e, ends_open = last, False
                elif running_ok:
                    # one partition past the target: emit a slice of it
                    # and carry its running state
                    if run_aligned:
                        _, rb = self._boundary_indices(
                            keys, m, self.batch_rows, with_runs=True)
                        if rb == 0:
                            break  # one tie run fills the target: grow
                        e, ends_open = rb, True
                    else:
                        e, ends_open = min(self.batch_rows, rows), True
                else:
                    first_any = self._first_boundary(chunk, rows)
                    if first_any == 0:
                        # one open partition fills the buffer and no
                        # carry is possible: grow (a partition must fit)
                        break
                    # the oversized head partition ends later in the
                    # buffer: emit exactly it
                    e, ends_open = first_any, False
                del keys
                yield process(chunk, e, ends_open, e == rows)
                if e < rows:
                    buf = [slice_batch(chunk, [e, rows])[0]]
                    rows -= e
                else:
                    buf, rows = [], 0
        if rows:
            chunk = concat_batches(buf) if len(buf) > 1 else buf[0]
            yield process(chunk, rows, False, True)


def _running_state(we: WindowExpression, sp: W.SortedPartitions,
                   c: Optional[ColVal]):
    """A running function's state arrays at each row: (row number,),
    (count,), (sum, count) or (min/max, count)."""
    kind = we.kind
    capacity = sp.capacity
    device = sp.pos.device
    if kind == "row_number":
        return (sp.pos - sp.seg_start + 1,)
    rows = we.spec.frame.kind == "rows"
    if kind in ("sum", "count", "avg"):
        if kind == "count":
            vals = torch.ones(capacity, dtype=torch.int64, device=device)
            validity = None if c is None else c.validity
        else:
            vals = c.values.to(torch.float64 if kind == "avg"
                               else dts.torch_dtype(we.dtype))
            validity = c.validity
        s, n = W.frame_sum(sp, ColVal(dts.INT64, vals, validity), None, 0,
                           rows=rows)
        return (n,) if kind == "count" else (s, n)
    v, n = W.running_minmax(sp, c, kind)
    if not rows:
        end = sp.run_end.clamp(0, max(capacity - 1, 0))
        v, n = v[end], n[end]
    return (v, n)


def _add_carry(we: WindowExpression, state, carry, mask: torch.Tensor):
    """``state`` with the previous chunk's running ``carry`` folded into
    the rows of ``mask`` (the chunk's first partition)."""
    if we.kind in ("min", "max"):
        v, n = state
        cv, cn = carry
        op = torch.minimum if we.kind == "min" else torch.maximum
        # an empty side holds the reduction's identity, so op is exact
        return (torch.where(mask, op(v, cv), v),
                torch.where(mask, n + cn, n))
    return tuple(torch.where(mask, t + ct, t) for t, ct in zip(state, carry))


def _running_output(we: WindowExpression, state) -> ColVal:
    kind = we.kind
    if kind == "row_number":
        return ColVal(dts.INT32, state[0].to(torch.int32))
    if kind == "count":
        return ColVal(dts.INT64, state[0])
    s, n = state
    if kind == "avg":
        return ColVal(dts.FLOAT64, s / torch.clamp(n, min=1).to(
            torch.float64), n > 0)
    return ColVal(we.dtype, s, n > 0)


def _head_batch(batch: ColumnarBatch, n: int) -> ColumnarBatch:
    """The first ``n`` rows of a batch as views, with no host fetch (a
    string column keeps its chars, as ``_head`` does)."""
    if n == batch.nrows:
        return batch
    cols = {}
    for name, c in batch.columns.items():
        validity = None if c.validity is None else c.validity[:n]
        if c.offsets is not None:
            cols[name] = Column(c.dtype, c.data, n, validity,
                                offsets=c.offsets[:n + 1])
        else:
            cols[name] = Column(c.dtype, c.data[:n], n, validity)
    return ColumnarBatch(cols, n)


def _head(c: ColVal, n: int) -> ColVal:
    """The first ``n`` rows of a column (a string keeps its chars)."""
    validity = None if c.validity is None else c.validity[:n]
    if c.offsets is not None:
        return ColVal(c.dtype, c.values, validity, c.offsets[:n + 1])
    return ColVal(c.dtype, c.values[:n], validity)
