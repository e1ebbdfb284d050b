"""Stage functions: an operator's expression forest evaluated per batch.

Counterpart of ``spark_rapids_tpu/ops/compiler.py``.  There each forest is
one ``jax.jit``-compiled XLA computation; PyTorch runs eagerly, so a stage
here is a plain function that evaluates the forest over a batch.  The
fused-stage rule is the JAX package's: predicates evaluate bottom-first
with progressive check masking (``fold_conjuncts``), projections evaluate
over the pre-filter rows, and rows compact once, at the stage boundary.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import Column, RowCount
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops.expressions import (
    ColVal, EmitContext, Expression)


def batch_to_colvals(batch: ColumnarBatch,
                     dtypes: Sequence[DataType]) -> List[ColVal]:
    return [ColVal(dt, c.data, c.validity, c.offsets)
            for c, dt in zip(batch.columns.values(), dtypes)]


def batch_context(batch: ColumnarBatch,
                  dtypes: Sequence[DataType]) -> EmitContext:
    """EmitContext over a batch; a device-resident row count stays on the
    device (no sync)."""
    rc = batch.row_count
    device = batch.device
    nrows = int(rc) if rc.is_concrete else rc.device_tensor(device)
    return EmitContext(batch_to_colvals(batch, dtypes), nrows,
                       batch.capacity, device)


def widen(c: ColVal, capacity: int) -> ColVal:
    """Scalar values/validity (literal operands) widen to full columns.
    A string column's chars are not rows and stay as they are; a string
    literal repeats over the rows."""
    v, val = c.values, c.validity
    if c.offsets is not None:
        if c.offsets.shape[0] != capacity + 1:
            from spark_rapids_tpu_torch.ops.stringops import (
                string_literal_column)
            return string_literal_column(c, capacity)
    elif v.dim() == 0:
        v = v.expand(capacity)
    if val is not None and val.dim() == 0:
        val = val.expand(capacity)
    if v is c.values and val is c.validity:
        return c
    return ColVal(c.dtype, v, val, c.offsets)


def colvals_to_columns(outs: Sequence[ColVal], nrows,
                       capacity: int) -> List[Column]:
    """Columns of ``capacity`` rows sharing ONE row count object, so a
    device-resident count resolves once for all of them."""
    nrows = RowCount.wrap(nrows)
    cols = []
    for o in outs:
        o = widen(o, capacity)
        values = o.values.contiguous()
        validity = None if o.validity is None else o.validity.contiguous()
        cols.append(Column(o.dtype, values, nrows, validity=validity,
                           offsets=o.offsets))
    return cols


def check_raise(ctx: EmitContext) -> None:
    """Surface recorded checks host-side (one counted fetch of the flags)."""
    if not ctx.checks:
        return
    from spark_rapids_tpu_torch.utils import hostsync
    flags = hostsync.fetch_all([f for _, f in ctx.checks])
    failed = [m for (m, _), f in zip(ctx.checks, flags) if bool(f)]
    if failed:
        raise ArithmeticError("; ".join(failed))


class StageFn:
    """``__call__(batch) -> list[Column]`` with the input's row count."""

    def __init__(self, exprs: Sequence[Expression],
                 input_dtypes: Sequence[DataType]):
        self.exprs = list(exprs)
        self.input_dtypes = list(input_dtypes)

    def __call__(self, batch: ColumnarBatch) -> List[Column]:
        ctx = batch_context(batch, self.input_dtypes)
        outs = [e.emit(ctx) for e in self.exprs]
        check_raise(ctx)
        return colvals_to_columns(outs, batch.row_count, batch.capacity)


class FilterStageFn:
    """Fused predicate(s) + projections + one compaction.

    ``predicate`` may be a list of conjuncts in bottom-first chain order
    (stage fusion): each evaluates with the mask of the conjuncts below it
    as its check mask, so a fused chain's checks fire for exactly the rows
    the unfused filters would have evaluated."""

    def __init__(self, predicate, project: Sequence[Expression],
                 input_dtypes: Sequence[DataType]):
        self.conjuncts = list(predicate) if isinstance(
            predicate, (list, tuple)) else [predicate]
        self.project = list(project)
        self.input_dtypes = list(input_dtypes)

    def __call__(self, batch: ColumnarBatch) -> Tuple[List[Column], int]:
        from spark_rapids_tpu_torch.ops import selection
        from spark_rapids_tpu_torch.ops.expressions import fold_conjuncts
        ctx = batch_context(batch, self.input_dtypes)
        keep = fold_conjuncts(ctx, self.conjuncts)
        outs = [widen(e.emit(ctx), ctx.capacity) for e in self.project]
        check_raise(ctx)
        compacted, n = selection.compact(outs, keep)
        return colvals_to_columns(compacted, n, n), n
