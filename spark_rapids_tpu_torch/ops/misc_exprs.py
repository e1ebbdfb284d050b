"""Hashes and per-batch ids.

Counterpart of ``spark_rapids_tpu/ops/misc_exprs.py``.

``Murmur3Hash`` is Spark's ``hash()``: Murmur3_x86_32 with seed 42, each
non-null argument hashed with the running hash as its seed
(``hashInt`` for booleans, the small integers and dates, ``hashLong``
for bigints, timestamps and decimals, the float bits with -0.0 as 0.0 and
NaN canonical, and ``hashUnsafeBytes`` over a string's UTF-8 bytes, its
tail bytes mixed one by one as signed bytes), an int32.  The 32-bit
arithmetic runs in int64 masked to 32 bits (torch's ``>>`` on an int32 is
arithmetic and its int32 overflow is not promised).  The JAX package's
``hash()`` is its partitioner's fmix mix instead, so the two differ
(``ROADMAP.md`` queue 3).

``Md5`` has no device rule: a plan holding it runs that node in the CPU
fallback (``hashlib``), as in the JAX package.

``monotonically_increasing_id()`` and ``spark_partition_id()`` need the
batch they are in: ``DataFrame.select`` routes their markers through a
``BatchId`` plan node, whose operator ``TpuBatchIdExec`` appends both
columns per batch (a batch is a partition: the id is the batch ordinal
shifted left 33 bits plus the row's offset, Spark's split).
"""

from __future__ import annotations

from typing import Iterator

import torch

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import Column
from spark_rapids_tpu_torch.exec.base import Schema, TpuExec
from spark_rapids_tpu_torch.ops.expressions import (
    ColVal, EmitContext, Expression)
from spark_rapids_tpu_torch.ops.kernels import _mul32

_U32 = 0xFFFFFFFF
SEED = 42


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _U32


def _mix_k1(k: torch.Tensor) -> torch.Tensor:
    return _mul32(_rotl(_mul32(k, 0xCC9E2D51), 15), 0x1B873593)


def _mix_h1(h: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    h = _rotl(h ^ k, 13)
    return (_mul32(h, 5) + 0xE6546B64) & _U32


def _fmix(h: torch.Tensor, length) -> torch.Tensor:
    h = h ^ length
    h = _mul32(h ^ (h >> 16), 0x85EBCA6B)
    h = _mul32(h ^ (h >> 13), 0xC2B2AE35)
    return h ^ (h >> 16)


def hash_int(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Murmur3 ``hashInt`` of int32 values (any int tensor, taken mod
    2^32) with per-row seeds in [0, 2^32)."""
    return _fmix(_mix_h1(seed, _mix_k1(v.to(torch.int64) & _U32)), 4)


def hash_long(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    v = v.to(torch.int64)
    h = _mix_h1(seed, _mix_k1(v & _U32))
    h = _mix_h1(h, _mix_k1((v >> 32) & _U32))
    return _fmix(h, 8)


def hash_bytes(c: ColVal, seed: torch.Tensor, capacity: int
               ) -> torch.Tensor:
    """Murmur3 ``hashUnsafeBytes`` of each row's UTF-8 bytes: its 4-byte
    little-endian words, then each tail byte as a signed int; the longest
    row's word count is one counted fetch."""
    from spark_rapids_tpu_torch.ops.stringops import _row_bounds
    from spark_rapids_tpu_torch.utils import hostsync
    starts, ends = _row_bounds(c)
    lens = ends - starts
    nbytes = c.values.shape[0]
    if capacity == 0 or nbytes == 0:
        return _fmix(seed, lens & _U32)
    nwords = torch.div(lens, 4, rounding_mode="floor")
    most = int(hostsync.fetch(nwords.max()))

    def byte(at):
        return c.values[at.clamp(0, nbytes - 1)].to(torch.int64)
    h = seed
    for w in range(most):
        at = starts + 4 * w
        word = byte(at) | (byte(at + 1) << 8) | (byte(at + 2) << 16) | \
            (byte(at + 3) << 24)
        h = torch.where(w < nwords, _mix_h1(h, _mix_k1(word)), h)
    tail_at = starts + 4 * nwords
    for t in range(3):
        b = byte(tail_at + t)
        signed = torch.where(b >= 128, b | 0xFFFFFF00, b)
        h = torch.where(t < lens - 4 * nwords, _mix_h1(h, _mix_k1(signed)),
                        h)
    return _fmix(h, lens & _U32)


def hash_column(c: ColVal, seed: torch.Tensor, capacity: int
                ) -> torch.Tensor:
    """One argument's Murmur3 hash over the running ``seed`` (nulls keep
    the seed)."""
    dt = c.dtype
    if dt.is_string:
        from spark_rapids_tpu_torch.ops.stringops import as_column
        c2 = as_column(c, capacity)
        h = hash_bytes(c2, seed, capacity)
    else:
        v = c.values
        if v.dim() == 0:
            v = v.expand(capacity)
        if dt.is_boolean:
            h = hash_int(v.to(torch.int64), seed)
        elif dt.name == "float":
            v = torch.where(v == 0, torch.zeros_like(v), v)
            bits = v.contiguous().view(torch.int32).to(torch.int64)
            bits = torch.where(torch.isnan(v), 0x7FC00000, bits)
            h = hash_int(bits, seed)
        elif dt.name == "double":
            v = torch.where(v == 0, torch.zeros_like(v), v)
            bits = v.contiguous().view(torch.int64)
            bits = torch.where(torch.isnan(v), 0x7FF8000000000000, bits)
            h = hash_long(bits, seed)
        elif dt.name in ("bigint", "timestamp") or dt.is_decimal:
            h = hash_long(v, seed)
        else:
            h = hash_int(v, seed)
    valid = c.validity
    if valid is None:
        return h
    if valid.dim() == 0:
        valid = valid.expand(capacity)
    return torch.where(valid, h, seed)


class Murmur3Hash(Expression):
    """hash(cols...): Spark's int32 Murmur3 hash, seed 42."""

    def __init__(self, *children: Expression, seed: int = SEED):
        self.children = tuple(children)
        self.seed = int(seed)

    def with_children(self, children):
        return Murmur3Hash(*children, seed=self.seed)

    @property
    def dtype(self):
        return dts.INT32

    @property
    def nullable(self) -> bool:
        return False

    def cache_key(self):
        return ("Murmur3Hash", self.seed,
                tuple(c.cache_key() for c in self.children))

    def emit(self, ctx: EmitContext) -> ColVal:
        h = torch.full((ctx.capacity,), self.seed & _U32, dtype=torch.int64,
                       device=ctx.device)
        for child in self.children:
            h = hash_column(child.emit(ctx), h, ctx.capacity)
        signed = torch.where(h >= (1 << 31), h - (1 << 32), h)
        return ColVal(dts.INT32, signed.to(torch.int32))


class Md5(Expression):
    """md5(string) as 32 lowercase hex digits: no device rule, so a plan
    holding it runs that node in the CPU fallback (``hashlib``)."""

    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def child(self):
        return self.children[0]

    def with_children(self, children):
        return Md5(children[0])

    @property
    def dtype(self):
        return dts.STRING


class _BatchIdMarker(Expression):
    """``monotonically_increasing_id()`` / ``spark_partition_id()`` in a
    select: ``DataFrame.select`` routes it into a ``BatchId`` node."""

    def __init__(self, kind: str):
        self.kind = kind  # "mid" | "pid"
        self.children = ()

    @property
    def dtype(self):
        return dts.INT64 if self.kind == "mid" else dts.INT32

    @property
    def nullable(self) -> bool:
        return False

    @property
    def name(self) -> str:
        return ("monotonically_increasing_id()" if self.kind == "mid"
                else "spark_partition_id()")

    def emit(self, ctx):
        raise RuntimeError(f"{self.name} is only valid in a select")

    def cache_key(self):
        return ("_BatchIdMarker", self.kind)


class TpuBatchIdExec(TpuExec):
    """Appends the per-batch id columns: each input batch is a partition,
    mid = (batch ordinal << 33) + row offset, pid = batch ordinal."""

    MID_COL = "__mid"
    PID_COL = "__pid"

    def __init__(self, child: TpuExec):
        super().__init__(child)

    @property
    def child(self) -> TpuExec:
        return self.children[0]

    @property
    def schema(self) -> Schema:
        return list(self.child.schema) + [
            (self.MID_COL, dts.INT64), (self.PID_COL, dts.INT32)]

    def do_execute(self) -> Iterator[ColumnarBatch]:
        for ordinal, batch in enumerate(self.child.execute()):
            cap = batch.capacity
            device = batch.device
            mid = torch.arange(cap, dtype=torch.int64, device=device) + \
                (ordinal << 33)
            pid = torch.full((cap,), ordinal, dtype=torch.int32,
                             device=device)
            cols = dict(batch.columns)
            cols[self.MID_COL] = Column(dts.INT64, mid, batch.row_count)
            cols[self.PID_COL] = Column(dts.INT32, pid, batch.row_count)
            yield ColumnarBatch(cols, batch.row_count)
