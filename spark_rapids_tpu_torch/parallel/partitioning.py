"""Partitioning: give every row a destination shard.

Counterpart of ``spark_rapids_tpu/parallel/partitioning.py``.  The hash is
the JAX package's murmur3 ``fmix32`` mix over each key column's two
32-bit words, bit for bit, so that the same rows go to the same shard in
both engines.  torch has few unsigned 32-bit operations, so the uint32
arithmetic runs in int64 masked to 32 bits after every multiply
(``ops/kernels._mul32``); a hash is an int64 tensor holding a value in
``[0, 2^32)``.

``layout_by_partition`` sorts rows by destination so each destination's
rows are contiguous, and counts them with the ``partition_histogram``
kernel: the send side of every exchange (``parallel/shuffle.py``).  Unlike
the JAX package's padded layout, its output holds exactly the live rows.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.ops import kernels
from spark_rapids_tpu_torch.ops.expressions import ColVal

_U32 = 0xFFFFFFFF
_NULL_HASH = 0x9E3779B9
_SEED = 42


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 of int64 ``h`` in [0, 2^32)."""
    h = kernels._mul32(h ^ (h >> 16), 0x85EBCA6B)
    h = kernels._mul32(h ^ (h >> 13), 0xC2B2AE35)
    return h ^ (h >> 16)


def _column_words(c: ColVal) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (lo, hi) 32-bit words (as int64 in [0, 2^32)) encoding the
    column's value so that rows comparing equal give equal words.  Floats
    canonicalise (-0.0 -> 0.0, every NaN -> 0.0), then split into the
    float32 bits of the value and the float32 bits of the scaled residual
    (``v - float64(float32(v))``, times 2^29)."""
    v = c.values
    if v.dtype.is_floating_point:
        v = v.to(torch.float64)
        zero = torch.zeros((), dtype=torch.float64, device=v.device)
        v = torch.where(v == 0.0, zero, v)
        v = torch.where(torch.isnan(v), zero, v)
        top = v.to(torch.float32)
        resid = (v - top.to(torch.float64)).to(torch.float32) * (2.0 ** 29)
        lo = top.contiguous().view(torch.int32).to(torch.int64) & _U32
        hi = resid.contiguous().view(torch.int32).to(torch.int64) & _U32
        return lo, hi
    if v.dtype == torch.bool:
        return v.to(torch.int64), torch.zeros_like(v, dtype=torch.int64)
    w = v.to(torch.int64)
    return w & _U32, (w >> 32) & _U32


def hash_columns(cols: Sequence[ColVal], seed: int = _SEED) -> torch.Tensor:
    """uint32 hash per row (int64 tensor) over the key columns; a null key
    hashes to a fixed sentinel."""
    acc = None
    for c in cols:
        lo, hi = _column_words(c)
        h = _mix32(lo ^ seed)
        h = _mix32((kernels._mul32(h, 31) + _mix32(hi ^ seed)) & _U32)
        if c.validity is not None:
            h = torch.where(c.validity, h, _NULL_HASH)
        acc = h if acc is None else \
            _mix32((kernels._mul32(acc, 31) + h) & _U32)
    return acc


def hash_partition_ids(key_cols: Sequence[ColVal],
                       num_parts: int) -> torch.Tensor:
    """Destination (int32) of each row: the key hash modulo ``num_parts``."""
    return (hash_columns(key_cols) % num_parts).to(torch.int32)


# -- host-side copy (numpy) ------------------------------------------------
# The JAX package keeps a numpy port of the hash beside the device one; the
# port keeps its own copy, so placement decided on the host matches the
# device's row for row.

def _np_mix32(h):
    h = np.uint32(h)
    h = (h ^ (h >> np.uint32(16))) * np.uint32(0x85EBCA6B)
    h = (h ^ (h >> np.uint32(13))) * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def _np_column_words(values: np.ndarray):
    v = values
    if np.issubdtype(v.dtype, np.floating):
        v = np.where(v == 0.0, 0.0, v).astype(np.float64)
        v = np.where(np.isnan(v), np.float64(0.0), v)
        top = v.astype(np.float32)
        resid = ((v - top.astype(np.float64)).astype(np.float32)
                 * np.float32(2.0) ** 29)
        return top.view(np.uint32), resid.view(np.uint32)
    if v.dtype == np.bool_:
        return v.astype(np.uint32), np.zeros_like(v, dtype=np.uint32)
    w = v.astype(np.int64)
    lo = (w & np.int64(0xFFFFFFFF)).astype(np.uint32)
    hi = (w >> 32).astype(np.uint32)
    return lo, hi


def host_hash_partition_ids(key_cols, num_parts: int,
                            seed: int = _SEED) -> np.ndarray:
    """Host-side partition ids matching :func:`hash_partition_ids` row
    for row.  ``key_cols``: [(values ndarray, validity ndarray or None)]."""
    acc = None
    with np.errstate(over="ignore"):
        for values, validity in key_cols:
            lo, hi = _np_column_words(values)
            h = _np_mix32(lo ^ np.uint32(seed))
            h = _np_mix32(h * np.uint32(31)
                          + _np_mix32(hi ^ np.uint32(seed)))
            if validity is not None:
                h = np.where(validity, h, np.uint32(_NULL_HASH))
            acc = h if acc is None else _np_mix32(
                acc * np.uint32(31) + h)
    return (acc % np.uint32(num_parts)).astype(np.int32)


def round_robin_partition_ids(capacity: int, num_parts: int,
                              start: int = 0, *, device) -> torch.Tensor:
    return ((torch.arange(capacity, device=device) + start)
            % num_parts).to(torch.int32)


def single_partition_ids(capacity: int, *, device) -> torch.Tensor:
    return torch.zeros(capacity, dtype=torch.int32, device=device)


def range_partition_ids(key: ColVal, bounds: torch.Tensor) -> torch.Tensor:
    """Destination by ascending range bounds: the count of bounds <= the
    row's key."""
    return torch.searchsorted(bounds, key.values,
                              right=True).to(torch.int32)


def layout_by_partition(cols: Sequence[ColVal], pids: torch.Tensor,
                        nrows: int, num_parts: int
                        ) -> Tuple[List[ColVal], torch.Tensor, torch.Tensor]:
    """Rows sorted by destination (stable), cut to the ``nrows`` live rows;
    returns (sorted columns, counts int32[num_parts], starts).

    ``counts[d]`` is the number of live rows bound for ``d`` (the
    ``partition_histogram`` kernel on the card) and ``starts`` its
    exclusive prefix sum.  Every live pid must lie in ``[0, num_parts)``;
    rows at or past ``nrows`` are padding and go nowhere."""
    from spark_rapids_tpu_torch.ops import selection
    capacity = pids.shape[0]
    row_mask = torch.arange(capacity, device=pids.device) < nrows
    sort_key = torch.where(row_mask, pids.to(torch.int32), num_parts)
    perm = torch.argsort(sort_key, stable=True)[:nrows]
    sorted_cols = selection.gather(cols, perm)
    counts = kernels.histogram(pids, row_mask, num_parts)
    starts = torch.cumsum(counts, 0) - counts
    return sorted_cols, counts, starts
