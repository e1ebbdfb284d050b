"""Distributed sort and TopN over a shard group.

Counterpart of ``spark_rapids_tpu/parallel/distsort.py``.  The sort
range-partitions on sampled splitters and sorts each shard locally, in the
JAX package's three phases with two host syncs:

1. **sample**: each shard takes ``SAMPLE_PER_SHARD`` strided key rows; the
   host gathers the samples and picks ``nshards - 1`` splitter rows in
   the query's total order (:func:`host_order`: descending keys, nulls
   first or last, NaN largest, -0.0 == 0.0, as the single-device sort).
2. **stats**: a histogram of every shard's range-partition ids
   (:func:`range_pids`) against the splitters, the ``partition_histogram``
   kernel on the card.
3. **final**: rows exchange to their range and each shard sorts locally
   (``ops/aggregates.sort_permutation``).  Shard i then holds range i,
   so the shards in order are the total order; equal keys land on one
   shard in source order, so the result is the stable sort.

``DistributedTopN`` sorts each shard, keeps its first n rows, gathers
the heads and cuts their merge to n, on shard 0; its ``last_stats`` holds
the rows gathered and kept.  Fixed-width keys only.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops import selection
from spark_rapids_tpu_torch.ops.aggregates import sort_permutation
from spark_rapids_tpu_torch.ops.compiler import check_raise, widen
from spark_rapids_tpu_torch.ops.expressions import (
    ColVal, EmitContext, Expression)
from spark_rapids_tpu_torch.ops.kernels import histogram
from spark_rapids_tpu_torch.parallel.distributed import cut, host_sync
from spark_rapids_tpu_torch.parallel.mesh import Shard, ShardGroup
from spark_rapids_tpu_torch.parallel.shuffle import all_gather_cols, exchange


def _norm_one(v: torch.Tensor):
    """(primary, nan flag as int8): NaN sorts largest, -0.0 == 0.0,
    integers and bools pass through."""
    if v.dtype.is_floating_point:
        nan = torch.isnan(v)
        zero = torch.zeros((), dtype=v.dtype, device=v.device)
        f = torch.where((v == 0.0) | nan, zero, v)
        return f, nan.to(torch.int8)
    if v.dtype == torch.bool:
        v = v.to(torch.int8)
    return v, torch.zeros(v.shape, dtype=torch.int8, device=v.device)


def _cmp_one(c: ColVal, desc: bool, nulls_first: bool, sv, svalid: bool):
    """(lt, eq) of each row's key against one splitter value in this key's
    total order (descending flips lt; nulls order by ``nulls_first``; a
    null equals a null)."""
    v = c.values
    f, nan = _norm_one(v)
    sf, snan = _norm_one(torch.as_tensor(sv, dtype=v.dtype,
                                         device=v.device))
    lt = (nan < snan) | ((nan == snan) & (f < sf))
    eq = (nan == snan) & (f == sf)
    if desc:
        lt = ~lt & ~eq
    rv = c.validity if c.validity is not None else \
        torch.ones(f.shape, dtype=torch.bool, device=v.device)
    if svalid:
        # a null row sorts before a valid splitter iff nulls come first
        lt = torch.where(rv, lt, bool(nulls_first))
        eq = rv & eq
    else:
        lt = rv & (not nulls_first)
        eq = ~rv
    return lt, eq


def range_pids(key_cols: Sequence[ColVal], descending: Sequence[bool],
               nulls_first: Sequence[bool], spl_vals, spl_valid,
               nshards: int) -> torch.Tensor:
    """Destination shard of each row: the count of splitters at or below
    the row in the total order.  ``spl_vals[k]`` / ``spl_valid[k]``: the
    ``nshards - 1`` splitter values of key k and their validity (host
    arrays)."""
    cap = key_cols[0].values.shape[0]
    device = key_cols[0].values.device
    pid = torch.zeros(cap, dtype=torch.int32, device=device)
    for s in range(nshards - 1):
        lt = torch.zeros(cap, dtype=torch.bool, device=device)
        eq = torch.ones(cap, dtype=torch.bool, device=device)
        for k, c in enumerate(key_cols):
            k_lt, k_eq = _cmp_one(c, descending[k], nulls_first[k],
                                  spl_vals[k][s], bool(spl_valid[k][s]))
            lt = lt | (eq & k_lt)
            eq = eq & k_eq
        pid = pid + (~lt).to(torch.int32)
    return pid


def host_order(cols: Sequence[np.ndarray], valids: Sequence[np.ndarray],
               descending: Sequence[bool], nulls_first: Sequence[bool],
               live: Optional[np.ndarray] = None) -> np.ndarray:
    """np.lexsort permutation realizing the same total order host-side
    (dead rows last).  Used for splitter selection."""
    lex: List[np.ndarray] = []
    for v, valid, desc, nf in zip(reversed(list(cols)),
                                  reversed(list(valids)),
                                  reversed(list(descending)),
                                  reversed(list(nulls_first))):
        if np.issubdtype(v.dtype, np.floating):
            nan = np.isnan(v)
            f = np.where(v == 0.0, 0.0, v)
            f = np.where(nan, 0.0, f)
            lex.extend([-f, -nan.astype(np.int8)] if desc
                       else [f, nan.astype(np.int8)])
        else:
            iv = v.astype(np.int64) if v.dtype == np.bool_ else v
            lex.append(~iv if desc else iv)
        null_key = (~valid).astype(np.int8)
        lex.append(-null_key if nf else null_key)
    if live is not None:
        lex.append((~live).astype(np.int8))
    return np.lexsort(lex)


def _emit_keys(key_exprs, cols: Shard, n: int, device) -> List[ColVal]:
    ctx = EmitContext(cols, n, n, device)
    keys = [widen(e.emit(ctx), n) for e in key_exprs]
    check_raise(ctx)
    return keys


class DistributedSort:
    """Range-partitioned sort.  After ``__call__`` shard i holds range i,
    sorted."""

    SAMPLE_PER_SHARD = 256

    def __init__(self, group: ShardGroup, in_dtypes: Sequence[DataType],
                 key_exprs: Sequence[Expression],
                 descending: Sequence[bool], nulls_first: Sequence[bool]):
        self.group = group
        self.nshards = group.nshards
        self.in_dtypes = list(in_dtypes)
        self.key_exprs = list(key_exprs)
        self.descending = list(descending)
        self.nulls_first = list(nulls_first)
        self.last_stats: Optional[dict] = None

    def _splitters(self, keys: Sequence[List[ColVal]],
                   nrows: Sequence[int]):
        """Phase 1: strided samples, one host sync, splitter rows."""
        device = self.group.device
        k = self.SAMPLE_PER_SHARD
        per_shard = []
        for ks, n in zip(keys, nrows):
            idx = (torch.arange(k, device=device) * n) // k
            live = torch.full((k,), n > 0, dtype=torch.bool, device=device)
            parts = [live]
            for c in ks:
                src = c.values if n > 0 else \
                    torch.zeros(1, dtype=c.values.dtype, device=device)
                parts.append(src[idx])
                valid = live if c.validity is None or n == 0 else \
                    c.validity[idx] & live
                parts.append(valid)
            per_shard.append(tuple(parts))
        got = host_sync(self.group, per_shard)
        live = got[0].reshape(-1)
        cols = [g.reshape(-1) for g in got[1::2]]
        valids = [g.reshape(-1) & live for g in got[2::2]]
        order = host_order(cols, valids, self.descending, self.nulls_first,
                           live=live)
        m = int(live.sum())
        if m == 0:
            idx = np.zeros(self.nshards - 1, dtype=np.int64)
        else:
            ranks = np.clip((np.arange(1, self.nshards) * m) // self.nshards,
                            0, m - 1)
            idx = order[ranks]
        spl_vals = [v[idx] for v in cols]
        spl_valid = [valid[idx] if m else np.ones(self.nshards - 1, bool)
                     for valid in valids]
        return spl_vals, spl_valid

    def __call__(self, shards: Sequence[Shard], nrows: Sequence[int]
                 ) -> Tuple[List[Shard], List[int]]:
        device = self.group.device
        keys = [_emit_keys(self.key_exprs, cols, n, device)
                for cols, n in zip(shards, nrows)]
        spl_vals, spl_valid = self._splitters(keys, nrows)
        # phase 2: the stats histogram of range ids
        pids, hists = [], []
        for ks, n in zip(keys, nrows):
            p = range_pids(ks, self.descending, self.nulls_first, spl_vals,
                           spl_valid, self.nshards)
            pids.append(p)
            hists.append(histogram(p, torch.ones(n, dtype=torch.bool,
                                                 device=device),
                                   self.nshards))
        counts = host_sync(self.group, hists).astype(np.int64)
        self.last_stats = {"partition_counts": counts}
        # phase 3: exchange to the ranges, sort each shard
        recv = exchange(shards, pids, nrows, self.nshards, self.group)
        outs, sizes = [], []
        for cols in recv:
            n = cols[0].values.shape[0] if cols else 0
            rkeys = _emit_keys(self.key_exprs, cols, n, device)
            perm = sort_permutation(
                rkeys, torch.ones(n, dtype=torch.bool, device=device),
                self.descending, self.nulls_first)
            outs.append(selection.gather(cols, perm))
            sizes.append(n)
        return outs, sizes


class DistributedTopN:
    """The first ``n`` rows in the sort order, on shard 0: each shard's
    sorted head of at most ``n`` rows, all heads gathered, their merge
    cut to ``n``."""

    def __init__(self, group: ShardGroup, in_dtypes: Sequence[DataType],
                 key_exprs: Sequence[Expression],
                 descending: Sequence[bool], nulls_first: Sequence[bool],
                 n: int):
        self.group = group
        self.in_dtypes = list(in_dtypes)
        self.key_exprs = list(key_exprs)
        self.descending = list(descending)
        self.nulls_first = list(nulls_first)
        self.n = int(n)
        self.last_stats: Optional[dict] = None

    def _head(self, cols: Shard, keys: List[ColVal], rows: int):
        device = self.group.device
        perm = sort_permutation(
            keys, torch.ones(rows, dtype=torch.bool, device=device),
            self.descending, self.nulls_first)[: min(self.n, rows)]
        return selection.gather(list(cols) + list(keys), perm)

    def __call__(self, shards: Sequence[Shard], nrows: Sequence[int]
                 ) -> Tuple[List[Shard], List[int]]:
        device = self.group.device
        ncols = len(self.in_dtypes)
        heads = [self._head(cols, _emit_keys(self.key_exprs, cols, n,
                                             device), n)
                 for cols, n in zip(shards, nrows)]
        merged = all_gather_cols(heads, self.group)
        total = merged[0].values.shape[0]
        top = self._head(merged[:ncols], merged[ncols:], total)[:ncols]
        k = min(self.n, total)
        self.last_stats = {"gathered_rows": total, "rows": k}
        outs, sizes = [], []
        for s in self.group.local_shards:
            size = k if s == 0 else 0
            outs.append(cut(top, size))
            sizes.append(size)
        return outs, sizes
