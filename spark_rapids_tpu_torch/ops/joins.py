"""Equi-join kernels: run matching (phase A) and chunked materialization
(phase B).

Counterpart of ``spark_rapids_tpu/ops/joins.py``:

* phase A, sort-merge (``join_match``): concatenate build and probe key
  columns, sort by (dead last, keys, build before probe) so each
  equal-key run holds its build rows first; segment arithmetic gives every
  probe row its match count and the sorted position of its first build
  match.  Null keys never match (Spark equi-join semantics); outer and
  anti rows survive through the counts.
* phase A, hash (``hash_join_match``): a single key column whose
  normalized 64-bit value is the table code; the build side goes through
  ``kernels.hash_insert`` and the probe side through ``kernels.hash_probe``
  (the JAX package's ``hash_table_insert`` / ``hash_table_probe``
  dispatch: the hand-written CUDA kernels on the card, the plain versions
  on the CPU; both follow the tensors' device, so a table and its probe
  always come from the same pair).
  Its outputs feed phase B byte-identically to the sort path's.
* phase B (``join_gather_indices``): with the match total known on the
  host, every output row maps back to (probe row, k-th build match) by one
  searchsorted and two gathers.

``jnp.lexsort`` has no torch counterpart: the sort is stable ``argsort``
passes from the least significant key to the most.  Positions and counts
are int64 throughout; segment sums are ``index_add_`` on int64 (exact), a
segment minimum is ``scatter_reduce(..., "amin")`` over a tensor filled
with the trash value, and a dropped scatter writes into one extra slot
that is sliced off.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from spark_rapids_tpu_torch.ops import kernels
from spark_rapids_tpu_torch.ops import selection
from spark_rapids_tpu_torch.ops.expressions import ColVal

_U32 = 0xFFFFFFFF


def _concat_col(b: ColVal, p: ColVal) -> ColVal:
    values = torch.cat([b.values, p.values])
    validity = None
    if b.validity is not None or p.validity is not None:
        bv = b.validity if b.validity is not None else \
            torch.ones(b.values.shape[0], dtype=torch.bool,
                       device=b.values.device)
        pv = p.validity if p.validity is not None else \
            torch.ones(p.values.shape[0], dtype=torch.bool,
                       device=p.values.device)
        validity = torch.cat([bv, pv])
    return ColVal(b.dtype, values, validity)


def _norm_key(v: torch.Tensor) -> torch.Tensor:
    """Join-key normal form: floats become their float64 bits as int64
    with the sign flip that keeps order (-0.0 first becomes 0.0), bools
    int8, other keys as they are."""
    if v.dtype.is_floating_point:
        v = torch.where(v == 0.0, torch.zeros((), dtype=v.dtype,
                                              device=v.device), v)
        bits = v.to(torch.float64).contiguous().view(torch.int64)
        return torch.where(bits < 0, ~bits, bits)
    if v.dtype == torch.bool:
        return v.to(torch.int8)
    return v


def _stable_lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """``jnp.lexsort``: the LAST key is primary; stable.  One stable
    argsort pass per key, least significant first."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        perm = perm[torch.argsort(k[perm], stable=True)]
    return perm


def join_match(build_keys: Sequence[ColVal], probe_keys: Sequence[ColVal],
               build_n, probe_n) -> Dict[str, torch.Tensor]:
    """Phase A by sort-merge.  ``build_n`` / ``probe_n``: live rows of
    each side (host int or 0-dim tensor); the key columns may be longer
    (padding).  Returns ``probe_count``, ``probe_bstart``,
    ``sorted_to_build`` and ``build_matched``."""
    device = build_keys[0].values.device
    b_cap = build_keys[0].values.shape[0]
    p_cap = probe_keys[0].values.shape[0]
    cap = b_cap + p_cap
    pos = torch.arange(cap, device=device)
    side = (pos >= b_cap).to(torch.int8)

    # live = in range AND all keys non-null (null never matches)
    live_b = pos < build_n
    live_p = (pos >= b_cap) & (pos < b_cap + probe_n)
    live = live_b | live_p
    norm_keys = []
    for bk, pk in zip(build_keys, probe_keys):
        c = _concat_col(bk, pk)
        if c.validity is not None:
            live = live & c.validity
        norm_keys.append(_norm_key(c.values))

    # sort: dead rows last, then by keys, then build before probe
    perm = _stable_lexsort([side] + norm_keys[::-1]
                           + [(~live).to(torch.int8)])
    n_live = live.sum()

    s_side = side[perm]
    s_live = pos < n_live
    same = torch.ones(cap, dtype=torch.bool, device=device)
    for k in norm_keys:
        sk = k[perm]
        same = same & (sk == torch.roll(sk, 1))
    boundary = (~same | (pos == 0)) & s_live
    run_id = torch.cumsum(boundary, 0) - 1
    run_id = torch.where(s_live, run_id, cap)  # trash segment

    sb = (s_side == 0) & s_live
    sp = (s_side == 1) & s_live
    zeros = torch.zeros(cap + 1, dtype=torch.int64, device=device)
    build_per_run = zeros.clone().index_add_(0, run_id, sb.to(torch.int64))
    probe_per_run = zeros.clone().index_add_(0, run_id, sp.to(torch.int64))
    first_build = torch.full((cap + 1,), cap, dtype=torch.int64,
                             device=device)
    first_build.scatter_reduce_(0, run_id, torch.where(sb, pos, cap),
                                "amin", include_self=True)
    rid = run_id.clamp(0, max(cap - 1, 0))

    # per sorted probe row -> original probe row
    probe_tgt = torch.where(sp, perm - b_cap, p_cap)
    probe_count = torch.zeros(p_cap + 1, dtype=torch.int64, device=device)
    probe_count.scatter_(0, probe_tgt,
                         torch.where(sp, build_per_run[rid], 0))
    probe_bstart = torch.zeros(p_cap + 1, dtype=torch.int64, device=device)
    probe_bstart.scatter_(0, probe_tgt,
                          torch.where(sp, first_build[rid], 0))

    # sorted position -> original build row
    sorted_to_build = torch.where(s_side == 0, perm, 0)

    # build rows that matched some probe row (full outer)
    build_matched = torch.zeros(b_cap + 1, dtype=torch.bool, device=device)
    build_matched.scatter_(0, torch.where(sb, perm, b_cap),
                           sb & (probe_per_run[rid] > 0))
    return {
        "probe_count": probe_count[:p_cap],
        "probe_bstart": probe_bstart[:p_cap],
        "sorted_to_build": sorted_to_build,
        "build_matched": build_matched[:b_cap],
    }


# The JAX package's bound on the hash join's table (a TPU VMEM bound),
# kept so both packages take the same path at the same sizes.
MAX_JOIN_TABLE_SLOTS = 1 << 20


def hash_join_eligible(build_keys: Sequence[ColVal],
                       probe_keys: Sequence[ColVal], b_cap: int) -> bool:
    """Gate of the hash phase A: a single key column (its normalized
    value is the 64-bit table code) and a build side whose half-load
    table fits ``MAX_JOIN_TABLE_SLOTS``.  ``b_cap`` is the build side's
    bucketed capacity (``bucket_capacity(build rows)``), so the gate
    opens at the same build sizes as the JAX package's, where a column's
    length is its bucketed capacity."""
    if len(build_keys) != 1 or len(probe_keys) != 1:
        return False
    return hash_join_table_slots(b_cap) <= MAX_JOIN_TABLE_SLOTS


def hash_join_table_slots(b_cap: int) -> int:
    """Power-of-two table for a load factor <= 0.5 over the build
    capacity (distinct build keys <= b_cap, so insertion never runs out
    of slots; only pathological probe chains can still overflow)."""
    t = 64
    while t < 2 * max(b_cap, 1):
        t *= 2
    return t


def _code_lanes(v: torch.Tensor):
    code = _norm_key(v).to(torch.int64)
    return kernels._to_i32_wrapping(code & _U32), (code >> 32).to(
        torch.int32)


def hash_join_match(build_keys: Sequence[ColVal],
                    probe_keys: Sequence[ColVal], build_n, probe_n,
                    num_slots: int) -> Dict[str, torch.Tensor]:
    """Hash phase A: the contract of :func:`join_match` plus an
    ``overflow`` flag (0-dim bool tensor).  When it is set, the other
    outputs are garbage to discard and the caller reruns the sort-merge
    phase; rows are never dropped.

    Byte-identical to the sort path: the table groups build rows by exact
    normalized key, and ``sorted_to_build`` lists each slot's build rows
    in original order (a stable sort by slot), which is the within-run
    order of the stable lexsort, so phase B materializes the same rows in
    the same order whichever phase A ran."""
    bk, pk = build_keys[0], probe_keys[0]
    device = bk.values.device
    b_cap = bk.values.shape[0]
    p_cap = pk.values.shape[0]
    T = num_slots

    live_b = torch.arange(b_cap, device=device) < build_n
    if bk.validity is not None:
        live_b = live_b & bk.validity
    blo, bhi = _code_lanes(bk.values)
    slot_b, tlo, thi, occ, overflow = kernels.hash_insert(
        blo, bhi, live_b, T)
    slot_b = slot_b.to(torch.int64)  # T for dead / overflowed rows

    # build rows grouped by slot, ORIGINAL order within a slot (stable)
    sorted_to_build = torch.argsort(slot_b, stable=True)
    counts = torch.bincount(slot_b, minlength=T + 1)[:T]
    starts = torch.cumsum(counts, 0) - counts

    live_p = torch.arange(p_cap, device=device) < probe_n
    if pk.validity is not None:
        live_p = live_p & pk.validity
    plo, phi = _code_lanes(pk.values)
    pslot = kernels.hash_probe(plo, phi, live_p, tlo, thi,
                               occ).to(torch.int64)
    hit = pslot < T
    safe = pslot.clamp(0, T - 1)
    probe_count = torch.where(hit, counts[safe], 0)
    probe_bstart = torch.where(hit, starts[safe], 0)

    matched_slot = torch.zeros(T + 1, dtype=torch.bool, device=device)
    matched_slot[pslot] = True  # T = trash
    build_matched = live_b & (slot_b < T) & \
        matched_slot[slot_b.clamp(0, T - 1)]
    return {
        "probe_count": probe_count,
        "probe_bstart": probe_bstart,
        "sorted_to_build": sorted_to_build,
        "build_matched": build_matched,
        "overflow": overflow,
    }


def join_out_starts(probe_count: torch.Tensor, probe_n, outer: bool):
    """Adjusted counts (left outer keeps an unmatched row with one null
    build row), exclusive starts, inclusive ends and the total (0-dim),
    all int64 on the device."""
    p_cap = probe_count.shape[0]
    device = probe_count.device
    in_range = torch.arange(p_cap, device=device) < probe_n
    count = probe_count
    if outer:
        count = torch.where(in_range & (count == 0), 1, count)
    count = torch.where(in_range, count, 0)
    ends = torch.cumsum(count, 0)
    starts = ends - count
    total = ends[-1] if p_cap else torch.zeros((), dtype=torch.int64,
                                               device=device)
    return count, starts, ends, total


def join_gather_indices(starts, ends, probe_count, probe_bstart,
                        sorted_to_build, total, out_cap: int):
    """Phase B mapping: output row j -> (probe row, build row, matched?,
    in range?) for j in [0, out_cap)."""
    device = ends.device
    j = torch.arange(out_cap, device=device)
    p = torch.searchsorted(ends, j, right=True)
    p = p.clamp(0, probe_count.shape[0] - 1)
    k = j - starts[p]
    matched = k < probe_count[p]
    bpos = probe_bstart[p] + k
    brow = sorted_to_build[bpos.clamp(0, sorted_to_build.shape[0] - 1)]
    in_range = j < total
    return p, brow.clamp(min=0), matched & in_range, in_range


def gather_build_side(cols: Sequence[ColVal], brow: torch.Tensor,
                      matched: torch.Tensor) -> List[ColVal]:
    """Gather build columns at ``brow``; unmatched rows become null."""
    outs = selection.gather(cols, brow)
    return [ColVal(o.dtype, o.values,
                   matched if o.validity is None else o.validity & matched,
                   o.offsets) for o in outs]
