#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA engine on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``spark_rapids_tpu_torch/csrc``
for sm_90a and holds each kernel against its plain PyTorch version on the
card; ``hash_insert`` and ``hash_probe`` also at the contract's edges (0,
-1, the int64 extremes and the table's empty word among the codes, every
row on one key, 2^16 keys x 64 duplicates, tables at load 0.7 and 0.9, no
rows, every row dead), ``masked_multi_reduce`` at its own (views 1, 3 and
15 rows in, n of 1 to 2^22 + 7 around its 16-row words and 512-row tiles,
all-pass and last-row-only masks, 8 and 9 columns, NaN and -0.0, a
validity off the mask's alignment), each case run twice.  It times each
kernel at the main path's shapes (CUDA events, and the device time in a
profiler trace; ``masked_multi_reduce`` also at the dense 2^26-row,
3-column check shape, with the sector floor beside its bound), then
drives the engine's paths
through ``TpuSession`` on CUDA, each with the kernel launch counts reset
just before it and read just after:

- TPC-H q6 and the q1-shaped group-by over 2^26 lineitem rows (the
  columns ``bench.py``'s ``gen_host`` makes);
- the sparse-key hash group-by (2^22 rows, 2^20 keys drawn from
  [0, 2^40)), hash path on and off;
- TPC-H q3 at scale factor 10 (only the columns q3 reads, value for value
  ``models/tpch.gen_tables``'), hash path on and off: two sort-merge
  joins, the three-key group-by, TopN;
- the fact-dim hash join (2^26 fact rows against 2^19 dim rows, then a
  group-by on the key), hash path on (``hash_insert`` + ``hash_probe`` in
  every probe batch) and off;
- the sharded query path on 8 logical shards of the card
  (``spark.rapids.sql.distributed.numShards=8``): q6 and the q1 shape at
  2^26 rows, the sparse-key group-by, the fact-dim join as a shuffle
  (2^19 build rows are past the 2^16 broadcast threshold) and
  ``orderBy`` / TopN of the 2^22-row sparse table, each beside its
  single-device twin; and the q1 shape at 2^22 rows through a one-rank
  NCCL process group against one logical shard.

Answers are checked against numpy / pandas oracles on the same host data.

Output, in order: the card's name and power limit, the torch/CUDA versions
and kernel build time, one line per check, rows/s per query, a
``{"kernels": [...]}`` line (per kernel: the first shape's times at the
top level, other shapes under ``other_shapes``, the main path's launches
in total and by shape), and last
``{"ok": true, "device": {...}}``.
Any failed check exits non-zero before the ``ok`` line.  Without a CUDA
device, or without the rest of the repository beside it, it fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 42
DEVICE = "cuda:0"

Q6_ROWS = 1 << 26
HASH_ROWS = 1 << 22
HASH_CARD = 1 << 20
HASH_SLOTS = 1 << 21
MMR_CHECK_ROWS = 1 << 26
Q3_SF = 10
FACT_ROWS = 1 << 26
DIM_ROWS = 1 << 19
BATCH_ROWS = 1 << 22
JOIN_SLOTS = 1 << 20                    # the join build's table
NSHARDS = 8
HIST_FACT_ROWS = FACT_ROWS // NSHARDS   # the join's stats pass per shard
HIST_BUCKET_ROWS = 1 << 19              # an aggregate's bucket stats pass
PG_ROWS = 1 << 22

TRACE_PAD = 16        # device ops around the timed calls in a trace
KERNEL_RTOL = 1e-12   # kernel vs plain float sums (another summation order)
QUERY_RTOL = 1e-9     # engine vs numpy oracle (bench.py's own q6 check)
# q3 hash on vs off: the group-by's float sums add in another order
# (atomics on the sort path, slot order on the hash path)
PATH_RTOL = 1e-12

# device-memory rate by card (NVIDIA data sheets), for the bound
HBM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12,
                   "H200": 4.8e12, "H100": 3.35e12}
# peak rate for the kernels' operations: float32 outside the tensor cores
# of an H100 SXM; float64 and int32 run no faster, so the operations term
# stays a lower bound on their time
PEAK_OPS_PER_S = 67e12


class CheckFailed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)
    print(f"ok   {what}", flush=True)


def gen_host(n: int, seed: int = SEED):
    """bench.py's gen_host: the numeric lineitem columns, 52 B a row."""
    rng = np.random.default_rng(seed)
    return {
        "l_extendedprice": rng.uniform(1000.0, 100000.0, n),
        "l_discount": rng.uniform(0.0, 0.11, n).round(2),
        "l_quantity": rng.integers(1, 51, n).astype(np.float64),
        "l_shipdate": rng.integers(8766, 10957, n).astype(np.int32),
        "l_tax": rng.uniform(0.0, 0.08, n).round(2),
        "l_returnflag_code": rng.integers(0, 3, n).astype(np.int64),
        "l_linestatus_code": rng.integers(0, 2, n).astype(np.int64),
    }


def gen_sparse(n: int, card: int, seed: int = SEED):
    """bench.py's --hash-agg-cardinality table: ``card`` distinct int64
    keys from [0, 2^40), integer-valued float64 values."""
    rng = np.random.default_rng(seed)
    uni = np.unique(rng.integers(0, 1 << 40, 4 * card, dtype=np.int64))[:card]
    keys = uni[rng.integers(0, len(uni), n)]
    vals = rng.integers(0, 1000, n).astype(np.float64)
    return {"k": keys, "v": vals}


def group_by_codes(n: int = HASH_ROWS, card: int = HASH_CARD):
    """The hash group-by's update-stage codes: the sparse table's keys as
    the radix codes the group-by hands ``hash_insert`` (key - min + 1)."""
    k = gen_sparse(n, card)["k"]
    return k - k.min() + 1


def q6_batch(torch, device, data, n: int = BATCH_ROWS):
    """q6's first batch as the main path hands it to
    ``masked_multi_reduce``: the fused filter's mask and rev = price *
    discount over the first ``n`` rows of ``gen_host``'s columns."""
    first = {k: torch.from_numpy(data[k][:n]).to(device)
             for k in ("l_shipdate", "l_discount", "l_quantity",
                       "l_extendedprice")}
    m = ((first["l_shipdate"] >= 9131) & (first["l_shipdate"] < 9496)
         & (first["l_discount"] >= 0.05) & (first["l_discount"] <= 0.07)
         & (first["l_quantity"] < 24.0))
    return first["l_extendedprice"] * first["l_discount"], m


def join_lanes(torch, device):
    """The fact-dim join's hash phase at the main path's shapes, as
    lanes: the build (the 2^19 dim keys) and one probe batch (2^22 fact
    keys, about half of them in dim)."""
    fact, dim = gen_fact_dim(BATCH_ROWS, DIM_ROWS)
    return (split_lanes(torch, dim["k"], device),
            split_lanes(torch, fact["k"], device))


# ------------------------------------------------------------------ timing --

def roofline(nbytes: int, ops: int, hbm: float):
    """(bound ms, what bounds it): the larger of the bytes over the memory
    rate and the operations over the peak rate."""
    t_bytes, t_ops = nbytes / hbm, ops / PEAK_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


class Timer:
    """Median time of a callable on the card: CUDA events around each
    call, after warm-up, with the L2 cache flushed before every call."""

    def __init__(self, torch, device):
        self.torch = torch
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device=device)
        self.marker = None  # the flush's kernel names in a trace

    def ms(self, fn, reps: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    def device_ms(self, fn, names, reps: int = 10, tries: int = 5):
        """``(ms, ops)``: the median over calls of the summed device time
        of the ops whose names contain one of ``names`` (kernels, and
        "Memset" for a wrapper's memsets), and how many such ops one call
        ran, from a ``torch.profiler`` trace of ``reps`` calls with the L2
        cache flushed before each: the kernels alone, without the host
        work that the event timing above includes.  The flush here is an
        elementwise kernel, so it is never counted as a memset; it also
        marks where each call begins in the trace.  The profiler loses a
        device op now and then, mostly at a trace's start or end, so each
        trace begins and ends with ``TRACE_PAD`` flushes, and a call
        counts only if it ran the most common number of named ops; a
        trace with fewer than half its calls whole is taken again (and
        reported), up to ``tries`` times.  ``(None, 0)`` if none was."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile as tprofile
        cuda = torch.autograd.DeviceType.CUDA
        for _ in range(tries):
            if self.marker:
                break
            with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(2 * TRACE_PAD):
                    self.flush.add_(1)
                torch.cuda.synchronize()
            self.marker = {e.name for e in prof.events()
                           if e.device_type == cuda}
        fn()
        torch.cuda.synchronize()
        for _ in range(tries):
            with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(TRACE_PAD):
                    self.flush.add_(1)
                for _ in range(reps):
                    self.flush.add_(1)
                    fn()
                for _ in range(TRACE_PAD):
                    self.flush.add_(1)
                torch.cuda.synchronize()
            calls, cur = [], None  # [ops, us] of each call after a flush
            for e in sorted((e for e in prof.events()
                             if e.device_type == cuda),
                            key=lambda e: e.time_range.start):
                if e.name in self.marker:
                    cur = [0, 0.0]
                    calls.append(cur)
                elif cur is not None and any(n in e.name for n in names):
                    cur[0] += 1
                    cur[1] += e.time_range.end - e.time_range.start
            counts = [c for c, _ in calls if c]
            if counts:
                per = max(set(counts), key=counts.count)
                whole = [us for c, us in calls if c == per]
                if 2 * len(whole) >= reps:
                    return float(np.median(whole)) / 1e3, per
            print(f"device_ms: {len(whole) if counts else 0} of {reps} "
                  f"calls whole in the trace (ops named {names} a call: "
                  f"{sorted(counts)}); taken again", flush=True)
        return None, 0


def dev_text(dev, ops=None) -> str:
    if dev is None:
        return "not measured (no kernel in the trace)"
    return f"{dev:.6f} ms" + ("" if ops is None else f" ({ops} ops a call)")


# --------------------------------------------------------- kernel checks --

def mmr_inputs(torch, device, n, ncols, rng):
    """Values with -0.0 sprinkled in, partly null validity on all but the
    first column, a 30% mask."""
    vals = [rng.normal(size=n) * 1e3 for _ in range(ncols)]
    for v in vals:
        v[:: 97] = -0.0
    valids = [None] + [rng.random(n) < 0.8 for _ in range(ncols - 1)]
    mask = rng.random(n) < 0.3
    to = lambda a: None if a is None else torch.from_numpy(a).to(device)
    return [to(v) for v in vals], [to(v) for v in valids], to(mask)


def mmr_dense(torch, device, ncols=3):
    """The dense check shape: ``MMR_CHECK_ROWS`` rows of ``mmr_inputs``
    from a seed of their own, so ``time_kernels.py`` times the same."""
    return mmr_inputs(torch, device, MMR_CHECK_ROWS, ncols,
                      np.random.default_rng(SEED + ncols))


def q6_merge(torch, device):
    """q6's merge of its 16 batch partials as the main path hands it to
    ``masked_multi_reduce``: 16 float64 rows, every one live (one block;
    the launch and the merge alone)."""
    v = np.random.default_rng(SEED).uniform(0.0, 1e9, 16)
    return ([torch.from_numpy(v).to(device)], [None],
            torch.ones(16, dtype=torch.bool, device=device))


def mmr_case(torch, base, case):
    vals, valids, mask = base
    if case == "nan":
        v = vals[0].clone()
        v[:: 1000003] = float("nan")
        vals = [v] + vals[1:]
    elif case == "all_masked":
        mask = torch.zeros_like(mask)
    return vals, valids, mask


def check_mmr(torch, K, vals, valids, mask, tag):
    s1, c1 = K.masked_multi_reduce(vals, valids, mask)
    s2, c2 = K.masked_multi_reduce(vals, valids, mask)
    ps, pc = K.masked_multi_reduce_plain(vals, valids, mask)
    torch.cuda.synchronize()
    s1, c1, s2, c2, ps, pc = [t.cpu().numpy() for t in (s1, c1, s2, c2,
                                                        ps, pc)]
    tag = f"masked_multi_reduce {tag}"
    check(np.array_equal(c1, pc) and np.array_equal(c1, c2),
          f"{tag}: counts exact {c1.tolist()}")
    close = np.allclose(s1, ps, rtol=KERNEL_RTOL, atol=0, equal_nan=True)
    check(close, f"{tag}: sums within rel {KERNEL_RTOL} of plain "
          f"({s1.tolist()} vs {ps.tolist()})")
    check(np.array_equal(s1.view(np.int64), s2.view(np.int64)),
          f"{tag}: two runs bit-identical")
    diff = np.abs(s1 - ps)
    return float(np.nanmax(diff)) if not np.isnan(diff).all() else 0.0


def check_mmr_edges(torch, K, device, rng):
    """masked_multi_reduce at its edges against the plain version, each
    case run twice (``check_mmr``): mask, value and validity views that
    start 1, 3 and 15 bytes or rows in (the kernel's scalar head), n of
    1, 15, 17, 511, 513 and 2^22 + 7 at offsets 0 and 3 (head, tail and a
    ragged last tile), an all-pass mask and one that passes only the last
    row, 8 and 9 columns (9 splits into two launches) with validity on
    some, NaN and -0.0 among the values (a column of -0.0 only), and a
    validity that does not share the mask's 16-byte alignment (read row
    by row).  Returns the largest absolute difference from plain."""
    err = 0.0
    big = 1 << 20
    vals, valids, mask = mmr_inputs(torch, device, big + 64, 3, rng)
    for off in (1, 3, 15):
        n = big + 5
        err = max(err, check_mmr(
            torch, K, [v[off:off + n] for v in vals],
            [None if ok is None else ok[off:off + n] for ok in valids],
            mask[off:off + n], f"views {off} rows in, n={n} cols=3"))
    for n in (1, 15, 17, 511, 513, (1 << 22) + 7):
        v, ok, m = mmr_inputs(torch, device, n + 3, 2, rng)
        for off in (0, 3):
            err = max(err, check_mmr(
                torch, K, [x[off:off + n] for x in v],
                [None if x is None else x[off:off + n] for x in ok],
                m[off:off + n], f"n={n} offset {off} cols=2"))
    n = big + 3
    v, ok, _ = mmr_inputs(torch, device, n, 2, rng)
    every = torch.ones(n, dtype=torch.bool, device=device)
    last = torch.zeros(n, dtype=torch.bool, device=device)
    last[-1] = True
    err = max(err, check_mmr(torch, K, v, ok, every, f"all pass n={n}"))
    err = max(err, check_mmr(torch, K, v, ok, last,
                             f"last row only n={n}"))
    n = big + 9
    for ncols in (8, 9):
        v, ok, m = mmr_inputs(torch, device, n, ncols, rng)
        v[1] = v[1].clone()
        v[1][:: 1013] = float("nan")
        v[2] = torch.full_like(v[2], -0.0)
        ok = [x if c % 3 else None for c, x in enumerate(ok)]
        err = max(err, check_mmr(torch, K, v, ok, m,
                                 f"n={n} cols={ncols}, NaN, -0.0"))
    v, ok, m = mmr_inputs(torch, device, big + 16, 2, rng)
    n = big
    err = max(err, check_mmr(
        torch, K, [x[1:n + 1] for x in v], [None, ok[1][:n]], m[1:n + 1],
        f"validity one byte off the mask's alignment, n={n}"))
    return err


def table_codes(torch, tlo, thi):
    """The int64 codes ``(hi << 32) | (lo & 0xFFFFFFFF)`` of two lanes."""
    return (thi.to(torch.int64) << 32) | (tlo.to(torch.int64) & 0xFFFFFFFF)


def stored_codes(torch, tlo, thi, occ):
    return torch.sort(table_codes(torch, tlo, thi)[occ]).values


def split_lanes(torch, codes, device):
    lo = (codes & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    hi = (codes >> 32).astype(np.int32)
    return torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device)


def extreme_codes(K):
    """0, -1, the int64 extremes and the CUDA table's empty word."""
    return np.array([0, -1, np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                     K.HASH_EMPTY], dtype=np.int64)


def insert_contract(torch, K, lo, hi, live, T, tag, plain_T=None,
                    expect_overflow=False):
    """The CUDA insert twice and its plain version once on the same rows
    (the plain version at ``plain_T`` slots where its cascade cannot hold
    the keys in ``T``), held to the contract, never to slots: a placed
    row's slot holds its code, dead rows sit at T, stored codes are
    distinct live codes; without overflow every live row is placed, the
    stored set is the set of live codes, the same on both runs and in the
    plain version's table.  Returns the first CUDA table and the plain
    one."""
    plain_T = plain_T or T
    code = table_codes(torch, lo, hi)
    want = torch.unique(code[live])
    runs = [K.hash_insert(lo, hi, live, T) for _ in range(2)]
    plain = K.hash_insert_plain(lo, hi, live, plain_T)
    torch.cuda.synchronize()
    sets = []
    for r, (slot, tlo, thi, occ, ovf) in enumerate(runs, 1):
        t64 = table_codes(torch, tlo, thi)
        sl = slot.to(torch.int64)
        placed = live & (sl < T)
        stored = torch.sort(t64[occ]).values
        check(bool((t64[sl[placed]] == code[placed]).all())
              and bool(occ[sl[placed]].all())
              and bool((sl[~live] == T).all()),
              f"{tag} run {r}: every placed row's slot holds its code, "
              "dead rows at T")
        check(stored.unique().numel() == stored.numel()
              and bool(torch.isin(stored, want).all()),
              f"{tag} run {r}: stored codes are distinct live codes "
              f"({stored.numel()})")
        unplaced = int((live & (sl == T)).sum())
        if expect_overflow:
            check(bool(ovf), f"{tag} run {r}: overflow flagged "
                  f"({unplaced} live rows past the cap at T)")
        else:
            check(not bool(ovf) and unplaced == 0
                  and torch.equal(stored, want),
                  f"{tag} run {r}: no overflow, every live row placed, "
                  f"stored set = the {want.numel()} live codes")
        sets.append(stored)
    if expect_overflow:
        check(bool(plain[4]), f"{tag}: the plain version overflows too")
    else:
        at = "" if plain_T == T else f" at T={plain_T}"
        check(torch.equal(sets[0], sets[1]),
              f"{tag}: stored code sets identical on two runs")
        check(not bool(plain[4]) and torch.equal(
            stored_codes(torch, *plain[1:4]), sets[0]),
              f"{tag}: stored set equals the plain version's{at}")
    return runs[0], plain


def probe_contract(torch, K, plo, phi, live, table, ptable, tag):
    """hash_probe twice on the CUDA table and its plain version once on
    the plain table: a hit's slot holds the row's code, no miss's code is
    stored, dead rows at T; both runs give the same slots, and hit/miss
    per row equals the plain pair's.  Returns the rows that disagree with
    the plain pair (0)."""
    code = table_codes(torch, plo, phi)
    slots = [K.hash_probe(plo, phi, live, *table[1:4]) for _ in range(2)]
    pslot = K.hash_probe_plain(plo, phi, live, *ptable[1:4])
    torch.cuda.synchronize()
    hits = []
    for name, tb, sl in (("cuda run 1", table, slots[0]),
                         ("cuda run 2", table, slots[1]),
                         ("plain", ptable, pslot)):
        T = tb[3].shape[0]
        t64 = table_codes(torch, tb[1], tb[2])
        sl = sl.to(torch.int64)
        hit = sl < T
        check(bool((t64[sl[hit]] == code[hit]).all())
              and bool(tb[3][sl[hit]].all())
              and not bool(torch.isin(code[~hit & live], t64[tb[3]]).any())
              and bool((sl[~live] == T).all()),
              f"{tag} {name}: every hit's slot holds the row's code, no "
              "miss's code is stored, dead rows at T")
        hits.append(hit)
    check(torch.equal(slots[0], slots[1]),
          f"{tag}: two runs give identical slots")
    disagree = int((hits[0] != hits[2]).sum())
    check(disagree == 0, f"{tag}: hit/miss identical per row with the "
          f"plain pair ({int(hits[0].sum())} hits)")
    return disagree


def check_hash(torch, K, device, n, card, T, rng):
    """hash_insert at the hash group-by's shape: the group-by's radix
    codes, 97% of rows live, and the same with the extreme codes in the
    first rows."""
    code = group_by_codes(n, card)
    lo, hi = split_lanes(torch, code, device)
    live_h = rng.random(n) < 0.97
    live = torch.from_numpy(live_h).to(device)
    tag = f"hash_insert n={n} card={card} T={T}"
    insert_contract(torch, K, lo, hi, live, T, tag)
    ext = extreme_codes(K)
    code_x = code.copy()
    code_x[: len(ext)] = ext
    live_h[: len(ext)] = True
    xlo, xhi = split_lanes(torch, code_x, device)
    insert_contract(torch, K, xlo, xhi, torch.from_numpy(live_h).to(device),
                    T, f"{tag} with 0, -1, int64 min/max, HASH_EMPTY")


def check_hash_overflow(torch, K, device):
    n, T = 1 << 16, 1 << 10
    lo = torch.arange(n, dtype=torch.int32, device=device)
    hi = torch.full((n,), 7, dtype=torch.int32, device=device)
    live = torch.ones(n, dtype=torch.bool, device=device)
    ovf = K.hash_insert(lo, hi, live, T)[4]
    povf = K.hash_insert_plain(lo, hi, live, T)[4]
    check(bool(ovf) and bool(povf),
          f"hash_insert forced overflow ({n} keys, T={T}): flagged on both")


def probe_rows(rng, keys, n, ext):
    """``n`` probe codes, about half drawn from ``keys`` and half absent
    from them, with ``ext`` in the first rows; and a live mask, 10% dead
    (the first rows live)."""
    pool = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                        n // 2 + 16, dtype=np.int64)
    absent = pool[~np.isin(pool, keys)]
    probe = np.where(rng.random(n) < 0.5,
                     keys[rng.integers(0, len(keys), n)],
                     absent[rng.integers(0, len(absent), n)])
    probe[: len(ext)] = ext
    live = rng.random(n) >= 0.1
    live[: len(ext)] = True
    return probe, live


def check_hash_edges(torch, K, device, rng):
    """The hash contract at its edges, each insert case run twice and
    probed by 2^22 rows (half hits, the extreme codes among them), against
    the plain pair: every live row on one key (an ordinary one, and the
    key equal to the table's empty word); 2^16 keys x 64 duplicates (the
    claim race); a table at load 0.7 (chains of 100+ slots, still under
    the cap); a table at load 0.9 (chains past the 256-slot cap: overflow
    must be flagged); no rows, and all rows dead."""
    ext = extreme_codes(K)
    n = 1 << 22
    I64 = np.iinfo(np.int64)

    def distinct(k):
        pool = np.unique(rng.integers(I64.min, I64.max, k + k // 8 + 64,
                                      dtype=np.int64))
        pool = pool[~np.isin(pool, ext)]
        rng.shuffle(pool)
        return np.concatenate([ext, pool[: k - len(ext)]])

    cases = [("one key", np.full(n, 12345, dtype=np.int64), 1 << 20, None,
              False),
             ("one key = HASH_EMPTY", np.full(n, K.HASH_EMPTY,
                                               dtype=np.int64), 1 << 20,
              None, False)]
    keys = distinct(1 << 16)
    cases.append(("2^16 keys x 64 duplicates",
                  rng.permutation(np.repeat(keys, 64)), 1 << 17, None,
                  False))
    keys = distinct(int(0.7 * (1 << 20)))
    cases.append(("load 0.7", rng.permutation(np.repeat(keys, 4)), 1 << 20,
                  1 << 22, False))
    keys = distinct(int(0.9 * (1 << 20)))
    cases.append(("load 0.9", rng.permutation(keys), 1 << 20, None, True))
    for name, codes, T, plain_T, overflow in cases:
        lo, hi = split_lanes(torch, codes, device)
        live = torch.ones(len(codes), dtype=torch.bool, device=device)
        tag = f"hash edge {name} (n={len(codes)}, T={T})"
        table, ptable = insert_contract(torch, K, lo, hi, live, T, tag,
                                        plain_T, overflow)
        if overflow:
            continue
        probe, plive = probe_rows(rng, np.unique(codes), n, ext)
        plo, phi = split_lanes(torch, probe, device)
        probe_contract(torch, K, plo, phi,
                       torch.from_numpy(plive).to(device), table, ptable,
                       f"hash_probe on {tag}")
    empty = torch.zeros(0, dtype=torch.int32, device=device)
    nolive = torch.zeros(0, dtype=torch.bool, device=device)
    lo, hi = split_lanes(torch, ext, device)
    plive = torch.ones(len(ext), dtype=torch.bool, device=device)
    for name, args in (("no rows", (empty, empty, nolive)),
                       ("all rows dead", (lo, hi, torch.zeros_like(plive)))):
        slot, tlo, thi, occ, ovf = K.hash_insert(*args, 64)
        got = K.hash_probe(lo, hi, plive, tlo, thi, occ)
        check(not bool(ovf) and not bool(occ.any())
              and bool((slot == 64).all()) and bool((got == 64).all()),
              f"hash edge {name}: empty table, every probe of 0, -1, "
              "int64 min/max, HASH_EMPTY misses")
    table = K.hash_insert(lo, hi, plive, 64)
    on_views = K.hash_probe(lo, hi, plive, *table[1:4])
    separate = K.hash_probe(lo, hi, plive, table[1].contiguous(),
                            table[2].contiguous(), table[3])
    check(torch.equal(on_views, separate) and bool((on_views < 64).all()),
          "hash_probe on the table's lanes as two separate contiguous "
          "arrays (packed first) equals the probe on the insert's views")


def gen_fact_dim(n_fact: int, n_dim: int, seed: int = SEED):
    """The repo's fact-dim hash-join shape (``tests/test_hash_wire.py``),
    scaled: 2 * n_dim distinct int64 keys from [0, 2^40); dim holds every
    second one with integer-valued ``w``; fact draws keys from all of
    them (about half match) with integer-valued ``v`` in [0, 10^4)."""
    rng = np.random.default_rng(seed)
    uni = np.unique(rng.integers(0, 1 << 40, 8 * n_dim,
                                 dtype=np.int64))[: 2 * n_dim]
    dim = {"k": uni[::2],
           "w": rng.integers(0, 100, n_dim).astype(np.float64)}
    fact = {"k": uni[rng.integers(0, len(uni), n_fact)],
            "v": rng.integers(0, 10 ** 4, n_fact).astype(np.float64)}
    return fact, dim


def check_probe(torch, K, device, n_build, T, n_probe, rng):
    """hash_probe against its plain version at the fact-dim join's probe
    shape: each pair (CUDA insert + CUDA probe, plain insert + plain
    probe) builds its own table of ``n_build`` distinct codes (0, -1, the
    int64 extremes and the CUDA table's empty word among them) and probes
    ``n_probe`` rows, about half hits and 10% dead.  The pairs lay tables
    out differently, so the contract is compared, not slots."""
    ext = extreme_codes(K)
    pool = np.unique(rng.integers(np.iinfo(np.int64).min,
                                  np.iinfo(np.int64).max, 3 * n_build,
                                  dtype=np.int64))
    pool = pool[~np.isin(pool, ext)]
    rng.shuffle(pool)
    build = np.concatenate([ext, pool[: n_build - len(ext)]])
    probe, live_h = probe_rows(rng, build, n_probe, ext)
    blo, bhi = split_lanes(torch, build, device)
    plo, phi = split_lanes(torch, probe, device)
    blive = torch.ones(n_build, dtype=torch.bool, device=device)
    live = torch.from_numpy(live_h).to(device)
    tag = f"hash_probe n={n_probe} build={n_build} T={T}"
    table, ptable = insert_contract(torch, K, blo, bhi, blive, T,
                                    f"{tag} build")
    return probe_contract(torch, K, plo, phi, live, table, ptable, tag)


def q3_oracle(cols):
    """pandas q3 on the host arrays: filter, merge, group, sort, top 11
    (the 11th shows the margin at the cut)."""
    import pandas as pd
    host = {t: {k: v for k, (_, v, _) in c.items()} for t, c in cols.items()}
    offsets, chars = host["customer"]["c_mktsegment"]
    word = np.frombuffer(b"BUILDING", dtype=np.uint8)
    lens = np.diff(offsets)
    starts = offsets[:-1]
    building = lens == len(word)
    for i, b in enumerate(word):
        building &= chars[np.minimum(starts + i, len(chars) - 1)] == b
    cutoff = int((np.datetime64("1995-03-15") - np.datetime64("1970-01-01"))
                 .astype(np.int64))
    c = pd.DataFrame({"o_custkey": host["customer"]["c_custkey"][building]})
    o = pd.DataFrame(host["orders"])
    o = o[o.o_orderdate < cutoff].rename(columns={"o_orderkey":
                                                  "l_orderkey"})
    li = pd.DataFrame(host["lineitem"])
    li = li[li.l_shipdate > cutoff]
    j = c.merge(o, on="o_custkey").merge(li, on="l_orderkey")
    j["rev"] = j.l_extendedprice * (1 - j.l_discount)
    g = j.groupby(["l_orderkey", "o_orderdate", "o_shippriority"],
                  as_index=False)["rev"].sum()
    top = g.sort_values(["rev", "o_orderdate"], ascending=[False, True],
                        kind="stable").head(11)
    return top, len(g)


def make_fact_dim(F, fact, dim):
    return (fact.join(dim, on="k").group_by("k")
            .agg(F.sum(F.col("v")).alias("sv"),
                 F.sum(F.col("w")).alias("sw")))


def fact_dim_oracle(fact, dim):
    hit = np.isin(fact["k"], dim["k"])
    k, inv = np.unique(fact["k"][hit], return_inverse=True)
    sv = np.bincount(inv, weights=fact["v"][hit])
    n = np.bincount(inv)
    sw = dim["w"][np.searchsorted(dim["k"], k)] * n
    return k, sv, sw


def check_hist(torch, K, device, n, parts, rng, live):
    """partition_histogram against its plain version, bit for bit, on
    ``n`` pids in [0, parts) with a ``live`` mask, through the vector
    path (aligned tensors) and the scalar path (views one row in)."""
    pids = torch.from_numpy(
        rng.integers(0, parts, n).astype(np.int32)).to(device)
    mask = live.to(device)
    tag = f"partition_histogram n={n} parts={parts}"
    err = 0
    for what, p, m in (("aligned", pids, mask),
                       ("offset", pids[1:], mask[1:])):
        got = K.partition_histogram(p, m, parts)
        want = K.partition_histogram_plain(p, m, parts)
        torch.cuda.synchronize()
        err = max(err, int((got - want).abs().max()))
        check(torch.equal(got, want) and int(got.sum()) == int(m.sum()),
              f"{tag} {what}: counts equal plain ({int(got.sum())} live)")
    return pids, mask, err


def check_hist_edges(torch, K, device, rng):
    n, parts = 1 << 20, 8
    ones = torch.ones(n, dtype=torch.bool, device=device)
    empty_i = torch.zeros(0, dtype=torch.int32, device=device)
    empty_b = torch.zeros(0, dtype=torch.bool, device=device)
    before = K.launches.snapshot()["partition_histogram"]
    got = K.partition_histogram(empty_i, empty_b, parts)
    check(got.tolist() == [0] * parts
          and K.launches.snapshot()["partition_histogram"] == before,
          "partition_histogram empty input: zeros, no launch")
    pids = torch.from_numpy(
        rng.integers(0, parts, n).astype(np.int32)).to(device)
    got = K.partition_histogram(pids, torch.zeros_like(ones), parts)
    check(got.tolist() == [0] * parts,
          "partition_histogram all rows masked: zeros")
    bad = pids.clone()
    sel = torch.from_numpy(rng.random(n) < 0.25).to(device)
    junk = torch.tensor([-1, parts, parts + 3, 1 << 30, -(1 << 31)],
                        dtype=torch.int32, device=device)
    bad[sel] = junk[torch.randint(0, 5, (int(sel.sum()),),
                                  device=device)]
    got = K.partition_histogram(bad, ones, parts)
    want = K.partition_histogram_plain(bad, ones, parts)
    check(torch.equal(got, want) and int(got.sum()) == int((~sel).sum()),
          f"partition_histogram out-of-range pids counted nowhere "
          f"({int(sel.sum())} of {n})")
    wide = 4096  # 128 KB of warp histograms: past the 48 KB default
    wp = torch.from_numpy(rng.integers(0, wide, n).astype(np.int32)).to(
        device)
    check(torch.equal(K.partition_histogram(wp, ones, wide),
                      K.partition_histogram_plain(wp, ones, wide)),
          f"partition_histogram parts={wide}: counts equal plain")
    try:
        K.partition_histogram(wp, ones, 1 << 16)
    except ValueError as exc:
        check(True, f"partition_histogram parts=65536 refused: {exc}")
    else:
        check(False, "partition_histogram parts=65536 should be refused")


def timing(shape, ms, dev, plain_ms, lib_ms, nbytes, ops, hbm):
    """One shape's numbers for the kernels line: event-timed ms, device
    ms from a profiler trace, the plain version's and the library call's
    ms, and the bound from ``nbytes`` and ``ops``."""
    bound, by = roofline(nbytes, ops, hbm)
    return {"shape": shape, "ms": ms, "device_ms": dev,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms}


def report(name, t, library, nbytes, ops=None):
    print(f"{name} {t['shape']}: kernel {t['ms']:.4f} ms (device time in "
          f"a profiler trace {dev_text(t['device_ms'], ops)}), plain "
          f"{t['plain_ms']:.4f} ms, library ({library}) "
          f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms by "
          f"{t['bound_by']} ({nbytes} B)", flush=True)


def time_hist(torch, K, timer, pids, mask, parts, hbm, label):
    n = pids.shape[0]
    ms = timer.ms(lambda: K.partition_histogram(pids, mask, parts))
    plain_ms = timer.ms(
        lambda: K.partition_histogram_plain(pids, mask, parts))
    lib_ms = timer.ms(lambda: torch.bincount(
        torch.where(mask, pids, parts), minlength=parts + 1)[:parts])
    dev, ops = timer.device_ms(
        lambda: K.partition_histogram(pids, mask, parts), ("ph_kernel",))
    # a pid and a mask byte in per row, the counts out; a compare and an
    # add per row
    nbytes = 5 * n + 4 * parts
    t = timing(f"{label} n={n} parts={parts}", ms, dev, plain_ms, lib_ms,
               nbytes, 2 * n, hbm)
    report("partition_histogram", t, "bincount", nbytes, ops)
    return t


def time_insert(torch, K, timer, lo, hi, live, T, hbm, label):
    """hash_insert at one shape; the library call is ``torch.unique`` of
    the live codes with the inverse (a group id per row)."""
    n = lo.shape[0]
    ms = timer.ms(lambda: K.hash_insert(lo, hi, live, T))
    plain_ms = timer.ms(lambda: K.hash_insert_plain(lo, hi, live, T))
    codes = table_codes(torch, lo, hi)[live]
    lib_ms = timer.ms(lambda: torch.unique(codes, return_inverse=True))
    dev, ops = timer.device_ms(lambda: K.hash_insert(lo, hi, live, T),
                               ("hi_", "Memset"))
    # rows: lo, hi, live in, slot out; table: lanes and occupied out
    nbytes = 13 * n + 9 * T + 1
    # fmix32's 11 integer operations and a 2-lane compare per row
    t = timing(f"{label} n={n} T={T}", ms, dev, plain_ms, lib_ms, nbytes,
               13 * n, hbm)
    report("hash_insert", t, "torch.unique", nbytes, ops)
    return t


def time_probe(torch, K, timer, blo, bhi, plo, phi, T, hbm, label):
    """hash_probe at one shape: the probe lanes, every row live, against
    the table of the build lanes at T slots; the library call is a binary
    search over the sorted build codes plus an equality check (membership
    and position up to layout)."""
    n = plo.shape[0]
    plive = torch.ones(n, dtype=torch.bool, device=plo.device)
    blive = torch.ones(blo.shape[0], dtype=torch.bool, device=blo.device)
    table = K.hash_insert(blo, bhi, blive, T)
    ptable = K.hash_insert_plain(blo, bhi, blive, T)
    code = table_codes(torch, plo, phi)
    stored = torch.sort(table_codes(torch, blo, bhi)).values
    ms = timer.ms(lambda: K.hash_probe(plo, phi, plive, *table[1:4]))
    plain_ms = timer.ms(
        lambda: K.hash_probe_plain(plo, phi, plive, *ptable[1:4]))

    def lookup():
        pos = torch.searchsorted(stored, code).clamp(max=len(stored) - 1)
        return torch.where(plive & (stored[pos] == code), pos, T)
    lib_ms = timer.ms(lookup)
    dev, ops = timer.device_ms(
        lambda: K.hash_probe(plo, phi, plive, *table[1:4]), ("hp_",))
    # what the kernel needs of these inputs: every row's live byte, lo and
    # hi in, its slot out; the table's occupied bytes, and the lanes of
    # its occupied slots only
    nbytes = 13 * n + T + 8 * int(table[3].sum())
    # fmix32's 11 integer operations and a 2-lane compare per row
    t = timing(f"{label} n={n} T={T}", ms, dev, plain_ms, lib_ms, nbytes,
               13 * n, hbm)
    report("hash_probe", t, "searchsorted", nbytes, ops)
    return t


def sector_floor(vals, valids, m):
    """Bytes of the 32-byte sectors the kernel must read (every sector of
    the mask, each validity sector holding a row the mask passes, each
    value sector holding a row that passes both), plus the outputs,
    counted exactly on the host."""
    def sectors(t, rows, width):
        """32 B times the sectors that hold the sorted ``rows``."""
        s = (t.data_ptr() % 32 + rows * width) // 32
        return 32 * (int(np.count_nonzero(s[1:] != s[:-1])) + (len(s) > 0))
    mh = m.cpu().numpy()
    n = len(mh)
    # the mask's bytes are contiguous: every sector from first to last
    nbytes = 32 * ((m.data_ptr() % 32 + n - 1) // 32 + 1) + 12 * len(vals)
    masked = np.flatnonzero(mh)
    for v, ok in zip(vals, valids):
        live = masked
        if ok is not None:
            nbytes += sectors(ok, masked, 1)
            live = masked[ok.cpu().numpy()[masked]]
        nbytes += sectors(v, live, 8)
    return nbytes


def time_mmr(torch, K, timer, vals, valids, m, hbm, label):
    """masked_multi_reduce of the columns ``vals`` under ``m``; the
    library call is ``torch.where`` + ``sum`` and the live rows' ``sum``
    per column.  The sector floor is printed on a line of its own."""
    n = m.shape[0]
    args = (vals, valids, m)
    ms = timer.ms(lambda: K.masked_multi_reduce(*args))
    plain_ms = timer.ms(lambda: K.masked_multi_reduce_plain(*args))

    def library():
        out = []
        for v, ok in zip(vals, valids):
            live = m if ok is None else m & ok
            out.append((torch.where(live, v, 0.0).sum(), live.sum()))
        return out
    lib_ms = timer.ms(library)
    dev, ops = timer.device_ms(lambda: K.masked_multi_reduce(*args),
                               ("mmr_",))
    selected = sum(int(c.sum()) for _, c in library())
    masked = int(m.sum())
    # every mask byte, a validity byte only where the mask passes, the
    # values of the rows that count, the outputs; a mask test per row, an
    # add and a count per row that counts
    nbytes = n + masked * sum(ok is not None for ok in valids) \
        + 8 * selected + 12 * len(vals)
    t = timing(f"{label} n={n} cols={len(vals)} ({selected} rows pass)",
               ms, dev, plain_ms, lib_ms, nbytes, n + 2 * selected, hbm)
    report("masked_multi_reduce", t, "where + sum", nbytes, ops)
    floor = sector_floor(vals, valids, m)
    print(f"masked_multi_reduce {t['shape']}: sector floor "
          f"{floor / hbm * 1e3:.6f} ms ({floor} B of 32-byte sectors)",
          flush=True)
    return t


def hbm_rate(name: str) -> float:
    """The card's device-memory rate in bytes/s, for the bound."""
    return next((v for k, v in HBM_BYTES_PER_S.items() if k in name),
                3.35e12)


class PathLaunches:
    """Kernel launches of the main path's runs: per kernel, in total and
    by the shape of the call."""

    def __init__(self, names):
        self.counts = {k: 0 for k in names}
        self.shapes = {k: {} for k in names}

    def add(self, launches):
        for k in self.counts:
            self.counts[k] += launches[k]
            for shape, c in launches["by_shape"][k].items():
                self.shapes[k][shape] = self.shapes[k].get(shape, 0) + c


def exchanged_rows(stats) -> int:
    """Rows the planner's stage statistics say the exchanges move."""
    total = 0
    for _, st in stats:
        for key in ("partition_counts", "probe_counts", "build_counts"):
            if key in st:
                total += int(np.asarray(st[key]).sum())
    return total


def check_dist(session, label, launches, metrics, want_hist=True):
    """The sharded phase's own checks: it ran distributed, launched the
    histogram kernel where the phase runs it, and its exchanges moved
    exactly the rows the stage statistics counted."""
    check(session.last_dist_explain == "distributed",
          f"{label}: ran distributed ({session.last_dist_explain!r})")
    if want_hist:
        check(launches["partition_histogram"] >= 1,
              f"{label}: launched partition_histogram "
              f"{launches['partition_histogram']}x")
    moved = metrics["shuffle"]["rowsMoved"]
    counted = exchanged_rows(session.last_dist_stats)
    check(moved == counted,
          f"{label}: rows exchanged {moved} == sum(partition counts) "
          f"{counted} ({metrics['shuffle']['exchanges']} exchanges, "
          f"{metrics['host_syncs']} host syncs)")


def make_sort(F, df):
    return df.orderBy("k")


def make_topn(F, df):
    return df.orderBy(F.col("v").desc()).limit(10)


# ------------------------------------------------------------- main path --

def q6_oracle(d):
    m = ((d["l_shipdate"] >= 9131) & (d["l_shipdate"] < 9496)
         & (d["l_discount"] >= 0.05) & (d["l_discount"] <= 0.07)
         & (d["l_quantity"] < 24.0))
    return float((d["l_extendedprice"][m] * d["l_discount"][m]).sum())


def q1_oracle(d):
    m = d["l_shipdate"] <= 10471
    g = (d["l_returnflag_code"] * 2 + d["l_linestatus_code"])[m]

    def s(x):
        return np.bincount(g, weights=x[m], minlength=6)
    n = np.bincount(g, minlength=6)
    disc = d["l_extendedprice"] * (1.0 - d["l_discount"])
    return {"sum_qty": s(d["l_quantity"]), "sum_base": s(d["l_extendedprice"]),
            "sum_disc": s(disc), "avg_disc": s(d["l_discount"]) / n, "n": n}


def make_q6(F, df):
    return df.filter(
        (F.col("l_shipdate") >= 9131) & (F.col("l_shipdate") < 9496) &
        (F.col("l_discount") >= 0.05) & (F.col("l_discount") <= 0.07) &
        (F.col("l_quantity") < 24.0)
    ).select((F.col("l_extendedprice") * F.col("l_discount"))
             .alias("rev")).agg(F.sum("rev").alias("revenue"))


def make_q1(F, df):
    return (df.filter(F.col("l_shipdate") <= 10471)
            .groupBy("l_returnflag_code", "l_linestatus_code")
            .agg(F.sum("l_quantity").alias("sum_qty"),
                 F.sum("l_extendedprice").alias("sum_base"),
                 F.sum((F.col("l_extendedprice") *
                        (F.lit(1.0) - F.col("l_discount")))
                       .alias("d")).alias("sum_disc"),
                 F.avg("l_discount").alias("avg_disc"),
                 F.count("l_quantity").alias("n")))


def make_hash_agg(F, df):
    return df.groupBy("k").agg(F.sum("v").alias("s"),
                               F.count("v").alias("n"))


def drive(torch, K, fm, query, rows, card_line, label, reps=3,
          extra=None):
    """Reset the launch counts, run the query once through the engine
    (its counts are the main path's), then time ``reps`` more runs.
    ``extra``: more metric objects (reset, snapshot) read like ``fm``;
    ``fm`` then returns their snapshots in a dict beside its own."""
    K.launches.reset()
    fm.reset()
    for m in (extra or {}).values():
        m.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = query.to_pandas()
    first_s = time.perf_counter() - t0
    launches = dict(K.launches.snapshot(),
                    by_shape=K.launches.shape_snapshot())
    fusion = fm.snapshot()
    if extra:
        fusion = dict(fusion, **{k: m.snapshot() for k, m in extra.items()})
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        query.to_pandas()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    print(f"rows/s {label}: {rows / wall:.6e} (median of {reps} runs, "
          f"{wall * 1e3:.3f} ms; first run {first_s * 1e3:.3f} ms; "
          f"{rows} rows) on {card_line}", flush=True)
    return result, launches, fusion, rows / wall


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the "
              "card", file=sys.stderr)
        return 1
    if not (ROOT / "spark_rapids_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: spark_rapids_tpu_torch/ is not beside this "
              "script; run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.session import TpuSession
    from spark_rapids_tpu_torch.exec.fusion import fusion_metrics as fm
    from spark_rapids_tpu_torch.ops import kernels as K

    device = torch.device(DEVICE)
    # 1. the card and the build
    card_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card_line, flush=True)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {name}, capability "
          f"{torch.cuda.get_device_capability(0)}, deterministic algorithms "
          f"{torch.are_deterministic_algorithms_enabled()}", flush=True)
    t0 = time.perf_counter()
    K.library()
    print(f"kernel build {K.build_seconds():.3f} s (load incl. "
          f"{time.perf_counter() - t0:.3f} s) -> {K._LIBRARY.path}",
          flush=True)
    hbm = hbm_rate(name)
    print(f"bound uses {hbm / 1e12:.2f} TB/s device memory for {name}",
          flush=True)
    print("masked_multi_reduce resident blocks an SM (256 threads each) "
          "for 1, up to 4, up to 8 columns: "
          + ", ".join(str(K.library().srt_mmr_blocks_per_sm(c))
                      for c in (1, 4, 8)), flush=True)
    timer = Timer(torch, device)
    rng = np.random.default_rng(SEED)

    # 2. each kernel against its plain version
    for ncols in (1, 3):
        base = mmr_dense(torch, device, ncols)
        for case in ("mixed", "nan", "all_masked"):
            check_mmr(torch, K, *mmr_case(torch, base, case),
                      f"n={MMR_CHECK_ROWS} cols={ncols} {case}")
        if ncols == 3:
            mmr_dense_t = time_mmr(torch, K, timer, *base, hbm, "dense")
        del base
    mmr_err = check_mmr_edges(torch, K, device, rng)
    data = gen_host(Q6_ROWS)
    # q6's batch on one device, and a shard's whole input over 8 shards
    mmr_times = []
    for n, label in ((BATCH_ROWS, "q6 batch"),
                     (Q6_ROWS // NSHARDS, "sharded q6 shard")):
        v0, m0 = q6_batch(torch, device, data, n)
        mmr_err = max(mmr_err, check_mmr(torch, K, [v0], [None], m0,
                                         f"{label} n={n}"))
        mmr_times.append(time_mmr(torch, K, timer, [v0], [None], m0, hbm,
                                  label))
        del v0, m0
    mmr_times.append(mmr_dense_t)

    check_hash(torch, K, device, HASH_ROWS, HASH_CARD, HASH_SLOTS, rng)
    check_hash_overflow(torch, K, device)
    check_hash_edges(torch, K, device, rng)
    # hash_probe against its plain version at the join's probe shape
    probe_err = check_probe(torch, K, device, DIM_ROWS, JOIN_SLOTS,
                            BATCH_ROWS, rng)
    # the main path's shapes: the group-by's update stage (every row
    # live, no filter), the join build (the 2^19 dim keys into a 2^20-slot
    # table) and one 2^22-row probe batch against that table
    lo, hi = split_lanes(torch, group_by_codes(), device)
    live = torch.ones(HASH_ROWS, dtype=torch.bool, device=device)
    insert_times = [time_insert(torch, K, timer, lo, hi, live, HASH_SLOTS,
                                hbm, "hash group-by")]
    (blo, bhi), (plo, phi) = join_lanes(torch, device)
    blive = torch.ones(DIM_ROWS, dtype=torch.bool, device=device)
    insert_times.append(time_insert(torch, K, timer, blo, bhi, blive,
                                    JOIN_SLOTS, hbm, "join build"))
    probe = time_probe(torch, K, timer, blo, bhi, plo, phi, JOIN_SLOTS, hbm,
                       "fact-dim probe batch")
    del lo, hi, live, blo, bhi, blive, plo, phi

    # partition_histogram at the sharded path's two stats shapes: the
    # fact side's per-shard pass (every row live, 8 parts) and an
    # aggregate's bucket pass (the partial's live groups, 32 buckets)
    fact_live = torch.ones(HIST_FACT_ROWS, dtype=torch.bool)
    hp, hm, hist_err = check_hist(torch, K, device, HIST_FACT_ROWS, NSHARDS,
                                  rng, fact_live)
    bucket_live = torch.arange(HIST_BUCKET_ROWS) < (HIST_BUCKET_ROWS * 3 // 4)
    bp, bm, err = check_hist(torch, K, device, HIST_BUCKET_ROWS,
                             4 * NSHARDS, rng, bucket_live)
    hist_err = max(hist_err, err)
    check_hist_edges(torch, K, device, rng)
    hist_times = [time_hist(torch, K, timer, hp, hm, NSHARDS, hbm,
                            "fact stats"),
                  time_hist(torch, K, timer, bp, bm, 4 * NSHARDS, hbm,
                            "bucket stats")]
    del hp, hm, bp, bm

    # 3. the main path through TpuSession on CUDA
    from spark_rapids_tpu_torch.parallel.shuffle import shuffle_metrics
    from spark_rapids_tpu_torch.utils.hostsync import host_sync_metrics
    dist_metrics = {"shuffle": shuffle_metrics,
                    "host_syncs": host_sync_metrics}
    dist_conf = {"spark.rapids.sql.distributed.numShards": NSHARDS}
    total = PathLaunches(K.launches.NAMES)
    s = TpuSession({})
    check(s.device == device, f"session on {s.device}")
    df = s.create_dataframe(data)
    got6, l6, _, r6 = drive(torch, K, fm, make_q6(F, df), Q6_ROWS,
                            card_line, "q6")
    want6 = q6_oracle(data)
    rev = float(got6["revenue"][0])
    check(abs(rev - want6) <= QUERY_RTOL * abs(want6),
          f"q6 revenue {rev!r} within rel {QUERY_RTOL} of numpy {want6!r}")
    check(l6["masked_multi_reduce"] >= 1,
          f"q6 launched masked_multi_reduce {l6['masked_multi_reduce']}x")
    got1, l1, _, r1 = drive(torch, K, fm, make_q1(F, df), Q6_ROWS,
                            card_line, "q1 shape")
    want1 = q1_oracle(data)
    got1 = got1.sort_values(["l_returnflag_code", "l_linestatus_code"],
                            ignore_index=True)
    keys = (got1["l_returnflag_code"] * 2 + got1["l_linestatus_code"])
    check(keys.tolist() == list(range(6)), "q1 groups exact (6 keys)")
    check(got1["n"].tolist() == want1["n"].tolist(), "q1 counts exact")
    for c in ("sum_qty", "sum_base", "sum_disc", "avg_disc"):
        check(np.allclose(got1[c].to_numpy(), want1[c], rtol=QUERY_RTOL,
                          atol=0), f"q1 {c} within rel {QUERY_RTOL}")
    total.add(l6)
    total.add(l1)
    s.stop()
    del df
    single_rate = {"q6": r6, "q1 shape": r1}

    # the same two queries over 8 logical shards
    s = TpuSession(dist_conf)
    df = s.create_dataframe(data)
    got6, l6, m6, d6 = drive(torch, K, fm, make_q6(F, df), Q6_ROWS,
                             card_line, "distributed q6", extra=dist_metrics)
    rev = float(got6["revenue"][0])
    check(abs(rev - want6) <= QUERY_RTOL * abs(want6),
          f"distributed q6 revenue {rev!r} within rel {QUERY_RTOL} of "
          f"numpy {want6!r}")
    check_dist(s, "distributed q6", l6, m6, want_hist=False)
    check(l6["masked_multi_reduce"] >= NSHARDS + 1,
          f"distributed q6 launched masked_multi_reduce "
          f"{l6['masked_multi_reduce']}x (per shard and the merge)")
    got1, l1, m1, d1 = drive(torch, K, fm, make_q1(F, df), Q6_ROWS,
                             card_line, "distributed q1 shape",
                             extra=dist_metrics)
    got1 = got1.sort_values(["l_returnflag_code", "l_linestatus_code"],
                            ignore_index=True)
    keys = (got1["l_returnflag_code"] * 2 + got1["l_linestatus_code"])
    check(keys.tolist() == list(range(6)),
          "distributed q1 groups exact (6 keys)")
    check(got1["n"].tolist() == want1["n"].tolist(),
          "distributed q1 counts exact")
    for c in ("sum_qty", "sum_base", "sum_disc", "avg_disc"):
        check(np.allclose(got1[c].to_numpy(), want1[c], rtol=QUERY_RTOL,
                          atol=0), f"distributed q1 {c} within rel "
              f"{QUERY_RTOL}")
    check_dist(s, "distributed q1 shape", l1, m1)
    st = dict(s.last_dist_stats)["aggregate"]
    check(st["bucket_counts"].shape == (NSHARDS, 4 * NSHARDS)
          and int(st["bucket_counts"].sum()) == 6 * NSHARDS,
          f"distributed q1: {4 * NSHARDS} buckets, 6 groups per shard")
    for label, rate in (("q6", d6), ("q1 shape", d1)):
        print(f"rows/s {label}: distributed over {NSHARDS} shards "
              f"{rate:.6e}, single device {single_rate[label]:.6e}",
              flush=True)
    total.add(l6)
    total.add(l1)
    s.stop()
    del df, data

    sparse = gen_sparse(HASH_ROWS, HASH_CARD)
    uk, inv = np.unique(sparse["k"], return_inverse=True)
    want_s = np.bincount(inv, weights=sparse["v"])
    want_n = np.bincount(inv)
    results, rate_hash = {}, {}
    for enabled in (False, True):
        s = TpuSession({"spark.rapids.tpu.pallas.hash.enabled": enabled,
                        "spark.rapids.tpu.pallas.hash.tableSlots":
                            str(HASH_SLOTS)})
        q = make_hash_agg(F, s.create_dataframe(sparse))
        label = f"hash group-by ({'hash on' if enabled else 'hash off'})"
        got, lh, fus, rate_hash[enabled] = drive(
            torch, K, fm, q, HASH_ROWS, card_line, label)
        got = got.sort_values("k", ignore_index=True)
        results[enabled] = got
        check(np.array_equal(got["k"].to_numpy(), uk)
              and np.array_equal(got["s"].to_numpy(), want_s)
              and np.array_equal(got["n"].to_numpy(), want_n),
              f"{label}: {len(got)} groups equal numpy exactly")
        if enabled:
            check(fus["hashKernelLaunches"] >= 1
                  and fus["hashOverflowFallbacks"] == 0,
                  f"{label}: hashKernelLaunches "
                  f"{fus['hashKernelLaunches']}, hashOverflowFallbacks "
                  f"{fus['hashOverflowFallbacks']}")
            check(lh["hash_insert"] >= 1,
                  f"{label}: launched hash_insert {lh['hash_insert']}x")
            total.add(lh)
        else:
            check(lh["hash_insert"] == 0, f"{label}: no hash_insert launch")
        s.stop()
    check(results[False].equals(results[True]),
          "hash group-by identical with hash on and off")

    # the sparse group-by over 8 logical shards: every partial group
    # crosses the exchange
    s = TpuSession(dist_conf)
    sdf = s.create_dataframe(sparse)
    got, ls, ms_, ds = drive(torch, K, fm, make_hash_agg(F, sdf), HASH_ROWS,
                             card_line, "distributed sparse group-by",
                             extra=dist_metrics)
    got = got.sort_values("k", ignore_index=True)
    check(np.array_equal(got["k"].to_numpy(), uk)
          and np.array_equal(got["s"].to_numpy(), want_s)
          and np.array_equal(got["n"].to_numpy(), want_n),
          f"distributed sparse group-by: {len(got)} groups equal numpy "
          "exactly")
    check_dist(s, "distributed sparse group-by", ls, ms_)
    print(f"rows/s sparse group-by: distributed over {NSHARDS} shards "
          f"{ds:.6e}, single device {rate_hash[False]:.6e} (hash off), "
          f"{rate_hash[True]:.6e} (hash on)", flush=True)
    total.add(ls)

    # orderBy and TopN of the same table: the range sort
    order = np.argsort(sparse["k"], kind="stable")
    top = np.argsort(-sparse["v"], kind="stable")[:10]
    single = TpuSession({})
    one = single.create_dataframe(sparse)
    _, _, _, r_sort = drive(torch, K, fm, make_sort(F, one), HASH_ROWS,
                            card_line, "sort (single device)", reps=1)
    _, _, _, r_top = drive(torch, K, fm, make_topn(F, one), HASH_ROWS,
                           card_line, "TopN 10 (single device)", reps=1)
    single.stop()
    del one
    got, lo, mo, d_sort = drive(torch, K, fm, make_sort(F, sdf), HASH_ROWS,
                                card_line, "distributed sort",
                                extra=dist_metrics)
    check(np.array_equal(got["k"].to_numpy(), sparse["k"][order])
          and np.array_equal(got["v"].to_numpy(), sparse["v"][order]),
          f"distributed orderBy(k): {len(got)} rows equal np.sort "
          "(stable)")
    check_dist(s, "distributed sort", lo, mo)
    total.add(lo)
    got, lt, mt, d_top = drive(torch, K, fm, make_topn(F, sdf), HASH_ROWS,
                               card_line, "distributed TopN 10",
                               extra=dist_metrics)
    check(np.array_equal(got["k"].to_numpy(), sparse["k"][top])
          and np.array_equal(got["v"].to_numpy(), sparse["v"][top]),
          "distributed TopN 10 by v desc equals numpy (stable)")
    check(s.last_dist_explain == "distributed",
          f"distributed TopN 10: ran distributed "
          f"({s.last_dist_explain!r})")
    print(f"rows/s sort: distributed over {NSHARDS} shards {d_sort:.6e}, "
          f"single device {r_sort:.6e}; TopN 10: distributed "
          f"{d_top:.6e}, single device {r_top:.6e}", flush=True)
    s.stop()
    del sdf, sparse

    # TPC-H q3 at SF10: customer 1.5M, orders 15M, lineitem 60M rows
    from spark_rapids_tpu_torch.interop import batch_from_arrays
    from spark_rapids_tpu_torch.models import tpch
    t0 = time.perf_counter()
    q3_cols = tpch.gen_q3_columns(Q3_SF)
    q3_rows = sum(len(next(iter(c.values()))[1]) for c in q3_cols.values())
    want3, n_groups3 = q3_oracle(q3_cols)
    print(f"q3 SF{Q3_SF}: {q3_rows} input rows, {n_groups3} groups; data "
          f"and pandas oracle {time.perf_counter() - t0:.3f} s", flush=True)
    rev = want3["rev"].to_numpy()
    if abs(rev[9] - rev[10]) > QUERY_RTOL * abs(rev[9]):
        print(f"q3 oracle: 10th and 11th revenues {float(rev[9])!r} and "
              f"{float(rev[10])!r} differ by more than rel {QUERY_RTOL}",
              flush=True)
    else:
        print(f"q3 oracle: 10th and 11th revenues {float(rev[9])!r} and "
              f"{float(rev[10])!r} are within rel {QUERY_RTOL}: the cut at "
              "10 is not decided by the tolerance", flush=True)
    want3 = want3.head(10)
    q3_out = {}
    for enabled in (False, True):
        s = TpuSession({"spark.rapids.sql.tpu.maxBatchRows": BATCH_ROWS,
                        "spark.rapids.tpu.pallas.hash.enabled": enabled,
                        "spark.rapids.tpu.pallas.hash.tableSlots":
                            str(HASH_SLOTS)})
        tables = {name: s.create_dataframe(batch_from_arrays(c, s.device))
                  for name, c in q3_cols.items()}
        label = f"q3 SF{Q3_SF} ({'hash on' if enabled else 'hash off'})"
        got, l3, fus, _ = drive(torch, K, fm, tpch.q3(tables), q3_rows,
                                card_line, label)
        q3_out[enabled] = got
        days = [d.toordinal() - 719163 for d in got["o_orderdate"]]
        check(got["l_orderkey"].tolist() == want3["l_orderkey"].tolist()
              and days == want3["o_orderdate"].tolist()
              and got["o_shippriority"].tolist()
              == want3["o_shippriority"].tolist(),
              f"{label}: top-10 keys and order equal pandas")
        check(np.allclose(got["revenue"].to_numpy(), want3["rev"].to_numpy(),
                          rtol=QUERY_RTOL, atol=0),
              f"{label}: revenue within rel {QUERY_RTOL} of pandas")
        print(f"{label}: {n_groups3} groups, hashKernelLaunches "
              f"{fus['hashKernelLaunches']}, launches {l3}", flush=True)
        if enabled:
            check(fus["hashKernelLaunches"] >= 1
                  and fus["hashOverflowFallbacks"] == 0
                  and l3["hash_insert"] >= 1,
                  f"{label}: the group-by took the hash table "
                  f"(hash_insert {l3['hash_insert']}x), no overflow")
            total.add(l3)
        else:
            check(l3["hash_insert"] == 0 and l3["hash_probe"] == 0,
                  f"{label}: no hash kernel launch")
        s.stop()
        del tables
    a, b = q3_out[False], q3_out[True]
    check(a.drop(columns="revenue").equals(b.drop(columns="revenue"))
          and np.allclose(a["revenue"], b["revenue"], rtol=PATH_RTOL,
                          atol=0),
          f"q3 identical with hash on and off (revenue within rel "
          f"{PATH_RTOL})")
    del q3_cols

    # fact-dim hash join: 2^26 fact rows, 2^19 dim rows, 16 probe batches
    fact, dim = gen_fact_dim(FACT_ROWS, DIM_ROWS)
    want_k, want_sv, want_sw = fact_dim_oracle(fact, dim)
    fd_out, rate_fd = {}, {}
    for enabled in (False, True):
        s = TpuSession({"spark.rapids.sql.tpu.maxBatchRows": BATCH_ROWS,
                        "spark.rapids.tpu.pallas.hash.enabled": enabled,
                        "spark.rapids.tpu.pallas.hash.tableSlots":
                            str(HASH_SLOTS)})
        q = make_fact_dim(F, s.create_dataframe(fact),
                          s.create_dataframe(dim))
        label = f"fact-dim join ({'hash on' if enabled else 'hash off'})"
        got, lf, fus, rate_fd[enabled] = drive(
            torch, K, fm, q, FACT_ROWS + DIM_ROWS, card_line, label)
        fd_out[enabled] = got
        check(np.array_equal(got["k"].to_numpy(), want_k)
              and np.array_equal(got["sv"].to_numpy(), want_sv)
              and np.array_equal(got["sw"].to_numpy(), want_sw),
              f"{label}: {len(got)} groups equal numpy exactly")
        batches = FACT_ROWS // BATCH_ROWS
        if enabled:
            check(lf["hash_probe"] == batches
                  and lf["hash_insert"] >= batches
                  and fus["hashOverflowFallbacks"] == 0,
                  f"{label}: hash_probe {lf['hash_probe']}x (one per probe "
                  f"batch), hash_insert {lf['hash_insert']}x, "
                  f"hashKernelLaunches {fus['hashKernelLaunches']}, "
                  f"hashOverflowFallbacks {fus['hashOverflowFallbacks']}")
            total.add(lf)
        else:
            check(lf["hash_insert"] == 0 and lf["hash_probe"] == 0,
                  f"{label}: no hash kernel launch")
        s.stop()
    check(fd_out[False].equals(fd_out[True]),
          "fact-dim join identical with hash on and off")

    # the same join over 8 logical shards: 2^19 build rows are past the
    # broadcast threshold, so both sides shuffle by key hash, then the
    # group-by exchanges its partials
    s = TpuSession(dist_conf)
    q = make_fact_dim(F, s.create_dataframe(fact), s.create_dataframe(dim))
    got, lf, mf, d_fd = drive(torch, K, fm, q, FACT_ROWS + DIM_ROWS,
                              card_line, "distributed fact-dim join",
                              extra=dist_metrics)
    got = got.sort_values("k", ignore_index=True)
    check(np.array_equal(got["k"].to_numpy(), want_k)
          and np.array_equal(got["sv"].to_numpy(), want_sv)
          and np.array_equal(got["sw"].to_numpy(), want_sw),
          f"distributed fact-dim join: {len(got)} groups equal numpy "
          "exactly")
    check_dist(s, "distributed fact-dim join", lf, mf)
    jst = dict(s.last_dist_stats)["join:inner"]
    check(jst["strategy"] == "shuffle"
          and int(jst["probe_counts"].sum()) == FACT_ROWS
          and int(jst["build_counts"].sum()) == DIM_ROWS,
          f"distributed fact-dim join: shuffle strategy, stats histograms "
          f"count {FACT_ROWS} probe and {DIM_ROWS} build rows")
    print(f"rows/s fact-dim join: distributed over {NSHARDS} shards "
          f"{d_fd:.6e}, single device {rate_fd[False]:.6e} (hash off), "
          f"{rate_fd[True]:.6e} (hash on)", flush=True)
    total.add(lf)
    s.stop()
    del fact, dim, q

    # one real process group: NCCL with one rank, against one logical
    # shard on the same data
    import os
    import tempfile
    import torch.distributed as dist
    pg_data = gen_host(PG_ROWS, seed=SEED + 1)
    s = TpuSession({"spark.rapids.sql.distributed.numShards": 1})
    want_pg = make_q1(F, s.create_dataframe(pg_data)).to_pandas()
    want_pg_stats = dict(s.last_dist_stats)["aggregate"]
    s.stop()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            s = TpuSession({}, process_group=dist.group.WORLD)
            label = "q1 shape over a one-rank NCCL group"
            got, lp, mp_, _ = drive(
                torch, K, fm, make_q1(F, s.create_dataframe(pg_data)),
                PG_ROWS, card_line, label, extra=dist_metrics)
            check_dist(s, label, lp, mp_)
            pst = dict(s.last_dist_stats)["aggregate"]
        finally:
            dist.destroy_process_group()
    check(all(np.array_equal(pst[k], want_pg_stats[k])
              for k in ("bucket_counts", "bucket_map", "partition_counts")),
          f"{label}: stage statistics equal one logical shard's")
    check(got.drop(columns=["sum_qty", "sum_base", "sum_disc", "avg_disc"])
          .equals(want_pg.drop(columns=["sum_qty", "sum_base", "sum_disc",
                                        "avg_disc"]))
          and all(np.allclose(got[c], want_pg[c], rtol=PATH_RTOL, atol=0)
                  for c in ("sum_qty", "sum_base", "sum_disc", "avg_disc")),
          f"{label}: answer equals one logical shard's (float sums within "
          f"rel {PATH_RTOL})")
    want_o = q1_oracle(pg_data)
    got = got.sort_values(["l_returnflag_code", "l_linestatus_code"],
                          ignore_index=True)
    check(got["n"].tolist() == want_o["n"].tolist()
          and np.allclose(got["sum_disc"].to_numpy(), want_o["sum_disc"],
                          rtol=QUERY_RTOL, atol=0),
          f"{label}: counts exact and sums within rel {QUERY_RTOL} of numpy")
    total.add(lp)
    del pg_data
    check(all(v >= 1 for v in total.counts.values()),
          f"every kernel ran on the main path: {total.counts}")

    # 4. the kernels line, 5. the result line
    def entry(name, replaces, err, times):
        """The first shape's numbers at the top level (the keys every
        kernel carries), the other shapes' under ``other_shapes``, and
        the main path's launches in total and by shape."""
        first = times[0]
        e = {"name": name, "route": "cuda",
             "source": f"spark_rapids_tpu_torch/csrc/{name}.cu",
             "replaces": f"spark_rapids_tpu/ops/pallas_kernels.py:{replaces}",
             "launches": total.counts[name], "max_abs_err": float(err),
             **first,
             "launches_by_shape": total.shapes[name]}
        if len(times) > 1:
            e["other_shapes"] = times[1:]
        return e

    kernels = [
        entry("masked_multi_reduce", 210, mmr_err, mmr_times),
        entry("hash_insert", 456, 0.0, insert_times),
        entry("hash_probe", 532, probe_err, [probe]),
        entry("partition_histogram", 122, hist_err, hist_times),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as exc:
        print(f"FAIL {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
