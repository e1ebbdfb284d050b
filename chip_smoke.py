#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA engine on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``spark_rapids_tpu_torch/csrc``
for sm_90a, holds each kernel against its plain PyTorch version on the
card, then drives the engine's main path through ``TpuSession`` on CUDA:
TPC-H q6 and the q1-shaped group-by over 2^26 lineitem rows (the columns
``bench.py``'s ``gen_host`` makes), and the sparse-key hash group-by
(2^22 rows, 2^20 keys drawn from [0, 2^40)) with the hash path on and off.
Answers are checked against float64 numpy oracles on the same host data.

Output, in order: the card's name and power limit, the torch/CUDA versions
and kernel build time, one line per check, rows/s per query, a
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": {...}}``.
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

KERNEL_RTOL = 1e-12   # kernel vs plain float sums (another summation order)
QUERY_RTOL = 1e-9     # engine vs numpy oracle (bench.py's own q6 check)

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


def stored_codes(torch, tlo, thi, occ):
    t64 = (thi.to(torch.int64) << 32) | (tlo.to(torch.int64) & 0xFFFFFFFF)
    return torch.sort(t64[occ]).values


def check_hash(torch, K, device, n, card, T, rng):
    data = gen_sparse(n, card)
    code = data["k"] - data["k"].min() + 1   # the group-by's radix code
    lo_h = (code & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    hi_h = (code >> 32).astype(np.int32)
    lo = torch.from_numpy(lo_h).to(device)
    hi = torch.from_numpy(hi_h).to(device)
    live = torch.from_numpy(rng.random(n) < 0.97).to(device)
    slot, tlo, thi, occ, ovf = K.hash_insert(lo, hi, live, T)
    pslot, ptlo, pthi, pocc, povf = K.hash_insert_plain(lo, hi, live, T)
    torch.cuda.synchronize()
    tag = f"hash_insert n={n} card={card} T={T}"
    check(not bool(ovf) and not bool(povf), f"{tag}: no overflow on both")
    a = stored_codes(torch, tlo, thi, occ)
    b = stored_codes(torch, ptlo, pthi, pocc)
    code_t = (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & 0xFFFFFFFF)
    want = torch.unique(code_t[live])
    check(a.numel() == b.numel() == want.numel()
          and bool((a == b).all()) and bool((a == want).all()),
          f"{tag}: stored code sets equal ({a.numel()} codes)")
    t64 = (thi.to(torch.int64) << 32) | (tlo.to(torch.int64) & 0xFFFFFFFF)
    sl = slot.to(torch.int64)
    check(bool((sl[live] < T).all())
          and bool((t64[sl[live]] == code_t[live]).all())
          and bool(occ[sl[live]].all()),
          f"{tag}: every live row's slot holds its code")
    check(bool((sl[~live] == T).all()), f"{tag}: dead rows at T")
    return lo, hi, live, code_t


def check_hash_overflow(torch, K, device):
    n, T = 1 << 16, 1 << 10
    lo = torch.arange(n, dtype=torch.int32, device=device)
    hi = torch.full((n,), 7, dtype=torch.int32, device=device)
    live = torch.ones(n, dtype=torch.bool, device=device)
    ovf = K.hash_insert(lo, hi, live, T)[4]
    povf = K.hash_insert_plain(lo, hi, live, T)[4]
    check(bool(ovf) and bool(povf),
          f"hash_insert forced overflow ({n} keys, T={T}): flagged on both")


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


def drive(torch, K, fm, query, rows, card_line, label, reps=3):
    """Reset the launch counts, run the query once through the engine
    (its counts are the main path's), then time ``reps`` more runs."""
    K.launches.reset()
    fm.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = query.to_pandas()
    first_s = time.perf_counter() - t0
    launches = K.launches.snapshot()
    fusion = fm.snapshot()
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
    hbm = next(v for k, v in HBM_BYTES_PER_S.items() if k in name) \
        if any(k in name for k in HBM_BYTES_PER_S) else 3.35e12
    print(f"bound uses {hbm / 1e12:.2f} TB/s device memory for {name}",
          flush=True)
    timer = Timer(torch, device)
    rng = np.random.default_rng(SEED)

    # 2. each kernel against its plain version
    for ncols in (1, 3):
        base = mmr_inputs(torch, device, MMR_CHECK_ROWS, ncols, rng)
        for case in ("mixed", "nan", "all_masked"):
            check_mmr(torch, K, *mmr_case(torch, base, case),
                      f"n={MMR_CHECK_ROWS} cols={ncols} {case}")
        t = timer.ms(lambda: K.masked_multi_reduce(*base), reps=5)
        # mask and validity bytes, plus the values of the rows that count
        needed = int(K.masked_multi_reduce_plain(*base)[1].sum())
        b = MMR_CHECK_ROWS * ncols + 8 * needed + 12 * ncols
        # a mask test per row, an add and a count per row that counts
        bms, bby = roofline(b, MMR_CHECK_ROWS + 2 * needed, hbm)
        print(f"masked_multi_reduce n={MMR_CHECK_ROWS} cols={ncols}: "
              f"kernel {t:.4f} ms, bound {bms:.4f} ms by {bby} ({b} B)",
              flush=True)
        del base
    # q6's first batch as the main path hands it to the kernel: the
    # fused filter's mask and rev = price * discount, maxBatchRows rows
    data = gen_host(Q6_ROWS)
    n6 = 1 << 22
    first = {k: torch.from_numpy(v[:n6]).to(device) for k, v in data.items()}
    m0 = ((first["l_shipdate"] >= 9131) & (first["l_shipdate"] < 9496)
          & (first["l_discount"] >= 0.05) & (first["l_discount"] <= 0.07)
          & (first["l_quantity"] < 24.0))
    v0 = first["l_extendedprice"] * first["l_discount"]
    del first
    mmr_err = check_mmr(torch, K, [v0], [None], m0, f"q6 batch n={n6}")
    mmr_ms = timer.ms(lambda: K.masked_multi_reduce([v0], [None], m0))
    mmr_plain_ms = timer.ms(
        lambda: K.masked_multi_reduce_plain([v0], [None], m0))
    mmr_lib_ms = timer.ms(lambda: (torch.where(m0, v0, 0.0).sum(),
                                   m0.sum()))
    selected = int(m0.sum())
    mmr_bytes = n6 + 8 * selected + 8 + 4   # mask, needed values, outputs
    mmr_bound, mmr_by = roofline(mmr_bytes, n6 + 2 * selected, hbm)
    print(f"masked_multi_reduce q6 batch n={n6} ({selected} rows pass): "
          f"kernel {mmr_ms:.4f} ms, plain {mmr_plain_ms:.4f} ms, library "
          f"{mmr_lib_ms:.4f} ms, bound {mmr_bound:.4f} ms by {mmr_by} "
          f"({mmr_bytes} B)", flush=True)
    del v0, m0

    lo, hi, live, code_t = check_hash(torch, K, device, HASH_ROWS,
                                      HASH_CARD, HASH_SLOTS, rng)
    check_hash_overflow(torch, K, device)
    # the main path's update stage: every row live (no filter)
    live = torch.ones_like(live)
    hash_ms = timer.ms(lambda: K.hash_insert(lo, hi, live, HASH_SLOTS))
    hash_plain_ms = timer.ms(
        lambda: K.hash_insert_plain(lo, hi, live, HASH_SLOTS))
    live_codes = code_t
    hash_lib_ms = timer.ms(
        lambda: torch.unique(live_codes, return_inverse=True))
    # rows: lo, hi, live in, slot out; table: lanes and occupied out
    hash_bytes = 13 * HASH_ROWS + 9 * HASH_SLOTS + 1
    # fmix32's 11 integer operations and a 2-lane compare per live row
    hash_bound, hash_by = roofline(hash_bytes, 13 * HASH_ROWS, hbm)
    print(f"hash_insert n={HASH_ROWS} T={HASH_SLOTS}: kernel {hash_ms:.4f} "
          f"ms, plain {hash_plain_ms:.4f} ms, library (torch.unique) "
          f"{hash_lib_ms:.4f} ms, bound {hash_bound:.4f} ms by {hash_by} "
          f"({hash_bytes} B)", flush=True)
    del lo, hi, live, code_t, live_codes

    # 3. the main path through TpuSession on CUDA
    total = {k: 0 for k in K.launches.NAMES}
    s = TpuSession({})
    check(s.device == device, f"session on {s.device}")
    df = s.create_dataframe(data)
    got6, l6, _, _ = drive(torch, K, fm, make_q6(F, df), Q6_ROWS,
                           card_line, "q6")
    want6 = q6_oracle(data)
    rev = float(got6["revenue"][0])
    check(abs(rev - want6) <= QUERY_RTOL * abs(want6),
          f"q6 revenue {rev!r} within rel {QUERY_RTOL} of numpy {want6!r}")
    check(l6["masked_multi_reduce"] >= 1,
          f"q6 launched masked_multi_reduce {l6['masked_multi_reduce']}x")
    got1, l1, _, _ = drive(torch, K, fm, make_q1(F, df), Q6_ROWS,
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
    for k in total:
        total[k] += l6[k] + l1[k]
    s.stop()
    del df, data

    sparse = gen_sparse(HASH_ROWS, HASH_CARD)
    uk, inv = np.unique(sparse["k"], return_inverse=True)
    want_s = np.bincount(inv, weights=sparse["v"])
    want_n = np.bincount(inv)
    results = {}
    for enabled in (False, True):
        s = TpuSession({"spark.rapids.tpu.pallas.hash.enabled": enabled,
                        "spark.rapids.tpu.pallas.hash.tableSlots":
                            str(HASH_SLOTS)})
        q = make_hash_agg(F, s.create_dataframe(sparse))
        label = f"hash group-by ({'hash on' if enabled else 'hash off'})"
        got, lh, fus, _ = drive(torch, K, fm, q, HASH_ROWS, card_line,
                                label)
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
            for k in total:
                total[k] += lh[k]
        else:
            check(lh["hash_insert"] == 0, f"{label}: no hash_insert launch")
        s.stop()
    check(results[False].equals(results[True]),
          "hash group-by identical with hash on and off")
    check(all(v >= 1 for v in total.values()),
          f"every kernel ran on the main path: {total}")

    # 4. the kernels line, 5. the result line
    kernels = [
        {"name": "masked_multi_reduce", "route": "cuda",
         "source": "spark_rapids_tpu_torch/csrc/masked_multi_reduce.cu",
         "replaces": "spark_rapids_tpu/ops/pallas_kernels.py:210",
         "launches": total["masked_multi_reduce"], "max_abs_err": mmr_err,
         "ms": mmr_ms, "plain_ms": mmr_plain_ms, "bound_ms": mmr_bound,
         "bound_by": mmr_by, "library_ms": mmr_lib_ms},
        {"name": "hash_insert", "route": "cuda",
         "source": "spark_rapids_tpu_torch/csrc/hash_insert.cu",
         "replaces": "spark_rapids_tpu/ops/pallas_kernels.py:456",
         "launches": total["hash_insert"], "max_abs_err": 0.0,
         "ms": hash_ms, "plain_ms": hash_plain_ms, "bound_ms": hash_bound,
         "bound_by": hash_by, "library_ms": hash_lib_ms},
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
