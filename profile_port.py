#!/usr/bin/env python3
"""Where the time goes in the port's join paths, on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 profile_port.py

It builds the same inputs as ``chip_smoke.py`` (TPC-H q3 at SF10 and the
fact-dim join at 2^26 x 2^19), warms each query once, then traces one run
per query with ``torch.profiler`` (hash path on and off, and the fact-dim
join once more over 8 logical shards as a shuffle join), and TPC-H q6
and the q1 shape over 2^26 rows (``bench.py``'s ``gen_host`` columns) on
one device and over 8 logical shards, and prints, per run: the host wall
time, the device's busy time (the union of the intervals in which any
CUDA kernel or copy ran) and its idle share of the wall time, the counted
host syncs, the device ops that took the most device time, and the device
time of each hand-written kernel and of all memsets (the hash insert
clears its table with one; PyTorch issues others), with its share of the
busy time.  It checks nothing; ``chip_smoke.py`` holds the answers
against their oracles.  Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import sys
import time

import chip_smoke as cs

TOP = 10
# name prefixes of the kernels under spark_rapids_tpu_torch/csrc
HAND_WRITTEN = ("mmr_", "hi_", "hp_", "ph_")


def busy_ms(events) -> float:
    """Union of the device intervals of ``events`` (kernels, copies and
    sets on the card), in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3  # profiler times are in us


def profile(torch, query, label, card_line):
    from torch.profiler import ProfilerActivity, profile as tprofile
    from spark_rapids_tpu_torch.utils.hostsync import host_sync_metrics
    query.to_pandas()  # warm
    torch.cuda.synchronize()
    host_sync_metrics.reset()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        query.to_pandas()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    syncs = host_sync_metrics.snapshot()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_ms(device)
    print(f"{label}: wall {wall:.3f} ms, device busy {busy:.3f} ms, idle "
          f"share {1 - busy / wall:.4f}, {len(device)} device ops, "
          f"{syncs} host syncs on {card_line}", flush=True)
    by_name = {}
    for e in device:
        t = by_name.setdefault(e.name, [0.0, 0])
        t[0] += (e.time_range.end - e.time_range.start) / 1e3
        t[1] += 1
    for name, (ms, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:TOP]:
        print(f"  {ms:10.3f} ms {n:6d}x  {name[:110]}", flush=True)
    mine = {}
    for name, (ms, n) in by_name.items():
        # a template kernel's name starts with its return type
        short = name.removeprefix("void ").split("(")[0]
        if short.startswith(HAND_WRITTEN + ("Memset",)):
            t = mine.setdefault(short.strip(), [0.0, 0])
            t[0] += ms
            t[1] += n
    if mine:
        print("  hand-written kernels, and all memsets (PyTorch's too): "
              + ", ".join(f"{name} {ms:.3f} ms ({n}x, {ms / busy:.4f} of "
                          "busy)" for name, (ms, n) in sorted(mine.items())),
              flush=True)


def main() -> int:
    import subprocess
    import torch
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 1
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.session import TpuSession
    from spark_rapids_tpu_torch.interop import batch_from_arrays
    from spark_rapids_tpu_torch.models import tpch
    card_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card_line, flush=True)

    def session(enabled):
        return TpuSession({
            "spark.rapids.sql.tpu.maxBatchRows": cs.BATCH_ROWS,
            "spark.rapids.tpu.pallas.hash.enabled": enabled,
            "spark.rapids.tpu.pallas.hash.tableSlots": str(cs.HASH_SLOTS)})

    cols = tpch.gen_q3_columns(cs.Q3_SF)
    for enabled in (False, True):
        s = session(enabled)
        t = {name: s.create_dataframe(batch_from_arrays(c, s.device))
             for name, c in cols.items()}
        profile(torch, tpch.q3(t), f"q3 SF{cs.Q3_SF} hash "
                f"{'on' if enabled else 'off'}", card_line)
        s.stop()
        del t
    del cols
    fact, dim = cs.gen_fact_dim(cs.FACT_ROWS, cs.DIM_ROWS)
    for enabled in (False, True):
        s = session(enabled)
        q = cs.make_fact_dim(F, s.create_dataframe(fact),
                             s.create_dataframe(dim))
        profile(torch, q, f"fact-dim join hash "
                f"{'on' if enabled else 'off'}", card_line)
        s.stop()
    sharded = {"spark.rapids.sql.distributed.numShards": cs.NSHARDS}
    s = TpuSession(sharded)
    q = cs.make_fact_dim(F, s.create_dataframe(fact),
                         s.create_dataframe(dim))
    profile(torch, q, f"fact-dim join over {cs.NSHARDS} shards (shuffle)",
            card_line)
    if s.last_dist_explain != "distributed":
        print(f"profile_port: the sharded run fell back: "
              f"{s.last_dist_explain}", file=sys.stderr)
        return 1
    s.stop()
    del fact, dim, q
    data = cs.gen_host(cs.Q6_ROWS)
    for make, name in ((cs.make_q6, "q6"), (cs.make_q1, "q1 shape")):
        for conf, where in (({}, "one device"),
                            (sharded, f"over {cs.NSHARDS} shards")):
            s = TpuSession(conf)
            profile(torch, make(F, s.create_dataframe(data)),
                    f"{name}, {where}", card_line)
            s.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
