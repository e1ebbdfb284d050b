#!/usr/bin/env python3
"""Where the time goes in the port's join paths, on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 profile_port.py [tpch] [join] [q6] [tpcds]

(no argument runs every section).  It builds the same inputs as
``chip_smoke.py`` (the TPC-H tables at SF10, the fact-dim join at 2^26 x
2^19 and the TPC-DS tables at the tpcds phase's scale), warms each
query once, then traces
one run per query with ``torch.profiler`` (q3 with the hash path on and
off, TPC-H q1 (a string-keyed group-by) and q9 (a five-way join) with it
on, the fact-dim join hash on and off and once more over 8 logical shards
as a shuffle join), and TPC-H q6
and the q1 shape over 2^26 rows (``bench.py``'s ``gen_host`` columns) on
one device and over 8 logical shards, and TPC-DS q67 (rollup over eight
keys, four of them strings, then a window) and q47 (a windowed average
and ``lag``/``lead`` over two specs) through ``session.sql`` with the
hash path on, and prints, per run: the host wall
time, the device's busy time (the union of the intervals in which any
CUDA kernel or copy ran) and its idle share of the wall time, the counted
host syncs, the host time of the string dictionary (fetching string
columns, encoding and decoding on the host; apart from that, its
card-side calls) and its share of the wall, the device ops
that took the most device time, and the device
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


class DictTime:
    """Host time of the string dictionary (``ops/dictionary.py``): its
    fetches of string columns and its host encoders and decoder, and
    apart from those the calls of its card-side encoder, decoder and sort
    keys (their host wall, waits for the card at their counted fetches
    included), timed by wrapping the module's functions and the
    dictionary's methods (the engine calls them through those)."""

    FETCH = ("host_strings",)
    ENCODE = ("dict_encode_stable", "ordered_dict_encode", "rank_encode",
              "decode")
    CARD = ("string_sort_keys",)
    CARD_METHODS = ("_encode_device", "_decode_device")

    def __init__(self):
        self.reset()
        self._wrapped = False

    def reset(self):
        self.calls, self.fetch_ms, self.encode_ms = 0, 0.0, 0.0
        self.card_calls, self.card_ms = 0, 0.0

    def snapshot(self):
        return {"calls": self.calls, "fetch_ms": self.fetch_ms,
                "encode_ms": self.encode_ms, "card_calls": self.card_calls,
                "card_ms": self.card_ms}

    def wrap(self):
        if self._wrapped:
            return
        from spark_rapids_tpu_torch.ops import dictionary
        for name in self.FETCH + self.ENCODE:
            setattr(dictionary, name,
                    self._timed(getattr(dictionary, name),
                                "fetch_ms" if name in self.FETCH
                                else "encode_ms", "calls"))
        for name in self.CARD:
            setattr(dictionary, name, self._timed(
                getattr(dictionary, name), "card_ms", "card_calls"))
        for name in self.CARD_METHODS:
            setattr(dictionary.StableDictionary, name, self._timed(
                getattr(dictionary.StableDictionary, name), "card_ms",
                "card_calls"))
        self._wrapped = True

    def _timed(self, fn, field, count):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                setattr(self, count, getattr(self, count) + 1)
                setattr(self, field, getattr(self, field)
                        + (time.perf_counter() - t0) * 1e3)
        return run


dict_time = DictTime()


def profile(torch, query, label, card_line):
    """``query``: a DataFrame, or a function that builds one (a SQL
    statement, built anew in the traced run: its scalar subqueries run
    there)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    from spark_rapids_tpu_torch.utils.hostsync import host_sync_metrics

    def run():
        return (query() if callable(query) else query).to_pandas()
    run()  # warm
    torch.cuda.synchronize()
    host_sync_metrics.reset()
    dict_time.reset()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    syncs = host_sync_metrics.snapshot()
    encode = dict_time.snapshot()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_ms(device)
    print(f"{label}: wall {wall:.3f} ms, device busy {busy:.3f} ms, idle "
          f"share {1 - busy / wall:.4f}, {len(device)} device ops, "
          f"{syncs} host syncs on {card_line}", flush=True)
    if encode["calls"]:
        print(f"  host dictionary: {encode['calls']} calls, fetch "
              f"{encode['fetch_ms']:.3f} ms (waits for the card included), "
              f"encode and decode {encode['encode_ms']:.3f} ms; "
              f"{(encode['fetch_ms'] + encode['encode_ms']) / wall:.4f} of "
              "the wall", flush=True)
    if encode["card_calls"]:
        print(f"  string dictionary on the card: {encode['card_calls']} "
              f"calls, {encode['card_ms']:.3f} ms of host wall (its waits "
              f"for the card included); {encode['card_ms'] / wall:.4f} of "
              "the wall", flush=True)
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
    dict_time.wrap()
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.session import TpuSession
    from spark_rapids_tpu_torch.models import tpch
    card_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card_line, flush=True)
    sections = set(sys.argv[1:]) or {"tpch", "join", "q6", "tpcds"}

    def session(enabled):
        return TpuSession({
            "spark.rapids.sql.tpu.maxBatchRows": cs.BATCH_ROWS,
            "spark.rapids.tpu.pallas.hash.enabled": enabled,
            "spark.rapids.tpu.pallas.hash.tableSlots": str(cs.HASH_SLOTS)})

    if "tpch" in sections:
        profile_tpch(torch, tpch, session, card_line)
    if "join" in sections and profile_joins(torch, F, TpuSession, session,
                                            card_line):
        return 1
    if "q6" in sections:
        profile_q6(torch, F, TpuSession, card_line)
    if "tpcds" in sections:
        profile_tpcds(torch, session, card_line)
    return 0


def profile_tpch(torch, tpch, session, card_line):
    batches = cs.device_tables(tpch.gen_table_columns(cs.TPCH_SF),
                               torch.device(cs.DEVICE))
    for enabled in (False, True):
        s = session(enabled)
        t = {name: s.create_dataframe(b) for name, b in batches.items()}
        profile(torch, tpch.q3(t), f"q3 SF{cs.TPCH_SF} hash "
                f"{'on' if enabled else 'off'}", card_line)
        if enabled:
            for name in ("q1", "q9"):
                profile(torch, tpch.QUERIES[name](t),
                        f"TPC-H {name} SF{cs.TPCH_SF} hash on", card_line)
        s.stop()
        del t
    del batches


def profile_joins(torch, F, TpuSession, session, card_line) -> bool:
    """The fact-dim join hash off and on, and as a shuffle join over 8
    shards; True when the sharded run fell back."""
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
        return True
    s.stop()
    return False


def profile_q6(torch, F, TpuSession, card_line):
    sharded = {"spark.rapids.sql.distributed.numShards": cs.NSHARDS}
    data = cs.gen_host(cs.Q6_ROWS)
    for make, name in ((cs.make_q6, "q6"), (cs.make_q1, "q1 shape")):
        for conf, where in (({}, "one device"),
                            (sharded, f"over {cs.NSHARDS} shards")):
            s = TpuSession(conf)
            profile(torch, make(F, s.create_dataframe(data)),
                    f"{name}, {where}", card_line)
            s.stop()


def profile_tpcds(torch, session, card_line):
    from spark_rapids_tpu_torch.models import tpcds
    t0 = time.perf_counter()
    batches = cs.tpcds_device_tables(tpcds.gen_tables(sf=cs.TPCDS_SF),
                                     torch.device(cs.DEVICE))
    print(f"TPC-DS SF{cs.TPCDS_SF} generated and on the card in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    s = cs.tpcds_session(cs.tpch_conf(True), batches)
    for name in ("q67", "q47"):
        profile(torch, lambda name=name: s.sql(tpcds.QUERIES[name]),
                f"TPC-DS {name} SF{cs.TPCDS_SF} hash on", card_line)
    s.stop()


if __name__ == "__main__":
    sys.exit(main())
