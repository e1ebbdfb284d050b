#!/usr/bin/env python3
"""Where the time goes in the port's join paths, on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 profile_port.py [tpch] [join] [q6] [tpcds] [files] [sharded_tpch]
                            [memory] [fallback] [tpcds_decimal]
                            [strings_dates] [nested] [udf] [serving]
                            [reuse]

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
hash path on, and TPC-H q1 and q6 over SF10 lineitem written as 16
parquet files, pipeline on and off, and (``sharded_tpch``, only when asked
for) TPC-H q1 and q9 at SF10 on one device and over 8 logical shards, and
(``memory``, only when asked for) the memory phase's out-of-core sort of
SF10 lineitem at default memory and under the 256 MiB spill budget (its
batches consumed on the card, not collected) and TPC-H q18 under that
budget, with the host time the spill catalog spent copying to the host,
checksumming, encoding frames, writing and reading disk and restoring,
and (``fallback``, only when asked for) ``chip_smoke.py``'s fallback
phase over the SF10 tables against their 22 answers, then one trace each
of TPC-H q10 with its Sort in the CPU fallback, q14 with its LIKE-holding
aggregate there and the official q13 join there, with the fallback
nodes' host time in pandas and in each transfer, and
(``tpcds_decimal``, only when asked for) TPC-DS q67 and q47 over the
tpcds phase's tables with ``decimal(7,2)`` money columns (q67's rollup
Aggregate in the CPU fallback), then q67 timed once under each setting of
that aggregate's host work (one worker thread or ``_HOST_THREADS``, the
distinct-groups sample's skip off or on), and (``strings_dates``, only
when asked for) ``chip_smoke.py``'s strings_dates phase over the SF10
tables (its checks included), then one trace each of SD3 (regexes,
``replace`` and ``locate`` over 15M ``o_comment`` rows) and SD4 (chained
string producers over the 8M-row part-partsupp join), and (``nested``,
only when asked for) ``chip_smoke.py``'s nested phase over the SF10
tables (its checks included), then one trace each of ND1 (collect_list
and collect_set per order over 60M lines, and the collection functions
over the 15M arrays) and ND5 (a map per line, read back and summed),
and (``udf``, only when asked for) ``chip_smoke.py``'s udf phase over
the SF10 tables (its checks included), then UD3 (``models/udf.py``: the
black-box ``phone_cc`` over all of SF10 customer, grouped by it) through
``chip_smoke.UDF_WORKERS`` pool workers and UD8's q1-form group-by reading
its cached slice of lineitem, each traced after a warm run, with the
Python execs' host time fetching the arguments, in Python and uploading
the results, and the cache's bytes and host time, and (``serving``, only
when asked for) ``chip_smoke.py``'s serving phase over the SF10 tables
(its checks included), then one device-only trace of SV1's three
concurrent TPC-H streams with each stream's wall and admission wait,
and (``reuse``, only when asked for) ``chip_smoke.py``'s reuse phase
over the SF10 tables (its checks included), then one trace of sharded
TPC-H q9 clean and one of its resume from stage checkpoints after an
injected OOM, and the 22 sharded TPC-H queries with the default-on
checkpoint log on and off in one run, and prints, per run: the host wall
time, the device's busy time (the union of the intervals in which any
CUDA kernel or copy ran) and its idle share of the wall time, the counted
host syncs, the host time of the string dictionary (fetching string
columns, encoding and decoding on the host; apart from that, its
card-side calls) and its share of the wall, the device time of the
host-to-device copies, the device ops
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
              "decode", "ordered_dict_table")
    CARD = ("string_sort_keys", "encode_sorted")
    CARD_METHODS = ("_encode_device", "_decode_device", "sorted")
    # the sharded path's dictionaries (SortedDictionary)
    SORTED_METHODS = ("bounds", "decode", "positions_in")

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
        for cls, names in ((dictionary.StableDictionary, self.CARD_METHODS),
                           (dictionary.SortedDictionary,
                            self.SORTED_METHODS)):
            for name in names:
                setattr(cls, name, self._timed(getattr(cls, name),
                                               "card_ms", "card_calls"))
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


SPILL_TIMES = ("spill_to_host_ns", "checksum_ns", "serialize_ns",
               "disk_write_ns", "disk_read_ns", "restore_ns")


def profile(torch, query, label, card_line, run=None, catalog=None,
            host_ops=True):
    """``query``: a DataFrame, or a function that builds one (a SQL
    statement, built anew in the traced run: its scalar subqueries run
    there); ``run`` replaces the collect (``to_pandas``); with
    ``catalog``, the spill
    catalog's host times of the traced run are printed too.
    ``host_ops=False`` traces the device only (a long run's host ops
    would swamp the profiler)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    from spark_rapids_tpu_torch.utils.hostsync import host_sync_metrics

    if run is None:
        def run():
            return (query() if callable(query) else query).to_pandas()
    run()  # warm
    torch.cuda.synchronize()
    host_sync_metrics.reset()
    dict_time.reset()
    spill0 = catalog.stats() if catalog is not None else None
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.insert(0, ProfilerActivity.CPU)
    with tprofile(activities=activities) as prof:
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
    if catalog is not None:
        st = catalog.stats()
        print("  spill catalog (host thread ms): " + ", ".join(
            f"{k[:-3]} {(st[k] - spill0[k]) / 1e6:.3f}"
            for k in SPILL_TIMES) + "; bytes to the host "
            f"{st['spilled_to_host_total'] - spill0['spilled_to_host_total']}"
            f" (copied {st['host_copy_bytes_total'] - spill0['host_copy_bytes_total']}),"
            f" to disk {st['spilled_to_disk_total'] - spill0['spilled_to_disk_total']}"
            f" (frames {st['disk_file_bytes_total'] - spill0['disk_file_bytes_total']})",
            flush=True)
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
    h2d = [e for e in device if "HtoD" in e.name]
    if h2d:
        print(f"  host-to-device copies: {len(h2d)}, "
              f"{busy_ms(h2d):.3f} ms of device time", flush=True)
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
    sections = set(sys.argv[1:]) or {"tpch", "join", "q6", "tpcds",
                                     "files"}

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
    if "files" in sections:
        profile_files(torch, TpuSession, tpch, card_line)
    if "memory" in sys.argv[1:]:
        profile_memory(torch, F, TpuSession, tpch, card_line)
    if "fallback" in sys.argv[1:]:
        profile_fallback(torch, F, TpuSession, tpch, card_line)
    if "tpcds_decimal" in sys.argv[1:]:
        profile_tpcds_decimal(torch, card_line)
    if "strings_dates" in sys.argv[1:]:
        profile_strings_dates(torch, TpuSession, tpch, card_line)
    if "nested" in sys.argv[1:]:
        profile_nested(torch, tpch, card_line)
    if "udf" in sys.argv[1:]:
        profile_udf(torch, tpch, card_line)
    if "serving" in sys.argv[1:]:
        profile_serving(torch, tpch, card_line)
    if "reuse" in sys.argv[1:]:
        profile_reuse(torch, tpch, card_line)
    if "sharded_tpch" in sys.argv[1:]:
        return profile_sharded(torch, TpuSession, tpch, card_line)
    return 0


def profile_reuse(torch, tpch, card_line):
    """``chip_smoke.py``'s reuse phase (its checks included) over the
    SF10 tables, then one trace of RU3's sharded resume: TPC-H q9 over
    ``chip_smoke.NSHARDS`` logical shards with a device OOM injected as
    its third stage's frame is saved, so the spill rung's re-attempt
    splices the first two stages; then :func:`checkpoint_control`."""
    import tempfile
    from spark_rapids_tpu_torch.api.session import TpuSession
    from spark_rapids_tpu_torch.exec.fusion import fusion_metrics as fm
    from spark_rapids_tpu_torch.ops import kernels as K
    from spark_rapids_tpu_torch.robustness import inject as I
    from spark_rapids_tpu_torch.robustness.checkpoint import (
        checkpoint_metrics)
    from spark_rapids_tpu_torch.robustness.driver import recovery_metrics
    t0 = time.perf_counter()
    cols = tpch.gen_table_columns(cs.TPCH_SF)
    batches = cs.device_tables(cols, torch.device(cs.DEVICE))
    del cols
    print(f"TPC-H SF{cs.TPCH_SF} generated and on the card in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    K.library()
    s = TpuSession(cs.tpch_conf(True))
    t = {k: s.create_dataframe(b) for k, b in batches.items()}
    answers = {n: tpch.QUERIES[n](t).to_pandas()
               for n in cs.REUSE_EXACT + ("q9",)}
    s.stop()
    total = cs.PathLaunches(K.launches.NAMES)
    secs = cs.run_reuse(torch, K, fm, tpch, batches, answers, card_line,
                        total, tempfile.mkdtemp(prefix="profile_reuse_"))
    print(f"reuse phase {secs:.3f} s (budget {cs.REUSE_BUDGET_S} s); "
          f"launches {total.counts}", flush=True)
    s = TpuSession(cs.sharded_conf(cs.tpch_conf(True)))
    q = tpch.QUERIES[cs.RU3_QUERY](
        {k: s.create_dataframe(b) for k, b in batches.items()})
    profile(torch, q, f"RU3 sharded {cs.RU3_QUERY} SF{cs.TPCH_SF} clean "
            f"over {cs.NSHARDS} shards", card_line)

    def resume():
        rule = I.inject("checkpoint.write", count=1,
                        skip=cs.RU3_FAULT_SKIP, exc=torch.OutOfMemoryError)
        try:
            q.to_pandas()
        finally:
            I.remove(rule)
    before = checkpoint_metrics.snapshot()
    profile(torch, q, f"RU3 sharded {cs.RU3_QUERY} SF{cs.TPCH_SF}, an OOM "
            "at its third stage's save, resumed", card_line, run=resume,
            catalog=s.memory_catalog)
    after = checkpoint_metrics.snapshot()
    print("  checkpoint counters over the warm and the traced run: "
          + str({k: after[k] - before[k] for k in after}), flush=True)
    s.stop()
    recovery_metrics.reset()
    checkpoint_control(torch, tpch, batches, card_line)


def checkpoint_control(torch, tpch, batches, card_line):
    """The default-on lineage log's cost in one run: the 22 TPC-H
    DataFrame queries over ``chip_smoke.NSHARDS`` logical shards with
    ``recovery.checkpoint.enabled`` on and off, one warm pass and then
    passes in the order on, off, off, on; each pass's wall (the card
    synchronized at both ends) and the log's writes and bytes."""
    from spark_rapids_tpu_torch.api.session import TpuSession
    from spark_rapids_tpu_torch.robustness.checkpoint import (
        checkpoint_metrics)
    key = "spark.rapids.sql.recovery.checkpoint.enabled"
    sessions = {on: TpuSession(dict(cs.sharded_conf(cs.tpch_conf(True)),
                                    **{key: on}))
                for on in (True, False)}
    tables = {on: {k: s.create_dataframe(b) for k, b in batches.items()}
              for on, s in sessions.items()}

    def one_pass(on):
        m0 = checkpoint_metrics.snapshot()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for query in tpch.QUERIES.values():
            query(tables[on]).to_pandas()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        m1 = checkpoint_metrics.snapshot()
        return wall, {k: m1[k] - m0[k] for k in ("writes", "bytesWritten")}
    one_pass(True)
    walls = {True: [], False: []}
    for on in (True, False, False, True):
        wall, d = one_pass(on)
        walls[on].append(wall)
        print(f"checkpoint control, log {'on' if on else 'off'}: "
              f"{len(tpch.QUERIES)} sharded TPC-H queries SF{cs.TPCH_SF} "
              f"in {wall:.3f} s, {d['writes']} writes, "
              f"{d['bytesWritten']} bytes on {card_line}", flush=True)
    print(f"checkpoint control: on {sum(walls[True]):.3f} s, off "
          f"{sum(walls[False]):.3f} s over two passes each, ratio "
          f"{sum(walls[True]) / sum(walls[False]):.4f} on {card_line}",
          flush=True)
    for s in sessions.values():
        s.stop()


def profile_strings_dates(torch, TpuSession, tpch, card_line):
    """``chip_smoke.py``'s strings_dates phase (its checks included) over
    the SF10 tables, then traces of SD3 and SD4."""
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.exec.fusion import fusion_metrics as fm
    from spark_rapids_tpu_torch.models import strings_dates as SD
    from spark_rapids_tpu_torch.ops import kernels as K
    cpu = cs.start_process(cs.strings_dates_cpu_answers, cs.SD_CHECK_SF)
    t0 = time.perf_counter()
    batches = cs.device_tables(tpch.gen_table_columns(cs.TPCH_SF),
                               torch.device(cs.DEVICE))
    print(f"TPC-H SF{cs.TPCH_SF} on the card in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    import tempfile
    K.library()
    total = cs.PathLaunches(K.launches.NAMES)
    with tempfile.TemporaryDirectory(prefix="profile_port_") as tmp:
        refs = cs.start_function_pass(batches, tmp)
        secs = cs.run_strings_dates(torch, K, fm, SD, batches, card_line,
                                    total, cpu, refs)
    print(f"strings_dates phase {secs:.3f} s; launches {total.counts}",
          flush=True)
    for name in ("sd3", "sd4"):
        s = cs.sd_session(batches, True, SD.FALLBACK_NODES[name])
        profile(torch, lambda s=s, name=name: SD.run(F, s, name),
                f"{name.upper()} SF{cs.TPCH_SF}, hash on", card_line)
        s.stop()


def profile_nested(torch, tpch, card_line):
    """``chip_smoke.py``'s nested phase (its checks included) over the
    SF10 tables, then traces of ND1 and ND5, each collected to arrow."""
    import tempfile
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.exec.fusion import fusion_metrics as fm
    from spark_rapids_tpu_torch.models import nested as ND
    from spark_rapids_tpu_torch.ops import kernels as K
    cpu = cs.start_process(cs.nested_cpu_answers, cs.ND_CHECK_SF)
    t0 = time.perf_counter()
    cols = tpch.gen_table_columns(cs.TPCH_SF)
    oracle = cs.nested_oracle(ND, cols)
    batches = cs.device_tables(cols, torch.device(cs.DEVICE))
    del cols
    print(f"TPC-H SF{cs.TPCH_SF} generated and on the card in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    K.library()
    total = cs.PathLaunches(K.launches.NAMES)
    with tempfile.TemporaryDirectory(prefix="profile_port_") as tmp:
        secs = cs.run_nested(torch, K, fm, ND, batches, card_line, total,
                             oracle, cpu, tmp)
    print(f"nested phase {secs:.3f} s; launches {total.counts}",
          flush=True)
    for name in ("nd1", "nd5"):
        s = cs.nested_session(batches, name)
        profile(torch, None, f"{name.upper()} SF{cs.TPCH_SF}, hash on",
                card_line, run=lambda s=s, name=name: ND.build(
                    F, s, name).to_arrow())
        s.stop()


def profile_udf(torch, tpch, card_line):
    """``chip_smoke.py``'s udf phase (its checks included) over the SF10
    tables, then UD3 through the worker pool and UD8's cached read, each
    traced after a warm run, with the Python execs' host ms per metric
    (argument fetch, Python, result upload) of the traced run and the
    cache's bytes."""
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.exec.fusion import fusion_metrics as fm
    from spark_rapids_tpu_torch.models import udf as UD
    from spark_rapids_tpu_torch.ops import kernels as K
    from spark_rapids_tpu_torch.udf import worker_pool as WP
    cpu = cs.start_process(cs.udf_cpu_answers, cs.UDF_CHECK_SF)
    t0 = time.perf_counter()
    cols = tpch.gen_table_columns(cs.TPCH_SF)
    host = UD.host_columns({t: cols[t] for t in
                            ("lineitem", "orders", "customer", "supplier")})
    refs = cs.OnThread(lambda: UD.references(host))
    batches = cs.device_tables(cols, torch.device(cs.DEVICE))
    del cols, host
    print(f"TPC-H SF{cs.TPCH_SF} generated and on the card in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    K.library()
    s = cs.udf_session(batches)
    q6 = tpch.q6({"lineitem": s.table("lineitem")}).to_pandas()
    s.stop()
    total = cs.PathLaunches(K.launches.NAMES)
    secs = cs.run_udf(torch, K, fm, UD, batches, card_line, total,
                      lambda: (refs.result(), refs.seconds), cpu,
                      q6["revenue"][0])
    print(f"udf phase {secs:.3f} s; launches {total.counts}", flush=True)
    s = cs.udf_session(batches, workers=cs.UDF_WORKERS)
    base = UD.lineitem_1995(F, s).cache()
    for name in ("ud3g", "ud8b"):
        held = {}

        def run(name=name):
            held["df"] = UD.build(F, s, name,
                                  base if name in UD.UD8 else None)
            return held["df"].to_arrow()
        WP.pool_metrics.reset()
        profile(torch, None, f"{name.upper()} SF{cs.TPCH_SF}"
                + (f", {cs.UDF_WORKERS} pool workers" if name == "ud3g"
                   else ", cached read"), card_line, run=run)
        ms = cs.python_ms(held["df"]._last_exec)
        print("  Python execs' host ms of the traced run: " + ", ".join(
            f"{k} {v:.3f}" for k, v in ms.items())
            + f"; pool {WP.pool_metrics.snapshot()}", flush=True)
    entry = s.cache_manager.lookup(base.plan)
    print(f"  cache: {entry.cached_bytes} bytes compressed, "
          f"{entry.raw_bytes} raw, {len(entry.frames)} frames; host ms "
          f"framing {entry.frame_ns / 1e6:.3f}, restoring "
          f"{entry.restore_ns / 1e6:.3f} (the traced read)", flush=True)
    s.stop()
    WP.shutdown_pool()


def profile_serving(torch, tpch, card_line):
    """``chip_smoke.py``'s serving phase (its checks included, against
    the 22 answers of one run each) over the SF10 tables, then one
    device trace of SV1's three streams after a warm run, with each
    stream's wall and its queries' admission wait beside it."""
    import tempfile
    from spark_rapids_tpu_torch.ops import kernels as K
    from spark_rapids_tpu_torch.tools.eventlog import parse_event_log
    t0 = time.perf_counter()
    cols = tpch.gen_table_columns(cs.TPCH_SF)
    batches = cs.device_tables(cols, torch.device(cs.DEVICE))
    del cols
    print(f"TPC-H SF{cs.TPCH_SF} generated and on the card in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    K.library()
    workdir = tempfile.mkdtemp(prefix="profile_serving_")
    s = cs.serving_session(batches, "")
    t = cs.stream_tables(s, batches)
    answers = {n: q(t).to_pandas() for n, q in tpch.QUERIES.items()}
    s.stop()
    total = cs.PathLaunches(K.launches.NAMES)
    secs = cs.run_serving(torch, K, tpch, batches, answers, card_line,
                          total, workdir)
    print(f"serving phase {secs:.3f} s (budget {cs.SERVING_BUDGET_S} s); "
          f"launches {total.counts}", flush=True)
    streams = {k: [f"q{i}" for i in v] for k, v in cs.TPCH_STREAMS.items()}
    # the same 66 queries one after another on one thread, then all three
    # streams at once with the pipeline off (three threads, not six)
    # streams at once with the pipeline off (three threads, not six), and
    # with the interpreter handing its lock over every 0.5 ms, not 5 ms
    one = {0: [q for k in sorted(streams) for q in streams[k]]}
    interval = sys.getswitchinterval()
    for label, sub, extra, switch in (
            ("serial (one thread)", one, {}, interval),
            ("3 streams, pipeline off", streams,
             {"spark.rapids.tpu.pipeline.enabled": False}, interval),
            ("3 streams, switch interval 0.5 ms", streams, {}, 0.0005)):
        s = cs.serving_session(batches, "", **extra)
        mem0 = cs.memory_counters(torch)
        torch.cuda.synchronize()
        sys.setswitchinterval(switch)
        try:
            _, walls, _, _, wall = cs.run_streams(tpch, s, batches, sub, [])
            torch.cuda.synchronize()
        finally:
            sys.setswitchinterval(interval)
        print(f"SV1's 66 queries, {label}: wall {wall:.3f} s, queries "
              f"summed {sum(sum(w) for w in walls.values()):.3f} s; memory "
              f"{cs.memory_counters(torch, mem0)} on {card_line}",
              flush=True)
        s.stop()
    held = {}

    def run():
        s = cs.serving_session(batches, tempfile.mkdtemp(dir=workdir))
        starts = cs.query_starts(s)
        held["out"] = cs.run_streams(tpch, s, batches, streams, starts)
        path = s.events.path
        s.stop()
        held["app"] = parse_event_log(path)
    profile(torch, None, f"SV1 TPC-H throughput SF{cs.TPCH_SF}, "
            f"{len(streams)} streams x 22", card_line, run=run,
            host_ops=False)
    _, _, stream_s, qids, wall = held["out"]
    ends = {q.query_id: q for q in held["app"].queries}
    for k in sorted(stream_s):
        wait = sum(ends[q].admission.get("waitMs", 0.0) for q in qids[k])
        print(f"  stream {k}: wall {stream_s[k]:.3f} s, admission wait "
              f"{wait:.3f} ms ({wait / 1e3 / stream_s[k]:.6f} of its "
              f"wall); the three streams' wall {wall:.3f} s", flush=True)


def profile_tpcds_decimal(torch, card_line):
    """TPC-DS q67 (its rollup's Aggregate, a sum past DECIMAL_64, in the
    CPU fallback) and q47 (a window avg over decimal sums) over the tpcds
    phase's SF50 tables with decimal(7,2) money columns, with the
    fallback node's host time in pandas and in each transfer; then q67's
    wall and fallback times under each setting of the fallback
    aggregate's host work, each answer against the first setting's."""
    from spark_rapids_tpu_torch.models import tpcds
    t0 = time.perf_counter()
    batches = tpcds.decimal_batches(cs.tpcds_device_tables(
        tpcds.gen_tables(sf=cs.TPCDS_SF), torch.device(cs.DEVICE)))
    print(f"TPC-DS SF{cs.TPCDS_SF} with decimal money columns generated "
          f"and on the card in {time.perf_counter() - t0:.3f} s",
          flush=True)
    s = cs.tpcds_session(cs.decimal_conf(), batches)
    for name in ("q67", "q47"):
        held = {}

        def build(name=name):
            held["df"] = s.sql(tpcds.QUERIES[name])
            return held["df"]
        profile(torch, build, f"TPC-DS {name} SF{cs.TPCDS_SF} decimal, "
                "hash on", card_line)
        for n in cs.fallback_nodes(held["df"]._last_exec):
            print(f"  {n.describe()}: pandas {n.host_ns() / 1e6:.3f} ms, "
                  f"to the host {n.metrics['toHostTime'].value / 1e6:.3f} "
                  "ms, to the card "
                  f"{n.metrics['toDeviceTime'].value / 1e6:.3f} ms, "
                  f"waiting on its children "
                  f"{n.metrics['childTime'].value / 1e6:.3f} ms (the "
                  "traced run)", flush=True)
    # the fallback aggregate's mechanisms beside its deferred merge, each
    # alone: the pool's threads, the sample's skip of futile partials
    from spark_rapids_tpu_torch.exec import fallback
    # (a share of 1: no sample has more groups than rows, so none skips)
    threads, skip = fallback._HOST_THREADS, fallback._SKIP_SHARE
    first = None
    for label, n, k in (("deferred merge, 1 thread, no skip", 1, 1.0),
                        (f"{threads} threads, no skip", threads, 1.0),
                        ("1 thread, skip", 1, skip),
                        (f"{threads} threads, skip", threads, skip)):
        fallback._HOST_THREADS, fallback._SKIP_SHARE = n, k
        t0 = time.perf_counter()
        df = s.sql(tpcds.QUERIES["q67"])
        got = df.to_pandas()
        wall = (time.perf_counter() - t0) * 1e3
        first = got if first is None else first
        ns = cs.fallback_nodes(df._last_exec)
        print(f"TPC-DS q67 SF{cs.TPCDS_SF} decimal, fallback aggregate "
              f"with {label}: wall {wall:.3f} ms, pandas "
              f"{sum(x.host_ns() for x in ns) / 1e6:.3f} ms, to the host "
              f"{sum(x.metrics['toHostTime'].value for x in ns) / 1e6:.3f} "
              f"ms, to the card "
              f"{sum(x.metrics['toDeviceTime'].value for x in ns) / 1e6:.3f}"
              f" ms; the answer equals the first setting's bit for bit: "
              f"{got.equals(first)} on {card_line}", flush=True)
    fallback._HOST_THREADS, fallback._SKIP_SHARE = threads, skip
    s.stop()


def profile_fallback(torch, F, TpuSession, tpch, card_line):
    """``chip_smoke.py``'s fallback phase (its checks included) over the
    SF10 tables, then traces of one query of each of its parts."""
    from spark_rapids_tpu_torch.exec.fusion import fusion_metrics as fm
    from spark_rapids_tpu_torch.ops import kernels as K
    batches = cs.device_tables(tpch.gen_table_columns(cs.TPCH_SF),
                               torch.device(cs.DEVICE))
    s = TpuSession(cs.tpch_conf(True))
    t = {name: s.create_dataframe(b) for name, b in batches.items()}
    t0 = time.perf_counter()
    answers = {name: q(t).to_pandas() for name, q in tpch.QUERIES.items()}
    print(f"the 22 answers on the card in {time.perf_counter() - t0:.3f} s",
          flush=True)
    s.stop()
    total = cs.PathLaunches(K.launches.NAMES)
    t0 = time.perf_counter()
    fb = cs.run_fallback(torch, K, fm, tpch, batches, answers, card_line,
                         total)
    print(f"fallback phase {time.perf_counter() - t0:.3f} s ("
          + ", ".join(f"{k} {fb[k]:.3f} s" for k in ("F1", "F2", "F3",
                                                     "F4"))
          + f"); launches {total.counts}", flush=True)
    parts = (("F1 TPC-H q10, Sort in pandas",
              {"spark.rapids.sql.exec.Sort": False},
              lambda t: tpch.QUERIES["q10"](t)),
             ("F2 TPC-H q14, its LIKE-holding aggregate in pandas",
              {"spark.rapids.sql.expression.Like": False},
              lambda t: tpch.QUERIES["q14"](t)),
             ("F3 official TPC-H q13, its join in pandas", {},
              lambda t: cs.official_q13(F, t)))
    for label, keys, build in parts:
        s = TpuSession(dict(cs.tpch_conf(True), **keys, **{
            "spark.rapids.sql.test.enabled": False}))
        q = build({name: s.create_dataframe(b)
                   for name, b in batches.items()})
        profile(torch, q, f"{label} SF{cs.TPCH_SF}", card_line)
        for n in cs.fallback_nodes(q._last_exec):
            print(f"  {n.describe()}: pandas {n.host_ns() / 1e6:.3f} ms, "
                  f"to the host {n.metrics['toHostTime'].value / 1e6:.3f} "
                  "ms, to the card "
                  f"{n.metrics['toDeviceTime'].value / 1e6:.3f} ms, "
                  f"waiting on its children "
                  f"{n.metrics['childTime'].value / 1e6:.3f} ms (the "
                  "traced run)", flush=True)
        s.stop()


def profile_memory(torch, F, TpuSession, tpch, card_line):
    """The memory phase's sort of SF10 lineitem (every column, 60,000,000
    rows) at default memory and under the spill budget, its batches
    consumed on the card, and TPC-H q18 under the budget."""
    batches = cs.device_tables(tpch.gen_table_columns(cs.TPCH_SF),
                               torch.device(cs.DEVICE))
    for conf, where in ((cs.tpch_conf(True), "default memory"),
                        (cs.memory_conf(cs.tpch_conf(True)),
                         f"spill budget {cs.MEMORY_BUDGET} bytes")):
        s = TpuSession(conf)
        q = s.create_dataframe(batches["lineitem"]).orderBy(
            F.col("l_extendedprice").desc(), F.col("l_orderkey"),
            F.col("l_linenumber"))

        def consume(q=q, s=s):
            for b in s.plan(q.plan).execute():
                del b
        profile(torch, q, f"sort of lineitem SF{cs.TPCH_SF}, {where}",
                card_line, run=consume, catalog=s.memory_catalog)
        s.stop()
    s = TpuSession(cs.memory_conf(cs.tpch_conf(True)))
    t = {name: s.create_dataframe(b) for name, b in batches.items()}
    profile(torch, tpch.QUERIES["q18"](t),
            f"TPC-H q18 SF{cs.TPCH_SF}, spill budget {cs.MEMORY_BUDGET} "
            "bytes", card_line, catalog=s.memory_catalog)
    s.stop()


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


def profile_files(torch, TpuSession, tpch, card_line):
    """TPC-H q1 and q6 over SF10 lineitem written as 16 parquet files
    through the port's writer, with the pipeline on and off."""
    import os
    import tempfile
    cols = tpch.gen_table_columns(cs.TPCH_SF)
    batch = cs.device_tables({"lineitem": cols["lineitem"]},
                             torch.device(cs.DEVICE))
    del cols
    with tempfile.TemporaryDirectory(prefix="profile-files-") as tmp:
        cs.write_tpch_parquet(batch, tmp)
        del batch
        for pipeline in (True, False):
            s = TpuSession(cs.files_conf(pipeline))
            t = tpch.read_parquet(s, tmp)
            for name in ("q1", "q6"):
                profile(torch, tpch.QUERIES[name](t),
                        f"TPC-H {name} SF{cs.TPCH_SF} over parquet, "
                        f"pipeline {'on' if pipeline else 'off'}",
                        card_line)
            s.stop()


def profile_sharded(torch, TpuSession, tpch, card_line) -> int:
    """TPC-H q1 (two string group keys) and q9 (a five-way join and a
    LIKE over p_name) at SF10, on one device and over 8 logical shards
    (the sharded_tpch phase's sessions); 1 when a sharded run fell
    back."""
    batches = cs.device_tables(tpch.gen_table_columns(cs.TPCH_SF),
                               torch.device(cs.DEVICE))
    for conf, where in ((cs.tpch_conf(True), "one device"),
                        (cs.sharded_conf(cs.tpch_conf(True)),
                         f"over {cs.NSHARDS} shards")):
        s = TpuSession(conf)
        t = {name: s.create_dataframe(b) for name, b in batches.items()}
        for name in ("q1", "q9"):
            profile(torch, tpch.QUERIES[name](t),
                    f"TPC-H {name} SF{cs.TPCH_SF}, {where}", card_line)
            if conf is not None and s.shards is not None and \
                    s.last_dist_explain != "distributed":
                print(f"profile_port: {name} fell back: "
                      f"{s.last_dist_explain}", file=sys.stderr)
                return 1
        s.stop()
        del t
    return 0


if __name__ == "__main__":
    sys.exit(main())
