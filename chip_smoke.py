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
- TPC-H q3 at scale factor 10 over all eight tables of
  ``models/tpch.gen_table_columns`` (value for value
  ``models/tpch.gen_tables``', put on the card once), hash path on and
  off: two sort-merge joins, the three-key group-by, TopN;
- all 22 TPC-H queries over the same SF10 tables, hash path on: per query
  its rows/s (input rows of the tables it reads over the median wall of
  3 runs after a warm one), its kernel launches, hash overflow fallbacks
  and counted host syncs; each answer equals the hash-off run's (keys,
  counts, strings and order exactly, floats within 1e-9 relative), q1
  equals a numpy oracle, and all 22 at SF0.1 on the card equal the
  engine on the CPU (computed meanwhile in a spawned process of its
  own);
- the ``fallback`` phase over the same tables and against the tpch22
  answers (order included): F1 all 22 with
  ``spark.rapids.sql.exec.Sort=false`` (every Sort in the CPU
  fallback, in pandas), F2 q2, q9, q14, q16 and q20 with
  ``spark.rapids.sql.expression.Like=false`` (the nodes holding a LIKE,
  read from each plan), F3 the official text of q13 (its residual left
  join in the fallback: 15M orders, 1.5M customers), each plan's
  ``CpuFallbackExec`` nodes exactly the expected ones, with wall, host
  syncs and the fallback nodes' host ms in pandas and in each transfer;
  F4 the 22 planned, not run, under the cost-based optimizer (built-in
  weights): tagging and planning host ms per query and the regions it
  reverts;
- the same 22 queries as SQL text (``models/tpch_sql.py``) through
  ``session.sql`` over the same tables, hash on, each once after its
  DataFrame form: launches, host syncs and rows/s per query, and each
  answer equal to the DataFrame form's; an unported SQL function raises
  ``NotImplementedError`` naming it (``ntile``), and a
  residual on a left join and
  a RANGE frame with offsets raise strict test mode's ``RuntimeError``
  naming the node and the reason;
- the ``strings_dates`` phase over the same tables: SD1-SD10
  (``models/strings_dates.py``: string, date-and-time, regex and hash
  functions and casts to and from strings over customer, orders,
  lineitem, part, partsupp, supplier and nation) in strict test mode with
  only each query's pinned fallback nodes (SD9's outer projection), one
  warm run and one timed run equal to it bit for bit (rows/s, launches,
  host syncs); SD1, SD4 and SD6 again with the hash path off, equal; the
  function pass: every ported function over 2^20 rows of the SF10
  columns on the card equal to the engine on the CPU (computed in a
  spawned process meanwhile; ``months_between`` within 1e-15 relative),
  and over
  the first 2^16 rows equal to Python's ``str``, ``re``, ``datetime`` and
  a Python Murmur3; and the ten at SF0.1 on the card equal to the engine
  on the CPU (computed meanwhile in a spawned process);
- the ``nested`` phase over the same tables: ND1-ND7
  (``models/nested.py``: collect_list/collect_set per order and the
  collection functions, explode and posexplode, an exploded hash join
  with a keyless sum, a struct through a top-N sort, maps, tumbling and
  sliding windows, JSON and ``split`` in the fallback) in strict test
  mode with only ND7's pinned fallback nodes, one warm and one timed run
  bit for bit (rows/s, launches, host syncs), each equal to numpy's
  answers (computed by the process that generated the tables); ND2 and
  ND3 with the hash path off, equal; the SQL forms of ND1, ND4, ND5 and
  ND6 equal to their DataFrame forms; array, struct and map columns
  through parquet and back; all at SF0.1 on the card equal to the
  engine on the CPU (a spawned process); ``hash_insert``,
  ``hash_probe`` and ``masked_multi_reduce`` each launched;
- the ``udf`` phase over the same tables: UD1-UD9 (``models/udf.py``:
  TPC-H q6 and q1's shape as compiled Python UDFs, a black-box UDF over
  the 1.5M customers, a ``tpu_udf`` torch function, ``mapInPandas``,
  ``applyInPandas``, grouped-aggregate and window pandas UDFs,
  ``cogroup``, a cached slice of lineitem read by three queries, a pivot
  over the lineitem-orders join) in strict test mode, one warm and one
  timed run bit for bit (rows/s, launches, host syncs and the Python
  execs' host ms), each equal to numpy's or pandas' answers (computed by
  the process that generated the tables); UD1 bit for bit tpch22's q6,
  UD2 with the hash path off, UD3 through 4 pool workers equal to inline
  (the pool ran, nothing degraded), UD4's torch function bit for bit its
  column form, UD8's cached answers equal to the uncached plan's (float
  sums within 1e-12), the cache's bytes and host ms; all at SF0.1 on the
  card equal to the engine on the CPU (a spawned process);
  ``hash_insert``, ``hash_probe`` (UD8c's join to one month of orders)
  and ``masked_multi_reduce`` each launched;
- the ``serving`` phase over the same tables, every query inside the
  query envelope (a per-query context, admission, the recovery driver, a
  watchdog query scope, the event log), strict mode at tpch22's conf:
  SV1 TPC-H's throughput test, three streams of the 22 in the
  specification's Appendix A orders on three threads through one
  session (each answer equal to tpch22's bit for bit; 66 QueryStart/
  QueryEnd pairs in the event log, read with ``tools/eventlog.py``, with
  distinct ids, each stream's its own; no recovery action; the streams'
  walls, the admission wait's p50 and p95 and Throughput@Size); SV2
  streams 1 and 2's first two under the fair interleaver, then two
  clients' lineitem scans at once, whose every batch passes the gate
  (one client waits for the other's turn; the answers equal the
  uninterleaved scan's); SV3 q3 with
  three injected OOMs past the operator retries (the ladder's first rung
  the one the escaped fault enters at, never ``cpu``; the answer
  tpch22's; the successful attempt launched ``hash_insert``); SV4 q6
  wedged on a delay rule under a 2 s deadline (a TimeoutFault, the retry
  rung, the answer; the WatchdogTrip event carries q6's id); SV5
  admission at one slot and one queued query (a third refused with a
  FATAL AdmissionFault while the first is wedged); SV6 q1 and q9 traced
  (the same bits, Chrome trace files that validate, spans naming
  ``operator.batch``, ``hostsync.fetch`` and ``admission.wait``).
  Every earlier and later phase also checks that no query recorded a
  recovery action;
- the ``files`` phase: the same SF10 tables written as parquet through
  ``DataFrame.write.parquet`` (lineitem and orders as 16 files each),
  then the 22 queries over ``session.read.parquet`` with the pipeline on
  (one warm run, then one timed run equal to it bit for bit; rows/s,
  launches, host syncs and the host time the scans waited for decoded tables and spent
  uploading), each answer equal to the in-memory one; q6 and q13
  (``FILES_PIPELINE_OFF``) once more with the pipeline off, equal bit
  for bit; q1 and q6
  under the PERFILE,
  COALESCING and MULTITHREADED readers, q6's scan decoding only its four
  columns; at SF0.1 lineitem as ORC and as CSV equal to its parquet
  copy, a partitioned write read back through discovery and a bucketed
  write pruned to one file by an equality filter;
- the ``sharded_tpch`` phase on 8 logical shards of the card
  (``numShards=8``; strings travel as dictionary codes): the 22 TPC-H
  queries as DataFrames and as SQL over the same SF10 tables, each once
  warm and once timed, beside its single-device rows/s; then the 22 over
  the files phase's parquet with the file list sharded (q1, q3, q6, q9,
  q13 and q21 always, then the rest; a query not started inside the
  phase's time budget is cut and named); then TPC-DS q3, q55 and q96 at the tpcds phase's
  scale.  Each runs distributed (its scalar subqueries too), its
  exchanges move the rows its stage statistics count, and its answer
  equals the single-device one; over files the scan's peak host rows
  stay within the largest shard's footer rows;
- the 29 TPC-DS queries (``models/tpcds.py``) through ``session.sql`` at
  scale factor 50 (store_sales 3.0e7 rows), after the TPC-H tables left
  the card: per query one warm run, then one timed run equal to it bit
  for bit (rows/s over the input rows of the tables it reads), launches,
  hash overflow fallbacks and host syncs; for 4 of them
  (``TPCDS_FLOAT_SUBSET``) the answer equals a hash-off run's, and their
  answers at SF1 on the card the engine's on the CPU;
- the ``tpcds_decimal`` pass over the same tables with the
  specification's money columns as ``decimal(7,2)``
  (``tpcds.decimal_batches``, on the card): the 29 through
  ``session.sql`` in strict test mode with ``allowedNonTpu`` naming the
  Aggregate, each plan's ``CpuFallbackExec`` nodes exactly the JAX
  package's (the Aggregate of q7, q27, q65, q13, q6, two of q44), one
  warm and one timed run (bit for bit), the fallback nodes' host ms (q67
  is cut, ``TPCDS_DECIMAL_CUT``),
  and each answer equal to the float pass's (keys, counts, strings and
  order exactly, a decimal within 1e-9 relative or half a unit of its
  scale, rows tied on their numbers as sets); then the ``numeric`` pass
  over its store_sales: per item the sample stddev, the population
  variance, first and last (the aggregate shape of q17 and q39), hash on
  and off, against numpy, and every ported math function, round/bround,
  floor/ceil, pmod, the bitwise operators and the shifts over 2^20 rows
  on the card against the engine on the CPU (transcendentals within
  1e-13 relative, the rest exactly); at SF1 all 29 decimal queries on
  the card equal the engine on the CPU (decimals exactly), and
  store_sales' decimal form written to parquet and read back gives q3
  and q48 exactly (the CPU's SF1 answers computed meanwhile in a spawned
  process of its own);
- the ``memory`` phase, after the files phase over its parquet (M1-M4)
  and inside the tpcds phase on its tables (M5): M1 the out-of-core
  sort of SF10 lineitem (60,000,000 rows, every column) by
  (l_extendedprice desc, l_orderkey, l_linenumber) at default memory,
  sorted within and across its output batches, its keys equal to numpy's
  ``lexsort`` (computed on a thread meanwhile), an order-free checksum of
  every column equal to the input's; M2 the same sort of lineitem's
  first 8 input batches under a 256 MiB spill budget with a 1 GiB host
  tier, reaching host and disk with no integrity failure, equal batch
  for batch, bit for bit, to M1's sort of those batches at default
  memory; M3 11 of the 22 TPC-H queries (``MEMORY_M3_QUERIES``) under
  the budget, once each, equal to
  the tpch22 answers, q18 spilling and tree-merging, and q1 and q18 over the
  parquet with the pipeline's batches registered; M4 a real
  ``torch.OutOfMemoryError`` in q1's aggregate over 2^26-row batches
  under ``torch.cuda.set_per_process_memory_fraction`` recovered by
  retry and split, then injected OOMs through project/filter,
  aggregate, join and sort at SF10, each equal to the uninjected run; M5
  TPC-DS q47 and q67 in more than one window chunk, and q67 again under
  the budget with its sorts spilling and the same answer.  Its launches
  are ``launches_by_phase["memory"]``;
- the fact-dim hash join (2^26 fact rows against 2^19 dim rows, then a
  group-by on the key), hash path on (``hash_insert`` + ``hash_probe`` in
  every probe batch) and off, run while the TPC-H tables are generated
  (before q3);
- the sharded query path on 8 logical shards of the card
  (``spark.rapids.sql.distributed.numShards=8``): q6 and the q1 shape at
  2^26 rows, the sparse-key group-by, the fact-dim join as a shuffle
  (2^19 build rows are past the 2^16 broadcast threshold) and
  ``orderBy`` / TopN of the 2^22-row sparse table, each beside its
  single-device twin; and the q1 shape at 2^22 rows and TPC-H q1 at SF1
  (two string group keys) through a one-rank NCCL process group against
  one logical shard (and q1 against numpy).

Answers are checked against numpy / pandas oracles on the same host data.
The single-device tpch22, tpch_sql, strings_dates, nested, udf, files,
memory and tpcds phases plan
in strict test mode (``spark.rapids.sql.test.enabled``): a node of
theirs that would fall back to the CPU fails the run.

Output, in order: the card's name and power limit, the torch/CUDA versions
and kernel build time, one line per check, rows/s per query, a
``{"kernels": [...]}`` line (per kernel: the first shape's times at the
top level, other shapes under ``other_shapes``, the main path's launches
in total, by phase for the tpch22, fallback, tpch_sql, strings_dates,
nested, udf, files, tpcds, tpcds_decimal, numeric, sharded_tpch and
memory phases, and by shape),
and last
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
TPCH_SF = 10            # TPC-H scale of q3's phase and the 22 queries
TPCH_CHECK_SF = 0.1     # the card against the engine on the CPU
FILES_PER_BIG_TABLE = 16  # lineitem and orders as parquet in the files phase
FILES_CHECK_SF = 0.1    # ORC, CSV, partitioned and bucketed round trips
# store_sales 3.0e7 rows: SF100 (lineitem's SF10 rows) took 409 s of the
# 400 s the phase may take on a slower host
TPCDS_SF = 50
TPCDS_CHECK_SF = 1      # the card against the engine on the CPU
CPU_CHECK_THREADS = 4   # the CPU answers' process, beside the card's phase
FACT_ROWS = 1 << 26
DIM_ROWS = 1 << 19
BATCH_ROWS = 1 << 22
JOIN_SLOTS = 1 << 20                    # the join build's table
NSHARDS = 8
HIST_FACT_ROWS = FACT_ROWS // NSHARDS   # the join's stats pass per shard
HIST_BUCKET_ROWS = 1 << 19              # an aggregate's bucket stats pass
PG_ROWS = 1 << 22
PG_TPCH_SF = 1          # TPC-H q1 through the one-rank NCCL group
# the sharded_tpch phase's file pass: these first, then the rest while
# the phase stays inside SHARDED_BUDGET_S (a phase may take 400 s)
SHARDED_FILES_FIRST = ("q1", "q3", "q6", "q9", "q13", "q21")
SHARDED_BUDGET_S = 110.0     # 340 s before the nested phase's cuts
SHARDED_TPCDS = ("q3", "q55", "q96")
# the time step's cuts of earlier phases, so that the TPC-DS decimal and
# numeric passes fit the script's time: the float tpcds phase times one
# run after the warm one (two before) and the files phase one (two
# before), and the files phase reruns with the pipeline off only these
# queries (all 22 before)
FILES_REPS = 1
TPCDS_REPS = 1
# the nested phase's cuts of earlier phases, past the two its issue names
# (FILES_PIPELINE_OFF, TPCDS_FLOAT_SUBSET): the tpch22 phase times one run
# after the warm one (three before), the files phase times 11 of the 22
# and the tpcds phase 15 of the 29 (FILES_TIMED, TPCDS_TIMED: each checked
# bit for bit against its warm run; the others run once), M2 sorts 4
# input batches (8 before) and the sharded file pass has SHARDED_BUDGET_S
TPCH22_REPS = 1
# the udf phase's cuts (its run took the script past 1080 s): the files
# phase times these 5 of the 22 (11 before: q1, q5, q9, q10, q12 and q21
# cut, 21.7 s of timed runs) and the tpcds phase these 7 of the 29 (15
# before: q7, q19, q27, q46, q47, q67, q88 and q98 cut, 19.7 s)
# The serving phase's cuts (its final run took the script to 1153 s):
# the files phase times these 2 (q3, q14 and q18 cut, 4.8 s), the tpcds
# phase these 3 (q34, q42, q52 and q61 cut, 2.7 s), and the decimal pass
# leaves out q67 (54.9 s, 29.1 of them in pandas: its rollup's Aggregate
# in the CPU fallback, whose path q7, q27 and q65 still take)
FILES_TIMED = ("q6", "q13")
TPCDS_TIMED = ("q3", "q55", "q96")
TPCDS_DECIMAL_CUT = ("q67",)
# the strings_dates phase's cuts of earlier phases: the decimal pass runs
# q67 once (its warm run is its checked run; cut since), and M3 runs these
# 11 of the 22 under the budget (q18 spills and tree-merges)
MEMORY_M3_QUERIES = ("q1", "q2", "q4", "q5", "q6", "q8", "q9", "q10", "q12",
                     "q17", "q18")
# the files phase's pipeline-off pass (q1, q3 and q18 cut for the nested
# phase's time)
FILES_PIPELINE_OFF = ("q6", "q13")
# the float tpcds pass's hash-off rerun and its SF1 check against the
# CPU run over these (star joins, windows, the scalar subqueries' Range;
# q19, q27, q67's rollup and q88 cut for the nested phase's time); the
# decimal pass runs all 29 at SF1
TPCDS_FLOAT_SUBSET = ("q3", "q47", "q61", "q98")
# the decimal pass's CpuFallbackExec nodes: the JAX package's over the
# same tables (avg over a decimal, a sum past DECIMAL_64)
TPCDS_DECIMAL_FALLBACK = {q: ["Aggregate"] for q in
                          ("q7", "q27", "q65", "q67", "q13", "q6")}
TPCDS_DECIMAL_FALLBACK["q44"] = ["Aggregate", "Aggregate"]
DECIMAL_RTOL = 1e-9   # a decimal answer against the float tables' doubles
NUMERIC_SLICE_ROWS = 1 << 20   # the numeric pass's card-against-CPU slice
MATH_RTOL = 1e-13     # CUDA's libm against glibc

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
    reads = {"customer": ("c_custkey", "c_mktsegment"),
             "orders": ("o_orderkey", "o_custkey", "o_orderdate",
                        "o_shippriority"),
             "lineitem": ("l_orderkey", "l_extendedprice", "l_discount",
                          "l_shipdate")}
    host = {t: {k: cols[t][k][1] for k in ks} for t, ks in reads.items()}
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


# ---------------------------------------------------------------- tpch22 --

class ReadTables(dict):
    """The tables a query reads: a dict that notes every key looked up."""

    def __init__(self, tables):
        super().__init__(tables)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def device_tables(cols, device):
    """Every table of ``gen_table_columns`` output as one batch on the
    card (copied once; sessions share them)."""
    from spark_rapids_tpu_torch.interop import batch_from_arrays
    return {name: batch_from_arrays(c, device) for name, c in cols.items()}


def frames_match(got, want, rtol):
    """(equal, what differs): same columns, rows and order; floats within
    ``rtol`` relative, every other column (keys, counts, strings, dates)
    exactly."""
    if list(got.columns) != list(want.columns) or len(got) != len(want):
        return False, (f"shape {list(got.columns)} x {len(got)} vs "
                       f"{list(want.columns)} x {len(want)}")
    for c in got.columns:
        g, w = got[c], want[c]
        if g.dtype.kind == "f" and w.dtype.kind == "f":
            gv, wv = g.to_numpy(), w.to_numpy()
            if not np.allclose(gv, wv, rtol=rtol, atol=0, equal_nan=True):
                bad = np.nonzero(~np.isclose(gv, wv, rtol=rtol, atol=0,
                                             equal_nan=True))[0][:3]
                return False, (f"{c} rows {bad.tolist()}: "
                               f"{gv[bad].tolist()} vs {wv[bad].tolist()}")
        elif not g.equals(w):
            bad = np.nonzero((g != w).to_numpy())[0][:3]
            return False, (f"{c} rows {bad.tolist()}: {g.iloc[bad].tolist()}"
                           f" vs {w.iloc[bad].tolist()}")
    return True, ""


def tpch_q1_oracle(cols):
    """q1 at the generated scale from the host columns with numpy: groups
    (returnflag, linestatus) in order, sums and averages in float64."""
    li = {k: cols["lineitem"][k][1] for k in cols["lineitem"]}
    m = li["l_shipdate"] <= int((np.datetime64("1998-09-02")
                                 - np.datetime64("1970-01-01"))
                                .astype(np.int64))
    rf_off, rf_chars = li["l_returnflag"]
    ls_off, ls_chars = li["l_linestatus"]
    rf = rf_chars[rf_off[:-1]][m]   # one-byte strings
    ls = ls_chars[ls_off[:-1]][m]
    g = rf.astype(np.int64) * 256 + ls
    keys, inv = np.unique(g, return_inverse=True)
    n = np.bincount(inv)

    def s(x):
        return np.bincount(inv, weights=x[m])
    price, disc, tax = (li["l_extendedprice"], li["l_discount"],
                        li["l_tax"])
    disc_price = price * (1 - disc)
    return {"l_returnflag": [chr(k // 256) for k in keys],
            "l_linestatus": [chr(k % 256) for k in keys],
            "sum_qty": s(li["l_quantity"]), "sum_base_price": s(price),
            "sum_disc_price": s(disc_price),
            "sum_charge": s(disc_price * (1 + tax)),
            "avg_qty": s(li["l_quantity"]) / n, "avg_price": s(price) / n,
            "avg_disc": s(disc) / n, "count_order": n}


def tpch_conf(hash_on: bool):
    """The conf of the single-device TPC-H, TPC-DS, files and memory
    phases: 2^22-row batches, the hash path on or off, and strict test
    mode, so a plan node that would fall back to the CPU fails the run."""
    return {"spark.rapids.sql.tpu.maxBatchRows": BATCH_ROWS,
            "spark.rapids.tpu.pallas.hash.enabled": hash_on,
            "spark.rapids.tpu.pallas.hash.tableSlots": str(HASH_SLOTS),
            "spark.rapids.sql.test.enabled": True}


def table_bytes(batches) -> int:
    return sum(c.data.nbytes + (0 if c.offsets is None else c.offsets.nbytes)
               + (0 if c.validity is None else c.validity.nbytes)
               for b in batches.values() for c in b.columns.values())


def run_tpch22(torch, K, fm, tpch, cols, batches, card_line, total,
               reps=TPCH22_REPS):
    """All 22 TPC-H queries through ``TpuSession`` on the card over the
    device tables ``batches`` (made from the host ``cols``), hash on:
    launches and host syncs of the first run (the main path's), then
    rows/s over the median of ``reps``; each answer equals the hash-off
    run's (check a) and q1 equals numpy (check c).  Returns the answers
    and the rows/s by query."""
    from spark_rapids_tpu_torch.api.session import TpuSession
    from spark_rapids_tpu_torch.utils.hostsync import host_sync_metrics
    sessions = {on: TpuSession(tpch_conf(on)) for on in (True, False)}
    tables = {on: {k: s.create_dataframe(b) for k, b in batches.items()}
              for on, s in sessions.items()}
    rates, answers = {}, {}
    for name, query in tpch.QUERIES.items():
        read = ReadTables(tables[True])
        q = query(read)
        rows = sum(batches[k].nrows for k in read.read)
        got, launches, fus, rate = drive(
            torch, K, fm, q, rows, card_line, f"tpch22 {name}", reps=reps,
            extra={"host_syncs": host_sync_metrics}, same_bits=True)
        rates[name] = rate
        answers[name] = got
        total.add(launches)
        print(f"tpch22 {name}: {len(got)} rows; launches "
              + ", ".join(f"{k} {launches[k]}" for k in K.launches.NAMES)
              + f"; hashKernelLaunches {fus['hashKernelLaunches']}, "
              f"hashOverflowFallbacks {fus['hashOverflowFallbacks']}, "
              f"host syncs {fus['host_syncs']}; tables "
              f"{sorted(read.read)}", flush=True)
        off = query(tables[False]).to_pandas()
        ok, why = frames_match(got, off, QUERY_RTOL)
        check(ok, f"tpch22 {name}: hash on equals hash off (floats within "
              f"rel {QUERY_RTOL}) {why}")
    want = tpch_q1_oracle(cols)
    got = answers["q1"]
    check(got["l_returnflag"].tolist() == want["l_returnflag"]
          and got["l_linestatus"].tolist() == want["l_linestatus"]
          and got["count_order"].tolist() == want["count_order"].tolist(),
          f"tpch22 q1: {len(got)} groups, order and counts equal numpy")
    for c in ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
              "avg_qty", "avg_price", "avg_disc"):
        check(np.allclose(got[c].to_numpy(), want[c], rtol=QUERY_RTOL,
                          atol=0),
              f"tpch22 q1 {c} within rel {QUERY_RTOL} of numpy")
    for s in sessions.values():
        s.stop()
    print("tpch22 rows/s on " + card_line + ": " + json.dumps(
        {k: float(f"{v:.6e}") for k, v in rates.items()}), flush=True)
    return answers, rates


def sql_tables(text):
    """Names of the tables a SQL statement reads (its CTEs substituted)."""
    from spark_rapids_tpu_torch.sql import parser as A
    found = set()

    def walk(node):
        if isinstance(node, A.TableRef):
            found.add(node.name.lower())
        if isinstance(node, list):
            for x in node:
                walk(x)
        elif hasattr(node, "__dataclass_fields__"):
            for f in node.__dataclass_fields__:
                walk(getattr(node, f))
    walk(A.parse(text))
    return found


def sql_launch_line(label, got, launches, fus, tables):
    print(f"{label}: {len(got)} rows; launches "
          + ", ".join(f"{k} {launches[k]}" for k in launches
                      if k != "by_shape")
          + f"; hashKernelLaunches {fus['hashKernelLaunches']}, "
          f"hashOverflowFallbacks {fus['hashOverflowFallbacks']}, "
          f"host syncs {fus['host_syncs']}; tables {sorted(tables)}",
          flush=True)


def run_tpch_sql(torch, K, fm, tpch_sql, batches, df_answers, card_line,
                 total):
    """The 22 queries as SQL text through ``session.sql`` over the same
    device tables, hash on, each once after its DataFrame form ran: its
    launches, host syncs and rows/s, and its answer equal to the
    DataFrame form's (keys, counts, strings and order exactly, floats
    within ``QUERY_RTOL``)."""
    from spark_rapids_tpu_torch.api.session import TpuSession
    from spark_rapids_tpu_torch.utils.hostsync import host_sync_metrics
    s = TpuSession(tpch_conf(True))
    tpch_sql.register(s, {k: s.create_dataframe(b)
                          for k, b in batches.items()})
    rates, mmr = {}, {}
    for name, text in tpch_sql.QUERIES.items():
        read = sql_tables(text)
        rows = sum(batches[k].nrows for k in read)
        got, launches, fus, rates[name] = drive(
            torch, K, fm, lambda text=text: s.sql(text), rows, card_line,
            f"tpch_sql {name}", reps=0, extra={"host_syncs":
                                               host_sync_metrics})
        total.add(launches)
        mmr[name] = launches["masked_multi_reduce"]
        sql_launch_line(f"tpch_sql {name}", got, launches, fus, read)
        want = tpch_sql.dataframe_form(name, df_answers[name])
        ok, why = frames_match(got.reset_index(drop=True),
                               want.reset_index(drop=True), QUERY_RTOL)
        check(ok, f"tpch_sql {name}: the SQL answer equals the DataFrame "
              f"form's (floats within rel {QUERY_RTOL}) {why}")
    check_unported_raise(s)
    s.stop()
    print("tpch_sql rows/s on " + card_line + ": " + json.dumps(
        {k: float(f"{v:.6e}") for k, v in rates.items()}), flush=True)
    print("tpch_sql masked_multi_reduce launches: " + json.dumps(mmr),
          flush=True)
    return rates


def check_unported_raise(s):
    """On the card as on the CPU, an unported SQL function raises
    ``NotImplementedError`` naming it; a residual condition on a join
    that is not inner and a window frame the card does not run are
    tagged off the device, and the session's strict test mode raises
    naming the node and the reason instead of falling back."""
    from spark_rapids_tpu_torch.api import functions as F
    nation, region = s.table("nation"), s.table("region")
    cases = {
        "ntile": (NotImplementedError, "ntile", lambda: s.sql(
            "SELECT ntile(4) OVER (ORDER BY n_nationkey) FROM nation")),
        "left join": (RuntimeError, "Join fell back to CPU in strict test "
                      "mode: non-equi join conditions", lambda: nation.join(
                          region, on=(F.col("n_regionkey")
                                      == F.col("r_regionkey"))
                          & (F.col("n_nationkey") > F.col("r_regionkey")),
                          how="left")),
        "range frames": (RuntimeError, "Window fell back to CPU in strict "
                         "test mode: expression WindowExpression cannot run "
                         "on the device: range frames", lambda: nation.select(
                             F.window_sum("n_nationkey").over(
                                 F.Window.partitionBy("n_regionkey")
                                 .orderBy("n_nationkey")
                                 .rangeBetween(-2, 2)).alias("w"))),
    }
    for what, (kind, text, build) in cases.items():
        try:
            build().collect()
            raised = ""
        except kind as exc:
            raised = str(exc)
        check(text in raised, f"unported {what!r} raises "
              f"{kind.__name__} on the card: {raised!r}")


# --------------------------------------------------------- strings_dates --

SD_HASH_OFF = ("sd1", "sd4", "sd6")     # rerun with the hash path off
SD_CHECK_SF = 0.1         # SD1-SD10 on the card against the engine on the CPU
SD_FUNCTION_ROWS = 1 << 20  # the function pass: rows from the SF10 columns
SD_ORACLE_ROWS = 1 << 16  # ... of which Python checks these
SD_FLOAT_RTOL = 1e-15     # months_between, card against CPU and Python
SD_BUDGET_S = 120.0
# the SF10 columns the function pass draws its rows from
SD_FUNCTION_COLUMNS = {
    "customer": ("c_name", "c_phone", "c_mktsegment", "c_nationkey"),
    "orders": ("o_comment", "o_orderdate", "o_orderkey", "o_orderpriority"),
    "lineitem": ("l_shipdate", "l_commitdate", "l_receiptdate", "l_discount",
                 "l_shipinstruct"),
    "part": ("p_type", "p_brand", "p_mfgr", "p_container"),
}


def sd_session(batches, hash_on, allowed=(), device=None):
    """A strict-mode session over the TPC-H views allowing only the
    ``allowed`` fallback nodes."""
    from spark_rapids_tpu_torch.api.session import TpuSession
    from spark_rapids_tpu_torch.models import tpch_sql
    conf = dict(tpch_conf(hash_on), **{
        "spark.rapids.sql.test.allowedNonTpu": ",".join(allowed) or "none"})
    s = TpuSession(conf) if device is None else TpuSession(conf,
                                                           device=device)
    tpch_sql.register(s, {k: s.create_dataframe(b)
                          for k, b in batches.items()})
    return s


def strings_dates_cpu_answers(sf, conn):
    """In a process of its own: SD1-SD10 on the engine on the CPU at scale
    ``sf`` (the SF0.1 check's reference)."""
    import torch
    torch.set_num_threads(CPU_CHECK_THREADS)
    sys.path.insert(0, str(ROOT))
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.models import strings_dates as SD
    from spark_rapids_tpu_torch.models import tpch
    try:
        batches = device_tables(tpch.gen_table_columns(sf), "cpu")
        out = {}
        for name in SD.QUERIES:
            s = sd_session(batches, True, SD.FALLBACK_NODES[name], "cpu")
            out[name] = SD.run(F, s, name).to_pandas()
        conn.send(out)
    except BaseException as exc:
        conn.send(exc)
        raise
    finally:
        conn.close()


def function_exprs(F):
    """Every ported string, date-and-time, regex, hash and cast function
    over the function pass's columns, by name."""
    c = F.col
    ts = F.from_unixtime(F.unix_timestamp(c("o_orderdate"))
                         + c("o_orderkey") % 86400).cast("timestamp")
    return {
        "length": F.length("o_comment"),
        "octet_length": F.octet_length("o_comment"),
        "upper": F.upper("o_comment"), "lower": F.lower("c_mktsegment"),
        "initcap": F.initcap(F.lower("p_type")),
        "trim": F.trim(F.concat(F.lit("  "), c("c_name"), F.lit(" "))),
        "ltrim": F.ltrim(F.concat(F.lit("  "), c("p_container"))),
        "rtrim": F.rtrim(F.concat(c("p_container"), F.lit("  "))),
        "concat": F.concat(c("c_name"), F.lit("/"), c("c_phone")),
        "concat_ws": F.concat_ws("|", "p_brand", "p_container",
                                 "o_orderpriority"),
        "lpad": F.lpad("c_mktsegment", 12, "*"),
        "rpad": F.rpad("o_orderpriority", 8, "-."),
        "locate": F.locate("-", c("c_phone"), 4),
        "locate_word": F.locate("special", c("o_comment")),
        "substring_index": F.substring_index("c_phone", "-", 2),
        "substring_index_neg": F.substring_index("c_phone", "-", -2),
        "repeat": F.repeat(F.substring("p_mfgr", 14, 1), 3),
        "ascii": F.ascii("c_name"), "chr": F.chr(c("c_nationkey") + 65),
        "rlike": F.rlike("o_comment", "special.*requests"),
        "rlike_anchored": F.rlike("o_comment", "^[a-z]{3}.+ly$"),
        "regexp_replace": F.regexp_replace("c_phone", "-", ""),
        "replace": F.replace("o_comment", " ", ""),
        "translate": F.translate("p_type", "AEIOU", "aeiou"),
        "split": F.split("c_phone", "-").getItem(2),
        "hash": F.hash("c_name", "o_orderkey"),
        "isnan": F.isnan("l_discount"),
        "greatest": F.greatest("l_shipdate", "l_commitdate",
                               "l_receiptdate"),
        "least": F.least("l_shipdate", "l_commitdate", "l_receiptdate"),
        "quarter": F.quarter("o_orderdate"),
        "dayofweek": F.dayofweek("o_orderdate"),
        "weekday": F.weekday("o_orderdate"),
        "dayofyear": F.dayofyear("o_orderdate"),
        "last_day": F.last_day("o_orderdate"),
        "next_day": F.next_day("o_orderdate", "Fri"),
        "hour": F.hour(ts), "minute": F.minute(ts), "second": F.second(ts),
        "add_months": F.add_months("o_orderdate", 13),
        "months_between": F.months_between("l_receiptdate", "l_shipdate"),
        "trunc": F.trunc("o_orderdate", "quarter"),
        "unix_timestamp": F.unix_timestamp(ts),
        "from_unixtime": F.from_unixtime(c("o_orderkey") * 997),
        "date_format": F.date_format(ts, "yyyy-MM-dd HH:mm:ss"),
        "int_string": c("o_orderkey").cast("string"),
        "string_int": F.substring_index("c_phone", "-", 1).cast("int"),
        "string_bigint": F.regexp_replace("c_phone", "-", "").cast("bigint"),
        "string_double": F.concat(F.substring_index("c_phone", "-", 1),
                                  F.lit("."), F.substring("c_phone", 4, 3))
        .cast("double"),
        "date_string": c("o_orderdate").cast("string"),
        "string_date": c("o_orderdate").cast("string").cast("date"),
        "timestamp_string": ts.cast("string"),
        "string_timestamp": ts.cast("string").cast("timestamp"),
        "bool_string": F.isnan("l_discount").cast("string"),
        "string_bool": (c("o_orderkey") % 2 == 0).cast("string")
        .cast("boolean"),
    }


def _mm3(values, kinds, seed=42):
    """Spark's Murmur3_x86_32 ``hash()`` of one row, in Python."""
    m = 0xFFFFFFFF

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & m

    def k1(k):
        return (rotl((k * 0xCC9E2D51) & m, 15) * 0x1B873593) & m

    def h1(h, k):
        return (rotl(h ^ k, 13) * 5 + 0xE6546B64) & m

    def fmix(h, n):
        h ^= n
        h = ((h ^ (h >> 16)) * 0x85EBCA6B) & m
        h = ((h ^ (h >> 13)) * 0xC2B2AE35) & m
        return h ^ (h >> 16)
    h = seed
    for v, kind in zip(values, kinds):
        if kind == "string":
            b = v.encode("utf-8")
            n4 = len(b) // 4 * 4
            for i in range(0, n4, 4):
                h = h1(h, k1(int.from_bytes(b[i:i + 4], "little")))
            for x in b[n4:]:
                h = h1(h, k1((x - 256 if x >= 128 else x) & m))
            h = fmix(h, len(b))
        else:
            v &= (1 << 64) - 1
            h = fmix(h1(h1(h, k1(v & m)), k1(v >> 32)), 8)
    return h - (1 << 32) if h >= 1 << 31 else h


def function_oracles():
    """Python's answer (``str``, ``re``, ``datetime``, ``hashlib``,
    Spark's documented rules) of each function of :func:`function_exprs`
    for one row (a dict of its input values)."""
    import calendar
    import datetime as dtm
    import math
    import re
    epoch = dtm.date(1970, 1, 1)
    rx1 = re.compile("special.*requests")
    rx2 = re.compile("^[a-z]{3}.+ly$")

    def ts(r):
        return dtm.datetime(1970, 1, 1) + dtm.timedelta(seconds=(
            r["o_orderdate"] - epoch).days * 86400 + r["o_orderkey"] % 86400)

    def ascii_case(v, up):
        return "".join(ch.upper() if up and "a" <= ch <= "z" else
                       ch.lower() if not up and "A" <= ch <= "Z" else ch
                       for ch in v)

    def initcap(v):
        out, prev = [], True
        for ch in v:
            out.append(ch.upper() if prev else ch.lower())
            prev = ch == " "
        return "".join(out)

    def pad(v, w, p, left):
        if len(v) >= w:
            return v[:w]
        fill = (p * w)[:w - len(v)]
        return fill + v if left else v + fill

    def sub_index(v, d, n):
        parts = v.split(d)
        return d.join(parts[:n]) if n > 0 else d.join(parts[n:])

    def add_months(d, n):
        y, mo = divmod(d.year * 12 + d.month - 1 + n, 12)
        return dtm.date(y, mo + 1, min(d.day, calendar.monthrange(
            y, mo + 1)[1]))

    def months_between(a, b):
        if a.day == b.day or (a.day == calendar.monthrange(
                a.year, a.month)[1] and b.day == calendar.monthrange(
                b.year, b.month)[1]):
            return float((a.year * 12 + a.month) - (b.year * 12 + b.month))
        v = (a.year * 12 + a.month) - (b.year * 12 + b.month) + \
            (a.day - b.day) * 86400 / (31 * 86400)
        return math.floor(v * 1e8 + 0.5) / 1e8

    def next_fri(d):
        return d + dtm.timedelta(days=(4 - d.weekday() + 7) % 7 or 7)

    def fmt(t):
        return t.strftime("%Y-%m-%d %H:%M:%S")
    li = ("l_shipdate", "l_commitdate", "l_receiptdate")
    return {
        "length": lambda r: len(r["o_comment"]),
        "octet_length": lambda r: len(r["o_comment"].encode("utf-8")),
        "upper": lambda r: ascii_case(r["o_comment"], True),
        "lower": lambda r: ascii_case(r["c_mktsegment"], False),
        "initcap": lambda r: initcap(r["p_type"].lower()),
        "trim": lambda r: ("  " + r["c_name"] + " ").strip(" "),
        "ltrim": lambda r: r["p_container"],
        "rtrim": lambda r: r["p_container"],
        "concat": lambda r: r["c_name"] + "/" + r["c_phone"],
        "concat_ws": lambda r: "|".join((r["p_brand"], r["p_container"],
                                         r["o_orderpriority"])),
        "lpad": lambda r: pad(r["c_mktsegment"], 12, "*", True),
        "rpad": lambda r: pad(r["o_orderpriority"], 8, "-.", False),
        "locate": lambda r: r["c_phone"].find("-", 3) + 1,
        "locate_word": lambda r: r["o_comment"].find("special") + 1,
        "substring_index": lambda r: sub_index(r["c_phone"], "-", 2),
        "substring_index_neg": lambda r: sub_index(r["c_phone"], "-", -2),
        "repeat": lambda r: r["p_mfgr"][13:14] * 3,
        "ascii": lambda r: ord(r["c_name"][0]),
        "chr": lambda r: chr((r["c_nationkey"] + 65) % 256),
        "rlike": lambda r: bool(rx1.search(r["o_comment"])),
        "rlike_anchored": lambda r: bool(rx2.search(r["o_comment"])),
        "regexp_replace": lambda r: r["c_phone"].replace("-", ""),
        "replace": lambda r: r["o_comment"].replace(" ", ""),
        "translate": lambda r: r["p_type"].translate(
            str.maketrans("AEIOU", "aeiou")),
        "split": lambda r: r["c_phone"].split("-")[2],
        "hash": lambda r: _mm3([r["c_name"], r["o_orderkey"]],
                               ["string", "bigint"]),
        "isnan": lambda r: math.isnan(r["l_discount"]),
        "greatest": lambda r: max(r[k] for k in li),
        "least": lambda r: min(r[k] for k in li),
        "quarter": lambda r: (r["o_orderdate"].month - 1) // 3 + 1,
        "dayofweek": lambda r: (r["o_orderdate"].weekday() + 1) % 7 + 1,
        "weekday": lambda r: r["o_orderdate"].weekday(),
        "dayofyear": lambda r: r["o_orderdate"].timetuple().tm_yday,
        "last_day": lambda r: r["o_orderdate"].replace(
            day=calendar.monthrange(r["o_orderdate"].year,
                                    r["o_orderdate"].month)[1]),
        "next_day": lambda r: next_fri(r["o_orderdate"]),
        "hour": lambda r: ts(r).hour, "minute": lambda r: ts(r).minute,
        "second": lambda r: ts(r).second,
        "add_months": lambda r: add_months(r["o_orderdate"], 13),
        "months_between": lambda r: months_between(r["l_receiptdate"],
                                                   r["l_shipdate"]),
        "trunc": lambda r: dtm.date(r["o_orderdate"].year, (
            r["o_orderdate"].month - 1) // 3 * 3 + 1, 1),
        "unix_timestamp": lambda r: (r["o_orderdate"] - epoch).days * 86400
        + r["o_orderkey"] % 86400,
        "from_unixtime": lambda r: fmt(dtm.datetime(1970, 1, 1) +
                                       dtm.timedelta(seconds=r["o_orderkey"]
                                                     * 997)),
        "date_format": lambda r: fmt(ts(r)),
        "int_string": lambda r: str(r["o_orderkey"]),
        "string_int": lambda r: int(r["c_phone"].split("-")[0]),
        "string_bigint": lambda r: int(r["c_phone"].replace("-", "")),
        "string_double": lambda r: float(r["c_phone"].split("-")[0] + "."
                                         + r["c_phone"][3:6]),
        "date_string": lambda r: r["o_orderdate"].isoformat(),
        "string_date": lambda r: r["o_orderdate"],
        "timestamp_string": lambda r: fmt(ts(r)),
        "string_timestamp": lambda r: ts(r),
        "bool_string": lambda r: str(math.isnan(r["l_discount"])).lower(),
        "string_bool": lambda r: r["o_orderkey"] % 2 == 0,
    }


def function_oracle_values(path, rows, conn):
    """In a process of its own: Python's answer of every function of
    :func:`function_exprs` for the first ``rows`` rows of the arrow file
    ``path``, as an arrow table, and the seconds it took."""
    import pyarrow as pa
    try:
        t0 = time.perf_counter()
        with pa.memory_map(path) as src:
            table = pa.ipc.open_file(src).read_all().slice(0, rows)
        data = table.to_pylist()
        out = pa.table({name: pa.array([fn(r) for r in data])
                        for name, fn in function_oracles().items()})
        conn.send((out, time.perf_counter() - t0))
    except BaseException as exc:
        conn.send(exc)
        raise
    finally:
        conn.close()


def function_pass_cpu(path, out_path, conn):
    """In a process of its own: every function of :func:`function_exprs`
    over the rows of the arrow file ``path`` on the engine on the CPU,
    written to the arrow file ``out_path``; the seconds it took."""
    import pyarrow as pa
    import torch
    torch.set_num_threads(CPU_CHECK_THREADS)
    sys.path.insert(0, str(ROOT))
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.session import TpuSession
    try:
        t0 = time.perf_counter()
        with pa.memory_map(path) as src:
            table = pa.ipc.open_file(src).read_all()
        s = TpuSession({}, device="cpu")
        out = s.create_dataframe(table).select(
            *[e.alias(k) for k, e in function_exprs(F).items()]).to_arrow()
        with pa.OSFile(out_path, "wb") as sink:
            with pa.ipc.new_file(sink, out.schema) as writer:
                writer.write_table(out)
        conn.send(time.perf_counter() - t0)
    except BaseException as exc:
        conn.send(exc)
        raise
    finally:
        conn.close()


def start_function_pass(batches, workdir):
    """Start the function pass's references while the card runs other
    phases, each in a process of its own over its rows written to an
    arrow file in ``workdir``: the engine on the CPU over
    ``SD_FUNCTION_ROWS`` rows and Python over the first
    ``SD_ORACLE_ROWS``.  Returns (a function that waits for the CPU's
    arrow table and its seconds, Python's process)."""
    import os
    import pyarrow as pa
    path = os.path.join(workdir, "function_pass_in.arrow")
    out_path = os.path.join(workdir, "function_pass_cpu.arrow")
    table = batch_to_cpu(function_batch(batches, SD_FUNCTION_ROWS)).to_arrow()
    with pa.OSFile(path, "wb") as sink:
        with pa.ipc.new_file(sink, table.schema) as writer:
            writer.write_table(table)
    cpu = start_process(function_pass_cpu, path, out_path)
    oracle = start_process(function_oracle_values, path, SD_ORACLE_ROWS)

    def cpu_job():
        secs = receive_cpu_answers(*cpu, "strings_dates function pass CPU")
        with pa.memory_map(out_path) as src:
            return pa.ipc.open_file(src).read_all(), secs
    return cpu_job, oracle


def function_batch(batches, n):
    """One batch of the first ``n`` rows of each table's function-pass
    columns (views of the card's SF10 tables, a string's chars cut to its
    rows)."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.exec.basic import slice_batch
    cols = {}
    for table, names in SD_FUNCTION_COLUMNS.items():
        b = batches[table]
        head = slice_batch(b, [0, n, b.nrows])[0] if b.nrows > n else b
        for name in names:
            cols[name] = head.columns[name]
    return ColumnarBatch(cols, n)


def batch_to_cpu(batch):
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import Column
    cols = {}
    for k, c in batch.columns.items():
        off = None if c.offsets is None else c.offsets.cpu()
        data = c.data if off is None else c.data[:int(off[-1])]
        cols[k] = Column(c.dtype, data.cpu(), batch.nrows,
                         validity=None if c.validity is None
                         else c.validity.cpu(), offsets=off)
    return ColumnarBatch(cols, batch.nrows)


def _py_value(v):
    import datetime as dtm
    if isinstance(v, dtm.datetime):
        return v.replace(tzinfo=None)
    return v


def run_function_pass(torch, K, F, batches, card_line, total, cpu_job,
                      oracle_proc):
    """Every ported function over ``SD_FUNCTION_ROWS`` rows of the SF10
    columns on the card against the engine on the CPU (``cpu_job``: the
    CPU's arrow table, computed in a process meanwhile), exactly (floats
    within ``SD_FLOAT_RTOL``), and on the first ``SD_ORACLE_ROWS`` rows
    against Python (``oracle_proc``: the process computing Python's
    answers meanwhile)."""
    from spark_rapids_tpu_torch.api.session import TpuSession
    t0 = time.perf_counter()
    n = SD_FUNCTION_ROWS
    s = TpuSession(tpch_conf(True))
    exprs = function_exprs(F)
    df = s.create_dataframe(function_batch(batches, n)).select(
        *[e.alias(k) for k, e in exprs.items()])
    check(not fallback_nodes(s.plan(df.plan)),
          f"strings_dates function pass: all {len(exprs)} functions on the "
          "card")
    K.launches.reset()
    got = df.to_arrow()
    total.add(dict(K.launches.snapshot(),
                   by_shape=K.launches.shape_snapshot()))
    card_s = time.perf_counter() - t0
    s.stop()
    t1 = time.perf_counter()
    want, cpu_s = cpu_job()
    waited = time.perf_counter() - t1
    bad = []
    for name in exprs:
        g, w = got.column(name), want.column(name)
        if g.type != w.type:
            bad.append(f"{name}: type {g.type} vs {w.type}")
            continue
        ga = g.to_numpy(zero_copy_only=False)
        wa = w.to_numpy(zero_copy_only=False)
        if name == "months_between":
            ok = np.allclose(ga, wa, rtol=SD_FLOAT_RTOL, atol=0)
        else:
            ok = g.equals(w)
        if not ok:
            bad.append(name)
    check(not bad, f"strings_dates function pass: {len(exprs)} functions "
          f"over {n} rows of the SF10 columns, the card equals the CPU "
          f"(months_between within rel {SD_FLOAT_RTOL}) {bad}")
    # Python on the first rows
    t2 = time.perf_counter()
    m = SD_ORACLE_ROWS
    oracles, py_s = receive_cpu_answers(*oracle_proc,
                                        "strings_dates Python answers")
    wrong = []
    for name in oracles.column_names:
        exp = oracles.column(name)
        g = got.column(name)[:m]
        if name == "months_between":
            same = np.allclose(g.to_numpy(), exp.to_numpy(),
                               rtol=SD_FLOAT_RTOL, atol=0)
        else:
            g = g.cast(exp.type) if g.type != exp.type else g
            same = g.equals(exp)
        if not same:
            vals = [_py_value(v) for v in g.to_pylist()]
            want_vals = exp.to_pylist()
            first = next((i for i, (a, b) in enumerate(zip(vals, want_vals))
                          if a != b), 0)
            wrong.append(f"{name} row {first}: {vals[first]!r} vs "
                         f"{want_vals[first]!r}")
    check(not wrong and set(oracles.column_names) == set(exprs),
          f"strings_dates function pass: {len(oracles)} functions over the "
          f"first {m} rows equal Python's str, re, datetime and Murmur3 "
          f"{wrong}")
    print(f"strings_dates function pass: the card {card_s:.3f} s for "
          f"{len(exprs)} functions over {n} rows; the CPU's took "
          f"{cpu_s:.3f} s in a process (waited {waited:.3f} s for it), "
          f"Python's over {m} rows {py_s:.3f} s in a process (waited for "
          f"it and compared in {time.perf_counter() - t2:.3f} s)",
          flush=True)


def run_strings_dates(torch, K, fm, SD, batches, card_line, total,
                      cpu_proc, function_refs):
    """The strings_dates phase over the SF10 tables on the card: SD1-SD10
    in strict test mode (only each query's pinned fallback nodes), once
    warm and once timed (bit for bit), rows/s and host syncs; hash off
    over ``SD_HASH_OFF`` equal to hash on; the function pass (its
    references from ``function_refs``, :func:`start_function_pass`'s);
    SD1-SD10 at ``SD_CHECK_SF`` on the card equal to the engine on the CPU
    (from ``cpu_proc``, started before).  Returns the phase's seconds."""
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.utils.hostsync import host_sync_metrics
    t_phase = time.perf_counter()
    cpu_job, oracle_proc = function_refs
    sessions = {}

    def session(name, hash_on=True):
        key = (tuple(SD.FALLBACK_NODES[name]), hash_on)
        if key not in sessions:
            sessions[key] = sd_session(batches, hash_on, key[0])
        return sessions[key]

    answers, rates, syncs = {}, {}, {}
    for name in SD.QUERIES:
        s = session(name)
        held = {}

        def build(s=s, name=name):
            held["df"] = SD.run(F, s, name)
            return held["df"]
        rows = sum(batches[k].nrows for k in SD.TABLES[name])
        label = f"strings_dates {name}"
        got, launches, fus, rates[name] = drive(
            torch, K, fm, build, rows, card_line, label, reps=1,
            same_bits=True, extra={"host_syncs": host_sync_metrics})
        total.add(launches)
        answers[name] = got
        syncs[name] = fus["host_syncs"]
        nodes = sorted(type(n.node).__name__
                       for n in fallback_nodes(held["df"]._last_exec))
        check(nodes == sorted(SD.FALLBACK_NODES[name]),
              f"{label}: CpuFallbackExec nodes {nodes}, pinned "
              f"{SD.FALLBACK_NODES[name]}")
        sql_launch_line(label, got, launches, fus, SD.TABLES[name])
    for name in SD_HASH_OFF:
        off = SD.run(F, session(name, False), name).to_pandas()
        ok, why = frames_match(off, answers[name], QUERY_RTOL)
        check(ok, f"strings_dates {name}: hash off equals hash on (floats "
              f"within rel {QUERY_RTOL}) {why}")
    for s in sessions.values():
        s.stop()
    print("strings_dates rows/s on " + card_line + ": " + json.dumps(
        {k: float(f"{v:.6e}") for k, v in rates.items()}), flush=True)
    print("strings_dates host syncs: " + json.dumps(syncs), flush=True)
    run_function_pass(torch, K, F, batches, card_line, total, cpu_job,
                      oracle_proc)
    # at SF0.1 against the engine on the CPU
    t0 = time.perf_counter()
    small = device_tables(tpch.gen_table_columns(SD_CHECK_SF),
                          torch.device(DEVICE))
    got = {}
    for name in SD.QUERIES:
        s = sd_session(small, True, SD.FALLBACK_NODES[name])
        got[name] = SD.run(F, s, name).to_pandas()
        s.stop()
    want = receive_cpu_answers(*cpu_proc, f"strings_dates SF{SD_CHECK_SF}")
    for name in SD.QUERIES:
        ok, why = frames_match(got[name], want[name], QUERY_RTOL)
        check(ok, f"strings_dates SF{SD_CHECK_SF} {name}: the card equals "
              f"the CPU (floats within rel {QUERY_RTOL}) {why}")
    print(f"strings_dates SF{SD_CHECK_SF}: 10 queries on the card, then the "
          f"CPU's answers, in {time.perf_counter() - t0:.3f} s", flush=True)
    return time.perf_counter() - t_phase


# ----------------------------------------------------------------- nested --

ND_BUDGET_S = 60.0
ND_HASH_OFF = ("nd2", "nd3")               # rerun with the hash path off
ND_CHECK_SF = 0.1      # ND1-ND7 on the card against the engine on the CPU
ND_FILE_ROWS = 1 << 20  # ND4's parquet round trip: rows from lineitem


def nested_oracle(ND, cols):
    """``models/nested.references`` (numpy's answers of ND1-ND7 at SF10)
    on a thread: a function that waits for them, ``(refs, seconds)``
    (``profile_port.py``'s; ``chip_smoke.py`` computes them in the
    process that generates the tables)."""
    host = ND.host_columns({t: cols[t] for t in ("lineitem", "orders",
                                                 "supplier")})
    job = OnThread(lambda: ND.references(host))
    return lambda: (job.result(), job.seconds)


def nested_session(batches, name, hash_on=True, device=None):
    """A strict-mode session over the TPC-H views (and ``lineitem_map``)
    allowing only ``name``'s pinned fallback nodes."""
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.models import nested as ND
    s = sd_session(batches, hash_on, ND.FALLBACK_NODES[name], device)
    ND.register_map_view(F, s)
    return s


def nested_cpu_answers(sf, conn):
    """In a process of its own: ND1-ND7 and their SQL forms on the engine
    on the CPU at scale ``sf`` (the SF0.1 check's reference), as arrow
    tables."""
    import torch
    torch.set_num_threads(CPU_CHECK_THREADS)
    sys.path.insert(0, str(ROOT))
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.models import nested as ND
    from spark_rapids_tpu_torch.models import tpch
    try:
        batches = device_tables(tpch.gen_table_columns(sf), "cpu")
        out = {}
        for name in ND.NAMES:
            s = nested_session(batches, name, device="cpu")
            out[name] = ND.build(F, s, name).to_arrow()
            if name in ND.SQL:
                out[name + " sql"] = s.sql(ND.SQL[name]).to_arrow()
            s.stop()
        conn.send(out)
    except BaseException as exc:
        conn.send(exc)
        raise
    finally:
        conn.close()


def arrow_match(got, want, rtol, columns=None):
    """(equal, what differs) of two arrow tables over ``columns`` (all of
    ``want``'s by default): the same rows and order, float columns within
    ``rtol`` relative, every other column (arrays and structs included)
    exactly."""
    import pyarrow as pa
    columns = list(want.column_names) if columns is None else columns
    missing = [c for c in columns if c not in got.column_names]
    if missing or got.num_rows != want.num_rows:
        return False, (f"columns {got.column_names} x {got.num_rows} vs "
                       f"{want.column_names} x {want.num_rows}")
    for c in columns:
        g, w = got.column(c), want.column(c)
        if pa.types.is_floating(w.type):
            gv, wv = g.to_numpy(), w.to_numpy()
            if not np.allclose(gv, wv, rtol=rtol, atol=0, equal_nan=True):
                return False, f"{c}: floats differ past rel {rtol}"
        elif not g.equals(w):
            return False, f"{c}: differs"
    return True, ""


def nested_file_round_trip(F, s, workdir):
    """ND4's file check: a 2^20-row slice of lineitem with an array, a
    struct (one field a map) and a map column, written by the port to
    parquet and read back through its reader, equals what was written."""
    import os
    src = s.table("lineitem").limit(ND_FILE_ROWS).select(
        "l_orderkey", F.array("l_partkey", "l_suppkey").alias("keys"),
        F.struct("l_linenumber", "l_shipdate",
                 F.create_map(F.lit(1), F.col("l_quantity"))
                 .alias("qty")).alias("line"),
        F.create_map(F.lit(2), F.col("l_extendedprice"), F.lit(3),
                     F.col("l_discount")).alias("money"))
    path = os.path.join(workdir, "nested_parquet")
    t0 = time.perf_counter()
    want = src.to_arrow()
    src.write.mode("overwrite").parquet(path)
    got = s.read.parquet(path).to_arrow()
    check(got.num_rows == ND_FILE_ROWS and got.equals(want),
          f"nested parquet round trip: {got.num_rows} rows with array, "
          "struct and map columns read back equal to what was written")
    print(f"nested parquet round trip: {ND_FILE_ROWS} rows, columns "
          f"{[str(f.type) for f in got.schema]}, "
          f"{time.perf_counter() - t0:.3f} s", flush=True)


def run_nested(torch, K, fm, ND, batches, card_line, total, oracle,
               cpu_proc, workdir):
    """The nested phase over the SF10 tables on the card: ND1-ND7 in
    strict test mode (only ND7's pinned fallback nodes), each once warm
    and once timed (bit for bit), against numpy (``oracle()`` waits for
    its answers: ``(refs, seconds computing)``); ND2 and ND3
    with the hash path off; the SQL forms of ND1, ND4, ND5 and ND6 against
    their DataFrame forms; ND4's parquet round trip; every query at
    ``ND_CHECK_SF`` on the card against the engine on the CPU (from
    ``cpu_proc``).  Returns the phase's seconds."""
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.utils.hostsync import host_sync_metrics
    t_phase = time.perf_counter()
    sessions = {}

    def session(name, hash_on=True):
        key = (tuple(ND.FALLBACK_NODES[name]), hash_on)
        if key not in sessions:
            sessions[key] = nested_session(batches, name, hash_on)
        return sessions[key]

    t0 = time.perf_counter()
    refs, secs = oracle()
    print(f"nested: numpy's answers took {secs:.3f} s on the host; waited "
          f"{time.perf_counter() - t0:.3f} s for them", flush=True)
    answers, rates, syncs = {}, {}, {}
    for name in ND.NAMES:
        s = session(name)
        held = {}

        def build(s=s, name=name):
            held["df"] = ND.build(F, s, name)
            return held["df"]
        rows = sum(batches[k].nrows for k in ND.TABLES[name])
        label = f"nested {name}"
        got, launches, fus, rates[name] = drive(
            torch, K, fm, build, rows, card_line, label, reps=1,
            extra={"host_syncs": host_sync_metrics}, same_bits=True,
            arrow=True)
        total.add(launches)
        answers[name] = got
        syncs[name] = fus["host_syncs"]
        ok, why = ND.check(name, got, refs)
        check(ok, f"{label}: equals numpy (integers, keys, arrays and "
              f"order exactly, float sums within rel {ND.FLOAT_RTOL}) {why}")
        nodes = sorted(type(n.node).__name__
                       for n in fallback_nodes(held["df"]._last_exec))
        check(nodes == sorted(ND.FALLBACK_NODES[name]),
              f"{label}: CpuFallbackExec nodes {nodes}, pinned "
              f"{ND.FALLBACK_NODES[name]}")
        print(f"{label}: {got.num_rows} rows; launches "
              + ", ".join(f"{k} {launches[k]}" for k in launches
                          if k != "by_shape")
              + f"; hashKernelLaunches {fus['hashKernelLaunches']}, host "
              f"syncs {fus['host_syncs']}", flush=True)
    del refs
    for name in ND_HASH_OFF:
        off = ND.build(F, session(name, False), name).to_arrow()
        ok, why = arrow_match(off, answers[name], QUERY_RTOL)
        check(ok, f"nested {name}: hash off equals hash on (floats within "
              f"rel {QUERY_RTOL}) {why}")
    for name in ND.SQL:
        t0 = time.perf_counter()
        sql = session(name).sql(ND.SQL[name]).to_arrow()
        ok, why = arrow_match(sql, answers[name], QUERY_RTOL,
                              sql.column_names)
        check(ok, f"nested {name}: SQL equals the DataFrame form "
              f"(columns {sql.column_names}; floats within rel "
              f"{QUERY_RTOL}) {why}")
        print(f"nested {name} SQL: {sql.num_rows} rows in "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms", flush=True)
    nested_file_round_trip(F, session("nd4"), workdir)
    for s in sessions.values():
        s.stop()
    answers.clear()
    print("nested rows/s on " + card_line + ": " + json.dumps(
        {k: float(f"{v:.6e}") for k, v in rates.items()}), flush=True)
    print("nested host syncs: " + json.dumps(syncs), flush=True)
    # at SF0.1 against the engine on the CPU
    t0 = time.perf_counter()
    small = device_tables(tpch.gen_table_columns(ND_CHECK_SF),
                          torch.device(DEVICE))
    got = {}
    for name in ND.NAMES:
        s = nested_session(small, name)
        got[name] = ND.build(F, s, name).to_arrow()
        if name in ND.SQL:
            got[name + " sql"] = s.sql(ND.SQL[name]).to_arrow()
        s.stop()
    want = receive_cpu_answers(*cpu_proc, f"nested SF{ND_CHECK_SF}")
    for name in got:
        ok, why = arrow_match(got[name], want[name], QUERY_RTOL)
        check(ok, f"nested SF{ND_CHECK_SF} {name}: the card equals the CPU "
              f"(floats within rel {QUERY_RTOL}) {why}")
    print(f"nested SF{ND_CHECK_SF}: {len(got)} queries on the card, then "
          f"the CPU's answers, in {time.perf_counter() - t0:.3f} s",
          flush=True)
    return time.perf_counter() - t_phase


UDF_BUDGET_S = 60.0
UDF_WORKERS = 4          # UD3 again through the worker pool
UDF_CHECK_SF = 0.1       # UD1-UD9 on the card against the engine on the CPU
PYTHON_METRICS = ("argFetchTime", "pythonTime", "resultUploadTime")


def udf_session(batches, hash_on=True, workers=0, device=None):
    """A strict-mode session over the TPC-H views: the Python execs are
    device-side nodes, so no CPU fallback is allowed."""
    from spark_rapids_tpu_torch.api.session import TpuSession
    from spark_rapids_tpu_torch.models import tpch_sql
    conf = dict(tpch_conf(hash_on), **{
        "spark.rapids.sql.test.allowedNonTpu": "none",
        "spark.rapids.sql.python.numWorkers": workers})
    s = TpuSession(conf) if device is None else TpuSession(conf,
                                                           device=device)
    tpch_sql.register(s, {k: s.create_dataframe(b)
                          for k, b in batches.items()})
    return s


def udf_answers(F, UD, s):
    """UD1-UD9 on session ``s`` as arrow tables (UD8 over a cached
    slice)."""
    base = UD.lineitem_1995(F, s).cache()
    return {name: UD.build(F, s, name, base if name in UD.UD8 else None)
            .to_arrow() for name in UD.NAMES}


def udf_cpu_answers(sf, conn):
    """In a process of its own: UD1-UD9 on the engine on the CPU at scale
    ``sf`` (the SF0.1 check's reference)."""
    import torch
    torch.set_num_threads(CPU_CHECK_THREADS)
    sys.path.insert(0, str(ROOT))
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.models import udf as UD
    try:
        s = udf_session(device_tables(tpch.gen_table_columns(sf), "cpu"),
                        device="cpu")
        conn.send(udf_answers(F, UD, s))
        s.stop()
    except BaseException as exc:
        conn.send(exc)
        raise
    finally:
        conn.close()


def exec_nodes(plan):
    out, stack = [], [plan]
    while stack:
        node = stack.pop()
        out.append(node)
        stack.extend(node.children)
    return out


def python_ms(plan) -> dict:
    """Host ms of the plan's Python execs, per metric (the argument fetch,
    the Python code, the result upload)."""
    out = {m: 0.0 for m in PYTHON_METRICS}
    for node in exec_nodes(plan):
        for m in PYTHON_METRICS:
            if m in node.metrics:
                out[m] += node.metrics[m].value / 1e6
    return out


def run_udf(torch, K, fm, UD, batches, card_line, total, refs_fn, cpu_proc,
            q6_answer):
    """The udf phase over the SF10 tables on the card: UD1-UD9 in strict
    test mode, each once warm and once timed (bit for bit), against numpy
    and pandas (``refs_fn()`` waits for their answers: ``(refs, seconds
    computing)``); UD1 bit for bit equal to tpch22's q6
    (``q6_answer``); UD2 with the hash path off; UD3 with the worker pool
    (``UDF_WORKERS``) against inline, the pool run without degrading;
    UD4's torch function against the same query with columns; UD8's
    cached reads against the uncached plan, the cache's bytes and host
    ms; every query at ``UDF_CHECK_SF`` on the card against the engine on
    the CPU (from ``cpu_proc``).  Returns the phase's seconds."""
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.udf import worker_pool as WP
    from spark_rapids_tpu_torch.utils.hostsync import host_sync_metrics
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    refs, secs = refs_fn()
    print(f"udf: numpy's and pandas' answers took {secs:.3f} s on the "
          f"host; waited {time.perf_counter() - t0:.3f} s for them",
          flush=True)
    s = udf_session(batches)
    base = UD.lineitem_1995(F, s).cache()
    plain = UD.lineitem_1995(F, s)
    answers, rates, syncs, py_ms = {}, {}, {}, {}
    python_nodes = ("TpuArrowEvalPythonExec", "InPandasExec")
    for name in UD.NAMES:
        held = {}

        def build(name=name):
            held["df"] = UD.build(F, s, name,
                                  base if name in UD.UD8 else None)
            return held["df"]
        rows = sum(batches[k].nrows for k in UD.TABLES[name])
        label = f"udf {name}"
        got, launches, fus, rates[name] = drive(
            torch, K, fm, build, rows, card_line, label, reps=1,
            extra={"host_syncs": host_sync_metrics}, same_bits=True,
            arrow=True)
        total.add(launches)
        answers[name] = got
        syncs[name] = fus["host_syncs"]
        plan = held["df"]._last_exec
        tree = plan.tree_string()
        py_ms[name] = python_ms(plan)
        if name in UD.UD8:
            ok, why = arrow_match(got, UD.build(F, s, name, plain)
                                  .to_arrow(), PATH_RTOL)
            check(ok, f"{label}: the cached plan equals the uncached one "
                  f"(keys and counts exactly, float sums within rel "
                  f"{PATH_RTOL}) {why}")
            check("TpuCachedScanExec" in tree and
                  tree.count("TpuScanExec") == (name == "ud8c"),
                  f"{label}: the timed run read the cache (no lineitem "
                  "scan)")
        ok, why = UD.check(name, got, refs)
        check(ok, f"{label}: equals numpy / pandas (keys, counts and order "
              f"exactly, floats within rel {UD.FLOAT_RTOL}) {why}")
        n_eval = tree.count("TpuArrowEvalPythonExec")
        check(n_eval == (1 if name in UD.ARROW_EVAL else 0),
              f"{label}: {n_eval} TpuArrowEvalPythonExec in the plan")
        if name in ("ud1", "ud2", "ud4", "ud4c"):
            check(not any(p in tree for p in python_nodes),
                  f"{label}: no Python node in the plan")
        print(f"{label}: {got.num_rows} rows; launches "
              + ", ".join(f"{k} {launches[k]}" for k in launches
                          if k != "by_shape")
              + f"; host syncs {fus['host_syncs']}; Python nodes' host ms "
              + ", ".join(f"{k} {v:.3f}" for k, v in py_ms[name].items()),
              flush=True)
        if name == "ud8a":
            check("TpuMaterializeCacheExec" not in tree,
                  f"{label}: the timed run read the cache")
    entry = s.cache_manager.lookup(base.plan)
    print(f"udf ud8: cache {entry.cached_bytes} bytes compressed, "
          f"{entry.raw_bytes} raw, {len(entry.frames)} frames; host ms "
          f"framing {entry.frame_ns / 1e6:.3f}, restoring "
          f"{entry.restore_ns / 1e6:.3f} (over every read)", flush=True)
    base.unpersist()
    tree = s.plan(UD.build(F, s, "ud8b", base).plan).tree_string()
    check("Cache" not in tree, "udf ud8: no cache node after unpersist")
    # UD1 is tpch22's q6, bit for bit
    got = answers["ud1"].column("revenue").to_pylist()[0]
    check(float(got).hex() == float(q6_answer).hex(),
          f"udf ud1: revenue {got!r} equals tpch22's q6 {q6_answer!r} bit "
          "for bit")
    check(answers["ud4"].equals(answers["ud4c"]),
          "udf ud4: the torch function equals the columns' form bit for "
          "bit")
    s.stop()
    off = udf_session(batches, hash_on=False)
    ok, why = arrow_match(UD.build(F, off, "ud2").to_arrow(),
                          answers["ud2"], PATH_RTOL)
    check(ok, f"udf ud2: hash off equals hash on (floats within rel "
          f"{PATH_RTOL}) {why}")
    off.stop()
    pool = udf_session(batches, workers=UDF_WORKERS)
    for name in ("ud3g", "ud3x"):
        WP.pool_metrics.reset()
        t0 = time.perf_counter()
        got = UD.build(F, pool, name).to_arrow()
        snap = WP.pool_metrics.snapshot()
        check(got.equals(answers[name]),
              f"udf {name}: {UDF_WORKERS} workers equal inline bit for bit")
        check(snap["poolChunks"] >= UDF_WORKERS and
              snap["degradedToInline"] == 0,
              f"udf {name}: the pool ran ({snap}) and nothing degraded")
        print(f"udf {name} with {UDF_WORKERS} workers: "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms; pool {snap}",
              flush=True)
    pool.stop()
    WP.shutdown_pool()
    answers.clear()
    del refs
    print("udf rows/s on " + card_line + ": " + json.dumps(
        {k: float(f"{v:.6e}") for k, v in rates.items()}), flush=True)
    print("udf host syncs: " + json.dumps(syncs), flush=True)
    # at SF0.1 against the engine on the CPU
    t0 = time.perf_counter()
    small = device_tables(tpch.gen_table_columns(UDF_CHECK_SF),
                          torch.device(DEVICE))
    s = udf_session(small)
    got = udf_answers(F, UD, s)
    s.stop()
    want = receive_cpu_answers(*cpu_proc, f"udf SF{UDF_CHECK_SF}")
    for name in UD.NAMES:
        ok, why = arrow_match(got[name], want[name], QUERY_RTOL)
        check(ok, f"udf SF{UDF_CHECK_SF} {name}: the card equals the CPU "
              f"(floats within rel {QUERY_RTOL}) {why}")
    print(f"udf SF{UDF_CHECK_SF}: {len(got)} queries on the card, then the "
          f"CPU's answers, in {time.perf_counter() - t0:.3f} s", flush=True)
    return time.perf_counter() - t_phase


# ---------------------------------------------------------- serving phase --

SERVING_BUDGET_S = 75.0
# the TPC-H specification's Appendix A: the query order of throughput
# streams 1-3 (three streams is the minimum at SF10, section 5.3.4)
TPCH_STREAMS = {
    1: (21, 3, 18, 5, 11, 7, 6, 20, 17, 12, 16, 15, 13, 10, 2, 8, 14, 19,
        9, 22, 1, 4),
    2: (6, 17, 14, 16, 19, 10, 9, 2, 15, 8, 5, 22, 12, 7, 13, 18, 1, 4, 20,
        3, 11, 21),
    3: (8, 5, 4, 6, 17, 7, 1, 18, 22, 14, 9, 10, 15, 11, 20, 2, 21, 19, 13,
        16, 12, 3),
}
SV2_QUERIES = 2            # streams 1 and 2's first two, interleaved
# SV3: q3's guarded attempts (memory/retry's checkpoints) at SF10 in an
# uninjected run are 15 splittable ones, then the join build's keys,
# which cannot be split (33 in all): the OOM rule skips to that one
SV3_SKIP = 15
SV4_DEADLINE_MS = 2000     # SV4: q6's deadline budget (q6 takes ~50 ms)
SV6_QUERIES = ("q1", "q9")
SV6_POINTS = ("operator.batch", "hostsync.fetch", "admission.wait")


def check_no_recovery(label):
    """No query of the phase recorded a recovery action: with recovery on
    by default, this shows no device work was re-driven, and none was
    answered elsewhere (the ``cpu`` rung)."""
    from spark_rapids_tpu_torch.robustness.driver import recovery_metrics
    snap = recovery_metrics.snapshot()
    check(not snap, f"{label}: no query recorded a recovery action "
          f"(recovery_metrics {snap})")


def serving_session(batches, log_dir, **extra):
    """A strict-mode session at tpch22's conf (so its answers have
    tpch22's bits) with the event log in ``log_dir``."""
    from spark_rapids_tpu_torch.api.session import TpuSession
    return TpuSession(dict(tpch_conf(True), **{
        "spark.rapids.tpu.eventLog.dir": log_dir}, **extra))


def stream_tables(s, batches):
    """One client's DataFrames over the shared device tables."""
    return {k: s.create_dataframe(b) for k, b in batches.items()}


def query_starts(s):
    """(thread ident, queryId) of every QueryStart the session emits, in
    order: the single-device envelope emits it on the query's driving
    thread.  A query's own envelope is the last one its thread started
    before its collect returned; the scalar subqueries of q11, q15 and
    q22 run (in envelopes of their own) while the query is built."""
    import threading
    seen = []
    emit = s.events.emit

    def spy(event, **fields):
        if event == "QueryStart":
            seen.append((threading.get_ident(), fields["queryId"]))
        emit(event, **fields)
    s.events.emit = spy
    return seen


def run_threads(targets):
    """Start one thread per callable, join them, re-raise the first
    error; returns each thread's ident."""
    import threading
    errors, idents = [], {}

    def wrap(key, fn):
        idents[key] = threading.get_ident()
        try:
            fn()
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=wrap, args=(k, fn))
               for k, fn in targets.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return idents


def run_streams(tpch, s, batches, streams, starts):
    """Each stream's queries, in order, on a thread of its own, all
    streams at once: (answers, per-query walls, per-stream walls, each
    query's own query id by stream, the phase's wall).  ``starts``: the
    session's ``query_starts`` record."""
    import threading
    answers = {k: [] for k in streams}
    walls = {k: [] for k in streams}
    qids = {k: [] for k in streams}
    stream_s = {}
    tables = {k: stream_tables(s, batches) for k in streams}

    def stream(k):
        def run():
            me = threading.get_ident()
            t_stream = time.perf_counter()
            for name in streams[k]:
                t0 = time.perf_counter()
                answers[k].append((name, tpch.QUERIES[name](
                    tables[k]).to_pandas()))
                walls[k].append(time.perf_counter() - t0)
                qids[k].append(next((q for i, q in reversed(starts)
                                     if i == me), None))
            stream_s[k] = time.perf_counter() - t_stream
        return run

    t0 = time.perf_counter()
    run_threads({k: stream(k) for k in streams})
    return answers, walls, stream_s, qids, time.perf_counter() - t0


def memory_counters(torch, before=None):
    """The caching allocator's retries and OOMs, the operators' OOM
    retries and splits, and the peak reserved bytes (a delta from
    ``before``, the peak since it)."""
    from spark_rapids_tpu_torch.memory.retry import retry_metrics
    st = torch.cuda.memory_stats()
    now = {"allocRetries": st.get("num_alloc_retries", 0),
           "allocOoms": st.get("num_ooms", 0),
           **retry_metrics.snapshot()}
    if before is None:
        torch.cuda.reset_peak_memory_stats()
        return now
    out = {k: now[k] - before[k] for k in now}
    out["peakReservedBytes"] = torch.cuda.max_memory_reserved()
    return out


def check_stream_answers(label, answers, df_answers):
    for k, got in answers.items():
        for name, df in got:
            check(df.equals(df_answers[name]),
                  f"{label} stream {k} {name}: the answer equals tpch22's "
                  "bit for bit")


def attribute_streams(label, starts, qids, streams, app):
    """Each stream's queries have distinct query ids of their own, each
    with one QueryStart/QueryEnd pair of status success in the event
    log; every other envelope (a scalar subquery's) succeeded too.
    Returns the queries' own records."""
    every = [q for v in qids.values() for q in v]
    n = sum(len(v) for v in streams.values())
    check(None not in every and len(set(every)) == n,
          f"{label}: {n} distinct query ids, each stream's its own "
          f"({ {k: len(v) for k, v in qids.items()} })")
    ends = {q.query_id: q for q in app.queries}
    mine = [ends.get(q) for q in every]
    check(all(q is not None and q.status == "success" and q.start_ts
              and q.end_ts for q in mine),
          f"{label}: the event log holds a QueryStart/QueryEnd pair of "
          f"status success for each of the {n} queries")
    check(len(app.queries) == len(starts) and all(
        q.status == "success" for q in app.queries),
          f"{label}: all {len(app.queries)} envelopes ({n} queries and "
          f"{len(app.queries) - n} scalar subqueries) succeeded")
    return mine


def run_interleaved_scans(settings, batches, log_dir):
    """SV2's second half: two clients at once each scan lineitem for
    ``l_quantity <= 1`` under the fair interleaver.  Each of the scan's
    batches reaches the query's top, so both queries must pass the gate
    at every batch (timeslices of two or more each) and one of them must
    wait for the other's turn; the answers equal the same query's
    without the interleaver, bit for bit."""
    import threading
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.session import TpuSession
    from spark_rapids_tpu_torch.tools.eventlog import parse_event_log

    def scan(s):
        return s.create_dataframe(batches["lineitem"]).filter(
            F.col("l_quantity") <= 1).select("l_orderkey", "l_linenumber",
                                             "l_extendedprice")
    plain = TpuSession(dict(settings, **{
        "spark.rapids.tpu.serving.interleave.enabled": False,
        "spark.rapids.tpu.eventLog.dir": ""}))
    want = scan(plain).to_pandas()
    plain.stop()
    s = TpuSession(dict(settings, **{
        "spark.rapids.tpu.eventLog.dir": log_dir}))
    gate = threading.Barrier(2)
    got = {}

    def client(k):
        def run():
            df = scan(s)
            gate.wait()
            got[k] = df.to_pandas()
        return run
    run_threads({k: client(k) for k in ("A", "B")})
    path = s.events.path
    snap = s.interleaver.snapshot()
    s.stop()
    info = [q.sharing.get("interleave") or {}
            for q in parse_event_log(path).queries]
    check(all(got[k].equals(want) for k in ("A", "B")),
          f"serving SV2 scans: both interleaved answers ({len(want)} rows) "
          "equal the uninterleaved one bit for bit")
    check(len(info) == 2 and all(i.get("timeslices", 0) >= 2 for i in info)
          and sum(i.get("waitMs", 0.0) for i in info) > 0,
          f"serving SV2 scans: every batch of both passed the gate and one "
          f"waited for the other's turn ({info})")
    print(f"serving SV2 scans (two clients, lineitem l_quantity <= 1): "
          f"interleaver {snap}; per query {info}", flush=True)


def run_serving(torch, K, tpch, batches, df_answers, card_line, total,
                workdir):
    """The serving phase over the SF10 tables on the card (SV1-SV6):
    TPC-H's throughput test (three concurrent streams of the 22) through
    one session, the fair interleaver, the recovery ladder on a device
    OOM, the watchdog, admission's typed rejection, and span tracing.
    Returns the phase's seconds."""
    import os
    import tempfile
    from spark_rapids_tpu_torch.memory import retry as R
    from spark_rapids_tpu_torch.robustness import faults as FT
    from spark_rapids_tpu_torch.robustness import inject as I
    from spark_rapids_tpu_torch.robustness.driver import (
        QueryRetryDriver, recovery_metrics)
    from spark_rapids_tpu_torch.tools.eventlog import parse_event_log
    from spark_rapids_tpu_torch.tools.traceview import (
        load_trace, validate_chrome_trace)
    from spark_rapids_tpu_torch.utils import tracing
    t_phase = time.perf_counter()
    logs = tempfile.mkdtemp(prefix="serving_", dir=workdir)

    def log_dir(name):
        return os.path.join(logs, name)

    # SV1: the throughput test, three streams of the 22 at once
    streams = {k: [f"q{i}" for i in v] for k, v in TPCH_STREAMS.items()}
    s = serving_session(batches, log_dir("sv1"))
    starts = query_starts(s)
    metrics0 = recovery_metrics.snapshot()
    K.launches.reset()
    torch.cuda.synchronize()
    mem0 = memory_counters(torch)
    answers, walls, stream_s, qids, wall = run_streams(
        tpch, s, batches, streams, starts)
    torch.cuda.synchronize()
    mem = memory_counters(torch, mem0)
    launches = dict(K.launches.snapshot(),
                    by_shape=K.launches.shape_snapshot())
    total.add(launches)
    check_stream_answers("serving SV1", answers, df_answers)
    path = s.events.path
    s.stop()
    app = parse_event_log(path)
    mine = attribute_streams("serving SV1", starts, qids, streams, app)
    check(s.recovery_log == [] and recovery_metrics.snapshot() == metrics0,
          f"serving SV1: no query recorded a recovery action "
          f"(recovery_log {s.recovery_log}, recovery_metrics "
          f"{recovery_metrics.snapshot()})")
    for k in ("masked_multi_reduce", "hash_insert", "hash_probe"):
        check(launches[k] >= 1, f"serving SV1 launched {k} {launches[k]}x")
    waits = np.array([q.admission.get("waitMs", 0.0) for q in mine])
    print(f"serving SV1 TPC-H throughput SF{TPCH_SF}, {len(streams)} "
          f"streams x 22 on {card_line}: wall {wall:.3f} s; streams "
          + ", ".join(f"{k} {stream_s[k]:.3f} s" for k in sorted(stream_s))
          + f"; admission wait p50 {np.percentile(waits, 50):.3f} ms, p95 "
          f"{np.percentile(waits, 95):.3f} ms over {len(waits)} queries; "
          f"Throughput@Size {len(streams) * 22 * 3600 / wall * TPCH_SF:.3f}"
          f" (3 x 22 x 3600 / wall s x SF); launches "
          + ", ".join(f"{k} {launches[k]}" for k in K.launches.NAMES)
          + f"; memory {mem}", flush=True)
    for k in sorted(walls):
        print(f"serving SV1 stream {k} query walls (s): " + ", ".join(
            f"{name} {w:.3f}" for (name, _), w in
            zip(answers[k], walls[k])), flush=True)

    t_sv = {"SV1": time.perf_counter() - t_phase}

    # SV2: the fair interleaver, two streams' first queries at once (each
    # yields its answer as one batch, so the gate has nothing to order),
    # then two scans whose every batch passes the gate
    t0 = time.perf_counter()
    sub = {k: streams[k][:SV2_QUERIES] for k in (1, 2)}
    s = serving_session(batches, log_dir("sv2"), **{
        "spark.rapids.tpu.serving.interleave.enabled": True,
        "spark.rapids.tpu.serving.concurrentQueries": 2})
    starts = query_starts(s)
    K.launches.reset()
    answers, _, stream_s, qids, wall = run_streams(tpch, s, batches, sub,
                                                   starts)
    total.add(dict(K.launches.snapshot(),
                   by_shape=K.launches.shape_snapshot()))
    check_stream_answers("serving SV2", answers, df_answers)
    path = s.events.path
    snap = s.interleaver.snapshot()
    s.stop()
    app = parse_event_log(path)
    attribute_streams("serving SV2", starts, qids, sub, app)
    info = [q.sharing.get("interleave") for q in app.queries]
    check(all(i is not None and i["quantum"] >= 1 for i in info)
          and s.recovery_log == [],
          f"serving SV2: each of {len(info)} QueryEnds carries its "
          f"interleave info ({info}), no recovery action")
    print(f"serving SV2 interleaved ({SV2_QUERIES} of streams 1 and 2, "
          f"concurrentQueries 2): wall {wall:.3f} s; interleaver {snap}; "
          f"per query (gate wait ms, timeslices) "
          f"{[(i['waitMs'], i['timeslices']) for i in info]}", flush=True)
    run_interleaved_scans(s.conf.settings, batches, log_dir("sv2b"))
    check_no_recovery("serving SV1-SV2")
    t_sv["SV2"] = time.perf_counter() - t0

    # SV3: a device OOM past the operator retries enters the ladder.  The
    # rule skips to q3's first guarded attempt that cannot be split (a
    # join build's keys) and fails it once more than oomRetry.maxRetries
    t0 = time.perf_counter()
    s = serving_session(batches, log_dir("sv3"), **{
        "spark.rapids.sql.recovery.backoffMs": 0})
    df = tpch.q3(stream_tables(s, batches))
    skip = SV3_SKIP
    num = s.memory_catalog.max_retries + 1
    attempt = df._attempt_batches
    per_attempt = []

    def counted(mode):
        K.launches.reset()
        try:
            return attempt(mode)
        finally:
            per_attempt.append((mode.rung, K.launches.snapshot()))
    df._attempt_batches = counted
    R.inject_oom(num, skip=skip)
    try:
        got = df.to_pandas()
    finally:
        R.clear_injected_oom()
    trail = list(s.recovery_log)
    s.stop()
    rungs = [r["action"] for r in trail]
    escaped = trail[0]["error"].split(":")[0] if trail else "nothing"
    want_rung = QueryRetryDriver._entry_rung(FT.classify(
        R.SplitAndRetryOOM("x") if escaped == "SplitAndRetryOOM"
        else R.InjectedOomError("x")))
    print(f"serving SV3 q3 with {num} injected OOMs after {skip} guarded "
          f"attempts: {escaped} escaped the operator retries; trail "
          f"{[(r['action'], r['fault']) for r in trail]}; launches by "
          f"attempt {per_attempt}", flush=True)
    check(rungs and rungs[0] == want_rung and "cpu" not in rungs,
          f"serving SV3: the trail {rungs} starts at the {want_rung!r} "
          "rung _entry_rung gives the escaped fault and never reaches cpu")
    check(got.equals(df_answers["q3"]),
          "serving SV3: q3's answer equals tpch22's bit for bit")
    check(per_attempt[-1][1]["hash_insert"] >= 1,
          f"serving SV3: the successful attempt launched hash_insert "
          f"{per_attempt[-1][1]['hash_insert']}x")

    t_sv["SV3"] = time.perf_counter() - t0

    # SV4: the watchdog trips a wedged q6, the retry answers
    t0 = time.perf_counter()
    s = serving_session(batches, log_dir("sv4"), **{
        "spark.rapids.sql.recovery.backoffMs": 0,
        "spark.rapids.tpu.serving.deadlineBudgetMs": SV4_DEADLINE_MS})
    df = tpch.q6(stream_tables(s, batches))
    q6_plan = df.plan.tree_string()
    rule = I.inject("memory.oom", kind="delay", delay_s=None, count=1)
    t0 = time.perf_counter()
    try:
        got = df.to_pandas()
    finally:
        I.remove(rule)
    sv4_s = time.perf_counter() - t0
    trail = [(r["action"], r["fault"]) for r in s.recovery_log]
    path = s.events.path
    s.stop()
    app = parse_event_log(path)
    tripped = [q for q in app.queries
               if any(w.get("kind") == "trip" for w in q.watchdog)]
    check(rule.fired == 1 and trail == [("retry", "timeout")],
          f"serving SV4: a TimeoutFault, then the retry rung ({trail})")
    check(got.equals(df_answers["q6"]),
          "serving SV4: q6's answer equals tpch22's bit for bit")
    check(len(tripped) == 1 and tripped[0].status.startswith(
        "failed: TimeoutFault") and tripped[0].logical_plan == q6_plan,
          f"serving SV4: the WatchdogTrip event carries q6's queryId "
          f"({[(q.query_id, q.status[:40]) for q in app.queries]})")
    print(f"serving SV4 q6 wedged under a {SV4_DEADLINE_MS} ms deadline: "
          f"{sv4_s:.3f} s to the answer; trip {tripped[0].watchdog}",
          flush=True)

    t_sv["SV4"] = time.perf_counter() - t0

    # SV5: admission's typed rejection while the slot is wedged
    t0 = time.perf_counter()
    s = serving_session(batches, log_dir("sv5"), **{
        "spark.rapids.tpu.serving.concurrentQueries": 1,
        "spark.rapids.tpu.serving.maxQueuedQueries": 1})
    import threading
    results, rules, errors = {}, {}, []
    armed = threading.Event()

    def client(name):
        """Client ``name``'s q6 on a thread of its own; A arms a delay
        rule keyed to its own queries and holds the slot wedged on it."""
        def run():
            try:
                with I.scoped_rules(key=name):
                    if name == "A":
                        rules["A"] = I.inject(
                            "memory.oom", kind="delay", delay_s=None,
                            count=1, all_threads=True)
                        armed.set()
                    results[name] = tpch.q6(stream_tables(s, batches)) \
                        .to_pandas()
            except BaseException as exc:  # noqa: BLE001 - checked below
                errors.append(exc)
                armed.set()
        t = threading.Thread(target=run)
        t.start()
        return t

    def wait_for(cond):
        ev = threading.Event()
        while not cond() and not errors:
            ev.wait(0.005)

    holder = client("A")
    armed.wait()
    wait_for(lambda: rules["A"].fired == 1)
    queued = client("B")
    wait_for(lambda: s.admission.snapshot()["queued"] == 1)
    refused = None
    try:
        tpch.q6(stream_tables(s, batches)).to_pandas()
    except BaseException as exc:  # noqa: BLE001 - checked below, after A
        refused = exc             # is disarmed
    if "A" in rules:
        I.remove(rules["A"])
    holder.join()
    queued.join()
    path = s.events.path
    s.stop()
    app = parse_event_log(path)
    check(not errors, f"serving SV5: A and B ran without error {errors}")
    check(isinstance(refused, FT.AdmissionFault)
          and refused.reason == "queue-full" and FT.classify(refused).fatal,
          f"serving SV5: C refused at arrival with a FATAL AdmissionFault "
          f"({refused!r})")
    check(s.recovery_log == [] and [r["reason"] for r in app.rejections]
          == ["queue-full"],
          f"serving SV5: no recovery action, one AdmissionReject event "
          f"({app.rejections})")
    check(all(results[k].equals(df_answers["q6"]) for k in ("A", "B")),
          "serving SV5: A and B answer q6 bit for bit once A's rule is "
          "disarmed")
    print(f"serving SV5 admission: {s.admission.snapshot()}", flush=True)

    t_sv["SV5"] = time.perf_counter() - t0

    # SV6: span tracing, answers the same bits
    t0 = time.perf_counter()
    s = serving_session(batches, log_dir("sv6"), **{
        "spark.rapids.tpu.trace.enabled": True,
        "spark.rapids.tpu.trace.dir": log_dir("traces")})
    t = stream_tables(s, batches)
    K.launches.reset()
    got = {q: tpch.QUERIES[q](t).to_pandas() for q in SV6_QUERIES}
    total.add(dict(K.launches.snapshot(),
                   by_shape=K.launches.shape_snapshot()))
    path = s.events.path
    s.stop()
    tracing.configure(False)
    app = parse_event_log(path)
    for q in SV6_QUERIES:
        check(got[q].equals(df_answers[q]),
              f"serving SV6 {q}: traced, the answer equals tpch22's bit "
              "for bit")
    for q in app.queries:
        obj = load_trace(q.spans["traceFile"])
        bad = validate_chrome_trace(obj)
        check(not bad, f"serving SV6 query {q.query_id}: its Chrome trace "
              f"parses and validates {bad[:3]}")
        pts = set(q.spans["points"])
        check(set(SV6_POINTS) <= pts,
              f"serving SV6 query {q.query_id}: spans include "
              f"{SV6_POINTS} ({sorted(pts)})")
        top = sorted(q.spans["points"].items(),
                     key=lambda kv: -kv[1]["exclusiveMs"])[:6]
        print(f"serving SV6 query {q.query_id} spans (host wall clock) on "
              f"{card_line}: wall {q.spans['wallMs']} ms, unattributed "
              f"{q.spans['unattributedFrac']}; " + ", ".join(
                  f"{k} {v['exclusiveMs']} ms ({v['count']}x)"
                  for k, v in top), flush=True)
    recovery_metrics.reset()  # SV3 and SV4's actions were injected
    t_sv["SV6"] = time.perf_counter() - t0
    secs = time.perf_counter() - t_phase
    print(f"serving phase by part on {card_line}: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in t_sv.items())
        + f"; {secs:.3f} s in all against SERVING_BUDGET_S "
        f"{SERVING_BUDGET_S} s", flush=True)
    return secs


# ------------------------------------------------------------ reuse phase --

REUSE_BUDGET_S = 45.0
REUSE_EXACT = ("q3", "q6", "q18")   # RU1: a miss, then a hit, each
REUSE_CHECK_SF = 0.1                 # RU1's parquet copy of lineitem
# RU2: five bindings of q6's date range, discount range and quantity (the
# specification's first)
RU2_BINDINGS = (
    ((1994, 1, 1), (1995, 1, 1), 0.05, 0.07, 24.0),
    ((1995, 1, 1), (1996, 1, 1), 0.04, 0.06, 25.0),
    ((1993, 1, 1), (1994, 1, 1), 0.06, 0.08, 24.0),
    ((1996, 1, 1), (1997, 1, 1), 0.02, 0.04, 23.0),
    ((1997, 1, 1), (1998, 1, 1), 0.07, 0.09, 25.0))
RU3_QUERY = "q9"      # seven exchange stages, as many as q5's
RU3_FAULT_SKIP = 2    # the OOM comes as the third stage's frame is saved
RU4_CUT = (1998, 9, 2)


class _SaveClock:
    """Host time inside ``CheckpointManager.save`` (the lineage log's
    writes: registering a stage's frame and launching its stamp)."""

    ns = 0
    installed = False

    @classmethod
    def install(cls):
        if cls.installed:
            return
        from spark_rapids_tpu_torch.robustness.checkpoint import (
            CheckpointManager)
        real = CheckpointManager.save

        def timed(self, *a, **k):
            t0 = time.perf_counter_ns()
            try:
                return real(self, *a, **k)
            finally:
                cls.ns += time.perf_counter_ns() - t0
        CheckpointManager.save = timed
        cls.installed = True


def ckpt_watch():
    """The checkpoint counters and save time now (``ckpt_report``)."""
    from spark_rapids_tpu_torch.robustness.checkpoint import (
        checkpoint_metrics)
    _SaveClock.install()
    return checkpoint_metrics.snapshot(), _SaveClock.ns


def ckpt_report(label, before, card_line):
    """The default-on lineage log's writes, bytes and save time since
    ``before``; a clean phase resumes nothing and drops nothing."""
    from spark_rapids_tpu_torch.robustness.checkpoint import (
        checkpoint_metrics)
    snap0, ns0 = before
    snap = checkpoint_metrics.snapshot()
    d = {k: snap[k] - snap0[k] for k in snap}
    print(f"checkpoints in {label} on {card_line}: {d['writes']} writes, "
          f"{d['bytesWritten']} bytes, {d['evictions']} evictions, saves "
          f"{(_SaveClock.ns - ns0) / 1e6:.3f} host ms", flush=True)
    check(d["resumes"] == 0 and d["invalid"] == 0,
          f"{label}: no checkpoint resumed or dropped ({d})")


def reuse_q6(F, t, d0, d1, lo, hi, qty):
    """TPC-H q6 with its five literals as arguments: for the
    specification's values the expression of ``models/tpch.q6``."""
    import datetime
    l = t["lineitem"]
    return (l.filter(
        (F.col("l_shipdate") >= F.lit(datetime.date(*d0))) &
        (F.col("l_shipdate") < F.lit(datetime.date(*d1))) &
        (F.col("l_discount") >= lo) & (F.col("l_discount") <= hi) &
        (F.col("l_quantity") < qty))
        .select((F.col("l_extendedprice") * F.col("l_discount"))
                .alias("rev"))
        .agg(F.sum("rev").alias("revenue")))


def reuse_ru4(F, t, ordered):
    """RU4's pair over lineitem: a scan, filter and partial aggregate,
    and the same subtree under a sort."""
    import datetime
    agg = (t["lineitem"]
           .filter(F.col("l_shipdate") <= F.lit(datetime.date(*RU4_CUT)))
           .groupBy("l_returnflag", "l_linestatus")
           .agg(F.sum("l_quantity").alias("sum_qty"),
                F.sum("l_extendedprice").alias("sum_base_price"),
                F.count("l_quantity").alias("count_order")))
    return agg.orderBy("l_returnflag", "l_linestatus") if ordered else agg


def fresh_copy(batch):
    """``batch`` with every buffer copied: equal values, other objects."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import Column

    def copy(t):
        return None if t is None else t.clone()
    return ColumnarBatch({
        n: Column(c.dtype, copy(c.data), c.row_count, copy(c.validity),
                  copy(c.offsets), c.dictionary)
        for n, c in batch.columns.items()}, batch.row_count)


def no_launch(K):
    snap = K.launches.snapshot()
    return all(snap[k] == 0 for k in K.launches.NAMES), snap


def cached_run(torch, K, query, s, label, want):
    """A run the result cache must answer: no operator, no kernel
    launch, the stored answer bit for bit.  Returns (ms, host syncs)."""
    from spark_rapids_tpu_torch.utils.hostsync import host_sync_metrics
    K.launches.reset()
    host_sync_metrics.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = (query() if callable(query) else query).to_pandas()
    ms = (time.perf_counter() - t0) * 1e3
    syncs = host_sync_metrics.snapshot()
    none, snap = no_launch(K)
    check(s.last_dist_explain.endswith("cache hit"),
          f"{label}: answered by the result cache "
          f"({s.last_dist_explain!r})")
    check(none, f"{label}: the hit launched no kernel ({snap})")
    check(got.equals(want), f"{label}: the hit's answer equals the "
          "stored one bit for bit")
    return ms, syncs


def run_reuse(torch, K, fm, tpch, batches, df_answers, card_line,
              launches, workdir):
    """The reuse phase over the tpch22 tables (its answers are this run's
    ``df_answers``): RU1 the result cache's exact tier, RU2 plan
    templates and a prepared q6, RU3 a sharded resume from stage
    checkpoints, RU4 the shared stage store over NSHARDS logical shards.
    Returns the phase's seconds."""
    import os
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.session import TpuSession
    from spark_rapids_tpu_torch.robustness import inject as I
    from spark_rapids_tpu_torch.robustness.checkpoint import (
        checkpoint_metrics)
    from spark_rapids_tpu_torch.robustness.driver import (
        QueryRetryDriver, recovery_metrics)
    t_phase = time.perf_counter()
    parts = {}
    cache_conf = dict(tpch_conf(True), **{
        "spark.rapids.tpu.serving.resultCache.enabled": True})

    # RU1: q3, q6 and q18 miss then hit; equal values in new batches
    # miss; over parquet a rewritten file misses
    t0 = time.perf_counter()
    s = TpuSession(cache_conf)
    tables = {k: s.create_dataframe(b) for k, b in batches.items()}
    for name in REUSE_EXACT:
        label = f"reuse RU1 {name} SF{TPCH_SF}"
        read = ReadTables(tables)
        q = tpch.QUERIES[name](read)
        rows = sum(batches[k].nrows for k in read.read)
        snap0 = s.result_cache.snapshot()
        got, lq, _, rate = drive(torch, K, fm, q, rows, card_line,
                                 f"{label} (miss)", reps=0)
        snap1 = s.result_cache.snapshot()
        check(snap1["misses"] == snap0["misses"] + 1
              and snap1["hits"] == snap0["hits"],
              f"{label}: the first run is a miss ({snap1})")
        check(got.equals(df_answers[name]),
              f"{label}: the miss equals tpch22's answer bit for bit")
        want = "masked_multi_reduce" if name == "q6" else "hash_insert"
        check(lq[want] >= 1, f"{label}: the miss launched {want} ({lq})")
        launches.add(lq)
        ms, syncs = cached_run(torch, K, lambda n=name: tpch.QUERIES[n](
            tables), s, f"{label} (hit)", df_answers[name])
        print(f"{label}: miss {rows / rate * 1e3:.3f} ms, launches "
              + ", ".join(f"{k} {lq[k]}" for k in K.launches.NAMES)
              + f"; hit {ms:.3f} ms, {syncs} host syncs, no launch, on "
              f"{card_line}", flush=True)
    snap0 = s.result_cache.snapshot()
    fresh = {"lineitem": s.create_dataframe(fresh_copy(batches["lineitem"]))}
    li_rows = batches["lineitem"].nrows
    got, lq, _, _ = drive(torch, K, fm, tpch.q6(fresh), li_rows, card_line,
                          "reuse RU1 q6 over new batches", reps=0)
    snap1 = s.result_cache.snapshot()
    check(snap1["hits"] == snap0["hits"]
          and snap1["misses"] == snap0["misses"] + 1
          and lq["masked_multi_reduce"] >= 1,
          f"reuse RU1 q6 over new batches of equal values: a miss "
          f"({snap0} -> {snap1}, launches {lq})")
    check(got.equals(df_answers["q6"]),
          "reuse RU1 q6 over new batches: tpch22's answer bit for bit")
    launches.add(lq)
    del fresh
    s.stop()
    del tables
    # a parquet copy of lineitem at SF0.1
    root = os.path.join(workdir, "reuse_lineitem")
    s = TpuSession(tpch_conf(True))
    cols = tpch.gen_table_columns(REUSE_CHECK_SF)["lineitem"]
    n_file = len(cols["l_orderkey"][1])
    s.create_dataframe(device_tables({"l": cols}, s.device)["l"]) \
        .write.parquet(root)
    s.stop()
    del cols
    s = TpuSession(cache_conf)

    def over_files():
        return tpch.q6({"lineitem": s.read.parquet(root)})
    label = f"reuse RU1 q6 over SF{REUSE_CHECK_SF} parquet"
    want, lq, _, _ = drive(torch, K, fm, over_files, n_file, card_line,
                           f"{label} (miss)", reps=0)
    launches.add(lq)
    cached_run(torch, K, over_files, s, f"{label} (hit)", want)
    path = sorted(os.path.join(root, f) for f in os.listdir(root)
                  if f.endswith(".parquet"))[0]
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob)
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
    snap0 = s.result_cache.snapshot()
    got, lq, _, _ = drive(torch, K, fm, over_files, n_file, card_line,
                          f"{label} after a rewrite", reps=0)
    snap1 = s.result_cache.snapshot()
    check(snap1["invalidations"] == snap0["invalidations"] + 1
          and snap1["hits"] == snap0["hits"]
          and lq["masked_multi_reduce"] >= 1 and got.equals(want),
          f"{label}: a rewritten file (new mtime) is a miss, invalidated, "
          f"and the same answer ({snap0} -> {snap1})")
    launches.add(lq)
    s.stop()
    parts["RU1"] = time.perf_counter() - t0

    # RU2: q6 prepared, under five bindings, against the inline q6; then
    # with the exact tier alone (a prepared run skips it: its plan holds
    # the literals of prepare time) and with the template tier
    t0 = time.perf_counter()
    tpl = dict(tpch_conf(True), **{"spark.rapids.tpu.template.enabled": True})
    plain = TpuSession(tpch_conf(True))
    pt = {"lineitem": plain.create_dataframe(batches["lineitem"])}
    inline = {b: reuse_q6(F, pt, *b).to_pandas() for b in RU2_BINDINGS}
    check(inline[RU2_BINDINGS[0]].equals(df_answers["q6"]),
          "reuse RU2: the inline q6 builder equals TPC-H q6")
    plain.stop()
    for mode in ("none", "exact", "template"):
        with_cache = mode == "template"
        conf = dict(tpl, **({
            "spark.rapids.tpu.serving.resultCache.enabled": True,
            "spark.rapids.tpu.template.resultCache.enabled": with_cache}
            if mode != "none" else {}))
        s = TpuSession(conf)
        t = {"lineitem": s.create_dataframe(batches["lineitem"])}
        h = s.prepare(reuse_q6(F, t, *RU2_BINDINGS[0]))
        check(h.param_count == 5 and not h.refusals,
              f"reuse RU2: q6 prepared with 5 parameters ({h.describe()})")
        plans = []
        real_plan = s.plan
        s.plan = lambda *a, **k: (plans.append(1), real_plan(*a, **k))[1]
        order = {"none": RU2_BINDINGS,
                 "exact": RU2_BINDINGS[:2] + RU2_BINDINGS[:1],
                 "template": RU2_BINDINGS[:2] + RU2_BINDINGS[:2]}[mode]
        for i, b in enumerate(order):
            label = (f"reuse RU2 prepared q6 SF{TPCH_SF} binding "
                     f"{RU2_BINDINGS.index(b)}"
                     + {"none": "", "exact": " (exact tier only)",
                        "template": " (template cache)"}[mode])
            repeat = with_cache and i >= 2
            if repeat:
                cached_run(torch, K, lambda b=b: _PreparedRun(h, b), s,
                           label, inline[b])
                continue
            got, lq, _, _ = drive(torch, K, fm,
                                  lambda b=b: _PreparedRun(h, b),
                                  batches["lineitem"].nrows, card_line,
                                  label, reps=0)
            check(lq["masked_multi_reduce"] >= 1,
                  f"{label}: launched masked_multi_reduce ({lq})")
            check(np.float64(got["revenue"][0]).tobytes()
                  == np.float64(inline[b]["revenue"][0]).tobytes(),
                  f"{label}: equals the inline-literal q6 bit for bit "
                  f"({got['revenue'][0]!r} vs {inline[b]['revenue'][0]!r})")
            launches.add(lq)
        check(not plans, f"reuse RU2: the prepared runs planned nothing "
              f"({len(plans)} calls into session.plan)")
        if mode == "exact":
            snap = s.result_cache.snapshot()
            check(snap["hits"] == 0 and snap["stores"] == 0,
                  f"reuse RU2: a prepared run keys no exact-tier entry, "
                  f"so no binding is served another's answer ({snap})")
        if with_cache:
            snap = s.result_cache.snapshot()
            check(snap["templateHits"] == 2 and snap["templateStores"] == 2,
                  f"reuse RU2: repeated bindings hit, two bindings two "
                  f"entries ({snap})")
            check(inline[RU2_BINDINGS[0]]["revenue"][0]
                  != inline[RU2_BINDINGS[1]]["revenue"][0],
                  "reuse RU2: the two bindings' answers differ")
        s.stop()
    parts["RU2"] = time.perf_counter() - t0

    # RU3: sharded q9, an OOM as its third stage is saved; the spill
    # rung's re-attempt resumes from the first two
    t0 = time.perf_counter()
    s = TpuSession(sharded_conf(tpch_conf(True)))
    read = ReadTables({k: s.create_dataframe(b) for k, b in batches.items()})
    q = tpch.QUERIES[RU3_QUERY](read)
    rows = sum(batches[k].nrows for k in read.read)
    label = f"reuse RU3 sharded {RU3_QUERY} SF{TPCH_SF}"
    ck0 = checkpoint_metrics.snapshot()
    t1 = time.perf_counter()
    clean, lc, _, _ = drive(torch, K, fm, q, rows, card_line,
                            f"{label} (clean)", reps=0)
    clean_s = time.perf_counter() - t1
    ck1 = checkpoint_metrics.snapshot()
    ok, why = frames_match(clean, df_answers[RU3_QUERY], QUERY_RTOL)
    check(ok and s.last_dist_explain == "distributed",
          f"{label}: ran distributed and equals tpch22's answer {why}")
    launches.add(lc)
    writes = ck1["writes"] - ck0["writes"]
    at = {}
    real_spill = QueryRetryDriver._spill_device_store

    def between_attempts(self):
        at["launches"] = K.launches.snapshot()
        at["t"] = time.perf_counter()
        real_spill(self)
    resumed = {}
    for corrupt in (False, True):
        tag = "corrupt restore" if corrupt else "resume"
        s.recovery_log.clear()
        ck0 = checkpoint_metrics.snapshot()
        rules = [I.inject("checkpoint.write", count=1, skip=RU3_FAULT_SKIP,
                          exc=torch.OutOfMemoryError)]
        if corrupt:
            rules.append(I.inject("checkpoint.restore", kind="corrupt",
                                  count=1))
        QueryRetryDriver._spill_device_store = between_attempts
        try:
            got, lr, _, _ = drive(torch, K, fm, q, rows, card_line,
                                  f"{label} ({tag})", reps=0)
            end = time.perf_counter()
        finally:
            QueryRetryDriver._spill_device_store = real_spill
            for r in rules:
                I.remove(r)
        ck1 = checkpoint_metrics.snapshot()
        d = {k: ck1[k] - ck0[k] for k in ck1}
        first = at["launches"]
        second = {k: lr[k] - first[k] for k in K.launches.NAMES}
        actions = [r["action"] for r in s.recovery_log]
        check(actions == ["spill"],
              f"{label} ({tag}): one recovery action, spill ({actions})")
        check(got.equals(clean),
              f"{label} ({tag}): equals the clean sharded answer bit for "
              "bit")
        if corrupt:
            check(d["invalid"] >= 1
                  and d["stagesSkipped"] < resumed["stagesSkipped"],
                  f"{label} ({tag}): the rotten checkpoint dropped "
                  f"(CheckpointInvalid) and its subtree re-ran ({d}; the "
                  f"clean resume skipped {resumed['stagesSkipped']})")
        else:
            resumed = d
            check(d["resumes"] >= 1 and d["stagesSkipped"] >= 1
                  and second["partition_histogram"]
                  < lc["partition_histogram"],
                  f"{label} ({tag}): resumed ({d}) with fewer "
                  f"partition_histogram launches than a clean run "
                  f"({second['partition_histogram']} vs "
                  f"{lc['partition_histogram']})")
        launches.add(lr)
        print(f"{label} ({tag}) on {card_line}: clean run {clean_s:.3f} s "
              f"with {writes} checkpoint writes; the re-attempt (spill "
              f"rung included) {end - at['t']:.3f} s, launches "
              + json.dumps(second) + f" against the clean run's "
              + json.dumps({k: lc[k] for k in K.launches.NAMES})
              + f"; checkpoint counters {d}", flush=True)
    s.stop()
    del read, q
    check(not recovery_metrics.snapshot().keys() - {"spill"},
          f"reuse RU3: only the injected spill rungs "
          f"({recovery_metrics.snapshot()})")
    recovery_metrics.reset()  # RU3's actions were injected
    parts["RU3"] = time.perf_counter() - t0

    # RU4: two sharded queries sharing lineitem's scan, filter and
    # partial aggregate; the second splices the first's stage
    t0 = time.perf_counter()
    off_s = TpuSession(sharded_conf(tpch_conf(True)))
    off = {k: off_s.create_dataframe(batches[k]) for k in ("lineitem",)}
    want_a, la_off, _, _ = drive(torch, K, fm, reuse_ru4(F, off, False),
                                 li_rows,
                                 card_line, "reuse RU4 A (store off)",
                                 reps=0)
    want_b, lb_off, _, _ = drive(torch, K, fm, reuse_ru4(F, off, True),
                                 li_rows,
                                 card_line, "reuse RU4 B (store off)",
                                 reps=0)
    off_s.stop()
    launches.add(la_off)
    launches.add(lb_off)
    s = TpuSession(dict(sharded_conf(tpch_conf(True)), **{
        "spark.rapids.tpu.serving.sharedStage.enabled": True}))
    on = {k: s.create_dataframe(batches[k]) for k in ("lineitem",)}
    got_a, la, _, _ = drive(torch, K, fm, reuse_ru4(F, on, False),
                            li_rows,
                            card_line, "reuse RU4 A (store on)", reps=0)
    got_b, lb, _, _ = drive(torch, K, fm, reuse_ru4(F, on, True),
                            li_rows,
                            card_line, "reuse RU4 B (store on)", reps=0)
    snap = s.shared_stages.snapshot()
    check(got_a.equals(want_a) and got_b.equals(want_b),
          "reuse RU4: both answers equal their store-off answers bit for "
          "bit")
    check(snap["resumes"] >= 1 and
          lb["partition_histogram"] < lb_off["partition_histogram"],
          f"reuse RU4: B spliced A's stage ({snap}) with fewer launches "
          f"(partition_histogram {lb['partition_histogram']} vs "
          f"{lb_off['partition_histogram']} with the store off)")
    launches.add(la)
    launches.add(lb)
    print(f"reuse RU4 on {card_line}: shared store {snap}; B's launches "
          + json.dumps({k: lb[k] for k in K.launches.NAMES})
          + " against " + json.dumps({k: lb_off[k]
                                      for k in K.launches.NAMES})
          + " with the store off", flush=True)
    s.stop()
    parts["RU4"] = time.perf_counter() - t0
    check_no_recovery("reuse RU4")
    secs = time.perf_counter() - t_phase
    print(f"reuse phase by part on {card_line}: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in parts.items())
        + f"; {secs:.3f} s in all against REUSE_BUDGET_S "
        f"{REUSE_BUDGET_S} s", flush=True)
    return secs


def _bind(b):
    import datetime
    d0, d1, lo, hi, qty = b
    return (datetime.date(*d0), datetime.date(*d1), lo, hi, qty)


class _PreparedRun:
    """A prepared q6 run under binding ``b``, shaped as ``drive`` reads a
    DataFrame (``to_pandas``)."""

    def __init__(self, handle, b):
        self.handle, self.b = handle, b

    def to_pandas(self):
        return self.handle.run_pandas(*_bind(self.b))


def tpcds_device_tables(data, device):
    """Every TPC-DS table (pandas, from ``tpcds.gen_tables``) as one
    batch on ``device``, through arrow as ``create_dataframe`` takes it."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    return {name: ColumnarBatch.from_pandas(df, device=device)
            for name, df in data.items()}


def tpcds_session(conf, batches):
    """A session with every TPC-DS table registered as a view over the
    shared device batches."""
    from spark_rapids_tpu_torch.api.session import TpuSession
    s = TpuSession(conf, device=next(iter(batches.values())).device)
    for name, b in batches.items():
        s.create_dataframe(b).createOrReplaceTempView(name)
    return s


def run_tpcds(torch, K, fm, tpcds, batches, card_line, total,
              reps=TPCDS_REPS):
    """The 29 TPC-DS queries through ``session.sql`` on the card, hash on:
    launches, hash overflow fallbacks and host syncs of the warm run (the
    main path's), rows/s over the median of ``reps`` timed runs, each of
    which must equal the warm run bit for bit (check a), and for the queries of ``TPCDS_FLOAT_SUBSET`` the
    answer equal to a hash-off run's (check b)."""
    from spark_rapids_tpu_torch.utils.hostsync import host_sync_metrics
    on = tpcds_session(tpch_conf(True), batches)
    off = tpcds_session(tpch_conf(False), batches)
    rates, walls, answers = {}, {}, {}
    for name, text in tpcds.QUERIES.items():
        read = sql_tables(text)
        rows = sum(batches[k].nrows for k in read)
        t0 = time.perf_counter()
        got, launches, fus, rates[name] = drive(
            torch, K, fm, lambda text=text: on.sql(text), rows, card_line,
            f"tpcds {name}", reps=reps if name in TPCDS_TIMED else 0,
            same_bits=True,
            extra={"host_syncs": host_sync_metrics})
        walls[name] = rows / rates[name]
        answers[name] = got
        total.add(launches)
        sql_launch_line(f"tpcds {name}", got, launches, fus, read)
        if name in TPCDS_FLOAT_SUBSET:
            hash_off = off.sql(text).to_pandas()
            ok, why = frames_match(got, hash_off, QUERY_RTOL)
            check(ok, f"tpcds {name}: hash on equals hash off (floats "
                  f"within rel {QUERY_RTOL}) {why}")
        print(f"tpcds {name}: phase time {time.perf_counter() - t0:.3f} s",
              flush=True)
    on.stop()
    off.stop()
    print("tpcds rows/s on " + card_line + ": " + json.dumps(
        {k: float(f"{v:.6e}") for k, v in rates.items()}), flush=True)
    print("tpcds median wall s: " + json.dumps(
        {k: float(f"{v:.6f}") for k, v in walls.items()}), flush=True)
    return answers, rates


def tpcds_cpu_answers(sf, conn):
    """In a process of its own: TPC-DS answers of the engine on the CPU
    at scale ``sf``, sent down ``conn`` (check c's reference), so that
    they are computed while the card runs the tpcds phases: the float
    tables' for ``TPCDS_FLOAT_SUBSET``, the decimal tables' for all 29."""
    import torch
    torch.set_num_threads(CPU_CHECK_THREADS)
    sys.path.insert(0, str(ROOT))
    from spark_rapids_tpu_torch.models import tpcds
    try:
        batches = tpcds_device_tables(tpcds.gen_tables(sf=sf), "cpu")
        s = tpcds_session(tpch_conf(True), batches)
        out = {"float": {name: s.sql(tpcds.QUERIES[name]).to_pandas()
                         for name in TPCDS_FLOAT_SUBSET}}
        s = tpcds_session(decimal_conf(), tpcds.decimal_batches(batches))
        out["decimal"] = {name: s.sql(text).to_pandas()
                          for name, text in tpcds.QUERIES.items()}
        conn.send(out)
    except BaseException as exc:
        conn.send(exc)
        raise
    finally:
        conn.close()


def start_process(target, *args):
    """(process, connection) computing ``target(*args, conn)`` in a
    process of its own while the card works: the CPU's answers of a
    check, or generated tables."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    parent, child = ctx.Pipe(duplex=False)
    # daemonic: a failed check ends the script, and the process with it
    proc = ctx.Process(target=target, args=(*args, child), daemon=True)
    proc.start()
    child.close()
    return proc, parent


def _received(proc, conn, label, receive):
    """``receive(conn)`` from the process of :func:`start_process`, which
    then ends."""
    try:
        got = receive(conn)
    finally:
        conn.close()
        proc.join(timeout=60)
        if proc.is_alive():
            proc.terminate()
            proc.join()
    check(proc.exitcode == 0, f"{label}: the process exited "
          f"{proc.exitcode}")
    return got


def _item(conn):
    got = conn.recv()
    if isinstance(got, BaseException):
        raise got
    return got


def receive_cpu_answers(proc, conn, label):
    """The answers the process of :func:`start_process` sends."""
    return _received(proc, conn, label, _item)


def _pickled(obj, path):
    """``obj`` pickled to ``path`` (a pipe moves gigabytes several times
    more slowly than a file), or ``obj`` itself if the file cannot be
    written."""
    import pickle
    try:
        with open(path, "wb") as f:
            pickle.dump(obj, f, protocol=5)
        return path
    except OSError:
        Path(path).unlink(missing_ok=True)
        return obj


def _unpickled(got):
    """What :func:`_pickled` gave, loaded (and its file removed)."""
    import pickle
    if not isinstance(got, str):
        return got
    with open(got, "rb") as f:
        obj = pickle.load(f)
    Path(got).unlink()
    return obj


def generated_tables(sf, where, conn):
    """In a process of its own: ``tpch.gen_table_columns(sf)`` pickled
    into the directory ``where``, then ``(path, seconds generating)``
    down ``conn``; then, from the same columns, numpy's answers of the
    nested phase (``models/nested.references``), pickled beside them, and
    ``(path, seconds computing)``, and the same for the udf phase
    (``models/udf.references``): computed here, they take no share of
    the card-driving process's interpreter."""
    sys.path.insert(0, str(ROOT))
    try:
        from spark_rapids_tpu_torch.models import nested as ND
        from spark_rapids_tpu_torch.models import tpch
        from spark_rapids_tpu_torch.models import udf as UD
        t0 = time.perf_counter()
        tables = tpch.gen_table_columns(sf)
        seconds = time.perf_counter() - t0
        conn.send((_pickled(tables, str(Path(where) / "tpch_columns.pkl")),
                   seconds))
        t0 = time.perf_counter()
        refs = ND.references(ND.host_columns(
            {t: tables[t] for t in ("lineitem", "orders", "supplier")}))
        conn.send((_pickled(refs, str(Path(where) / "nested_refs.pkl")),
                   time.perf_counter() - t0))
        del refs
        t0 = time.perf_counter()
        refs = UD.references(UD.host_columns(
            {t: tables[t] for t in ("lineitem", "orders", "customer",
                                    "supplier")}))
        del tables
        conn.send((_pickled(refs, str(Path(where) / "udf_refs.pkl")),
                   time.perf_counter() - t0))
    except BaseException as exc:
        conn.send(exc)
        raise
    finally:
        conn.close()


def receive_tables(proc, conn, label):
    """(tables, seconds generating) from :func:`generated_tables` (the
    process goes on to the nested answers: :func:`receive_nested_refs`)."""
    got, seconds = _item(conn)
    return _unpickled(got), seconds


def receive_nested_refs(proc, conn, label):
    """(numpy's nested answers, seconds computing) from
    :func:`generated_tables` (which goes on to the udf phase's:
    :func:`receive_udf_refs`)."""
    got, seconds = _item(conn)
    return _unpickled(got), seconds


def receive_udf_refs(proc, conn, label):
    """(numpy's and pandas' udf answers, seconds computing) from
    :func:`generated_tables`, which then ends."""
    got, seconds = _received(proc, conn, label, _item)
    return _unpickled(got), seconds


def check_tpcds_cpu(torch, tpcds, sf, proc, conn):
    """At scale ``sf`` the queries of ``TPCDS_FLOAT_SUBSET`` over the
    float tables, and all 29 over the decimal tables, on the card equal
    the engine on the CPU over the same generated tables (check c; a
    decimal exactly, a double within rel 1e-12 for the decimal tables);
    the CPU's answers come from the process :func:`start_process`
    started.  Then the decimal files check on the same tables."""
    t0 = time.perf_counter()
    batches = tpcds_device_tables(tpcds.gen_tables(sf=sf), DEVICE)
    card = tpcds_session(tpch_conf(True), batches)
    got = {name: card.sql(tpcds.QUERIES[name]).to_pandas()
           for name in TPCDS_FLOAT_SUBSET}
    card.stop()
    dec_batches = tpcds.decimal_batches(batches)
    card = tpcds_session(decimal_conf(), dec_batches)
    got_dec = {name: card.sql(text).to_pandas()
               for name, text in tpcds.QUERIES.items()}
    card.stop()
    want = receive_cpu_answers(proc, conn, f"tpcds SF{sf}")
    for name in TPCDS_FLOAT_SUBSET:
        ok, why = frames_match(got[name], want["float"][name], QUERY_RTOL)
        check(ok, f"tpcds SF{sf} {name}: the card equals the CPU (floats "
              f"within rel {QUERY_RTOL}) {why}")
    for name in tpcds.QUERIES:
        ok, why = frames_match(got_dec[name], want["decimal"][name],
                               PATH_RTOL)
        check(ok, f"tpcds_decimal SF{sf} {name}: the card equals the CPU "
              f"bit for bit (decimals exactly, doubles within rel "
              f"{PATH_RTOL}) {why}")
    print(f"tpcds SF{sf}: {len(TPCDS_FLOAT_SUBSET)} float and 29 decimal "
          f"queries on the card, then waited for the CPU's answers, in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    check_decimal_files(tpcds, dec_batches, got_dec, sf)


# --------------------------------------------------------- tpcds_decimal --

def decimal_conf(hash_on: bool = True):
    """The decimal pass's conf: the tpcds phase's, with the JAX package's
    fallback node (an Aggregate holding avg over a decimal or a sum past
    DECIMAL_64) allowed off the card in strict test mode."""
    return dict(tpch_conf(hash_on),
                **{"spark.rapids.sql.test.allowedNonTpu": "Aggregate"})


def _as_doubles(col):
    """A decimal answer column (Python Decimals and None) as doubles, and
    half a unit of its last digit."""
    import decimal
    vals = [v for v in col if isinstance(v, decimal.Decimal)]
    unit = max([float(decimal.Decimal(1).scaleb(v.as_tuple().exponent))
                for v in vals] or [0.0])
    return np.array([float(v) if isinstance(v, decimal.Decimal)
                     else np.nan for v in col]), unit / 2


def decimal_vs_float(got, want):
    """(equal, what differs): the decimal tables' answer against the float
    tables' on the same data.  Keys, counts, strings and row order
    exactly; a decimal within ``DECIMAL_RTOL`` of the double or half a
    unit of its scale (an avg or a quotient rounds to its scale), a double
    within ``DECIMAL_RTOL``.  Rows whose money and double columns all tie
    within that tolerance (an ORDER BY on a sum that is exact in decimal
    and off by an ulp in doubles) are compared as a set; an answer with no
    such column has its rows compared in order."""
    if list(got.columns) != list(want.columns) or len(got) != len(want):
        return False, (f"shape {list(got.columns)} x {len(got)} vs "
                       f"{list(want.columns)} x {len(want)}")
    num, exact = [], []
    for c in got.columns:
        if got[c].dtype == object and want[c].dtype.kind == "f":
            g, half = _as_doubles(got[c])
            num.append((c, g, want[c].to_numpy(dtype=np.float64), half))
        elif got[c].dtype.kind == "f":
            num.append((c, got[c].to_numpy(dtype=np.float64),
                        want[c].to_numpy(dtype=np.float64), 0.0))
        else:
            exact.append(c)

    def close(a, b, half):
        bound = np.maximum(np.abs(b) * DECIMAL_RTOL, half * 1.000001)
        return (np.abs(a - b) <= bound) | (np.isnan(a) & np.isnan(b))
    for c, g, w, half in num:
        if not close(g, w, half).all():
            bad = np.nonzero(~close(g, w, half))[0][:3]
            return False, (f"{c} rows {bad.tolist()}: {g[bad].tolist()} vs "
                           f"{w[bad].tolist()}")
    differ = [c for c in exact if not got[c].equals(want[c])]
    if not differ:
        return True, ""
    if not num:
        return False, f"{differ} differ (no number for rows to tie on)"
    # runs of rows whose numbers tie within the tolerance, as sets
    n = len(want)
    tie = np.ones(max(n - 1, 0), dtype=bool)
    for c, _, w, half in num:
        tie &= close(w[1:], w[:-1], half)
    starts = np.concatenate([[0], np.nonzero(~tie)[0] + 1, [n]])
    for a, b in zip(starts[:-1], starts[1:]):
        gs = sorted(map(tuple, got[exact].iloc[a:b].astype(str).values))
        ws = sorted(map(tuple, want[exact].iloc[a:b].astype(str).values))
        if gs != ws:
            return False, f"rows {a}..{b - 1} differ as a set: {gs[:2]} vs " \
                f"{ws[:2]}"
    return True, "(tied rows as sets)"


def run_tpcds_decimal(torch, K, fm, tpcds, batches, float_answers,
                      card_line, total):
    """The tpcds_decimal pass: the tpcds phase's SF50 tables with the
    specification's money columns as ``decimal(7,2)``
    (``tpcds.decimal_batches``, on the card), the 29 queries through
    ``session.sql`` in strict test mode, hash on, ``allowedNonTpu``
    naming the Aggregate: per query its CpuFallbackExec nodes exactly
    ``TPCDS_DECIMAL_FALLBACK``'s, a warm run (launches, host syncs, the
    fallback nodes' host ms), one timed run equal to it bit for bit, and
    the answer against the float pass's (:func:`decimal_vs_float`).
    Returns the rows/s by query."""
    from spark_rapids_tpu_torch.utils.hostsync import host_sync_metrics
    t0 = time.perf_counter()
    dec = tpcds.decimal_batches(batches)
    torch.cuda.synchronize()
    print(f"tpcds_decimal: {sum(len(v) for v in tpcds.MONEY_COLUMNS.values())}"
          f" money columns to decimal(7,2) on the card in "
          f"{time.perf_counter() - t0:.3f} s, {table_bytes(dec)} bytes "
          "(the other columns shared)", flush=True)
    s = tpcds_session(decimal_conf(), dec)
    rates, fallback_ms = {}, {}
    for name, text in tpcds.QUERIES.items():
        if name in TPCDS_DECIMAL_CUT:
            continue
        read = sql_tables(text)
        rows = sum(dec[k].nrows for k in read)
        label = f"tpcds_decimal {name}"
        t0 = time.perf_counter()
        held = {}

        def build(text=text):
            held["df"] = s.sql(text)
            return held["df"]
        want_nodes = TPCDS_DECIMAL_FALLBACK.get(name, [])
        got_nodes = sorted(type(n.node).__name__
                           for n in fallback_nodes(s.plan(build().plan)))
        check(got_nodes == sorted(want_nodes),
              f"{label}: CpuFallbackExec nodes {got_nodes}, expected "
              f"{sorted(want_nodes)}")
        got, launches, fus, rates[name] = drive(
            torch, K, fm, build, rows, card_line, label,
            reps=1,
            same_bits=True, extra={"host_syncs": host_sync_metrics})
        total.add(launches)
        sql_launch_line(label, got, launches, fus, read)
        nodes = fallback_nodes(held["df"]._last_exec)
        if nodes:
            ms = [sum(n.host_ns() for n in nodes) / 1e6,
                  sum(n.metrics["toHostTime"].value for n in nodes) / 1e6,
                  sum(n.metrics["toDeviceTime"].value for n in nodes) / 1e6]
            fallback_ms[name] = ms
            print(f"{label}: in the fallback {ms[0]:.3f} ms pandas, "
                  f"{ms[1]:.3f} ms to the host, {ms[2]:.3f} ms to the card "
                  "(the timed run)", flush=True)
        ok, why = decimal_vs_float(got, float_answers[name])
        check(ok, f"{label}: equals the float tables' answer (decimals "
              f"within rel {DECIMAL_RTOL} or half a unit, order included) "
              f"{why}")
        print(f"{label}: phase time {time.perf_counter() - t0:.3f} s",
              flush=True)
    s.stop()
    print("tpcds_decimal rows/s on " + card_line + ": " + json.dumps(
        {k: float(f"{v:.6e}") for k, v in rates.items()})
        + f"; cut for the script's time: {list(TPCDS_DECIMAL_CUT)}",
        flush=True)
    print("tpcds_decimal fallback host ms (pandas, to host, to card): "
          + json.dumps({k: [round(x, 3) for x in v]
                        for k, v in fallback_ms.items()}), flush=True)
    return dec, rates


NUMERIC_UNARY = ("sqrt", "cbrt", "exp", "expm1", "log", "log2", "log10",
                 "log1p", "sin", "cos", "tan", "cot", "asin", "acos", "atan",
                 "sinh", "cosh", "tanh", "asinh", "acosh", "atanh",
                 "degrees", "radians", "rint", "signum")


def numeric_projection(F, df):
    """Every ported math function over a decimal money column (its value
    scaled into each function's domain where it has one), round / bround
    over decimals, floor / ceil, pow, atan2, hypot, log(base, x), pmod,
    the bitwise operators and the shifts over ``ss_item_sk``."""
    p = F.col("ss_net_profit")
    # [0, 0.2]: the inverse trigonometric functions' domain, and the
    # trigonometric ones away from their zeros and poles (near those a
    # relative bound on libm's last ulps has no meaning)
    unit = F.col("ss_sales_price") / 1000
    small = ("asin", "acos", "atanh", "sin", "cos", "tan", "cot")
    cols = [getattr(F, fn)(unit if fn in small else
                           p / 100 if fn in ("exp", "expm1", "sinh",
                                             "cosh") else
                           F.col("ss_list_price") if fn == "acosh" else p)
            .alias(fn) for fn in NUMERIC_UNARY]
    k = F.col("ss_item_sk")
    cols += [
        F.round(p, 1).alias("round1"), F.round(p, -2).alias("round_2"),
        F.bround(p, 1).alias("bround1"), F.bround(p, -1).alias("bround_1"),
        F.floor(p).alias("floor"), F.ceil(p).alias("ceil"),
        F.round(F.col("ss_sales_price") * 1.03, 2).alias("round_double"),
        F.pow(unit, 3).alias("pow"), F.atan2(p, unit).alias("atan2"),
        F.hypot(p, unit).alias("hypot"),
        F.logarithm(F.lit(2.0), F.col("ss_list_price")).alias("log_base"),
        F.pmod(k, F.lit(97)).alias("pmod"),
        F.pmod(p, F.lit(7.5)).alias("pmod_double"),
        k.bitwiseOR(F.col("ss_quantity")).alias("bit_or"),
        k.bitwiseXOR(F.lit(0x5A5A)).alias("bit_xor"),
        F.bitwise_not(k).alias("bit_not"),
        F.shiftleft(k, 7).alias("shl"), F.shiftright(k, 3).alias("shr"),
        F.shiftrightunsigned(-k, 5).alias("shru"),
    ]
    return df.select(*cols)


def numeric_aggregate(F, df):
    """The aggregate shape of TPC-DS q17 and q39 per item: sample stddev
    and population variance (of a count and of a decimal), first and
    last of the ticket number in row order."""
    return df.groupBy("ss_item_sk").agg(
        F.stddev_samp("ss_quantity").alias("sd_qty"),
        F.var_pop("ss_net_profit").alias("var_profit"),
        F.first("ss_ticket_number").alias("first_ticket"),
        F.last("ss_ticket_number").alias("last_ticket"),
        F.count("*").alias("n")).orderBy("ss_item_sk")


def numeric_oracle(item, qty, profit_cents, ticket):
    """numpy float64 moments (two passes) and positional first / last per
    item, for the items that occur, ascending."""
    order = np.argsort(item, kind="stable")   # rows of an item in order
    si = item[order]
    starts = np.flatnonzero(np.r_[True, si[1:] != si[:-1]])
    ends = np.r_[starts[1:], len(si)]
    keys, n = si[starts], ends - starts
    first, last = order[starts], order[ends - 1]
    inv = np.repeat(np.arange(len(starts)), n)

    def moments(x):
        x = x[order]
        mean = np.add.reduceat(x, starts) / n
        return np.add.reduceat((x - mean[inv]) ** 2, starts)
    m2_q = moments(qty.astype(np.float64))
    m2_p = moments(profit_cents / 100.0)
    with np.errstate(invalid="ignore", divide="ignore"):
        sd = np.where(n > 1, np.sqrt(m2_q / (n - 1)), np.nan)
    return {"ss_item_sk": keys, "sd_qty": sd, "var_profit": m2_p / n,
            "first_ticket": ticket[first], "last_ticket": ticket[last],
            "n": n}


def run_numeric(torch, K, fm, dec, card_line, total):
    """The numeric pass over the decimal pass's SF50 store_sales: the
    per-item aggregate hash on and off against numpy (moments within rel
    ``DECIMAL_RTOL``, first / last and counts exactly), then the
    projection of every ported function over the first
    ``NUMERIC_SLICE_ROWS`` rows on the card against the engine on the CPU
    over the same rows (transcendentals within rel ``MATH_RTOL``, the
    rest exactly)."""
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.session import TpuSession
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import decimal_unscaled
    from spark_rapids_tpu_torch.utils.hostsync import host_sync_metrics
    ss = dec["store_sales"]
    rows = ss.nrows
    cols = ["ss_item_sk", "ss_quantity", "ss_net_profit",
            "ss_ticket_number"]
    host = ColumnarBatch({k: ss.columns[k] for k in cols},
                         ss.row_count).to_arrow()
    # numpy's answer on a thread while the card runs the aggregates
    oracle = OnThread(lambda: numeric_oracle(
        host.column("ss_item_sk").to_numpy(),
        host.column("ss_quantity").to_numpy(),
        np.concatenate([decimal_unscaled(c) for c in
                        host.column("ss_net_profit").chunks]),
        host.column("ss_ticket_number").to_numpy()))
    answers, want = {}, None
    for hash_on in (True, False):
        s = TpuSession(tpch_conf(hash_on), device=ss.device)
        label = f"numeric per-item moments, first, last " \
            f"({'hash on' if hash_on else 'hash off'})"
        got, launches, fus, _ = drive(
            torch, K, fm, numeric_aggregate(F, s.create_dataframe(ss)),
            rows, card_line, label, reps=1, same_bits=True,
            extra={"host_syncs": host_sync_metrics})
        total.add(launches)
        answers[hash_on] = got
        if want is None:
            t0 = time.perf_counter()
            want = oracle.result()
            print(f"numeric: numpy oracle over {rows} rows in "
                  f"{oracle.seconds:.3f} s on a thread; waited "
                  f"{time.perf_counter() - t0:.3f} s for it", flush=True)
        check(np.array_equal(got["ss_item_sk"].to_numpy(),
                             want["ss_item_sk"])
              and np.array_equal(got["n"].to_numpy(), want["n"])
              and np.array_equal(got["first_ticket"].to_numpy(),
                                 want["first_ticket"])
              and np.array_equal(got["last_ticket"].to_numpy(),
                                 want["last_ticket"]),
              f"{label}: {len(got)} items, counts, first and last equal "
              "numpy exactly")
        for c in ("sd_qty", "var_profit"):
            g = got[c].to_numpy(dtype=np.float64, na_value=np.nan)
            check(np.allclose(g, want[c], rtol=DECIMAL_RTOL, atol=0,
                              equal_nan=True),
                  f"{label}: {c} within rel {DECIMAL_RTOL} of numpy "
                  "float64")
        print(f"{label}: launches " + ", ".join(
            f"{k} {launches[k]}" for k in K.launches.NAMES)
            + f"; host syncs {fus['host_syncs']}", flush=True)
        s.stop()
    check(answers[True].equals(answers[False]),
          "numeric aggregate: hash on equals hash off bit for bit")
    # the projection: the card against the CPU over one slice
    n = min(NUMERIC_SLICE_ROWS, rows)
    table = head_batch(ss, n).to_arrow()
    card = TpuSession(tpch_conf(True), device=ss.device)
    label = f"numeric projection over {n} rows"
    got, launches, fus, _ = drive(
        torch, K, fm, numeric_projection(F, card.create_dataframe(table)),
        n, card_line, label, reps=1, same_bits=True)
    total.add(launches)
    cpu = TpuSession(tpch_conf(True), device="cpu")
    want_p = numeric_projection(F, cpu.create_dataframe(table)).to_pandas()
    exact = 0
    for c in got.columns:
        if c in NUMERIC_UNARY or c in ("pow", "atan2", "hypot", "log_base"):
            g = got[c].to_numpy(dtype=np.float64, na_value=np.nan)
            w = want_p[c].to_numpy(dtype=np.float64, na_value=np.nan)
            check(np.allclose(g, w, rtol=MATH_RTOL,
                              atol=np.finfo(np.float64).tiny,
                              equal_nan=True),
                  f"{label}: {c} within rel {MATH_RTOL} of the CPU")
        else:
            check(got[c].equals(want_p[c]),
                  f"{label}: {c} equals the CPU exactly")
            exact += 1
    card.stop()
    cpu.stop()
    print(f"{label}: {len(got.columns)} columns, {exact} exact", flush=True)


def head_batch(batch, n):
    """The first ``n`` rows of a device batch, as views."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import Column
    cols = {}
    for k, c in batch.columns.items():
        valid = None if c.validity is None else c.validity[:n]
        if c.offsets is not None:
            cols[k] = Column(c.dtype, c.data, n, validity=valid,
                             offsets=c.offsets[:n + 1])
        else:
            cols[k] = Column(c.dtype, c.data[:n], n, validity=valid)
    return ColumnarBatch(cols, n)


def check_decimal_files(tpcds, dec_batches, answers, sf):
    """store_sales' decimal form written to parquet and read back (the
    other tables in memory): q3 and q48 over it equal the in-memory
    decimal answers exactly, and the scan read decimal(7,2) columns."""
    import tempfile
    from spark_rapids_tpu_torch.api.session import TpuSession
    with tempfile.TemporaryDirectory() as root:
        s = tpcds_session(decimal_conf(), dec_batches)
        path = f"{root}/store_sales"
        s.table("store_sales").write.mode("overwrite").parquet(path)
        back = s.read.parquet(path)
        check(dict(back.schema)["ss_net_profit"].name == "decimal(7,2)",
              f"tpcds_decimal SF{sf} files: store_sales read back with "
              "decimal(7,2) money columns")
        back.createOrReplaceTempView("store_sales")
        for name in ("q3", "q48"):
            got = s.sql(tpcds.QUERIES[name]).to_pandas()
            ok, why = frames_match(got, answers[name], 0.0)
            check(ok, f"tpcds_decimal SF{sf} files {name}: over parquet "
                  f"equals the in-memory decimal answer exactly {why}")
        s.stop()


def tpch22_cpu_answers(sf, conn):
    """In a process of its own: the 22 TPC-H answers of the engine on the
    CPU at scale ``sf``, sent down ``conn`` (check b's reference)."""
    import torch
    torch.set_num_threads(CPU_CHECK_THREADS)
    sys.path.insert(0, str(ROOT))
    from spark_rapids_tpu_torch.api.session import TpuSession
    from spark_rapids_tpu_torch.models import tpch
    try:
        cpu = TpuSession(tpch_conf(True), device="cpu")
        tables = {k: cpu.create_dataframe(b) for k, b in device_tables(
            tpch.gen_table_columns(sf), cpu.device).items()}
        conn.send({name: query(tables).to_pandas()
                   for name, query in tpch.QUERIES.items()})
    except BaseException as exc:
        conn.send(exc)
        raise
    finally:
        conn.close()


def check_tpch22_cpu(torch, tpch, sf, proc, conn):
    """All 22 queries at scale ``sf`` on the card equal the engine on the
    CPU over the same columns (check b); the CPU's answers come from the
    process :func:`start_process` started."""
    from spark_rapids_tpu_torch.api.session import TpuSession
    t0 = time.perf_counter()
    card = TpuSession(tpch_conf(True))
    on_card = {k: card.create_dataframe(b) for k, b in device_tables(
        tpch.gen_table_columns(sf), card.device).items()}
    got = {name: query(on_card).to_pandas()
           for name, query in tpch.QUERIES.items()}
    card.stop()
    want = receive_cpu_answers(proc, conn, f"tpch22 SF{sf}")
    for name in tpch.QUERIES:
        ok, why = frames_match(got[name], want[name], QUERY_RTOL)
        check(ok, f"tpch22 SF{sf} {name}: the card equals the CPU (floats "
              f"within rel {QUERY_RTOL}) {why}")
    print(f"tpch22 SF{sf}: 22 queries on the card, then waited for the "
          f"CPU's answers, in {time.perf_counter() - t0:.3f} s", flush=True)


# -------------------------------------------------------------- fallback --

# F2: the queries whose LIKE sits over part (q9's predicate is a
# Contains, so it keeps every node on the card)
FALLBACK_LIKE_QUERIES = ("q2", "q9", "q14", "q16", "q20")


def logical_nodes(plan):
    stack, out = [plan], []
    while stack:
        node = stack.pop()
        out.append(node)
        stack.extend(node.children)
    return out


def fallback_nodes(exec_plan):
    """The CpuFallbackExec nodes of a physical plan."""
    from spark_rapids_tpu_torch.exec.fallback import CpuFallbackExec
    stack, out = [exec_plan], []
    while stack:
        node = stack.pop()
        if isinstance(node, CpuFallbackExec):
            out.append(node)
        stack.extend(node.children)
    return out


def like_holders(plan):
    """Type names of the logical nodes whose own expressions hold a
    LIKE: those that fall back when ``spark.rapids.sql.expression.Like``
    is off."""
    from spark_rapids_tpu_torch.ops.stringops import Like
    from spark_rapids_tpu_torch.plan.overrides import _node_expressions

    def has_like(e):
        return isinstance(e, Like) or any(has_like(c) for c in e.children)
    return sorted(type(n).__name__ for n in logical_nodes(plan)
                  if any(has_like(e) for e in _node_expressions(n)))


def fallback_run(torch, K, fm, s, label, q, rows, want, want_nodes,
                 card_line, total):
    """One query of the fallback phase: its plan's CpuFallbackExec nodes
    are exactly ``want_nodes``; one run through the engine (launches,
    host syncs, wall); the answer equals ``want`` under the tpch22
    phase's comparison, order included.  Returns (wall s, host syncs,
    the fallback nodes' host ms in pandas, to host and to the device)."""
    from spark_rapids_tpu_torch.utils.hostsync import host_sync_metrics
    got_nodes = sorted(type(n.node).__name__
                       for n in fallback_nodes(s.plan(q.plan)))
    check(got_nodes == sorted(want_nodes),
          f"{label}: CpuFallbackExec nodes {got_nodes}, expected "
          f"{sorted(want_nodes)}")
    got, launches, fus, rate = drive(
        torch, K, fm, q, rows, card_line, label, reps=0,
        extra={"host_syncs": host_sync_metrics})
    total.add(launches)
    wall = rows / rate
    nodes = fallback_nodes(q._last_exec)
    pandas_ms = sum(n.host_ns() for n in nodes) / 1e6
    to_host_ms = sum(n.metrics["toHostTime"].value for n in nodes) / 1e6
    to_dev_ms = sum(n.metrics["toDeviceTime"].value for n in nodes) / 1e6
    print(f"{label}: fallback nodes {got_nodes}; wall {wall * 1e3:.3f} ms; "
          f"host syncs {fus['host_syncs']}; in the fallback {pandas_ms:.3f}"
          f" ms pandas, {to_host_ms:.3f} ms to the host, {to_dev_ms:.3f} ms"
          " to the card; launches " + ", ".join(
              f"{k} {launches[k]}" for k in K.launches.NAMES), flush=True)
    ok, why = frames_match(got, want, QUERY_RTOL)
    check(ok, f"{label}: equals the tpch22 answer (floats within rel "
          f"{QUERY_RTOL}, order included) {why}")
    return wall, fus["host_syncs"], pandas_ms, to_host_ms, to_dev_ms


def official_q13(F, t):
    """TPC-H q13 as its text has it, the residual on the outer join, with
    the columns pruned as Spark's optimizer prunes them."""
    c = t["customer"].select("c_custkey")
    o = t["orders"].select("o_orderkey", "o_custkey", "o_comment")
    j = c.join(o, on=(F.col("c_custkey") == F.col("o_custkey"))
               & ~F.col("o_comment").like("%special%requests%"),
               how="left")
    per_cust = j.groupBy("c_custkey").agg(
        F.count(F.col("o_orderkey")).alias("c_count"))
    return (per_cust.groupBy("c_count").agg(F.count().alias("custdist"))
            .orderBy(F.col("custdist").desc(), F.col("c_count").desc()))


def run_fallback(torch, K, fm, tpch, batches, df_answers, card_line, total):
    """The fallback phase over the tpch22 phase's SF10 tables and answers:
    F1 every Sort in pandas, F2 every LIKE over part in pandas, F3 the
    official q13 join in pandas, F4 the 22 plans under the cost-based
    optimizer (planned, not run), with tagging and planning host times."""
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.session import TpuSession
    from spark_rapids_tpu_torch.config.rapids_conf import RapidsConf
    from spark_rapids_tpu_torch.plan import logical as L
    from spark_rapids_tpu_torch.plan.overrides import TpuOverrides
    summary = {}

    def tables_of(s):
        return {k: s.create_dataframe(b) for k, b in batches.items()}

    # F1: spark.rapids.sql.exec.Sort=false, the 22 queries
    t0 = time.perf_counter()
    # strict test mode stays on: allowedNonTpu names the nodes a part
    # expects on the CPU
    s = TpuSession(dict(tpch_conf(True), **{
        "spark.rapids.sql.exec.Sort": False,
        "spark.rapids.sql.test.allowedNonTpu": "Sort"}))
    t = tables_of(s)
    for name, query in tpch.QUERIES.items():
        read = ReadTables(t)
        q = query(read)
        rows = sum(batches[k].nrows for k in read.read)
        # every Sort of the plan (none in the keyless q6, q14, q17, q19)
        want = ["Sort"] * sum(isinstance(n, L.Sort)
                              for n in logical_nodes(q.plan))
        summary[f"F1 {name}"] = fallback_run(
            torch, K, fm, s, f"fallback F1 {name}", q, rows,
            df_answers[name], want, card_line, total)
    s.stop()
    summary["F1"] = time.perf_counter() - t0

    # F2: spark.rapids.sql.expression.Like=false, the LIKE-over-part ones
    t0 = time.perf_counter()
    s = TpuSession(dict(tpch_conf(True), **{
        "spark.rapids.sql.expression.Like": False,
        "spark.rapids.sql.test.allowedNonTpu": "Filter,Aggregate"}))
    t = tables_of(s)
    hash_launches = {"hash_insert": 0, "hash_probe": 0}
    for name in FALLBACK_LIKE_QUERIES:
        read = ReadTables(t)
        q = tpch.QUERIES[name](read)
        rows = sum(batches[k].nrows for k in read.read)
        want = like_holders(q.plan)
        print(f"fallback F2 {name}: LIKE held by {want} (from the plan)",
              flush=True)
        part = PathLaunches(K.launches.NAMES)
        summary[f"F2 {name}"] = fallback_run(
            torch, K, fm, s, f"fallback F2 {name}", q, rows,
            df_answers[name], want, card_line, part)
        total.extend(part)
        for k in hash_launches:
            hash_launches[k] += part.counts[k]
    check(all(v >= 1 for v in hash_launches.values()),
          f"fallback F2: the joins above and beside the CPU nodes ran the "
          f"hash kernels ({hash_launches})")
    s.stop()
    summary["F2"] = time.perf_counter() - t0

    # F3: the official q13 join (15M orders build, 1.5M customers probe)
    t0 = time.perf_counter()
    s = TpuSession(dict(tpch_conf(True), **{
        "spark.rapids.sql.test.allowedNonTpu": "Join"}))
    t = tables_of(s)
    q = official_q13(F, t)
    rows = batches["customer"].nrows + batches["orders"].nrows
    f3 = PathLaunches(K.launches.NAMES)
    summary["F3 q13"] = fallback_run(
        torch, K, fm, s, "fallback F3 official q13", q, rows,
        df_answers["q13"], ["Join"], card_line, f3)
    plan = q._last_exec.tree_string()
    check(plan.count("TpuHashAggregateExec") == 2
          and plan.splitlines()[0].startswith("TpuSortExec"),
          "fallback F3: both group-bys and the sort ran on the card")
    total.extend(f3)
    s.stop()
    summary["F3"] = time.perf_counter() - t0

    # F4: the optimizer, planning only, under its built-in weights
    t0 = time.perf_counter()
    s = TpuSession(tpch_conf(True))
    t = tables_of(s)
    tagger = TpuOverrides(RapidsConf(tpch_conf(True)), s.device)
    cbo = TpuOverrides(RapidsConf(dict(tpch_conf(True), **{
        "spark.rapids.sql.optimizer.enabled": True})), s.device)
    from spark_rapids_tpu_torch.plan.cbo import weights_calibrated
    print(f"fallback F4: optimizer weights calibrated for cuda: "
          f"{weights_calibrated('cuda')} (the built-in ratio table)",
          flush=True)
    times = {}
    for name, query in tpch.QUERIES.items():
        q = query(t)   # a scalar subquery runs here, on the card
        t1 = time.perf_counter()
        tagger.tag(q.plan)
        t2 = time.perf_counter()
        cbo.tag(q.plan)
        t3 = time.perf_counter()
        s.plan(q.plan)
        t4 = time.perf_counter()
        times[name] = ((t2 - t1) * 1e3, (t3 - t2) * 1e3, (t4 - t3) * 1e3)
        print(f"fallback F4 {name}: tagging {times[name][0]:.3f} ms, "
              f"tagging and optimizer {times[name][1]:.3f} ms, whole "
              f"planning {times[name][2]:.3f} ms (host); optimizer "
              f"reverts {cbo.last_cbo}", flush=True)
    s.stop()
    summary["F4"] = time.perf_counter() - t0
    print("fallback F4 host ms per query (tagging, tagging+optimizer, "
          "planning) on " + card_line + ": " + json.dumps(
              {k: [round(x, 3) for x in v] for k, v in times.items()}),
          flush=True)
    return summary


# ----------------------------------------------------------------- files --

def files_conf(pipeline: bool = True, reader: str = "AUTO"):
    """The tpch22 conf (hash on, 2^22-row batches) for file scans: the
    reader's batches are 2^22 rows too."""
    return dict(tpch_conf(True), **{
        "spark.rapids.sql.reader.batchSizeRows": BATCH_ROWS,
        "spark.rapids.tpu.pipeline.enabled": pipeline,
        "spark.rapids.sql.format.parquet.reader.type": reader})


def import_formats():
    """pyarrow's parquet, ORC and CSV modules; a missing one fails the
    phase, naming it."""
    import importlib
    mods = {}
    for fmt in ("parquet", "orc", "csv"):
        try:
            mods[fmt] = importlib.import_module(f"pyarrow.{fmt}")
        except ImportError as exc:
            raise CheckFailed(f"files: pyarrow.{fmt} does not import on "
                              f"this machine: {exc}") from exc
    import pyarrow
    print(f"files: pyarrow {pyarrow.__version__} with parquet, orc and csv",
          flush=True)
    return mods


def scans_of(plan):
    """The file scans of a physical plan."""
    out = []

    def walk(n):
        if type(n).__name__ == "TpuFileScanExec":
            out.append(n)
        for c in n.children:
            walk(c)
    walk(plan)
    return out


def scan_split(df):
    """Host ms the last run's scans waited for decoded tables and spent
    uploading them, and the bytes arrow decoded."""
    scans = scans_of(df._last_exec)
    return (sum(sc.metrics["decodeTime"].value for sc in scans) / 1e6,
            sum(sc.metrics["uploadTime"].value for sc in scans) / 1e6,
            sum(sc.metrics["bytesDecoded"].value for sc in scans))


def write_tpch_parquet(batches, root):
    """The TPC-H device tables written through ``DataFrame.write.parquet``:
    lineitem and orders as FILES_PER_BIG_TABLE files each, every other
    table as one file."""
    import os
    from spark_rapids_tpu_torch.api.session import TpuSession
    t0 = time.perf_counter()
    on_disk = 0
    for name, b in batches.items():
        parts = FILES_PER_BIG_TABLE if name in ("lineitem", "orders") else 1
        per_file = -(-b.nrows // parts)
        s = TpuSession({"spark.rapids.sql.writer.maxRowsPerFile": per_file})
        st = s.create_dataframe(b).write.parquet(os.path.join(root, name))
        check(st.num_files == parts and st.num_rows == b.nrows,
              f"files: {name} written as {st.num_files} parquet files, "
              f"{st.num_rows} rows, {st.num_bytes} bytes")
        on_disk += st.num_bytes
        s.stop()
    print(f"files: the eight SF{TPCH_SF} tables written as parquet in "
          f"{time.perf_counter() - t0:.3f} s, {on_disk} bytes on disk",
          flush=True)


def run_files(torch, K, fm, tpch, batches, df_answers, mem_rates,
              card_line, total, then=None):
    """The 22 TPC-H queries over parquet files the port wrote, against
    the in-memory tpch22 answers of this run (rows/s beside theirs,
    ``mem_rates``); pipeline on and off; the reader strategies; q6's
    pruning; ORC, CSV, partitioned and bucketed round trips at SF0.1.
    ``then(root)``: more work over the same files (the sharded_tpch
    phase's file pass), run before they are removed."""
    import os
    import tempfile
    from spark_rapids_tpu_torch.api.session import TpuSession
    from spark_rapids_tpu_torch.utils.hostsync import host_sync_metrics
    import_formats()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-files-") as tmp:
        root = os.path.join(tmp, "tpch")
        write_tpch_parquet(batches, root)
        on = TpuSession(files_conf(True))
        tables = tpch.read_parquet(on, root)
        check(len(tables["lineitem"].plan.paths) == FILES_PER_BIG_TABLE,
              f"files: lineitem read as {FILES_PER_BIG_TABLE} files")
        rates, answers = {}, {}
        for name, query in tpch.QUERIES.items():
            read = ReadTables(tables)
            q = query(read)
            rows = sum(batches[k].nrows for k in read.read)
            got, launches, fus, rates[name] = drive(
                torch, K, fm, q, rows, card_line, f"files {name}",
                reps=FILES_REPS if name in FILES_TIMED else 0,
                extra={"host_syncs": host_sync_metrics},
                same_bits=True)
            answers[name] = got
            total.add(launches)
            dec, up, nbytes = scan_split(q)
            wall = 1e3 * rows / rates[name]
            st = on.last_pipeline_stats
            print(f"files {name}: launches "
                  + ", ".join(f"{k} {launches[k]}" for k in K.launches.NAMES)
                  + f"; host syncs {fus['host_syncs']}; last run: wall "
                  f"{wall:.3f} ms, scans waited {dec:.3f} ms for decoded "
                  f"tables and uploaded for {up:.3f} ms, the rest "
                  f"{wall - dec - up:.3f} ms; {nbytes} bytes decoded; "
                  f"pipeline {st.as_dict()}", flush=True)
            ok, why = frames_match(got, df_answers[name], QUERY_RTOL)
            check(ok, f"files {name}: the answer over parquet equals the "
                  f"in-memory tpch22 answer (floats within rel "
                  f"{QUERY_RTOL}) {why}")
        print("files rows/s on " + card_line + ": " + json.dumps(
            {k: float(f"{v:.6e}") for k, v in rates.items()}), flush=True)
        print("files rows/s beside in memory (files, in memory, ratio): "
              + json.dumps({k: [float(f"{v:.6e}"),
                                float(f"{mem_rates[k]:.6e}"),
                                round(v / mem_rates[k], 4)]
                            for k, v in rates.items()}), flush=True)
        on.stop()

        # pipeline off: the same answers, bit for bit
        off = TpuSession(files_conf(False))
        off_tables = tpch.read_parquet(off, root)
        for name in FILES_PIPELINE_OFF:
            got = tpch.QUERIES[name](off_tables).to_pandas()
            check(got.equals(answers[name]),
                  f"files {name}: pipeline off equals pipeline on bit for "
                  "bit")
        off.stop()

        # the reader strategies, and q6's pruning
        q6_cols = {"l_shipdate", "l_discount", "l_quantity",
                   "l_extendedprice"}
        for reader in ("PERFILE", "COALESCING", "MULTITHREADED"):
            s = TpuSession(files_conf(True, reader))
            t = tpch.read_parquet(s, root)
            for name in ("q1", "q6"):
                q = tpch.QUERIES[name](t)
                got = q.to_pandas()
                ok, why = frames_match(got, answers[name], QUERY_RTOL)
                check(ok, f"files {name} {reader}: equals the default "
                      f"reader's answer (floats within rel {QUERY_RTOL}) "
                      f"{why}")
                if name == "q6":
                    sc = scans_of(q._last_exec)
                    dec, up, nbytes = scan_split(q)
                    check(len(sc) == 1 and set(sc[0].columns) == q6_cols
                          and t["lineitem"].plan.required_columns
                          == q6_cols,
                          f"files q6 {reader}: the scan decodes only "
                          f"{sorted(sc[0].columns)}: {nbytes} bytes "
                          f"decoded, waited {dec:.3f} ms, uploads "
                          f"{up:.3f} ms")
            s.stop()
        check_small_formats(tpch, os.path.join(tmp, "small"))
        if then is not None:
            then(root)


def check_small_formats(tpch, root):
    """At SF0.1: lineitem as ORC and as CSV reads back equal to its
    parquet copy; a partitionBy write reads back through discovery equal
    to what was written; a bucketBy write under an equality filter
    prunes to one file."""
    import os
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.session import TpuSession
    s = TpuSession(files_conf(True))
    cols = tpch.gen_table_columns(FILES_CHECK_SF)["lineitem"]
    li = s.create_dataframe(device_tables({"l": cols}, s.device)["l"])
    paths = {fmt: os.path.join(root, fmt) for fmt in
             ("parquet", "orc", "csv")}
    for fmt, p in paths.items():
        getattr(li.write, fmt)(p)
    base = s.read.parquet(paths["parquet"]).to_pandas()
    check(len(base) == len(cols["l_orderkey"][1]),
          f"files SF{FILES_CHECK_SF}: lineitem parquet holds {len(base)} "
          "rows")
    for fmt in ("orc", "csv"):
        got = getattr(s.read, fmt)(paths[fmt]).to_pandas()
        note = ""
        if fmt == "csv":
            # CSV carries no types: its integers read back as bigint
            widened = [c for c in got.columns
                       if got[c].dtype != base[c].dtype]
            got = got.astype({c: base[c].dtype for c in widened})
            note = f"; read back as another type, then cast: {widened}"
        ok, why = frames_match(got, base, 0.0)
        check(ok, f"files SF{FILES_CHECK_SF}: lineitem as {fmt} reads back "
              f"equal to its parquet copy{note} {why}")
    part = os.path.join(root, "by_flag")
    st = li.write.partitionBy("l_returnflag").parquet(part)
    back = s.read.parquet(part).to_pandas()
    keys = list(base.columns)  # (orderkey, linenumber) is not unique
    ok, why = frames_match(
        back[list(base.columns)].sort_values(keys, ignore_index=True),
        base.sort_values(keys, ignore_index=True), 0.0)
    check(ok and st.num_partitions == 3 and
          sorted(os.listdir(part)) == ["l_returnflag=A", "l_returnflag=N",
                                       "l_returnflag=R"],
          f"files SF{FILES_CHECK_SF}: partitionBy(l_returnflag) reads back "
          f"through discovery equal to what was written "
          f"({st.num_partitions} partitions) {why}")
    buck = os.path.join(root, "bucketed")
    st = li.write.bucketBy(8, "l_orderkey").parquet(buck)
    key = int(base["l_orderkey"].iloc[len(base) // 2])
    q = s.read.parquet(buck).filter(F.col("l_orderkey") == key)
    got = q.to_pandas().sort_values(keys, ignore_index=True)
    want = base[base["l_orderkey"] == key].sort_values(
        keys, ignore_index=True)
    sc = scans_of(q._last_exec)
    ok, why = frames_match(got, want, 0.0)
    check(ok and st.num_files == 8 and len(sc) == 1
          and len(sc[0].paths) == 1,
          f"files SF{FILES_CHECK_SF}: bucketBy(8, l_orderkey) then "
          f"l_orderkey == {key} reads one of {st.num_files} files and "
          f"equals pandas ({len(got)} rows) {why}")
    s.stop()


# ---------------------------------------------------------- sharded_tpch --

def sharded_conf(base):
    """``base`` over NSHARDS logical shards of the card."""
    return dict(base, **{"spark.rapids.sql.distributed.numShards": NSHARDS})


def dist_metric_objs():
    """The sharded checks' metric objects: rows exchanged, host syncs."""
    from spark_rapids_tpu_torch.parallel.shuffle import shuffle_metrics
    from spark_rapids_tpu_torch.utils.hostsync import host_sync_metrics
    return {"shuffle": shuffle_metrics, "host_syncs": host_sync_metrics}


class DistLog:
    """While active, every distributed execution's verdict and stage
    statistics: a SQL statement's scalar subqueries run as queries of
    their own while it is built, and exchange rows too."""

    def __enter__(self):
        from spark_rapids_tpu_torch.api import dataframe
        self._mod, self._real = dataframe, dataframe.try_distributed
        self.runs = []

        def logged(session, plan, resume=False):
            got = self._real(session, plan, resume=resume)
            self.runs.append((session.last_dist_explain,
                              list(session.last_dist_stats or [])))
            return got
        dataframe.try_distributed = logged
        return self

    def __exit__(self, *exc):
        self._mod.try_distributed = self._real


def sharded_query(torch, K, fm, s, label, query, rows, want, card_line,
                  single_rate, launches, reps=1):
    """One query of the sharded_tpch phase: a warm run (its launches are
    the main path's) and ``reps`` timed runs.  It and any scalar
    subquery ran distributed, its exchanges moved the rows the stage
    statistics counted, and its answer equals ``want`` (keys, counts,
    strings and order exactly, floats within QUERY_RTOL).  Returns its
    rows/s (of the warm run when ``reps`` is 0)."""
    with DistLog() as log:
        got, lq, mq, rate = drive(torch, K, fm, query, rows, card_line,
                                  f"{label} (warm run)", reps=0,
                                  extra=dist_metric_objs())
    explains = [e for e, _ in log.runs]
    check(explains and all(e == "distributed" for e in explains),
          f"{label}: ran distributed ({len(explains)} executions: "
          f"{sorted(set(explains))})")
    moved = mq["shuffle"]["rowsMoved"]
    counted = sum(exchanged_rows(st) for _, st in log.runs)
    check(moved == counted,
          f"{label}: rows exchanged {moved} == sum(partition counts) "
          f"{counted} ({mq['shuffle']['exchanges']} exchanges, "
          f"{mq['host_syncs']} host syncs)")
    ok, why = frames_match(got.reset_index(drop=True),
                           want.reset_index(drop=True), QUERY_RTOL)
    check(ok, f"{label}: equals the single-device answer (floats within "
          f"rel {QUERY_RTOL}) {why}")
    launches.add(lq)
    if reps:
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            (query() if callable(query) else query).to_pandas()
            walls.append(time.perf_counter() - t0)
        rate = rows / float(np.median(walls))
    ratio = f"{rate / single_rate:.4f}" if single_rate else "n/a"
    print(f"rows/s {label}: {rate:.6e} over {NSHARDS} shards "
          f"({'median of ' + str(reps) + ' runs' if reps else 'warm run'}"
          f"), single device {single_rate:.6e} (ratio {ratio}); host syncs "
          f"{mq['host_syncs']}; launches "
          + ", ".join(f"{k} {lq[k]}" for k in K.launches.NAMES)
          + f"; rows exchanged {moved} on {card_line}", flush=True)
    return rate


def run_sharded_tpch(torch, K, fm, tpch, tpch_sql, batches, df_answers,
                     df_rates, sql_rates, card_line, launches):
    """The sharded_tpch phase in memory: the 22 TPC-H queries as
    DataFrames and as SQL over the tpch22 tables on NSHARDS logical
    shards, each against the single-device answer of this run."""
    from spark_rapids_tpu_torch.api.session import TpuSession
    s = TpuSession(sharded_conf(tpch_conf(True)))
    tables = {k: s.create_dataframe(b) for k, b in batches.items()}
    tpch_sql.register(s, tables)
    rates = {}
    for name, query in tpch.QUERIES.items():
        read = ReadTables(tables)
        q = query(read)
        rows = sum(batches[k].nrows for k in read.read)
        rates[f"df {name}"] = sharded_query(
            torch, K, fm, s, f"sharded_tpch {name}", q, rows,
            df_answers[name], card_line, df_rates[name], launches)
    for name, text in tpch_sql.QUERIES.items():
        rows = sum(batches[k].nrows for k in sql_tables(text))
        rates[f"sql {name}"] = sharded_query(
            torch, K, fm, s, f"sharded_tpch sql {name}",
            lambda text=text: s.sql(text), rows,
            tpch_sql.dataframe_form(name, df_answers[name]), card_line,
            sql_rates.get(name, 0.0), launches)
    s.stop()
    print(f"sharded_tpch rows/s over {NSHARDS} shards on {card_line}: "
          + json.dumps({k: float(f"{v:.6e}") for k, v in rates.items()}),
          flush=True)


def run_sharded_files(torch, K, fm, tpch, root, batches, df_answers,
                      card_line, launches, deadline):
    """The sharded_tpch phase over the files phase's parquet: the 22
    queries with the file list sharded over NSHARDS logical shards (each
    shard reads its own files), SHARDED_FILES_FIRST always and first; a
    later query not started by ``deadline`` (perf_counter seconds) is cut
    and named."""
    from spark_rapids_tpu_torch.api.session import TpuSession
    s = TpuSession(sharded_conf(files_conf(True)))
    tables = tpch.read_parquet(s, root)
    order = list(SHARDED_FILES_FIRST) + [
        q for q in tpch.QUERIES if q not in SHARDED_FILES_FIRST]
    cut = []
    for name in order:
        if name not in SHARDED_FILES_FIRST and time.perf_counter() > deadline:
            cut.append(name)
            continue
        read = ReadTables(tables)
        q = tpch.QUERIES[name](read)
        rows = sum(batches[k].nrows for k in read.read)
        label = f"sharded_tpch files {name}"
        sharded_query(torch, K, fm, s, label, q, rows, df_answers[name],
                      card_line, 0.0, launches, reps=0)
        st = s.last_scan_stats
        check(st is not None and st["sharded_files"]
              and st["peak_host_rows"] <= st["shard_bound_rows"],
              f"{label}: the file list sharded ({st and st['files']} files "
              f"in {st and st['scans']} scans, {st and st['total_rows']} "
              f"rows); peak host rows {st and st['peak_host_rows']} <= the "
              f"largest shard's footer rows "
              f"{st and st['shard_bound_rows']}")
    s.stop()
    print(f"sharded_tpch files: {len(order) - len(cut)} of {len(order)} "
          f"queries run; cut for the phase's time: {cut}", flush=True)


def run_sharded_tpcds(torch, K, fm, batches, answers, rates, card_line,
                      launches):
    """The sharded_tpch phase's TPC-DS queries on NSHARDS logical shards,
    each against the tpcds phase's single-device answer."""
    from spark_rapids_tpu_torch.models import tpcds
    s = tpcds_session(sharded_conf(tpch_conf(True)), batches)
    for name in SHARDED_TPCDS:
        text = tpcds.QUERIES[name]
        rows = sum(batches[k].nrows for k in sql_tables(text))
        sharded_query(torch, K, fm, s, f"sharded_tpch tpcds {name}",
                      lambda text=text: s.sql(text), rows, answers[name],
                      card_line, rates[name], launches, reps=0)
    s.stop()


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

    def extend(self, other: "PathLaunches"):
        self.add(dict(other.counts, by_shape=other.shapes))


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
          extra=None, same_bits=False, arrow=False):
    """Reset the launch counts, run the query once through the engine
    (its counts are the main path's), then time ``reps`` more runs (with
    ``reps=0`` the rate is the one run's).  ``query`` is a DataFrame, or a
    function that builds one (a SQL statement, whose scalar subqueries
    run while it is built: they count, and each timed run builds it
    anew).  ``extra``: more metric objects (reset, snapshot) read like
    ``fm``; ``fm`` then returns their snapshots in a dict beside its own.
    ``same_bits``: check that every timed run's answer equals the first
    run's bit for bit (float sums included).  ``arrow``: collect arrow
    tables (nested columns stay lists and structs) instead of pandas."""
    def run():
        df = query() if callable(query) else query
        return df.to_arrow() if arrow else df.to_pandas()
    K.launches.reset()
    fm.reset()
    for m in (extra or {}).values():
        m.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = run()
    first_s = time.perf_counter() - t0
    launches = dict(K.launches.snapshot(),
                    by_shape=K.launches.shape_snapshot())
    fusion = fm.snapshot()
    if extra:
        fusion = dict(fusion, **{k: m.snapshot() for k, m in extra.items()})
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        again = run()
        walls.append(time.perf_counter() - t0)
        if same_bits:
            check(again.equals(result),
                  f"{label}: a repeated run's answer equals the first "
                  "bit for bit")
    wall = float(np.median(walls)) if walls else first_s
    runs = f"median of {reps} runs" if reps else "one run"
    print(f"rows/s {label}: {rows / wall:.6e} ({runs}, "
          f"{wall * 1e3:.3f} ms; first run {first_s * 1e3:.3f} ms; "
          f"{rows} rows) on {card_line}", flush=True)
    return result, launches, fusion, rows / wall


# ----------------------------------------------------------- memory phase --

MEMORY_BUDGET = 256 << 20   # M2-M5's device spill budget (SF100 cut to SF10)
MEMORY_HOST = 1 << 30       # the host tier (the reference's default)
OOM_BATCH_ROWS = 1 << 26    # M4: q1's aggregate over 2^26-row batches
OOM_HEADROOM = 0.55         # M4: the cap leaves this share of its peak
M2_BATCHES = 4              # M2 sorts lineitem's first 4 input batches
M5_QUERIES = ("q47", "q67")
M5_BUDGET_QUERY = "q67"     # M5's run under the spill budget
SORT_KEYS = ("l_extendedprice", "l_orderkey", "l_linenumber")
CHECK_SLICE_ROWS = 1 << 22  # the input checksum's slices
# wrap-around int64 mixing constants (splitmix64's, as signed values)
_MIX1 = -7046029254386353131
_MIX2 = -4658895280553007687
_MIX3 = -7723592293110705685
NULL_WORD = 0x5EED


def memory_conf(base):
    """``base`` under the phase's spill budget and host tier."""
    return dict(base, **{
        "spark.rapids.memory.tpu.deviceLimitBytes": MEMORY_BUDGET,
        "spark.rapids.memory.host.spillStorageSize": MEMORY_HOST})


def mix(x):
    """A wrap-around int64 mix of each element (splitmix64's finaliser
    with arithmetic shifts)."""
    x = x * _MIX1
    x = x ^ (x >> 31)
    x = x * _MIX2
    return x ^ (x >> 29)


def row_words(torch, col, n):
    """One int64 per row of a column's first n rows, from its bits: a
    float's bits, an integer's value, a string's chars with their places
    (a hash of the row), a null a word of its own; no host sync."""
    dev = col.data.device
    if col.offsets is not None:
        off = col.offsets[:n + 1].to(torch.int64)
        chars = col.data.to(torch.int64)
        j = torch.arange(chars.shape[0], device=dev)
        row = (torch.searchsorted(off, j, right=True) - 1).clamp(
            0, max(n - 1, 0))
        inside = (j >= off[0]) & (j < off[n])
        m = mix((chars + 1) * _MIX3 + (j - off[row]) * _MIX1)
        h = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
            0, row, torch.where(inside, m, torch.zeros_like(m)))
        w = mix(h + (off[1:] - off[:-1]) * _MIX2)
    else:
        v = col.data[:n]
        if v.dtype == torch.float64:
            w = v.contiguous().view(torch.int64)
        elif v.dtype == torch.float32:
            w = v.contiguous().view(torch.int32).to(torch.int64)
        else:
            w = v.to(torch.int64)
    if col.validity is not None:
        w = torch.where(col.validity[:n], w,
                        torch.full_like(w, NULL_WORD))
    return w


def batch_sums(torch, batch):
    """On the card: per column the sum of its rows' mixed words (order
    free: a permutation of the rows keeps it), and the batch's sum of
    words mixed with their row numbers (order bound)."""
    n = batch.nrows
    dev = batch.device
    place = mix(torch.arange(n, device=dev) + 1)
    cols, ordered = [], torch.zeros((), dtype=torch.int64, device=dev)
    for i, c in enumerate(batch.columns.values()):
        w = mix(row_words(torch, c, n) + (i + 1) * 1000003)
        cols.append(w.sum())
        ordered = ordered + mix(w ^ place).sum()
    return torch.stack(cols), ordered


def table_sums(torch, batch):
    """``batch_sums``' column sums of a whole table, a slice at a time."""
    from spark_rapids_tpu_torch.exec.basic import slice_batch
    n = batch.nrows
    total = None
    for part in slice_batch(batch, list(range(0, n, CHECK_SLICE_ROWS))
                            + [n]):
        cs, _ = batch_sums(torch, part)
        total = cs if total is None else total + cs
    return total


def exec_metric(plan, name):
    """A metric summed over a physical plan's operators."""
    got = plan.metrics[name].value if name in plan.metrics else 0
    return got + sum(exec_metric(c, name) for c in plan.children)


class OnThread:
    """``fn()`` on a thread of its own, started at once (numpy lets go of
    the GIL while it sorts): a host oracle computed while the card runs
    the phases before its own.  ``result()`` waits for it and re-raises
    its error; ``seconds`` is its run time."""

    def __init__(self, fn):
        import threading
        self._fn = fn
        self._out = self._error = None
        self.seconds = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        t0 = time.perf_counter()
        try:
            self._out = self._fn()
        except BaseException as exc:  # re-raised on the main thread
            self._error = exc
        self.seconds = time.perf_counter() - t0
        self._fn = None

    def result(self):
        self._t.join()
        if self._error is not None:
            raise self._error
        return self._out


def lexsort_oracle(lineitem_cols) -> OnThread:
    """numpy's lexsort of lineitem's three sort keys, on a thread."""
    price, okey, line = (np.asarray(lineitem_cols[k][1]) for k in SORT_KEYS)

    def run():
        idx = np.lexsort((line, okey, -price))
        return [price[idx], okey[idx], line[idx]]
    return OnThread(run)


def memory_sort(torch, K, fm, F, lineitem, conf, label, keys_out=None):
    """``lineitem.orderBy(l_extendedprice desc, l_orderkey,
    l_linenumber)`` through ``TpuSession(conf)``, consumed batch by
    batch: (rows, column sums, [(rows, ordered sum)] per batch, seconds,
    launches, session, plan); the key columns go to ``keys_out``."""
    from spark_rapids_tpu_torch.api.session import TpuSession
    s = TpuSession(conf, device=DEVICE)
    q = s.create_dataframe(lineitem).orderBy(
        F.col("l_extendedprice").desc(), F.col("l_orderkey"),
        F.col("l_linenumber"))
    K.launches.reset()
    fm.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = s.plan(q.plan)
    col_sums, ordered, sizes, keys = None, [], [], []
    for b in plan.execute():
        cs, od = batch_sums(torch, b)
        col_sums = cs if col_sums is None else col_sums + cs
        ordered.append(od)
        sizes.append(b.nrows)
        if keys_out is not None:
            keys.append([b.column(k).data[:b.nrows].clone()
                         for k in SORT_KEYS])
        del b
    torch.cuda.synchronize()
    s.memory_catalog.wait_for_writes()
    seconds = time.perf_counter() - t0
    launches = dict(K.launches.snapshot(),
                    by_shape=K.launches.shape_snapshot())
    ordered = torch.stack(ordered).cpu().numpy().tolist()
    if keys_out is not None:
        keys_out.extend(torch.cat([k[i] for k in keys]).cpu().numpy()
                        for i in range(len(SORT_KEYS)))
    print(f"memory {label}: {sum(sizes)} rows in {len(sizes)} batches, "
          f"{seconds:.3f} s; outOfCoreRuns "
          f"{exec_metric(plan, 'outOfCoreRuns')}, outOfCoreMergeSteps "
          f"{exec_metric(plan, 'outOfCoreMergeSteps')}; catalog "
          f"{s.memory_catalog.stats()}", flush=True)
    return (sum(sizes), col_sums.cpu().numpy(), list(zip(sizes, ordered)),
            seconds, launches, s, plan)


def run_memory_sorts(torch, K, fm, F, lineitem, lexsort, total):
    """M1 (default memory): the out-of-core sort of lineitem, sorted,
    complete, a permutation of its input.  M2 (the 256 MiB budget): the
    same sort of lineitem's first ``M2_BATCHES`` input batches, bit for
    bit M1's sort of them at default memory, batch by batch."""
    from spark_rapids_tpu_torch.exec.basic import slice_batch
    n = lineitem.nrows
    t0 = time.perf_counter()
    want_sums = table_sums(torch, lineitem).cpu().numpy()
    print(f"memory M1: input checksums in {time.perf_counter() - t0:.3f} s",
          flush=True)
    keys = []
    rows, sums, per_batch, s1, l1, sess, plan = memory_sort(
        torch, K, fm, F, lineitem, tpch_conf(True), "M1 (default memory)",
        keys)
    total.add(l1)
    check(exec_metric(plan, "outOfCoreRuns") > 1
          and exec_metric(plan, "outOfCoreMergeSteps") > 1
          and len(per_batch) > 1,
          f"memory M1: the sort of {n} rows took the out-of-core merge "
          f"({exec_metric(plan, 'outOfCoreRuns')} runs, "
          f"{exec_metric(plan, 'outOfCoreMergeSteps')} merge steps, "
          f"{len(per_batch)} output batches)")
    sess.stop()
    check(rows == n, f"memory M1: {rows} rows out of {n}")
    price, okey, line = keys
    t0 = time.perf_counter()
    later = (price[1:] < price[:-1]) | ((price[1:] == price[:-1]) & (
        (okey[1:] > okey[:-1]) | ((okey[1:] == okey[:-1])
                                  & (line[1:] >= line[:-1]))))
    check(bool(later.all()),
          "memory M1: every output batch and every batch boundary sorted "
          "by (l_extendedprice desc, l_orderkey, l_linenumber)")
    want = lexsort.result()
    check(all(np.array_equal(a, b) for a, b in zip(keys, want)),
          f"memory M1: the three key columns equal numpy's lexsort of "
          f"them (lexsort {lexsort.seconds:.3f} s on the host, compared in "
          f"{time.perf_counter() - t0:.3f} s)")
    del keys, price, okey, line, later, want
    check(np.array_equal(sums, want_sums),
          f"memory M1: the order-free checksum of all "
          f"{len(lineitem.columns)} columns (strings too) equals the "
          "input's: the output is a permutation of the input")
    m = min(n, M2_BATCHES * BATCH_ROWS)
    head = slice_batch(lineitem, [0, m])[0]
    rows1, _, per_batch1, s1h, l1h, sess1, _ = memory_sort(
        torch, K, fm, F, head, tpch_conf(True),
        f"M1 over the first {m} rows (default memory)")
    total.add(l1h)
    sess1.stop()
    rows2, _, per_batch2, s2, l2, sess2, _ = memory_sort(
        torch, K, fm, F, head, memory_conf(tpch_conf(True)),
        f"M2 over the first {m} rows (spill budget {MEMORY_BUDGET} bytes)")
    total.add(l2)
    st = sess2.memory_catalog.stats()
    check(st["spilled_to_host_total"] > 0 and st["spilled_to_disk_total"] > 0
          and st["integrity_failures"] == 0,
          f"memory M2: spilled {st['spilled_to_host_total']} bytes to the "
          f"host and {st['spilled_to_disk_total']} to disk "
          f"({st['disk_file_bytes_total']} bytes of frames), restored "
          f"{st['restored_from_host_total']} from the host and "
          f"{st['restored_from_disk_total']} from disk, no integrity "
          "failure")
    print(f"memory M2 times: host copies {st['spill_to_host_ns'] / 1e6:.3f}"
          f" ms, checksums {st['checksum_ns'] / 1e6:.3f} ms, frame encode "
          f"{st['serialize_ns'] / 1e6:.3f} ms, disk writes "
          f"{st['disk_write_ns'] / 1e6:.3f} ms, disk reads "
          f"{st['disk_read_ns'] / 1e6:.3f} ms, restores "
          f"{st['restore_ns'] / 1e6:.3f} ms (host thread time)", flush=True)
    sess2.stop()
    check(rows2 == rows1 == m and per_batch2 == per_batch1,
          f"memory M2: {len(per_batch2)} output batches equal M1's over the "
          f"same {m} rows batch for batch, bit for bit (row counts and "
          "per-batch checksums)")
    print(f"memory M1 + M2: {s1 + s1h + s2:.3f} s (M1 {s1:.3f}, M1 over "
          f"{m} rows {s1h:.3f}, M2 {s2:.3f})", flush=True)
    return s1 + s1h + s2


def run_memory_tpch(torch, K, fm, tpch, batches, df_answers, root, total):
    """M3: 11 of the 22 TPC-H queries in memory under the spill budget, once
    each, equal to the tpch22 answers; q1 and q18 over the files phase's
    parquet with the pipeline on."""
    from spark_rapids_tpu_torch.api.session import TpuSession
    s = TpuSession(memory_conf(tpch_conf(True)), device=DEVICE)
    tables = {k: s.create_dataframe(b) for k, b in batches.items()}
    cat = s.memory_catalog
    spilled, merged = [], []
    for name in MEMORY_M3_QUERIES:
        query = tpch.QUERIES[name]
        K.launches.reset()
        fm.reset()
        t0 = time.perf_counter()
        q = query(tables)
        got = q.to_pandas()
        first = time.perf_counter() - t0
        total.add(dict(K.launches.snapshot(),
                       by_shape=K.launches.shape_snapshot()))
        ms = s.last_memory_stats
        steps = exec_metric(q._last_exec, "treeMergeSteps")
        runs = exec_metric(q._last_exec, "outOfCoreRuns")
        print(f"memory M3 {name}: {first:.3f} s; spilled {ms['spilledToHostBytes']} bytes to the host, "
              f"{ms['spilledToDiskBytes']} to disk; tree merge steps "
              f"{steps}; out-of-core runs {runs}; retries "
              f"{ms['retryCount']}", flush=True)
        if ms["spilledToHostBytes"]:
            spilled.append(name)
        if steps:
            merged.append(name)
        ok, why = frames_match(got, df_answers[name], QUERY_RTOL)
        check(ok, f"memory M3 {name}: under the {MEMORY_BUDGET}-byte budget "
              f"equals the tpch22 answer (floats within rel {QUERY_RTOL}) "
              f"{why}")
    print(f"memory M3: spilled {spilled}; tree-merged {merged}; catalog "
          f"{cat.stats()}", flush=True)
    check("q18" in spilled and "q18" in merged,
          "memory M3: q18 spilled and tree-merged")
    s.stop()
    sf = TpuSession(memory_conf(files_conf(True)), device=DEVICE)
    ftables = tpch.read_parquet(sf, root)
    for name in ("q1", "q18"):
        K.launches.reset()
        got = tpch.QUERIES[name](ftables).to_pandas()
        total.add(dict(K.launches.snapshot(),
                       by_shape=K.launches.shape_snapshot()))
        st = sf.last_pipeline_stats
        ok, why = frames_match(got, df_answers[name], QUERY_RTOL)
        check(ok and st.registered == st.batches > 0,
              f"memory M3 {name} over parquet, pipeline on, under the "
              f"budget: equals the in-memory answer; the pipeline "
              f"registered {st.registered} of {st.batches} in-flight "
              f"batches; spilled {sf.last_memory_stats} {why}")
    sf.stop()


def run_memory_oom(torch, K, tpch, batches, total):
    """M4: a real ``torch.OutOfMemoryError`` in q1's aggregate under a
    capped allocator, recovered by spill, retry and split."""
    from spark_rapids_tpu_torch.api.session import TpuSession
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.memory import retry as R
    li = batches["lineitem"]
    q1_cols = ("l_returnflag", "l_linestatus", "l_quantity",
               "l_extendedprice", "l_discount", "l_tax", "l_shipdate")
    narrow = ColumnarBatch({k: li.columns[k] for k in q1_cols}, li.nrows)
    conf = dict(tpch_conf(True), **{
        "spark.rapids.sql.tpu.maxBatchRows": OOM_BATCH_ROWS,
        "spark.rapids.tpu.pipeline.enabled": False})
    s = TpuSession(conf, device=DEVICE)
    q = tpch.q1({"lineitem": s.create_dataframe(narrow)})
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    want = q.to_pandas()
    peak = torch.cuda.max_memory_allocated() - base
    card = torch.cuda.get_device_properties(0).total_memory
    cap = base + int(OOM_HEADROOM * peak)
    torch.cuda.empty_cache()
    R.retry_metrics.reset()
    K.launches.reset()
    torch.cuda.set_per_process_memory_fraction(cap / card)
    t0 = time.perf_counter()
    try:
        got = q.to_pandas()
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    seconds = time.perf_counter() - t0
    total.add(dict(K.launches.snapshot(),
                   by_shape=K.launches.shape_snapshot()))
    snap = R.retry_metrics.snapshot()
    print(f"memory M4: q1 over {OOM_BATCH_ROWS}-row batches took {peak} "
          f"bytes past the {base} resident; capped at {cap} of {card} "
          f"bytes it ran in {seconds:.3f} s with retry_metrics {snap}",
          flush=True)
    check(snap["retryCount"] >= 1 and snap["splitAndRetryCount"] >= 1,
          f"memory M4: the caching allocator's torch.OutOfMemoryError was "
          f"recovered by with_retry ({snap['retryCount']} retries, "
          f"{snap['splitAndRetryCount']} splits)")
    ok, why = frames_match(got, want, QUERY_RTOL)
    check(ok, f"memory M4: the recovered q1 equals the uncapped run (floats "
          f"within rel {QUERY_RTOL}) {why}")
    s.stop()


def run_memory_injected(torch, K, F, batches, total):
    """M4's injected OOMs (``inject_oom``, the shapes of the retry tests)
    through project/filter, aggregate, join and sort at SF10, each equal
    to the uninjected run; the pipeline is off, so the injection and the
    operators share this thread."""
    from spark_rapids_tpu_torch.api.session import TpuSession
    from spark_rapids_tpu_torch.memory import retry as R
    s = TpuSession(dict(tpch_conf(True), **{
        "spark.rapids.tpu.pipeline.enabled": False}), device=DEVICE)
    t = {k: s.create_dataframe(b) for k, b in batches.items()}

    def on_card(df):
        """(rows, column sums, per-batch ordered sums) of the plan."""
        rows, sums, ordered = 0, None, []
        for b in s.plan(df.plan).execute():
            cs, od = batch_sums(torch, b)
            rows += b.nrows
            sums = cs if sums is None else sums + cs
            ordered.append((b.nrows, od))
        return rows, sums.cpu().numpy(), [
            (n, int(o)) for n, o in ordered]

    cases = [
        ("project/filter", 2, 0, "sums", t["lineitem"].filter(
            F.col("l_quantity") > 20).select(
            (F.col("l_orderkey") * 2 + 1).alias("x2"),
            F.col("l_extendedprice"), F.col("l_shipmode"))),
        ("aggregate", 2, 0, "frame", t["lineitem"].groupBy(
            "l_returnflag", "l_linestatus").agg(
            F.sum("l_extendedprice").alias("s"),
            F.count("l_quantity").alias("c"))),
        ("join", 2, 1, "sums", t["orders"].join(
            t["customer"], F.col("o_custkey") == F.col("c_custkey"))),
        ("sort", 1, 0, "ordered", t["orders"].orderBy("o_totalprice",
                                                      "o_orderkey")),
    ]
    for label, num, skip, how, df in cases:
        R.clear_injected_oom()
        K.launches.reset()
        want = df.to_pandas() if how == "frame" else on_card(df)
        total.add(dict(K.launches.snapshot(),
                       by_shape=K.launches.shape_snapshot()))
        R.retry_metrics.reset()
        R.inject_oom(num, skip=skip)
        try:
            got = df.to_pandas() if how == "frame" else on_card(df)
        finally:
            R.clear_injected_oom()
        snap = R.retry_metrics.snapshot()
        if how == "frame":
            ok, why = frames_match(got, want, QUERY_RTOL)
        else:
            ok = got[0] == want[0] and np.array_equal(got[1], want[1]) and (
                how != "ordered" or got[2] == want[2])
            why = f"{got[0]} rows vs {want[0]}"
        check(ok and snap["retryCount"] >= 1,
              f"memory M4 {label} at SF{TPCH_SF} with {num} injected OOMs "
              f"(skip {skip}): the uninjected answer "
              f"({'bit for bit, batch by batch' if how == 'ordered' else 'rows and checksums' if how == 'sums' else f'floats within rel {QUERY_RTOL}'}); "
              f"retry_metrics {snap} {why}")
    s.stop()


def run_memory_windows(torch, K, fm, batches, total):
    """M5: TPC-DS q47 and q67 (windows over their sorts) run chunked,
    and ``M5_BUDGET_QUERY`` again under the spill budget, with the same
    answer."""
    from spark_rapids_tpu_torch.models import tpcds
    answers = {}
    for budget in (False, True):
        conf = memory_conf(tpch_conf(True)) if budget else tpch_conf(True)
        s = tpcds_session(conf, batches)
        for name in (M5_BUDGET_QUERY,) if budget else M5_QUERIES:
            K.launches.reset()
            t0 = time.perf_counter()
            df = s.sql(tpcds.QUERIES[name])
            got = df.to_pandas()
            seconds = time.perf_counter() - t0
            total.add(dict(K.launches.snapshot(),
                           by_shape=K.launches.shape_snapshot()))
            chunks = exec_metric(df._last_exec, "windowChunks")
            runs = exec_metric(df._last_exec, "outOfCoreRuns")
            ms = s.last_memory_stats
            label = f"memory M5 tpcds {name}" + (
                f" under the {MEMORY_BUDGET}-byte budget" if budget else "")
            print(f"{label}: {seconds:.3f} s, {len(got)} rows, window chunks "
                  f"{chunks}, out-of-core runs {runs}, {ms}", flush=True)
            if not budget:
                check(chunks > 1, f"{label}: the window ran {chunks} chunks")
                answers[name] = got
            else:
                check(ms["spilledToHostBytes"] > 0
                      and got.equals(answers[name]),
                      f"{label}: its sorts spilled "
                      f"{ms['spilledToHostBytes']} bytes and the answer "
                      "equals the unbudgeted run's bit for bit")
        s.stop()


def run_memory_phase(torch, K, fm, F, tpch, batches, df_answers, root,
                     lexsort, launches):
    """M1-M4 of the memory phase, with the spill catalog's and the retry
    counters' totals."""
    from spark_rapids_tpu_torch.memory.retry import retry_metrics
    t0 = time.perf_counter()
    run_memory_sorts(torch, K, fm, F, batches["lineitem"], lexsort,
                     launches)
    t1 = time.perf_counter()
    run_memory_tpch(torch, K, fm, tpch, batches, df_answers, root, launches)
    t2 = time.perf_counter()
    retry_metrics.reset()
    run_memory_oom(torch, K, tpch, batches, launches)
    run_memory_injected(torch, K, F, batches, launches)
    print(f"memory phase M1-M4: M1 + M2 {t1 - t0:.3f} s, M3 {t2 - t1:.3f} "
          f"s, M4 {time.perf_counter() - t2:.3f} s; launches "
          f"{launches.counts}", flush=True)


def check_memory_launches(launches, seconds):
    print(f"memory phase {sum(seconds.values()):.3f} s ("
          + ", ".join(f"{k} {v:.3f} s" for k, v in seconds.items())
          + f"); launches {launches.counts}", flush=True)
    for k in ("masked_multi_reduce", "hash_insert", "hash_probe"):
        check(launches.counts[k] >= 1,
              f"memory launched {k} {launches.counts[k]}x")


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
    started = time.perf_counter()
    # the TPC-H tables are generated in a process of their own while the
    # card checks its kernels, and come back through a file
    import atexit
    import shutil
    import tempfile
    scratch = tempfile.mkdtemp(prefix="chip_smoke_")
    atexit.register(shutil.rmtree, scratch, True)
    tpch_gen = start_process(generated_tables, TPCH_SF, scratch)
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
    dist_metrics = dist_metric_objs()
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

    # fact-dim hash join: 2^26 fact rows, 2^19 dim rows, 16 probe batches
    # (while the TPC-H tables are still being generated)
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

    # TPC-H at SF10: lineitem 60M rows, orders 15M, partsupp 8M, part 2M,
    # customer 1.5M, supplier 100k; every table on the card once.  The
    # CPU's answers at SF0.1 (check b) are computed meanwhile in a process
    # of their own
    from spark_rapids_tpu_torch.models import tpch
    tpch_cpu = start_process(tpch22_cpu_answers, TPCH_CHECK_SF)
    t0 = time.perf_counter()
    tpch_cols, gen_s = receive_tables(*tpch_gen, f"TPC-H SF{TPCH_SF}")
    print(f"TPC-H SF{TPCH_SF}: all eight tables generated in {gen_s:.3f} "
          "s in a process of their own, beside the kernel checks; "
          f"waited {time.perf_counter() - t0:.3f} s for them", flush=True)
    # the memory phase's oracle, sorting on the host meanwhile (the
    # nested phase's comes from the generating process)
    from spark_rapids_tpu_torch.models import nested as ND
    lexsort = lexsort_oracle(tpch_cols["lineitem"])
    t0 = time.perf_counter()
    tpch_batches = device_tables(tpch_cols, device)
    torch.cuda.synchronize()
    print(f"TPC-H SF{TPCH_SF}: on the card in "
          f"{time.perf_counter() - t0:.3f} s, {table_bytes(tpch_batches)} "
          "bytes; rows " + ", ".join(
              f"{k} {b.nrows}" for k, b in tpch_batches.items()), flush=True)
    t0 = time.perf_counter()
    q3_rows = sum(tpch_batches[k].nrows
                  for k in ("customer", "orders", "lineitem"))
    want3, n_groups3 = q3_oracle(tpch_cols)
    print(f"q3 SF{TPCH_SF}: {q3_rows} input rows, {n_groups3} groups; "
          f"pandas oracle {time.perf_counter() - t0:.3f} s", flush=True)
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
        tables = {name: s.create_dataframe(b)
                  for name, b in tpch_batches.items()}
        label = (f"q3 SF{TPCH_SF} "
                 f"({'hash on' if enabled else 'hash off'})")
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

    # all 22 TPC-H queries at SF10 (hash on, against hash off and numpy),
    # then at SF0.1 against the engine on the CPU
    tpch_launches = PathLaunches(K.launches.NAMES)
    df_answers, mem_rates = run_tpch22(torch, K, fm, tpch, tpch_cols,
                                       tpch_batches, card_line,
                                       tpch_launches)
    for k in ("masked_multi_reduce", "hash_insert", "hash_probe"):
        check(tpch_launches.counts[k] >= 1,
              f"tpch22 launched {k} {tpch_launches.counts[k]}x")
    total.extend(tpch_launches)
    check_no_recovery("tpch22")

    # the strings_dates phase's SF0.1 answers on the CPU, meanwhile
    sd_cpu = start_process(strings_dates_cpu_answers, SD_CHECK_SF)

    # the fallback phase over the same tables, against the tpch22 answers
    fallback_launches = PathLaunches(K.launches.NAMES)
    t0 = time.perf_counter()
    fb = run_fallback(torch, K, fm, tpch, tpch_batches, df_answers,
                      card_line, fallback_launches)
    print(f"fallback phase {time.perf_counter() - t0:.3f} s ("
          + ", ".join(f"{k} {fb[k]:.3f} s" for k in ("F1", "F2", "F3", "F4"))
          + f"); launches {fallback_launches.counts}", flush=True)
    for k in ("hash_insert", "hash_probe"):
        check(fallback_launches.counts[k] >= 1,
              f"fallback launched {k} {fallback_launches.counts[k]}x")
    total.extend(fallback_launches)
    check_no_recovery("fallback")

    # the strings_dates function pass's references (the engine on the CPU
    # and Python), computed while the card runs the tpch_sql phase
    function_refs = start_function_pass(tpch_batches, scratch)

    # the same 22 queries as SQL text through session.sql, each once
    from spark_rapids_tpu_torch.models import tpch_sql
    sql_launches = PathLaunches(K.launches.NAMES)
    t0 = time.perf_counter()
    sql_rates = run_tpch_sql(torch, K, fm, tpch_sql, tpch_batches,
                             df_answers, card_line, sql_launches)
    print(f"tpch_sql phase {time.perf_counter() - t0:.3f} s; launches "
          f"{sql_launches.counts}", flush=True)
    for k in ("hash_insert", "hash_probe"):
        check(sql_launches.counts[k] >= 1,
              f"tpch_sql launched {k} {sql_launches.counts[k]}x")
    total.extend(sql_launches)
    check_no_recovery("tpch_sql")

    # the nested and udf phases' SF0.1 answers on the CPU, meanwhile
    nd_cpu = start_process(nested_cpu_answers, ND_CHECK_SF)
    udf_cpu = start_process(udf_cpu_answers, UDF_CHECK_SF)

    # the strings_dates phase: SD1-SD10 over the same tables
    from spark_rapids_tpu_torch.models import strings_dates
    sd_launches = PathLaunches(K.launches.NAMES)
    sd_s = run_strings_dates(torch, K, fm, strings_dates, tpch_batches,
                             card_line, sd_launches, sd_cpu, function_refs)
    print(f"strings_dates phase {sd_s:.3f} s (budget {SD_BUDGET_S} s); "
          f"launches {sd_launches.counts}", flush=True)
    for k in ("hash_insert", "hash_probe"):
        check(sd_launches.counts[k] >= 1,
              f"strings_dates launched {k} {sd_launches.counts[k]}x")
    total.extend(sd_launches)
    check_no_recovery("strings_dates")

    # the nested phase: ND1-ND7 over the same tables
    nd_launches = PathLaunches(K.launches.NAMES)
    nd_s = run_nested(torch, K, fm, ND, tpch_batches, card_line,
                      nd_launches, lambda: receive_nested_refs(
                          *tpch_gen, "nested answers"), nd_cpu, scratch)
    print(f"nested phase {nd_s:.3f} s (budget {ND_BUDGET_S} s); launches "
          f"{nd_launches.counts}", flush=True)
    for k in ("masked_multi_reduce", "hash_insert", "hash_probe"):
        check(nd_launches.counts[k] >= 1,
              f"nested launched {k} {nd_launches.counts[k]}x")
    total.extend(nd_launches)
    check_no_recovery("nested")

    # the udf phase: UD1-UD9 over the same tables
    from spark_rapids_tpu_torch.models import udf as UD
    udf_launches = PathLaunches(K.launches.NAMES)
    udf_s = run_udf(torch, K, fm, UD, tpch_batches, card_line,
                    udf_launches, lambda: receive_udf_refs(
                        *tpch_gen, "udf answers"), udf_cpu,
                    df_answers["q6"]["revenue"][0])
    print(f"udf phase {udf_s:.3f} s (budget {UDF_BUDGET_S} s); launches "
          f"{udf_launches.counts}", flush=True)
    for k in ("masked_multi_reduce", "hash_insert", "hash_probe"):
        check(udf_launches.counts[k] >= 1,
              f"udf launched {k} {udf_launches.counts[k]}x")
    total.extend(udf_launches)
    check_no_recovery("udf")

    serving_launches = PathLaunches(K.launches.NAMES)
    serving_s = run_serving(torch, K, tpch, tpch_batches, df_answers,
                            card_line, serving_launches, scratch)
    print(f"serving phase {serving_s:.3f} s (budget {SERVING_BUDGET_S} "
          f"s); launches {serving_launches.counts}", flush=True)
    for k in ("masked_multi_reduce", "hash_insert", "hash_probe"):
        check(serving_launches.counts[k] >= 1,
              f"serving launched {k} {serving_launches.counts[k]}x")
    total.extend(serving_launches)

    # the sharded_tpch phase, in three passes: the 44 queries in memory
    # here, the 22 over the files phase's parquet inside that phase, and
    # three TPC-DS queries after the tpcds phase
    sharded_launches = PathLaunches(K.launches.NAMES)
    sharded_s = {}
    ckpt0 = ckpt_watch()
    t0 = time.perf_counter()
    run_sharded_tpch(torch, K, fm, tpch, tpch_sql, tpch_batches, df_answers,
                     mem_rates, sql_rates, card_line, sharded_launches)
    sharded_s["in memory"] = time.perf_counter() - t0
    print(f"sharded_tpch in memory {sharded_s['in memory']:.3f} s; "
          f"launches {sharded_launches.counts}", flush=True)
    ckpt_report("sharded_tpch in memory", ckpt0, card_line)
    check_no_recovery("sharded_tpch in memory")

    # the reuse phase: the result cache, templates, a sharded resume and
    # the shared stage store, over the same tables
    reuse_launches = PathLaunches(K.launches.NAMES)
    reuse_s = run_reuse(torch, K, fm, tpch, tpch_batches, df_answers,
                        card_line, reuse_launches, scratch)
    print(f"reuse phase {reuse_s:.3f} s (budget {REUSE_BUDGET_S} s); "
          f"launches {reuse_launches.counts}", flush=True)
    for k in ("masked_multi_reduce", "hash_insert", "partition_histogram"):
        check(reuse_launches.counts[k] >= 1,
              f"reuse launched {k} {reuse_launches.counts[k]}x")
    total.extend(reuse_launches)
    ckpt0 = ckpt_watch()

    def sharded_files(root):
        t_files = time.perf_counter()
        # keep time for the TPC-DS pass
        deadline = t_files + SHARDED_BUDGET_S - 40.0 - sharded_s["in memory"]
        run_sharded_files(torch, K, fm, tpch, root, tpch_batches,
                          df_answers, card_line, sharded_launches, deadline)
        sharded_s["files"] = time.perf_counter() - t_files
        print(f"sharded_tpch files {sharded_s['files']:.3f} s", flush=True)

    # the memory phase (M1-M4), after the files phase over its parquet
    memory_launches = PathLaunches(K.launches.NAMES)
    memory_s = {}

    def after_files(root):
        sharded_files(root)
        t_mem = time.perf_counter()
        run_memory_phase(torch, K, fm, F, tpch, tpch_batches, df_answers,
                         root, lexsort, memory_launches)
        memory_s["M1-M4"] = time.perf_counter() - t_mem

    # the 22 queries over parquet files the port writes from the same
    # tables, against this run's in-memory answers
    files_launches = PathLaunches(K.launches.NAMES)
    t0 = time.perf_counter()
    launches_before = dict(sharded_launches.counts)
    run_files(torch, K, fm, tpch, tpch_batches, df_answers, mem_rates,
              card_line, files_launches, then=after_files)
    files_s = time.perf_counter() - t0 - sharded_s["files"] \
        - memory_s["M1-M4"]
    print(f"files phase {files_s:.3f} s; launches "
          f"{files_launches.counts}; then the sharded_tpch file pass "
          f"launches " + json.dumps({k: sharded_launches.counts[k]
                                     - launches_before[k]
                                     for k in K.launches.NAMES}),
          flush=True)
    for k in ("masked_multi_reduce", "hash_insert", "hash_probe"):
        check(files_launches.counts[k] >= 1,
              f"files launched {k} {files_launches.counts[k]}x")
    total.extend(files_launches)
    del tpch_cols, tpch_batches, df_answers, lexsort
    check_tpch22_cpu(torch, tpch, TPCH_CHECK_SF, *tpch_cpu)

    # TPC-DS at SF50 (half the rows of SF10's lineitem in the fact
    # table): the 29 queries through session.sql, hash on; the CPU's
    # answers at SF1 (check c) are computed meanwhile in a process of
    # their own
    from spark_rapids_tpu_torch.models import tpcds
    cpu_proc, cpu_conn = start_process(tpcds_cpu_answers,
                                           TPCDS_CHECK_SF)
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    ds_data = tpcds.gen_tables(sf=TPCDS_SF)
    print(f"TPC-DS SF{TPCDS_SF}: {len(ds_data)} tables generated in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    t0 = time.perf_counter()
    ds_batches = tpcds_device_tables(ds_data, device)
    del ds_data
    torch.cuda.synchronize()
    print(f"TPC-DS SF{TPCDS_SF}: on the card in "
          f"{time.perf_counter() - t0:.3f} s, {table_bytes(ds_batches)} "
          "bytes; rows " + ", ".join(
              f"{k} {b.nrows}" for k, b in ds_batches.items()), flush=True)
    ds_launches = PathLaunches(K.launches.NAMES)
    ds_answers, ds_rates = run_tpcds(torch, K, fm, tpcds, ds_batches,
                                     card_line, ds_launches)
    for k in ("hash_insert", "hash_probe"):
        check(ds_launches.counts[k] >= 1,
              f"tpcds launched {k} {ds_launches.counts[k]}x")
    total.extend(ds_launches)
    print(f"tpcds phase (SF{TPCDS_SF}) {time.perf_counter() - t_phase:.3f}"
          f" s; launches {ds_launches.counts}", flush=True)
    # the memory phase's M5, on the tpcds phase's tables
    t0 = time.perf_counter()
    run_memory_windows(torch, K, fm, ds_batches, memory_launches)
    memory_s["M5"] = time.perf_counter() - t0
    check_memory_launches(memory_launches, memory_s)
    total.extend(memory_launches)
    t0 = time.perf_counter()
    run_sharded_tpcds(torch, K, fm, ds_batches, ds_answers, ds_rates,
                      card_line, sharded_launches)
    sharded_s["tpcds"] = time.perf_counter() - t0
    print(f"sharded_tpch phase {sum(sharded_s.values()):.3f} s ("
          + ", ".join(f"{k} {v:.3f} s" for k, v in sharded_s.items())
          + f"); launches {sharded_launches.counts}", flush=True)
    for k in ("masked_multi_reduce", "partition_histogram"):
        check(sharded_launches.counts[k] >= 1,
              f"sharded_tpch launched {k} {sharded_launches.counts[k]}x")
    total.extend(sharded_launches)
    check_no_recovery("sharded_tpch, files, memory, tpcds")
    ckpt_report("sharded_tpch files and tpcds, files, memory, tpcds",
                ckpt0, card_line)

    # the tpcds_decimal pass over the same tables with decimal money
    # columns, then the numeric pass over its store_sales
    dec_launches = PathLaunches(K.launches.NAMES)
    t0 = time.perf_counter()
    dec, _ = run_tpcds_decimal(torch, K, fm, tpcds, ds_batches, ds_answers,
                               card_line, dec_launches)
    print(f"tpcds_decimal phase (SF{TPCDS_SF}) "
          f"{time.perf_counter() - t0:.3f} s; launches "
          f"{dec_launches.counts}", flush=True)
    for k in ("hash_insert", "hash_probe"):
        check(dec_launches.counts[k] >= 1,
              f"tpcds_decimal launched {k} {dec_launches.counts[k]}x")
    total.extend(dec_launches)
    check_no_recovery("tpcds_decimal")
    del ds_batches, ds_answers
    numeric_launches = PathLaunches(K.launches.NAMES)
    t0 = time.perf_counter()
    run_numeric(torch, K, fm, dec, card_line, numeric_launches)
    print(f"numeric phase {time.perf_counter() - t0:.3f} s; launches "
          f"{numeric_launches.counts}", flush=True)
    total.extend(numeric_launches)
    del dec
    # at SF1 against the engine on the CPU, and the decimal files check
    check_tpcds_cpu(torch, tpcds, TPCDS_CHECK_SF, cpu_proc, cpu_conn)
    phase_launches = {"tpch22": tpch_launches.counts,
                      "fallback": fallback_launches.counts,
                      "tpch_sql": sql_launches.counts,
                      "strings_dates": sd_launches.counts,
                      "nested": nd_launches.counts,
                      "udf": udf_launches.counts,
                      "serving": serving_launches.counts,
                      "files": files_launches.counts,
                      "tpcds": ds_launches.counts,
                      "tpcds_decimal": dec_launches.counts,
                      "numeric": numeric_launches.counts,
                      "sharded_tpch": sharded_launches.counts,
                      "reuse": reuse_launches.counts,
                      "memory": memory_launches.counts}

    # NCCL allocates its buffers outside PyTorch's caching allocator,
    # whose cache may by now hold nearly the whole card (83.7e9 bytes
    # reserved against 53e9 at the peak in a run with the files phase,
    # where the group's first all-to-all then failed): hand the cached
    # blocks back first
    torch.cuda.empty_cache()
    host = torch.cuda.host_memory_stats()
    print(f"before NCCL: device reserved {torch.cuda.memory_reserved()} "
          f"bytes (peak allocated {torch.cuda.max_memory_allocated()}); "
          f"pinned host {host.get('allocated_bytes.current')} bytes (peak "
          f"{host.get('allocated_bytes.peak')}, "
          f"{host.get('num_host_alloc')} cudaHostAlloc calls)", flush=True)

    # one real process group: NCCL with one rank, against one logical
    # shard on the same data
    import os
    import tempfile
    import torch.distributed as dist
    pg_data = gen_host(PG_ROWS, seed=SEED + 1)
    s = TpuSession({"spark.rapids.sql.distributed.numShards": 1})
    want_pg = make_q1(F, s.create_dataframe(pg_data)).to_pandas()
    want_pg_stats = dict(s.last_dist_stats)["aggregate"]
    # TPC-H q1 at SF1: two string group keys, as dictionary codes
    pg_cols = tpch.gen_table_columns(PG_TPCH_SF)
    pg_li = device_tables({"lineitem": pg_cols["lineitem"]}, device)
    want_pg_q1 = tpch.q1({"lineitem": s.create_dataframe(
        pg_li["lineitem"])}).to_pandas()
    check(s.last_dist_explain == "distributed",
          f"TPC-H q1 SF{PG_TPCH_SF} on one logical shard ran distributed "
          f"({s.last_dist_explain!r})")
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
            q1_label = f"TPC-H q1 SF{PG_TPCH_SF} over a one-rank NCCL group"
            got_q1, lq1, mq1, _ = drive(
                torch, K, fm, tpch.q1({"lineitem": s.create_dataframe(
                    pg_li["lineitem"])}), pg_li["lineitem"].nrows,
                card_line, q1_label, extra=dist_metrics)
            check_dist(s, q1_label, lq1, mq1)
        finally:
            dist.destroy_process_group()
    ok, why = frames_match(got_q1, want_pg_q1, PATH_RTOL)
    check(ok, f"{q1_label}: answer equals one logical shard's (floats "
          f"within rel {PATH_RTOL}) {why}")
    want_o = tpch_q1_oracle(pg_cols)
    check(got_q1["l_returnflag"].tolist() == want_o["l_returnflag"]
          and got_q1["l_linestatus"].tolist() == want_o["l_linestatus"]
          and got_q1["count_order"].tolist()
          == want_o["count_order"].tolist()
          and all(np.allclose(got_q1[c].to_numpy(), want_o[c],
                              rtol=QUERY_RTOL, atol=0)
                  for c in ("sum_qty", "sum_base_price", "sum_disc_price",
                            "sum_charge", "avg_qty", "avg_price",
                            "avg_disc")),
          f"{q1_label}: groups, order and counts equal numpy, sums within "
          f"rel {QUERY_RTOL}")
    total.add(lq1)
    del pg_cols, pg_li
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
    check_no_recovery("numeric and the NCCL group")
    check(all(v >= 1 for v in total.counts.values()),
          f"every kernel ran on the main path: {total.counts}")

    print(f"chip_smoke: every phase in {time.perf_counter() - started:.1f}"
          " s", flush=True)

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
             "launches_by_phase": {p: c[name]
                                   for p, c in phase_launches.items()},
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
