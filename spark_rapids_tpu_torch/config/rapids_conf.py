"""Typed configuration: the keys this port reads, under the JAX package's
names, defaults and validation (``spark_rapids_tpu/config/rapids_conf.py``).

A conf dict written for the JAX engine passes unchanged as long as it only
sets these keys; any other ``spark.rapids.*`` key is rejected, because a
knob the port does not read must fail loudly rather than silently no-op.
Besides the registered keys the port reads four families of dynamic
keys, as the JAX package does (``_known_key``):
``spark.rapids.sql.exec.<Name>`` and ``spark.rapids.sql.expression.<Name>``
switch one operator or expression class off (``op_enabled``; a name the
planner does not know is rejected, so a typo still fails),
``spark.rapids.sql.optimizer.{tpu,cpu}OpCost.<Op>`` set the cost-based
optimizer's per-row weights (``op_cost``), and
``spark.rapids.tpu.watchdog.deadline.<point>`` sets one monitored
section's deadline (``watchdog_deadline_ms``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class ConfEntry:
    """One typed config entry."""

    def __init__(self, key: str, default: Any, doc: str, conv: Callable,
                 validator: Optional[Callable[[Any], Optional[str]]] = None):
        self.key = key
        self.default = default
        self.doc = doc
        self.conv = conv
        self.validator = validator

    def get(self, settings: Dict[str, Any]) -> Any:
        raw = settings.get(self.key)
        if raw is None:
            return self.default
        value = self.conv(raw) if isinstance(raw, str) else raw
        if self.validator is not None:
            err = self.validator(value)
            if err:
                raise ValueError(f"{self.key}={value!r}: {err}")
        return value


def _to_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


def _to_int(s: str) -> int:
    return int(s)


def _to_float(s: str) -> float:
    return float(s)


def _positive(v):
    return None if v > 0 else "must be positive"


def _fraction(v):
    return None if 0.0 <= v <= 1.0 else "must be in [0, 1]"


_REGISTRY: Dict[str, ConfEntry] = {}


def conf(key, default, doc, conv=str, validator=None) -> ConfEntry:
    assert key not in _REGISTRY, f"duplicate conf {key}"
    entry = ConfEntry(key, default, doc, conv, validator)
    _REGISTRY[key] = entry
    return entry


BATCH_SIZE_BYTES = conf(
    "spark.rapids.sql.batchSizeBytes", 1 << 31,
    "Target size in bytes for columnar batches; hard-capped at 2 GiB.  "
    "The in-memory scan cuts its input into batches of at most this many "
    "bytes.", _to_int,
    lambda v: None if 0 < v <= (1 << 31) else "must be in (0, 2GiB]")

BATCH_ROW_CAPACITY = conf(
    "spark.rapids.sql.tpu.maxBatchRows", 1 << 22,
    "Maximum rows per device batch: the in-memory scan cuts its input "
    "into batches of at most this many rows, so a large table runs "
    "partial aggregation per batch and then one merge.", _to_int,
    _positive)

FUSION_ENABLED = conf(
    "spark.rapids.tpu.fusion.enabled", True,
    "Whole-stage fusion (exec/fusion.py): the planner collapses maximal "
    "Filter/Project chains, and the chain feeding an aggregate, into one "
    "stage whose predicates travel as a row mask and whose rows compact "
    "once at the stage boundary.  False runs one stage per operator; "
    "results are identical either way.", _to_bool)

PALLAS_HASH_ENABLED = conf(
    "spark.rapids.tpu.pallas.hash.enabled", False,
    "Hash-table group-by (ops/kernels.py hash_insert): where the dense "
    "coded directory cannot hold the key space, an open-addressing table "
    "over the 64-bit coded key replaces the sort path.  A probe chain "
    "past 256 steps, or more groups than slots, raises the overflow flag: "
    "the stage discards the hash output and re-runs the exact sort path, "
    "counted in hashOverflowFallbacks.  Results are identical either "
    "way.", _to_bool)

PALLAS_HASH_TABLE_SLOTS = conf(
    "spark.rapids.tpu.pallas.hash.tableSlots", 1 << 16,
    "Slot count of the hash group-by table (power of two).  Bounds the "
    "distinct groups per launch: more groups than slots overflow to the "
    "sort path.", _to_int,
    lambda v: None if v >= 64 and (v & (v - 1)) == 0
    else "must be a power of two >= 64")

JOIN_OUTPUT_BATCH_ROWS = conf(
    "spark.rapids.sql.join.outputBatchRows", 1 << 22,
    "Join output chunk size in rows: bounds the device memory of each "
    "emitted batch (exec/join.py emits the joined rows in chunks of at "
    "most this many).", _to_int, _positive)

DISTRIBUTED_ENABLED = conf(
    "spark.rapids.sql.distributed.enabled", True,
    "When the session holds a shard group, offer every query plan to the "
    "distributed planner (parallel/dist_planner.py) before the "
    "single-device engine; unsupported plans fall back with the reason on "
    "session.last_dist_explain.", _to_bool)

DISTRIBUTED_NUM_SHARDS = conf(
    "spark.rapids.sql.distributed.numShards", 0,
    "Build a group of N logical shards on the session's device at session "
    "start and run supported queries distributed over it (0 = only when "
    "a process_group is passed to TpuSession).", _to_int,
    lambda v: None if v >= 0 else "must be >= 0")

BROADCAST_JOIN_THRESHOLD_ROWS = conf(
    "spark.rapids.sql.join.broadcastThresholdRows", 1 << 16,
    "Build sides at or below this many rows broadcast instead of "
    "shuffling (autoBroadcastJoinThreshold analog, in rows).",
    _to_int, _positive)


# -------------------------------------------------------------- file I/O --

_READER_TYPES = ("PERFILE", "COALESCING", "MULTITHREADED", "AUTO")


def _reader_type_ok(v):
    return None if v in _READER_TYPES else \
        "must be PERFILE, COALESCING, MULTITHREADED or AUTO"


READER_BATCH_SIZE_ROWS = conf(
    "spark.rapids.sql.reader.batchSizeRows", 1 << 20,
    "Soft cap on rows per batch produced by file scans.", _to_int,
    _positive)

WRITER_MAX_ROWS_PER_FILE = conf(
    "spark.rapids.sql.writer.maxRowsPerFile", 1 << 22,
    "Max rows per output file for dataset writes.", _to_int, _positive)

# per format: the scan switches (a disabled format hands the scan to the
# CPU fallback, exec/fallback.py), the multi-file reader strategy and its
# thread pool
FORMAT_ENABLED, FORMAT_READ_ENABLED, READER_TYPE = {}, {}, {}
READ_NUM_THREADS, MAX_NUM_FILES_PARALLEL = {}, {}
for _fmt, _name in (("parquet", "parquet"), ("orc", "ORC"),
                    ("csv", "CSV")):
    _base = f"spark.rapids.sql.format.{_fmt}"
    FORMAT_ENABLED[_fmt] = conf(
        f"{_base}.enabled", True,
        f"Use the engine's columnar {_name} scan; when false a {_name} "
        "scan runs on the CPU fallback (arrow record batches through "
        "pandas, then uploaded), with this key as its reason.", _to_bool)
    FORMAT_READ_ENABLED[_fmt] = conf(
        f"{_base}.read.enabled", True,
        f"Read side of the {_name} format switch: when false a {_name} "
        "scan runs on the CPU fallback.", _to_bool)
    READER_TYPE[_fmt] = conf(
        f"{_base}.reader.type", "AUTO",
        f"{_name} reader strategy over several files: PERFILE, "
        "COALESCING, MULTITHREADED or AUTO (io/multifile.py).", str,
        _reader_type_ok)
    READ_NUM_THREADS[_fmt] = conf(
        f"{_base}.multiThreadedRead.numThreads", 8,
        f"Thread-pool size of the multithreaded {_name} reader.",
        _to_int, _positive)
    MAX_NUM_FILES_PARALLEL[_fmt] = conf(
        f"{_base}.multiThreadedRead.maxNumFilesParallel", 4,
        f"Max {_name} files decoded ahead by the multithreaded reader.",
        _to_int, _positive)

PIPELINE_ENABLED = conf(
    "spark.rapids.tpu.pipeline.enabled", True,
    "Drive query execution through the asynchronous pipeline "
    "(exec/pipeline.py): a worker thread pulls the operator batches "
    "(reader decode, host->device upload, kernel launches) while the "
    "driving thread consumes results.  Batch contents and order are "
    "identical to the sequential pull loop.", _to_bool)

PIPELINE_DEPTH = conf(
    "spark.rapids.tpu.pipeline.depth", 2,
    "Maximum batches in flight between the pipeline worker and the "
    "consuming thread.", _to_int, _positive)


# ---------------------------------------------------------------- memory --
# the spill catalog (memory/spill.py), OOM retry (memory/retry.py) and the
# operators that hold state (exec/sort.py, exec/aggregate.py,
# exec/window.py), sized by api/session.py

SORT_OOC_THRESHOLD = conf(
    "spark.rapids.sql.sort.outOfCoreThresholdBytes", 256 << 20,
    "Total input bytes above which a sort of several batches takes the "
    "windowed out-of-core merge (sorted spillable runs, bounded merge "
    "windows) instead of one concatenated device sort.", _to_int,
    _positive)

SORT_OOC_WINDOW_ROWS = conf(
    "spark.rapids.sql.sort.outOfCoreWindowRows", 1 << 16,
    "Rows pulled from each sorted run per merge step of the out-of-core "
    "sort; bounds the merge working set to about 2 * runs * window "
    "rows.", _to_int, _positive)

AGG_MERGE_CHUNK_ROWS = conf(
    "spark.rapids.sql.agg.mergeChunkRows", 1 << 22,
    "Partial-aggregate batches merge in chunks of at most this many rows "
    "(a tree reduction) instead of one concatenation of every partial, "
    "so the merge working set stays bounded.", _to_int, _positive)

UDF_COMPILER_ENABLED = conf(
    "spark.rapids.sql.udfCompiler.enabled", False,
    "Compile Python UDF bytecode into TPU expression trees "
    "(reference udf-compiler, RapidsConf.scala:519).  As in the JAX "
    "package, nothing reads it: F.udf compiles whenever it can.",
    _to_bool)

PYTHON_NUM_WORKERS = conf(
    "spark.rapids.sql.python.numWorkers", 0,
    "Worker processes for black-box Python UDF evaluation (0 = inline "
    "on the driver thread; the concurrentPythonWorkers analog). "
    "Spawn-started and reused across batches; unpicklable functions "
    "fall back to inline.", _to_int,
    lambda v: None if v >= 0 else "must be >= 0")

CONCURRENT_TPU_TASKS = conf(
    "spark.rapids.sql.concurrentTpuTasks", 1,
    "Number of tasks that may issue work to the device concurrently "
    "(the session's admission semaphore).", _to_int, _positive)

MEM_POOL_FRACTION = conf(
    "spark.rapids.memory.tpu.allocFraction", 0.9,
    "Fraction of device memory that spillable batches may hold before "
    "the catalog spills them.", _to_float, _fraction)

MEM_MIN_ALLOC_FRACTION = conf(
    "spark.rapids.memory.tpu.minAllocFraction", 0.25,
    "Minimum fraction of device memory the spill budget must reach; "
    "session start fails when the reserve and the limits squeeze it "
    "below this.", _to_float, _fraction)

MEM_MAX_ALLOC_FRACTION = conf(
    "spark.rapids.memory.tpu.maxAllocFraction", 1.0,
    "Ceiling on the fraction of device memory the spill budget may "
    "claim, applied after the reserve is subtracted.", _to_float,
    _fraction)

MEM_RESERVE = conf(
    "spark.rapids.memory.tpu.reserve", 640 << 20,
    "Bytes of device memory held back from the spill budget for the "
    "runtime and kernels' scratch.", _to_int,
    lambda v: None if v >= 0 else "must be >= 0")

HOST_SPILL_STORAGE_SIZE = conf(
    "spark.rapids.memory.host.spillStorageSize", 1 << 30,
    "Bytes of host memory used as the first spill tier before disk.",
    _to_int, _positive)

SPILL_DISK_WRITE_THREADS = conf(
    "spark.rapids.memory.spill.diskWriteThreads", 2,
    "Concurrent writer threads that demote host-tier batches to disk; "
    "the native pager releases the GIL, so writes overlap.", _to_int,
    _positive)

DEVICE_MEMORY_LIMIT = conf(
    "spark.rapids.memory.tpu.deviceLimitBytes", 0,
    "Device budget in bytes for spillable batches; 0 = the device's "
    "memory less the reserve, times allocFraction.", _to_int,
    lambda v: None if v >= 0 else "must be >= 0")

SHUFFLE_COMPRESSION_CODEC = conf(
    "spark.rapids.shuffle.compression.codec", "lz4",
    "Codec of host frames (the spill catalog's disk tier): none, zrle "
    "(zero runs only), lz4 (zrle and the LZ4-class lzb, the smaller per "
    "buffer; zstd accepted as an alias).", str,
    lambda v: None if v in ("none", "zrle", "lz4", "zstd")
    else "unknown codec")

ENCODING_STORAGE_HOST_CODEC = conf(
    "spark.rapids.tpu.encoding.storage.hostCodec", "none",
    "Frame codec of the spill catalog's host tier (and so of demoted "
    "checkpoints and cached results): none keeps numpy buffers; zrle, "
    "lz4 and zstd keep each payload as one frame of the native codec "
    "the disk tier writes. The checksum stays over the decoded bytes, "
    "and a frame that no longer decodes is dropped as corruption.",
    str, lambda v: None if v in ("none", "zrle", "lz4", "zstd")
    else "unknown codec")

WINDOW_BATCH_ROWS = conf(
    "spark.rapids.sql.window.batchRows", 1 << 20,
    "Target rows per window-operator chunk when its input arrives sorted "
    "(the planner puts a sort under every partitioned window).  Chunks "
    "end at partition boundaries; a partition larger than this streams "
    "with running state carried across chunks when every function of "
    "the operator has a running frame, and otherwise grows the chunk.",
    _to_int, _positive)

OOM_RETRY_MAX = conf(
    "spark.rapids.memory.oomRetry.maxRetries", 2,
    "Spill-and-retry attempts per device OOM before splitting or "
    "failing (memory/retry.py).", _to_int,
    lambda v: None if v >= 0 else "must be >= 0")

SPILL_INTEGRITY_ENABLED = conf(
    "spark.rapids.memory.spill.integrityCheck.enabled", True,
    "Verify a crc32 checksum, computed when a batch leaves the device, "
    "on every HOST and DISK tier restore; a mismatch drops the batch and "
    "raises SpillCorruptionError, never returning wrong bytes.  Disk "
    "spill files are always written atomically (temp file, fsync, "
    "rename).", _to_bool)



# ------------------------------------------------------- query envelope --
# the event log (utils/events.py), span tracing (utils/tracing.py), the
# recovery driver (robustness/driver.py), the watchdog
# (robustness/watchdog.py) and the serving layer (serving/)

_non_negative = (lambda v: None if v >= 0 else "must be >= 0")

EVENT_LOG_DIR = conf(
    "spark.rapids.tpu.eventLog.dir", "",
    "Directory for the session's JSON-lines query event log (plans, "
    "per-operator metrics, spill, retry, admission and span facts). "
    "Empty disables logging; tools/eventlog.py parses the files.", str)

EVENT_LOG_FLUSH_MS = conf(
    "spark.rapids.tpu.eventLog.flushMs", 0,
    "Batched event-log flushing: lines are written at once but flushes "
    "are coalesced to at most one per this many milliseconds. 0 flushes "
    "every line. QueryEnd, QueryFatal and SessionEnd always flush.",
    _to_int, _non_negative)

TRACE_ENABLED = conf(
    "spark.rapids.tpu.trace.enabled", False,
    "Arm the span-tracing runtime (utils/tracing.py): thread-aware, "
    "query-attributed host wall-clock spans over operator batch pulls, "
    "host syncs, reader pulls, exchanges, spill tier moves, admission "
    "and pipeline waits. Spans drain at QueryEnd into its 'spans' "
    "rollup and, with trace.dir set, a Chrome trace file per query. "
    "Off by default; answers are the same bits either way. Setting "
    "trace.dir also arms tracing. Process-global: the last-constructed "
    "session's setting wins.", _to_bool)

TRACE_DIR = conf(
    "spark.rapids.tpu.trace.dir", "",
    "Directory for per-query Chrome-trace-event JSON files "
    "(tools/traceview.py), one per query envelope, failed ones "
    "included. Setting this implies trace.enabled.", str)

TRACE_MAX_EVENTS = conf(
    "spark.rapids.tpu.trace.maxEvents", 100_000,
    "Bound on span records per thread buffer and per exported trace; "
    "a trace past it carries an explicit trace-truncated marker.",
    _to_int, _positive)

QUERY_RECOVERY_ENABLED = conf(
    "spark.rapids.sql.recovery.enabled", True,
    "Enable the query-level recovery driver: classified transient "
    "faults (device OOM past the operator retries, reader and shuffle "
    "faults, watchdog timeouts) re-drive the query down a bounded "
    "ladder (retry, spill, smaller batches, one device, CPU) instead of "
    "failing it. CUDA runtime errors, kernel build failures and "
    "unported features are fatal and never re-driven.", _to_bool)

QUERY_RECOVERY_MAX_RETRIES = conf(
    "spark.rapids.sql.recovery.maxRetries", 2,
    "Plain same-plan retries (with backoff) before the recovery ladder "
    "escalates to degradation.", _to_int, _non_negative)

QUERY_RECOVERY_BACKOFF_MS = conf(
    "spark.rapids.sql.recovery.backoffMs", 25,
    "Base backoff between same-plan query retries, doubled per retry, "
    "jittered (seeded per driver) and capped at "
    "spark.rapids.sql.recovery.backoffCapMs.", _to_int, _non_negative)

QUERY_RECOVERY_BACKOFF_CAP_MS = conf(
    "spark.rapids.sql.recovery.backoffCapMs", 2000,
    "Ceiling on the exponential retry backoff (before jitter).",
    _to_int, _positive)

RECOVERY_CHECKPOINT_ENABLED = conf(
    "spark.rapids.sql.recovery.checkpoint.enabled", True,
    "Register the output of every completed exchange stage of the "
    "sharded path (aggregate, join, sort, top-N) as a stage checkpoint "
    "in a per-query lineage log (robustness/checkpoint.py). On a "
    "retryable fault the recovery ladder's re-attempt resumes from the "
    "completed stages instead of re-reading sources. Checkpoints are "
    "verified on restore; a corrupt or evicted one is dropped and its "
    "subtree re-runs.", _to_bool)

RECOVERY_CHECKPOINT_MAX_BYTES = conf(
    "spark.rapids.sql.recovery.checkpoint.maxBytes", 1 << 30,
    "Ceiling on the bytes one query's lineage log may hold across all "
    "spill tiers; the oldest checkpoints evict first (CheckpointEvict "
    "events) and their subtrees re-run on resume.", _to_int, _positive)

RECOVERY_CHECKPOINT_TIERS = conf(
    "spark.rapids.sql.recovery.checkpoint.tiers", "device,host,disk",
    "Spill tiers a checkpoint payload may occupy: 'device,host,disk' "
    "registers it on the device and lets pressure demote it; "
    "'host,disk' moves it to the host at write; 'disk' writes it to a "
    "disk frame at once.", str,
    lambda v: None if v in ("device,host,disk", "host,disk", "disk")
    else "must be 'device,host,disk', 'host,disk' or 'disk'")

WATCHDOG_ENABLED = conf(
    "spark.rapids.tpu.watchdog.enabled", True,
    "Enable the hang watchdog (robustness/watchdog.py): monitored "
    "sections around reader pulls, shuffle exchanges, host syncs of "
    "the sharded path, disk spill writes, UDF worker calls and the "
    "pipeline worker's heartbeat turn deadline overruns into retryable "
    "TimeoutFaults delivered at the next cooperative checkpoint. It "
    "cannot interrupt a device sync: the fault is raised after the "
    "sync returns.", _to_bool)

WATCHDOG_DEFAULT_DEADLINE_MS = conf(
    "spark.rapids.tpu.watchdog.defaultDeadlineMs", 300_000,
    "Deadline of every monitored section without a per-point override "
    "(spark.rapids.tpu.watchdog.deadline.<point>). 0 disables "
    "monitoring for sections without an override.", _to_int,
    _non_negative)

WATCHDOG_QUERY_DEADLINE_MS = conf(
    "spark.rapids.tpu.watchdog.queryDeadlineMs", 0,
    "Wall-time deadline of one query execution attempt; an overrun is "
    "a retryable TimeoutFault. 0 disables the whole-query deadline.",
    _to_int, _non_negative)

WATCHDOG_POLL_MS = conf(
    "spark.rapids.tpu.watchdog.pollMs", 25,
    "Target poll interval of the watchdog monitor thread; the cadence "
    "also adapts to the shortest active deadline.", _to_int, _positive)

SERVING_CONCURRENT_QUERIES = conf(
    "spark.rapids.tpu.serving.concurrentQueries", 4,
    "Maximum queries admitted onto the device at once by the session's "
    "admission controller (serving/admission.py, the query-granularity "
    "GpuSemaphore). Queries past it wait in a fair FIFO queue; 0 "
    "disables admission control.", _to_int, _non_negative)

SERVING_HBM_ADMISSION_FRACTION = conf(
    "spark.rapids.tpu.serving.hbmAdmissionFraction", 0.8,
    "Fraction of the spill catalog's device budget that admitted "
    "queries' declared memory weights may claim together; a query "
    "heavier than the whole budget still admits alone.", _to_float,
    _fraction)

SERVING_ADMISSION_TIMEOUT_MS = conf(
    "spark.rapids.tpu.serving.admissionTimeoutMs", 0,
    "Longest one query may wait in the admission queue before a typed "
    "AdmissionFault rejects it. 0 waits indefinitely.", _to_int,
    _non_negative)

SERVING_MAX_QUEUED_QUERIES = conf(
    "spark.rapids.tpu.serving.maxQueuedQueries", 0,
    "Bound on the admission queue; a query arriving at a full queue is "
    "rejected at once with AdmissionFault('queue-full'). 0 leaves the "
    "queue unbounded.", _to_int, _non_negative)

SERVING_QUERY_MEMORY_BUDGET = conf(
    "spark.rapids.tpu.serving.queryMemoryBudgetBytes", 0,
    "Per-query ceiling on the spill-catalog bytes the query's own "
    "batches hold on the device. Past it the query's own coldest "
    "batches spill to host first (BudgetExhausted, action=spill); a "
    "query still over after that is rejected with a typed "
    "BudgetExhaustedFault. 0 disables it (the admission weight is then "
    "an equal share of the admission bytes).", _to_int, _non_negative)

SERVING_SYNC_BUDGET = conf(
    "spark.rapids.tpu.serving.syncBudget", 0,
    "Per-query ceiling on counted device->host synchronisations "
    "(utils/hostsync.py); past it the query is rejected with a typed "
    "BudgetExhaustedFault at the offending sync. 0 disables.", _to_int,
    _non_negative)

SERVING_DEADLINE_BUDGET_MS = conf(
    "spark.rapids.tpu.serving.deadlineBudgetMs", 0,
    "Wall-time deadline of EACH execution attempt of a query (overrides "
    "spark.rapids.tpu.watchdog.queryDeadlineMs when set); an overrun is "
    "a retryable TimeoutFault for that query only. 0 defers to the "
    "watchdog conf.", _to_int, _non_negative)

SERVING_INTERLEAVE_ENABLED = conf(
    "spark.rapids.tpu.serving.interleave.enabled", False,
    "Fair batch-for-batch interleaving of admitted queries "
    "(serving/scheduler.py): queries take weighted round-robin "
    "timeslices at every batch pull (and sharded exchange stage) "
    "instead of each dispatching as fast as its thread runs. "
    "Cooperative: it reorders when batches dispatch, never what they "
    "compute.", _to_bool)

SERVING_INTERLEAVE_QUANTUM = conf(
    "spark.rapids.tpu.serving.interleave.quantumBatches", 1,
    "Base number of batch slices one query may advance per round-robin "
    "turn of the fair interleaver.", _to_int, _positive)

# -------------------------------------------------------------- planning --
# the planner's tagging (plan/overrides.py), its CPU fallback
# (exec/fallback.py) and the cost-based optimizer (plan/cbo.py)

SERVING_CHECKPOINT_FLOOR_BYTES = conf(
    "spark.rapids.tpu.serving.checkpointEvictionFloorBytes", 0,
    "Cross-query isolation floor for stage checkpoints: device pressure "
    "from one query demotes that query's own batches first, and may not "
    "demote ANOTHER query's checkpoint-priority payloads below this "
    "many device bytes (unless the budget cannot be met any other "
    "way). 0 disables the floor.", _to_int, _non_negative)

SERVING_RESULT_CACHE_ENABLED = conf(
    "spark.rapids.tpu.serving.resultCache.enabled", False,
    "Plan-keyed result cache (serving/reuse.py): before planning, a "
    "query's structural plan signature and the input fingerprint of "
    "what it reads (file path/size/mtime_ns, in-memory batch "
    "identities) are looked up in a session store on the host; a hit "
    "answers without running an operator. A moved fingerprint "
    "invalidates the entry, every hit is CRC-verified, and plans with "
    "UDFs or pandas nodes are never cached.", _to_bool)

SERVING_RESULT_CACHE_MAX_BYTES = conf(
    "spark.rapids.tpu.serving.resultCache.maxBytes", 256 << 20,
    "Ceiling on the bytes the result cache holds on the host and disk "
    "tiers; least recently used entries evict first, and a result "
    "larger than the whole budget is not stored.", _to_int, _positive)

SERVING_SHARED_STAGE_ENABLED = conf(
    "spark.rapids.tpu.serving.sharedStage.enabled", False,
    "Cross-query stage store (serving/reuse.py): sharded queries "
    "register every completed exchange stage in one session store "
    "keyed by the structural stage id with the input fingerprint "
    "folded in, and splice each other's stages on first attempts. A "
    "failed check, an eviction or a moved fingerprint re-runs the "
    "subtree. Payloads move to the host at write.", _to_bool)

SERVING_SHARED_STAGE_MAX_BYTES = conf(
    "spark.rapids.tpu.serving.sharedStage.maxBytes", 1 << 30,
    "Ceiling on the bytes the shared stage store holds on the host and "
    "disk tiers; the oldest entries evict first.", _to_int, _positive)

TEMPLATE_ENABLED = conf(
    "spark.rapids.tpu.template.enabled", False,
    "Parameterized plan templates (plan/template.py): constant "
    "literals are hoisted into typed parameter slots with value-free "
    "keys before planning, and session.prepare(df) plans a template "
    "once for runs under new bindings. Literals whose swap would change "
    "the plan's shape (nulls, strings, decimals, ANSI-checked "
    "operations, unaliased projections, LIMIT, join/sort/window "
    "positions) stay inline.", _to_bool)

TEMPLATE_RESULT_CACHE_ENABLED = conf(
    "spark.rapids.tpu.template.resultCache.enabled", False,
    "Template tier of the result cache: a templated query stores and "
    "looks up its answer under (template fingerprint, parameter "
    "vector), with the exact tier's checks. Needs template.enabled and "
    "serving.resultCache.enabled.", _to_bool)

EXPLAIN = conf(
    "spark.rapids.sql.explain", "NONE",
    "Explain why parts of a query did or did not run on the device: NONE, "
    "NOT_ON_TPU (print the nodes and expressions that fall back to the "
    "CPU, with their reasons) or ALL (print every node) at each "
    "planning.", str,
    lambda v: None if v in ("NONE", "NOT_ON_TPU", "ALL") else
    "must be NONE, NOT_ON_TPU or ALL")

INCOMPAT_ENABLED = conf(
    "spark.rapids.sql.incompatibleOps.enabled", True,
    "Run operators whose semantics differ from CPU Spark in documented "
    "corner cases (ASCII-only case mapping, byte-semantics regex). The "
    "reference defaults this OFF (RapidsMeta.scala:271); this engine "
    "defaults ON because each incompat is individually documented and "
    "per-op keys (spark.rapids.sql.expression.<Name>) can disable any "
    "single one.", _to_bool)

REGEXP_ENABLED = conf(
    "spark.rapids.sql.regexp.enabled", True,
    "Evaluate regular-expression expressions (rlike, regexp_replace, "
    "split_part) on device; when false every regex expression tags off "
    "to the CPU fallback (reference `sql.regexp.enabled`, "
    "RapidsConf.scala).", _to_bool)

VARIABLE_FLOAT_AGG = conf(
    "spark.rapids.sql.variableFloatAgg.enabled", True,
    "Allow sum and avg over floating-point values on the device even "
    "though chunked evaluation adds in another order than CPU Spark; when "
    "false such an aggregate falls back to the CPU.", _to_bool)

CAST_STRING_TO_FLOAT = conf(
    "spark.rapids.sql.castStringToFloat.enabled", True,
    "Allow string->float casts on the device.", _to_bool)

CAST_FLOAT_TO_STRING = conf(
    "spark.rapids.sql.castFloatToString.enabled", True,
    "Allow float->string casts on the device.", _to_bool)

CAST_FLOAT_TO_DECIMAL = conf(
    "spark.rapids.sql.castFloatToDecimal.enabled", True,
    "Allow float->decimal casts on the device (reference "
    "`sql.castFloatToDecimal.enabled`).", _to_bool)

DECIMAL_ENABLED = conf(
    "spark.rapids.sql.decimalType.enabled", True,
    "Enable decimal (DECIMAL_64) processing: device arithmetic with "
    "Spark result-type rules and overflow->null, sum up to "
    "decimal(8,s) children; wider results and avg fall back to CPU "
    "(reference RapidsConf.scala:564).", _to_bool)

CAST_STRING_TO_TIMESTAMP = conf(
    "spark.rapids.sql.castStringToTimestamp.enabled", True,
    "Allow string->timestamp and string->date casts on the device.",
    _to_bool)

SUPPRESS_PLANNING_FAILURE = conf(
    "spark.rapids.sql.suppressPlanningFailure", False,
    "When planning itself raises, run the whole query on the CPU "
    "fallback instead of failing (the error is kept on "
    "session.last_planning_error).", _to_bool)

OPTIMIZER_TRANSITION_COST = conf(
    "spark.rapids.sql.optimizer.transitionRowCost", 0.1,
    "Microseconds per row charged for a host<->device transition by the "
    "cost-based optimizer.", _to_float)

CBO_ENABLED = conf(
    "spark.rapids.sql.optimizer.enabled", False,
    "Enable the cost-based optimizer: device regions whose estimated "
    "work cannot pay for their host<->device transitions run on the CPU "
    "fallback instead.", _to_bool)

TEST_ENABLED = conf(
    "spark.rapids.sql.test.enabled", False,
    "Strict test mode: planning raises when a node would fall back to "
    "the CPU.", _to_bool)

TEST_ALLOWED_NON_TPU = conf(
    "spark.rapids.sql.test.allowedNonTpu", "",
    "Comma-separated plan node names that strict test mode lets fall back "
    "to the CPU.", str)


# dynamic per-op enable keys: spark.rapids.sql.expression.<Name> and
# spark.rapids.sql.exec.<Name>
_DYNAMIC_PREFIXES = ("spark.rapids.sql.expression.",
                     "spark.rapids.sql.exec.")
# per-op cost-model weights (any logical-plan node name)
_COST_PREFIXES = ("spark.rapids.sql.optimizer.tpuOpCost.",
                  "spark.rapids.sql.optimizer.cpuOpCost.")


# per-point watchdog deadlines (any monitored section name, e.g.
# io.reader, pipeline.worker, spill.disk); values in ms, 0 disables
_WATCHDOG_DEADLINE_PREFIX = "spark.rapids.tpu.watchdog.deadline."


def _known_key(key: str) -> bool:
    if key in _REGISTRY:
        return True
    if key.startswith(_COST_PREFIXES) or \
            key.startswith(_WATCHDOG_DEADLINE_PREFIX):
        return True
    for p in _DYNAMIC_PREFIXES:
        if key.startswith(p):
            # imported here: the planner imports this module
            from spark_rapids_tpu_torch.plan.overrides import valid_op_names
            return key[len(p):] in valid_op_names()
    return False


class RapidsConf:
    """Immutable view over a settings dict."""

    def __init__(self, settings: Optional[Dict[str, Any]] = None):
        self.settings = dict(settings or {})
        for k in self.settings:
            if k.startswith("spark.rapids.") and not _known_key(k):
                raise ValueError(
                    f"unknown configuration key {k!r}: the PyTorch port "
                    f"reads only {sorted(_REGISTRY)}, "
                    "spark.rapids.sql.{exec,expression}.<Name>, "
                    "spark.rapids.sql.optimizer.{tpu,cpu}OpCost.<Op> and "
                    "spark.rapids.tpu.watchdog.deadline.<point>")
        for entry in _REGISTRY.values():
            entry.get(self.settings)  # validate eagerly

    def get(self, entry: ConfEntry) -> Any:
        return entry.get(self.settings)

    def set(self, key: str, value) -> "RapidsConf":
        """A new conf with ``key`` set (this one stays as it is)."""
        s = dict(self.settings)
        s[key] = value
        return RapidsConf(s)

    def watchdog_deadline_ms(self, point: str) -> int:
        """``spark.rapids.tpu.watchdog.deadline.<point>``, else the
        defaultDeadlineMs entry; 0 disables the point."""
        raw = self.settings.get(_WATCHDOG_DEADLINE_PREFIX + point)
        if raw is None:
            return self.get(WATCHDOG_DEFAULT_DEADLINE_MS)
        return int(raw)

    @property
    def explain(self) -> str:
        return self.get(EXPLAIN)

    def op_enabled(self, kind: str, name: str) -> bool:
        """Per-op enable key ``spark.rapids.sql.<kind>.<Name>`` (kind is
        ``exec`` or ``expression``), default True."""
        raw = self.settings.get(f"spark.rapids.sql.{kind}.{name}")
        if raw is None:
            return True
        return raw if isinstance(raw, bool) else _to_bool(str(raw))

    def op_cost(self, side: str, name: str) -> Optional[float]:
        """Per-op cost weight in us/row,
        ``spark.rapids.sql.optimizer.<side>OpCost.<Op>`` (side ``tpu`` or
        ``cpu``); None = the optimizer's own table."""
        raw = self.settings.get(
            f"spark.rapids.sql.optimizer.{side}OpCost.{name}")
        return None if raw is None else float(raw)
