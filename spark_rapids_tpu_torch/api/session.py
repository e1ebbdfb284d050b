"""TpuSession: the entry point of the PyTorch engine.

Counterpart of ``spark_rapids_tpu/api/session.py``.  A session owns its
configuration and one device; ``session.read`` makes DataFrames over
parquet, ORC and CSV files.  ``TpuSession(conf)`` runs on ``cuda:0``
and raises when no CUDA device is present: it never carries on quietly on
the CPU.  Pass ``device="cpu"`` to run on the CPU on purpose (the tests
do); the hand-written kernels' plain versions then run instead.

``session.plan`` tags each plan node and expression
(``plan/overrides.py``); what does not run on the device runs in a
``CpuFallbackExec`` between device operators, and
``session.overrides.last_explain`` says which and why
(``DataFrame.explain()`` prints it under the physical plan).  With
``spark.rapids.sql.test.enabled`` any such fallback raises instead.
``session.cache_manager`` holds the plans ``df.cache()`` marked
(``exec/cache.py``); the planner reads a cached plan from its frames.

A session may hold a shard group, and then offers every collected plan to
the distributed planner first (``parallel/dist_planner.py``):
``spark.rapids.sql.distributed.numShards = n > 0`` makes ``n`` logical
shards on the session's device (``LocalShards``); ``process_group=g``
makes one shard per rank of an initialised ``torch.distributed`` group
(``ProcessGroupShards``), where every rank builds the same DataFrame,
scans its own block of rows and collects the whole result.

Memory (``_init_memory``): each session owns a spill catalog
(``session.memory_catalog``, ``memory/spill.py``), which the planner
binds to every operator it builds for the session, and an admission
semaphore (``session.semaphore``).  The device budget is
``spark.rapids.memory.tpu.deviceLimitBytes`` when set, else sized from
the card (``torch.cuda.mem_get_info``) as the JAX package sizes it from
its device: less the reserve, times ``allocFraction``, at most
``maxAllocFraction`` of what is left, and session start fails below
``minAllocFraction`` of the card.  On ``device="cpu"`` no CUDA call runs:
the same sizing applies to a device of ``CPU_DEVICE_BYTES`` (16 GiB, the
JAX package's fallback).  ``stop()`` closes the catalog (its live handles
and spill files).

The query envelope (``_init_observability`` and ``_init_serving``):
every ``collect`` runs in a ``serving/context.QueryContext``, through the
session's ``admission`` controller (``serving.concurrentQueries``, 4 by
default; None when 0) and, when ``serving.interleave.enabled``, its
``interleaver``, under a ``robustness/driver.QueryRetryDriver`` whose
actions land on ``recovery_log``, in a watchdog query scope, with
QueryStart/QueryEnd records on ``events`` when
``spark.rapids.tpu.eventLog.dir`` is set (``DataFrame._execute_batches``).
``_current_qid`` is a per-thread view, so concurrent queries on one
session, each on its own thread, keep their own query ids.
``TpuSession._active`` is the session of the query running last (set
per attempt), which subsystems without a session at hand (the watchdog's
events, the UDF pool's degradation record) resolve.

Reuse (``serving/reuse.py``, ``robustness/checkpoint.py``,
``plan/template.py``): a sharded query keeps a lineage log of its stage
checkpoints on ``session.checkpoints`` (on by default), from which a
recovery re-attempt resumes; ``result_cache``
(``serving.resultCache.enabled``) answers a repeated plan over unchanged
inputs from the host, ``shared_stages`` (``serving.sharedStage.enabled``)
lets sharded queries splice each other's stages, and ``prepare(df)``
(``template.enabled``) plans a query once for runs under new literals.
``stop()`` closes both stores.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from spark_rapids_tpu_torch.api.dataframe import DataFrame
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.config import rapids_conf as rc
from spark_rapids_tpu_torch.config.rapids_conf import RapidsConf
from spark_rapids_tpu_torch.parallel.mesh import (
    LocalShards, ProcessGroupShards)
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.overrides import TpuOverrides


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda:0``; a CUDA device must exist."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the PyTorch engine runs on the "
            "GPU unless the caller asks for the CPU with device='cpu'")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class DataFrameReader:
    """``session.read.parquet(path, ...)``: a DataFrame over files.  A
    path may be a file or a directory (a hive-partitioned table root, or a
    bucketed table's directory with its ``_bucket_spec.json``)."""

    def __init__(self, session: "TpuSession"):
        self.session = session

    def option(self, key: str, value) -> "DataFrameReader":
        """Reader options (a CSV's ``header``, ``sep``, ``nullValue`` ...)
        are not honoured by the port's readers yet, so setting one raises
        rather than reading the files some other way."""
        raise NotImplementedError(
            f"reader option {key!r} is not supported by the PyTorch "
            f"port's readers")

    def _make(self, paths, file_format) -> DataFrame:
        from spark_rapids_tpu_torch.io.bucketing import read_spec
        from spark_rapids_tpu_torch.io.readers import infer_file_schema
        if isinstance(paths, str):
            paths = [paths]
        paths = [str(p) for p in paths]
        if not paths:
            raise ValueError("read needs at least one path")
        schema = infer_file_schema(paths, file_format)
        bucket_spec = read_spec(paths[0]) if len(paths) == 1 else None
        rel = L.FileRelation(paths, file_format, schema,
                             bucket_spec=bucket_spec)
        return DataFrame(self.session, rel)

    def parquet(self, *paths: str) -> DataFrame:
        return self._make(list(paths), "parquet")

    def orc(self, *paths: str) -> DataFrame:
        return self._make(list(paths), "orc")

    def csv(self, *paths: str) -> DataFrame:
        return self._make(list(paths), "csv")


CPU_DEVICE_BYTES = 16 << 30


class TpuSession:
    _active: Optional["TpuSession"] = None

    def __init__(self, conf: Optional[Union[RapidsConf, Dict]] = None,
                 device=None, process_group=None):
        self.conf = conf if isinstance(conf, RapidsConf) else \
            RapidsConf(conf)
        self.device = resolve_device(device)
        self._init_memory()
        self._init_serving()
        self._init_observability()
        from spark_rapids_tpu_torch.exec.cache import CacheManager
        # the plans df.cache() marked, and their frames once materialized
        self.cache_manager = CacheManager()
        self.overrides = TpuOverrides(self.conf, self.device,
                                      self.memory_catalog,
                                      semaphore=self.semaphore,
                                      cache_manager=self.cache_manager)
        self.stopped = False
        # distributed execution: the shard group, the planner's verdict
        # on the last query and its operators' stage statistics
        self.shards = None
        if process_group is not None:
            self.shards = ProcessGroupShards(process_group, self.device)
        elif self.conf.get(rc.DISTRIBUTED_NUM_SHARDS):
            self.shards = LocalShards(
                self.conf.get(rc.DISTRIBUTED_NUM_SHARDS), self.device)
        self.last_dist_explain = ""
        self.last_dist_stats = None
        # the sharded file scan's counters of the last distributed query
        # (None when no file scan was sharded)
        self.last_scan_stats = None
        # the last single-device collect's pipeline counters (None when
        # it ran without the pipeline)
        self.last_pipeline_stats = None
        # the last single-device collect's spill bytes (to host, to
        # disk) and OOM retries and splits (memory/retry.retry_metrics)
        self.last_memory_stats = None
        # the error a suppressed planning failure left (see ``plan``)
        self.last_planning_error = None
        self._views: Dict[str, DataFrame] = {}
        TpuSession._active = self

    def _init_serving(self) -> None:
        """The admission controller (serving/admission.py: at most
        ``concurrentQueries`` in flight, their memory weights within
        ``hbmAdmissionFraction`` of the spill catalog's device budget;
        None when 0) and the fair interleaver (serving/scheduler.py;
        None unless ``interleave.enabled``)."""
        conf = self.conf
        self.admission = None
        n = conf.get(rc.SERVING_CONCURRENT_QUERIES)
        if n > 0:
            from spark_rapids_tpu_torch.serving.admission import (
                AdmissionController)
            self.admission = AdmissionController(
                max_queries=n,
                hbm_bytes=int(self.memory_catalog.device_budget *
                              conf.get(rc.SERVING_HBM_ADMISSION_FRACTION)),
                default_weight=conf.get(rc.SERVING_QUERY_MEMORY_BUDGET),
                timeout_ms=conf.get(rc.SERVING_ADMISSION_TIMEOUT_MS),
                max_queue=conf.get(rc.SERVING_MAX_QUEUED_QUERIES))
        self.interleaver = None
        if conf.get(rc.SERVING_INTERLEAVE_ENABLED):
            from spark_rapids_tpu_torch.serving.scheduler import (
                FairInterleaver)
            self.interleaver = FairInterleaver(
                conf.get(rc.SERVING_INTERLEAVE_QUANTUM))
        # cross-query reuse (serving/reuse.py), off by default
        self.result_cache = None
        if conf.get(rc.SERVING_RESULT_CACHE_ENABLED):
            from spark_rapids_tpu_torch.serving.reuse import ResultCache
            self.result_cache = ResultCache(self)
        self.shared_stages = None
        if conf.get(rc.SERVING_SHARED_STAGE_ENABLED):
            from spark_rapids_tpu_torch.serving.reuse import (
                SharedStageCache)
            self.shared_stages = SharedStageCache(self)

    def _init_observability(self) -> None:
        """Query ids, the recovery trail, the event log and the span
        runtime (reference ``api/session.py:336-381``, without the cost
        model)."""
        import itertools
        import uuid
        from spark_rapids_tpu_torch.utils import tracing
        from spark_rapids_tpu_torch.utils.events import EventLogger
        self._query_ids = itertools.count(1)
        self.session_id = uuid.uuid4().hex[:12]
        # recovery actions (robustness/driver.py) in arrival order: the
        # in-memory mirror of the RecoveryAction events
        self.recovery_log = []
        # thread-keyed stores behind the _current_qid / checkpoints
        # views: one session serves concurrent queries, each on its own
        # driving thread
        self._qid_by_ident = {}
        self._checkpoints_by_ident = {}
        self.events = EventLogger(
            self.conf.get(rc.EVENT_LOG_DIR) or None, self.session_id,
            conf_snapshot=dict(self.conf.settings),
            flush_ms=self.conf.get(rc.EVENT_LOG_FLUSH_MS))
        # span tracing: process-global, this session's conf wins
        trace_dir = self.conf.get(rc.TRACE_DIR) or None
        self.last_span_stats = None  # the last QueryEnd spans rollup
        tracing.configure(
            enabled=bool(self.conf.get(rc.TRACE_ENABLED) or trace_dir),
            trace_dir=trace_dir,
            max_events=self.conf.get(rc.TRACE_MAX_EVENTS))

    # per-query state views: call sites read and write
    # ``session._current_qid`` / ``session.checkpoints`` and get the
    # CALLING query's value, resolved by effective thread ident (an
    # adopted pipeline worker resolves to its driving query)
    @property
    def _current_qid(self):
        from spark_rapids_tpu_torch.serving import context as qc
        return self._qid_by_ident.get(qc.effective_ident())

    @_current_qid.setter
    def _current_qid(self, qid) -> None:
        from spark_rapids_tpu_torch.serving import context as qc
        ident = qc.effective_ident()
        if qid is None:
            self._qid_by_ident.pop(ident, None)
        else:
            self._qid_by_ident[ident] = qid
        ctx = qc.current()
        if ctx is not None:
            ctx.set_qid(qid)

    @property
    def checkpoints(self):
        """The calling query's stage-checkpoint manager
        (``robustness/checkpoint.py``): its lineage log on a sharded
        session, or the shared stage store; None outside a query and on
        one device."""
        from spark_rapids_tpu_torch.serving import context as qc
        return self._checkpoints_by_ident.get(qc.effective_ident())

    @checkpoints.setter
    def checkpoints(self, mgr) -> None:
        from spark_rapids_tpu_torch.serving import context as qc
        ident = qc.effective_ident()
        if mgr is None:
            self._checkpoints_by_ident.pop(ident, None)
        else:
            self._checkpoints_by_ident[ident] = mgr
        ctx = qc.current()
        if ctx is not None:
            ctx.checkpoints = mgr

    # --------------------------------------------------------- builders --
    @classmethod
    def builder(cls) -> "SessionBuilder":
        return SessionBuilder()

    @classmethod
    def active(cls) -> "TpuSession":
        """The active session, made (on ``cuda:0``) if there is none."""
        if cls._active is None:
            cls._active = TpuSession()
        return cls._active

    def set_conf(self, key: str, value) -> None:
        """Set one conf key on this session: the planner is rebuilt with
        it, and a changed ``eventLog.dir`` reopens the event log."""
        old_log_dir = self.conf.get(rc.EVENT_LOG_DIR)
        self.conf = self.conf.set(key, value)
        self.overrides = TpuOverrides(self.conf, self.device,
                                      self.memory_catalog,
                                      semaphore=self.semaphore,
                                      cache_manager=self.cache_manager)
        if self.conf.get(rc.EVENT_LOG_DIR) != old_log_dir:
            self.events.close()
            self._init_observability()

    def _init_memory(self) -> None:
        """The spill catalog and the admission semaphore
        (GpuDeviceManager.initializeGpuAndMemory's sizing contract,
        GpuDeviceManager.scala:170-245)."""
        from spark_rapids_tpu_torch import native
        from spark_rapids_tpu_torch.memory.spill import (
            SpillableBatchCatalog, TpuSemaphore)
        conf = self.conf
        budget = conf.get(rc.DEVICE_MEMORY_LIMIT)
        if not budget:
            if self.device.type == "cuda":
                _, total = torch.cuda.mem_get_info(self.device)
            else:
                total = CPU_DEVICE_BYTES
            usable = max(total - conf.get(rc.MEM_RESERVE), 0)
            budget = min(int(usable * conf.get(rc.MEM_POOL_FRACTION)),
                         int(usable * conf.get(rc.MEM_MAX_ALLOC_FRACTION)))
            least = int(total * conf.get(rc.MEM_MIN_ALLOC_FRACTION))
            if budget < least:
                raise ValueError(
                    f"device spill budget {budget} bytes is below "
                    f"minAllocFraction of the device ({least}); lower "
                    "spark.rapids.memory.tpu.reserve, raise allocFraction, "
                    "or lower minAllocFraction")
        self.memory_catalog = SpillableBatchCatalog(
            device_budget=budget,
            host_budget=conf.get(rc.HOST_SPILL_STORAGE_SIZE),
            frame_codec=native.codec_level(
                conf.get(rc.SHUFFLE_COMPRESSION_CODEC)),
            disk_write_threads=conf.get(rc.SPILL_DISK_WRITE_THREADS),
            integrity_check=conf.get(rc.SPILL_INTEGRITY_ENABLED),
            max_retries=conf.get(rc.OOM_RETRY_MAX),
            checkpoint_floor=conf.get(rc.SERVING_CHECKPOINT_FLOOR_BYTES),
            host_codec=native.codec_level(
                conf.get(rc.ENCODING_STORAGE_HOST_CODEC)))
        self.semaphore = TpuSemaphore(conf.get(rc.CONCURRENT_TPU_TASKS))

    def create_dataframe(self, data) -> DataFrame:
        """A DataFrame over a dict of numpy arrays (or lists with None
        for nulls), a pandas DataFrame, a pyarrow Table, or a
        ColumnarBatch already on the session's device.  The data is
        copied to the device once, here; struct and map columns shred
        into flat columns (a dot in a column name is reserved for
        them)."""
        import pandas as pd
        import pyarrow as pa
        from spark_rapids_tpu_torch.columnar.nested import (
            check_reserved_names)
        if isinstance(data, pd.DataFrame):
            check_reserved_names(data.columns)
            batch = ColumnarBatch.from_pandas(data, device=self.device)
        elif isinstance(data, pa.Table):
            check_reserved_names(data.column_names)
            batch = ColumnarBatch.from_arrow(data, device=self.device)
        elif isinstance(data, dict):
            check_reserved_names(data.keys())
            batch = ColumnarBatch.from_pydict(data, device=self.device)
        elif isinstance(data, ColumnarBatch):
            if data.device != self.device:
                raise ValueError(f"batch is on {data.device}, session on "
                                 f"{self.device}")
            batch = data
        else:
            raise TypeError(f"cannot create a DataFrame from {type(data)}")
        return DataFrame(self, L.InMemoryRelation([batch], batch.schema))

    @property
    def read(self) -> DataFrameReader:
        return DataFrameReader(self)

    def range(self, start: int, end: Optional[int] = None,
              step: int = 1) -> DataFrame:
        """A bigint column ``id`` over [start, end) by ``step``
        (``range(n)`` is [0, n))."""
        if end is None:
            start, end = 0, start
        return DataFrame(self, L.Range(start, end, step))

    # ------------------------------------------------------------- SQL --
    def register_view(self, name: str, df: DataFrame) -> None:
        """The temp-view registry that ``sql`` FROM clauses read
        (``df.createOrReplaceTempView`` forwards here)."""
        self._views[name.lower()] = df

    def table(self, name: str) -> DataFrame:
        key = name.lower()
        if key not in self._views:
            raise KeyError(
                f"unknown table or view {name!r}; register with "
                "df.createOrReplaceTempView(name)")
        return self._views[key]

    def sql(self, query: str) -> DataFrame:
        """A SQL SELECT over the registered temp views, lowered onto the
        DataFrame algebra (``sql/``).  An uncorrelated scalar subquery
        runs here, once, as one counted sync; a construct the port does
        not run raises ``NotImplementedError`` naming it."""
        from spark_rapids_tpu_torch.sql import parse, resolve
        return resolve(self, parse(query))

    def prepare(self, df: DataFrame):
        """``df`` as a prepared statement (``api/prepared.py``): its
        literals hoist into parameter slots and the template is planned
        once; each ``handle.run(p0=..., ...)`` binds and executes without
        a planning pass, through admission, the recovery ladder and
        tracing as any query.  Requires
        ``spark.rapids.tpu.template.enabled``."""
        from spark_rapids_tpu_torch.api.prepared import PreparedStatement
        return PreparedStatement(self, df)

    def plan(self, logical: L.LogicalPlan, overrides=None):
        """The physical plan of ``logical`` (``overrides.last_explain``
        then says what runs where).  With
        ``spark.rapids.sql.suppressPlanningFailure`` a planning error
        demotes the whole query to the CPU fallback, keeping the error on
        ``last_planning_error``.  ``overrides``: a one-off planner (the
        recovery driver's split rung plans with smaller batch sizes this
        way, leaving the session's conf alone)."""
        if self.stopped:
            raise RuntimeError("session is stopped")
        ov = overrides if overrides is not None else self.overrides
        if not self.conf.get(rc.SUPPRESS_PLANNING_FAILURE):
            return ov.apply(logical)
        try:
            return ov.apply(logical)
        except Exception as exc:
            import warnings
            # the root cause first: the CPU plan may itself lack a branch
            # for some node, and that later error must not hide this one
            warnings.warn(
                f"planning failed ({type(exc).__name__}: {exc}); running "
                "the whole query on the CPU fallback "
                "(spark.rapids.sql.suppressPlanningFailure)",
                RuntimeWarning, stacklevel=2)
            self.last_planning_error = exc
            return self.plan_cpu_only(logical)

    def plan_cpu_only(self, logical: L.LogicalPlan):
        """The whole query on the CPU fallback, every node a
        ``CpuFallbackExec`` whose output lands on the session's device."""
        from spark_rapids_tpu_torch.exec.fallback import CpuFallbackExec

        def whole_cpu(n):
            return CpuFallbackExec(n, [whole_cpu(c) for c in n.children],
                                   self.device)
        return whole_cpu(logical)

    def stop(self) -> None:
        """Stop the session: the event log closes (SessionEnd), and the
        spill tiers are swept (live handles close, orphaned spill files
        go, and the catalog's own directory is removed)."""
        self.stopped = True
        self.events.close()
        for store in (self.result_cache, self.shared_stages):
            if store is not None:
                try:
                    store.close()
                except Exception:
                    pass  # teardown must reach the catalog sweep
        self.cache_manager.clear()
        self.memory_catalog.close()
        if TpuSession._active is self:
            TpuSession._active = None


class SessionBuilder:
    """``TpuSession.builder().config(k, v).getOrCreate()``."""

    def __init__(self):
        self._conf: Dict[str, object] = {}
        self._device = None

    def config(self, key: str, value) -> "SessionBuilder":
        self._conf[key] = value
        return self

    def device(self, device) -> "SessionBuilder":
        """The session's device (default ``cuda:0``; ``"cpu"`` on
        purpose)."""
        self._device = device
        return self

    def getOrCreate(self) -> TpuSession:
        return TpuSession(RapidsConf(self._conf), device=self._device)
