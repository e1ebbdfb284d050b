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
    def __init__(self, conf: Optional[Union[RapidsConf, Dict]] = None,
                 device=None, process_group=None):
        self.conf = conf if isinstance(conf, RapidsConf) else \
            RapidsConf(conf)
        self.device = resolve_device(device)
        self._init_memory()
        self.overrides = TpuOverrides(self.conf, self.device,
                                      self.memory_catalog)
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
            max_retries=conf.get(rc.OOM_RETRY_MAX))
        self.semaphore = TpuSemaphore(conf.get(rc.CONCURRENT_TPU_TASKS))

    def create_dataframe(self, data) -> DataFrame:
        """A DataFrame over a dict of numpy arrays (or lists with None
        for nulls), a pandas DataFrame, or a ColumnarBatch already on the
        session's device.  The data is copied to the device once, here."""
        import pandas as pd
        if isinstance(data, pd.DataFrame):
            batch = ColumnarBatch.from_pandas(data, device=self.device)
        elif isinstance(data, dict):
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

    def plan(self, logical: L.LogicalPlan):
        """The physical plan of ``logical`` (``overrides.last_explain``
        then says what runs where).  With
        ``spark.rapids.sql.suppressPlanningFailure`` a planning error
        demotes the whole query to the CPU fallback, keeping the error on
        ``last_planning_error``."""
        if self.stopped:
            raise RuntimeError("session is stopped")
        if not self.conf.get(rc.SUPPRESS_PLANNING_FAILURE):
            return self.overrides.apply(logical)
        try:
            return self.overrides.apply(logical)
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
        """Stop the session and sweep its spill tiers: live handles
        close, orphaned spill files go, and the catalog's own directory
        is removed."""
        self.stopped = True
        self.memory_catalog.close()
