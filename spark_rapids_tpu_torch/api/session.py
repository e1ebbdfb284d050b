"""TpuSession: the entry point of the PyTorch engine.

Counterpart of ``spark_rapids_tpu/api/session.py``.  A session owns its
configuration and one device.  ``TpuSession(conf)`` runs on ``cuda:0``
and raises when no CUDA device is present: it never carries on quietly on
the CPU.  Pass ``device="cpu"`` to run on the CPU on purpose (the tests
do); the hand-written kernels' plain versions then run instead.

A session may hold a shard group, and then offers every collected plan to
the distributed planner first (``parallel/dist_planner.py``):
``spark.rapids.sql.distributed.numShards = n > 0`` makes ``n`` logical
shards on the session's device (``LocalShards``); ``process_group=g``
makes one shard per rank of an initialised ``torch.distributed`` group
(``ProcessGroupShards``), where every rank builds the same DataFrame,
scans its own block of rows and collects the whole result.
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


class TpuSession:
    def __init__(self, conf: Optional[Union[RapidsConf, Dict]] = None,
                 device=None, process_group=None):
        self.conf = conf if isinstance(conf, RapidsConf) else \
            RapidsConf(conf)
        self.device = resolve_device(device)
        self.overrides = TpuOverrides(self.conf, self.device)
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
        self._views: Dict[str, DataFrame] = {}

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
        if self.stopped:
            raise RuntimeError("session is stopped")
        return self.overrides.apply(logical)

    def stop(self) -> None:
        self.stopped = True
