"""``df.cache()``: compressed host-resident columnar caching.

Counterpart of ``spark_rapids_tpu/exec/cache.py``.  The reference caches a
DataFrame as in-memory Parquet-encoded batches
(ParquetCachedBatchSerializer): compact host bytes, decoded on the device
when read again.  The port stores each batch as one frame of its own
native codec (``spark_rapids_tpu_torch/native``, the spill tier's frame
format, at ``spark.rapids.shuffle.compression.codec``'s level): the first
run of a plan holding a cached node streams its batches through
``TpuMaterializeCacheExec``, which frames each (one counted fetch of its
buffers), and later runs read ``TpuCachedScanExec``, which restores and
uploads them.

A cache is keyed by the identity of its logical plan node: any query whose
tree holds that node reads the cache (the planner substitutes it when it
converts the node), and the planner's pushdown stops at it, so a query's
filters and column pruning never shrink what is cached.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import Column, to_device
from spark_rapids_tpu_torch.exec.base import Schema, TpuExec


def batch_to_frame(batch: ColumnarBatch, level: int = 2):
    """``(frame bytes, raw bytes, host dictionaries)`` of one batch: its
    rows' buffers fetched in one counted sync and serialized."""
    from spark_rapids_tpu_torch import native
    from spark_rapids_tpu_torch.utils import hostsync
    n = batch.nrows
    bufs, slots = [], []
    for c in batch.columns.values():
        parts = [c.data if c.offsets is not None else c.data[:n],
                 None if c.validity is None else c.validity[:n],
                 None if c.offsets is None else c.offsets[:n + 1]]
        slots.append(parts)
        bufs.extend(p for p in parts if p is not None)
    host = iter(hostsync.fetch_all(bufs))
    cols, raw, dictionaries = [], 0, []
    for (name, dt), c, row in zip(batch.schema, batch.columns.values(),
                                  slots):
        got = [None if b is None else next(host) for b in row]
        raw += sum(g.nbytes for g in got if g is not None)
        cols.append((native.dtype_code(dt), got[0], got[1], got[2]))
        dictionaries.append(c.dictionary)
    return native.serialize_batch(n, cols, level), raw, dictionaries


def frame_to_batch(blob: bytes, schema: Schema, device,
                   dictionaries=None) -> ColumnarBatch:
    """The batch a frame holds, uploaded to ``device``."""
    from spark_rapids_tpu_torch import native
    nrows, cols = native.deserialize_batch(blob)
    dictionaries = dictionaries or [None] * len(schema)
    out = {}
    for (name, dt), (_, d, v, o), dic in zip(schema, cols, dictionaries):
        storage = np.uint8 if dt.is_string else dt.storage
        # an empty buffer (no rows, or every string empty) is absent
        d = np.zeros(0, dtype=storage) if d is None else d.view(storage)
        offsets = None
        if dt.has_offsets:
            offsets = to_device(np.zeros(1, np.int32) if o is None
                                else o.view(np.int32), device, copy=True)
        out[name] = Column(
            dt, to_device(d, device, copy=True), nrows,
            validity=None if v is None else to_device(
                v.view(np.bool_), device, copy=True),
            offsets=offsets, dictionary=dic)
    return ColumnarBatch(out, nrows)


class CacheEntry:
    """One cached plan: its frames once materialized, their compressed
    and raw bytes, and the host ns spent framing and restoring them."""

    def __init__(self, plan):
        self.plan = plan
        self.schema: Schema = list(plan.schema)
        self.frames: Optional[List[tuple]] = None
        self.raw_bytes = 0
        self.frame_ns = 0
        self.restore_ns = 0

    @property
    def materialized(self) -> bool:
        return self.frames is not None

    @property
    def cached_bytes(self) -> int:
        return sum(len(f) for f, _ in self.frames) if self.frames else 0


class CacheManager:
    """The session's registry of cached logical plans (Spark's
    CacheManager)."""

    def __init__(self):
        self._entries: Dict[int, CacheEntry] = {}

    def register(self, plan) -> CacheEntry:
        e = self._entries.get(id(plan))
        if e is None:
            e = CacheEntry(plan)
            self._entries[id(plan)] = e
        return e

    def unregister(self, plan) -> None:
        self._entries.pop(id(plan), None)

    def lookup(self, plan) -> Optional[CacheEntry]:
        e = self._entries.get(id(plan))
        # an id is reused once its plan is collected: the entry holds its
        # plan, so a live entry's plan is the one asked about
        return e if e is not None and e.plan is plan else None

    def clear(self) -> None:
        self._entries.clear()


class TpuMaterializeCacheExec(TpuExec):
    """The first run of a cached plan: its batches pass through, each
    framed to the host; the cache is published only when the run ends (a
    LIMIT that stops early publishes nothing)."""

    def __init__(self, entry: CacheEntry, child: TpuExec,
                 codec_level: int = 2):
        super().__init__(child)
        self.entry = entry
        self.codec_level = codec_level

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def describe(self):
        return "TpuMaterializeCacheExec"

    def do_execute(self) -> Iterator[ColumnarBatch]:
        frames, raw, ns = [], 0, 0
        for batch in self.children[0].execute():
            t0 = time.perf_counter_ns()
            blob, nbytes, dicts = batch_to_frame(batch, self.codec_level)
            ns += time.perf_counter_ns() - t0
            frames.append((blob, dicts))
            raw += nbytes
            yield batch
        self.entry.raw_bytes = raw
        self.entry.frame_ns = ns
        self.entry.frames = frames


class TpuCachedScanExec(TpuExec):
    """Later runs: the frames restored and uploaded (Spark's
    InMemoryTableScanExec)."""

    def __init__(self, entry: CacheEntry, device):
        super().__init__()
        self.entry = entry
        self.device = torch.device(device)

    @property
    def schema(self) -> Schema:
        return self.entry.schema

    def describe(self):
        return (f"TpuCachedScanExec[{len(self.entry.frames or [])} batches, "
                f"{self.entry.cached_bytes} bytes]")

    def do_execute(self) -> Iterator[ColumnarBatch]:
        for blob, dicts in self.entry.frames or []:
            t0 = time.perf_counter_ns()
            batch = frame_to_batch(blob, self.entry.schema, self.device,
                                   dicts)
            self.entry.restore_ns += time.perf_counter_ns() - t0
            yield batch
