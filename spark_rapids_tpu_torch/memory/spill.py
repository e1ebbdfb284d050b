"""The spill catalog: device -> host -> disk.

Counterpart of ``spark_rapids_tpu/memory/spill.py`` (the reference's
RapidsBufferCatalog, its device, host and disk stores, and
SpillableColumnarBatch).  Operators that hold state register their
batches; the catalog counts the device bytes the registered batches hold
and, past ``device_budget``, moves the coldest to the host (numpy copies),
and past ``host_budget`` the coldest host batches to disk (one frame file
each, ``native.serialize_batch``, written atomically: temp file, fsync,
rename).  ``materialize`` brings a batch back to the device.  Spilling is
watermark-driven, as in the JAX package; ``memory/retry.py`` spills
everything when the device runs out anyway.

Coldest first: the lowest priority, then the least recently used (the
priorities of SpillPriorities.scala below).

* Integrity: a crc32 of the host payload is stamped when the batch leaves
  the device and checked on every restore, from the host or from disk; a
  mismatch (or a frame that no longer decodes) drops the batch and raises
  ``SpillCorruptionError``.  Wrong bytes are never returned.
* The host tier holds numpy arrays, not pinned tensors: the checksum and
  the frame codec read numpy, a 1 GiB host tier of page-locked memory
  would be taken from the whole machine, and the copy back to the card
  goes through the uploading thread's pinned staging ring
  (``columnar/column.stage_parts``) anyway.
* A spill copies the live rows only (padding past the row count stays
  behind, so a restored batch has none) and is a sync: a row count still
  on the device and the string columns' char counts come to the host in
  one counted fetch, then the buffers in one more
  (``utils/hostsync.host_sync_metrics``); each waits for the work that
  made its tensors.  The device tier counts a handle's device bytes, the
  host and disk tiers its payload's bytes.
* Views: a handle counts the bytes of its tensors' own elements, never a
  view's base storage, and a zero-stride column (``expand``) counts and
  spills one element, restored as a zero-stride view.
* Threads: the catalog's lock guards tiers and counters only.  The copies
  to the host and the disk writes run outside it, on handles marked as
  moving, so a thread that restores or closes a batch never waits behind
  another thread's device sync.  Disk writes run behind the spilling
  thread in the writer pool, with at most another ``host_budget`` of
  payloads in flight; a restore of a batch still being written waits for
  its write.

* Owners and budgets: ``register`` tags each handle with the query
  that registered it (the current ``serving/context.QueryContext``, which
  an adopted pipeline worker resolves to its driving query), and the
  catalog keeps each owner's device bytes.  Past the owner's
  ``spark.rapids.tpu.serving.queryMemoryBudgetBytes`` its own coldest
  device batches move to the host first (BudgetExhausted, action=spill);
  a query still over budget after that is rejected with a typed
  ``BudgetExhaustedFault``, and the registration that busted it is
  removed first, so the catalog's bytes are as they were.  An aliased
  registration (a no-copy stage checkpoint, whose tensors the query's
  frame still holds) is outside both counts and never a pressure victim
  while it sits on the device: moving it would free nothing counted.
* Faults: ``spill.disk`` fires in each disk write before anything is
  written (on the writer's thread), ``spill.corrupt.host`` and
  ``spill.corrupt.disk`` offer a payload to corrupt rules on each
  restore (``robustness/inject.py``), and the wait for the writers is a
  ``spill.disk`` watchdog section.

* The checkpoint floor: device pressure is attributed to the query that
  caused it (``for_owner``): that owner's batches move first within a
  priority class, and another owner's checkpoint-priority batches (at
  or below ``CHECKPOINT_TIER_MAX``, ``robustness/checkpoint.py``) keep
  ``checkpoint_floor`` device bytes unless the budget cannot be met any
  other way (``spark.rapids.tpu.serving.checkpointEvictionFloorBytes``);
  an aliased checkpoint is not moved by pressure at all.
* The compressed host tier: with ``host_codec`` > 0
  (``spark.rapids.tpu.encoding.storage.hostCodec``) a batch on the host
  is one frame of the native codec (the disk tier's format, so its disk
  write writes the frame as it is), and the host tier counts the frame's
  bytes.  The checksum is of the decoded payload, and a frame that no
  longer decodes is corruption.
"""

from __future__ import annotations

import concurrent.futures as cf
import itertools
import os
import tempfile
import threading
import time
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import Column, RowCount, to_device
from spark_rapids_tpu_torch.robustness.faults import (  # noqa: F401
    CorruptionFault, SpillIOError)

# storage tiers
DEVICE = "DEVICE"
HOST = "HOST"
DISK = "DISK"

# spill priorities (SpillPriorities.scala:26-61): shuffle outputs
# coldest, batches about to be consumed hottest
OUTPUT_FOR_SHUFFLE_INITIAL_PRIORITY = -1000
AGGREGATE_INTERMEDIATE_PRIORITY = 0
ACTIVE_ON_DECK_PRIORITY = 1000
# stage checkpoints register at or below this priority
# (robustness/checkpoint.py); the cross-query eviction floor applies to
# handles in this class
CHECKPOINT_TIER_MAX = -1500


class SpillCorruptionError(CorruptionFault):
    """A spilled batch failed its checksum (or its frame no longer
    decodes) on restore; the batch was dropped.  A ``CorruptionFault``:
    degradable, the recovery driver re-plans and reads the source
    again.  (``SpillIOError``, a failed disk write or read, is the fault
    taxonomy's, re-exported here.)"""

    def __init__(self, tier: str, detail: str):
        Exception.__init__(self, f"spill corruption at {tier}: {detail}")
        self.tier = tier


class IntegrityMetrics:
    """Process-wide checksum failures per tier."""

    def __init__(self):
        self._lock = threading.Lock()
        self.corruption_counts: Dict[str, int] = {}

    def bump(self, tier: str) -> None:
        with self._lock:
            self.corruption_counts[tier] = \
                self.corruption_counts.get(tier, 0) + 1

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.corruption_counts)

    def reset(self) -> None:
        with self._lock:
            self.corruption_counts.clear()


integrity_metrics = IntegrityMetrics()


def _emit_corruption(tier: str, buf_id: int, detail: str) -> None:
    """Event-log a checksum failure (a SpillCorruption event, stamped
    with the query in flight on this thread)."""
    from spark_rapids_tpu_torch.utils.events import emit_on_session
    emit_on_session("SpillCorruption", tier=tier, bufId=buf_id,
                    detail=detail)


def _payload_checksum(payload: dict, nrows: int) -> int:
    """crc32 of the host payload in canonical form (the JAX package's):
    the row count, then each non-empty buffer's key and raw bytes in key
    order, so any flipped bit fails verification."""
    crc = zlib.crc32(str(int(nrows)).encode())
    for key in sorted(payload):
        v = payload[key]
        if not isinstance(v, np.ndarray) or v.size == 0:
            continue
        crc = zlib.crc32(key.encode(), crc)
        crc = zlib.crc32(np.ascontiguousarray(v).view(np.uint8).reshape(-1),
                         crc)
    return crc & 0xFFFFFFFF


def _zero_stride(t: torch.Tensor) -> bool:
    return t.dim() == 1 and t.shape[0] > 1 and t.stride(0) == 0


def tensor_bytes(t: Optional[torch.Tensor]) -> int:
    """Bytes a tensor holds: its elements', never more than its storage
    (a view of a larger base counts its own elements, a zero-stride view
    one element)."""
    if t is None:
        return 0
    if _zero_stride(t):
        return t.element_size()
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def batch_bytes(batch: ColumnarBatch) -> int:
    return sum(tensor_bytes(c.data) + tensor_bytes(c.validity)
               + tensor_bytes(c.offsets) for c in batch.columns.values())


class SpillableHandle:
    """One registered batch, resident at exactly one tier."""

    _ids = itertools.count()

    def __init__(self, catalog: "SpillableBatchCatalog",
                 batch: ColumnarBatch, priority: int,
                 owner: Optional[int] = None, aliased: bool = False):
        self.id = next(SpillableHandle._ids)
        self.catalog = catalog
        self.priority = priority
        # the owning query (the QueryContext owner ident that registered
        # this batch; None outside any query): per-owner device bytes
        # and budgets
        self.owner = owner
        # the device batch shares its tensors with data its registrant
        # still holds (see SpillableBatchCatalog.register); cleared once
        # it leaves the device
        self.aliased = bool(aliased)
        self.tier = DEVICE
        self.size_bytes = batch_bytes(batch)
        # bytes of the host payload (set when it leaves the device; its
        # frame's bytes when the host tier compresses): the host and disk
        # tiers count these
        self.host_size = 0
        self.last_access = 0
        self._device: Optional[ColumnarBatch] = batch
        # the host payload: a dict of numpy buffers, or one frame (bytes)
        # when the catalog's host codec is on
        self._host = None
        self._disk_path: Optional[str] = None
        self._disk_stored = 0
        # crc32 of the host payload, stamped when the batch leaves the
        # device and checked on every restore
        self._integrity_crc: Optional[int] = None
        self._schema = batch.schema
        self._torch_device = batch.device
        # a deferred (device-resident) count stays deferred while the
        # batch sits on the device; the spill resolves it
        self._row_count = batch.row_count
        # zero-stride buffers: payload key -> rows to expand back to
        self._expanded: Dict[str, int] = {}
        # a tier move in flight on some thread (the copy runs outside the
        # catalog lock): the handle is nobody else's victim meanwhile
        self._moving = False
        self._restore_lock = threading.Lock()
        self.closed = False

    @property
    def nrows(self) -> int:
        return int(self._row_count)

    @property
    def row_count(self) -> RowCount:
        return self._row_count

    @property
    def stored_bytes(self) -> int:
        """Bytes the handle occupies at its tier: the device batch's, the
        host payload's (a compressed frame's own), or the disk frame's."""
        if self.tier == DEVICE:
            return self.size_bytes
        if self.tier == DISK and self._disk_stored:
            return self._disk_stored
        return self.host_size

    @property
    def nrows_bound(self) -> int:
        """Upper bound on nrows without a sync (the capacity while the
        count is on the device)."""
        if self._row_count.is_concrete:
            return int(self._row_count)
        b = self._device
        return b.capacity if b is not None else self.nrows

    # -------------------------------------------------------------- movement --
    def _to_host_payload(self, batch: ColumnarBatch) -> dict:
        """The batch's live rows as host numpy arrays (copies, never views
        of the device tensors): ``nrows`` values, validities and offsets
        and each string column's chars up to its last offset, so padding
        past the row count never leaves the device.  A row count still on
        the device, and the string columns' char counts, come first in one
        counted fetch; the buffers then in one more."""
        from spark_rapids_tpu_torch.utils import hostsync
        rc = self._row_count
        strings = [c for c in batch.columns.values()
                   if c.offsets is not None]
        first = []
        if not rc.is_concrete:
            first.append(rc.device_tensor(rc._device.device))
            at = first[0]
        else:
            at = int(rc)
        first += [c.offsets[at] for c in strings]
        got = [int(x) for x in hostsync.fetch_all(first)]
        if not rc.is_concrete:
            rc._value = got.pop(0)
        n = int(rc)
        ends = dict(zip(map(id, strings), got))
        keys, tensors = [], []
        for name, col in batch.columns.items():
            chars = ends.get(id(col))
            for part, t in (("data", col.data), ("validity", col.validity),
                            ("offsets", col.offsets)):
                if t is None:
                    continue
                key = f"{name}.{part}"
                if _zero_stride(t):
                    self._expanded[key] = n if part != "offsets" else n + 1
                    t = t[:1]
                elif part == "data" and chars is not None:
                    t = t[:chars]
                else:
                    t = t[:n + 1] if part == "offsets" else t[:n]
                keys.append(key)
                tensors.append(t)
        hostsync.host_sync_metrics.bump(1)
        host = [t.detach().to("cpu", copy=True).numpy() for t in tensors]
        self.host_size = sum(h.nbytes for h in host)
        return dict(zip(keys, host))

    def _rebuild(self, payload: dict, device=None) -> ColumnarBatch:
        """The batch from a host payload, on its own device (or on
        ``device``: the CPU for a reader that wants host tensors)."""
        device = self._torch_device if device is None else device
        n = self.nrows

        def buf(key, dtype):
            a = payload.get(key)
            if a is None:
                return None
            t = to_device(np.ascontiguousarray(a).view(dtype), device)
            if key in self._expanded:
                t = t.expand(self._expanded[key])
            return t

        cols = {}
        for name, dt in self._schema:
            data = buf(f"{name}.data", dt.storage)
            if data is None:
                # an empty buffer (the chars of all-empty strings) is
                # absent from a frame
                data = torch.from_numpy(np.zeros(0, dtype=dt.storage)).to(
                    device)
            offsets = buf(f"{name}.offsets", np.int32) if dt.has_offsets \
                else None
            if dt.has_offsets and offsets is None:
                offsets = torch.zeros(1, dtype=torch.int32, device=device)
            cols[name] = Column(dt, data, n,
                                validity=buf(f"{name}.validity", np.bool_),
                                offsets=offsets)
        return ColumnarBatch(cols, n)

    def _frame_columns(self, payload: dict):
        from spark_rapids_tpu_torch import native
        return [(native.dtype_code(dt), payload.get(f"{name}.data"),
                 payload.get(f"{name}.validity"),
                 payload.get(f"{name}.offsets"))
                for name, dt in self._schema]

    def _payload_from_frame(self, blob: bytes) -> dict:
        from spark_rapids_tpu_torch import native
        _, cols = native.deserialize_batch(blob)
        payload = {}
        for (name, dt), (_, d, v, o) in zip(self._schema, cols):
            if d is not None:
                payload[f"{name}.data"] = d if dt.is_string else \
                    d.view(dt.storage)
            if v is not None:
                payload[f"{name}.validity"] = v.view(np.bool_)
            if o is not None:
                payload[f"{name}.offsets"] = o.view(np.int32)
        return payload

    def spill_to_host(self) -> int:
        """Copy the batch to the host and drop the device copy; returns
        the device bytes released.  (The catalog calls this; called
        directly, the catalog's counters are the caller's to move.)"""
        assert self.tier == DEVICE
        payload = self._copy_out(self._device)
        self._host = payload
        self._device = None
        self.tier = HOST
        return self.size_bytes

    def _copy_out(self, batch: ColumnarBatch):
        """``batch`` (the device batch, taken by the caller: a close may
        drop ``_device`` meanwhile) as a checksummed host payload, or,
        with the catalog's host codec on, as one frame of it (the
        checksum is of the decoded payload)."""
        cat = self.catalog
        t0 = time.perf_counter_ns()
        payload = self._to_host_payload(batch)
        t1 = time.perf_counter_ns()
        if cat.integrity_check:
            self._integrity_crc = _payload_checksum(payload, self.nrows)
        cat._time("spill_to_host_ns", t1 - t0)
        cat._time("checksum_ns", time.perf_counter_ns() - t1)
        if not cat.host_codec:
            return payload
        from spark_rapids_tpu_torch import native
        t2 = time.perf_counter_ns()
        blob = native.serialize_batch(
            self.nrows, self._frame_columns(payload), cat.host_codec)
        cat._time("serialize_ns", time.perf_counter_ns() - t2)
        cat.note_host_encoding(self.host_size, len(blob))
        self.host_size = len(blob)
        return blob

    def _write_disk(self, payload) -> int:
        """Serialize ``payload`` (the host payload, taken by the caller:
        a close may drop ``_host`` meanwhile; a compressed host tier's
        frame is written as it is) and write it atomically; returns the
        file's bytes.  State does not move: on failure the batch is
        intact at the host tier."""
        from spark_rapids_tpu_torch import native
        from spark_rapids_tpu_torch.robustness.inject import fire
        # "spill.disk" fires before anything is written: on failure the
        # batch is still intact at the HOST tier, and the query driver
        # can retry the whole query
        fire("spill.disk")
        cat = self.catalog
        path = os.path.join(cat.spill_dir, f"buf-{self.id}.tcf")
        t0 = time.perf_counter_ns()
        blob = payload if isinstance(payload, bytes) else \
            native.serialize_batch(
                self.nrows, self._frame_columns(payload), cat.frame_codec)
        t1 = time.perf_counter_ns()
        # torn-write-proof: a crash before the rename leaves no file at
        # ``path``, so a partial frame is never restorable
        tmp = path + ".tmp"
        try:
            os.makedirs(cat.spill_dir, exist_ok=True)
            cat._write_frame(tmp, blob)
            fd = os.open(tmp, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
            os.replace(tmp, path)
        except OSError as e:
            try:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            except OSError:
                pass
            raise SpillIOError(
                f"disk spill of buf-{self.id} failed: {e}") from e
        cat._time("serialize_ns", t1 - t0)
        cat._time("disk_write_ns", time.perf_counter_ns() - t1)
        self._disk_path = path
        self._disk_stored = len(blob)
        return len(blob)

    def spill_to_disk(self) -> int:
        """Write the host payload to disk and drop it (see
        ``spill_to_host`` on the counters); returns the bytes the host
        tier released."""
        assert self.tier == HOST
        self._write_disk(self._host)
        self._host = None
        self.tier = DISK
        return self.host_size

    def materialize(self) -> ColumnarBatch:
        """The batch on the device, restored from the host or disk if it
        was spilled."""
        if self.closed:
            raise ValueError("spillable batch already closed")
        self.last_access = self.catalog.next_access_stamp()
        batch = self._device
        if batch is not None:
            return batch
        with self._restore_lock:
            batch = self._device
            if batch is not None:
                return batch
            if self.closed:
                raise ValueError("spillable batch already closed")
            from spark_rapids_tpu_torch.utils import tracing
            if tracing._armed:
                with tracing.span(f"spill.restore.{self.tier.lower()}"):
                    return self._materialize_cold()
            return self._materialize_cold()

    def host_payload(self) -> dict:
        """The host payload of a batch at the HOST or DISK tier, decoded
        and checksum-checked as a restore checks it (a mismatch drops the
        batch and raises ``SpillCorruptionError``), without bringing the
        batch back to the device and without moving it between tiers:
        for a store that answers from the host (``serving/reuse.py``)."""
        if self.closed:
            raise ValueError("spillable batch already closed")
        cat = self.catalog
        with cat._lock:
            while self._moving:
                cat._moved.wait()
            if self.closed:
                raise ValueError("spillable batch already closed")
            tier = self.tier
            if tier == DEVICE:
                raise ValueError(f"buf-{self.id} is on the device")
            self._moving = True
        try:
            payload, bad = self._load_payload(tier)
            if bad is None:
                bad = self._check(payload)
        finally:
            with cat._lock:
                self._moving = False
                cat._moved.notify_all()
        if bad is not None:
            self._drop_corrupt(tier, bad)
        return payload

    def _drop_corrupt(self, tier: str, bad: str) -> None:
        """Wrong bytes are never returned: the batch is dropped, counted
        and reported, and ``SpillCorruptionError`` raised."""
        self.close()
        integrity_metrics.bump(tier)
        with self.catalog._lock:
            self.catalog.integrity_failures += 1
        _emit_corruption(tier, self.id, bad)
        raise SpillCorruptionError(tier, bad)

    def host_batch(self, payload: dict) -> ColumnarBatch:
        """``payload`` (from :meth:`host_payload`, or a copy of it) as a
        batch of CPU tensors (copies: the stored payload stays as it
        was)."""
        copy = {k: np.array(v, copy=True) for k, v in payload.items()}
        return self._rebuild(copy, device=torch.device("cpu"))

    def _materialize_cold(self) -> ColumnarBatch:
        cat = self.catalog
        with cat._lock:
            # a move to disk in flight finishes first; meanwhile no mover
            # takes this handle
            while self._moving:
                cat._moved.wait()
            if self.closed:
                raise ValueError("spillable batch already closed")
            tier = self.tier
            self._moving = True
        batch = None
        try:
            t0 = time.perf_counter_ns()
            payload, bad = self._load_payload(tier)
            if bad is None:
                bad = self._check(payload)
            if bad is None:
                batch = self._rebuild(payload)
                cat._time("restore_ns", time.perf_counter_ns() - t0)
        finally:
            # back on the device in the same lock region that ends the
            # move, so no mover takes the handle at its old tier between
            with cat._lock:
                cat._restored(self, batch, tier)
                self._moving = False
                cat._moved.notify_all()
        if bad is not None:
            self._drop_corrupt(tier, bad)
        cat.ensure_budget(for_owner=self.owner)
        return batch

    def _load_payload(self, tier: str):
        """(payload, None), or (None, why) for a frame that no longer
        decodes."""
        from spark_rapids_tpu_torch.robustness.inject import fire_mutate
        if tier == HOST and not isinstance(self._host, bytes):
            return self._corrupt_point(self._host, "spill.corrupt.host"), \
                None
        if tier == HOST:
            # a compressed host frame: the corrupt rule rots its bytes,
            # as on disk
            blob = fire_mutate("spill.corrupt.host", self._host)
            try:
                return self._payload_from_frame(blob), None
            except ValueError as e:
                return None, f"buf-{self.id}: host frame decode failed: {e}"
        from spark_rapids_tpu_torch import native
        t0 = time.perf_counter_ns()
        try:
            blob = native.read_spill_file(self._disk_path)
        except OSError as e:
            raise SpillIOError(
                f"disk restore of buf-{self.id} failed: {e}") from e
        self.catalog._time("disk_read_ns", time.perf_counter_ns() - t0)
        blob = fire_mutate("spill.corrupt.disk", blob)
        try:
            return self._payload_from_frame(blob), None
        except ValueError as e:
            return None, f"buf-{self.id}: frame decode failed: {e}"

    @staticmethod
    def _corrupt_point(payload: dict, point: str) -> dict:
        """Chaos hook: offer ONE payload buffer (the first non-empty one
        in key order) to an armed corrupt rule.  The mutated copy
        replaces it in a shallow copy of the dict: the restore sees rot,
        the stored payload itself is untouched."""
        from spark_rapids_tpu_torch.robustness.inject import fire_mutate
        key = next((k for k in sorted(payload)
                    if isinstance(payload[k], np.ndarray)
                    and payload[k].size > 0), None)
        if key is None:
            return payload
        mutated = fire_mutate(point, payload[key])
        if mutated is payload[key]:
            return payload
        payload = dict(payload)
        payload[key] = mutated
        return payload

    def _check(self, payload: dict) -> Optional[str]:
        """The checksum gate of every restore: None, or the mismatch."""
        if not self.catalog.integrity_check or self._integrity_crc is None:
            return None
        t0 = time.perf_counter_ns()
        got = _payload_checksum(payload, self.nrows)
        self.catalog._time("checksum_ns", time.perf_counter_ns() - t0)
        if got == self._integrity_crc:
            return None
        return (f"buf-{self.id}: crc {got:#010x} != stored "
                f"{self._integrity_crc:#010x}")

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        self._device = None
        self._host = None
        path = self._disk_path   # a restore or writer may clear it
        try:
            if path and os.path.exists(path):
                os.unlink(path)
        except OSError:
            # the catalog's close sweep collects what a failed unlink
            # left behind
            pass
        finally:
            # deregistration survives an unlink failure
            self._disk_path = None
            self.catalog.remove(self)


class SpillableBatchCatalog:
    """Registry of spillable batches with watermark-driven demotion.

    ``device_budget``: device bytes the registered batches may hold
    before the coldest move to the host; ``host_budget``: host bytes
    before the coldest host batches move to disk
    (``memory.host.spillStorageSize``).  ``frame_codec``: the disk
    frames' codec level; ``disk_write_threads`` writers encode and write
    frames behind the spilling thread (``wait_for_writes``), which waits
    at most ``disk_write_timeout_s`` for them (a wedged writer then
    raises ``SpillIOError`` instead of hanging the query).  ``max_retries``: the OOM recoveries ``memory/retry.py``
    makes per attempt for work that spills into this catalog."""

    def __init__(self, device_budget: int = 1 << 34,
                 host_budget: int = 1 << 30,
                 spill_dir: Optional[str] = None,
                 frame_codec: int = 2,
                 disk_write_threads: int = 2,
                 integrity_check: bool = True,
                 disk_write_timeout_s: float = 600.0,
                 max_retries: int = 2,
                 checkpoint_floor: int = 0,
                 host_codec: int = 0):
        self.device_budget = device_budget
        # device bytes another owner's pressure may not take from an
        # owner's checkpoint-priority batches (0: no floor)
        self.checkpoint_floor = int(checkpoint_floor)
        # the host tier's frame codec level (0: numpy payloads) and the
        # raw and encoded bytes of the frames it made
        self.host_codec = int(host_codec)
        self.host_raw_bytes_total = 0
        self.host_encoded_bytes_total = 0
        # OOM recoveries per guarded attempt (memory/retry.py)
        self.max_retries = int(max_retries)
        self.host_budget = host_budget
        self.integrity_check = bool(integrity_check)
        self.frame_codec = int(frame_codec)
        self.disk_write_threads = max(int(disk_write_threads), 1)
        self.disk_write_timeout_s = float(disk_write_timeout_s)
        # made on the first disk spill; only a directory this catalog
        # made is removed at close
        self._owns_spill_dir = spill_dir is None
        self._spill_dir = spill_dir
        # build the host runtime now: a first build inside a spill would
        # stall every thread behind it (and a failed one should fail the
        # session, not a query)
        from spark_rapids_tpu_torch import native
        native.library()
        self._lock = threading.Lock()
        self._moved = threading.Condition(self._lock)
        self._handles: Dict[int, SpillableHandle] = {}
        # the disk writers (made on the first disk spill), the payload
        # bytes they hold, and the first write error not yet raised
        self._writer: Optional[cf.ThreadPoolExecutor] = None
        self._inflight_bytes = 0
        self._write_error: Optional[BaseException] = None
        # every id this catalog issued: the close sweep removes only
        # these files from a spill directory others may share
        self._issued_ids: set = set()
        self.device_bytes = 0
        self.host_bytes = 0
        self.disk_bytes = 0
        self.spilled_to_host_total = 0
        self.spilled_to_disk_total = 0
        self.host_copy_bytes_total = 0
        self.disk_file_bytes_total = 0
        self.restored_from_host_total = 0
        self.restored_from_disk_total = 0
        self.integrity_failures = 0
        # per-owner DEVICE-tier byte budgets (a QueryContext installs
        # its queryMemoryBudgetBytes) and device bytes, the latter
        # mirrored wherever ``device_bytes`` moves
        self._owner_budgets: Dict[int, int] = {}
        self._owner_device: Dict[int, int] = {}
        self._times: Dict[str, int] = {
            k: 0 for k in ("spill_to_host_ns", "checksum_ns", "serialize_ns",
                           "disk_write_ns", "disk_read_ns", "restore_ns")}
        self._access_counter = itertools.count(1)

    @property
    def spill_dir(self) -> str:
        if self._spill_dir is None:
            with self._lock:
                if self._spill_dir is None:
                    self._spill_dir = tempfile.mkdtemp(prefix="torch-spill-")
        return self._spill_dir

    def next_access_stamp(self) -> int:
        return next(self._access_counter)

    def _time(self, key: str, ns: int) -> None:
        with self._lock:
            self._times[key] += ns

    def note_host_encoding(self, raw: int, encoded: int) -> None:
        with self._lock:
            self.host_raw_bytes_total += int(raw)
            self.host_encoded_bytes_total += int(encoded)

    @staticmethod
    def _write_frame(path: str, blob: bytes) -> None:
        """The pager write (one place, so a test can wedge it)."""
        from spark_rapids_tpu_torch import native
        native.write_spill_file(path, blob)

    # ------------------------------------------------------------- interface --
    def register(self, batch: ColumnarBatch,
                 priority: int = AGGREGATE_INTERMEDIATE_PRIORITY,
                 owner: Optional[int] = None,
                 aliased: bool = False) -> SpillableHandle:
        """Register a device batch.  ``aliased``: the batch shares its
        tensors with data the caller still holds (a no-copy stage
        checkpoint of a frame the query goes on using).  While it stays
        on the device it is counted in neither the device tier nor its
        owner's budget, and pressure never picks it: moving it would free
        nothing the catalog could count.  Its registrant bounds it (the
        lineage log's ``maxBytes``).  An explicit :meth:`demote` moves it,
        and from then on it is an ordinary host batch."""
        if owner is None:
            # the registering query's scope (the pipeline worker and any
            # other thread adopted into a QueryContext resolve to it)
            from spark_rapids_tpu_torch.serving import context as qc
            ctx = qc.current()
            owner = ctx.owner_ident if ctx is not None else None
        from spark_rapids_tpu_torch.utils import tracing
        if tracing._armed:
            with tracing.span("spill.register"):
                return self._register_impl(batch, priority, owner,
                                           aliased)
        return self._register_impl(batch, priority, owner, aliased)

    def _register_impl(self, batch: ColumnarBatch, priority: int,
                       owner: Optional[int],
                       aliased: bool = False) -> SpillableHandle:
        h = SpillableHandle(self, batch, priority, owner=owner,
                            aliased=aliased)
        h.last_access = self.next_access_stamp()
        with self._lock:
            self._handles[h.id] = h
            self._issued_ids.add(h.id)
            if not aliased:
                self.device_bytes += h.size_bytes
                self._owner_device_adjust(owner, h.size_bytes)
        if not aliased:
            self.ensure_budget(for_owner=owner)
            self._enforce_owner_budget(h)
        return h

    # ------------------------------------------------------- per-owner budgets --
    def set_owner_budget(self, owner: int, budget: int) -> None:
        with self._lock:
            self._owner_budgets[owner] = int(budget)

    def clear_owner_budget(self, owner: int) -> None:
        with self._lock:
            self._owner_budgets.pop(owner, None)

    def owner_device_bytes(self, owner: int) -> int:
        with self._lock:
            return self._owner_device.get(owner, 0)

    def _owner_device_adjust(self, owner: Optional[int], delta: int) -> None:
        """Under the lock: mirror a DEVICE-tier byte movement into the
        owner's count."""
        if owner is None or not delta:
            return
        new = self._owner_device.get(owner, 0) + delta
        if new:
            self._owner_device[owner] = new
        else:
            self._owner_device.pop(owner, None)

    def _enforce_owner_budget(self, h: SpillableHandle) -> None:
        """The per-query memory-budget ladder, after each of an owner's
        registrations: over budget, the owner's OWN coldest device
        batches move to the host (other queries' batches are untouched);
        when that still leaves the owner over (the new batch alone is
        past the budget), the owning query is rejected with a typed
        BudgetExhaustedFault, after the registration is removed: the
        caller never receives the handle, so it must not stay behind."""
        owner = h.owner
        if owner is None:
            return
        with self._lock:
            budget = self._owner_budgets.get(owner)
            used = self._owner_device.get(owner, 0)
            if budget is None or used <= budget:
                return
            victims = []
            for v in sorted((x for x in self._handles.values()
                             if x.owner == owner and x.tier == DEVICE
                             and not x._moving and not x.aliased
                             and x.id != h.id),
                            key=lambda x: (x.priority, x.last_access, x.id)):
                if used <= budget:
                    break
                v._moving = True
                used -= v.size_bytes
                victims.append(v)
            moved = sum(v.size_bytes for v in victims)
            self.device_bytes -= moved
            self._owner_device_adjust(owner, -moved)
        if victims:
            self._to_host(victims)
        with self._lock:
            used = self._owner_device.get(owner, 0)
        from spark_rapids_tpu_torch.serving import context as qc
        ctx = qc.current()
        if ctx is None:
            return
        if victims:
            ctx.note_memory_pressure(used, spilled=True)
        if used > budget:
            h.close()
            ctx.note_memory_pressure(used, spilled=False)  # raises

    def unspill(self, h: SpillableHandle, batch: ColumnarBatch,
                tier: str) -> None:
        """Back on the device after a restore from ``tier``."""
        with self._lock:
            self._restored(h, batch, tier)
        self.ensure_budget(for_owner=h.owner)

    def _restored(self, h: SpillableHandle, batch: Optional[ColumnarBatch],
                  tier: str) -> None:
        """Under the lock: account a restore of ``h`` from ``tier`` that
        ended with ``batch`` (None: it failed, and the handle stays
        where it was).  A handle closed meanwhile leaves its tier here,
        since its close left the accounting to the restore."""
        gone = h.id not in self._handles
        if batch is None and not gone:
            return
        if tier == HOST:
            self.host_bytes -= h.host_size
        else:
            self.disk_bytes -= h.host_size
            path, h._disk_path = h._disk_path, None
            if path and os.path.exists(path):
                os.unlink(path)
        if gone:
            return
        if tier == HOST:
            self.restored_from_host_total += h.host_size
        else:
            self.restored_from_disk_total += h.host_size
        h.tier = DEVICE
        h._device = batch
        h._host = None
        self.device_bytes += h.size_bytes
        self._owner_device_adjust(h.owner, h.size_bytes)

    def remove(self, h: SpillableHandle) -> None:
        with self._lock:
            if self._handles.pop(h.id, None) is None:
                return
            if h._moving:
                # the mover accounts for the handle when it finishes
                return
            if h.tier == DEVICE:
                if not h.aliased:
                    self.device_bytes -= h.size_bytes
                    self._owner_device_adjust(h.owner, -h.size_bytes)
            elif h.tier == HOST:
                self.host_bytes -= h.host_size
            else:
                self.disk_bytes -= h.host_size

    def demote(self, h: SpillableHandle, target: str) -> None:
        """Move one handle down to ``target`` now, whatever the budgets."""
        if target not in (HOST, DISK):
            return
        with self._lock:
            if h.closed or h.id not in self._handles or h._moving:
                return
            tier = h.tier
            if tier == DEVICE:
                h._moving = True
                if not h.aliased:
                    self.device_bytes -= h.size_bytes
                    self._owner_device_adjust(h.owner, -h.size_bytes)
        if tier == DEVICE:
            self._to_host([h])
        if target == DISK:
            with self._lock:
                if h.closed or h.tier != HOST or h._moving:
                    return
                h._moving = True
                self.host_bytes -= h.host_size
            self._to_disk([h])
            self.wait_for_writes()

    def ensure_budget(self, extra_needed: int = 0,
                      for_owner: Optional[int] = None) -> None:
        """Demote the coldest handles until the budgets hold (the
        synchronous spill of RapidsBufferStore.scala:146); callers may ask
        for ``extra_needed`` device bytes of headroom.  ``for_owner``: the
        query whose registration caused the pressure (the checkpoint
        floor's attribution)."""
        victims = self._pick(DEVICE, self.device_budget - extra_needed,
                             for_owner)
        if victims:
            self._to_host(victims)
        victims = self._pick(HOST, self.host_budget)
        if victims:
            self._to_disk(victims)

    def _floor_protected(self, h: SpillableHandle,
                         for_owner: Optional[int],
                         device_left: Dict[int, int]) -> bool:
        """Under the lock: whether pressure from ``for_owner`` may not
        take ``h``, another owner's checkpoint-priority batch, because
        that owner's device checkpoint bytes would fall below the floor.
        An owner's own batches are never protected from its own
        pressure."""
        if not self.checkpoint_floor or h.owner is None or \
                h.owner == for_owner or h.priority > CHECKPOINT_TIER_MAX:
            return False
        left = device_left.get(h.owner)
        if left is None:
            left = sum(x.size_bytes for x in self._handles.values()
                       if x.owner == h.owner and x.tier == DEVICE
                       and not x._moving and not x.aliased
                       and x.priority <= CHECKPOINT_TIER_MAX)
            device_left[h.owner] = left
        if left - h.size_bytes < self.checkpoint_floor:
            return True
        device_left[h.owner] = left - h.size_bytes
        return False

    def _pick(self, tier: str, budget: int,
              for_owner: Optional[int] = None) -> List[SpillableHandle]:
        """Under the lock: the coldest handles of ``tier`` whose move
        brings it within ``budget``, marked moving and taken off the
        tier's count.  Coldest: the lowest priority, then (under
        attributed pressure) the causing owner's before another's, then
        the least recently used.  A batch the checkpoint floor protects
        moves only when nothing else brings the tier within budget."""
        with self._lock:
            used = self.device_bytes if tier == DEVICE else self.host_bytes
            if used <= budget:
                return []

            def key(h):
                foreign = 1 if (for_owner is not None and
                                h.owner != for_owner) else 0
                return (h.priority, foreign, h.last_access, h.id)

            candidates = sorted(
                (h for h in self._handles.values()
                 if h.tier == tier and not h._moving and not h.aliased),
                key=key)
            picked, deferred = [], []
            device_left: Dict[int, int] = {}
            for h in candidates:
                if used <= budget:
                    break
                if tier == DEVICE and \
                        self._floor_protected(h, for_owner, device_left):
                    deferred.append(h)
                    continue
                used -= h.size_bytes if tier == DEVICE else h.host_size
                picked.append(h)
            # the floor is isolation, not a leak
            for h in deferred:
                if used <= budget:
                    break
                used -= h.size_bytes
                picked.append(h)
            for h in picked:
                h._moving = True
            if tier == DEVICE:
                self.device_bytes -= sum(h.size_bytes for h in picked)
                for h in picked:
                    self._owner_device_adjust(h.owner, -h.size_bytes)
            else:
                self.host_bytes -= sum(h.host_size for h in picked)
            return picked

    def _finish(self, h: SpillableHandle, tier: str, ok: bool) -> None:
        """Under the lock: account a finished move of ``h`` to ``tier``
        (``ok``) or put it back where it was."""
        h._moving = False
        self._moved.notify_all()
        gone = h.id not in self._handles
        if not ok:
            if not gone:
                if tier == HOST:
                    if not h.aliased:
                        self.device_bytes += h.size_bytes
                        self._owner_device_adjust(h.owner, h.size_bytes)
                else:
                    self.host_bytes += h.host_size
            return
        if tier == HOST:
            h.aliased = False  # the host payload is the catalog's own copy
            self.spilled_to_host_total += h.size_bytes
            self.host_copy_bytes_total += h.host_size
            if not gone:
                self.host_bytes += h.host_size
        else:
            self.spilled_to_disk_total += h.host_size
            self.disk_file_bytes_total += h._disk_stored
            if not gone:
                self.disk_bytes += h.host_size

    def _to_host(self, victims: List[SpillableHandle]) -> None:
        from spark_rapids_tpu_torch.utils import tracing
        with self._lock:
            jobs = [(h, h._device) for h in victims]
        for i, (h, batch) in enumerate(jobs):
            try:
                with tracing.span("spill.demote.host"):
                    payload = None if batch is None else h._copy_out(batch)
            except BaseException:
                with self._lock:
                    for v, _ in jobs[i:]:
                        self._finish(v, HOST, False)
                raise
            with self._lock:
                if payload is None or h.closed:
                    # closed since it was picked: nothing lands anywhere
                    self._finish(h, HOST, False)
                    continue
                h._host = payload
                h._device = None
                h.tier = HOST
                self._finish(h, HOST, True)
        with self._lock:
            over = self.host_bytes > self.host_budget
        if over:
            victims = self._pick(HOST, self.host_budget)
            if victims:
                self._to_disk(victims)

    def _to_disk(self, victims: List[SpillableHandle]) -> None:
        """Hand the victims to the writer pool: their frames encode and
        write behind this thread, each handle marked as moving (its
        payload still on the host) until its write lands.  This thread
        waits only while more than ``host_budget`` bytes of payloads are
        in flight, so the host holds at most twice its budget."""
        with self._lock:
            if self._writer is None:
                self._writer = cf.ThreadPoolExecutor(
                    max_workers=self.disk_write_threads,
                    thread_name_prefix="spill-writer")
            for h in victims:
                self._inflight_bytes += h.host_size
            jobs = [(h, h._host) for h in victims]
        for h, payload in jobs:
            self._writer.submit(self._write_job, h, payload) \
                .add_done_callback(lambda f, h=h: self._write_done(h, f))
        self.wait_for_writes(self.host_budget)

    @staticmethod
    def _write_job(h: SpillableHandle, payload: Optional[dict]) -> None:
        if payload is not None and not h.closed:
            h._write_disk(payload)

    def _write_done(self, h: SpillableHandle, fut) -> None:
        """A writer finished ``h``: account it at DISK, or back at HOST
        when the write failed (the error raises from the next wait)."""
        err = fut.exception()
        with self._lock:
            ok = err is None and not h.closed
            if h.closed:
                # closed while in flight: its file (if written) goes
                path, h._disk_path = h._disk_path, None
                if path is not None:
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
            elif err is None:
                h._host = None
                h.tier = DISK
            elif self._write_error is None:
                self._write_error = err
            self._inflight_bytes -= h.host_size
            self._finish(h, DISK, ok)

    def wait_for_writes(self, limit: int = 0) -> None:
        """Wait until at most ``limit`` bytes of payloads are being
        written to disk (0: every write has landed).  A write that failed
        since the last wait raises here (its batch is intact at the host
        tier), and so does a wait past ``disk_write_timeout_s`` (a wedged
        writer: its handle stays marked as moving; the query fails
        instead of hanging)."""
        deadline = time.monotonic() + self.disk_write_timeout_s
        with self._lock:
            waiting = self._inflight_bytes > limit
        if waiting:
            # a "spill.disk" watchdog section that beats whenever a
            # write lands, so its deadline measures a stuck writer (a
            # stalled disk, a delay rule on "spill.disk"); each wait
            # slice is a cancellation checkpoint, taken outside the lock
            from spark_rapids_tpu_torch.robustness import watchdog
            with watchdog.section("spill.disk") as sect:
                while True:
                    watchdog.checkpoint()
                    with self._lock:
                        before = self._inflight_bytes
                        if before <= limit:
                            break
                        left = deadline - time.monotonic()
                        if left <= 0:
                            raise SpillIOError(
                                f"{before} bytes of disk spill writes "
                                f"did not finish within "
                                f"{self.disk_write_timeout_s} s")
                        self._moved.wait(min(left, 0.05))
                        landed = self._inflight_bytes < before
                    if landed and sect is not None:
                        sect.beat()
        with self._lock:
            err, self._write_error = self._write_error, None
        if err is not None:
            raise err

    def close(self) -> None:
        """Close every live handle (unlinking its file), then remove the
        orphaned frames this catalog issued (``buf-<id>.tcf`` and torn
        ``.tcf.tmp`` files) and the spill directory if the catalog made
        it.  The catalog stays usable."""
        try:
            self.wait_for_writes()
        except OSError:
            # a failed or wedged write: its handle closes all the same
            pass
        with self._lock:
            handles = list(self._handles.values())
        for h in handles:
            h.close()

        def mine(name: str) -> bool:
            if not name.startswith("buf-") or not (
                    name.endswith(".tcf") or name.endswith(".tcf.tmp")):
                return False
            try:
                return int(name[4:].split(".", 1)[0]) in self._issued_ids
            except ValueError:
                return False

        spill_dir = self._spill_dir
        if spill_dir is None:
            return
        try:
            for name in os.listdir(spill_dir):
                if mine(name):
                    try:
                        os.unlink(os.path.join(spill_dir, name))
                    except OSError:
                        pass
            if self._owns_spill_dir:
                os.rmdir(spill_dir)
                self._spill_dir = None
        except OSError:
            pass

    def stats(self) -> Dict[str, int]:
        with self._lock:
            out = {
                "device_bytes": self.device_bytes,
                "host_bytes": self.host_bytes,
                "disk_bytes": self.disk_bytes,
                "spilled_to_host_total": self.spilled_to_host_total,
                "spilled_to_disk_total": self.spilled_to_disk_total,
                "host_copy_bytes_total": self.host_copy_bytes_total,
                "disk_file_bytes_total": self.disk_file_bytes_total,
                "restored_from_host_total": self.restored_from_host_total,
                "restored_from_disk_total": self.restored_from_disk_total,
                "num_handles": len(self._handles),
                "integrity_failures": self.integrity_failures,
                "host_raw_bytes_total": self.host_raw_bytes_total,
                "host_encoded_bytes_total": self.host_encoded_bytes_total,
            }
            out.update(self._times)
        return out


_default_catalog: Optional[SpillableBatchCatalog] = None


def default_catalog() -> SpillableBatchCatalog:
    """The catalog of operators built outside a session (a session's
    planner binds its own catalog to the operators it builds)."""
    global _default_catalog
    if _default_catalog is None:
        _default_catalog = SpillableBatchCatalog()
    return _default_catalog


def set_default_catalog(cat: Optional[SpillableBatchCatalog]) -> None:
    global _default_catalog
    _default_catalog = cat


class TpuSemaphore:
    """Admission control: bounds the tasks issuing device work at once
    (GpuSemaphore.scala:28, ``spark.rapids.sql.concurrentTpuTasks``);
    re-entrant per thread."""

    def __init__(self, permits: int = 1):
        self._sem = threading.BoundedSemaphore(permits)
        self._held = threading.local()
        self.wait_time_ns = 0

    def acquire_if_necessary(self) -> None:
        if getattr(self._held, "count", 0) == 0:
            t0 = time.perf_counter_ns()
            self._sem.acquire()
            self.wait_time_ns += time.perf_counter_ns() - t0
        self._held.count = getattr(self._held, "count", 0) + 1

    def release_if_held(self) -> None:
        count = getattr(self._held, "count", 0)
        if count > 0:
            self._held.count = count - 1
            if self._held.count == 0:
                self._sem.release()

    def release_all_held(self) -> None:
        """Drop this thread's whole admission count."""
        if getattr(self._held, "count", 0) > 0:
            self._held.count = 0
            self._sem.release()

    def __enter__(self):
        self.acquire_if_necessary()
        return self

    def __exit__(self, *exc):
        self.release_if_held()
        return False
