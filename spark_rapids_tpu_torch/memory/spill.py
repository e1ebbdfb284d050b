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

Not ported: the JAX package's per-query owner budgets, the checkpoint
eviction floor and the compressed host tier, which serve its serving and
robustness layers.
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

# storage tiers
DEVICE = "DEVICE"
HOST = "HOST"
DISK = "DISK"

# spill priorities (SpillPriorities.scala:26-61): shuffle outputs
# coldest, batches about to be consumed hottest
OUTPUT_FOR_SHUFFLE_INITIAL_PRIORITY = -1000
AGGREGATE_INTERMEDIATE_PRIORITY = 0
ACTIVE_ON_DECK_PRIORITY = 1000


class SpillCorruptionError(RuntimeError):
    """A spilled batch failed its checksum (or its frame no longer
    decodes) on restore; the batch was dropped."""

    def __init__(self, tier: str, detail: str):
        super().__init__(f"spill corruption at {tier}: {detail}")
        self.tier = tier


class SpillIOError(OSError):
    """A disk spill or restore failed; a failed write leaves the batch
    intact at the host tier."""


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
                 batch: ColumnarBatch, priority: int):
        self.id = next(SpillableHandle._ids)
        self.catalog = catalog
        self.priority = priority
        self.tier = DEVICE
        self.size_bytes = batch_bytes(batch)
        # bytes of the host payload (set when it leaves the device): the
        # host and disk tiers count these
        self.host_size = 0
        self.last_access = 0
        self._device: Optional[ColumnarBatch] = batch
        self._host: Optional[dict] = None
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

    def _rebuild(self, payload: dict) -> ColumnarBatch:
        device = self._torch_device
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

    def _copy_out(self, batch: ColumnarBatch) -> dict:
        """``batch`` (the device batch, taken by the caller: a close may
        drop ``_device`` meanwhile) as a checksummed host payload."""
        cat = self.catalog
        t0 = time.perf_counter_ns()
        payload = self._to_host_payload(batch)
        t1 = time.perf_counter_ns()
        if cat.integrity_check:
            self._integrity_crc = _payload_checksum(payload, self.nrows)
        cat._time("spill_to_host_ns", t1 - t0)
        cat._time("checksum_ns", time.perf_counter_ns() - t1)
        return payload

    def _write_disk(self, payload: dict) -> int:
        """Serialize ``payload`` (the host payload, taken by the caller:
        a close may drop ``_host`` meanwhile) and write it atomically;
        returns the file's bytes.  State does not move: on failure the
        batch is intact at the host tier."""
        from spark_rapids_tpu_torch import native
        cat = self.catalog
        path = os.path.join(cat.spill_dir, f"buf-{self.id}.tcf")
        t0 = time.perf_counter_ns()
        blob = native.serialize_batch(
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
            return self._materialize_cold()

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
            # wrong bytes are never returned: the batch is dropped
            self.close()
            integrity_metrics.bump(tier)
            with cat._lock:
                cat.integrity_failures += 1
            raise SpillCorruptionError(tier, bad)
        cat.ensure_budget()
        return batch

    def _load_payload(self, tier: str):
        """(payload, None), or (None, why) for a frame that no longer
        decodes."""
        if tier == HOST:
            return self._host, None
        from spark_rapids_tpu_torch import native
        t0 = time.perf_counter_ns()
        try:
            blob = native.read_spill_file(self._disk_path)
        except OSError as e:
            raise SpillIOError(
                f"disk restore of buf-{self.id} failed: {e}") from e
        self.catalog._time("disk_read_ns", time.perf_counter_ns() - t0)
        try:
            return self._payload_from_frame(blob), None
        except ValueError as e:
            return None, f"buf-{self.id}: frame decode failed: {e}"

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
                 max_retries: int = 2):
        self.device_budget = device_budget
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

    @staticmethod
    def _write_frame(path: str, blob: bytes) -> None:
        """The pager write (one place, so a test can wedge it)."""
        from spark_rapids_tpu_torch import native
        native.write_spill_file(path, blob)

    # ------------------------------------------------------------- interface --
    def register(self, batch: ColumnarBatch,
                 priority: int = AGGREGATE_INTERMEDIATE_PRIORITY
                 ) -> SpillableHandle:
        h = SpillableHandle(self, batch, priority)
        h.last_access = self.next_access_stamp()
        with self._lock:
            self._handles[h.id] = h
            self._issued_ids.add(h.id)
            self.device_bytes += h.size_bytes
        self.ensure_budget()
        return h

    def unspill(self, h: SpillableHandle, batch: ColumnarBatch,
                tier: str) -> None:
        """Back on the device after a restore from ``tier``."""
        with self._lock:
            self._restored(h, batch, tier)
        self.ensure_budget()

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

    def remove(self, h: SpillableHandle) -> None:
        with self._lock:
            if self._handles.pop(h.id, None) is None:
                return
            if h._moving:
                # the mover accounts for the handle when it finishes
                return
            if h.tier == DEVICE:
                self.device_bytes -= h.size_bytes
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
                self.device_bytes -= h.size_bytes
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

    def ensure_budget(self, extra_needed: int = 0) -> None:
        """Demote the coldest handles until the budgets hold (the
        synchronous spill of RapidsBufferStore.scala:146); callers may ask
        for ``extra_needed`` device bytes of headroom."""
        victims = self._pick(DEVICE, self.device_budget - extra_needed)
        if victims:
            self._to_host(victims)
        victims = self._pick(HOST, self.host_budget)
        if victims:
            self._to_disk(victims)

    def _pick(self, tier: str, budget: int) -> List[SpillableHandle]:
        """Under the lock: the coldest handles of ``tier`` whose move
        brings it within ``budget``, marked moving and taken off the
        tier's count."""
        with self._lock:
            used = self.device_bytes if tier == DEVICE else self.host_bytes
            if used <= budget:
                return []
            candidates = sorted(
                (h for h in self._handles.values()
                 if h.tier == tier and not h._moving),
                key=lambda h: (h.priority, h.last_access, h.id))
            picked = []
            for h in candidates:
                if used <= budget:
                    break
                h._moving = True
                used -= h.size_bytes if tier == DEVICE else h.host_size
                picked.append(h)
            if tier == DEVICE:
                self.device_bytes -= sum(h.size_bytes for h in picked)
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
                    self.device_bytes += h.size_bytes
                else:
                    self.host_bytes += h.host_size
            return
        if tier == HOST:
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
        with self._lock:
            jobs = [(h, h._device) for h in victims]
        for i, (h, batch) in enumerate(jobs):
            try:
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
            while self._inflight_bytes > limit:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise SpillIOError(
                        f"{self._inflight_bytes} bytes of disk spill "
                        f"writes did not finish within "
                        f"{self.disk_write_timeout_s} s")
                self._moved.wait(left)
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
