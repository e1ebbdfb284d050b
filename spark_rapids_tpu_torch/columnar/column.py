"""Device column and lazy row count.

Counterpart of ``spark_rapids_tpu/columnar/column.py``.  A Column is a torch
tensor of values plus an optional bool validity tensor (True = valid, None =
no nulls) on one device, with a logical row count.  A string column keeps
the JAX layout: uint8 chars plus int32 row offsets; an array column the
same layout over its flat fixed-width elements (no null elements, as in
the JAX package; an ``array<string>``, which only the CPU fallback makes,
holds int32 codes into a host string table, its ``dictionary``); a
decimal column its unscaled int64 values (:func:`decimal_unscaled`, :func:`decimal_array`
convert arrow's 128-bit decimals without a Python object per row).  XLA
needed every buffer padded to a power-of-two capacity; PyTorch does not,
so columns built from host data are exact-length.  Operators that produce a data-dependent number
of rows (a group-by's groups) may still return buffers longer than the row
count, with the count carried lazily on the device: rows past it are
padding that every consumer masks.
"""

from __future__ import annotations

import datetime as _dt
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.columnar.dtypes import DataType

MIN_CAPACITY = 1024


def decimal_unscaled(arr) -> np.ndarray:
    """An arrow decimal128 array (precision <= 18) as its unscaled int64
    values, read from the low words of its 16-byte little-endian buffer;
    null slots hold zero."""
    n = len(arr)
    buf = arr.buffers()[1]
    if buf is None or not n:
        return np.zeros(n, dtype=np.int64)
    words = np.frombuffer(buf, dtype=np.int64)
    out = words[2 * arr.offset: 2 * (arr.offset + n): 2]
    if arr.null_count:
        import pyarrow.compute as pc
        valid = pc.is_valid(arr).to_numpy(zero_copy_only=False)
        out = np.where(valid, out, 0)
    return out


def decimal_array(values: np.ndarray, valid, dt: DataType):
    """An arrow ``decimal128(p, s)`` array of unscaled int64 ``values``
    (``valid`` False is null, None is all valid): each value's low word
    and its sign as the high word."""
    import pyarrow as pa
    values = np.asarray(values, dtype=np.int64)
    n = values.shape[0]
    words = np.empty((n, 2), dtype=np.int64)
    words[:, 0] = values
    words[:, 1] = values >> 63
    bitmap = None
    if valid is not None and not np.all(valid):
        bitmap = pa.py_buffer(np.packbits(np.asarray(valid, dtype=np.bool_),
                                          bitorder="little"))
    return pa.Array.from_buffers(
        dts.to_arrow_type(dt), n, [bitmap, pa.py_buffer(words)],
        null_count=-1 if bitmap is not None else 0)


def _host_view(a: np.ndarray) -> torch.Tensor:
    """A tensor over a numpy array's memory, read-only arrays (arrow's
    buffers) included: it is only read from."""
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.ascontiguousarray(a))


STAGING_SLOT_BYTES = 64 << 20
STAGING_SLOTS = 4


class StagingRing:
    """A thread's pinned staging buffers for one CUDA device, used in
    turn: ``STAGING_SLOTS`` slots of ``STAGING_SLOT_BYTES``.  A slot is
    refilled only after the device copy that last read it has completed
    (its event), so pinned memory stays bounded however far the host runs
    ahead of the card, and a slow host never waits on a new pinned
    allocation.  Each uploading thread keeps its own ring
    (``_staging_ring``); the blocks go back to PyTorch's caching host
    allocator with the thread."""

    def __init__(self, device: torch.device):
        # on the CPU (the tests) the slots are plain memory and carry no
        # events: every copy has completed when it returns
        self.device = device
        self.slots = [torch.empty(STAGING_SLOT_BYTES, dtype=torch.uint8,
                                  pin_memory=device.type == "cuda")
                      for _ in range(STAGING_SLOTS)]
        self.events = [None] * STAGING_SLOTS
        self.turn = 0

    def upload(self, parts, out: torch.Tensor) -> None:
        """Copy ``parts`` (see ``stage_parts``) end to end into the device
        tensor ``out``, through the slots."""
        item = out.element_size()
        cap = STAGING_SLOT_BYTES // item
        slot, fill, dst = None, 0, 0

        def flush():
            nonlocal slot, fill, dst
            out[dst:dst + fill].copy_(slot[:fill], non_blocking=True)
            if self.device.type == "cuda":
                # the copy runs on the destination device's current
                # stream, whichever device is current on this thread
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(out.device))
                self.events[self.turn] = ev
            self.turn = (self.turn + 1) % STAGING_SLOTS
            dst += fill
            slot, fill = None, 0

        for p in parts:
            n = p[0] if isinstance(p, tuple) else len(p)
            src = None if isinstance(p, tuple) else _host_view(p)
            pos = 0
            while pos < n:
                if slot is None:
                    ev = self.events[self.turn]
                    if ev is not None:
                        ev.synchronize()
                    slot = self.slots[self.turn].view(out.dtype)
                m = min(n - pos, cap - fill)
                if src is None:
                    slot[fill:fill + m].fill_(p[1])
                else:
                    slot[fill:fill + m].copy_(src[pos:pos + m])
                fill += m
                pos += m
                if fill == cap:
                    flush()
        if fill:
            flush()


_rings = threading.local()


def _staging_ring(device: torch.device) -> StagingRing:
    rings = getattr(_rings, "by_device", None)
    if rings is None:
        rings = _rings.by_device = {}
    if device not in rings:
        rings[device] = StagingRing(device)
    return rings[device]


def stage_parts(parts, np_dtype, device) -> torch.Tensor:
    """Host parts laid end to end as one tensor on ``device``.

    A part is a numpy array or ``(rows, value)`` for a run of one value.
    Each byte is copied once on the host (``Tensor.copy_``, which splits
    a large copy over the intra-op threads): to a CUDA device into the
    calling thread's pinned ``StagingRing``, whose slots go to the card
    with ``non_blocking=True`` copies on the current stream, so the host
    goes on (decoding the next file) while they run; on the CPU into the
    result itself.  The host time goes to the calling thread's upload
    watcher."""
    import time
    from spark_rapids_tpu_torch.utils import hostsync
    device = torch.device(device)
    t0 = time.perf_counter_ns()
    total = sum(p[0] if isinstance(p, tuple) else len(p) for p in parts)
    out = torch.empty(total, dtype=dts.torch_dtype_of_numpy(np_dtype),
                      device=device)
    if device.type == "cuda":
        if total:
            _staging_ring(out.device).upload(parts, out)
    else:
        off = 0
        for p in parts:
            if isinstance(p, tuple):
                n = p[0]
                out[off:off + n].fill_(p[1])
            else:
                n = len(p)
                if n:
                    out[off:off + n].copy_(_host_view(p))
            off += n
    hostsync.note_upload(time.perf_counter_ns() - t0)
    return out


def to_device(host: np.ndarray, device, copy: bool = False) -> torch.Tensor:
    """One host buffer as a tensor on ``device`` (``stage_parts``).  On
    the CPU the tensor shares ``host`` unless ``copy`` is set or ``host``
    is read-only."""
    host = np.ascontiguousarray(host)
    if torch.device(device).type == "cpu" and not copy and \
            host.flags.writeable:
        return torch.from_numpy(host)
    return stage_parts([host], host.dtype, device)


def bucket_capacity(n: int, minimum: int = MIN_CAPACITY) -> int:
    """Round up to the next power of two, floor ``minimum``."""
    n = max(int(n), 1)
    cap = minimum
    while cap < n:
        cap <<= 1
    return cap


class RowCount:
    """Lazy, possibly device-resident row count.

    Holds either a host int or a 0-dim device tensor.  ``int(rc)`` resolves
    a device count through ``hostsync.fetch`` (one counted sync) and caches
    it, so one RowCount never syncs twice; device paths use
    :meth:`device_tensor` and never sync."""

    __slots__ = ("_value", "_device")

    def __init__(self, value=None, device=None):
        if value is None and device is None:
            raise ValueError("RowCount needs a value or a device scalar")
        self._value = None if value is None else int(value)
        self._device = device

    @property
    def is_concrete(self) -> bool:
        return self._value is not None

    def __int__(self) -> int:
        if self._value is None:
            from spark_rapids_tpu_torch.utils import hostsync
            self._value = int(hostsync.fetch(self._device))
        return self._value

    __index__ = __int__

    def device_tensor(self, device) -> torch.Tensor:
        """The count as a 0-dim int64 tensor on ``device`` (no sync)."""
        if self._device is not None:
            return self._device.to(device=device, dtype=torch.int64)
        return torch.tensor(self._value, dtype=torch.int64, device=device)

    @staticmethod
    def wrap(n) -> "RowCount":
        if isinstance(n, RowCount):
            return n
        if isinstance(n, torch.Tensor):
            return RowCount(device=n)
        return RowCount(value=int(n))

    @staticmethod
    def materialize_all(counts) -> None:
        """Resolve every device-resident count in one counted sync."""
        from spark_rapids_tpu_torch.utils import hostsync
        lazy = [rc for rc in counts
                if isinstance(rc, RowCount) and rc._value is None]
        if not lazy:
            return
        values = hostsync.fetch_all([rc._device for rc in lazy])
        for rc, v in zip(lazy, values):
            rc._value = int(v)

    def __repr__(self) -> str:
        if self._value is not None:
            return f"RowCount({self._value})"
        return "RowCount(<device>)"


OFFSETS_LIMIT = 1 << 31   # int32 offsets: chars or elements per column


class Column:
    """One device column: ``data`` (capacity rows; for strings the uint8
    chars, for arrays the flat elements), optional ``validity``, for
    strings and arrays int32 ``offsets`` of capacity + 1 entries starting
    at 0, and a logical row count no larger than the capacity.  A
    string's chars (an array's elements) may run past ``offsets[nrows]``
    (padding every consumer ignores).  ``dictionary``: the host string
    table of an ``array<string>``'s codes."""

    __slots__ = ("dtype", "data", "validity", "offsets", "_row_count",
                 "dictionary")

    def __init__(self, dtype: DataType, data: torch.Tensor, nrows,
                 validity: Optional[torch.Tensor] = None,
                 offsets: Optional[torch.Tensor] = None, dictionary=None):
        if data.dim() != 1:
            raise ValueError("column data must be 1-D")
        if dtype.has_offsets != (offsets is not None):
            raise ValueError(f"{dtype} column: offsets must be given "
                             "exactly for string and array columns")
        rows = data.shape[0] if offsets is None else offsets.shape[0] - 1
        if validity is not None and validity.shape != (rows,):
            raise ValueError("validity must have one entry per row")
        self.dtype = dtype
        self.data = data
        self.validity = validity
        self.offsets = offsets
        self.dictionary = dictionary
        self._row_count = RowCount.wrap(nrows)

    @property
    def nrows(self) -> int:
        """Concrete row count (syncs once if carried on the device)."""
        return int(self._row_count)

    @property
    def row_count(self) -> RowCount:
        return self._row_count

    @property
    def capacity(self) -> int:
        if self.offsets is not None:
            return int(self.offsets.shape[0]) - 1
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    @classmethod
    def from_numpy(cls, values: np.ndarray, dtype: Optional[DataType] = None,
                   validity: Optional[np.ndarray] = None,
                   device="cpu") -> "Column":
        """Exact-length device column from host values, typed as the JAX
        package types them: datetime64 of any unit becomes a timestamp,
        ``datetime.date`` objects a date, str/object values a string
        (``None`` is null).  An all-True validity is dropped: no nulls."""
        values = np.asarray(values)
        if values.dtype.kind == "O":
            sample = next((v for v in values if v is not None), None)
            if isinstance(sample, _dt.datetime):
                validity = _none_validity(values, validity)
                values = np.array([sample if v is None else v
                                   for v in values], dtype="datetime64[us]")
            elif isinstance(sample, _dt.date):
                validity = _none_validity(values, validity)
                values = np.array([sample if v is None else v
                                   for v in values],
                                  dtype="datetime64[D]").astype(np.int32)
                dtype = dtype or dts.DATE32
        if values.dtype.kind in ("U", "S", "O"):
            return cls.from_strings(values.tolist(), validity=validity,
                                    device=device)
        if values.dtype.kind == "M":
            values = values.astype("datetime64[us]").astype(np.int64)
            dtype = dtype or dts.TIMESTAMP_US
        dtype = dtype or dts.from_numpy_dtype(values.dtype)
        data = to_device(values.astype(dtype.storage, copy=False), device)
        return cls(dtype, data, len(values),
                   validity=_device_validity(validity, len(values), device))

    @classmethod
    def from_strings(cls, values: Sequence[Optional[str]],
                     validity: Optional[np.ndarray] = None,
                     device="cpu") -> "Column":
        """String column in the JAX layout: UTF-8 chars plus int32
        offsets; a null row (``None`` or a False validity) has length 0."""
        nrows = len(values)
        valid = np.ones(nrows, dtype=np.bool_)
        if validity is not None:
            valid &= np.asarray(validity, dtype=np.bool_)
        encoded = []
        for i, s in enumerate(values):
            if s is None or not valid[i]:
                valid[i] = False
                encoded.append(b"")
            else:
                encoded.append(str(s).encode("utf-8"))
        offsets = np.zeros(nrows + 1, dtype=np.int64)
        np.cumsum([len(b) for b in encoded], out=offsets[1:])
        chars = np.frombuffer(b"".join(encoded), dtype=np.uint8)
        return cls.from_string_buffers(offsets, chars, valid, device)

    @classmethod
    def from_string_buffers(cls, offsets: np.ndarray, chars: np.ndarray,
                            validity: Optional[np.ndarray] = None,
                            device="cpu") -> "Column":
        """String column from host (offsets[n+1], chars) buffers."""
        offsets = np.asarray(offsets, dtype=np.int64)
        if offsets.ndim != 1 or offsets.shape[0] < 1 or offsets[0] != 0 \
                or (np.diff(offsets) < 0).any():
            raise ValueError("string offsets must start at 0 and never "
                             "decrease")
        check_offsets(int(offsets[-1]), "string column")
        chars = np.ascontiguousarray(chars, dtype=np.uint8)
        if chars.shape[0] < offsets[-1]:
            raise ValueError("chars buffer shorter than the last offset")
        nrows = offsets.shape[0] - 1
        return cls(dts.STRING, to_device(chars, device, copy=True),
                   nrows, validity=_device_validity(validity, nrows, device),
                   offsets=to_device(offsets.astype(np.int32), device))

    @classmethod
    def from_arrays(cls, values: Sequence, element: DataType,
                    validity: Optional[np.ndarray] = None,
                    device="cpu") -> "Column":
        """Array column from a list of lists (``None`` is a null row),
        through arrow's list layout: the flat elements plus int32
        offsets.  Null elements are refused, as in the JAX package;
        string elements make an ``array<string>`` of codes into a sorted
        host table."""
        import pyarrow as pa
        from spark_rapids_tpu_torch.columnar.batch import _column_from_arrow
        valid = np.ones(len(values), dtype=np.bool_) if validity is None \
            else np.asarray(validity, dtype=np.bool_)
        rows = [None if v is None or not ok else list(v)
                for v, ok in zip(values, valid)]
        arr = pa.array(rows, pa.list_(dts.to_arrow_type(element)))
        return _column_from_arrow(pa.chunked_array([arr]), device,
                                  "values")

    def to_pylist(self) -> list:
        """The column's rows as Python values (one counted fetch)."""
        from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
        return ColumnarBatch({"c": self}).to_arrow().column(0).to_pylist()

    @staticmethod
    def to_arrow(dtype: DataType, host_data: np.ndarray, host_validity,
                 n: int, host_offsets=None, dictionary=None):
        """pyarrow array of the first ``n`` rows of host buffers fetched
        by ``ColumnarBatch.to_arrow``, typed as the JAX package types it
        (dates as ``date32``, timestamps as UTC microseconds, decimals as
        ``decimal128``, arrays as lists)."""
        import pyarrow as pa
        at = dts.to_arrow_type(dtype)
        valid = None if host_validity is None else host_validity[:n]
        if dtype.is_array:
            offs = host_offsets[: n + 1].astype(np.int32)
            lo, hi = (int(offs[0]), int(offs[-1])) if n else (0, 0)
            elems = host_data[lo:hi]
            if dtype.element.is_string:
                table = dictionary if dictionary is not None else \
                    pa.array([], pa.string())
                values = table.take(pa.array(elems, pa.int32()))
            else:
                values = Column.to_arrow(dtype.element, elems, None,
                                         hi - lo)
            bitmap = None if valid is None or valid.all() else \
                pa.py_buffer(np.packbits(valid, bitorder="little"))
            return pa.Array.from_buffers(
                at, n, [bitmap, pa.py_buffer(offs - lo)],
                null_count=-1 if bitmap is not None else 0,
                children=[values])
        if dtype.is_string:
            offs = host_offsets[: n + 1].astype(np.int32)
            offs = offs - offs[0] if n else np.zeros(1, dtype=np.int32)
            chars = host_data[int(host_offsets[0]): int(host_offsets[n])] \
                if n else host_data[:0]
            bitmap = None if valid is None or valid.all() else \
                pa.py_buffer(np.packbits(valid, bitorder="little"))
            return pa.Array.from_buffers(
                at, n, [bitmap, pa.py_buffer(offs), pa.py_buffer(chars)],
                null_count=-1 if bitmap is not None else 0)
        vals = host_data[:n]
        if dtype.is_decimal:
            return decimal_array(vals, valid, dtype)
        if dtype.is_date:
            vals = vals.astype("datetime64[D]")
        elif dtype.is_timestamp:
            vals = vals.astype("datetime64[us]")
        mask = None if valid is None or valid.all() else ~valid
        return pa.array(vals, type=at, mask=mask)

    def __repr__(self) -> str:
        return (f"Column({self.dtype}, {self._row_count}, "
                f"cap={self.capacity}, {self.device})")


def check_offsets(total: int, what: str) -> None:
    """Refuse a column past the int32 offsets: ``total`` chars or
    elements in one batch, ``what`` naming the column."""
    if total >= OFFSETS_LIMIT:
        raise ValueError(
            f"{what}: {total} values in one batch do not fit int32 "
            f"offsets (the bound is {OFFSETS_LIMIT - 1})")


def _none_validity(values: np.ndarray, validity):
    present = np.array([v is not None for v in values], dtype=np.bool_)
    return present if validity is None else \
        present & np.asarray(validity, dtype=np.bool_)


def _device_validity(validity, nrows: int, device):
    """Device copy of a host validity, or None when every row is valid."""
    if validity is None:
        return None
    validity = np.asarray(validity, dtype=np.bool_)
    if validity.shape != (nrows,):
        raise ValueError("validity must match the values' shape")
    if validity.all():
        return None
    return to_device(validity, device)
