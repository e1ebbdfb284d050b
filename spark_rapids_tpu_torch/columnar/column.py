"""Device column and lazy row count.

Counterpart of ``spark_rapids_tpu/columnar/column.py``.  A Column is a torch
tensor of values plus an optional bool validity tensor (True = valid, None =
no nulls) on one device, with a logical row count.  XLA needed every buffer
padded to a power-of-two capacity; PyTorch does not, so columns built from
host data are exact-length.  Operators that produce a data-dependent number
of rows (a group-by's groups) may still return buffers longer than the row
count, with the count carried lazily on the device: rows past it are
padding that every consumer masks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.columnar.dtypes import DataType

MIN_CAPACITY = 1024


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


class Column:
    """One device column: ``data`` (capacity rows), optional ``validity``
    and a logical row count no larger than the capacity."""

    __slots__ = ("dtype", "data", "validity", "_row_count")

    def __init__(self, dtype: DataType, data: torch.Tensor, nrows,
                 validity: Optional[torch.Tensor] = None):
        if data.dim() != 1:
            raise ValueError("column data must be 1-D")
        if validity is not None and validity.shape != data.shape:
            raise ValueError("validity must match the data's shape")
        self.dtype = dtype
        self.data = data
        self.validity = validity
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
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    @classmethod
    def from_numpy(cls, values: np.ndarray, dtype: Optional[DataType] = None,
                   validity: Optional[np.ndarray] = None,
                   device="cpu") -> "Column":
        """Exact-length device column from host values (numeric only).
        An all-True validity is dropped: no nulls."""
        values = np.asarray(values)
        if values.dtype.kind in ("U", "S", "O", "M"):
            raise TypeError(f"column of numpy dtype {values.dtype}: only "
                            "numeric and boolean columns are ported")
        dtype = dtype or dts.from_numpy_dtype(values.dtype)
        host = np.ascontiguousarray(values.astype(dtype.storage, copy=False))
        if not host.flags.writeable:  # torch tensors need writable memory
            host = host.copy()
        data = torch.from_numpy(host).to(device)
        dev_validity = None
        if validity is not None:
            validity = np.asarray(validity, dtype=np.bool_)
            if validity.shape != values.shape:
                raise ValueError("validity must match the values' shape")
            if not validity.all():
                dev_validity = torch.from_numpy(
                    np.ascontiguousarray(validity)).to(device)
        return cls(dtype, data, len(values), validity=dev_validity)

    @staticmethod
    def to_arrow(host_data: np.ndarray, host_validity, n: int):
        """pyarrow array of the first ``n`` rows of host buffers fetched
        by ``ColumnarBatch.to_arrow``."""
        import pyarrow as pa
        mask = None if host_validity is None else ~host_validity[:n]
        return pa.array(host_data[:n], mask=mask)

    def __repr__(self) -> str:
        return (f"Column({self.dtype}, {self._row_count}, "
                f"cap={self.capacity}, {self.device})")
