"""ColumnarBatch: a set of columns of one row count on one device.

Counterpart of ``spark_rapids_tpu/columnar/batch.py``.  Batches flow
device-resident between operators; crossing back to the host happens only
at collect (``to_arrow``), in one counted fetch.
"""

from __future__ import annotations

import datetime as _dt
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.columnar.column import (
    Column, RowCount, stage_parts)
from spark_rapids_tpu_torch.columnar.dtypes import DataType

Schema = Sequence[Tuple[str, DataType]]


class ColumnarBatch:
    __slots__ = ("columns", "_row_count")

    def __init__(self, columns: Dict[str, Column], nrows=None):
        self.columns: Dict[str, Column] = dict(columns)
        if nrows is None:
            if not columns:
                raise ValueError("empty batch needs explicit nrows")
            nrows = next(iter(columns.values())).row_count
        self._row_count = RowCount.wrap(nrows)
        if self._row_count.is_concrete:
            n = int(self._row_count)
            for name, col in self.columns.items():
                if col.row_count.is_concrete and col.nrows != n:
                    raise ValueError(
                        f"column {name} nrows {col.nrows} != batch {n}")

    @property
    def nrows(self) -> int:
        """Concrete row count (syncs once if carried on the device)."""
        return int(self._row_count)

    @property
    def row_count(self) -> RowCount:
        return self._row_count

    @property
    def names(self) -> List[str]:
        return list(self.columns)

    @property
    def schema(self) -> List[Tuple[str, DataType]]:
        return [(n, c.dtype) for n, c in self.columns.items()]

    @property
    def capacity(self) -> int:
        return next(iter(self.columns.values())).capacity

    @property
    def device(self) -> torch.device:
        return next(iter(self.columns.values())).device

    def device_size_bytes(self) -> int:
        """Bytes of the batch's device buffers (capacity, not rows)."""
        return sum(c.data.nbytes
                   + (0 if c.offsets is None else c.offsets.nbytes)
                   + (0 if c.validity is None else c.validity.nbytes)
                   for c in self.columns.values())

    def column(self, name: str) -> Column:
        return self.columns[name]

    def __len__(self) -> int:
        return self.nrows

    def __repr__(self) -> str:
        cols = ", ".join(f"{n}:{c.dtype}" for n, c in self.columns.items())
        return f"ColumnarBatch[{self._row_count}]({cols})"

    # ------------------------------------------------------------ host interop
    @classmethod
    def from_pydict(cls, data: Dict[str, Sequence],
                    device="cpu") -> "ColumnarBatch":
        """Columns from a dict of numpy arrays or lists.  As in the JAX
        package, a list holding ``None`` makes a nullable column (``None``
        is null), a list of str a string column, ``datetime.date`` values
        a date column and a datetime64 array a timestamp column."""
        nrows = len(next(iter(data.values()))) if data else 0
        cols = {}
        for name, values in data.items():
            if isinstance(values, (list, tuple)):
                cols[name] = _column_from_list(list(values), device)
            else:
                cols[name] = Column.from_numpy(np.asarray(values),
                                               device=device)
            if cols[name].nrows != nrows:
                raise ValueError(f"column {name!r} has {cols[name].nrows} "
                                 f"rows, expected {nrows}")
        return cls(cols, nrows)

    @classmethod
    def from_arrow(cls, table, device="cpu") -> "ColumnarBatch":
        """Columns from a pyarrow Table; arrow nulls become validity.
        Each column's chunks go end to end into one staging buffer per
        device buffer (``column.stage_parts``), without concatenating
        them first."""
        cols = {name: _column_from_arrow(table.column(name), device)
                for name in table.column_names}
        return cls(cols, table.num_rows)

    @classmethod
    def from_pandas(cls, df, device="cpu") -> "ColumnarBatch":
        """Columns from a pandas DataFrame, through pyarrow as the JAX
        package does, so float NaN in pandas becomes a null here too."""
        import pyarrow as pa
        return cls.from_arrow(pa.Table.from_pandas(df, preserve_index=False),
                              device=device)

    def to_arrow(self):
        """pyarrow Table of the batch's rows, fetched in one counted sync."""
        import pyarrow as pa
        from spark_rapids_tpu_torch.utils import hostsync
        n = self.nrows
        bufs = []
        for c in self.columns.values():
            if c.offsets is not None:
                bufs.extend([c.data, c.offsets[: n + 1]])
            else:
                bufs.append(c.data[:n])
            if c.validity is not None:
                bufs.append(c.validity[:n])
        host = iter(hostsync.fetch_all(bufs))
        arrays = {}
        for name, c in self.columns.items():
            data = next(host)
            offsets = next(host) if c.offsets is not None else None
            validity = next(host) if c.validity is not None else None
            arrays[name] = Column.to_arrow(c.dtype, data, validity, n,
                                           offsets)
        return pa.table(arrays)

    def to_pandas(self):
        return self.to_arrow().to_pandas()


def _column_from_arrow(chunked, device) -> Column:
    """One arrow column (a ChunkedArray) as a device column."""
    import pyarrow as pa
    import pyarrow.compute as pc
    chunks, at = list(chunked.chunks), chunked.type
    if pa.types.is_dictionary(at):
        chunks = [c.dictionary_decode() for c in chunks]
        at = at.value_type
    dt = dts.from_arrow_type(at)
    n = sum(len(c) for c in chunks)
    validity = None
    if any(c.null_count for c in chunks):
        validity = stage_parts(
            [np.asarray(pc.is_valid(c)) if c.null_count else (len(c), True)
             for c in chunks], np.bool_, device)
    if dt.is_string:
        data, offsets = _string_buffers(chunks, n, device)
        return Column(dt, data, n, validity=validity, offsets=offsets)
    return Column(dt, stage_parts([_fixed_width(c, dt) for c in chunks],
                                  dt.storage, device), n, validity=validity)


def _fixed_width(arr, dt) -> np.ndarray:
    """An arrow chunk's values as numpy storage values (a view where arrow
    allows); null slots hold zero."""
    import pyarrow as pa
    import pyarrow.compute as pc
    if dt.is_date:
        arr = arr.cast(pa.int32())
    elif dt.is_timestamp:
        arr = arr.cast(pa.timestamp("us")).cast(pa.int64())
    if arr.null_count:
        arr = pc.fill_null(arr, pa.scalar(False if dt.is_boolean else 0,
                                          arr.type))
    return arr.to_numpy(zero_copy_only=False)


def _string_buffers(chunks, n: int, device):
    """(chars, int32 offsets) on ``device`` of arrow string chunks, from
    their own buffers (no Python string per row).  A null row becomes an
    empty string, as ``Column.from_strings`` makes it."""
    import pyarrow as pa
    import pyarrow.compute as pc
    char_parts, offset_parts, base = [], [], 0
    for c in chunks:
        if c.null_count:
            c = pc.fill_null(c, "")
        k = len(c)
        if not k:
            continue
        bufs = c.buffers()
        width = np.int64 if pa.types.is_large_string(c.type) else np.int32
        co = np.frombuffer(bufs[1], dtype=width)[c.offset: c.offset + k + 1]
        if bufs[2] is not None:
            char_parts.append(np.frombuffer(bufs[2], dtype=np.uint8)[
                int(co[0]): int(co[-1])])
        # rebased to this chunk's place in the column (a view when the
        # chunk starts at its own offset 0 and at the column's start)
        offset_parts.append(co[:-1] if base == int(co[0]) and
                            width == np.int32 else
                            (co[:-1] - co[0] + base).astype(np.int32))
        base += int(co[-1] - co[0])
        if base >= (1 << 31):
            raise ValueError("string offsets are int32: a column holds "
                             "less than 2 GiB of chars")
    offsets = stage_parts(offset_parts + [(1, base)], np.int32, device)
    return stage_parts(char_parts, np.uint8, device), offsets


def _column_from_list(values: list, device) -> Column:
    """The JAX package's ``from_pydict`` rule for a Python list."""
    if any(isinstance(v, str) for v in values):
        return Column.from_strings(values, device=device)
    present = [v for v in values if v is not None]
    if present and all(isinstance(v, _dt.date) for v in present):
        return Column.from_numpy(np.array(values, dtype=object),
                                 device=device)
    validity = np.array([v is not None for v in values], dtype=np.bool_)
    filled = [0 if v is None else v for v in values]
    if present and all(isinstance(v, bool) for v in present):
        filled = np.array([bool(v) for v in filled], dtype=np.bool_)
    return Column.from_numpy(np.asarray(filled), validity=validity,
                             device=device)


def empty_batch(schema: Schema, device="cpu",
                capacity: int = 0) -> ColumnarBatch:
    """A batch of no rows whose columns hold ``capacity`` padding rows
    (zero values, and for strings zero-length rows)."""
    cols = {}
    for name, dt in schema:
        if dt.is_string:
            cols[name] = Column(
                dt, torch.zeros(0, dtype=torch.uint8, device=device), 0,
                offsets=torch.zeros(capacity + 1, dtype=torch.int32,
                                    device=device))
        else:
            cols[name] = Column(dt, torch.zeros(
                capacity, dtype=dts.torch_dtype(dt), device=device), 0)
    return ColumnarBatch(cols, 0)
