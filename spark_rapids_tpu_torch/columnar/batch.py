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
from spark_rapids_tpu_torch.columnar.column import Column, RowCount
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
        """Columns from a pyarrow Table; arrow nulls become validity."""
        import pyarrow as pa
        import pyarrow.compute as pc
        cols = {}
        for name in table.column_names:
            arr = table.column(name).combine_chunks()
            if pa.types.is_dictionary(arr.type):
                arr = arr.dictionary_decode()
            dt = dts.from_arrow_type(arr.type)
            if dt.is_string:
                cols[name] = Column.from_strings(arr.to_pylist(),
                                                 device=device)
                continue
            validity = None
            if arr.null_count:
                validity = np.asarray(pc.is_valid(arr))
            if dt.is_date:
                values = np.asarray(arr.cast(pa.int32()).fill_null(0))
            elif dt.is_timestamp:
                values = np.asarray(arr.cast(pa.timestamp("us"))
                                    .cast(pa.int64()).fill_null(0))
            else:
                if arr.null_count:
                    arr = pc.fill_null(arr, pa.scalar(
                        False if dt.is_boolean else 0, arr.type))
                values = arr.to_numpy(zero_copy_only=False)
            cols[name] = Column.from_numpy(values, dtype=dt,
                                           validity=validity, device=device)
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
