"""ColumnarBatch: a set of columns of one row count on one device.

Counterpart of ``spark_rapids_tpu/columnar/batch.py``.  Batches flow
device-resident between operators; crossing back to the host happens only
at collect (``to_arrow``), in one counted fetch.
"""

from __future__ import annotations

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
        """Columns from a dict of numpy arrays (no nulls; nulls come in
        through ``from_pandas`` or ``interop.batch_from_arrays``)."""
        nrows = len(next(iter(data.values()))) if data else 0
        cols = {}
        for name, values in data.items():
            cols[name] = Column.from_numpy(np.asarray(values), device=device)
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
            dt = _from_arrow_type(arr.type)
            validity = None
            if arr.null_count:
                validity = np.asarray(pc.is_valid(arr))
                arr = pc.fill_null(arr, pa.scalar(False if dt.is_boolean
                                                  else 0, arr.type))
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
            bufs.append(c.data[:n])
            if c.validity is not None:
                bufs.append(c.validity[:n])
        host = iter(hostsync.fetch_all(bufs))
        arrays = {}
        for name, c in self.columns.items():
            data = next(host)
            validity = next(host) if c.validity is not None else None
            arrays[name] = Column.to_arrow(data, validity, n)
        return pa.table(arrays)

    def to_pandas(self):
        return self.to_arrow().to_pandas()


def _from_arrow_type(at) -> DataType:
    import pyarrow as pa
    for check, dt in ((pa.types.is_boolean, dts.BOOL),
                      (pa.types.is_int8, dts.INT8),
                      (pa.types.is_int16, dts.INT16),
                      (pa.types.is_int32, dts.INT32),
                      (pa.types.is_int64, dts.INT64),
                      (pa.types.is_float32, dts.FLOAT32),
                      (pa.types.is_float64, dts.FLOAT64)):
        if check(at):
            return dt
    raise TypeError(f"arrow type {at}: only numeric and boolean columns "
                    "are ported")


def empty_batch(schema: Schema, device="cpu") -> ColumnarBatch:
    cols = {name: Column(dt, torch.empty(0, dtype=dts.torch_dtype(dt),
                                         device=device), 0)
            for name, dt in schema}
    return ColumnarBatch(cols, 0)
