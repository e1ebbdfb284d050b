"""Logical data types of the port's columns.

Counterpart of ``spark_rapids_tpu/columnar/dtypes.py``, cut to the types
the ported slices carry: boolean, the four integer widths, float and
double, string (uint8 chars plus int32 row offsets), date (int32 days
since the epoch) and timestamp (int64 microseconds since the epoch, UTC).
Decimals and nested types come with later slices.  Each type names its
numpy storage dtype, as in the JAX package, and :func:`torch_dtype` gives
the matching torch dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataType:
    """A logical column type: Spark's ``name`` and the numpy ``storage``
    dtype of its device buffer."""

    name: str
    storage: Any

    @property
    def is_boolean(self) -> bool:
        return self.name == "boolean"

    @property
    def is_integral(self) -> bool:
        return self.name in ("tinyint", "smallint", "int", "bigint")

    @property
    def is_floating(self) -> bool:
        return self.name in ("float", "double")

    @property
    def is_string(self) -> bool:
        return self.name == "string"

    @property
    def has_offsets(self) -> bool:
        """True when the device layout is (flat chars, int32 offsets)."""
        return self.is_string

    @property
    def is_date(self) -> bool:
        return self.name == "date"

    @property
    def is_timestamp(self) -> bool:
        return self.name == "timestamp"

    @property
    def is_datetime(self) -> bool:
        return self.is_date or self.is_timestamp

    def __repr__(self) -> str:
        return self.name

    def __str__(self) -> str:
        return self.name


BOOL = DataType("boolean", np.dtype(np.bool_))
INT8 = DataType("tinyint", np.dtype(np.int8))
INT16 = DataType("smallint", np.dtype(np.int16))
INT32 = DataType("int", np.dtype(np.int32))
INT64 = DataType("bigint", np.dtype(np.int64))
FLOAT32 = DataType("float", np.dtype(np.float32))
FLOAT64 = DataType("double", np.dtype(np.float64))
# chars buffer storage; offsets are always int32
STRING = DataType("string", np.dtype(np.uint8))
DATE32 = DataType("date", np.dtype(np.int32))  # days since unix epoch
TIMESTAMP_US = DataType("timestamp", np.dtype(np.int64))  # micros, UTC

_BY_NAME = {t.name: t for t in
            (BOOL, INT8, INT16, INT32, INT64, FLOAT32, FLOAT64, STRING,
             DATE32, TIMESTAMP_US)}

_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.uint8): torch.uint8,
}


def dtype_from_name(name: str) -> DataType:
    name = name.strip().lower()
    if name in _BY_NAME:
        return _BY_NAME[name]
    aliases = {"long": INT64, "integer": INT32, "short": INT16, "byte": INT8,
               "bool": BOOL, "str": STRING, "float64": FLOAT64,
               "float32": FLOAT32,
               "int64": INT64, "int32": INT32, "int16": INT16, "int8": INT8}
    if name in aliases:
        return aliases[name]
    raise ValueError(f"unknown or unsupported data type name: {name}")


_NUMERIC = (BOOL, INT8, INT16, INT32, INT64, FLOAT32, FLOAT64)


def from_numpy_dtype(dt) -> DataType:
    """The JAX package's mapping: datetime64 of any unit is a timestamp,
    str/bytes/object arrays are strings."""
    dt = np.dtype(dt)
    for t in _NUMERIC:
        if t.storage == dt:
            return t
    if dt.kind == "M":
        return TIMESTAMP_US
    if dt.kind in ("U", "S", "O"):
        return STRING
    raise ValueError(f"unsupported numpy dtype {dt}")


def from_arrow_type(at) -> DataType:
    import pyarrow as pa
    for check, dt in ((pa.types.is_boolean, BOOL),
                      (pa.types.is_int8, INT8),
                      (pa.types.is_int16, INT16),
                      (pa.types.is_int32, INT32),
                      (pa.types.is_int64, INT64),
                      (pa.types.is_float32, FLOAT32),
                      (pa.types.is_float64, FLOAT64),
                      (pa.types.is_string, STRING),
                      (pa.types.is_large_string, STRING),
                      (pa.types.is_date32, DATE32),
                      (pa.types.is_timestamp, TIMESTAMP_US)):
        if check(at):
            return dt
    if pa.types.is_dictionary(at):
        return from_arrow_type(at.value_type)
    raise TypeError(f"arrow type {at} is not ported")


def to_arrow_type(dt: DataType):
    import pyarrow as pa
    return {"boolean": pa.bool_(), "tinyint": pa.int8(),
            "smallint": pa.int16(), "int": pa.int32(),
            "bigint": pa.int64(), "float": pa.float32(),
            "double": pa.float64(), "string": pa.string(),
            "date": pa.date32(),
            "timestamp": pa.timestamp("us", tz="UTC")}[dt.name]


def torch_dtype(dt: DataType) -> torch.dtype:
    """The torch dtype of ``dt``'s device buffer."""
    return _TORCH[np.dtype(dt.storage)]


def torch_dtype_of_numpy(dt) -> torch.dtype:
    """The torch dtype of a numpy buffer dtype."""
    return _TORCH[np.dtype(dt)]
