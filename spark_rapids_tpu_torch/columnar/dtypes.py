"""Logical data types of the port's columns.

Counterpart of ``spark_rapids_tpu/columnar/dtypes.py``, cut to the types
the ported slices carry: boolean, the four integer widths, float and
double, string (uint8 chars plus int32 row offsets), date (int32 days
since the epoch), timestamp (int64 microseconds since the epoch, UTC) and
DECIMAL_64 (``decimal(p,s)`` with p <= 18, the unscaled value in an
int64), and the nested types in the JAX package's layout: an ARRAY of a
fixed-width element is its flat element buffer plus int32 row offsets (the
string chars layout), and a STRUCT or a MAP is a logical type over flat
columns (``columnar/nested.py`` shreds them at ingest and reassembles them
at the arrow output).  Each type names its numpy storage dtype, as in the
JAX package, and :func:`torch_dtype` gives the matching torch dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataType:
    """A logical column type: Spark's ``name`` and the numpy ``storage``
    dtype of its device buffer."""

    name: str
    storage: Any
    # decimal only
    precision: Optional[int] = None
    scale: Optional[int] = None
    # array only: the element type (``storage`` is then the element's
    # storage dtype: flat element values plus int32 row offsets)
    element: Optional["DataType"] = None
    # struct only: ((field name, DataType), ...); a map has exactly the
    # two pseudo-fields ("key", K) and ("value", V).  Neither lives on the
    # device as a container: struct field "a" of column "s" is the flat
    # column "s.a", a map "m" the two aligned array columns "m.__key" and
    # "m.__value" (``columnar/nested.py``)
    fields: Optional[tuple] = None

    @property
    def is_array(self) -> bool:
        return self.element is not None

    @property
    def is_struct(self) -> bool:
        return self.fields is not None and not self.name.startswith("map<")

    @property
    def is_map(self) -> bool:
        return self.fields is not None and self.name.startswith("map<")

    @property
    def is_nested(self) -> bool:
        return self.fields is not None

    @property
    def key_type(self) -> "DataType":
        assert self.is_map
        return self.fields[0][1]

    @property
    def value_type(self) -> "DataType":
        assert self.is_map
        return self.fields[1][1]

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
    def is_decimal(self) -> bool:
        return self.name.startswith("decimal")

    @property
    def is_numeric(self) -> bool:
        return self.is_integral or self.is_floating or self.is_decimal

    @property
    def is_string(self) -> bool:
        return self.name == "string"

    @property
    def has_offsets(self) -> bool:
        """True when the device layout is (flat values, int32 offsets):
        strings (chars) and arrays (elements)."""
        return self.is_string or self.is_array

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


def ArrayType(element: DataType) -> DataType:
    """ARRAY<element> of a fixed-width element: the flat element buffer
    plus int32 row offsets, as a string's chars, so gather, concatenation
    and spill take arrays through the strings' offsets path."""
    if element.has_offsets or element.is_nested:
        raise ValueError(
            f"nested element type {element} not supported (single-level "
            "arrays of fixed-width elements only)")
    return DataType(f"array<{element.name}>", element.storage,
                    element=element)


def StructType(fields) -> DataType:
    """STRUCT<f1: t1, ...>: a logical grouping of shredded flat columns."""
    fields = tuple((str(n), t) for n, t in fields)
    if not fields:
        raise ValueError("struct needs at least one field")
    inner = ",".join(f"{n}:{t.name}" for n, t in fields)
    return DataType(f"struct<{inner}>", np.dtype(np.uint8), fields=fields)


def MapType(key: DataType, value: DataType) -> DataType:
    """MAP<K, V> of fixed-width scalars, shredded to the two array columns
    ``<name>.__key`` (ARRAY<K>) and ``<name>.__value`` (ARRAY<V>) with the
    same row offsets."""
    if key.has_offsets or value.has_offsets or key.is_nested \
            or value.is_nested:
        raise ValueError(
            f"map<{key},{value}> unsupported: key/value must be "
            "fixed-width scalar types")
    return DataType(f"map<{key.name},{value.name}>", np.dtype(np.uint8),
                    fields=(("key", key), ("value", value)))


def DecimalType(precision: int, scale: int) -> DataType:
    """DECIMAL_64 only, as in the JAX package (precision <= 18)."""
    if precision > 18:
        raise ValueError(
            f"decimal precision {precision} > 18 unsupported (DECIMAL_64 only, "
            "matching reference TypeSig.DECIMAL_64)")
    if scale < 0 or scale > precision:
        raise ValueError(f"bad decimal scale {scale} for precision {precision}")
    return DataType(f"decimal({precision},{scale})", np.dtype(np.int64),
                    precision=precision, scale=scale)


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
    if name.startswith("array<") and name.endswith(">"):
        return ArrayType(dtype_from_name(name[6:-1]))
    if name.startswith("decimal"):
        inner = name[name.index("(") + 1:name.index(")")]
        p, s = (int(x) for x in inner.split(","))
        return DecimalType(p, s)
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
    if pa.types.is_struct(at):
        return StructType((f.name, from_arrow_type(f.type)) for f in at)
    if pa.types.is_map(at):
        return MapType(from_arrow_type(at.key_type),
                       from_arrow_type(at.item_type))
    if pa.types.is_list(at) or pa.types.is_large_list(at):
        return ArrayType(from_arrow_type(at.value_type))
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
    if pa.types.is_decimal(at):
        return DecimalType(at.precision, at.scale)
    raise TypeError(f"arrow type {at} is not ported")


def to_arrow_type(dt: DataType):
    import pyarrow as pa
    if dt.is_decimal:
        return pa.decimal128(dt.precision, dt.scale)
    if dt.is_array:
        return pa.list_(to_arrow_type(dt.element))
    if dt.is_map:
        return pa.map_(to_arrow_type(dt.key_type),
                       to_arrow_type(dt.value_type))
    if dt.is_struct:
        return pa.struct([pa.field(n, to_arrow_type(t))
                          for n, t in dt.fields])
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
