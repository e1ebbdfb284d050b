"""Logical data types of the port's columns.

Counterpart of ``spark_rapids_tpu/columnar/dtypes.py``, cut to the numeric
types this slice carries (boolean, the four integer widths, float and
double).  Strings, dates, decimals and nested types come with later slices.
Each type names its numpy storage dtype, as in the JAX package, and
:func:`torch_dtype` gives the matching torch dtype.
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

_BY_NAME = {t.name: t for t in
            (BOOL, INT8, INT16, INT32, INT64, FLOAT32, FLOAT64)}

_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def dtype_from_name(name: str) -> DataType:
    name = name.strip().lower()
    if name in _BY_NAME:
        return _BY_NAME[name]
    aliases = {"long": INT64, "integer": INT32, "short": INT16, "byte": INT8,
               "bool": BOOL, "float64": FLOAT64, "float32": FLOAT32,
               "int64": INT64, "int32": INT32, "int16": INT16, "int8": INT8}
    if name in aliases:
        return aliases[name]
    raise ValueError(f"unknown or unsupported data type name: {name}")


def from_numpy_dtype(dt) -> DataType:
    dt = np.dtype(dt)
    for t in _BY_NAME.values():
        if t.storage == dt:
            return t
    raise ValueError(f"unsupported numpy dtype {dt}")


def torch_dtype(dt: DataType) -> torch.dtype:
    """The torch dtype of ``dt``'s device buffer."""
    return _TORCH[np.dtype(dt.storage)]
