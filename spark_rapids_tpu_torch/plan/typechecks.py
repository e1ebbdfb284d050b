"""Type support signatures.

Counterpart of ``spark_rapids_tpu/plan/typechecks.py`` (the reference's
``TypeChecks.scala`` TypeSig algebra): each expression rule of the planner
(``plan/overrides.py``) declares which result types it runs on the device;
an expression outside them is tagged "will not run on the device" with a
reason and its plan node falls back to the CPU.  A signature is a set of
type names plus a flag for DECIMAL_64 (every ``decimal(p<=18, s)``) and
one for single-level arrays of fixed-width elements.
"""

from __future__ import annotations

from typing import Iterable, Optional, Set

from spark_rapids_tpu_torch.columnar.dtypes import DataType


class TypeSig:
    """A set of supported logical type names (+ the decimal and array
    flags)."""

    def __init__(self, names: Iterable[str], decimal: bool = False,
                 arrays: bool = False):
        self.names: Set[str] = set(names)
        self.decimal = decimal
        self.arrays = arrays

    def __add__(self, other: "TypeSig") -> "TypeSig":
        return TypeSig(self.names | other.names,
                       self.decimal or other.decimal,
                       self.arrays or other.arrays)

    def supports(self, dt: DataType) -> bool:
        if dt.is_decimal:
            return self.decimal
        if dt.is_array:
            return self.arrays and not dt.element.has_offsets
        return dt.name in self.names

    def reason_if_unsupported(self, dt: DataType,
                              what: str) -> Optional[str]:
        if self.supports(dt):
            return None
        return f"{what} has unsupported type {dt}"

    def __repr__(self):
        names = sorted(self.names) + (["decimal"] if self.decimal else []) \
            + (["array"] if self.arrays else [])
        return "TypeSig(" + ", ".join(names) + ")"


BOOLEAN = TypeSig(["boolean"])
INTEGRAL = TypeSig(["tinyint", "smallint", "int", "bigint"])
FP = TypeSig(["float", "double"])
DECIMAL_64 = TypeSig([], decimal=True)
NUMERIC = INTEGRAL + FP + DECIMAL_64
STRING = TypeSig(["string"])
DATETIME = TypeSig(["date", "timestamp"])
# the common cudf-equivalent set (TypeChecks.scala:557 commonCudfTypes)
COMMON = BOOLEAN + NUMERIC + STRING + DATETIME
ORDERABLE = COMMON
# single-level arrays of fixed-width elements (TypeSig.ARRAY)
ARRAY = TypeSig([], arrays=True)
ALL = COMMON + ARRAY
