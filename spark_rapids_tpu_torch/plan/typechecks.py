"""Type support signatures.

Counterpart of ``spark_rapids_tpu/plan/typechecks.py`` (the reference's
``TypeChecks.scala`` TypeSig algebra): each expression rule of the planner
(``plan/overrides.py``) declares which result types it runs on the device;
an expression outside them is tagged "will not run on the device" with a
reason and its plan node falls back to the CPU.  The port has no decimal
or array types yet, so a signature is a set of type names; those flags
come with the types.
"""

from __future__ import annotations

from typing import Iterable, Optional, Set

from spark_rapids_tpu_torch.columnar.dtypes import DataType


class TypeSig:
    """A set of supported logical type names."""

    def __init__(self, names: Iterable[str]):
        self.names: Set[str] = set(names)

    def __add__(self, other: "TypeSig") -> "TypeSig":
        return TypeSig(self.names | other.names)

    def supports(self, dt: DataType) -> bool:
        return dt.name in self.names

    def reason_if_unsupported(self, dt: DataType,
                              what: str) -> Optional[str]:
        if self.supports(dt):
            return None
        return f"{what} has unsupported type {dt}"

    def __repr__(self):
        return "TypeSig(" + ", ".join(sorted(self.names)) + ")"


BOOLEAN = TypeSig(["boolean"])
INTEGRAL = TypeSig(["tinyint", "smallint", "int", "bigint"])
FP = TypeSig(["float", "double"])
NUMERIC = INTEGRAL + FP
STRING = TypeSig(["string"])
DATETIME = TypeSig(["date", "timestamp"])
# the common cudf-equivalent set (TypeChecks.scala:557 commonCudfTypes)
COMMON = BOOLEAN + NUMERIC + STRING + DATETIME
ORDERABLE = COMMON
ALL = COMMON
