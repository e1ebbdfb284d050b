"""JSON and array-producing string expressions (the CPU fallback's).

Counterpart of ``spark_rapids_tpu/ops/json_ops.py``.  ``GetJsonObject``
(the reference's GpuGetJsonObject rule) and ``StringSplit`` (split to an
array of strings; the indexed form ``split(s, d).getItem(n)`` is the
device's ``regexops.SplitPart``) have no device representation, as in
the JAX package: a JSONPath needs a byte-level parser and an
``array<string>`` two levels of offsets.  Both have a planner rule that
tags them host-only, so a node holding one runs in ``CpuFallbackExec``,
which evaluates them with :meth:`eval_host`.
"""

from __future__ import annotations

import json
import re
from typing import List, Optional

import numpy as np

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops.expressions import Expression

# array<string> lives only on the host side: a fallback frame holds lists,
# and a device batch between two fallback nodes holds int32 codes into a
# host string table (``Column.dictionary``).  The type is built directly,
# not through ArrayType, which refuses variable-width elements.
ARRAY_STRING = DataType("array<string>", np.dtype(np.int32),
                        element=dts.STRING)

_PATH_RE = re.compile(r"\.([A-Za-z_][A-Za-z0-9_]*)|\[(\d+)\]|\['([^']*)'\]")


def parse_json_path(path: str) -> Optional[List[object]]:
    """'$.a.b[0]' -> ['a', 'b', 0]; None outside the supported subset."""
    if not path.startswith("$"):
        return None
    out: List[object] = []
    i = 1
    while i < len(path):
        m = _PATH_RE.match(path, i)
        if m is None:
            return None
        if m.group(1) is not None:
            out.append(m.group(1))
        elif m.group(2) is not None:
            out.append(int(m.group(2)))
        else:
            out.append(m.group(3))
        i = m.end()
    return out


def eval_json_path(doc: str, steps: List[object]) -> Optional[str]:
    """Spark's get_json_object: a string comes back raw, any other value
    as compact JSON text, a missing path or bad JSON as null."""
    try:
        v = json.loads(doc)
    except (ValueError, TypeError):
        return None
    for s in steps:
        if isinstance(s, int):
            if not isinstance(v, list) or not 0 <= s < len(v):
                return None
        elif not isinstance(v, dict) or s not in v:
            return None
        v = v[s]
    if v is None:
        return None
    if isinstance(v, str):
        return v
    return json.dumps(v, separators=(",", ":"))


class GetJsonObject(Expression):
    """get_json_object(json_str, '$.path') -> string."""

    def __init__(self, child: Expression, path: str):
        self.children = (child,)
        self.path = path
        self.steps = parse_json_path(path)

    def with_children(self, children):
        return GetJsonObject(children[0], self.path)

    @property
    def dtype(self) -> DataType:
        return dts.STRING

    @property
    def nullable(self) -> bool:
        return True

    @property
    def name(self) -> str:
        return f"get_json_object({self.children[0].name}, {self.path})"

    def cache_key(self):
        return ("GetJsonObject", self.children[0].cache_key(), self.path)

    def eval_host(self, value: Optional[str]) -> Optional[str]:
        if value is None or self.steps is None:
            return None
        return eval_json_path(value, self.steps)


class StringSplit(Expression):
    """split(str, regex[, limit]) -> array<string> (Spark's split)."""

    def __init__(self, child: Expression, pattern: str, limit: int = -1):
        self.children = (child,)
        self.pattern = pattern
        self.limit = int(limit)

    def with_children(self, children):
        return StringSplit(children[0], self.pattern, self.limit)

    @property
    def dtype(self) -> DataType:
        return ARRAY_STRING

    @property
    def nullable(self) -> bool:
        return True

    @property
    def name(self) -> str:
        return f"split({self.children[0].name}, {self.pattern!r})"

    def cache_key(self):
        return ("StringSplit", self.children[0].cache_key(), self.pattern,
                self.limit)

    def eval_host(self, value: Optional[str]) -> Optional[List[str]]:
        if value is None:
            return None
        # Spark: a regex; a limit above 0 caps the parts, else trailing
        # empty parts stay
        if self.limit > 0:
            return re.split(self.pattern, value, self.limit - 1)
        return re.split(self.pattern, value)
