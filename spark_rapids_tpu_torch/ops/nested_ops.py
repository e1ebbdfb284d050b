"""Struct and map expressions over shredded nested columns.

Counterpart of ``spark_rapids_tpu/ops/nested_ops.py`` (the reference's
CreateNamedStruct, GetStructField, CreateMap, GetMapValue, MapKeys and
MapValues rules).  Nested columns live as flat columns
(``columnar/nested.py``), so most of these resolve when they bind and run
no device code:

* ``GetStructField(col("s"), "a")`` binds to the flat column ``s.a``;
* ``MapKeys(col("m"))`` binds to the array column ``m.__key``;
* ``CreateNamedStruct`` and ``CreateMap`` expand at ``select`` into one
  projection per shredded child;
* ``GetMapValue`` is the one with work to do: the first matching key of
  each row by a segmented min over the key elements, then a gather of
  the value.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columnar.dtypes import (
    DataType, MapType, StructType)
from spark_rapids_tpu_torch.columnar.nested import (
    MAP_KEY_SUFFIX, MAP_VALUE_SUFFIX)
from spark_rapids_tpu_torch.ops.expressions import (
    Alias, ColVal, EmitContext, Expression, UnresolvedColumn)


def _base_name(e: Expression, what: str) -> str:
    if isinstance(e, UnresolvedColumn):
        return e.col_name
    raise ValueError(f"{what} requires a direct column reference, got {e}")


class GetStructField(Expression):
    """s.a / s["a"]: the shredded flat column ``s.a`` (chains compose:
    s.a.b).  Over a CreateNamedStruct it is the field's own expression."""

    def __init__(self, child: Expression, field: str):
        self.children = (child,)
        self.field = field

    def with_children(self, children):
        return GetStructField(children[0], self.field)

    @property
    def dtype(self) -> DataType:
        raise RuntimeError("GetStructField resolves at bind time")

    @property
    def nullable(self) -> bool:
        return True

    def bind(self, schema) -> Expression:
        base = self.children[0]
        if isinstance(base, CreateNamedStruct):
            return Alias(base.field_expr(self.field), self.field).bind(schema)
        parts = [self.field]
        while isinstance(base, GetStructField):
            parts.append(base.field)
            base = base.children[0]
        root = _base_name(base, "struct field access")
        path = ".".join([root] + parts[::-1])
        names = [n for n, _ in schema]
        if path not in names:
            hits = [n for n in names if n.startswith(path + ".")]
            if hits:
                raise KeyError(
                    f"{path!r} is a nested struct; select it whole or "
                    f"access a leaf field ({hits})")
            raise KeyError(
                f"struct field {path!r} not found; flat columns: {names}")
        return Alias(UnresolvedColumn(path).bind(schema), self.field)

    @property
    def name(self) -> str:
        return self.field

    def cache_key(self):
        return ("GetStructField", self.field, self.children[0].cache_key())

    def __str__(self):
        return f"{self.children[0]}.{self.field}"


class CreateNamedStruct(Expression):
    """struct(a, b, ...): expands at ``select`` into one shredded
    projection per field (``<out>.<field>``); never runs itself."""

    def __init__(self, pairs: Sequence[Tuple[str, Expression]]):
        if not pairs:
            raise ValueError("struct() needs at least one field")
        self.pairs = [(str(n), e) for n, e in pairs]
        self.children = tuple(e for _, e in self.pairs)

    def with_children(self, children):
        return CreateNamedStruct(
            list(zip([n for n, _ in self.pairs], children)))

    def field_expr(self, field: str) -> Expression:
        for n, e in self.pairs:
            if n == field:
                return e
        raise KeyError(f"struct has no field {field!r}; "
                       f"fields: {[n for n, _ in self.pairs]}")

    @property
    def dtype(self) -> DataType:
        return StructType((n, e.dtype) for n, e in self.pairs)

    @property
    def nullable(self) -> bool:
        return False

    def expand(self, out_name: str) -> List[Expression]:
        return [Alias(e, f"{out_name}.{n}") for n, e in self.pairs]

    @property
    def name(self) -> str:
        return "struct(" + ", ".join(n for n, _ in self.pairs) + ")"

    def cache_key(self):
        return ("CreateNamedStruct", tuple(n for n, _ in self.pairs),
                tuple(e.cache_key() for _, e in self.pairs))


class CreateMap(Expression):
    """map(k1, v1, k2, v2, ...): expands at ``select`` into the two
    aligned array projections ``<out>.__key`` and ``<out>.__value``."""

    def __init__(self, *entries: Expression):
        if not entries or len(entries) % 2:
            raise ValueError("map() needs alternating key, value pairs")
        self.children = tuple(entries)

    def with_children(self, children):
        return CreateMap(*children)

    @property
    def keys(self):
        return self.children[0::2]

    @property
    def values(self):
        return self.children[1::2]

    @property
    def dtype(self) -> DataType:
        return MapType(self.keys[0].dtype, self.values[0].dtype)

    @property
    def nullable(self) -> bool:
        return False

    def expand(self, out_name: str) -> List[Expression]:
        from spark_rapids_tpu_torch.ops.collections_ops import CreateArray
        # refuse a variable-width key or value where its type is known
        # already, before it could shred into bytes
        for e in self.children:
            try:
                dt = e.dtype
            except Exception:
                continue
            if dt.has_offsets or dt.is_nested:
                raise ValueError(
                    f"map() entry {e} has type {dt}: map keys/values "
                    "must be fixed-width scalar types")
        return [Alias(CreateArray(*self.keys), out_name + MAP_KEY_SUFFIX),
                Alias(CreateArray(*self.values),
                      out_name + MAP_VALUE_SUFFIX)]

    @property
    def name(self) -> str:
        return "map"


class _MapPart(Expression):
    """MapKeys / MapValues: bind to a shredded array column."""

    suffix = ""
    fn_name = ""

    def __init__(self, child: Expression):
        self.children = (child,)

    def with_children(self, children):
        return type(self)(children[0])

    @property
    def dtype(self) -> DataType:
        raise RuntimeError(f"{type(self).__name__} resolves at bind time")

    @property
    def nullable(self) -> bool:
        return False

    def bind(self, schema) -> Expression:
        base = _base_name(self.children[0], self.fn_name)
        return Alias(UnresolvedColumn(base + self.suffix).bind(schema),
                     f"{self.fn_name}({base})")

    @property
    def name(self) -> str:
        c = self.children[0]
        n = c.col_name if isinstance(c, UnresolvedColumn) else str(c)
        return f"{self.fn_name}({n})"


class MapKeys(_MapPart):
    suffix = MAP_KEY_SUFFIX
    fn_name = "map_keys"


class MapValues(_MapPart):
    suffix = MAP_VALUE_SUFFIX
    fn_name = "map_values"


class GetMapValue(Expression):
    """m[key] / element_at(m, key): each row's first matching key.

    Before binding the children are (map reference, key); binding
    rewires them to the two shredded array columns and the key.  Every
    key element compares with its row's probe key in one vector op, a
    segmented min gives each row's earliest match, and the value gathers
    from there: null when the row has no match (Spark's semantics)."""

    def __init__(self, *children: Expression):
        self.children = tuple(children)

    def with_children(self, children):
        return GetMapValue(*children)

    @property
    def _bound(self) -> bool:
        return len(self.children) == 3

    @property
    def dtype(self) -> DataType:
        if not self._bound:
            raise RuntimeError("GetMapValue resolves dtypes at bind time")
        return self.children[1].dtype.element

    @property
    def nullable(self) -> bool:
        return True

    def bind(self, schema) -> Expression:
        if self._bound:
            return self
        base = _base_name(self.children[0], "map lookup")
        keys = UnresolvedColumn(base + MAP_KEY_SUFFIX).bind(schema)
        values = UnresolvedColumn(base + MAP_VALUE_SUFFIX).bind(schema)
        key = self.children[1].bind(schema)
        return Alias(GetMapValue(keys, values, key), f"{base}[{key}]")

    def emit(self, ctx: EmitContext) -> ColVal:
        from spark_rapids_tpu_torch.ops.collections_ops import (
            element_rows, live_elements)
        from spark_rapids_tpu_torch.ops.expressions import promote_types
        keys_e, values_e, key_e = self.children
        kc = keys_e.emit(ctx)
        vc = values_e.emit(ctx)
        probe = key_e.emit(ctx)
        cap = ctx.capacity
        ecap = int(kc.values.shape[0])
        row = element_rows(kc, cap)
        pv = probe.values
        per_elem = pv if pv.dim() == 0 else pv[row]
        # compare in the promoted type (Spark casts both sides): a
        # fractional float probe misses an integer key
        ct = promote_types(kc.dtype.element, probe.dtype)
        from spark_rapids_tpu_torch.columnar.dtypes import torch_dtype
        tdt = torch_dtype(ct)
        match = live_elements(kc, cap) & \
            (kc.values.to(tdt) == per_elem.to(tdt))
        pos = torch.arange(ecap, device=ctx.device)
        first = torch.full((cap,), ecap, dtype=torch.int64,
                           device=ctx.device)
        first.scatter_reduce_(0, row, torch.where(match, pos, ecap), "amin")
        found = first < ecap
        # (a map holds no null rows and no null elements, so the value
        # array's validity has nothing to add)
        vals = vc.values[first.clamp(max=ecap - 1)] if ecap else \
            torch.zeros(cap, dtype=vc.values.dtype, device=ctx.device)
        valid = found
        if probe.validity is not None:
            valid = valid & probe.validity
        return ColVal(self.dtype, vals, valid)

    @property
    def name(self) -> str:
        return "element_at"


def expand_nested_projections(exprs: List[Expression],
                              child_schema) -> List[Expression]:
    """``select``-time rewrite: a CreateNamedStruct or CreateMap output
    expands into its shredded projections (a field that is a struct or a
    map expands in turn), and a reference to a whole
    shredded column expands to all its flat members (so
    ``select("s", "v")`` keeps the struct)."""
    names = [n for n, _ in child_schema]
    out: List[Expression] = []
    for e in exprs:
        inner = e.children[0] if isinstance(e, Alias) else e
        out_name = e.alias if isinstance(e, Alias) else None
        if isinstance(inner, (CreateNamedStruct, CreateMap)):
            if out_name is None:
                raise ValueError(
                    f"{inner.name}: struct()/map() outputs must be "
                    "aliased (.alias('name'))")
            # a struct's field may be a struct or a map itself
            out.extend(expand_nested_projections(inner.expand(out_name),
                                                 child_schema))
            continue
        if isinstance(inner, UnresolvedColumn) and \
                inner.col_name not in names:
            members = [n for n in names
                       if n.startswith(inner.col_name + ".")]
            if members:
                if out_name is not None and out_name != inner.col_name:
                    out.extend(Alias(UnresolvedColumn(n),
                                     out_name + n[len(inner.col_name):])
                               for n in members)
                else:
                    out.extend(UnresolvedColumn(n) for n in members)
                continue
        out.append(e)
    return out
