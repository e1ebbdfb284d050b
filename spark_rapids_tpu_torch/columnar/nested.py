"""Nested-type shredding: struct/map columns <-> flat physical columns.

Counterpart of ``spark_rapids_tpu/columnar/nested.py``, copied (the port
keeps its own copy of this pure-pyarrow module rather than import the JAX
package).  The reference carries nested data through execution as cudf
struct/list device columns (``GpuColumnVector.java``,
``GpuGenerateExec.scala``); here, as in the JAX package, nested types are
SHREDDED at ingest into ordinary flat columns (the Dremel/columnar-shredding
representation) and reassembled only at the Arrow output boundary:

* ``STRUCT`` column ``s`` with fields ``a``, ``b``  ->  flat columns
  ``s.a``, ``s.b`` (recursively: ``s.a.c`` for nested structs).  Struct
  nulls propagate into the children at shred time (a null struct row has
  all-null fields), matching how field access on a null struct behaves.
* ``MAP`` column ``m``  ->  two aligned array columns ``m.__key`` /
  ``m.__value`` sharing per-row offsets.

Everything downstream — gather, filter compaction, joins, sort, spill,
serialization — operates on the flat columns with zero nested-awareness,
which is the point: one code path for flat and nested data.  The dot and the
``__key``/``__value`` suffixes are reserved column naming.
"""

from __future__ import annotations

from typing import List, Tuple

MAP_KEY_SUFFIX = ".__key"
MAP_VALUE_SUFFIX = ".__value"


def check_reserved_names(names) -> None:
    """Ingest-boundary guard: user column names must not collide with
    the shredding convention, or assemble_table would silently reshape
    them into structs/maps on output."""
    bad = [n for n in names if "." in n]
    if bad:
        raise ValueError(
            f"column name(s) {bad} contain '.', which is reserved for "
            "nested-type shredding; rename the column(s)")


def is_shredded_map(name: str, schema_names) -> bool:
    """True when a bare column reference names a shredded MAP column:
    absent itself, both halves present.  The single definition every
    bind-time dispatch site uses."""
    return (name not in schema_names
            and name + MAP_KEY_SUFFIX in schema_names
            and name + MAP_VALUE_SUFFIX in schema_names)


def has_nested(table) -> bool:
    import pyarrow as pa
    return any(pa.types.is_struct(f.type) or pa.types.is_map(f.type)
               for f in table.schema)


def _shred_array(name: str, arr) -> List[Tuple[str, object]]:
    """One (possibly nested) arrow column -> [(flat_name, arrow_array)]."""
    import pyarrow as pa
    import pyarrow.compute as pc
    arr = arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr
    t = arr.type
    if pa.types.is_struct(t):
        out = []
        null_mask = pc.is_null(arr) if arr.null_count else None
        for f in t:
            child = arr.field(f.name)
            if null_mask is not None:
                # a null struct row reads as null in every field
                child = pc.if_else(null_mask, pa.nulls(len(arr), f.type),
                                   child)
            out.extend(_shred_array(f"{name}.{f.name}", child))
        return out
    if pa.types.is_map(t):
        from spark_rapids_tpu_torch.columnar.dtypes import from_arrow_type
        from_arrow_type(t)  # raises the clear fixed-width-only error
        if arr.null_count:
            raise ValueError(
                f"map column {name!r}: null map rows unsupported "
                "(use an empty map)")
        offsets = arr.offsets
        keys = pa.ListArray.from_arrays(offsets, arr.keys)
        items = pa.ListArray.from_arrays(offsets, arr.items)
        return [(name + MAP_KEY_SUFFIX, keys),
                (name + MAP_VALUE_SUFFIX, items)]
    return [(name, arr)]


def shred_table(table):
    """Flatten every struct/map column of an arrow table (no-op copy
    of already-flat columns)."""
    import pyarrow as pa
    cols, names = [], []
    for fname in table.column_names:
        for n, a in _shred_array(fname, table.column(fname)):
            names.append(n)
            cols.append(a)
    return pa.table(dict(zip(names, cols)))


# ------------------------------------------------------------------ assembly --
def _group_prefixes(names: List[str]):
    """Group flat names into output slots, preserving first-seen order.

    Returns [(out_name, kind, members)] where kind is 'plain' | 'map' |
    'struct'; members lists the flat column names consumed."""
    slots = []
    consumed = set()
    for n in names:
        if n in consumed:
            continue
        if n.endswith(MAP_KEY_SUFFIX) or n.endswith(MAP_VALUE_SUFFIX):
            suffix = MAP_KEY_SUFFIX if n.endswith(MAP_KEY_SUFFIX) \
                else MAP_VALUE_SUFFIX
            base = n[:-len(suffix)]
            if "." not in base:
                # a complete TOP-LEVEL key/value pair assembles to a map
                # regardless of projection order; an orphan half (e.g. a
                # lone map_keys() output) stays a plain list column.  A
                # dotted base (s.m.__key) is a map INSIDE a struct — it
                # falls through to struct grouping and reassembles during
                # the recursive struct pass.
                k, v = base + MAP_KEY_SUFFIX, base + MAP_VALUE_SUFFIX
                if k in names and v in names and k not in consumed \
                        and v not in consumed:
                    slots.append((base, "map", [k, v]))
                    consumed.update((k, v))
                else:
                    slots.append((n, "plain", [n]))
                    consumed.add(n)
                continue
        if "." in n:
            base = n.split(".", 1)[0]
            if base in names:
                raise ValueError(
                    f"ambiguous output: both column {base!r} and struct "
                    f"member {n!r} present — alias one of them")
            members = [m for m in names if m not in consumed and
                       m.startswith(base + ".")]
            slots.append((base, "struct", members))
            consumed.update(members)
            continue
        slots.append((n, "plain", [n]))
        consumed.add(n)
    return slots


def _assemble_struct(prefix: str, members: List[Tuple[str, object]]):
    """members: [(name_relative_to_prefix, array)] -> StructArray."""
    import pyarrow as pa
    groups = _group_prefixes([n for n, _ in members])
    by_name = dict(members)
    fields, arrays = [], []
    for out_name, kind, flat in groups:
        if kind == "map":
            arr = _assemble_map(by_name[flat[0]], by_name[flat[1]])
        elif kind == "struct":
            arr = _assemble_struct(
                out_name,
                [(n[len(out_name) + 1:], by_name[n]) for n in flat])
        else:
            arr = by_name[flat[0]]
        fields.append(pa.field(out_name, arr.type))
        arrays.append(arr)
    return pa.StructArray.from_arrays(arrays, fields=fields)


def _assemble_map(keys_list, values_list):
    import pyarrow as pa
    keys_list = keys_list.combine_chunks() \
        if isinstance(keys_list, pa.ChunkedArray) else keys_list
    values_list = values_list.combine_chunks() \
        if isinstance(values_list, pa.ChunkedArray) else values_list
    return pa.MapArray.from_arrays(keys_list.offsets, keys_list.values,
                                   values_list.values)


def assemble_table(table):
    """Inverse of shred_table, driven purely by the naming convention.
    Tables without reserved names pass through untouched."""
    import pyarrow as pa
    names = table.column_names
    if not any("." in n for n in names):
        return table
    out_names, out_cols = [], []
    for out_name, kind, flat in _group_prefixes(names):
        if kind == "map":
            col = _assemble_map(table.column(flat[0]).combine_chunks(),
                                table.column(flat[1]).combine_chunks())
        elif kind == "struct":
            col = _assemble_struct(
                out_name,
                [(n[len(out_name) + 1:],
                  table.column(n).combine_chunks()) for n in flat])
        else:
            col = table.column(flat[0])
        out_names.append(out_name)
        out_cols.append(col)
    return pa.table(dict(zip(out_names, out_cols)))
