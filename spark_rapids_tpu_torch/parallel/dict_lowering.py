"""Strings on the sharded path: dictionary codes and expressions over them.

Counterpart of ``spark_rapids_tpu/parallel/dist_planner.py:142-509``
(``DictLookup``, ``ExprLowering``, ``_check_supported``).  A string column
travels between shards as int64 codes into one
:class:`~spark_rapids_tpu_torch.ops.dictionary.SortedDictionary` per
column, held on the session's device; code order is Spark's string order,
so group-by, sort, min/max and range comparisons run on the codes, and
``collect`` decodes.  A null row is code 0 with its validity off.

:class:`ExprLowering` rewrites a bound expression for such a frame:

- a reference to an encoded column becomes an int64 reference to its
  codes;
- ``ref OP 'literal'`` (also flipped) becomes a comparison of the codes
  with the literal's code bounds, counted on the device over the
  dictionary (one counted sync per literal);
- ``ref IN ('a', 'b', ...)`` becomes an IN over the literals' codes, an
  absent literal code -1;
- any other function of ONE encoded column and literals becomes a
  :class:`DictLookup`: the engine's own ``emit`` evaluates it once over
  the K dictionary values on the device, and each row gathers its
  result.  A string result re-encodes against a fresh sorted dictionary.

The JAX package evaluates a lookup over the K values and gives null rows
a null result.  The port evaluates it over the K values and one null row
as well, so an expression that is not null-propagating (``coalesce(s,
'x')``, ``s IS NULL`` inside a CASE) keeps its single-device answer on
null rows.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Sequence, Set

import torch

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.columnar.dtypes import DataType, torch_dtype
from spark_rapids_tpu_torch.ops import aggregates as agg
from spark_rapids_tpu_torch.ops import dictionary
from spark_rapids_tpu_torch.ops import predicates as P
from spark_rapids_tpu_torch.ops.compiler import check_raise, widen
from spark_rapids_tpu_torch.ops.dictionary import SortedDictionary
from spark_rapids_tpu_torch.ops.expressions import (
    Alias, BoundReference, ColVal, EmitContext, Expression, Literal)
from spark_rapids_tpu_torch.plan.logical import AggregateExpression


class NotDistributable(Exception):
    """The plan (or an expression) has no lowering onto the shard group;
    the query falls back to the single-device engine with this reason."""


def phys_dtype(dt: DataType) -> DataType:
    """A column's type as it travels between shards: strings as codes."""
    return dts.INT64 if dt.is_string else dt


_CMP = (P.EqualTo, P.LessThan, P.LessThanOrEqual, P.GreaterThan,
        P.GreaterThanOrEqual)
_FLIP = {P.LessThan: P.GreaterThan, P.LessThanOrEqual: P.GreaterThanOrEqual,
         P.GreaterThan: P.LessThan, P.GreaterThanOrEqual: P.LessThanOrEqual,
         P.EqualTo: P.EqualTo}


class DictLookup(Expression):
    """``table[codes]``: any function of one encoded column as a gather.

    ``values`` / ``valid`` hold the function's result for each of the K
    dictionary values and, at index K, for a null input; a null code row
    reads index K.  A string-valued function's results are codes into
    ``out_dict`` (``dtype`` is then INT64)."""

    def __init__(self, child: Expression, values: torch.Tensor,
                 valid: Optional[torch.Tensor], dtype: DataType,
                 out_dict: Optional[SortedDictionary] = None,
                 label: str = "f"):
        self.children = (child,)
        self.values = values
        self.valid = valid
        self._dtype = dtype
        self.out_dict = out_dict
        self.label = label

    @property
    def dtype(self) -> DataType:
        return self._dtype

    @property
    def nullable(self) -> bool:
        return True

    @property
    def name(self) -> str:
        return self.label

    def with_children(self, children):
        return DictLookup(children[0], self.values, self.valid, self._dtype,
                          self.out_dict, self.label)

    def emit(self, ctx: EmitContext) -> ColVal:
        c = self.children[0].emit(ctx)
        k = int(self.values.shape[0]) - 1  # the last entry: a null input
        if k < 0:  # the dry pass's empty table
            n = c.values.shape
            return ColVal(self._dtype,
                          torch.zeros(n, dtype=torch_dtype(self._dtype),
                                      device=ctx.device),
                          torch.zeros(n, dtype=torch.bool,
                                      device=ctx.device))
        idx = c.values.clamp(0, max(k - 1, 0))
        if c.validity is not None:
            idx = torch.where(c.validity, idx, torch.full_like(idx, k))
        return ColVal(self._dtype, self.values[idx],
                      None if self.valid is None else self.valid[idx])

    def cache_key(self):
        return ("DictLookup", self.label, self.children[0].cache_key(),
                id(self.values))

    def __str__(self):
        return f"DictLookup[{self.label}]({self.children[0]})"


def _with_null_row(d: SortedDictionary) -> ColVal:
    """The dictionary's values and one null row after them."""
    col = d.column()
    k = len(d)
    offsets = torch.cat([col.offsets, col.offsets[-1:]])
    valid = torch.ones(k + 1, dtype=torch.bool, device=d.device)
    valid[k] = False
    return ColVal(dts.STRING, col.values, valid, offsets)


def check_emittable(e: Expression) -> None:
    """Every node of ``e`` is one the port evaluates (its class has its
    own ``emit``); aggregate calls are planned, not emitted."""
    if isinstance(e, AggregateExpression):
        for c in e.children:
            check_emittable(c)
        return
    if type(e).emit is Expression.emit:
        raise NotDistributable(
            f"{type(e).__name__} has no evaluation in the PyTorch port")
    for c in e.children:
        check_emittable(c)


class ExprLowering:
    """Rewrite bound expressions for a frame whose ordinals in ``enc``
    travel as codes into their dictionaries.  In the dry pass every
    dictionary is empty: the rewrite type-checks, no lookup table is
    evaluated and no value is fetched.  ``pruned`` ordinals were not read
    at the scan (column pruning): reading one raises."""

    def __init__(self, enc: Dict[int, SortedDictionary], device,
                 dry: bool = False, pruned: Set[int] = frozenset(),
                 conf=None):
        self.enc = enc
        self.device = torch.device(device)
        self.dry = dry
        self.pruned = pruned
        # the session's conf: a lookup whose expression the planner tags
        # off the device evaluates through the CPU fallback's evaluator
        self.conf = conf

    def lower(self, e: Expression) -> Expression:
        if isinstance(e, Alias):
            return Alias(self.lower(e.children[0]), e.alias)
        if isinstance(e, BoundReference):
            if e.ordinal in self.pruned:
                raise NotDistributable(
                    f"column {e.name!r} is read but the scan pruned it")
            if e.ordinal in self.enc:
                return BoundReference(e.ordinal, dts.INT64, name=e.name,
                                      nullable=e.nullable)
            if e.dtype.is_string:
                raise NotDistributable(
                    f"column {e.name!r} is a string without a dictionary "
                    "on the shard group")
            return e
        if isinstance(e, _CMP) and (e.children[0].dtype.is_string or
                                    e.children[1].dtype.is_string):
            return self._lower_cmp(e)
        if isinstance(e, P.In) and e.children[0].dtype.is_string:
            return self._lower_in(e)
        if isinstance(e, (P.IsNull, P.IsNotNull)) and \
                e.children[0].dtype.is_string:
            return type(e)(self.lower(e.children[0]))
        if isinstance(e, AggregateExpression):
            return self.lower_agg(e)
        if any(c.dtype.is_string for c in e.children) or e.dtype.is_string:
            d = self._try_dict_lower(e)
            if d is not None:
                return d
            raise NotDistributable(
                f"{type(e).__name__} over strings has no code-space "
                "lowering (not a function of one encoded column and "
                "literals)")
        if not e.children:
            return e
        return e.with_children([self.lower(c) for c in e.children])

    # -- dictionary lookups ------------------------------------------------
    def _dict_lower_candidate(self, e: Expression) -> Optional[int]:
        """The single encoded ordinal ``e`` is a function of, or None
        (several columns, a column without a dictionary, an aggregate or
        window inside)."""
        from spark_rapids_tpu_torch.exec.window import WindowExpression
        ords = set()
        ok = True

        def walk(x):
            nonlocal ok
            if isinstance(x, (AggregateExpression, WindowExpression)):
                ok = False
                return
            if isinstance(x, BoundReference):
                if x.ordinal in self.enc and x.ordinal not in self.pruned:
                    ords.add(x.ordinal)
                else:
                    ok = False
                return
            for c in x.children:
                walk(c)

        walk(e)
        if not ok or len(ords) != 1:
            return None
        return ords.pop()

    def _try_dict_lower(self, e: Expression) -> Optional[DictLookup]:
        """``e`` evaluated over the dictionary of its one encoded column
        (and a null row) as a lookup; None when ``e`` is not such a
        function.  The engine's own ``emit`` evaluates it on the device,
        or, when the planner tags ``e`` off the device (a per-expression
        disable, a LIKE with ``_``, a string cast), the CPU fallback's
        evaluator does on the host: either way the work is over the K
        dictionary values, not the rows."""
        ordinal = self._dict_lower_candidate(e)
        if ordinal is None:
            return None
        codes = BoundReference(ordinal, dts.INT64, name=f"_c{ordinal}")

        def replace(x):
            if isinstance(x, BoundReference) and x.ordinal == ordinal:
                return BoundReference(0, x.dtype, name=x.name)
            if not x.children:
                return x
            return x.with_children([replace(c) for c in x.children])

        over_dict = replace(e)
        check_emittable(over_dict)
        label = f"{type(e).__name__}(dict)"
        out_type = dts.INT64 if e.dtype.is_string else e.dtype
        if self.dry:
            return DictLookup(
                codes, torch.zeros(0, dtype=torch_dtype(out_type),
                                   device=self.device), None, out_type,
                SortedDictionary.empty(self.device)
                if e.dtype.is_string else None, label)
        d = self.enc[ordinal]
        k = len(d) + 1
        if self._tagged_off(e):
            out = _host_lookup(over_dict, d, self.device)
        else:
            ctx = EmitContext([_with_null_row(d)], k, k, d.device)
            try:
                out = widen(over_dict.emit(ctx), k)
                check_raise(ctx)
            except NotImplementedError as exc:
                raise NotDistributable(
                    f"{type(e).__name__} over strings: {exc}") from exc
        if e.dtype.is_string:
            table, new_dict = dictionary.encode_sorted(out, k)
            return DictLookup(codes, table, out.validity, dts.INT64,
                              new_dict, label)
        return DictLookup(codes, out.values.to(torch_dtype(e.dtype)),
                          out.validity, e.dtype, None, label)

    def _tagged_off(self, e: Expression) -> bool:
        if self.conf is None:
            return False
        from spark_rapids_tpu_torch.plan.overrides import tag_expression
        return bool(tag_expression(e, self.conf))

    # -- aggregates --------------------------------------------------------
    def lower_agg(self, e: AggregateExpression) -> AggregateExpression:
        """An aggregate call over lowered children: over strings only
        ``min`` and ``max``, which codes preserve (``first`` / ``last``
        come with those aggregates)."""
        func = e.func
        if func.child is None:
            return e
        if func.child.dtype.is_string and \
                not isinstance(func, (agg.Min, agg.Max)):
            raise NotDistributable(
                f"aggregate {func.name} over strings is not supported on "
                "the shard group (only min/max are order preserving under "
                "dictionary codes)")
        f2 = copy.copy(func)
        f2.child = self.lower(func.child)
        return AggregateExpression(f2)

    # -- dictionaries of lowered expressions -------------------------------
    def encoded_ref(self, e: Expression) -> Optional[BoundReference]:
        """The encoded reference behind ``e`` (through one Alias)."""
        inner = e.children[0] if isinstance(e, Alias) else e
        if isinstance(inner, BoundReference) and inner.ordinal in self.enc:
            return inner
        return None

    def out_dict(self, lowered: Expression) -> Optional[SortedDictionary]:
        """The dictionary of a lowered expression's output codes, if it
        has one: an encoded reference passed through, or a lookup that
        re-encoded its string results."""
        inner = lowered.children[0] if isinstance(lowered, Alias) \
            else lowered
        if isinstance(inner, BoundReference) and inner.ordinal in self.enc:
            return self.enc[inner.ordinal]
        if isinstance(inner, DictLookup) and inner.out_dict is not None:
            return inner.out_dict
        return None

    def _encoded_operand(self, e: Expression):
        """(codes expression, dictionary) of a string subtree with a code
        representation: an encoded reference, or a lookup function of
        one (``substring(c_phone, 1, 2)``)."""
        inner = e.children[0] if isinstance(e, Alias) else e
        ref = self.encoded_ref(inner)
        if ref is not None and ref.ordinal not in self.pruned:
            return (BoundReference(ref.ordinal, dts.INT64, name=ref.name,
                                   nullable=ref.nullable),
                    self.enc[ref.ordinal])
        if inner.dtype.is_string:
            d = self._try_dict_lower(inner)
            if d is not None:
                return d, d.out_dict
        return None

    @staticmethod
    def _ref_and_literal(e):
        l, r = e.children
        if isinstance(r, Literal) and not isinstance(l, Literal):
            return l, r, False
        if isinstance(l, Literal) and not isinstance(r, Literal):
            return r, l, True
        return None

    def _lower_cmp(self, e):
        """``x OP 'lit'`` in code space: ``[lo, hi)`` are the codes equal
        to the literal, so ``< lit`` is ``code < lo``, ``<= lit`` is
        ``code < hi``, ``> lit`` is ``code >= hi``, ``>= lit`` is ``code >=
        lo`` and ``= lit`` is ``code == lo`` (-1 when absent)."""
        pair = self._ref_and_literal(e)
        op = self._encoded_operand(pair[0]) if pair else None
        if pair is None or op is None or \
                not isinstance(pair[1].value, str):
            d = self._try_dict_lower(e)
            if d is not None:
                return d
            raise NotDistributable(
                f"string comparison {e} is not (encoded expression vs "
                "literal); no code-space lowering")
        _, lit, flipped = pair
        codes, d = op
        cls = _FLIP[type(e)] if flipped else type(e)
        (lo, hi), = d.bounds([lit.value])

        def code(v):
            return Literal(int(v), dts.INT64)
        if cls is P.EqualTo:
            return P.EqualTo(codes, code(lo if hi > lo else -1))
        if cls is P.LessThan:
            return P.LessThan(codes, code(lo))
        if cls is P.LessThanOrEqual:
            return P.LessThan(codes, code(hi))
        if cls is P.GreaterThan:
            return P.GreaterThanOrEqual(codes, code(hi))
        return P.GreaterThanOrEqual(codes, code(lo))

    def _lower_in(self, e: P.In):
        op = self._encoded_operand(e.children[0])
        opts = e.children[1:]
        if op is None or not all(
                isinstance(o, Literal) and isinstance(o.value, str)
                for o in opts):
            d = self._try_dict_lower(e)
            if d is not None:
                return d
            raise NotDistributable(
                "string IN is only supported as an encoded expression "
                "IN (literals...) on the shard group")
        codes, d = op
        hits = [c for c in d.codes_of([o.value for o in opts]) if c >= 0]
        return P.In(codes, [Literal(int(c), dts.INT64)
                            for c in (hits or [-1])])


def _host_lookup(over_dict: Expression, d: SortedDictionary,
                 device) -> ColVal:
    """``over_dict`` (over input 0) for each dictionary value and a null
    row, evaluated on the host by the CPU fallback's evaluator, as a
    column on ``device``."""
    import pandas as pd
    import pyarrow as pa
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.exec.fallback import _eval, _to_arrow
    values = pd.array(d.to_pylist() + [None],
                      dtype=pd.StringDtype("pyarrow"))
    v = _eval(over_dict, pd.DataFrame({0: values}))
    col = ColumnarBatch.from_arrow(pa.table({"v": _to_arrow(v)}),
                                   device=device).column("v")
    return ColVal(col.dtype, col.data, col.validity, col.offsets)


def check_supported(exprs: Sequence[Expression], conf=None) -> None:
    """The lowered expressions run on the shard group: no string-typed
    node is left, the port evaluates every node, and (given the
    session's ``conf``) the planner's tagging passes each one, so
    per-op disables and type signatures hold on the shard group too (the
    JAX package's ``_check_supported``)."""
    def walk(e):
        if e.dtype.is_string:
            raise NotDistributable(
                f"string expression {e.name!r} has no code-space lowering")
        for c in e.children:
            walk(c)
    for e in exprs:
        check_emittable(e)
        walk(e)
        if conf is not None:
            from spark_rapids_tpu_torch.plan.overrides import tag_expression
            reasons = tag_expression(e, conf)
            if reasons:
                raise NotDistributable(
                    f"expression {type(e).__name__}: "
                    + "; ".join(reasons))

