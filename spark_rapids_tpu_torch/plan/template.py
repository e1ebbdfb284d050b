"""Parameterized plan templates: literal hoisting and template fingerprints.

Counterpart of ``spark_rapids_tpu/plan/template.py``.  A dashboard
re-issues one plan with shifting literals (a date range, a customer id).
:func:`hoist_literals` rewrites a bound logical plan so its constant
literals become typed :class:`~spark_rapids_tpu_torch.ops.expressions.
ParamSlot` leaves whose keys carry no value: the template tier of the
result cache keys on the template and its binding, and a prepared
statement (``api/prepared.py``) plans the template once and runs it under
every binding.  The port's stages are eager, so there is no trace to
reuse: what a template saves here is the planning pass.

A literal is hoisted only when the swap provably changes neither the
plan's shape nor an output name, with the JAX package's refusal table:

==========================  =================================================
refused literal             why (it stays inline, keyed by value)
==========================  =================================================
null literals               validity structure differs from a value scalar
string literals             char-array shape depends on the value
decimal literals            precision/scale derive from the digits
inside an ANSI-checked op   check constants belong to the operation
unaliased projections       the output column NAME embeds the literal text
LIMIT / slot constants      row-count shaping is structural, not a parameter
join/sort/window positions  those operators do not thread parameters
==========================  =================================================

A refused literal stays inline and in the fingerprint, so correctness
never depends on the refusal list; every refusal is recorded with its
reason.

:func:`plan_signature` is the canonical identity walk: every node's
class and attributes, expressions in full (inline literal values
included).  The exact result-cache tier and the stage ids of
``robustness/checkpoint.py`` key on it, so two plans differing in an
aliased literal, a join type or a sort direction never alias (the port's
logical nodes describe themselves by their output columns only).
"""

from __future__ import annotations

import copy
import dataclasses
import datetime
import decimal
import hashlib
import numbers
from typing import List, Optional, Tuple

import numpy as np

from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops.expressions import (
    Alias, Expression, Literal, ParamSlot, literal_storage_value)
from spark_rapids_tpu_torch.plan import logical as L

# refusal reasons (stable strings: they ride the QueryEnd sharing dict)
REFUSE_NULL = "null-literal"
REFUSE_STRING = "string-shape"
REFUSE_DECIMAL = "decimal-precision"
REFUSE_ANSI = "ansi-check-constant"
REFUSE_NAME = "unaliased-output-name"
REFUSE_LIMIT = "limit-shape-constant"
REFUSE_POSITION = "position-not-parameterized"


def _literal_refusal(lit: Literal) -> Optional[str]:
    """Literal kinds whose swap changes the shape (never hoisted)."""
    if lit.value is None:
        return REFUSE_NULL
    if lit.dtype.is_string:
        return REFUSE_STRING
    if lit.dtype.is_decimal:
        return REFUSE_DECIMAL
    return None


def _contains_literal(e: Expression) -> bool:
    if isinstance(e, Literal):
        return True
    return any(_contains_literal(c) for c in e.children)


def check_bindable(value, dtype: DataType) -> None:
    """Reject a binding that could not have been the hoisted literal: a
    float silently truncated into an integer slot must be a type error."""
    if value is None:
        raise TypeError(
            f"cannot bind None to a {dtype.name} parameter slot (null "
            "literals are never hoisted — issue the query with the null "
            "inline)")
    if dtype.name == "boolean":
        if not isinstance(value, bool):
            raise TypeError(f"parameter expects boolean, got {value!r}")
        return
    if dtype.is_integral:
        if isinstance(value, bool) or \
                not isinstance(value, numbers.Integral):
            raise TypeError(
                f"parameter expects {dtype.name}, got {value!r}")
        return
    if dtype.is_floating:
        if isinstance(value, bool) or not isinstance(value, numbers.Real):
            raise TypeError(
                f"parameter expects {dtype.name}, got {value!r}")
        return
    if dtype.is_datetime:
        # what Literal accepts (ints or parseable dates); garbage raises
        literal_storage_value(value, dtype)
        return
    raise TypeError(f"{dtype.name} parameters are not hoistable")


class _Hoister:
    def __init__(self):
        self.slots: List[ParamSlot] = []
        self.refusals: List[Tuple[str, str]] = []

    def _hoist_expr(self, e: Expression, ansi: bool = False) -> Expression:
        if isinstance(e, Literal):
            reason = _literal_refusal(e)
            if reason is None and ansi:
                reason = REFUSE_ANSI
            if reason is not None:
                self.refusals.append((reason, str(e)))
                return e
            slot = ParamSlot(len(self.slots), e.dtype, e.value)
            self.slots.append(slot)
            return slot
        if not e.children:
            return e
        # an ANSI-checked operation (a Cast with ansi=True) owns its
        # check constants: refuse underneath it
        child_ansi = ansi or bool(getattr(e, "ansi", False))
        new = [self._hoist_expr(c, child_ansi) for c in e.children]
        if all(n is o for n, o in zip(new, e.children)):
            return e
        return e.with_children(new)

    def _hoist_named(self, e: Expression) -> Expression:
        """A position whose expression names an output column: only an
        Alias pins the name against the rewrite."""
        if isinstance(e, Alias):
            inner = self._hoist_expr(e.child)
            return e if inner is e.child else Alias(inner, e.alias)
        if _contains_literal(e):
            self.refusals.append((REFUSE_NAME, e.name))
        return e

    def visit(self, plan: L.LogicalPlan) -> L.LogicalPlan:
        new_children = [self.visit(c) for c in plan.children]
        changed = any(n is not o
                      for n, o in zip(new_children, plan.children))
        fields = {}
        if isinstance(plan, L.Filter):
            cond = self._hoist_expr(plan.condition)
            if cond is not plan.condition:
                fields["condition"] = cond
        elif isinstance(plan, L.Project):
            exprs = [self._hoist_named(e) for e in plan.exprs]
            if any(n is not o for n, o in zip(exprs, plan.exprs)):
                fields["exprs"] = exprs
        elif isinstance(plan, L.Aggregate):
            group = [self._hoist_named(e) for e in plan.group_exprs]
            aggs = [self._hoist_named(e) for e in plan.agg_exprs]
            if any(n is not o for n, o in zip(group, plan.group_exprs)):
                fields["group_exprs"] = group
            if any(n is not o for n, o in zip(aggs, plan.agg_exprs)):
                fields["agg_exprs"] = aggs
        elif isinstance(plan, L.Limit):
            self.refusals.append((REFUSE_LIMIT, f"LIMIT {plan.n}"))
        elif any(_contains_literal(e) for e in _all_expressions(plan)):
            # join keys and conditions, sort orders, windows: literals
            # stay inline, one refusal per node
            self.refusals.append((REFUSE_POSITION, type(plan).__name__))
        if not changed and not fields:
            return plan
        node = copy.copy(plan)  # never deepcopy: relations hold live batches
        node.children = tuple(new_children)
        for k, v in fields.items():
            setattr(node, k, v)
        return node


def _all_expressions(node: L.LogicalPlan) -> List[Expression]:
    """A node's expressions (a join's condition included)."""
    from spark_rapids_tpu_torch.plan.overrides import _node_expressions
    return list(_node_expressions(node))


# attributes the planner sets on logical nodes from the whole plan
# (plan/overrides._pushdown_pass) before each planning: the same plan
# keys alike whether or not it was planned before
_PLANNER_SET = frozenset({"children", "batches", "required_columns",
                          "pushed_filters"})


def canonical(v, _seen=None):
    """A hashable, value-complete form of a plan attribute: the port's
    own objects (expressions, aggregate functions) by their class and
    every attribute (a ParamSlot by its index and type only, so a
    template's key carries no binding), numpy buffers by their bytes,
    types by name, dates and decimals by value; any other object by its class and id (it stays the
    same object within a process, so the key is stable, and two distinct
    objects never alias)."""
    if v is None or isinstance(v, (str, int, float, bool)):
        return v
    if isinstance(v, ParamSlot):
        return ("Param", v.index, v.dtype.name)
    if isinstance(v, DataType):
        return ("type", str(v))
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, (datetime.date, datetime.time, decimal.Decimal,
                      np.datetime64, bytes)):
        return (type(v).__name__, repr(v))
    if isinstance(v, np.ndarray):
        return ("ndarray", str(v.dtype), v.shape,
                hashlib.sha256(np.ascontiguousarray(v).tobytes())
                .hexdigest())
    seen = _seen if _seen is not None else set()
    if isinstance(v, (list, tuple)):
        return tuple(canonical(x, seen) for x in v)
    if isinstance(v, (set, frozenset)):
        return ("set",) + tuple(sorted(repr(canonical(x, seen))
                                       for x in v))
    if isinstance(v, dict):
        return ("dict",) + tuple(sorted(
            (repr(k), repr(canonical(x, seen))) for k, x in v.items()))
    own = type(v).__module__.startswith("spark_rapids_tpu_torch.") and \
        hasattr(v, "__dict__") and not isinstance(v, L.LogicalPlan)
    if not own or id(v) in seen:  # ``seen``: the path from the root
        return (type(v).__name__, id(v))
    seen.add(id(v))
    try:
        return (type(v).__name__,) + tuple(
            (k, canonical(x, seen)) for k, x in sorted(vars(v).items()))
    finally:
        seen.discard(id(v))


def plan_signature(plan: L.LogicalPlan) -> Tuple:
    """Canonical structural identity: per node, its depth, class and
    every attribute in canonical form (expressions with their literal
    values, a ParamSlot value-free; an in-memory relation's batches by
    identity, which its input fingerprint covers as well).  The cache
    tiers key on this, not on the rendered tree text, which names only
    output columns."""
    from spark_rapids_tpu_torch.plan import logical as L
    recs: List[Tuple] = []

    def rec(node: L.LogicalPlan, depth: int) -> None:
        attrs = tuple((k, canonical(v))
                      for k, v in sorted(vars(node).items())
                      if k not in _PLANNER_SET)
        if isinstance(node, L.InMemoryRelation):
            attrs += (("batches", tuple(id(b) for b in node.batches)),)
        recs.append((depth, type(node).__name__, attrs))
        for c in node.children:
            rec(c, depth + 1)

    rec(plan, 0)
    return tuple(recs)


def plan_fingerprint(plan: L.LogicalPlan) -> str:
    return hashlib.sha256(
        repr(plan_signature(plan)).encode("utf-8")).hexdigest()


@dataclasses.dataclass
class TemplateInfo:
    """A hoisted plan template and its current binding.

    ``plan`` shares every subtree it did not rewrite with the original
    plan (relations are the same objects).  The ParamSlots belong to this
    template and binding new values mutates them, so one TemplateInfo
    must not run concurrently with itself (a prepared statement's handle
    serializes its runs; the ad-hoc path hoists afresh per query)."""

    plan: L.LogicalPlan
    slots: List[ParamSlot]
    refusals: List[Tuple[str, str]]
    fingerprint: str

    @property
    def hoisted(self) -> bool:
        return bool(self.slots)

    @property
    def param_count(self) -> int:
        return len(self.slots)

    def bind(self, values) -> None:
        """Bind a positional parameter vector (type-checked first)."""
        if len(values) != len(self.slots):
            raise ValueError(
                f"template expects {len(self.slots)} parameters, "
                f"got {len(values)}")
        for s, v in zip(self.slots, values):
            check_bindable(v, s.dtype)
        for s, v in zip(self.slots, values):
            s.bind_value(v)

    def values(self) -> Tuple:
        return tuple(s.value for s in self.slots)

    def param_vector(self) -> Tuple:
        """Canonical (dtype, storage value) vector of the current binding:
        the template tier's key component."""
        return tuple(
            (s.dtype.name,
             repr(literal_storage_value(s.value, s.dtype)))
            for s in self.slots)


def hoist_literals(plan: L.LogicalPlan) -> TemplateInfo:
    """``plan`` rewritten into its parameterized template.  The slots
    carry the original literal values as their first binding, so
    ``info.plan`` runs as ``plan`` does; ``info.hoisted`` is False when
    nothing could be hoisted."""
    h = _Hoister()
    tplan = h.visit(plan)
    return TemplateInfo(plan=tplan, slots=h.slots, refusals=h.refusals,
                        fingerprint=plan_fingerprint(tplan))
