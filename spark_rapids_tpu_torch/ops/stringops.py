"""String expressions over the chars+offsets layout.

Counterpart of the parts of ``spark_rapids_tpu/ops/stringops.py`` that the
22 TPC-H queries and the ported string keys need: the layout helpers
(``row_lengths``, ``char_lengths``, ``byte_to_row``, ``build_strings``),
equality and ordering comparisons, ``StartsWith``/``EndsWith``/
``Contains``, ``Like`` with every plan of its pattern compiler,
``Substring`` by 1-based UTF-8 character position, and ``string_select``
(CASE and COALESCE with string results).

Every function is vector ops over the flat uint8 chars buffer plus the
int32 row offsets, as in the JAX package: a per-row verdict reduces over
byte ranges through the byte->row map (``searchsorted`` over the
offsets) with ``index_add_`` or ``scatter_reduce``; a producer computes
its output lengths first and maps every output byte back to a source byte
(``cumsum`` and ``searchsorted``).  Output char buffers are sized from
host-known bounds (the input's chars, a literal's length times the rows),
so no producer waits for the card.  A pattern byte test shifts the chars
buffer by slicing instead of gathering.  Casts to and from strings, case
mapping, trimming, concatenation and regular expressions are not ported:
a plan that needs one raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.ops.expressions import (
    ColVal, EmitContext, Expression)

_BIG = 1 << 30


# ------------------------------------------------------------ layout helpers

def row_lengths(c: ColVal) -> torch.Tensor:
    """Byte length per row."""
    return c.offsets[1:] - c.offsets[:-1]


def byte_to_row(c: ColVal, capacity: int) -> torch.Tensor:
    """Row index (int64) of every byte position in the chars buffer."""
    pos = torch.arange(c.values.shape[0], device=c.values.device)
    row = torch.searchsorted(c.offsets.to(torch.int64), pos, right=True) - 1
    return row.clamp(0, max(capacity - 1, 0))


def _char_prefix(c: ColVal) -> torch.Tensor:
    """int64[nchars + 1]: UTF-8 character starts before each byte (a
    character starts at every byte that is not a continuation byte)."""
    is_start = ((c.values & 0xC0) != 0x80).to(torch.int64)
    out = torch.zeros(c.values.shape[0] + 1, dtype=torch.int64,
                      device=c.values.device)
    torch.cumsum(is_start, 0, out=out[1:])
    return out


def char_lengths(c: ColVal) -> torch.Tensor:
    """UTF-8 character count per row (int64)."""
    prefix = _char_prefix(c)
    offs = c.offsets.to(torch.int64)
    return prefix[offs[1:]] - prefix[offs[:-1]]


def build_strings(lengths: torch.Tensor, src_start: torch.Tensor,
                  src_chars: torch.Tensor, out_char_cap: int):
    """(chars, int32 offsets) of rows whose ``lengths[r]`` bytes copy
    ``src_chars`` from ``src_start[r]`` on.  ``out_char_cap`` is a
    host-known bound on the output's bytes; bytes past the last offset are
    zero padding."""
    device = lengths.device
    lengths = lengths.clamp(min=0).to(torch.int64)
    offsets = torch.zeros(lengths.shape[0] + 1, dtype=torch.int64,
                          device=device)
    torch.cumsum(lengths, 0, out=offsets[1:])
    if out_char_cap == 0 or src_chars.shape[0] == 0 or \
            lengths.shape[0] == 0:
        return (torch.zeros(out_char_cap, dtype=torch.uint8, device=device),
                offsets.to(torch.int32))
    pos = torch.arange(out_char_cap, device=device)
    row = (torch.searchsorted(offsets, pos, right=True) - 1).clamp(
        0, lengths.shape[0] - 1)
    src = (src_start.to(torch.int64)[row] + pos - offsets[row]).clamp(
        0, src_chars.shape[0] - 1)
    chars = torch.where(pos < offsets[-1], src_chars[src],
                        torch.zeros((), dtype=torch.uint8, device=device))
    return chars, offsets.to(torch.int32)


def _literal_bytes(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("utf-8"), dtype=np.uint8)


def is_literal(c: ColVal, capacity: int) -> bool:
    """A one-row string value (a literal) met by a batch of other rows."""
    return c.offsets.shape[0] == 2 and capacity != 1


def _pattern_bytes(pat) -> list:
    """A pattern's bytes: host ints from a numpy pattern, 0-dim device
    tensors from a literal's chars (read on the card: no sync)."""
    if isinstance(pat, torch.Tensor):
        return [pat[i] for i in range(pat.shape[0])]
    return pat.tolist()


def _prefix_ok(c: ColVal, pat, starts: torch.Tensor) -> torch.Tensor:
    """Per row: the ``len(pat)`` bytes from ``starts`` equal ``pat``
    (callers check the row is long enough)."""
    ccap = c.values.shape[0]
    ok = torch.ones(starts.shape[0], dtype=torch.bool,
                    device=c.values.device)
    if ccap == 0:
        return ok & (len(pat) == 0)
    starts = starts.to(torch.int64)
    for i, b in enumerate(_pattern_bytes(pat)):
        ok = ok & (c.values[(starts + i).clamp(0, ccap - 1)] == b)
    return ok


def _match_starts(c: ColVal, pat: np.ndarray, capacity: int):
    """(bool per byte position: ``pat`` starts here and fits in its row,
    byte->row map)."""
    ccap = c.values.shape[0]
    v = c.values
    m = torch.ones(ccap, dtype=torch.bool, device=v.device)
    for i, b in enumerate(pat.tolist()):
        if i >= ccap:
            m.zero_()
            break
        m[: ccap - i] &= v[i:] == b
        if i:
            m[ccap - i:] = False
    row = byte_to_row(c, capacity)
    pos = torch.arange(ccap, device=v.device)
    fits = pos + len(pat) <= c.offsets.to(torch.int64)[row + 1]
    return m & fits, row


def _row_any(flags: torch.Tensor, row: torch.Tensor,
             capacity: int) -> torch.Tensor:
    return torch.zeros(capacity, dtype=torch.int32,
                       device=flags.device).index_add_(
        0, row, flags.to(torch.int32)) > 0


def _row_min(vals: torch.Tensor, row: torch.Tensor, capacity: int,
             fill: int) -> torch.Tensor:
    out = torch.full((capacity,), fill, dtype=vals.dtype,
                     device=vals.device)
    return out.scatter_reduce_(0, row, vals, "amin")


# -------------------------------------------------------------- comparisons

def string_equal(l: ColVal, r: ColVal, ctx: EmitContext) -> torch.Tensor:
    """Per-row equality of two string values; either may be a literal.
    Returns bool values; nulls are the caller's validity."""
    l_lit = is_literal(l, ctx.capacity)
    r_lit = is_literal(r, ctx.capacity)
    if l_lit and not r_lit:
        return string_equal(r, l, ctx)
    if r_lit:
        ok = row_lengths(l) == r.values.shape[0]
        return ok & _prefix_ok(l, r.values, l.offsets[:-1])
    same_len = row_lengths(l) == row_lengths(r)
    ccap = l.values.shape[0]
    if ccap == 0 or r.values.shape[0] == 0:
        return same_len  # no bytes to compare on one side
    row = byte_to_row(l, ctx.capacity)
    pos = torch.arange(ccap, device=l.values.device)
    k = pos - l.offsets.to(torch.int64)[row]
    r_idx = (r.offsets.to(torch.int64)[row] + k).clamp(
        0, r.values.shape[0] - 1)
    total = l.offsets[ctx.capacity].to(torch.int64)
    byte_bad = (l.values != r.values[r_idx]) & (pos < total)
    return same_len & ~_row_any(byte_bad, row, ctx.capacity)


def _lex_vs_literal(l: ColVal, pat: torch.Tensor):
    """(has_diff, l_byte_lt, len_lt, len_le) of each row against a
    literal: the first differing byte within the shorter length decides,
    else the lengths."""
    lens = row_lengths(l).to(torch.int64)
    n = lens.shape[0]
    device = l.values.device
    starts = l.offsets[:-1].to(torch.int64)
    ccap = l.values.shape[0]
    has_diff = torch.zeros(n, dtype=torch.bool, device=device)
    byte_lt = torch.zeros(n, dtype=torch.bool, device=device)
    for i, b in enumerate(_pattern_bytes(pat)):
        if ccap == 0:
            break
        lb = l.values[(starts + i).clamp(0, ccap - 1)]
        differ = (i < lens) & (lb != b) & ~has_diff
        byte_lt = torch.where(differ, lb < b, byte_lt)
        has_diff = has_diff | differ
    n_pat = pat.shape[0]
    return has_diff, byte_lt, lens < n_pat, lens <= n_pat


def _lex_compare(l: ColVal, r: ColVal, ctx: EmitContext):
    """(has_diff, l_byte_lt, len_lt, len_le) of two string columns: one
    pass over l's chars finds each row's first differing byte; ties fall
    to the lengths.  UTF-8 byte order is code-point order, so this is
    Spark's string order."""
    cap = ctx.capacity
    len_l = row_lengths(l).to(torch.int64)
    len_r = row_lengths(r).to(torch.int64)
    device = l.values.device
    ccap, rcap = l.values.shape[0], r.values.shape[0]
    if ccap == 0 or rcap == 0:
        none = torch.zeros(cap, dtype=torch.bool, device=device)
        return none, none, len_l < len_r, len_l <= len_r
    loffs = l.offsets.to(torch.int64)
    roffs = r.offsets.to(torch.int64)
    minlen = torch.minimum(len_l, len_r)
    pos = torch.arange(ccap, device=device)
    row = byte_to_row(l, cap)
    k = pos - loffs[row]
    r_idx = (roffs[row] + k).clamp(0, rcap - 1)
    within = (k < minlen[row]) & (pos < loffs[cap])
    differ = within & (l.values != r.values[r_idx])
    first_k = _row_min(torch.where(differ, k, _BIG), row, cap, _BIG)
    has_diff = first_k < _BIG
    safe_k = torch.where(has_diff, first_k, 0)
    lb = l.values[(loffs[:-1] + safe_k).clamp(0, ccap - 1)]
    rb = r.values[(roffs[:-1] + safe_k).clamp(0, rcap - 1)]
    return has_diff, lb < rb, len_l < len_r, len_l <= len_r


def _compare(l: ColVal, r: ColVal, ctx: EmitContext, op: str
             ) -> torch.Tensor:
    """``l op r`` per row for op in lt, le, gt, ge."""
    l_lit = is_literal(l, ctx.capacity)
    r_lit = is_literal(r, ctx.capacity)
    if l_lit and not r_lit:
        flip = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}[op]
        return _compare(r, l, ctx, flip)
    if r_lit:
        has_diff, byte_lt, len_lt, len_le = _lex_vs_literal(l, r.values)
    else:
        has_diff, byte_lt, len_lt, len_le = _lex_compare(l, r, ctx)
    lt = torch.where(has_diff, byte_lt, len_lt)
    le = torch.where(has_diff, byte_lt, len_le)
    return {"lt": lt, "le": le, "gt": ~le, "ge": ~lt}[op]


def string_lt(l: ColVal, r: ColVal, ctx: EmitContext) -> torch.Tensor:
    return _compare(l, r, ctx, "lt")


def string_le(l: ColVal, r: ColVal, ctx: EmitContext) -> torch.Tensor:
    return _compare(l, r, ctx, "le")


def string_gt(l: ColVal, r: ColVal, ctx: EmitContext) -> torch.Tensor:
    return _compare(l, r, ctx, "gt")


def string_ge(l: ColVal, r: ColVal, ctx: EmitContext) -> torch.Tensor:
    return _compare(l, r, ctx, "ge")


# ------------------------------------------------------------- CASE / select

def _full(capacity: int, value: bool, device) -> torch.Tensor:
    return torch.full((capacity,), value, dtype=torch.bool, device=device)


def string_select(masks: Sequence[torch.Tensor],
                  branches: Sequence[ColVal], capacity: int,
                  device) -> ColVal:
    """CASE over string branches: per row, the first true mask picks its
    branch's string; no true mask gives null.  A branch is a full column
    (offsets of capacity + 1), a one-row literal, or a null literal
    (offsets None).  One pass: the chosen branch's (start, length) per row
    indexes the concatenation of every branch's chars."""
    nb = len(branches)
    idx = torch.full((capacity,), nb, dtype=torch.int64, device=device)
    for i in reversed(range(nb)):
        idx = torch.where(masks[i], i, idx)
    chosen = idx < nb
    safe = idx.clamp(0, max(nb - 1, 0))
    starts, lens, valids, chunks = [], [], [], []
    base = 0
    out_cap = 0
    lit_max = 0
    for b in branches:
        if b.offsets is None:  # null literal
            starts.append(torch.full((capacity,), base, dtype=torch.int64,
                                     device=device))
            lens.append(torch.zeros(capacity, dtype=torch.int64,
                                    device=device))
            valids.append(_full(capacity, False, device))
            continue
        ch = b.values
        chunks.append(ch)
        offs = b.offsets.to(torch.int64)
        if offs.shape[0] == capacity + 1:
            st, ln = offs[:-1], offs[1:] - offs[:-1]
            out_cap += int(ch.shape[0])
        else:
            st = torch.zeros(capacity, dtype=torch.int64, device=device)
            ln = offs[-1].expand(capacity)
            lit_max = max(lit_max, int(ch.shape[0]))
        starts.append(st + base)
        lens.append(ln)
        v = b.validity
        if v is None:
            valids.append(_full(capacity, True, device))
        elif v.dim() == 0 or v.shape[0] != capacity:
            valids.append(v.reshape(-1)[0].expand(capacity))
        else:
            valids.append(v)
        base += int(ch.shape[0])
    out_cap += lit_max * capacity
    all_chars = torch.cat(chunks) if chunks else \
        torch.zeros(0, dtype=torch.uint8, device=device)
    ar = torch.arange(capacity, device=device)
    row_start = torch.stack(starts)[safe, ar]
    validity = chosen & torch.stack(valids)[safe, ar]
    row_len = torch.where(validity, torch.stack(lens)[safe, ar], 0)
    chars, offsets = build_strings(row_len, row_start, all_chars, out_cap)
    return ColVal(dts.STRING, chars, validity, offsets)


# ---------------------------------------------------------------- predicates

class _PatternPredicate(Expression):
    """Base of the predicates with a literal pattern."""

    def __init__(self, child: Expression, pattern: str):
        self.children = (child,)
        self.pattern = pattern

    @property
    def child(self):
        return self.children[0]

    def with_children(self, children):
        return type(self)(children[0], self.pattern)

    @property
    def dtype(self):
        return dts.BOOL

    def cache_key(self):
        return (type(self).__name__, self.pattern, self.child.cache_key())

    def __str__(self):
        return f"{type(self).__name__}({self.child}, {self.pattern!r})"


class EqualsLiteral(_PatternPredicate):
    def emit(self, ctx: EmitContext) -> ColVal:
        c = self.child.emit(ctx)
        pat = _literal_bytes(self.pattern)
        ok = (row_lengths(c) == len(pat)) & \
            _prefix_ok(c, pat, c.offsets[:-1])
        return ColVal(dts.BOOL, ok, c.validity)


class StartsWith(_PatternPredicate):
    def emit(self, ctx: EmitContext) -> ColVal:
        c = self.child.emit(ctx)
        pat = _literal_bytes(self.pattern)
        ok = (row_lengths(c) >= len(pat)) & \
            _prefix_ok(c, pat, c.offsets[:-1])
        return ColVal(dts.BOOL, ok, c.validity)


class EndsWith(_PatternPredicate):
    def emit(self, ctx: EmitContext) -> ColVal:
        c = self.child.emit(ctx)
        pat = _literal_bytes(self.pattern)
        ok = (row_lengths(c) >= len(pat)) & \
            _prefix_ok(c, pat, c.offsets[1:].to(torch.int64) - len(pat))
        return ColVal(dts.BOOL, ok, c.validity)


class Contains(_PatternPredicate):
    def emit(self, ctx: EmitContext) -> ColVal:
        c = self.child.emit(ctx)
        pat = _literal_bytes(self.pattern)
        if len(pat) == 0:
            return ColVal(dts.BOOL, _full(ctx.capacity, True, ctx.device),
                          c.validity)
        m, row = _match_starts(c, pat, ctx.capacity)
        return ColVal(dts.BOOL, _row_any(m, row, ctx.capacity), c.validity)


class Like(_PatternPredicate):
    """SQL LIKE with ``%`` wildcards.  A pattern with ``_`` is not ported
    and raises.  One-wildcard forms become prefix, suffix and infix tests;
    any other runs the ordered-segment match: per segment, the earliest
    match at or after the previous segment's end (``scatter_reduce``
    minimum over the byte->row map)."""

    def __init__(self, child: Expression, pattern: str):
        super().__init__(child, pattern)
        self._plan = self._compile(pattern)

    @staticmethod
    def _compile(p: str):
        if "_" in p:
            return None
        parts = p.split("%")
        if "%" not in p:
            return ("exact", p)
        if set(p) == {"%"}:
            return ("any",)
        inner = [s for s in parts if s]
        if p.startswith("%") and p.endswith("%") and len(inner) == 1:
            return ("contains", inner[0])
        if p.endswith("%") and not p.startswith("%") and len(inner) == 1:
            return ("prefix", inner[0])
        if p.startswith("%") and not p.endswith("%") and len(inner) == 1:
            return ("suffix", inner[0])
        if not p.startswith("%") and not p.endswith("%") and \
                len(inner) == 2 and len(parts) == 2:
            return ("prefix_suffix", inner[0], inner[1])
        return ("general", not p.startswith("%"), not p.endswith("%"),
                tuple(inner))

    def emit(self, ctx: EmitContext) -> ColVal:
        plan = self._plan
        if plan is None:
            raise NotImplementedError(
                f"LIKE pattern {self.pattern!r}: '_' is not ported")
        kind = plan[0]
        if kind == "any":
            c = self.child.emit(ctx)
            return ColVal(dts.BOOL, _full(ctx.capacity, True, ctx.device),
                          c.validity)
        if kind == "exact":
            return EqualsLiteral(self.child, plan[1]).emit(ctx)
        if kind == "contains":
            return Contains(self.child, plan[1]).emit(ctx)
        if kind == "prefix":
            return StartsWith(self.child, plan[1]).emit(ctx)
        if kind == "suffix":
            return EndsWith(self.child, plan[1]).emit(ctx)
        c = self.child.emit(ctx)
        if kind == "prefix_suffix":
            pre = StartsWith(self.child, plan[1]).emit(ctx)
            suf = EndsWith(self.child, plan[2]).emit(ctx)
            long_enough = row_lengths(c) >= (len(_literal_bytes(plan[1])) +
                                             len(_literal_bytes(plan[2])))
            return ColVal(dts.BOOL, pre.values & suf.values & long_enough,
                          c.validity)
        _, anchor_start, anchor_end, segments = plan
        ccap = c.values.shape[0]
        offs = c.offsets.to(torch.int64)
        ok = _full(ctx.capacity, True, ctx.device)
        cur = offs[:-1].clone()  # earliest start of the next segment
        segs = list(segments)
        if anchor_start and segs:
            ok = ok & StartsWith(self.child, segs[0]).emit(ctx).values
            cur = cur + len(_literal_bytes(segs[0]))
            segs = segs[1:]
        last = None
        if anchor_end and segs:
            last, segs = segs[-1], segs[:-1]
        pos = torch.arange(ccap, device=ctx.device)
        for seg in segs:
            pat = _literal_bytes(seg)
            m, row = _match_starts(c, pat, ctx.capacity)
            eligible = m & (pos >= cur[row])
            first = _row_min(torch.where(eligible, pos, _BIG), row,
                             ctx.capacity, _BIG)
            found = first < _BIG
            ok = ok & found
            cur = torch.where(found, first + len(pat), cur)
        if last is not None:
            pat = _literal_bytes(last)
            ok = ok & EndsWith(self.child, last).emit(ctx).values
            ok = ok & (offs[1:] - len(pat) >= cur)
        return ColVal(dts.BOOL, ok, c.validity)


# ----------------------------------------------------------------- producers

class Substring(Expression):
    """substring(str, pos, len): 1-based character position over UTF-8
    (Spark: pos 0 reads as 1, a negative pos counts from the end)."""

    def __init__(self, child: Expression, pos: int,
                 length: int = 2**31 - 1):
        self.children = (child,)
        self.pos = pos
        self.length = length

    @property
    def child(self):
        return self.children[0]

    def with_children(self, children):
        return Substring(children[0], self.pos, self.length)

    @property
    def dtype(self):
        return dts.STRING

    def emit(self, ctx: EmitContext) -> ColVal:
        c = self.child.emit(ctx)
        if is_literal(c, ctx.capacity):
            raise NotImplementedError("substring of a string literal")
        prefix = _char_prefix(c)
        offs = c.offsets.to(torch.int64)
        nchars = prefix[offs[1:]] - prefix[offs[:-1]]
        if self.pos >= 0:
            start_char = torch.full_like(nchars, max(self.pos - 1, 0))
        else:
            start_char = (nchars + self.pos).clamp(min=0)
        end_char = torch.minimum(start_char + max(self.length, 0), nchars)
        start_char = torch.minimum(start_char, nchars)
        # byte position of a row's k-th character: the first byte whose
        # character prefix passes the row's base count plus k
        base = prefix[offs[:-1]]
        starts = prefix[1:]
        start_byte = torch.searchsorted(starts, base + start_char + 1)
        end_byte = torch.searchsorted(starts, base + end_char + 1)
        start_byte = torch.minimum(torch.maximum(start_byte, offs[:-1]),
                                   offs[1:])
        end_byte = torch.minimum(torch.maximum(end_byte, start_byte),
                                 offs[1:])
        chars, offsets = build_strings(end_byte - start_byte, start_byte,
                                       c.values, int(c.values.shape[0]))
        return ColVal(dts.STRING, chars, c.validity, offsets)

    def cache_key(self):
        return ("Substring", self.pos, self.length, self.child.cache_key())

    def __str__(self):
        return f"substring({self.child}, {self.pos}, {self.length})"


def string_literal_column(c: ColVal, capacity: int) -> ColVal:
    """A one-row string literal repeated over ``capacity`` rows."""
    n = int(c.values.shape[0])
    device = c.values.device
    offsets = torch.arange(capacity + 1, device=device,
                           dtype=torch.int64) * n
    chars = c.values.repeat(capacity)
    validity = c.validity
    if validity is not None:
        validity = validity.reshape(-1)[0].expand(capacity)
    return ColVal(dts.STRING, chars, validity, offsets.to(torch.int32))

