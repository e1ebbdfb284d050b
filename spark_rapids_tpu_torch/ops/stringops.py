"""String expressions over the chars+offsets layout.

Counterpart of ``spark_rapids_tpu/ops/stringops.py``: the layout helpers
(``row_lengths``, ``char_lengths``, ``byte_to_row``, ``build_strings``),
equality and ordering comparisons, ``StartsWith``/``EndsWith``/
``Contains``, ``Like`` with every plan of its pattern compiler,
``Substring`` by 1-based UTF-8 character position, ``string_select``
(CASE and COALESCE with string results), ``Length``/``OctetLength``,
``StringLocate``, ``Upper``/``Lower``/``InitCap`` (ASCII case mapping,
tagged incompatible as in the JAX package), the trim family,
``ConcatStrings``, ``StringRepeat``, ``StringLPad``/``StringRPad``,
``SubstringIndex``, ``Ascii``/``Chr``, and the casts between strings and
the integral, float, boolean, date and timestamp types (``cast_string``).

Every function is vector ops over the flat uint8 chars buffer plus the
int32 row offsets, as in the JAX package.  A pattern test shifts the chars
buffer by slicing instead of gathering, and a match may not cross a row
boundary (``match_mask``).  Per-row answers (the first match at or after a
position, a row's k-th character, its first and last non-space byte) are
``searchsorted`` queries, one per row, over byte-level prefix counts, so
no byte->row map is built for them.  A producer computes its output
lengths first and maps every output byte back to a source byte
(``build_segments``: ``cumsum`` and ``searchsorted``).  Output char
buffers are sized from host-known bounds (the input's chars, a literal's
length times the rows); a producer whose bound exceeds the bytes its
inputs already hold (``repeat``, the pads, ``concat`` with literals)
fetches its exact total instead, one counted host sync per batch.

Where the JAX package departs from Spark the port keeps Spark's answer
(recorded in ``ROADMAP.md`` queue 3): ``lpad``/``rpad`` count characters,
not bytes, and an empty pad leaves a short string as it is;
``locate(substr, str, pos)`` honours ``pos`` from SQL; string -> number
casts trim whitespace, read a fraction into an integer by truncation,
accept exponents and Java's special literals, and give null on overflow.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops.expressions import (
    ColVal, EmitContext, Expression, UnaryExpression, combine_validity)

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
            end_char = start_char + max(self.length, 0)
        else:
            # Spark's substringSQL: the window [len + pos, len + pos +
            # length) is cut at 0 only after it is placed, so a pos
            # before the start eats into the length
            raw = nchars + self.pos
            start_char = raw.clamp(min=0)
            end_char = raw + max(self.length, 0)
        end_char = torch.minimum(torch.maximum(end_char, start_char), nchars)
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



# ------------------------------------------------- per-row search helpers

def as_column(c: ColVal, capacity: int) -> ColVal:
    """A string value as a full column (a literal repeats over the
    rows)."""
    if is_literal(c, capacity):
        return string_literal_column(c, capacity)
    return c


def _prefix_count(flags: torch.Tensor) -> torch.Tensor:
    """int64[n + 1]: the flags set before each position."""
    out = torch.zeros(flags.shape[0] + 1, dtype=torch.int64,
                      device=flags.device)
    torch.cumsum(flags.to(torch.int64), 0, out=out[1:])
    return out


def first_flag_from(prefix: torch.Tensor, start: torch.Tensor
                    ) -> torch.Tensor:
    """Per query, the first flagged position at or after ``start`` (the
    buffer's length when there is none)."""
    return torch.searchsorted(prefix, prefix[start] + 1) - 1


def last_flag_before(prefix: torch.Tensor, end: torch.Tensor
                     ) -> torch.Tensor:
    """Per query, the last flagged position before ``end`` (-1 when there
    is none; callers compare it with the row's start)."""
    return torch.searchsorted(prefix, prefix[end]) - 1


def _boundaries(c: ColVal) -> torch.Tensor:
    """bool[nchars + 1]: True at every row offset."""
    b = torch.zeros(c.values.shape[0] + 1, dtype=torch.bool,
                    device=c.values.device)
    b[c.offsets.to(torch.int64)] = True
    return b


def atom_hits(v: torch.Tensor, atom) -> torch.Tensor:
    """bool per byte: ``atom`` (a byte, None for any byte, or a list of
    inclusive (lo, hi) byte ranges) accepts it."""
    if atom is None:
        return torch.ones(v.shape, dtype=torch.bool, device=v.device)
    if isinstance(atom, int):
        return v == atom
    out = None
    for lo, hi in atom:
        t = v == lo if lo == hi else (v >= lo) & (v <= hi)
        out = t if out is None else out | t
    if out is None:
        return torch.zeros(v.shape, dtype=torch.bool, device=v.device)
    return out


def match_mask(c: ColVal, atoms, capacity: int) -> torch.Tensor:
    """bool per byte position: the atom sequence matches from here and
    ends within the same row (no row offset strictly inside the match,
    none past the last row's end)."""
    v = c.values
    ccap = v.shape[0]
    n = len(atoms)
    m = torch.zeros(ccap, dtype=torch.bool, device=v.device)
    if n == 0 or ccap < n:
        return m
    span = ccap - n + 1
    head = atom_hits(v[:span], atoms[0])
    for i in range(1, n):
        head = head & atom_hits(v[i:span + i], atoms[i])
    if n > 1:
        b = _boundaries(c)
        for i in range(1, n):
            head = head & ~b[i:span + i]
    m[:span] = head
    pos = torch.arange(ccap, device=v.device)
    return m & (pos + n <= c.offsets[capacity].to(torch.int64))


def literal_atoms(text: str) -> list:
    return [int(b) for b in text.encode("utf-8")]


def char_byte(prefix: torch.Tensor, starts: torch.Tensor,
              ends: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Byte position of each row's ``k``-th character (0-based; the row's
    end past its last character).  ``prefix`` is ``_char_prefix``."""
    pos = torch.searchsorted(prefix[1:], prefix[starts] + k + 1)
    return torch.minimum(torch.maximum(pos, starts), ends)


def _row_bounds(c: ColVal):
    offs = c.offsets.to(torch.int64)
    return offs[:-1], offs[1:]


def out_size(total: torch.Tensor, bound: int, held: int) -> int:
    """Chars to allocate for a producer's output: the host-known
    ``bound`` when it is no more than the ``held`` bytes its inputs
    already take, else the exact ``total`` (one counted sync)."""
    if bound <= held:
        return bound
    from spark_rapids_tpu_torch.utils import hostsync
    return int(hostsync.fetch(total))


def build_segments(segments, pool: torch.Tensor, bound: int, held: int,
                   capacity: int):
    """(chars, int32 offsets) of rows that are each a sequence of
    segments.  A segment is ``(lengths, starts, period)``: per row its
    byte count and its first byte in ``pool``; with a ``period`` (per row)
    its bytes cycle through the ``period`` bytes from ``starts``."""
    device = pool.device
    total = torch.zeros(capacity, dtype=torch.int64, device=device)
    segs = []
    for lengths, starts, period in segments:
        lengths = lengths.clamp(min=0).to(torch.int64)
        segs.append((lengths, starts.to(torch.int64), period))
        total = total + lengths
    offsets = torch.zeros(capacity + 1, dtype=torch.int64, device=device)
    torch.cumsum(total, 0, out=offsets[1:])
    cap = out_size(offsets[-1], bound, held)
    if cap == 0 or pool.shape[0] == 0 or capacity == 0:
        return (torch.zeros(cap, dtype=torch.uint8, device=device),
                offsets.to(torch.int32))
    pos = torch.arange(cap, device=device)
    row = (torch.searchsorted(offsets, pos, right=True) - 1).clamp(
        0, capacity - 1)
    k = pos - offsets[row]
    src = torch.zeros(cap, dtype=torch.int64, device=device)
    acc = torch.zeros(capacity, dtype=torch.int64, device=device)
    for lengths, starts, period in segs:
        rel = k - acc[row]
        inside = (rel >= 0) & (rel < lengths[row])
        if period is not None:
            rel = torch.remainder(rel, period.to(torch.int64).clamp(
                min=1)[row])
        src = torch.where(inside, starts[row] + rel, src)
        acc = acc + lengths
    chars = torch.where(pos < offsets[-1],
                        pool[src.clamp(0, pool.shape[0] - 1)],
                        torch.zeros((), dtype=torch.uint8, device=device))
    return chars, offsets.to(torch.int32)


def _validity_of(c: ColVal, capacity: int):
    v = c.validity
    if v is not None and v.dim() == 0:
        v = v.expand(capacity)
    return v


# ------------------------------------------------------------ row scalars

class _StringUnary(UnaryExpression):
    """A function of one string column (a literal repeats over the
    rows)."""

    def child_column(self, ctx: EmitContext) -> ColVal:
        c = as_column(self.child.emit(ctx), ctx.capacity)
        return ColVal(c.dtype, c.values, _validity_of(c, ctx.capacity),
                      c.offsets)


class Length(_StringUnary):
    """Spark length(): UTF-8 characters."""

    @property
    def dtype(self):
        return dts.INT32

    def emit(self, ctx: EmitContext) -> ColVal:
        c = self.child_column(ctx)
        return ColVal(dts.INT32, char_lengths(c).to(torch.int32),
                      c.validity)


class OctetLength(_StringUnary):
    @property
    def dtype(self):
        return dts.INT32

    def emit(self, ctx: EmitContext) -> ColVal:
        c = self.child_column(ctx)
        return ColVal(dts.INT32, row_lengths(c).to(torch.int32), c.validity)


class Ascii(_StringUnary):
    """Code point of the first character (0 for the empty string)."""

    @property
    def dtype(self):
        return dts.INT32

    def emit(self, ctx: EmitContext) -> ColVal:
        c = self.child_column(ctx)
        starts, ends = _row_bounds(c)
        nbytes = c.values.shape[0]
        if nbytes == 0:
            return ColVal(dts.INT32, torch.zeros(
                ctx.capacity, dtype=torch.int32, device=ctx.device),
                c.validity)

        def byte(k):
            return c.values[(starts + k).clamp(0, nbytes - 1)].to(
                torch.int32)
        b0, b1, b2, b3 = byte(0), byte(1), byte(2), byte(3)
        cp = torch.where(
            b0 < 0x80, b0, torch.where(
                b0 < 0xE0, ((b0 & 0x1F) << 6) | (b1 & 0x3F),
                torch.where(
                    b0 < 0xF0, ((b0 & 0x0F) << 12) | ((b1 & 0x3F) << 6)
                    | (b2 & 0x3F),
                    ((b0 & 0x07) << 18) | ((b1 & 0x3F) << 12)
                    | ((b2 & 0x3F) << 6) | (b3 & 0x3F))))
        return ColVal(dts.INT32, torch.where(ends > starts, cp, 0),
                      c.validity)


class Chr(UnaryExpression):
    """chr(n): the character of code point ``n mod 256`` (128-255 as two
    UTF-8 bytes); a negative ``n`` gives the empty string."""

    @property
    def dtype(self):
        return dts.STRING

    def emit(self, ctx: EmitContext) -> ColVal:
        c = self.child.emit(ctx)
        cap = ctx.capacity
        n = c.values.to(torch.int64)
        if n.dim() == 0:
            n = n.expand(cap)
        b = torch.remainder(n, 256)
        lens = torch.where(n < 0, 0, torch.where(b < 128, 1, 2))
        first = torch.where(b < 128, b, 0xC0 | (b >> 6)).to(torch.uint8)
        second = (0x80 | (b & 0x3F)).to(torch.uint8)
        pool = torch.stack([first, second], dim=1).reshape(-1)
        starts = torch.arange(cap, device=ctx.device) * 2
        chars, offsets = build_segments([(lens, starts, None)], pool,
                                        2 * cap, 2 * cap, cap)
        return ColVal(dts.STRING, chars, _validity_of(c, cap), offsets)


class StringLocate(Expression):
    """locate(substr, str[, pos]): the 1-based character position of the
    first ``substr`` at or after character ``pos``; 0 when there is none
    or ``pos`` < 1; an empty ``substr`` is found at 1 (Spark's
    ``UTF8String.indexOf``)."""

    def __init__(self, substr: str, child: Expression, start: int = 1):
        self.children = (child,)
        self.substr = substr
        self.start = int(start)

    @property
    def child(self):
        return self.children[0]

    def with_children(self, children):
        return StringLocate(self.substr, children[0], self.start)

    @property
    def dtype(self):
        return dts.INT32

    def cache_key(self):
        return ("StringLocate", self.substr, self.start,
                self.child.cache_key())

    def __str__(self):
        return f"locate({self.substr!r}, {self.child}, {self.start})"

    def emit(self, ctx: EmitContext) -> ColVal:
        c = as_column(self.child.emit(ctx), ctx.capacity)
        validity = _validity_of(c, ctx.capacity)
        cap = ctx.capacity
        if self.start < 1 or not self.substr:
            value = 0 if self.start < 1 else 1
            return ColVal(dts.INT32, torch.full(
                (cap,), value, dtype=torch.int32, device=ctx.device),
                validity)
        m = match_mask(c, literal_atoms(self.substr), cap)
        starts, ends = _row_bounds(c)
        chars = _char_prefix(c)
        from_byte = char_byte(chars, starts, ends,
                              torch.full_like(starts, self.start - 1))
        first = first_flag_from(_prefix_count(m), from_byte)
        found = first < ends
        safe = torch.where(found, first, starts)
        pos = chars[safe] - chars[starts] + 1
        return ColVal(dts.INT32, torch.where(found, pos, 0).to(torch.int32),
                      validity)


# ----------------------------------------------------------- case mapping

def _is_upper(v):
    return (v >= 65) & (v <= 90)


def _is_lower(v):
    return (v >= 97) & (v <= 122)


class Upper(_StringUnary):
    """upper(): ASCII letters only (tagged incompatible)."""

    @property
    def dtype(self):
        return dts.STRING

    def emit(self, ctx: EmitContext) -> ColVal:
        c = self.child_column(ctx)
        v = c.values
        return ColVal(dts.STRING, torch.where(_is_lower(v), v - 32, v),
                      c.validity, c.offsets)


class Lower(_StringUnary):
    """lower(): ASCII letters only (tagged incompatible)."""

    @property
    def dtype(self):
        return dts.STRING

    def emit(self, ctx: EmitContext) -> ColVal:
        c = self.child_column(ctx)
        v = c.values
        return ColVal(dts.STRING, torch.where(_is_upper(v), v + 32, v),
                      c.validity, c.offsets)


class InitCap(_StringUnary):
    """initcap(): each letter after a space or at the row's start upper,
    every other letter lower (ASCII, tagged incompatible)."""

    @property
    def dtype(self):
        return dts.STRING

    def emit(self, ctx: EmitContext) -> ColVal:
        c = self.child_column(ctx)
        v = c.values
        if v.shape[0] == 0:
            return c
        prev_space = torch.cat([torch.ones(1, dtype=torch.bool,
                                           device=v.device), v[:-1] == 32])
        word_start = prev_space | _boundaries(c)[:-1]
        out = torch.where(word_start & _is_lower(v), v - 32,
                          torch.where(~word_start & _is_upper(v), v + 32,
                                      v))
        return ColVal(dts.STRING, out, c.validity, c.offsets)


# ---------------------------------------------------------------- trimming

class _TrimBase(_StringUnary):
    """trim / ltrim / rtrim of spaces (0x20), Spark's default."""

    trim_left = True
    trim_right = True

    @property
    def dtype(self):
        return dts.STRING

    def emit(self, ctx: EmitContext) -> ColVal:
        c = self.child_column(ctx)
        starts, ends = _row_bounds(c)
        prefix = _prefix_count(c.values != 32)
        start, end = starts, ends
        if self.trim_left:
            start = torch.minimum(first_flag_from(prefix, starts), ends)
        if self.trim_right:
            last = last_flag_before(prefix, ends)
            end = torch.where(last >= start, last + 1, start)
        nbytes = int(c.values.shape[0])
        chars, offsets = build_segments([(end - start, start, None)],
                                        c.values, nbytes, nbytes,
                                        ctx.capacity)
        return ColVal(dts.STRING, chars, c.validity, offsets)


class StringTrim(_TrimBase):
    pass


class StringTrimLeft(_TrimBase):
    trim_right = False


class StringTrimRight(_TrimBase):
    trim_left = False


# ---------------------------------------------------------------- producers

def _pool(cols):
    """The chars of ``cols`` end to end, and each one's base in it."""
    bases, base = [], 0
    for c in cols:
        bases.append(base)
        base += int(c.values.shape[0])
    device = cols[0].values.device
    pool = torch.cat([c.values for c in cols]) if cols else \
        torch.zeros(0, dtype=torch.uint8, device=device)
    return pool, bases


class ConcatStrings(Expression):
    """concat(s1, s2, ...): null when any input is null."""

    def __init__(self, *children: Expression):
        self.children = tuple(children)

    def with_children(self, children):
        return ConcatStrings(*children)

    @property
    def dtype(self):
        return dts.STRING

    def emit(self, ctx: EmitContext) -> ColVal:
        cap = ctx.capacity
        raw = [c.emit(ctx) for c in self.children]
        held = sum(int(c.values.shape[0]) for c in raw)
        cols = [as_column(c, cap) for c in raw]
        pool, bases = _pool(cols)
        segs = []
        for c, base in zip(cols, bases):
            starts, ends = _row_bounds(c)
            segs.append((ends - starts, starts + base, None))
        chars, offsets = build_segments(segs, pool, int(pool.shape[0]),
                                        held, cap)
        validity = combine_validity(*[_validity_of(c, cap) for c in cols])
        return ColVal(dts.STRING, chars, validity, offsets)


class StringRepeat(Expression):
    """repeat(s, n): ``s`` n times (empty for n <= 0)."""

    def __init__(self, child: Expression, times: int):
        self.children = (child,)
        self.times = max(int(times), 0)

    @property
    def child(self):
        return self.children[0]

    def with_children(self, children):
        return StringRepeat(children[0], self.times)

    @property
    def dtype(self):
        return dts.STRING

    def cache_key(self):
        return ("StringRepeat", self.times, self.child.cache_key())

    def emit(self, ctx: EmitContext) -> ColVal:
        raw = self.child.emit(ctx)
        c = as_column(raw, ctx.capacity)
        starts, ends = _row_bounds(c)
        lens = ends - starts
        nbytes = int(c.values.shape[0])
        chars, offsets = build_segments(
            [(lens * self.times, starts, lens)], c.values,
            nbytes * self.times, int(raw.values.shape[0]), ctx.capacity)
        return ColVal(dts.STRING, chars, _validity_of(c, ctx.capacity),
                      offsets)


class _PadBase(Expression):
    """lpad / rpad to ``width`` characters: a longer string is cut to its
    first ``width`` characters; a shorter one is padded with ``pad``
    repeated (an empty pad leaves it as it is)."""

    left = True

    def __init__(self, child: Expression, width: int, pad: str = " "):
        self.children = (child,)
        self.width = int(width)
        self.pad = pad

    @property
    def child(self):
        return self.children[0]

    def with_children(self, children):
        return type(self)(children[0], self.width, self.pad)

    @property
    def dtype(self):
        return dts.STRING

    def cache_key(self):
        return (type(self).__name__, self.width, self.pad,
                self.child.cache_key())

    def emit(self, ctx: EmitContext) -> ColVal:
        raw = self.child.emit(ctx)
        c = as_column(raw, ctx.capacity)
        cap = ctx.capacity
        width = max(self.width, 0)
        starts, ends = _row_bounds(c)
        chars_prefix = _char_prefix(c)
        nch = chars_prefix[ends] - chars_prefix[starts]
        keep_end = char_byte(chars_prefix, starts, ends,
                             torch.clamp(nch, max=width))
        pad = self.pad.encode("utf-8")
        pad_chars = torch.clamp(width - nch, min=0)
        nbytes = int(c.values.shape[0])
        segs = [(keep_end - starts, starts, None)]
        if pad:
            # byte offset of each of the pad's characters
            text = self.pad
            char_off = [0]
            for ch in text:
                char_off.append(char_off[-1] + len(ch.encode("utf-8")))
            table = torch.tensor(char_off, dtype=torch.int64,
                                 device=ctx.device)
            pad_bytes = torch.div(pad_chars, len(text),
                                  rounding_mode="floor") * len(pad) + \
                table[torch.remainder(pad_chars, len(text))]
            base = torch.full_like(starts, nbytes)
            pad_seg = (pad_bytes, base, torch.full_like(starts, len(pad)))
            segs = [pad_seg] + segs if self.left else segs + [pad_seg]
            pool = torch.cat([c.values, torch.from_numpy(
                np.frombuffer(pad, dtype=np.uint8).copy()).to(ctx.device)])
        else:
            pool = c.values
        bound = nbytes + (width * len(pad) * cap if pad else 0)
        chars, offsets = build_segments(segs, pool, bound,
                                        int(raw.values.shape[0]), cap)
        return ColVal(dts.STRING, chars, _validity_of(c, cap), offsets)


class StringLPad(_PadBase):
    left = True


class StringRPad(_PadBase):
    left = False


class SubstringIndex(Expression):
    """substring_index(str, delim, count): the part before the count-th
    delimiter from the left (count > 0) or after the count-th from the
    right (count < 0); occurrences may overlap, as Spark's search steps
    one byte past each; empty for count 0 or an empty delimiter."""

    def __init__(self, child: Expression, delim: str, count: int):
        self.children = (child,)
        self.delim = delim
        self.count = int(count)

    @property
    def child(self):
        return self.children[0]

    def with_children(self, children):
        return SubstringIndex(children[0], self.delim, self.count)

    @property
    def dtype(self):
        return dts.STRING

    def cache_key(self):
        return ("SubstringIndex", self.delim, self.count,
                self.child.cache_key())

    def emit(self, ctx: EmitContext) -> ColVal:
        c = as_column(self.child.emit(ctx), ctx.capacity)
        starts, ends = _row_bounds(c)
        nbytes = int(c.values.shape[0])
        if self.count == 0 or not self.delim:
            start, end = starts, starts
        else:
            d = literal_atoms(self.delim)
            prefix = _prefix_count(match_mask(c, d, ctx.capacity))
            base = prefix[starts]
            total = prefix[ends] - base
            want = abs(self.count)
            if self.count > 0:
                nth = torch.searchsorted(prefix, base + want) - 1
                start = starts
                end = torch.where(total >= want, nth, ends)
            else:
                nth = torch.searchsorted(
                    prefix, base + (total - want + 1).clamp(min=1)) - 1
                start = torch.where(total >= want,
                                    torch.minimum(nth + len(d), ends),
                                    starts)
                end = ends
        chars, offsets = build_segments([(end - start, start, None)],
                                        c.values, nbytes, nbytes,
                                        ctx.capacity)
        return ColVal(dts.STRING, chars, _validity_of(c, ctx.capacity),
                      offsets)


# -------------------------------------------------------------------- casts

def cast_string(c: ColVal, target: DataType, ctx: EmitContext) -> ColVal:
    """A cast from or to a string (``ops/cast.cast_supported`` says which
    run here)."""
    if c.dtype.is_string:
        c = as_column(c, ctx.capacity)
        c = ColVal(c.dtype, c.values, _validity_of(c, ctx.capacity),
                   c.offsets)
        if target.is_integral:
            return _parse_integral(c, target, ctx)
        if target.is_floating:
            return _parse_float(c, target, ctx)
        if target.is_date:
            return _parse_date(c, ctx)
        if target.is_timestamp:
            return _parse_timestamp(c, ctx)
        if target.is_boolean:
            return _parse_bool(c, ctx)
    elif target.is_string:
        v = c.values
        if v.dim() == 0:
            c = ColVal(c.dtype, v.expand(ctx.capacity),
                       _validity_of(c, ctx.capacity))
        if c.dtype.is_boolean:
            return _format_bool(c, ctx)
        if c.dtype.is_integral:
            return _format_int(c, ctx)
        if c.dtype.is_date:
            return _format_date(c, ctx)
        if c.dtype.is_timestamp:
            return _format_timestamp(c, ctx)
    raise NotImplementedError(f"cast {c.dtype} -> {target} on the device")


# the longest trimmed string the number parsers read (a longer one is null)
MAX_NUMBER_BYTES = 40


def _trimmed(c: ColVal):
    """Each row's bounds with whitespace and control bytes (<= 0x20)
    trimmed from both ends, as Spark's casts trim."""
    starts, ends = _row_bounds(c)
    prefix = _prefix_count(c.values > 0x20)
    start = torch.minimum(first_flag_from(prefix, starts), ends)
    last = last_flag_before(prefix, ends)
    end = torch.where(last >= start, last + 1, start)
    return start, end


def _number_width(lens: torch.Tensor) -> int:
    """Bytes the number parsers read: the longest trimmed row, at most
    ``MAX_NUMBER_BYTES`` (one counted fetch)."""
    from spark_rapids_tpu_torch.utils import hostsync
    if lens.shape[0] == 0:
        return 1
    longest = int(hostsync.fetch(lens.max()))
    return max(1, min(longest, MAX_NUMBER_BYTES))


def _window(c: ColVal, start: torch.Tensor, lens: torch.Tensor,
            width: int) -> torch.Tensor:
    """[rows, width] int64 of each row's bytes from ``start`` (0 past its
    length)."""
    nbytes = c.values.shape[0]
    j = torch.arange(width, device=c.values.device)
    if nbytes == 0:
        return torch.zeros((start.shape[0], width), dtype=torch.int64,
                           device=c.values.device)
    idx = (start[:, None] + j[None, :]).clamp(0, nbytes - 1)
    win = c.values[idx].to(torch.int64)
    return torch.where(j[None, :] < lens[:, None], win, 0)


def _lower_ascii(win: torch.Tensor) -> torch.Tensor:
    return torch.where((win >= 65) & (win <= 90), win + 32, win)


def _equals_word(win, lens, word: str) -> torch.Tensor:
    ok = lens == len(word)
    for i, ch in enumerate(word.encode("ascii")):
        if i >= win.shape[1]:
            return torch.zeros_like(ok)
        ok = ok & (win[:, i] == ch)
    return ok


_INT_LIMITS = {"tinyint": (-(1 << 7), (1 << 7) - 1),
               "smallint": (-(1 << 15), (1 << 15) - 1),
               "int": (-(1 << 31), (1 << 31) - 1),
               "bigint": (-(1 << 63), (1 << 63) - 1)}


def _parse_integral(c: ColVal, target: DataType, ctx) -> ColVal:
    """Spark's non-ANSI string -> integral (``UTF8String.toLong``): an
    optional sign, digits, and an optional '.' whose digits are dropped;
    anything else, or a value outside the type, is null."""
    start, end = _trimmed(c)
    lens = end - start
    W = _number_width(lens)
    win = _window(c, start, lens, W)
    first = win[:, 0]
    neg = first == 45
    signed = neg | (first == 43)
    ok = (lens > 0) & (lens <= MAX_NUMBER_BYTES) & ~(signed & (lens == 1))
    minv = -(1 << 63)
    stop = -(-minv // 10)          # Long.MIN_VALUE / 10, toward zero
    acc = torch.zeros(win.shape[0], dtype=torch.int64, device=win.device)
    in_frac = torch.zeros_like(ok)
    for j in range(W):
        ch = win[:, j]
        active = (j < lens) & ~(signed & (j == 0))
        digit = (ch >= 48) & (ch <= 57)
        dot = (ch == 46) & ~in_frac
        d = ch - 48
        # an integer digit: acc = acc * 10 - d, null past the int64 range
        take = active & digit & ~in_frac
        ok = ok & ~(take & (acc < stop))
        a10 = torch.where(take & (acc >= stop), acc * 10, acc)
        ok = ok & ~(take & (a10 < minv + d))
        acc = torch.where(take & ok, a10 - d, acc)
        ok = ok & ~(active & ~digit & ~dot)
        in_frac = in_frac | (active & dot)
    # the accumulator holds minus the magnitude (Java's trick)
    ok = ok & (neg | (acc != minv))
    val = torch.where(neg, acc, -acc)
    lo, hi = _INT_LIMITS[target.name]
    ok = ok & (val >= lo) & (val <= hi)
    return ColVal(target, torch.where(ok, val, 0).to(
        dts.torch_dtype(target)), combine_validity(c.validity, ok))


# the float parser's states (a Java ``Double.parseDouble`` literal)
_F_START, _F_SIGN, _F_INT, _F_DOT, _F_LDOT, _F_FRAC, _F_E, _F_ESIGN, \
    _F_EXP, _F_SUFFIX, _F_BAD = range(11)
# classes: 0 digit, 1 sign, 2 dot, 3 e/E, 4 d/D/f/F, 5 other
_F_NEXT = [
    [_F_INT, _F_SIGN, _F_LDOT, _F_BAD, _F_BAD, _F_BAD],      # start
    [_F_INT, _F_BAD, _F_LDOT, _F_BAD, _F_BAD, _F_BAD],       # sign
    [_F_INT, _F_BAD, _F_DOT, _F_E, _F_SUFFIX, _F_BAD],       # int digits
    [_F_FRAC, _F_BAD, _F_BAD, _F_E, _F_SUFFIX, _F_BAD],      # '1.'
    [_F_FRAC, _F_BAD, _F_BAD, _F_BAD, _F_BAD, _F_BAD],       # '.'
    [_F_FRAC, _F_BAD, _F_BAD, _F_E, _F_SUFFIX, _F_BAD],      # fraction
    [_F_EXP, _F_ESIGN, _F_BAD, _F_BAD, _F_BAD, _F_BAD],      # 'e'
    [_F_EXP, _F_BAD, _F_BAD, _F_BAD, _F_BAD, _F_BAD],        # 'e-'
    [_F_EXP, _F_BAD, _F_BAD, _F_BAD, _F_SUFFIX, _F_BAD],     # exponent
    [_F_BAD] * 6,                                            # suffix
    [_F_BAD] * 6,
]
_F_ACCEPT = (_F_INT, _F_DOT, _F_FRAC, _F_EXP, _F_SUFFIX)
# exact powers of ten as doubles
_POW10 = [10.0 ** k for k in range(23)]


def _parse_float(c: ColVal, target: DataType, ctx) -> ColVal:
    """Spark's string -> float/double: whitespace trimmed, Java's decimal
    literal (sign, digits, '.', exponent, a d/f suffix) and the special
    literals inf, infinity and nan (any case, an optional sign on the
    infinities) and Java's +NaN / -NaN; anything else is null.  Up to 19
    significant digits with a decimal exponent within +-22 convert exactly
    (one correctly rounded multiply or divide); past that the value may
    differ from Java's in the last bit."""
    start, end = _trimmed(c)
    lens = end - start
    W = max(_number_width(lens), 9)     # the longest special literal
    win = _window(c, start, lens, W)
    device = win.device
    n = win.shape[0]
    nxt = torch.tensor(_F_NEXT, dtype=torch.int64, device=device)
    state = torch.full((n,), _F_START, dtype=torch.int64, device=device)
    mant = torch.zeros(n, dtype=torch.int64, device=device)
    nsig = torch.zeros(n, dtype=torch.int64, device=device)
    exp10 = torch.zeros(n, dtype=torch.int64, device=device)
    xval = torch.zeros(n, dtype=torch.int64, device=device)
    xneg = torch.zeros(n, dtype=torch.bool, device=device)
    neg = win[:, 0] == 45
    for j in range(W):
        ch = win[:, j]
        active = j < lens
        digit = (ch >= 48) & (ch <= 57)
        cls = torch.where(digit, 0, torch.where(
            (ch == 43) | (ch == 45), 1, torch.where(
                ch == 46, 2, torch.where(
                    (ch == 101) | (ch == 69), 3, torch.where(
                        (ch == 100) | (ch == 68) | (ch == 102) | (ch == 70),
                        4, 5)))))
        new = torch.where(active, nxt[state, cls], state)
        d = ch - 48
        in_int = active & (new == _F_INT)
        in_frac = active & (new == _F_FRAC)
        lead_zero = (mant == 0) & (d == 0)
        room = nsig < 19
        keep = (in_int | in_frac) & digit & ~lead_zero & room
        mant = torch.where(keep, mant * 10 + d, mant)
        nsig = nsig + keep.to(torch.int64)
        # an integer digit past 19 scales by ten; a kept fraction digit,
        # or a leading zero after the point, moves the point
        exp10 = exp10 + (in_int & digit & ~lead_zero & ~room).to(
            torch.int64)
        exp10 = exp10 - (in_frac & digit & (keep | lead_zero)).to(
            torch.int64)
        in_exp = active & (new == _F_EXP)
        xval = torch.where(in_exp, torch.clamp(xval * 10 + d, max=100000),
                           xval)
        xneg = xneg | (active & (new == _F_ESIGN) & (ch == 45))
        state = new
    ok = (lens > 0) & (lens <= MAX_NUMBER_BYTES)
    accept = torch.zeros(n, dtype=torch.bool, device=device)
    for s in _F_ACCEPT:
        accept = accept | (state == s)
    e = exp10 + torch.where(xneg, -xval, xval)
    m = mant.to(torch.float64)
    pow10 = torch.tensor(_POW10, dtype=torch.float64, device=device)
    exact = (mant < (1 << 53)) & (e.abs() <= 22)
    ae = e.abs().clamp(max=22)
    val = torch.where(e >= 0, m * pow10[ae], m / pow10[ae])
    approx = m * torch.pow(torch.full_like(m, 10.0),
                           e.clamp(-400, 400).to(torch.float64))
    val = torch.where(exact | (mant == 0), val, approx)
    val = torch.where(neg, -val, val)
    # the special literals
    low = _lower_ascii(win)
    inf = torch.zeros(n, dtype=torch.bool, device=device)
    for w in ("inf", "+inf", "infinity", "+infinity"):
        inf = inf | _equals_word(low, lens, w)
    ninf = _equals_word(low, lens, "-inf") | \
        _equals_word(low, lens, "-infinity")
    nan = _equals_word(low, lens, "nan") | \
        _equals_word(win, lens, "+NaN") | _equals_word(win, lens, "-NaN")
    val = torch.where(inf, float("inf"), torch.where(
        ninf, float("-inf"), torch.where(nan, float("nan"), val)))
    ok = ok & (accept | inf | ninf | nan)
    val = torch.where(ok, val, 0.0)
    return ColVal(target, val.to(dts.torch_dtype(target)),
                  combine_validity(c.validity, ok))


def _digits(win, cols):
    out = torch.zeros(win.shape[0], dtype=torch.int64, device=win.device)
    for i in cols:
        out = out * 10 + (win[:, i] - 48)
    return out


def _all_digits(win, cols):
    ok = torch.ones(win.shape[0], dtype=torch.bool, device=win.device)
    for i in cols:
        ok = ok & (win[:, i] >= 48) & (win[:, i] <= 57)
    return ok


def _date_part(win, lens):
    """(days, ok) of a window starting 'yyyy-MM-dd'."""
    from spark_rapids_tpu_torch.ops.datetime_ops import (
        _days_from_civil, _month_days)
    ok = (lens >= 10) & (win[:, 4] == 45) & (win[:, 7] == 45) & \
        _all_digits(win, (0, 1, 2, 3, 5, 6, 8, 9))
    y = _digits(win, (0, 1, 2, 3))
    m = _digits(win, (5, 6))
    d = _digits(win, (8, 9))
    mc = m.clamp(1, 12)
    ok = ok & (m >= 1) & (m <= 12) & (d >= 1) & (d <= _month_days(y, mc))
    return _days_from_civil(y, mc, d.clamp(1, 31)), ok


def _parse_date(c: ColVal, ctx) -> ColVal:
    """'yyyy-MM-dd' after trimming (the JAX package's form), else null."""
    start, end = _trimmed(c)
    lens = end - start
    win = _window(c, start, lens, 10)
    days, ok = _date_part(win, lens)
    ok = ok & (lens == 10)
    return ColVal(dts.DATE32, torch.where(ok, days, 0).to(torch.int32),
                  combine_validity(c.validity, ok))


def _parse_timestamp(c: ColVal, ctx) -> ColVal:
    """'yyyy-MM-dd[( |T)HH:mm:ss[.f{1,6}]]' after trimming, in UTC, as
    microseconds (the JAX package's forms), else null."""
    start, end = _trimmed(c)
    lens = end - start
    win = _window(c, start, lens, 26)
    days, ok = _date_part(win, lens)
    time_ok = ((win[:, 10] == 32) | (win[:, 10] == 84)) & \
        (win[:, 13] == 58) & (win[:, 16] == 58) & \
        _all_digits(win, (11, 12, 14, 15, 17, 18))
    hh, mi, ss = _digits(win, (11, 12)), _digits(win, (14, 15)), \
        _digits(win, (17, 18))
    time_ok = time_ok & (hh <= 23) & (mi <= 59) & (ss <= 59)
    frac = torch.zeros_like(days)
    fdig = torch.zeros_like(days)
    frac_ok = win[:, 19] == 46
    for i in range(20, 26):
        inside = i < lens
        d = (win[:, i] >= 48) & (win[:, i] <= 57)
        frac_ok = frac_ok & (~inside | d)
        frac = torch.where(inside & d, frac * 10 + win[:, i] - 48, frac)
        fdig = fdig + (inside & d).to(torch.int64)
    scale = torch.tensor([10 ** (6 - k) for k in range(7)],
                         dtype=torch.int64, device=win.device)
    micros_frac = frac * scale[fdig.clamp(0, 6)]
    ok = ok & ((lens == 10) | ((lens == 19) & time_ok) |
               ((lens >= 21) & (lens <= 26) & time_ok & frac_ok))
    secs = hh * 3600 + mi * 60 + ss
    micros = days * 86_400_000_000 + \
        torch.where(lens >= 19, secs * 1_000_000, 0) + \
        torch.where(lens >= 21, micros_frac, 0)
    return ColVal(dts.TIMESTAMP_US, torch.where(ok, micros, 0),
                  combine_validity(c.validity, ok))


_BOOL_TRUE = ("true", "t", "yes", "y", "1")
_BOOL_FALSE = ("false", "f", "no", "n", "0")


def _parse_bool(c: ColVal, ctx) -> ColVal:
    """true/t/yes/y/1 and false/f/no/n/0, any case, trimmed; anything
    else is null."""
    start, end = _trimmed(c)
    lens = end - start
    low = _lower_ascii(_window(c, start, lens, 5))
    is_true = torch.zeros(lens.shape[0], dtype=torch.bool,
                          device=lens.device)
    is_false = torch.zeros_like(is_true)
    for w in _BOOL_TRUE:
        is_true = is_true | _equals_word(low, lens, w)
    for w in _BOOL_FALSE:
        is_false = is_false | _equals_word(low, lens, w)
    ok = is_true | is_false
    return ColVal(dts.BOOL, is_true, combine_validity(c.validity, ok))


def fixed_rows(mat: torch.Tensor, lens: torch.Tensor, capacity: int):
    """(chars, offsets) of rows held left-aligned in a uint8 [rows, W]
    matrix, each ``lens[r]`` bytes long."""
    W = mat.shape[1]
    starts = torch.arange(capacity, device=mat.device) * W
    pool = mat.reshape(-1)
    n = int(pool.shape[0])
    return build_segments([(lens, starts, None)], pool, n, n, capacity)


def _format_bool(c: ColVal, ctx) -> ColVal:
    v = c.values.to(torch.bool)
    t = torch.tensor(list(b"true\0"), dtype=torch.uint8, device=v.device)
    f = torch.tensor(list(b"false"), dtype=torch.uint8, device=v.device)
    mat = torch.where(v[:, None], t[None, :], f[None, :])
    lens = torch.where(v, 4, 5)
    chars, offsets = fixed_rows(mat, lens, ctx.capacity)
    return ColVal(dts.STRING, chars, c.validity, offsets)


def int_digits(v: torch.Tensor):
    """([rows, 20] uint8 of each value's decimal text left-aligned, int64
    lengths) for int64 values (the minimum included)."""
    neg = v < 0
    # the magnitude's digits, least significant first, without negating
    # the minimum: remainders of a negative value are non-positive
    digs = []
    x = v
    for _ in range(19):
        r = torch.remainder(x, 10)
        q = torch.div(x, 10, rounding_mode="floor")
        # for negative x, floor division rounds away; fix to toward zero
        fix = (x < 0) & (r != 0)
        q = torch.where(fix, q + 1, q)
        r = torch.where(fix, 10 - r, r)
        digs.append(r)
        x = q
    digs = torch.stack(digs, dim=1)                  # [rows, 19]
    nz = digs != 0
    idx = torch.arange(19, device=v.device)
    ndig = torch.where(nz, idx + 1, 0).amax(dim=1).clamp(min=1)
    lens = ndig + neg.to(torch.int64)
    k = torch.arange(20, device=v.device)[None, :]
    pos_in_num = k - neg.to(torch.int64)[:, None]
    di = (ndig[:, None] - 1 - pos_in_num).clamp(0, 18)
    dig = torch.gather(digs, 1, di) + 48
    mat = torch.where((k == 0) & neg[:, None], 45, dig).to(torch.uint8)
    return mat, lens


def _format_int(c: ColVal, ctx) -> ColVal:
    mat, lens = int_digits(c.values.to(torch.int64))
    chars, offsets = fixed_rows(mat, lens, ctx.capacity)
    return ColVal(dts.STRING, chars, c.validity, offsets)


def _two(v):
    return [torch.div(v, 10, rounding_mode="floor") % 10, v % 10]


def _date_text_cols(y, m, d):
    """The ten columns of 'yyyy-MM-dd' (the year's low four digits)."""
    return [torch.div(y, 1000, rounding_mode="floor") % 10 + 48,
            torch.div(y, 100, rounding_mode="floor") % 10 + 48,
            torch.div(y, 10, rounding_mode="floor") % 10 + 48, y % 10 + 48,
            torch.full_like(y, 45), *[x + 48 for x in _two(m)],
            torch.full_like(y, 45), *[x + 48 for x in _two(d)]]


def _format_date(c: ColVal, ctx) -> ColVal:
    from spark_rapids_tpu_torch.ops.datetime_ops import _civil_from_days
    y, m, d = _civil_from_days(c.values)
    mat = torch.stack(_date_text_cols(y, m, d), dim=1).to(torch.uint8)
    lens = torch.full((mat.shape[0],), 10, dtype=torch.int64,
                      device=mat.device)
    chars, offsets = fixed_rows(mat, lens, ctx.capacity)
    return ColVal(dts.STRING, chars, c.validity, offsets)


def _format_timestamp(c: ColVal, ctx) -> ColVal:
    """'yyyy-MM-dd HH:mm:ss[.f]', the fraction's trailing zeros cut
    (Spark's cast of a timestamp to a string)."""
    v = c.values.to(torch.int64)
    days = torch.div(v, 86_400_000_000, rounding_mode="floor")
    in_day = v - days * 86_400_000_000
    secs = torch.div(in_day, 1_000_000, rounding_mode="floor")
    micros = in_day - secs * 1_000_000
    from spark_rapids_tpu_torch.ops.datetime_ops import _civil_from_days
    y, m, d = _civil_from_days(days)
    hh = torch.div(secs, 3600, rounding_mode="floor")
    mi = torch.div(secs, 60, rounding_mode="floor") % 60
    ss = secs % 60
    cols = _date_text_cols(y, m, d) + [
        torch.full_like(y, 32), *[x + 48 for x in _two(hh)],
        torch.full_like(y, 58), *[x + 48 for x in _two(mi)],
        torch.full_like(y, 58), *[x + 48 for x in _two(ss)],
        torch.full_like(y, 46)]
    for i in range(6):
        cols.append(torch.div(micros, 10 ** (5 - i),
                              rounding_mode="floor") % 10 + 48)
    mat = torch.stack(cols, dim=1).to(torch.uint8)
    # the fewest digits that hold the fraction (0 when it is 0)
    fdig = torch.zeros_like(micros)
    for k in range(6, 0, -1):
        fdig = torch.where(micros % (10 ** (6 - k + 1)) != 0,
                           torch.maximum(fdig, torch.full_like(fdig, k)),
                           fdig)
    lens = torch.where(micros > 0, 20 + fdig, 19)
    chars, offsets = fixed_rows(mat, lens, ctx.capacity)
    return ColVal(dts.STRING, chars, c.validity, offsets)
