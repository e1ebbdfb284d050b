"""Regular expressions and the remaining string producers.

Counterpart of ``spark_rapids_tpu/ops/regexops.py``.  Only a restricted
regex subset runs on the device; the planner tags any other pattern and
its node runs in the CPU fallback with Python's ``re``.

The device subset (``RegexProgram``, compiled by the JAX package's own
pattern compiler, copied here: pure numpy) is a sequence of segments of
fixed-length atoms (literals, ``.``, ``[...]`` classes with ranges and
negation, ``\\d \\w \\s`` and their negations, ``{m}`` repetition)
separated by ``.*`` / ``.+`` gaps, with optional ``^`` / ``$`` anchors.
Each atom is a 256-entry byte mask, tested as a few byte-range
comparisons over the chars buffer shifted by slicing; ``.`` matches one
byte, so the regex expressions are tagged incompatible as in the JAX
package.  A row matches when each segment's earliest match at or after
the previous segment's end exists: one ``searchsorted`` per row and
segment over the prefix count of match starts.

``RegExpReplace`` (and ``StringReplace`` through it) runs on the device
for a gap-free, unanchored pattern that cannot overlap itself, so every
raw match is a match of Java's left-to-right scan: one flat-map over the
chars buffer (per byte: the replacement at a match start, nothing inside
a match, else the byte).  The replacement is a literal after Java's
escapes (``\\x`` is ``x``); one holding ``$`` is tagged off.
``Translate`` maps and deletes ASCII bytes; ``ConcatWs`` skips nulls;
``SplitPart`` is ``split(s, d)[n]`` for a literal delimiter that cannot
overlap itself (the JAX package counts overlapping delimiters).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.ops.expressions import (
    ColVal, EmitContext, Expression, UnaryExpression, combine_validity)
from spark_rapids_tpu_torch.ops.stringops import (
    _prefix_count, _row_bounds, _validity_of, as_column, build_segments,
    first_flag_from, literal_atoms, match_mask)


# ------------------------------------------------------------ pattern compile

_CLASS_D = np.zeros(256, dtype=bool)
_CLASS_D[ord("0"):ord("9") + 1] = True
_CLASS_W = _CLASS_D.copy()
_CLASS_W[ord("a"):ord("z") + 1] = True
_CLASS_W[ord("A"):ord("Z") + 1] = True
_CLASS_W[ord("_")] = True
_CLASS_S = np.zeros(256, dtype=bool)
for _c in " \t\n\r\f\v":
    _CLASS_S[ord(_c)] = True
_CLASS_ANY = np.ones(256, dtype=bool)

_META = set(".[]()*+?{}|^$\\")


def _parse_class(pat: str, i: int) -> Tuple[Optional[np.ndarray], int]:
    """Parse [...] starting at pat[i] == '['; returns (mask, next_i)."""
    mask = np.zeros(256, dtype=bool)
    i += 1
    negate = False
    if i < len(pat) and pat[i] == "^":
        negate = True
        i += 1
    first = True
    while i < len(pat) and (pat[i] != "]" or first):
        first = False
        ch = pat[i]
        if ch == "\\" and i + 1 < len(pat):
            nxt = pat[i + 1]
            sub = {"d": _CLASS_D, "w": _CLASS_W, "s": _CLASS_S}.get(nxt)
            if sub is not None:
                mask |= sub
                i += 2
                continue
            ch = nxt
            i += 1
        o = ord(ch)
        if o > 255:
            return None, i  # non-ASCII class member: unsupported
        if i + 2 < len(pat) and pat[i + 1] == "-" and pat[i + 2] != "]":
            hi = ord(pat[i + 2])
            if hi > 255:
                return None, i
            mask[o:hi + 1] = True
            i += 3
        else:
            mask[o] = True
            i += 1
    if i >= len(pat):
        return None, i  # unterminated
    if negate:
        mask = ~mask
    return mask, i + 1


class RegexProgram:
    """Compiled restricted pattern: ``segments`` of byte-class masks
    separated by gaps; None when the pattern is outside the subset."""

    def __init__(self, anchored_start: bool, anchored_end: bool,
                 segments: List[List[np.ndarray]], gap_min: List[int]):
        self.anchored_start = anchored_start
        self.anchored_end = anchored_end
        self.segments = segments          # each: list of (256,) bool masks
        self.gap_min = gap_min            # min bytes before segment k (k>0)

    @property
    def single_fixed(self) -> bool:
        return (len(self.segments) == 1 and not self.anchored_start and
                not self.anchored_end)

    def no_self_overlap(self) -> bool:
        """True when a raw match can never overlap another (so all raw
        matches are greedy matches).  Shift-d overlap is impossible when
        some position i has mask[i] disjoint from mask[i+d]."""
        if len(self.segments) != 1:
            return False
        atoms = self.segments[0]
        n = len(atoms)
        for d in range(1, n):
            if not any(not (atoms[i] & atoms[i + d]).any()
                       for i in range(n - d)):
                return False
        return True


def compile_pattern(pat: str) -> Optional[RegexProgram]:
    """Compile to the device subset; None = unsupported (CPU fallback)."""
    i = 0
    anchored_start = False
    anchored_end = False
    if pat.startswith("^"):
        anchored_start = True
        i = 1
    body = pat
    if body.endswith("$") and not body.endswith("\\$"):
        anchored_end = True
        body = body[:-1]
    segments: List[List[np.ndarray]] = [[]]
    gap_min: List[int] = []
    while i < len(body):
        ch = body[i]
        mask: Optional[np.ndarray] = None
        if ch == "\\" and i + 1 < len(body):
            nxt = body[i + 1]
            named = {"d": _CLASS_D, "D": ~_CLASS_D, "w": _CLASS_W,
                     "W": ~_CLASS_W, "s": _CLASS_S, "S": ~_CLASS_S}
            if nxt in named:
                mask = named[nxt].copy()
            elif nxt in _META or not nxt.isalnum():
                mask = np.zeros(256, dtype=bool)
                mask[ord(nxt)] = True
            else:
                return None  # \b, \A, backrefs...
            i += 2
        elif ch == ".":
            # ".*" / ".+" are gaps between segments
            if i + 1 < len(body) and body[i + 1] in "*+":
                if not segments[-1] and len(segments) > 1:
                    return None  # consecutive gaps
                segments.append([])
                gap_min.append(1 if body[i + 1] == "+" else 0)
                i += 2
                continue
            mask = _CLASS_ANY.copy()
            i += 1
        elif ch == "[":
            mask, ni = _parse_class(body, i)
            if mask is None:
                return None
            i = ni
        elif ch in "*+?{}|()$^":
            if ch == "{":
                # fixed repetition {m} of the previous atom
                j = body.find("}", i)
                if j < 0 or not segments[-1]:
                    return None
                spec = body[i + 1:j]
                if not spec.isdigit():
                    return None  # {m,n} ranges unsupported
                prev = segments[-1][-1]
                for _ in range(int(spec) - 1):
                    segments[-1].append(prev.copy())
                i = j + 1
                continue
            return None  # alternation, groups, variable quantifiers
        else:
            enc = ch.encode("utf-8")
            for b in enc:
                m = np.zeros(256, dtype=bool)
                m[b] = True
                segments[-1].append(m)
            i += 1
            continue
        segments[-1].append(mask)
    if any(not s for s in segments):
        return None  # empty segment (e.g. bare ".*" pattern or gap at end)
    return RegexProgram(anchored_start, anchored_end, segments, gap_min)


def mask_atom(mask: np.ndarray):
    """A 256-entry byte mask as ``stringops.atom_hits``' atom: a byte,
    None for every byte, or the inclusive byte ranges it holds."""
    if mask.all():
        return None
    idx = np.flatnonzero(mask)
    if len(idx) == 1:
        return int(idx[0])
    runs, lo = [], None
    for b in range(257):
        on = b < 256 and mask[b]
        if on and lo is None:
            lo = b
        elif not on and lo is not None:
            runs.append((lo, b - 1))
            lo = None
    return runs


def match_program(c: ColVal, prog: RegexProgram, capacity: int
                  ) -> torch.Tensor:
    """bool per row: Java ``Matcher.find`` of the program (its anchors
    included): each segment's earliest match at or after the previous
    segment's end plus its gap, the last one at the row's end when
    anchored there."""
    starts, ends = _row_bounds(c)
    ccap = c.values.shape[0]
    earliest = starts
    ok = torch.ones(capacity, dtype=torch.bool, device=c.values.device)
    last = len(prog.segments) - 1
    for k, masks in enumerate(prog.segments):
        n = len(masks)
        m = match_mask(c, [mask_atom(x) for x in masks], capacity)
        at_start = k == 0 and prog.anchored_start
        if k == last and prog.anchored_end:
            p = ends - n
            hit = (p >= earliest) & (p >= starts) & \
                m[p.clamp(0, max(ccap - 1, 0))] if ccap else \
                torch.zeros_like(ok)
            if at_start:
                hit = hit & (p == starts)
            ok = ok & hit
            break
        if at_start:
            first = starts
            found = (starts + n <= ends) & \
                (m[starts.clamp(0, max(ccap - 1, 0))] if ccap else
                 torch.zeros_like(ok))
        else:
            first = first_flag_from(_prefix_count(m),
                                    earliest.clamp(max=ccap))
            found = first + n <= ends
        ok = ok & found
        gap = prog.gap_min[k] if k < len(prog.gap_min) else 0
        earliest = torch.where(found, first + n + gap, ends + 1)
    return ok


# -------------------------------------------------------------- expressions

class RLike(UnaryExpression):
    """rlike / regexp: unanchored find over the device subset."""

    def __init__(self, child: Expression, pattern: str):
        super().__init__(child)
        self.pattern = pattern
        self._prog = compile_pattern(pattern)

    def with_children(self, children):
        return RLike(children[0], self.pattern)

    @property
    def supported(self) -> bool:
        return self._prog is not None

    @property
    def dtype(self):
        return dts.BOOL

    def cache_key(self):
        return ("RLike", self.pattern, self.child.cache_key())

    def __str__(self):
        return f"RLike({self.child}, {self.pattern!r})"

    def emit(self, ctx: EmitContext) -> ColVal:
        if self._prog is None:
            raise NotImplementedError(
                f"regex {self.pattern!r} outside the device subset")
        c = as_column(self.child.emit(ctx), ctx.capacity)
        ok = match_program(c, self._prog, ctx.capacity)
        return ColVal(dts.BOOL, ok, _validity_of(c, ctx.capacity))


def java_replacement(text: str) -> Optional[str]:
    """A Java replacement string as its literal text (``\\x`` is ``x``),
    or None when it refers to a group (``$``) or ends in a lone
    backslash."""
    out, i = [], 0
    while i < len(text):
        ch = text[i]
        if ch == "$":
            return None
        if ch == "\\":
            if i + 1 >= len(text):
                return None
            out.append(text[i + 1])
            i += 2
            continue
        out.append(ch)
        i += 1
    return "".join(out)


def replace_matches(c: ColVal, atoms, replacement: bytes,
                    capacity: int):
    """(chars, offsets) of ``c`` with every match of ``atoms`` (which
    cannot overlap itself) replaced by ``replacement``."""
    n = len(atoms)
    R = len(replacement)
    device = c.values.device
    ccap = int(c.values.shape[0])
    starts_m = match_mask(c, atoms, capacity)
    P = _prefix_count(starts_m)
    pos = torch.arange(ccap, device=device)
    in_match = (P[pos + 1] - P[(pos - n + 1).clamp(min=0)]) > 0
    live = pos < c.offsets[capacity].to(torch.int64)
    emit_len = torch.where(starts_m, R, torch.where(in_match, 0, 1))
    emit_len = torch.where(live, emit_len, 0)
    out_pos = _prefix_count(emit_len)
    offsets = out_pos[c.offsets.to(torch.int64)]
    bound = ccap * max(R, 1) // max(n, 1) if R > n else ccap
    from spark_rapids_tpu_torch.ops.stringops import out_size
    cap = out_size(offsets[-1], bound, ccap)
    if cap == 0 or ccap == 0:
        return (torch.zeros(cap, dtype=torch.uint8, device=device),
                offsets.to(torch.int32))
    j = torch.arange(cap, device=device)
    i = (torch.searchsorted(out_pos, j, right=True) - 1).clamp(0, ccap - 1)
    off = j - out_pos[i]
    repl = torch.from_numpy(np.frombuffer(replacement or b"\0",
                                          dtype=np.uint8).copy()).to(device)
    byte = torch.where(starts_m[i], repl[off.clamp(0, max(R - 1, 0))],
                       c.values[i])
    chars = torch.where(j < offsets[-1], byte,
                        torch.zeros((), dtype=torch.uint8, device=device))
    return chars, offsets.to(torch.int32)


class RegExpReplace(Expression):
    """regexp_replace(s, pattern, replacement): on the device for a
    gap-free, unanchored pattern that cannot overlap itself, with a
    replacement that names no group; anything else is tagged off."""

    def __init__(self, child: Expression, pattern: str, replacement: str):
        self.children = (child,)
        self.pattern = pattern
        self.replacement = replacement
        prog = compile_pattern(pattern)
        self._prog = prog if (prog is not None and prog.single_fixed and
                              prog.no_self_overlap() and
                              "$" not in replacement) else None
        self._literal = java_replacement(replacement)

    @property
    def child(self) -> Expression:
        return self.children[0]

    def with_children(self, children):
        return RegExpReplace(children[0], self.pattern, self.replacement)

    @property
    def supported(self) -> bool:
        return self._prog is not None and self._literal is not None

    @property
    def dtype(self):
        return dts.STRING

    def cache_key(self):
        return ("RegExpReplace", self.pattern, self.replacement,
                self.child.cache_key())

    def emit(self, ctx: EmitContext) -> ColVal:
        if not self.supported:
            raise NotImplementedError(
                f"regexp_replace {self.pattern!r} outside the device subset")
        c = as_column(self.child.emit(ctx), ctx.capacity)
        atoms = [mask_atom(x) for x in self._prog.segments[0]]
        chars, offsets = replace_matches(
            c, atoms, self._literal.encode("utf-8"), ctx.capacity)
        return ColVal(dts.STRING, chars, _validity_of(c, ctx.capacity),
                      offsets)


class StringReplace(Expression):
    """replace(s, search, replacement) for a literal ``search``: every
    left-to-right occurrence; on the device when ``search`` cannot
    overlap itself (else tagged off, as an empty ``search`` is)."""

    def __init__(self, child: Expression, search: str, replacement: str):
        self.children = (child,)
        self.search = search
        self.replacement = replacement
        escaped = "".join("\\" + ch if ch in _META else ch for ch in search)
        prog = compile_pattern(escaped) if search else None
        self._ok = prog is not None and prog.no_self_overlap()

    @property
    def child(self) -> Expression:
        return self.children[0]

    def with_children(self, children):
        return StringReplace(children[0], self.search, self.replacement)

    @property
    def supported(self) -> bool:
        return self._ok

    @property
    def dtype(self):
        return dts.STRING

    def cache_key(self):
        return ("StringReplace", self.search, self.replacement,
                self.child.cache_key())

    def emit(self, ctx: EmitContext) -> ColVal:
        if not self.supported:
            raise NotImplementedError(
                f"replace search {self.search!r} unsupported on the device")
        c = as_column(self.child.emit(ctx), ctx.capacity)
        chars, offsets = replace_matches(
            c, literal_atoms(self.search), self.replacement.encode("utf-8"),
            ctx.capacity)
        return ColVal(dts.STRING, chars, _validity_of(c, ctx.capacity),
                      offsets)


class ConcatWs(Expression):
    """concat_ws(sep, s1, s2, ...): null inputs are skipped, so the result
    is never null."""

    def __init__(self, sep: str, *children: Expression):
        self.sep = sep
        self.children = tuple(children)

    def with_children(self, children):
        return ConcatWs(self.sep, *children)

    @property
    def dtype(self):
        return dts.STRING

    @property
    def nullable(self) -> bool:
        return False

    def cache_key(self):
        return ("ConcatWs", self.sep,
                tuple(c.cache_key() for c in self.children))

    def emit(self, ctx: EmitContext) -> ColVal:
        cap = ctx.capacity
        device = ctx.device
        raw = [c.emit(ctx) for c in self.children]
        held = sum(int(c.values.shape[0]) for c in raw)
        cols = [as_column(c, cap) for c in raw]
        sep = self.sep.encode("utf-8")
        S = len(sep)
        pool_parts, bases, base = [], [], 0
        for c in cols:
            bases.append(base)
            base += int(c.values.shape[0])
            pool_parts.append(c.values)
        sep_base = base
        pool_parts.append(torch.from_numpy(
            np.frombuffer(sep or b"\0", dtype=np.uint8).copy()).to(device))
        pool = torch.cat(pool_parts)
        any_before = torch.zeros(cap, dtype=torch.bool, device=device)
        segs = []
        for c, b in zip(cols, bases):
            valid = _validity_of(c, cap)
            valid = torch.ones(cap, dtype=torch.bool, device=device) \
                if valid is None else valid
            starts, ends = _row_bounds(c)
            if S:
                segs.append((torch.where(valid & any_before, S, 0),
                             torch.full_like(starts, sep_base), None))
            segs.append((torch.where(valid, ends - starts, 0), starts + b,
                         None))
            any_before = any_before | valid
        bound = base + S * max(len(cols) - 1, 0) * cap
        chars, offsets = build_segments(segs, pool, bound, held, cap)
        return ColVal(dts.STRING, chars, None, offsets)


class Translate(Expression):
    """translate(s, from, to): each character of ``from`` becomes the one
    at its place in ``to`` (the first occurrence wins), or is deleted past
    ``to``'s end.  On the device for ASCII ``from`` and ``to`` (a
    multi-byte character of ``s`` passes through untouched)."""

    def __init__(self, child: Expression, from_str: str, to_str: str):
        self.children = (child,)
        self.from_str = from_str
        self.to_str = to_str

    @property
    def child(self) -> Expression:
        return self.children[0]

    def with_children(self, children):
        return Translate(children[0], self.from_str, self.to_str)

    @property
    def supported(self) -> bool:
        return all(ord(ch) < 128 for ch in self.from_str + self.to_str)

    @property
    def dtype(self):
        return dts.STRING

    def cache_key(self):
        return ("Translate", self.from_str, self.to_str,
                self.child.cache_key())

    def emit(self, ctx: EmitContext) -> ColVal:
        if not self.supported:
            raise NotImplementedError("translate maps must be ASCII")
        c = as_column(self.child.emit(ctx), ctx.capacity)
        cap = ctx.capacity
        v = c.values
        out = v
        deleted = torch.zeros(v.shape, dtype=torch.bool, device=v.device)
        seen = set()
        for i, ch in enumerate(self.from_str):
            b = ord(ch)
            if b in seen:
                continue
            seen.add(b)
            hit = v == b
            if i < len(self.to_str):
                out = torch.where(hit, ord(self.to_str[i]), out)
            else:
                deleted = deleted | hit
        validity = _validity_of(c, cap)
        if len(self.from_str) <= len(self.to_str) or not seen:
            return ColVal(dts.STRING, out.to(torch.uint8), validity,
                          c.offsets)
        ccap = int(v.shape[0])
        pos = torch.arange(ccap, device=v.device)
        keep = ~deleted & (pos < c.offsets[cap].to(torch.int64))
        K = _prefix_count(keep)
        offsets = K[c.offsets.to(torch.int64)]
        if ccap == 0:
            return ColVal(dts.STRING, out.to(torch.uint8), validity,
                          offsets.to(torch.int32))
        src = (torch.searchsorted(K, pos + 1) - 1).clamp(0, ccap - 1)
        chars = torch.where(pos < offsets[-1], out.to(torch.uint8)[src],
                            torch.zeros((), dtype=torch.uint8,
                                        device=v.device))
        return ColVal(dts.STRING, chars, validity, offsets.to(torch.int32))


class SplitPart(Expression):
    """``split(s, delim)[n]``: the n-th (0-based) part of ``s`` cut at a
    literal delimiter; null past the last part."""

    def __init__(self, child: Expression, delim: str, index: int):
        self.children = (child,)
        self.delim = delim
        self.index = int(index)

    @property
    def child(self) -> Expression:
        return self.children[0]

    def with_children(self, children):
        return SplitPart(children[0], self.delim, self.index)

    @property
    def supported(self) -> bool:
        if not self.delim or self.index < 0 or \
                any(ch in _META for ch in self.delim):
            return False
        prog = compile_pattern(self.delim)
        return prog is not None and prog.no_self_overlap()

    @property
    def dtype(self):
        return dts.STRING

    def cache_key(self):
        return ("SplitPart", self.delim, self.index,
                self.child.cache_key())

    def emit(self, ctx: EmitContext) -> ColVal:
        if not self.supported:
            raise NotImplementedError(
                f"split delimiter {self.delim!r} unsupported on the device")
        c = as_column(self.child.emit(ctx), ctx.capacity)
        cap = ctx.capacity
        d = literal_atoms(self.delim)
        P = _prefix_count(match_mask(c, d, cap))
        starts, ends = _row_bounds(c)
        base = P[starts]
        total = P[ends] - base
        n = self.index
        have = total >= n
        if n == 0:
            part_start = starts
        else:
            nth = torch.searchsorted(P, base + n) - 1
            part_start = torch.where(have, nth + len(d), starts)
        nxt = torch.searchsorted(P, base + n + 1) - 1
        part_end = torch.where(total >= n + 1, nxt, ends)
        lens = torch.where(have, part_end - part_start, 0)
        nbytes = int(c.values.shape[0])
        chars, offsets = build_segments([(lens, part_start, None)],
                                        c.values, nbytes, nbytes, cap)
        validity = combine_validity(_validity_of(c, cap), have)
        return ColVal(dts.STRING, chars, validity, offsets)

