"""UDF compiler: CPython bytecode -> expression trees.

Counterpart of ``spark_rapids_tpu/udf/compiler.py`` (the reference's
``udf-compiler``: LambdaReflection -> CFG -> abstract interpretation ->
Catalyst).  ``dis`` supplies the instructions of a CPython 3.12 function;
a symbolic evaluator runs them over a stack and locals of expression trees
(or Python constants), and a conditional jump forks the evaluation, the
two arms rejoining as an ``If``.  Any opcode, call or operand type outside
the supported set makes ``compile_udf`` return None, and the UDF runs as a
host black box (``udf/python_exec.PythonUDF``), as the reference falls
back to the original function.

The port compiles a function at bind time, over typed argument
expressions, and the expression it returns computes what the function
computes in Python, where the JAX compiler gives Spark's operator
semantics instead:

- ``//`` floors and ``%`` takes the divisor's sign (``PyFloorDiv``,
  ``PyMod``: torch's floor division and remainder are Python's);
- a comparison of floats is IEEE's (NaN compares false and unequal to
  itself), not Spark's NaN-is-largest rule (``PyCompare``); ``min`` /
  ``max`` of two values keep Python's answer (the first argument unless
  the second compares less / greater), so a NaN argument wins or loses
  as it does in Python;
- ``round(x)`` rounds half to even and returns an integer; ``round(x, n)``
  for a constant n in [-15, 15] rounds half to even at n digits of x's
  exact value, to the double nearest the decimal result, as CPython's
  correctly rounded ``round`` (``PyRound``: exact two-products and sums;
  for n < 0 only while |x| < 2^62);
- integer operands widen to bigint and float operands to double, as
  Python's int and float hold them; truth tests are Python's (a number is
  true when non-zero, a string when not empty); a logarithm of a NaN is
  NaN;
- ``str.upper`` / ``lower`` (Python maps case over all of Unicode, the
  device's ``Upper`` / ``Lower`` ASCII only), ``str.strip`` / ``lstrip``
  / ``rstrip`` (Python strips all Unicode whitespace, the port's trims
  only spaces), ``str.title`` (Python's word rule is not ``InitCap``'s), ``int`` / ``float`` of a string (Python's
  parse rules are not a cast's), ``**`` other than a non-negative integer
  constant exponent, shifts other than by a constant in [0, 63], and
  arithmetic on booleans, decimals, dates and timestamps are not compiled.

Where Python raises or grows and Spark does not, the compiled form
follows Spark: an int64 result wraps on overflow (Python's int grows), a
division or modulus by zero and a math function outside its domain give
null or NaN as the expression does (Python raises ``ZeroDivisionError``
or ``ValueError``), and ``int(x)`` of a NaN or an infinite float is
Java's conversion (Python raises).  A row with a null argument gives null,
as the black-box path gives (Python would receive ``None``).
"""

from __future__ import annotations

import datetime
import dis
import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.exec.expand import NullLiteral
from spark_rapids_tpu_torch.ops import arithmetic as A
from spark_rapids_tpu_torch.ops import predicates as P
from spark_rapids_tpu_torch.ops import stringops as S
from spark_rapids_tpu_torch.ops.cast import Cast
from spark_rapids_tpu_torch.ops.expressions import (
    BinaryExpression, ColVal, EmitContext, Expression, Literal,
    UnaryExpression)


class CompileError(Exception):
    pass


_MAX_INSTRUCTIONS = 4000  # the path-explosion guard

_MATH_FNS: Dict[str, Callable] = {
    "sqrt": A.Sqrt, "exp": A.Exp, "log": A.Log, "log2": A.Log2,
    "log10": A.Log10, "log1p": A.Log1p, "sin": A.Sin, "cos": A.Cos,
    "tan": A.Tan, "asin": A.Asin, "acos": A.Acos, "atan": A.Atan,
    "sinh": A.Sinh, "cosh": A.Cosh, "tanh": A.Tanh, "floor": A.Floor,
    "ceil": A.Ceil, "degrees": A.ToDegrees, "radians": A.ToRadians,
    "fabs": A.Abs,
}

_DOMAIN_FNS = ("log", "log2", "log10", "log1p")

_INT64_MIN, _INT64_MAX = -(1 << 63), (1 << 63) - 1


# --------------------------------------------- Python-semantics expressions --

class PyFloorDiv(BinaryExpression):
    """Python's ``a // b``: floor division of bigints, or of doubles by
    CPython's rule (torch's ``floor`` rounding mode); a zero divisor gives
    null, and the bigint minimum // -1 wraps."""

    def eval_values(self, l, r):
        zero = r == 0
        if l.dtype.is_floating_point:
            safe = torch.where(zero, torch.ones_like(r), r)
            return torch.div(l, safe, rounding_mode="floor"), ~zero
        minus_one = r == -1
        safe = torch.where(zero | minus_one, torch.ones_like(r), r)
        q = torch.div(l, safe, rounding_mode="floor")
        return torch.where(minus_one, -l, q), ~zero


class PyMod(BinaryExpression):
    """Python's ``a % b``: the result takes the divisor's sign (torch's
    ``remainder``; a zero result too, as CPython's float modulus); a zero
    divisor gives null."""

    def eval_values(self, l, r):
        zero = r == 0
        safe = torch.where(zero, torch.ones_like(r), r)
        if not l.dtype.is_floating_point:
            safe = torch.where(r == -1, torch.ones_like(r), safe)
            return torch.remainder(l, safe), ~zero
        m = torch.remainder(l, safe)
        # a zero result takes the divisor's sign, as in CPython
        return torch.where(m == 0, torch.copysign(torch.zeros_like(m), safe),
                           m), ~zero


class PyPow(Expression):
    """``base ** k`` for a constant integer ``k >= 0``: a bigint power
    (wrapping past int64) or the double ``pow``."""

    def __init__(self, child: Expression, k: int):
        self.children = (child,)
        self.k = int(k)

    def with_children(self, children):
        return PyPow(children[0], self.k)

    @property
    def dtype(self):
        return self.children[0].dtype

    def emit(self, ctx: EmitContext) -> ColVal:
        c = self.children[0].emit(ctx)
        return ColVal(self.dtype, torch.pow(c.values, self.k), c.validity)

    def cache_key(self):
        return ("PyPow", self.k, self.children[0].cache_key())


class PyCompare(BinaryExpression):
    """A comparison of numbers as Python makes it: IEEE's for floats (a
    NaN compares false, and unequal to itself)."""

    _OPS = {"<": torch.lt, "<=": torch.le, ">": torch.gt, ">=": torch.ge,
            "==": torch.eq, "!=": torch.ne}

    def __init__(self, op: str, left: Expression, right: Expression):
        self.op = op
        self.children = (left, right)

    def with_children(self, children):
        return PyCompare(self.op, children[0], children[1])

    @property
    def dtype(self):
        return dts.BOOL

    def eval_values(self, l, r):
        return self._OPS[self.op](l, r), None

    def cache_key(self):
        return ("PyCompare", self.op,
                tuple(c.cache_key() for c in self.children))

    def __str__(self):
        return f"({self.children[0]} {self.op} {self.children[1]})"


_TWO52 = float(1 << 52)
_TWO62 = float(1 << 62)
_SPLITTER = 134217729.0  # 2^27 + 1 (Veltkamp's split of a double)


def _split(a):
    c = _SPLITTER * a
    hi = c - (c - a)
    return hi, a - hi


def _two_product(a, b):
    """(p, e) with a * b == p + e exactly (Dekker), for finite products."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _two_sum(a, b):
    """(s, e) with a + b == s + e exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _half_even(y, err, base_odd=None):
    """The integer nearest the exact y + err (|y| < 2^52, err below y's
    ulp), a tie going to the even one of base + that integer
    (``base_odd``: where the base is odd; None: an even base)."""
    fl = torch.floor(y)
    odd = torch.remainder(fl, 2) != 0
    if base_odd is not None:
        odd = odd != base_odd
    half = torch.where(err > 0, fl + 1, torch.where(err < 0, fl, fl + odd))
    frac = y - fl
    return torch.where(frac == 0.5, half,
                       torch.where(frac > 0.5, fl + 1, fl))


class PyRound(Expression):
    """Python's ``round``: ``round(x)`` (``ndigits`` None) rounds half to
    even and returns a bigint; ``round(x, n)`` keeps the type, a bigint
    rounded half to even to a multiple of 10^-n (unchanged for n >= 0), a
    double rounded half to even at n digits of its exact binary value to
    the double nearest the decimal result, as CPython's correctly rounded
    ``round`` (n in [-15, 15]; for n < 0 and |x| >= 2^62 the quotient
    x / 10^-n rounds in binary first)."""

    def __init__(self, child: Expression, ndigits: Optional[int] = None):
        self.children = (child,)
        self.ndigits = ndigits

    def with_children(self, children):
        return PyRound(children[0], self.ndigits)

    @property
    def dtype(self):
        t = self.children[0].dtype
        return dts.INT64 if self.ndigits is None else t

    def emit(self, ctx: EmitContext) -> ColVal:
        c = self.children[0].emit(ctx)
        v = c.values
        t = self.children[0].dtype
        if not t.is_floating:
            if self.ndigits is None or self.ndigits >= 0:
                return ColVal(self.dtype, v.to(torch.int64), c.validity)
            return A.BRound(self.children[0], self.ndigits).emit(ctx)
        if self.ndigits is None:
            return ColVal(dts.INT64, A._float_to_long(torch.round(v)),
                          c.validity)
        return ColVal(t, _round_float(v, self.ndigits), c.validity)

    def cache_key(self):
        return ("PyRound", self.ndigits, self.children[0].cache_key())


def _round_float(x, n):
    """Python's ``round(x, n)`` of doubles (see :class:`PyRound`)."""
    finite = torch.isfinite(x)
    x0 = torch.where(finite, x, torch.zeros_like(x))
    if n >= 0:
        f = float(10 ** n)
        # x = xi + xf exactly; xf * 10^n stays under 2^52, so its
        # two-product decides the rounding of the fraction exactly
        xi = torch.trunc(x0)
        xf = x0 - xi
        y, err = _two_product(xf, f)
        # with n == 0 a tie's parity is the whole value's
        k = _half_even(y, err, torch.remainder(xi, 2) != 0 if n == 0
                       else None)
        q = k / f
        # the answer is the double nearest xi + k / 10^n = s + e + d
        s, e = _two_sum(xi, q)
        p, pe = _two_product(q, f)
        d = (k - p) - pe  # has k / 10^n - q's sign
        inf = torch.full_like(s, float("inf"))
        nb = torch.nextafter(s, torch.where(e > 0, inf, -inf))
        tie = (e != 0) & (torch.abs(e) * 2 == torch.abs(nb - s))
        out = torch.where(tie & (torch.sign(d) == torch.sign(e)), nb, s)
    else:
        m = 10 ** (-n)
        # |x| < 2^62: x = xi + xf, xi = m * q0 + r0 in int64, and the
        # sign of 2 * (r0 + xf) - m decides the rounding exactly
        small = torch.abs(x0) < _TWO62
        xs = torch.where(small, x0, torch.zeros_like(x0))
        xi_f = torch.trunc(xs)
        xf = xs - xi_f
        xi = xi_f.to(torch.int64)
        q0 = torch.div(xi, m, rounding_mode="floor")
        cmp = (2 * (xi - q0 * m) - m).to(torch.float64) + 2 * xf
        odd = torch.remainder(q0, 2) != 0
        exact = (torch.where((cmp > 0) | ((cmp == 0) & odd), q0 + 1, q0)
                 * m).to(torch.float64)
        y = x0 / float(m)
        yp, ype = _two_product(y, float(m))
        fits = torch.abs(y) < _TWO52
        big = torch.where(fits, _half_even(
            torch.where(fits, y, torch.zeros_like(y)), (x0 - yp) - ype),
            y) * float(m)
        out = torch.where(small, exact, big)
    # a zero keeps x's sign, as Python's
    out = torch.where(out == 0, torch.copysign(torch.zeros_like(out), x0),
                      out)
    return torch.where(finite, out, x)


PY_EXPRESSIONS = (PyFloorDiv, PyMod, PyPow, PyCompare, PyRound)


# ----------------------------------------------------------- the evaluator --

class _Null:
    """The NULL a call's stack slot holds (``PUSH_NULL`` and the NULL
    forms of ``LOAD_GLOBAL`` / ``LOAD_ATTR``)."""


_NULL = _Null()


class _Attr:
    def __init__(self, obj, name: str):
        self.obj = obj
        self.name = name


def _is_expr(v) -> bool:
    return isinstance(v, Expression)


def _type_of(v) -> DataType:
    """The Spark type of a stack value (an expression's, or a constant's
    as a literal would have it)."""
    if _is_expr(v):
        return v.dtype
    if isinstance(v, bool):
        return dts.BOOL
    if isinstance(v, int):
        return dts.INT64
    if isinstance(v, float):
        return dts.FLOAT64
    if isinstance(v, str):
        return dts.STRING
    if isinstance(v, datetime.datetime):
        return dts.TIMESTAMP_US
    if isinstance(v, datetime.date):
        return dts.DATE32
    raise CompileError(f"constant {v!r} has no column type")


def _lit(v) -> Expression:
    if _is_expr(v):
        return v
    if v is None:
        raise CompileError("a None operand")
    if isinstance(v, int) and not isinstance(v, bool) and \
            not _INT64_MIN <= v <= _INT64_MAX:
        raise CompileError(f"integer constant {v} outside bigint")
    _type_of(v)
    return Literal(v)


def _number(v) -> Expression:
    """A numeric operand as Python holds it: an integer as a bigint, a
    float as a double; booleans, decimals and datetimes decline."""
    t = _type_of(v)
    if t.is_boolean or t.is_decimal or not (t.is_integral or t.is_floating):
        raise CompileError(f"arithmetic on {t}")
    e = _lit(v)
    if t.is_integral and t.name != "bigint":
        return Cast(e, dts.INT64)
    if t.is_floating and t.name != "double":
        return Cast(e, dts.FLOAT64)
    return e


def _truth(v):
    """Python's truth value of a stack value: a constant's, or a boolean
    expression (a number is true when non-zero, a string when not
    empty)."""
    if not _is_expr(v):
        return bool(v)
    t = v.dtype
    if t.is_boolean:
        return v
    if t.is_integral or t.is_floating:
        return PyCompare("!=", _number(v), Literal(0))
    if t.is_string:
        return P.GreaterThan(S.Length(v), Literal(0))
    raise CompileError(f"truth value of {t}")


def _compare(sym: str, l, r):
    if not _is_expr(l) and not _is_expr(r):
        return _const_op(sym, l, r)
    lt, rt = _type_of(l), _type_of(r)
    numeric = [t.is_integral or t.is_floating for t in (lt, rt)]
    if lt.is_boolean != rt.is_boolean:
        raise CompileError(f"comparison of {lt} and {rt}")
    if all(numeric) and not lt.is_boolean:
        return PyCompare(sym, _number(l), _number(r))
    if lt.is_decimal or rt.is_decimal:
        raise CompileError("comparison of decimals")
    if lt.name != rt.name and not (lt.is_datetime and rt.is_datetime):
        raise CompileError(f"comparison of {lt} and {rt}")
    if lt.is_datetime and lt.name != rt.name:
        raise CompileError("a date compared with a timestamp")
    le, re_ = _lit(l), _lit(r)
    if sym == "!=":
        return P.Not(P.EqualTo(le, re_))
    cls = {"<": P.LessThan, "<=": P.LessThanOrEqual, ">": P.GreaterThan,
           ">=": P.GreaterThanOrEqual, "==": P.EqualTo}[sym]
    return cls(le, re_)


def _arith(sym: str, l, r):
    if not _is_expr(l) and not _is_expr(r):
        return _const_op(sym, l, r)
    lt, rt = _type_of(l), _type_of(r)
    if sym == "+" and (lt.is_string or rt.is_string):
        if not (lt.is_string and rt.is_string):
            raise CompileError("str + non-str")
        return S.ConcatStrings(_lit(l), _lit(r))
    if lt.is_boolean and rt.is_boolean and sym in ("&", "|", "^"):
        le, re_ = _lit(l), _lit(r)
        if sym == "&":
            return P.And(le, re_)
        if sym == "|":
            return P.Or(le, re_)
        return P.Not(P.EqualTo(le, re_))
    le, re_ = _number(l), _number(r)
    floats = le.dtype.is_floating or re_.dtype.is_floating
    if sym == "+":
        return A.Add(le, re_)
    if sym == "-":
        return A.Subtract(le, re_)
    if sym == "*":
        return A.Multiply(le, re_)
    if sym == "/":
        return A.Divide(le, re_)
    if sym == "//":
        return PyFloorDiv(le, re_)
    if sym == "%":
        return PyMod(le, re_)
    if sym == "**":
        k = r
        if _is_expr(k) or isinstance(k, bool) or not isinstance(k, int) \
                or k < 0:
            raise CompileError("** needs a constant integer exponent >= 0")
        return PyPow(le, k)
    if floats:
        raise CompileError(f"{sym} on floats")
    if sym == "&":
        return A.BitwiseAnd(le, re_)
    if sym == "|":
        return A.BitwiseOr(le, re_)
    if sym == "^":
        return A.BitwiseXor(le, re_)
    if sym in ("<<", ">>"):
        if _is_expr(r) or not 0 <= r <= 63:
            raise CompileError("a shift needs a constant amount in [0, 63]")
        cls = A.ShiftLeft if sym == "<<" else A.ShiftRight
        return cls(le, Literal(int(r), dts.INT32))
    raise CompileError(f"binary op {sym}")


def _const_op(sym, l, r):
    import operator
    ops = {"+": operator.add, "-": operator.sub, "*": operator.mul,
           "/": operator.truediv, "//": operator.floordiv,
           "%": operator.mod, "**": operator.pow, "&": operator.and_,
           "|": operator.or_, "^": operator.xor, "<<": operator.lshift,
           ">>": operator.rshift, "<": operator.lt, "<=": operator.le,
           ">": operator.gt, ">=": operator.ge, "==": operator.eq,
           "!=": operator.ne}
    if sym not in ops:
        raise CompileError(f"operator {sym}")
    try:
        return ops[sym](l, r)
    except Exception as e:  # the function itself would raise here
        raise CompileError(f"constant {sym}: {e}")


def _if(cond, t, f):
    """``If(cond, t, f)``, a None arm a typed null."""
    if t is None and f is None:
        raise CompileError("both arms None")
    if t is None:
        t = NullLiteral(_type_of(f))
    if f is None:
        f = NullLiteral(_type_of(t))
    out = P.If(cond, _lit(t), _lit(f))
    try:
        out.dtype
    except (TypeError, ValueError) as e:
        raise CompileError(f"arms of different types: {e}")
    return out


class _Evaluator:
    def __init__(self, fn: Callable, args: Sequence[Expression]):
        self.code = fn.__code__
        if self.code.co_argcount != len(args) or \
                self.code.co_kwonlyargcount or \
                self.code.co_flags & (0x04 | 0x08 | 0x20 | 0x80 | 0x100):
            # *args, **kwargs, generators, coroutines
            raise CompileError("signature")
        self.instructions = list(dis.get_instructions(fn))
        self.by_offset = {ins.offset: i
                          for i, ins in enumerate(self.instructions)}
        self.globals = fn.__globals__
        self.closure = {}
        if fn.__closure__:
            for name, cell in zip(self.code.co_freevars, fn.__closure__):
                self.closure[name] = cell.cell_contents
        self.init_locals = dict(zip(self.code.co_varnames, args))
        self.budget = _MAX_INSTRUCTIONS

    def run(self):
        return self._exec(0, [], dict(self.init_locals))

    def _global(self, name: str):
        if name in self.globals:
            return self.globals[name]
        import builtins
        if hasattr(builtins, name):
            return getattr(builtins, name)
        raise CompileError(f"unknown global {name}")

    def _exec(self, idx: int, stack: List, local_vars: Dict[str, Any]):
        stack = list(stack)
        local_vars = dict(local_vars)
        while True:
            self.budget -= 1
            if self.budget <= 0:
                raise CompileError("instruction budget exceeded")
            if idx >= len(self.instructions):
                raise CompileError("fell off the end of the bytecode")
            ins = self.instructions[idx]
            op = ins.opname
            if op in ("RESUME", "NOP", "CACHE", "COPY_FREE_VARS",
                      "MAKE_CELL", "NOT_TAKEN", "EXTENDED_ARG"):
                pass
            elif op == "PUSH_NULL":
                stack.append(_NULL)
            elif op in ("LOAD_FAST", "LOAD_FAST_CHECK",
                        "LOAD_FAST_BORROW"):
                if ins.argval not in local_vars:
                    raise CompileError(f"unbound local {ins.argval}")
                stack.append(local_vars[ins.argval])
            elif op in ("LOAD_FAST_LOAD_FAST",
                        "LOAD_FAST_BORROW_LOAD_FAST_BORROW"):
                for name in ins.argval:
                    if name not in local_vars:
                        raise CompileError(f"unbound local {name}")
                    stack.append(local_vars[name])
            elif op == "STORE_FAST":
                local_vars[ins.argval] = stack.pop()
            elif op == "STORE_FAST_STORE_FAST":
                a, b = ins.argval
                local_vars[a] = stack.pop()
                local_vars[b] = stack.pop()
            elif op in ("LOAD_CONST", "LOAD_SMALL_INT"):
                stack.append(ins.argval)
            elif op == "LOAD_GLOBAL":
                if ins.arg & 1:
                    stack.append(_NULL)
                stack.append(self._global(ins.argval))
            elif op == "LOAD_DEREF":
                if ins.argval not in self.closure:
                    raise CompileError(f"closure variable {ins.argval}")
                stack.append(self.closure[ins.argval])
            elif op == "LOAD_ATTR":
                obj = stack.pop()
                if ins.arg & 1:
                    stack.append(_NULL)
                    stack.append(_Attr(obj, ins.argval))
                elif isinstance(obj, type(math)) and \
                        obj.__name__ in ("math", "datetime"):
                    stack.append(getattr(obj, ins.argval))
                else:
                    stack.append(_Attr(obj, ins.argval))
            elif op == "BINARY_OP":
                r, l = stack.pop(), stack.pop()
                stack.append(_arith(ins.argrepr.rstrip("="), l, r))
            elif op == "UNARY_NEGATIVE":
                v = stack.pop()
                stack.append(A.UnaryMinus(_number(v)) if _is_expr(v)
                             else -v)
            elif op == "UNARY_NOT":
                v = _truth(stack.pop())
                stack.append(P.Not(v) if _is_expr(v) else not v)
            elif op == "UNARY_INVERT":
                v = stack.pop()
                if _is_expr(v):
                    if not v.dtype.is_integral:
                        raise CompileError(f"~ on {v.dtype}")
                    v = A.BitwiseNot(_number(v))
                else:
                    v = ~v
                stack.append(v)
            elif op == "CALL_INTRINSIC_1" and \
                    ins.argrepr == "INTRINSIC_UNARY_POSITIVE":
                v = stack.pop()
                stack.append(_number(v) if _is_expr(v) else +v)
            elif op == "TO_BOOL":
                stack.append(_truth(stack.pop()))
            elif op == "COMPARE_OP":
                r, l = stack.pop(), stack.pop()
                sym = ins.argrepr.replace("bool(", "").rstrip(")").strip()
                stack.append(_compare(sym, l, r))
            elif op == "IS_OP":
                r, l = stack.pop(), stack.pop()
                if (_is_expr(l) or _is_expr(r)) and \
                        l is not None and r is not None:
                    raise CompileError("`is` between values")
                # a compiled function never sees a null argument (the row
                # is null), so no expression is None
                stack.append((l is r) != bool(ins.arg))
            elif op == "CONTAINS_OP":
                container, item = stack.pop(), stack.pop()
                stack.append(self._contains(item, container, ins.arg))
            elif op in ("POP_JUMP_IF_FALSE", "POP_JUMP_IF_TRUE",
                        "POP_JUMP_IF_NONE", "POP_JUMP_IF_NOT_NONE"):
                v = stack.pop()
                target = self.by_offset[ins.argval]
                if op in ("POP_JUMP_IF_NONE", "POP_JUMP_IF_NOT_NONE"):
                    is_none = v is None  # an expression is never None
                    taken = is_none if op == "POP_JUMP_IF_NONE" \
                        else not is_none
                    idx = target if taken else idx + 1
                    continue
                cond = _truth(v)
                if not _is_expr(cond):
                    taken = (not cond) if op == "POP_JUMP_IF_FALSE" \
                        else cond
                    idx = target if taken else idx + 1
                    continue
                if op == "POP_JUMP_IF_TRUE":
                    cond = P.Not(cond)
                t_val = self._exec(idx + 1, stack, local_vars)
                f_val = self._exec(target, stack, local_vars)
                return _if(cond, t_val, f_val)
            elif op in ("JUMP_FORWARD", "JUMP_BACKWARD_NO_INTERRUPT") and \
                    ins.argval > ins.offset:
                idx = self.by_offset[ins.argval]
                continue
            elif op in ("JUMP_BACKWARD", "JUMP_BACKWARD_NO_INTERRUPT",
                        "FOR_ITER", "GET_ITER"):
                raise CompileError("loops are not compiled")
            elif op == "POP_TOP":
                stack.pop()
            elif op == "COPY":
                stack.append(stack[-ins.arg])
            elif op == "SWAP":
                stack[-1], stack[-ins.arg] = stack[-ins.arg], stack[-1]
            elif op == "RETURN_VALUE":
                return stack.pop()
            elif op == "RETURN_CONST":
                return ins.argval
            elif op == "CALL":
                argc = ins.arg
                args = [stack.pop() for _ in range(argc)][::-1]
                callee = stack.pop()
                if not stack or stack.pop() is not _NULL:
                    raise CompileError("call form")
                stack.append(self._call(callee, args))
            else:
                raise CompileError(f"unsupported opcode {op}")
            idx += 1

    # ---- containment and calls ---------------------------------------------
    @staticmethod
    def _contains(item, container, invert):
        if not _is_expr(item) and not _is_expr(container):
            try:
                res = item in container
            except TypeError as e:
                raise CompileError(str(e))
            return res != bool(invert)
        if _is_expr(container):
            if not container.dtype.is_string or not isinstance(item, str):
                raise CompileError("`in` over a column")
            out = S.Contains(container, item)
        else:
            if not isinstance(container, (tuple, list, set, frozenset)):
                raise CompileError("`in` over a non-sequence constant")
            t = item.dtype
            if t.is_floating or t.is_boolean or t.is_decimal:
                # Python's equality of floats is IEEE's, IN's is Spark's
                raise CompileError(f"`in` over {t} values")
            opts = []
            for o in container:
                ot = _type_of(o)
                if ot.name != t.name and not (
                        ot.is_integral and t.is_integral):
                    raise CompileError("`in` over mixed types")
                opts.append(_lit(o))
            out = P.In(_number(item) if t.is_integral else item, opts)
        return P.Not(out) if invert else out

    def _call(self, callee, args):
        if isinstance(callee, _Attr):
            return self._method_call(callee.obj, callee.name, args)
        if getattr(callee, "__module__", "") == "math" and \
                getattr(math, getattr(callee, "__name__", ""), None) \
                is callee:
            return self._method_call(math, callee.__name__, args)
        if any(a is None for a in args):
            raise CompileError("a None argument")
        if not any(_is_expr(a) for a in args):
            if callee in (abs, min, max, len, round, int, float):
                try:
                    return callee(*args)
                except Exception as e:
                    raise CompileError(f"constant call: {e}")
            raise CompileError(f"call to {callee!r}")
        if callee is abs and len(args) == 1:
            return A.Abs(_number(args[0]))
        if callee in (min, max) and len(args) == 2:
            a, b = args
            sym = "<" if callee is min else ">"
            return _if(_compare(sym, b, a), b, a)
        if callee is len and len(args) == 1:
            if not _type_of(args[0]).is_string:
                raise CompileError("len of a non-string")
            return Cast(S.Length(args[0]), dts.INT64)
        if callee is round and len(args) in (1, 2):
            x = _number(args[0])
            if len(args) == 1:
                return PyRound(x)
            n = args[1]
            if _is_expr(n) or isinstance(n, bool) or \
                    not isinstance(n, int) or not -15 <= n <= 15:
                raise CompileError("round's ndigits must be a constant "
                                   "in [-15, 15]")
            return PyRound(x, n)
        if callee is float and len(args) == 1:
            return Cast(_number(args[0]), dts.FLOAT64)
        if callee is int and len(args) == 1:
            x = _number(args[0])
            return x if x.dtype.is_integral else Cast(x, dts.INT64)
        raise CompileError(f"call to {callee!r}")

    def _method_call(self, obj, name, args):
        if isinstance(obj, type(math)) and obj.__name__ == "math":
            if not any(_is_expr(a) for a in args):
                try:
                    return getattr(math, name)(*args)
                except Exception as e:
                    raise CompileError(f"math.{name}: {e}")
            if name == "pow" and len(args) == 2:
                return A.Pow(_number(args[0]), _number(args[1]))
            if name in _MATH_FNS and len(args) == 1:
                x = _number(args[0])
                if name == "fabs":
                    return A.Abs(Cast(x, dts.FLOAT64))
                out = _MATH_FNS[name](x)
                if name in _DOMAIN_FNS and x.dtype.is_floating:
                    # the logarithms are null outside their domain, but
                    # Python's of a NaN is NaN
                    return _if(P.IsNaN(x), x, out)
                return out
            raise CompileError(f"math.{name}")
        if not _is_expr(obj):
            raise CompileError(f"method {name} of a constant")
        if not obj.dtype.is_string:
            raise CompileError(f"method {name} of {obj.dtype}")
        if name in ("startswith", "endswith") and len(args) == 1 and \
                isinstance(args[0], str):
            cls = S.StartsWith if name == "startswith" else S.EndsWith
            return cls(obj, args[0])
        raise CompileError(f"str.{name}")


# the classes whose value is null wherever one of their inputs is null
_STRICT = (BinaryExpression, UnaryExpression, PyPow, PyRound, Cast,
           S.ConcatStrings, S.StartsWith, S.EndsWith, S.Contains)
_NON_STRICT = (P.And, P.Or, P.IsNull, P.IsNotNull, P.Coalesce)


def _strict_over(e: Expression, args: Sequence[Expression]) -> bool:
    """Whether ``e`` is null wherever any of ``args`` is: every argument
    appears in it, and every node is null-propagating."""
    seen = set()

    def walk(x) -> bool:
        for i, a in enumerate(args):
            if x is a:
                seen.add(i)
                return True
        if isinstance(x, (Literal, NullLiteral)):
            return True
        if isinstance(x, _NON_STRICT) or not isinstance(x, _STRICT):
            return False
        return all(walk(c) for c in x.children)

    return walk(e) and len(seen) == len(args)


def compile_udf(fn: Callable, args: Sequence[Expression]
                ) -> Optional[Expression]:
    """``fn(*args)`` as an expression over the typed (bound) argument
    expressions, or None when it is not compiled."""
    args = list(args)
    try:
        out = _Evaluator(fn, args).run()
        if not _is_expr(out):
            if out is None:
                return None
            out = _lit(out)
        out.dtype  # the tree must type
        if args and not _strict_over(out, args):
            guard = P.IsNotNull(args[0])
            for a in args[1:]:
                guard = P.And(guard, P.IsNotNull(a))
            out = P.CaseWhen([(guard, out)])
        return out
    except CompileError:
        return None
    except (TypeError, ValueError, KeyError, IndexError, RuntimeError,
            AttributeError):
        return None
