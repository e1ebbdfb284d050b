"""The PyTorch port's UDF compiler (``spark_rapids_tpu_torch/udf/compiler.py``)
against Python itself and the JAX package's compiler, on the CPU.

A table of functions covers arithmetic, comparisons, chained comparisons,
``and``/``or``/``not``, ``if``/``else``, locals, closures, ``math.*``,
``abs``/``min``/``max``/``len``/``int``/``float``/``round``, string methods,
``in``, ``is None`` and ``+`` on strings.  Each is compiled by both packages over the
same argument columns: both compile it or both decline, except where this
file's ``DECISIONS`` says otherwise and why.  Each compiled result is
evaluated over 48 rows made from a seed (negatives, zeros, NaN, -0.0,
infinities, ties at .5, tabs and non-ASCII text, nulls) and held against
the Python function called row by row: exactly (a float's sign of zero
included), or within 4 units in the last place for the functions that
call libm (``TRANSCENDENTAL``).  Where Python raises (a division by zero,
a math domain error, an int of NaN) the compiled form follows Spark, as
the compiler's module says, and gives null or NaN (``int``: Java's
conversion); a row with a null argument gives null.  The port's answer
also equals the JAX package's wherever the JAX package agrees with
Python; where it does not (floor division, modulus, round, NaN
comparisons and min/max, and the cases the test finds) only Python's
answer is held.  The same projection runs once more in the CPU fallback
(``spark.rapids.sql.exec.Project=false``), equal value for value.
"""

import datetime
import math

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.ops.expressions import UnresolvedColumn as JCol
from spark_rapids_tpu.udf.compiler import compile_udf as jax_compile
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.ops.expressions import UnresolvedColumn
from spark_rapids_tpu_torch.udf.compiler import compile_udf

D0 = datetime.date(1994, 1, 1)
D1 = datetime.date(1995, 6, 30)
K = 7
N = 48
ULPS = 4


def _closure(k):
    return lambda i: i * k + k


def _branches(x, i):
    if x > 1.0:
        r = x * 2
    elif i < 0:
        r = -x
    else:
        r = x + i
    return r


def _local(p, q):
    net = p * (1 - q)
    if q > 0.0:
        return net * (1 + q)
    return net


def _loop(s):
    n = 0
    for ch in s:
        n += 1
    return n


# name -> (function, argument columns, return type)
FUNCS = {
    "add_int": (lambda i, j: i + j - 3 * i, "ij", "bigint"),
    "mixed": (lambda i, x: i * x + 1, "ix", "double"),
    "truediv": (lambda x, y: x / y, "xy", "double"),
    "truediv_int": (lambda i, j: i / j, "ij", "double"),
    "floordiv_int": (lambda i, j: i // j, "ij", "bigint"),
    "floordiv_float": (lambda x, y: x // y, "xy", "double"),
    "mod_int": (lambda i, j: i % j, "ij", "bigint"),
    "mod_float": (lambda x, y: x % y, "xy", "double"),
    "neg": (lambda x: -x + 0.5, "x", "double"),
    "pow_int": (lambda i: i ** 3, "i", "bigint"),
    "pow_float": (lambda x: x ** 2, "x", "double"),
    "bitwise": (lambda i, j: (i & j) | (i ^ 7), "ij", "bigint"),
    "shift": (lambda i: (i << 3) >> 1, "i", "bigint"),
    "lt_float": (lambda x, y: x < y, "xy", "boolean"),
    "eq_float": (lambda x, y: x == y, "xy", "boolean"),
    "ne_float": (lambda x, y: x != y, "xy", "boolean"),
    "ge_int": (lambda i, j: i >= j, "ij", "boolean"),
    "chained": (lambda x: -1.0 <= x < 2.5, "x", "boolean"),
    "chained_int": (lambda i, j: 0 < i <= j, "ij", "boolean"),
    "date_range": (lambda d: d >= D0 and d < D1, "d", "boolean"),
    "str_lt": (lambda s, t: s < t, "st", "boolean"),
    "str_eq": (lambda s, t: s == t, "st", "boolean"),
    "and_or": (lambda i, x: (i > 0 and x > 0) or i < -5, "ix", "boolean"),
    "not": (lambda x: not x > 1.0, "x", "boolean"),
    "truth_int": (lambda i: 1 if i else 0, "i", "bigint"),
    "truth_str": (lambda s: "y" if s else "n", "s", "string"),
    "and_value": (lambda i, j: i and j, "ij", "bigint"),
    "ternary": (lambda x: x if x > 0 else -x, "x", "double"),
    "branches": (_branches, "xi", "double"),
    "local": (_local, "xy", "double"),
    "closure": (_closure(K), "i", "bigint"),
    "sqrt": (lambda x: math.sqrt(x), "x", "double"),
    "exp_log": (lambda x: math.exp(x / 100.0) + math.log1p(abs(x)), "x",
                "double"),
    "trig": (lambda x: math.sin(x) * math.cos(x) + math.atan(x), "x",
             "double"),
    "floor_ceil": (lambda x: math.floor(x) + math.ceil(x), "x", "bigint"),
    "degrees": (lambda x: math.degrees(x) + math.radians(x), "x", "double"),
    "math_pow": (lambda x, y: math.pow(x, y), "xy", "double"),
    "fabs": (lambda i: math.fabs(i), "i", "double"),
    "abs_int": (lambda i: abs(i), "i", "bigint"),
    "min_float": (lambda x, y: min(x, y), "xy", "double"),
    "max_float": (lambda x, y: max(x, y), "xy", "double"),
    "min_mixed": (lambda i, x: min(i, x), "ix", "double"),
    "len": (lambda s: len(s), "s", "bigint"),
    "int_of_float": (lambda x: int(x), "x", "bigint"),
    "float_of_int": (lambda i: float(i) / 3, "i", "double"),
    "round": (lambda x: round(x), "x", "bigint"),
    "round_2": (lambda x: round(x, 2), "x", "double"),
    "round_neg": (lambda x: round(x, -1), "x", "double"),
    "round_int": (lambda i: round(i, -1), "i", "bigint"),
    "round_big": (lambda b: round(b, 2), "b", "double"),
    "round_big_neg": (lambda b: round(b, -3), "b", "double"),
    "upper": (lambda s: s.upper(), "s", "string"),
    "lower": (lambda s: s.lower(), "s", "string"),
    "startswith": (lambda s: s.startswith("a"), "s", "boolean"),
    "endswith": (lambda s: s.endswith("é"), "s", "boolean"),
    "concat": (lambda s, t: s + "-" + t, "st", "string"),
    "contains": (lambda s: "b" in s, "s", "boolean"),
    "in_tuple": (lambda s: s in ("ab", "zz"), "s", "boolean"),
    "is_none": (lambda x: 0.0 if x is None else x * 2, "x", "double"),
    "strip": (lambda s: s.strip(), "s", "string"),
    "lstrip": (lambda s: s.lstrip(), "s", "string"),
    "rstrip": (lambda s: s.rstrip(), "s", "string"),
    "title": (lambda s: s.title(), "s", "string"),
    "int_of_str": (lambda n: int(n), "n", "bigint"),
    "loop": (_loop, "s", "bigint"),
    "split": (lambda s: s.split(" ")[0], "s", "string"),
    "slice": (lambda s: s[:1], "s", "string"),
}

# where the two compilers decide differently, and why
DECISIONS = {
    # Python maps case over all of Unicode; the device's Upper and Lower
    # map ASCII only
    "upper": "port declines", "lower": "port declines",
    # Python strips all Unicode whitespace; a trim strips spaces only
    "strip": "port declines", "lstrip": "port declines",
    "rstrip": "port declines",
    # Python's title() word rule is not InitCap's
    "title": "port declines",
    # Python parses int(str) by its own rules, not a cast's
    "int_of_str": "port declines",
    # the JAX compiler has no CONTAINS_OP, IS_OP or POP_JUMP_IF_NONE
    "contains": "JAX declines", "in_tuple": "JAX declines",
    "is_none": "JAX declines",
}
# where the JAX package's compiled answer differs from Python's on some
# row (Spark's operator semantics): only Python's answer is held there
JAX_DIVERGES = {
    "floordiv_int": "Spark's div truncates toward zero",
    "floordiv_float": "Spark's div of a NaN or by a float",
    "mod_int": "Spark's % takes the dividend's sign",
    "mod_float": "Java's remainder keeps the dividend's sign of zero",
    "pow_int": "Spark's pow is a double",
    "lt_float": "Spark's NaN is the largest value",
    "not": "Spark's NaN is the largest value",
    "min_float": "Least skips NaN", "max_float": "Greatest takes NaN",
    "min_mixed": "Least skips NaN",
    "truth_str": "a string's truth is its cast to boolean",
    "float_of_int": "XLA's division on the CPU is not correctly rounded",
    "round": "Spark's round is HALF_UP",
    "round_2": "Spark's round is HALF_UP",
    "round_int": "Spark's round is HALF_UP",
    "round_big": "Spark's round of a double is x * 10^n rounded in binary",
    "round_big_neg": "Spark's round of a double is x / 10^n rounded in "
                     "binary",
    "strip": "a trim strips spaces only",
    "lstrip": "a trim strips spaces only",
    "rstrip": "a trim strips spaces only",
    "title": "InitCap's word rule",
    "upper": "ASCII case mapping", "lower": "ASCII case mapping",
    "int_of_str": "a cast does not parse Python's numerals",
}
TRANSCENDENTAL = {"sqrt", "exp_log", "trig", "degrees", "math_pow"}
COLS = {"i": "i", "j": "j", "x": "x", "y": "y", "s": "s", "t": "t",
        "d": "d", "n": "n", "b": "b"}


def _table():
    rng = np.random.default_rng(15)
    i = [0, 1, -1, 7, -7, 2, -2, 3, 1 << 40, -(1 << 40), 10, 25, -3, 6,
         4, -4]
    i += rng.integers(-50, 50, N - len(i)).tolist()
    j = [0, -1, 2, -2, 3, -3, 5, 7, 3, 7, 0, -5, 2, 6, -4, 4]
    j += rng.integers(-9, 9, N - len(j)).tolist()
    x = [2.5, -2.5, 0.5, 1.5, -0.0, 0.0, float("nan"), 0.125, 2.675,
         -1.005, 1e10, -3.7, 7.25, float("inf"), -0.5, 3.5, 1.0,
         -float("inf"), 0.285, 12.5, -12.5, 1.235]
    x += rng.normal(0, 20, N - len(x)).round(3).tolist()
    y = [2.0, -2.0, 0.0, float("nan"), 0.5, -0.25, 3.0, -0.0, 1.5, 7.0,
         -3.7, 2.5, 0.1, 1.0, -1.0, 4.0]
    y += rng.normal(0, 3, N - len(y)).round(2).tolist()
    words = ["ab", "b", "", "\tx ", "é", "ñandú", "zz", "Ab c", "hello world",
             "  pad  ", "a b", "ßa", "Ωmega", "abé", "x y z", "12"]
    s = [words[k % len(words)] for k in range(N)]
    t = [words[(k * 7 + 3) % len(words)] for k in range(N)]
    d = [datetime.date(1993, 1, 1) + datetime.timedelta(days=int(v))
         for v in rng.integers(0, 1100, N)]
    # integers as Python parses them (a cast would not take "1_000")
    numerals = ["12", " 7", "-3", "1_000", "+5", "0", "\t42\n", "-0"]
    n = [numerals[k % len(numerals)] for k in range(N)]
    # magnitudes where x * 10^2 or x / 10^3 pass 2^52 (money in cents of
    # big totals), with ties at the rounded digit
    b = [123456789012.345, 1e15 + 0.25, -1e15 - 0.75, 4503599627370495.5,
         1e17 + 500.0, -2.5e16 + 1500.0, 7.0e14 + 0.125, 9.9e15 + 0.5,
         0.005, -0.015, 1e18 + 1500.0, 2.0 ** 53 + 2.0]
    b += rng.uniform(-1e17, 1e17, N - len(b)).tolist()
    cols = {"i": i, "j": j, "x": x, "y": y, "s": s, "t": t, "d": d,
            "n": n, "b": b}
    # a null in every column, in rows of their own and one row all null
    for k, name in enumerate(cols):
        cols[name][38 + k] = None
        cols[name][47] = None
    types = {"i": pa.int64(), "j": pa.int64(), "x": pa.float64(),
             "y": pa.float64(), "s": pa.string(), "t": pa.string(),
             "d": pa.date32(), "n": pa.string(), "b": pa.float64()}
    return pa.table({n: pa.array(v, type=types[n]) for n, v in cols.items()})


def _python(fn, args):
    """fn over one row: its value, or the exception Python raised."""
    try:
        return fn(*args)
    except (ZeroDivisionError, ValueError, OverflowError) as e:
        return e


def _same(got, want, ulps=0):
    if isinstance(want, bool) or isinstance(got, bool):
        return got == want
    if isinstance(want, float) or isinstance(got, float):
        got, want = float(got), float(want)
        if math.isnan(want) or math.isnan(got):
            return math.isnan(want) and math.isnan(got)
        if ulps and math.isfinite(want):
            return abs(got - want) <= ulps * np.spacing(abs(want))
        return got == want and math.copysign(1, got) == \
            math.copysign(1, want)
    return got == want


@pytest.fixture(scope="module")
def table():
    return _table()


@pytest.fixture(scope="module")
def port_results(table):
    """Every function through the port: compiled where it compiles, on
    the device path in strict mode; and the same again in the CPU
    fallback."""
    out = {}
    for conf, key in (({"spark.rapids.sql.test.enabled": True}, "device"),
                      ({"spark.rapids.sql.exec.Project": False},
                       "fallback")):
        s = TpuSession(conf, device="cpu")
        df = s.create_dataframe(table)
        q = df.select(*[TF.udf(FUNCS[n][0], FUNCS[n][2])(
            *[COLS[a] for a in FUNCS[n][1]]).alias(n) for n in FUNCS])
        got = q.to_arrow()
        for n in FUNCS:
            out.setdefault(key, {})[n] = got.column(n).to_pylist()
        s.stop()
    return out


@pytest.fixture(scope="module")
def jax_results(table):
    s = JaxSession()
    df = s.create_dataframe(table)
    q = df.select(*[JF.udf(FUNCS[n][0], FUNCS[n][2])(
        *[COLS[a] for a in FUNCS[n][1]]).alias(n) for n in FUNCS])
    got = q.to_arrow()
    return {n: got.column(n).to_pylist() for n in FUNCS}


def _port_compiles(table, name) -> bool:
    s = TpuSession({}, device="cpu")
    df = s.create_dataframe(table.slice(0, 1))
    fn, args, rt = FUNCS[name]
    schema = df.plan.schema
    bound = [UnresolvedColumn(COLS[a]).bind(schema) for a in args]
    s.stop()
    return compile_udf(fn, bound) is not None


@pytest.mark.parametrize("name", list(FUNCS))
def test_compile_decision(table, name):
    fn, args, _ = FUNCS[name]
    port = _port_compiles(table, name)
    jax = jax_compile(fn, [JCol(COLS[a]) for a in args]) is not None
    want = DECISIONS.get(name)
    if want == "port declines":
        assert jax and not port
    elif want == "JAX declines":
        assert port and not jax
    else:
        assert port == jax, f"port compiles: {port}, JAX: {jax}"


@pytest.mark.parametrize("name", list(FUNCS))
def test_compiled_equals_python(table, port_results, jax_results, name):
    fn, args, _ = FUNCS[name]
    rows = list(zip(*[table.column(COLS[a]).to_pylist() for a in args]))
    ulps = ULPS if name in TRANSCENDENTAL else 0
    dev = port_results["device"][name]
    fb = port_results["fallback"][name]
    jax = jax_results[name]
    for r, row in enumerate(rows):
        for path, got in (("device", dev[r]), ("fallback", fb[r])):
            if any(v is None for v in row):
                assert got is None, f"row {r} {row}: {path} gave {got!r}"
                continue
            want = _python(fn, row)
            if isinstance(want, Exception):
                # Python raises; the compiled form follows Spark
                if name == "int_of_float" and isinstance(got, int):
                    continue  # Java's conversion of NaN / infinity
                assert got is None or (isinstance(got, float) and (
                    math.isnan(got) or math.isinf(got))) or \
                    name in ("floor_ceil", "round"), \
                    f"row {r} {row}: Python raised {want!r}, {path} {got!r}"
                continue
            if isinstance(want, int) and not isinstance(want, bool) and \
                    not -(1 << 63) <= want < (1 << 63):
                # Python's int grows; the compiled form wraps at int64
                want = (want + (1 << 63)) % (1 << 64) - (1 << 63)
            assert _same(got, want, ulps), \
                f"row {r} {row}: {path} {got!r}, Python {want!r}"
            if path == "device" and name not in JAX_DIVERGES:
                # the JAX package agrees with Python here, and the port
                # with the JAX package
                assert jax[r] is not None and _same(jax[r], want, ulps), \
                    f"row {r} {row}: JAX {jax[r]!r}, Python {want!r}"
                assert _same(got, jax[r], ulps)
