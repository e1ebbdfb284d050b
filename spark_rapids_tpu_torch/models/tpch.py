"""TPC-H: synthetic data generator and the 22 query pipelines.

Counterpart of ``spark_rapids_tpu/models/tpch.py`` (whose copy imports the
JAX engine's session).  ``gen_tables`` is the JAX package's generator,
copied as is: pure numpy/pandas, so at the same ``sf`` and seed it gives
frame for frame the same tables.  ``gen_table_columns`` draws the same
random stream and builds the same values as column buffers (strings as
offsets and chars from byte tables, no Python string objects), so the
tables reach SF10 in host memory and time a chip run can afford;
``load_columns`` puts them on a session's device.  ``QUERIES`` holds all
22 queries, copied from the JAX package's.

Through ``load`` (pandas -> arrow) the date columns arrive as timestamps,
as they do in the JAX package; through ``load_columns`` they are dates.
"""

from __future__ import annotations

import datetime
from typing import Callable, Dict

import numpy as np
import pandas as pd

from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.dataframe import DataFrame


def _d(s: str):
    return np.datetime64(s, "D").astype("datetime64[D]")


SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
RETURNFLAGS = ["R", "A", "N"]
LINESTATUS = ["O", "F"]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = ["ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT", "ETHIOPIA",
           "FRANCE", "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ",
           "JAPAN", "JORDAN", "KENYA", "MOROCCO", "MOZAMBIQUE", "PERU",
           "CHINA", "ROMANIA", "SAUDI ARABIA", "VIETNAM", "RUSSIA",
           "UNITED KINGDOM", "UNITED STATES"]
TYPES = [f"{a} {b} {c}" for a in ("STANDARD", "SMALL", "MEDIUM", "LARGE",
                                  "ECONOMY", "PROMO")
         for b in ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED")
         for c in ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER")]
COLORS = ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
          "black", "blanched", "blue", "blush", "brown", "burlywood",
          "burnished", "chartreuse", "chiffon", "chocolate", "coral",
          "cornflower", "cornsilk", "cream", "cyan", "dark", "deep",
          "dim", "dodger", "drab", "firebrick", "floral", "forest",
          "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey",
          "honeydew", "hot", "hotpink", "indian", "ivory", "khaki",
          "lace", "lavender", "lawn", "lemon", "light", "lime", "linen",
          "magenta", "maroon", "medium", "metallic", "midnight", "mint",
          "misty", "moccasin", "navajo", "navy", "olive", "orange",
          "orchid", "pale", "papaya", "peach", "peru", "pink", "plum",
          "powder", "puff", "purple", "red", "rose", "rosy", "royal",
          "saddle", "salmon", "sandy", "seashell", "sienna", "sky",
          "slate", "smoke", "snow", "spring", "steel", "tan", "thistle",
          "tomato", "turquoise", "violet", "wheat", "white", "yellow"]
COMMENT_WORDS = ["carefully", "quickly", "furiously", "slyly", "blithely",
                 "pending", "final", "express", "regular", "ironic",
                 "deposits", "packages", "accounts", "theodolites",
                 "instructions", "foxes", "pinto", "beans", "requests",
                 "special", "even", "bold", "unusual", "silent"]


def gen_tables(sf: float = 0.01, seed: int = 7) -> Dict[str, pd.DataFrame]:
    rng = np.random.default_rng(seed)
    n_orders = max(int(1_500_000 * sf), 100)
    n_line = max(int(6_000_000 * sf), 400)
    n_cust = max(int(150_000 * sf), 50)
    n_part = max(int(200_000 * sf), 40)
    n_supp = max(int(10_000 * sf), 10)

    def comments(n, special_frac=0.05):
        w = rng.choice(COMMENT_WORDS, (n, 4))
        out = np.array([" ".join(r) for r in w], dtype=object)
        k = max(int(n * special_frac), 1)
        idx = rng.choice(n, k, replace=False)
        out[idx] = np.array(
            [f"{a} special {b} requests {c}"
             for a, b, c in rng.choice(COMMENT_WORDS, (k, 3))],
            dtype=object)
        return out

    base = _d("1992-01-01")
    order_dates = base + rng.integers(0, 2405, n_orders)
    # spec: customers with custkey % 3 == 0 place no orders (drives q13/q22)
    with_orders = np.arange(1, n_cust + 1, dtype=np.int64)
    with_orders = with_orders[with_orders % 3 != 0]
    orders = pd.DataFrame({
        "o_orderkey": np.arange(1, n_orders + 1, dtype=np.int64),
        "o_custkey": rng.choice(with_orders, n_orders),
        "o_orderstatus": rng.choice(["O", "F", "P"], n_orders),
        "o_totalprice": rng.uniform(800, 500000, n_orders).round(2),
        "o_orderdate": order_dates.astype("datetime64[D]"),
        "o_orderpriority": rng.choice(PRIORITIES, n_orders),
        "o_shippriority": np.zeros(n_orders, dtype=np.int32),
        "o_comment": comments(n_orders),
    })

    okeys = rng.integers(1, n_orders + 1, n_line)
    ship_delay = rng.integers(1, 122, n_line)
    odate_for_line = np.asarray(order_dates)[okeys - 1]
    shipdate = odate_for_line + ship_delay
    lineitem = pd.DataFrame({
        "l_orderkey": okeys.astype(np.int64),
        "l_partkey": rng.integers(1, n_part + 1, n_line),
        "l_suppkey": rng.integers(1, n_supp + 1, n_line),
        "l_linenumber": rng.integers(1, 8, n_line).astype(np.int32),
        "l_quantity": rng.integers(1, 51, n_line).astype(np.float64),
        "l_extendedprice": rng.uniform(900, 105000, n_line).round(2),
        "l_discount": (rng.integers(0, 11, n_line) / 100.0),
        "l_tax": (rng.integers(0, 9, n_line) / 100.0),
        "l_returnflag": rng.choice(RETURNFLAGS, n_line),
        "l_linestatus": rng.choice(LINESTATUS, n_line),
        "l_shipdate": shipdate.astype("datetime64[D]"),
        "l_commitdate": (odate_for_line +
                         rng.integers(30, 92, n_line)).astype(
                             "datetime64[D]"),
        "l_receiptdate": (shipdate +
                          rng.integers(1, 31, n_line)).astype(
                              "datetime64[D]"),
        "l_shipinstruct": rng.choice(
            ["DELIVER IN PERSON", "COLLECT COD", "NONE",
             "TAKE BACK RETURN"], n_line),
        "l_shipmode": rng.choice(SHIPMODES, n_line),
    })

    cnation = rng.integers(0, 25, n_cust).astype(np.int64)
    customer = pd.DataFrame({
        "c_custkey": np.arange(1, n_cust + 1, dtype=np.int64),
        "c_name": [f"Customer#{i:09d}" for i in range(1, n_cust + 1)],
        "c_nationkey": cnation,
        "c_phone": [f"{nk + 10}-{rng.integers(100, 999)}-"
                    f"{rng.integers(100, 999)}-{rng.integers(1000, 9999)}"
                    for nk in cnation],
        "c_acctbal": rng.uniform(-999, 9999, n_cust).round(2),
        "c_mktsegment": rng.choice(SEGMENTS, n_cust),
        "c_comment": comments(n_cust),
    })

    name_words = rng.choice(COLORS, (n_part, 5))
    part = pd.DataFrame({
        "p_partkey": np.arange(1, n_part + 1, dtype=np.int64),
        "p_name": [" ".join(r) for r in name_words],
        "p_mfgr": [f"Manufacturer#{rng.integers(1, 6)}"
                   for _ in range(n_part)],
        "p_brand": [f"Brand#{rng.integers(1, 6)}{rng.integers(1, 6)}"
                    for _ in range(n_part)],
        "p_type": rng.choice(TYPES, n_part),
        "p_size": rng.integers(1, 51, n_part).astype(np.int32),
        "p_container": rng.choice(
            ["SM CASE", "SM BOX", "MED BAG", "MED BOX", "LG CASE",
             "LG BOX", "JUMBO PKG", "WRAP PACK"], n_part),
        "p_retailprice": rng.uniform(900, 2000, n_part).round(2),
    })

    scomment = comments(n_supp)
    k = max(n_supp // 20, 1)
    idx = rng.choice(n_supp, k, replace=False)
    scomment[idx] = np.array(
        [f"{a} Customer {b} Complaints {c}"
         for a, b, c in rng.choice(COMMENT_WORDS, (k, 3))], dtype=object)
    supplier = pd.DataFrame({
        "s_suppkey": np.arange(1, n_supp + 1, dtype=np.int64),
        "s_name": [f"Supplier#{i:09d}" for i in range(1, n_supp + 1)],
        "s_address": [f"addr {i}" for i in range(1, n_supp + 1)],
        "s_nationkey": rng.integers(0, 25, n_supp).astype(np.int64),
        "s_phone": [f"{rng.integers(10, 35)}-{rng.integers(100, 999)}-"
                    f"{rng.integers(100, 999)}-{rng.integers(1000, 9999)}"
                    for _ in range(n_supp)],
        "s_acctbal": rng.uniform(-999, 9999, n_supp).round(2),
        "s_comment": scomment,
    })

    # partsupp: each part has 4 suppliers; spec formula
    # s = (p + i*(S/4 + (p-1)/S)) % S + 1 guarantees distinct suppliers
    ps_part = np.repeat(np.arange(1, n_part + 1, dtype=np.int64), 4)
    i = np.tile(np.arange(4, dtype=np.int64), n_part)
    ps_supp = ((ps_part + i * (n_supp // 4 + (ps_part - 1) // n_supp))
               % n_supp) + 1
    partsupp = pd.DataFrame({
        "ps_partkey": ps_part,
        "ps_suppkey": ps_supp,
        "ps_availqty": rng.integers(1, 10000, len(ps_part)).astype(
            np.int32),
        "ps_supplycost": rng.uniform(1, 1000, len(ps_part)).round(2),
    })

    nation = pd.DataFrame({
        "n_nationkey": np.arange(25, dtype=np.int64),
        "n_name": NATIONS,
        "n_regionkey": np.arange(25, dtype=np.int64) % 5,
    })
    region = pd.DataFrame({
        "r_regionkey": np.arange(5, dtype=np.int64),
        "r_name": REGIONS,
    })
    return {"lineitem": lineitem, "orders": orders, "customer": customer,
            "part": part, "supplier": supplier, "partsupp": partsupp,
            "nation": nation, "region": region}


def load(session, tables: Dict[str, pd.DataFrame]) -> Dict[str, DataFrame]:
    return {name: session.create_dataframe(df)
            for name, df in tables.items()}


# ------------------------------------------------ columns without pandas

def _parts_matrix(parts, n: int):
    """Rows built by concatenating ``parts`` left to right, as a
    zero-padded ``(n, width)`` uint8 matrix and the row lengths.  A part is
    a constant ``bytes`` or ``(codes, vocab)``: row i takes the word
    ``vocab[codes[i]]`` (an empty word is allowed)."""
    specs = []
    for part in parts:
        if isinstance(part, bytes):
            table = np.frombuffer(part, dtype=np.uint8)[None, :]
            specs.append((np.zeros(n, dtype=np.int64), table,
                          np.array([len(part)], dtype=np.int64)))
            continue
        codes, vocab = part
        words = [w.encode("utf-8") for w in vocab]
        lens = np.array([len(w) for w in words], dtype=np.int64)
        table = np.zeros((len(words), max(int(lens.max()), 1)),
                         dtype=np.uint8)
        for i, w in enumerate(words):
            table[i, :len(w)] = np.frombuffer(w, dtype=np.uint8)
        specs.append((np.asarray(codes, dtype=np.int64), table, lens))
    if len(specs) == 1:
        codes, table, lens = specs[0]
        return table[codes], lens[codes]
    total = np.zeros(n, dtype=np.int64)
    for codes, _, lens in specs:
        total += lens[codes]
    width = int(total.max()) if n else 0
    mat = np.zeros((n, width), dtype=np.uint8)
    flat = mat.reshape(-1)
    rows = np.arange(n, dtype=np.int64) * width
    start = np.zeros(n, dtype=np.int64)
    for codes, table, lens in specs:
        plen = lens[codes]
        for b in range(table.shape[1]):
            sel = np.nonzero(plen > b)[0]
            flat[rows[sel] + start[sel] + b] = table[codes[sel], b]
        start += plen
    return mat, total


def _buffers(mat: np.ndarray, lens: np.ndarray):
    """(offsets int64[n+1], chars uint8) of the rows of a padded matrix."""
    offsets = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    if mat.shape[1] == 0:
        return offsets, np.zeros(0, dtype=np.uint8)
    keep = np.arange(mat.shape[1], dtype=np.int64)[None, :] < lens[:, None]
    return offsets, mat[keep]


def _strings(parts, n: int):
    return _buffers(*_parts_matrix(parts, n))


_DIGITS = [str(d) for d in range(10)] + [""]


def _digit_parts(values: np.ndarray, width: int, pad: bool = True):
    """Parts writing each value in decimal over ``width`` digit places:
    zero-padded, or (``pad=False``) without leading zeros."""
    values = np.asarray(values, dtype=np.int64)
    parts = []
    for k in reversed(range(width)):
        digit = (values // 10 ** k) % 10
        if not pad and k:
            digit = np.where(values < 10 ** k, 10, digit)  # 10 is ""
        parts.append((digit, _DIGITS))
    return parts


def _words(codes: np.ndarray, vocab, sep: bytes = b" "):
    """Parts joining each row's words (``codes[i, j]``) with ``sep``."""
    parts = []
    for j in range(codes.shape[1]):
        if j:
            parts.append(sep)
        parts.append((codes[:, j], vocab))
    return parts


def _with_rows(base, idx: np.ndarray, repl):
    """The padded matrix ``base`` with rows ``idx`` replaced by ``repl``
    (both ``(matrix, lengths)``)."""
    mat, lens = base
    rmat, rlens = repl
    width = max(mat.shape[1], rmat.shape[1])
    if width > mat.shape[1]:
        mat = np.pad(mat, ((0, 0), (0, width - mat.shape[1])))
    mat[idx] = 0
    mat[idx, :rmat.shape[1]] = rmat
    lens = lens.copy()
    lens[idx] = rlens
    return mat, lens


def _scalar_draws(rows, width: int) -> np.ndarray:
    """``(n, width)`` int64 array of per-row scalar draws."""
    return np.array(rows, dtype=np.int64).reshape(-1, width)


def gen_table_columns(sf: float = 0.01, seed: int = 7) -> Dict[str, Dict]:
    """Every column of ``gen_tables(sf, seed)``, value for value, in the
    form ``interop.batch_from_arrays`` takes: ``{table: {column: (type
    name, values, None)}}``, dates as int32 days since the epoch, strings
    as ``(offsets, chars)`` built from byte tables without Python string
    objects.  The generator's random stream is drawn in the same order:
    ``Generator.choice`` over a list draws what ``integers`` over its
    length draws, and the per-row scalar draws (``c_phone``, ``p_mfgr``,
    ``p_brand``, ``s_phone``) stay scalar calls in a loop, as a vectorised
    ``integers`` consumes the stream another way."""
    rng = np.random.default_rng(seed)
    n_orders = max(int(1_500_000 * sf), 100)
    n_line = max(int(6_000_000 * sf), 400)
    n_cust = max(int(150_000 * sf), 50)
    n_part = max(int(200_000 * sf), 40)
    n_supp = max(int(10_000 * sf), 10)
    n_words = len(COMMENT_WORDS)

    def comments(n, special_frac=0.05):
        base = _parts_matrix(_words(rng.integers(0, n_words, (n, 4)),
                                    COMMENT_WORDS), n)
        k = max(int(n * special_frac), 1)
        idx = rng.choice(n, k, replace=False)
        w = rng.integers(0, n_words, (k, 3))
        special = _parts_matrix(
            [(w[:, 0], COMMENT_WORDS), b" special ", (w[:, 1], COMMENT_WORDS),
             b" requests ", (w[:, 2], COMMENT_WORDS)], k)
        return _with_rows(base, idx, special)

    def vocab(codes, words):
        return ("string", _strings([(codes, words)], len(codes)), None)

    def col(type_name, values):
        return (type_name, values, None)

    day0 = int(_d("1992-01-01").astype(np.int64))
    order_dates = day0 + rng.integers(0, 2405, n_orders)
    with_orders = np.arange(1, n_cust + 1, dtype=np.int64)
    with_orders = with_orders[with_orders % 3 != 0]
    orders = {
        "o_orderkey": col("bigint", np.arange(1, n_orders + 1,
                                              dtype=np.int64)),
        "o_custkey": col("bigint", rng.choice(with_orders, n_orders)),
        "o_orderstatus": vocab(rng.integers(0, 3, n_orders),
                               ["O", "F", "P"]),
        "o_totalprice": col("double",
                            rng.uniform(800, 500000, n_orders).round(2)),
        "o_orderdate": col("date", order_dates.astype(np.int32)),
        "o_orderpriority": vocab(rng.integers(0, len(PRIORITIES), n_orders),
                                 PRIORITIES),
        "o_shippriority": col("int", np.zeros(n_orders, dtype=np.int32)),
        "o_comment": ("string", _buffers(*comments(n_orders)), None),
    }

    okeys = rng.integers(1, n_orders + 1, n_line)
    ship_delay = rng.integers(1, 122, n_line)
    odate_for_line = order_dates[okeys - 1]
    shipdate = odate_for_line + ship_delay
    lineitem = {"l_orderkey": col("bigint", okeys.astype(np.int64))}
    lineitem["l_partkey"] = col("bigint",
                                rng.integers(1, n_part + 1, n_line))
    lineitem["l_suppkey"] = col("bigint",
                                rng.integers(1, n_supp + 1, n_line))
    lineitem["l_linenumber"] = col(
        "int", rng.integers(1, 8, n_line).astype(np.int32))
    lineitem["l_quantity"] = col(
        "double", rng.integers(1, 51, n_line).astype(np.float64))
    lineitem["l_extendedprice"] = col(
        "double", rng.uniform(900, 105000, n_line).round(2))
    lineitem["l_discount"] = col("double",
                                 rng.integers(0, 11, n_line) / 100.0)
    lineitem["l_tax"] = col("double", rng.integers(0, 9, n_line) / 100.0)
    lineitem["l_returnflag"] = vocab(
        rng.integers(0, len(RETURNFLAGS), n_line), RETURNFLAGS)
    lineitem["l_linestatus"] = vocab(
        rng.integers(0, len(LINESTATUS), n_line), LINESTATUS)
    lineitem["l_shipdate"] = col("date", shipdate.astype(np.int32))
    lineitem["l_commitdate"] = col(
        "date", (odate_for_line + rng.integers(30, 92, n_line))
        .astype(np.int32))
    lineitem["l_receiptdate"] = col(
        "date", (shipdate + rng.integers(1, 31, n_line)).astype(np.int32))
    lineitem["l_shipinstruct"] = vocab(
        rng.integers(0, 4, n_line),
        ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"])
    lineitem["l_shipmode"] = vocab(rng.integers(0, len(SHIPMODES), n_line),
                                   SHIPMODES)

    cnation = rng.integers(0, 25, n_cust).astype(np.int64)
    draw = rng.integers
    phone = _scalar_draws([(draw(100, 999), draw(100, 999),  # c_phone
                            draw(1000, 9999)) for _ in range(n_cust)], 3)
    custkey = np.arange(1, n_cust + 1, dtype=np.int64)
    customer = {
        "c_custkey": col("bigint", custkey),
        "c_name": ("string", _strings([b"Customer#"]
                                      + _digit_parts(custkey, 9), n_cust),
                   None),
        "c_nationkey": col("bigint", cnation),
        "c_phone": ("string", _strings(
            _digit_parts(cnation + 10, 2) + [b"-"]
            + _digit_parts(phone[:, 0], 3) + [b"-"]
            + _digit_parts(phone[:, 1], 3) + [b"-"]
            + _digit_parts(phone[:, 2], 4), n_cust), None),
    }
    customer["c_acctbal"] = col("double",
                                rng.uniform(-999, 9999, n_cust).round(2))
    customer["c_mktsegment"] = vocab(rng.integers(0, len(SEGMENTS), n_cust),
                                     SEGMENTS)
    customer["c_comment"] = ("string", _buffers(*comments(n_cust)), None)

    name_words = rng.integers(0, len(COLORS), (n_part, 5))
    mfgr = _scalar_draws([draw(1, 6) for _ in range(n_part)], 1)
    brand = _scalar_draws([(draw(1, 6), draw(1, 6))
                           for _ in range(n_part)], 2)
    part = {
        "p_partkey": col("bigint", np.arange(1, n_part + 1,
                                             dtype=np.int64)),
        "p_name": ("string", _strings(_words(name_words, COLORS), n_part),
                   None),
        "p_mfgr": ("string", _strings([b"Manufacturer#"]
                                      + _digit_parts(mfgr[:, 0], 1), n_part),
                   None),
        "p_brand": ("string", _strings(
            [b"Brand#"] + _digit_parts(brand[:, 0], 1)
            + _digit_parts(brand[:, 1], 1), n_part), None),
    }
    part["p_type"] = vocab(rng.integers(0, len(TYPES), n_part), TYPES)
    part["p_size"] = col("int",
                         rng.integers(1, 51, n_part).astype(np.int32))
    part["p_container"] = vocab(
        rng.integers(0, 8, n_part),
        ["SM CASE", "SM BOX", "MED BAG", "MED BOX", "LG CASE", "LG BOX",
         "JUMBO PKG", "WRAP PACK"])
    part["p_retailprice"] = col("double",
                                rng.uniform(900, 2000, n_part).round(2))

    scomment = comments(n_supp)
    k = max(n_supp // 20, 1)
    idx = rng.choice(n_supp, k, replace=False)
    w = rng.integers(0, n_words, (k, 3))
    scomment = _with_rows(scomment, idx, _parts_matrix(
        [(w[:, 0], COMMENT_WORDS), b" Customer ", (w[:, 1], COMMENT_WORDS),
         b" Complaints ", (w[:, 2], COMMENT_WORDS)], k))
    suppkey = np.arange(1, n_supp + 1, dtype=np.int64)
    supplier = {
        "s_suppkey": col("bigint", suppkey),
        "s_name": ("string", _strings([b"Supplier#"]
                                      + _digit_parts(suppkey, 9), n_supp),
                   None),
        "s_address": ("string", _strings(
            [b"addr "] + _digit_parts(suppkey, len(str(n_supp)),
                                      pad=False), n_supp), None),
        "s_nationkey": col("bigint",
                           rng.integers(0, 25, n_supp).astype(np.int64)),
    }
    sphone = _scalar_draws([(draw(10, 35), draw(100, 999),  # s_phone
                             draw(100, 999), draw(1000, 9999))
                            for _ in range(n_supp)], 4)
    supplier["s_phone"] = ("string", _strings(
        _digit_parts(sphone[:, 0], 2) + [b"-"]
        + _digit_parts(sphone[:, 1], 3) + [b"-"]
        + _digit_parts(sphone[:, 2], 3) + [b"-"]
        + _digit_parts(sphone[:, 3], 4), n_supp), None)
    supplier["s_acctbal"] = col("double",
                                rng.uniform(-999, 9999, n_supp).round(2))
    supplier["s_comment"] = ("string", _buffers(*scomment), None)

    ps_part = np.repeat(np.arange(1, n_part + 1, dtype=np.int64), 4)
    i4 = np.tile(np.arange(4, dtype=np.int64), n_part)
    ps_supp = ((ps_part + i4 * (n_supp // 4 + (ps_part - 1) // n_supp))
               % n_supp) + 1
    partsupp = {
        "ps_partkey": col("bigint", ps_part),
        "ps_suppkey": col("bigint", ps_supp),
        "ps_availqty": col("int", rng.integers(1, 10000, len(ps_part))
                           .astype(np.int32)),
        "ps_supplycost": col("double", rng.uniform(1, 1000, len(ps_part))
                             .round(2)),
    }
    nation = {
        "n_nationkey": col("bigint", np.arange(25, dtype=np.int64)),
        "n_name": vocab(np.arange(25), NATIONS),
        "n_regionkey": col("bigint", np.arange(25, dtype=np.int64) % 5),
    }
    region = {
        "r_regionkey": col("bigint", np.arange(5, dtype=np.int64)),
        "r_name": vocab(np.arange(5), REGIONS),
    }
    return {"lineitem": lineitem, "orders": orders, "customer": customer,
            "part": part, "supplier": supplier, "partsupp": partsupp,
            "nation": nation, "region": region}


def load_columns(session, columns: Dict[str, Dict]) -> Dict[str, DataFrame]:
    """DataFrames over ``gen_table_columns`` output, each table copied to
    the session's device once."""
    from spark_rapids_tpu_torch.interop import batch_from_arrays
    return {name: session.create_dataframe(
        batch_from_arrays(cols, device=session.device))
        for name, cols in columns.items()}


# ------------------------------------------------------------------- queries

def _join(left: DataFrame, right: DataFrame, lk, rk=None,
          how: str = "inner") -> DataFrame:
    """Join helper: renames right-side keys to the left-side names so the
    using-columns join applies, mirroring the rename-then-join idiom."""
    lk = [lk] if isinstance(lk, str) else list(lk)
    rk = lk if rk is None else ([rk] if isinstance(rk, str) else list(rk))
    for a, b in zip(lk, rk):
        if a != b:
            right = right.withColumnRenamed(b, a)
    return left.join(right, on=lk, how=how)


def q1(t: Dict[str, DataFrame]) -> DataFrame:
    """Pricing summary report."""
    l = t["lineitem"]
    disc_price = F.col("l_extendedprice") * (1 - F.col("l_discount"))
    charge = disc_price * (1 + F.col("l_tax"))
    return (l.filter(F.col("l_shipdate") <=
                     F.lit(datetime.date(1998, 9, 2)))
            .groupBy("l_returnflag", "l_linestatus")
            .agg(F.sum("l_quantity").alias("sum_qty"),
                 F.sum("l_extendedprice").alias("sum_base_price"),
                 F.sum(disc_price).alias("sum_disc_price"),
                 F.sum(charge).alias("sum_charge"),
                 F.avg("l_quantity").alias("avg_qty"),
                 F.avg("l_extendedprice").alias("avg_price"),
                 F.avg("l_discount").alias("avg_disc"),
                 F.count().alias("count_order"))
            .orderBy("l_returnflag", "l_linestatus"))


def q3(t: Dict[str, DataFrame]) -> DataFrame:
    """Shipping priority."""
    cutoff = datetime.date(1995, 3, 15)
    c = t["customer"].filter(F.col("c_mktsegment") == F.lit("BUILDING"))
    o = t["orders"].filter(F.col("o_orderdate") < F.lit(cutoff))
    l = t["lineitem"].filter(F.col("l_shipdate") > F.lit(cutoff))
    rev = F.col("l_extendedprice") * (1 - F.col("l_discount"))
    joined = c.select("c_custkey") \
        .withColumnRenamed("c_custkey", "o_custkey") \
        .join(o, on="o_custkey", how="inner")
    joined = joined.withColumnRenamed("o_orderkey", "l_orderkey") \
        .join(l, on="l_orderkey", how="inner")
    return (joined.groupBy("l_orderkey", "o_orderdate", "o_shippriority")
            .agg(F.sum(rev).alias("revenue"))
            .orderBy(F.col("revenue").desc(), "o_orderdate")
            .limit(10))


def q5(t: Dict[str, DataFrame]) -> DataFrame:
    """Local supplier volume: ASIA, 1994."""
    o = t["orders"].filter(
        (F.col("o_orderdate") >= F.lit(datetime.date(1994, 1, 1))) &
        (F.col("o_orderdate") < F.lit(datetime.date(1995, 1, 1))))
    r = t["region"].filter(F.col("r_name") == F.lit("ASIA"))
    n = t["nation"].withColumnRenamed("n_regionkey", "r_regionkey") \
        .join(r, on="r_regionkey", how="inner")
    s = t["supplier"].withColumnRenamed("s_nationkey", "n_nationkey") \
        .join(n.select("n_nationkey", "n_name"), on="n_nationkey")
    c = t["customer"].withColumnRenamed("c_nationkey", "n_nationkey")
    rev = F.col("l_extendedprice") * (1 - F.col("l_discount"))
    l = t["lineitem"].withColumnRenamed("l_suppkey", "s_suppkey")
    oc = o.withColumnRenamed("o_custkey", "c_custkey") \
        .join(c.select("c_custkey", "n_nationkey"), on="c_custkey")
    lo = l.withColumnRenamed("l_orderkey", "o_orderkey") \
        .join(oc.select("o_orderkey", "n_nationkey"), on="o_orderkey")
    # supplier nation must equal customer nation
    ls = lo.join(s.select("s_suppkey", "n_nationkey", "n_name")
                 .withColumnRenamed("n_nationkey", "s_nation")
                 .withColumnRenamed("n_name", "n_name"),
                 on="s_suppkey")
    same = ls.filter(F.col("n_nationkey") == F.col("s_nation"))
    return (same.groupBy("n_name").agg(F.sum(rev).alias("revenue"))
            .orderBy(F.col("revenue").desc()))


def q6(t: Dict[str, DataFrame]) -> DataFrame:
    """Forecasting revenue change (the benchmark slice)."""
    l = t["lineitem"]
    return (l.filter(
        (F.col("l_shipdate") >= F.lit(datetime.date(1994, 1, 1))) &
        (F.col("l_shipdate") < F.lit(datetime.date(1995, 1, 1))) &
        (F.col("l_discount") >= 0.05) & (F.col("l_discount") <= 0.07) &
        (F.col("l_quantity") < 24.0))
        .select((F.col("l_extendedprice") * F.col("l_discount"))
                .alias("rev"))
        .agg(F.sum("rev").alias("revenue")))


def q12(t: Dict[str, DataFrame]) -> DataFrame:
    """Shipping modes and order priority."""
    l = t["lineitem"].filter(
        (F.col("l_shipmode").isin("MAIL", "SHIP")) &
        (F.col("l_commitdate") < F.col("l_receiptdate")) &
        (F.col("l_shipdate") < F.col("l_commitdate")) &
        (F.col("l_receiptdate") >= F.lit(datetime.date(1994, 1, 1))) &
        (F.col("l_receiptdate") < F.lit(datetime.date(1995, 1, 1))))
    o = t["orders"]
    j = l.withColumnRenamed("l_orderkey", "o_orderkey") \
        .join(o.select("o_orderkey", "o_orderpriority"), on="o_orderkey")
    high = F.when((F.col("o_orderpriority") == F.lit("1-URGENT")) |
                  (F.col("o_orderpriority") == F.lit("2-HIGH")), 1) \
        .otherwise(0)
    low = F.when((F.col("o_orderpriority") != F.lit("1-URGENT")) &
                 (F.col("o_orderpriority") != F.lit("2-HIGH")), 1) \
        .otherwise(0)
    return (j.groupBy("l_shipmode")
            .agg(F.sum(high).alias("high_line_count"),
                 F.sum(low).alias("low_line_count"))
            .orderBy("l_shipmode"))


def q14(t: Dict[str, DataFrame]) -> DataFrame:
    """Promotion effect."""
    l = t["lineitem"].filter(
        (F.col("l_shipdate") >= F.lit(datetime.date(1995, 9, 1))) &
        (F.col("l_shipdate") < F.lit(datetime.date(1995, 10, 1))))
    p = t["part"]
    j = l.withColumnRenamed("l_partkey", "p_partkey") \
        .join(p.select("p_partkey", "p_type"), on="p_partkey")
    rev = F.col("l_extendedprice") * (1 - F.col("l_discount"))
    promo = F.when(F.col("p_type").like("PROMO%"), rev).otherwise(0.0)
    return j.agg((F.sum(promo) * 100.0).alias("promo_sum"),
                 F.sum(rev).alias("total_sum"))


def q2(t: Dict[str, DataFrame]) -> DataFrame:
    """Minimum cost supplier: size-15 %BRASS parts, EUROPE."""
    p = t["part"].filter((F.col("p_size") == 15) &
                         F.col("p_type").like("%BRASS"))
    r = t["region"].filter(F.col("r_name") == F.lit("EUROPE"))
    n = _join(t["nation"], r.select("r_regionkey"),
              "n_regionkey", "r_regionkey")
    s = _join(t["supplier"], n.select("n_nationkey", "n_name"),
              "s_nationkey", "n_nationkey")
    ps = _join(t["partsupp"], p.select("p_partkey", "p_mfgr"),
               "ps_partkey", "p_partkey")
    ps = _join(ps, s.select("s_suppkey", "s_acctbal", "s_name", "s_address",
                            "s_phone", "n_name"),
               "ps_suppkey", "s_suppkey")
    minc = ps.groupBy("ps_partkey").agg(
        F.min("ps_supplycost").alias("min_cost"))
    best = _join(ps, minc, "ps_partkey").filter(
        F.col("ps_supplycost") == F.col("min_cost"))
    return (best.select("s_acctbal", "s_name", "n_name", "ps_partkey",
                        "p_mfgr", "s_address", "s_phone")
            .orderBy(F.col("s_acctbal").desc(), "n_name", "s_name",
                     "ps_partkey")
            .limit(100))


def q4(t: Dict[str, DataFrame]) -> DataFrame:
    """Order priority checking (EXISTS -> semi join)."""
    o = t["orders"].filter(
        (F.col("o_orderdate") >= F.lit(datetime.date(1993, 7, 1))) &
        (F.col("o_orderdate") < F.lit(datetime.date(1993, 10, 1))))
    late = t["lineitem"].filter(
        F.col("l_commitdate") < F.col("l_receiptdate")) \
        .select("l_orderkey")
    j = _join(o, late, "o_orderkey", "l_orderkey", how="semi")
    return (j.groupBy("o_orderpriority")
            .agg(F.count().alias("order_count"))
            .orderBy("o_orderpriority"))


def q7(t: Dict[str, DataFrame]) -> DataFrame:
    """Volume shipping FRANCE <-> GERMANY."""
    n = t["nation"].select("n_nationkey", "n_name")
    s = _join(t["supplier"].select("s_suppkey", "s_nationkey"),
              n.withColumnRenamed("n_name", "supp_nation"),
              "s_nationkey", "n_nationkey")
    c = _join(t["customer"].select("c_custkey", "c_nationkey"),
              n.withColumnRenamed("n_name", "cust_nation"),
              "c_nationkey", "n_nationkey")
    o = _join(t["orders"].select("o_orderkey", "o_custkey"),
              c.select("c_custkey", "cust_nation"), "o_custkey", "c_custkey")
    l = t["lineitem"].filter(
        (F.col("l_shipdate") >= F.lit(datetime.date(1995, 1, 1))) &
        (F.col("l_shipdate") <= F.lit(datetime.date(1996, 12, 31))))
    j = _join(l, o.select("o_orderkey", "cust_nation"),
              "l_orderkey", "o_orderkey")
    j = _join(j, s.select("s_suppkey", "supp_nation"),
              "l_suppkey", "s_suppkey")
    j = j.filter(
        ((F.col("supp_nation") == F.lit("FRANCE")) &
         (F.col("cust_nation") == F.lit("GERMANY"))) |
        ((F.col("supp_nation") == F.lit("GERMANY")) &
         (F.col("cust_nation") == F.lit("FRANCE"))))
    j = j.withColumn("l_year", F.year(F.col("l_shipdate"))) \
        .withColumn("volume",
                    F.col("l_extendedprice") * (1 - F.col("l_discount")))
    return (j.groupBy("supp_nation", "cust_nation", "l_year")
            .agg(F.sum("volume").alias("revenue"))
            .orderBy("supp_nation", "cust_nation", "l_year"))


def q8(t: Dict[str, DataFrame]) -> DataFrame:
    """National market share: BRAZIL in AMERICA, ECONOMY ANODIZED STEEL."""
    p = t["part"].filter(
        F.col("p_type") == F.lit("ECONOMY ANODIZED STEEL")) \
        .select("p_partkey")
    n2 = t["nation"].select("n_nationkey", "n_name") \
        .withColumnRenamed("n_name", "nation")
    s = _join(t["supplier"].select("s_suppkey", "s_nationkey"), n2,
              "s_nationkey", "n_nationkey")
    r = t["region"].filter(F.col("r_name") == F.lit("AMERICA"))
    n1 = _join(t["nation"].select("n_nationkey", "n_regionkey"),
               r.select("r_regionkey"), "n_regionkey", "r_regionkey",
               how="semi")
    c = _join(t["customer"].select("c_custkey", "c_nationkey"),
              n1.select("n_nationkey"), "c_nationkey", "n_nationkey",
              how="semi")
    o = t["orders"].filter(
        (F.col("o_orderdate") >= F.lit(datetime.date(1995, 1, 1))) &
        (F.col("o_orderdate") <= F.lit(datetime.date(1996, 12, 31)))) \
        .select("o_orderkey", "o_custkey", "o_orderdate")
    o = _join(o, c.select("c_custkey"), "o_custkey", "c_custkey",
              how="semi")
    l = _join(t["lineitem"], p, "l_partkey", "p_partkey", how="semi")
    j = _join(l, o.select("o_orderkey", "o_orderdate"),
              "l_orderkey", "o_orderkey")
    j = _join(j, s.select("s_suppkey", "nation"), "l_suppkey", "s_suppkey")
    j = j.withColumn("o_year", F.year(F.col("o_orderdate"))) \
        .withColumn("volume",
                    F.col("l_extendedprice") * (1 - F.col("l_discount")))
    brazil = F.when(F.col("nation") == F.lit("BRAZIL"),
                    F.col("volume")).otherwise(0.0)
    agg = j.groupBy("o_year").agg(F.sum(brazil).alias("brazil_vol"),
                                  F.sum("volume").alias("total_vol"))
    return (agg.withColumn("mkt_share",
                           F.col("brazil_vol") / F.col("total_vol"))
            .select("o_year", "mkt_share").orderBy("o_year"))


def q9(t: Dict[str, DataFrame]) -> DataFrame:
    """Product type profit measure: parts named %green%."""
    p = t["part"].filter(F.col("p_name").contains("green")) \
        .select("p_partkey")
    l = _join(t["lineitem"], p, "l_partkey", "p_partkey", how="semi")
    n = t["nation"].select("n_nationkey", "n_name") \
        .withColumnRenamed("n_name", "nation")
    s = _join(t["supplier"].select("s_suppkey", "s_nationkey"), n,
              "s_nationkey", "n_nationkey")
    j = _join(l, s.select("s_suppkey", "nation"), "l_suppkey", "s_suppkey")
    j = _join(j, t["partsupp"].select("ps_partkey", "ps_suppkey",
                                      "ps_supplycost"),
              ["l_partkey", "l_suppkey"], ["ps_partkey", "ps_suppkey"])
    j = _join(j, t["orders"].select("o_orderkey", "o_orderdate"),
              "l_orderkey", "o_orderkey")
    j = j.withColumn("o_year", F.year(F.col("o_orderdate"))) \
        .withColumn(
            "amount",
            F.col("l_extendedprice") * (1 - F.col("l_discount")) -
            F.col("ps_supplycost") * F.col("l_quantity"))
    return (j.groupBy("nation", "o_year")
            .agg(F.sum("amount").alias("sum_profit"))
            .orderBy("nation", F.col("o_year").desc()))


def q10(t: Dict[str, DataFrame]) -> DataFrame:
    """Returned item reporting: top 20 customers by lost revenue."""
    o = t["orders"].filter(
        (F.col("o_orderdate") >= F.lit(datetime.date(1993, 10, 1))) &
        (F.col("o_orderdate") < F.lit(datetime.date(1994, 1, 1)))) \
        .select("o_orderkey", "o_custkey")
    l = t["lineitem"].filter(F.col("l_returnflag") == F.lit("R"))
    j = _join(l, o, "l_orderkey", "o_orderkey")
    j = _join(j, t["customer"].select("c_custkey", "c_name", "c_acctbal",
                                      "c_phone", "c_nationkey",
                                      "c_comment"),
              "o_custkey", "c_custkey")
    j = _join(j, t["nation"].select("n_nationkey", "n_name"),
              "c_nationkey", "n_nationkey")
    rev = F.col("l_extendedprice") * (1 - F.col("l_discount"))
    return (j.groupBy("o_custkey", "c_name", "c_acctbal", "c_phone",
                      "n_name", "c_comment")
            .agg(F.sum(rev).alias("revenue"))
            .orderBy(F.col("revenue").desc())
            .limit(20))


def q11(t: Dict[str, DataFrame], fraction: float = 0.0001) -> DataFrame:
    """Important stock identification (HAVING with scalar subquery)."""
    g = t["nation"].filter(F.col("n_name") == F.lit("GERMANY")) \
        .select("n_nationkey")
    s = _join(t["supplier"].select("s_suppkey", "s_nationkey"), g,
              "s_nationkey", "n_nationkey", how="semi")
    ps = _join(t["partsupp"], s.select("s_suppkey"),
               "ps_suppkey", "s_suppkey", how="semi")
    value = F.col("ps_supplycost") * F.col("ps_availqty").cast("double")
    per_part = ps.groupBy("ps_partkey").agg(F.sum(value).alias("value"))
    total = per_part.agg(F.sum("value").alias("total")).collect()[0][0]
    return (per_part.filter(F.col("value") > float(total) * fraction)
            .orderBy(F.col("value").desc()))


def q13(t: Dict[str, DataFrame]) -> DataFrame:
    """Customer distribution (left outer join + count of non-null)."""
    o = t["orders"].filter(
        ~F.col("o_comment").like("%special%requests%")) \
        .select("o_orderkey", "o_custkey")
    j = _join(t["customer"].select("c_custkey"), o,
              "c_custkey", "o_custkey", how="left")
    per_cust = j.groupBy("c_custkey").agg(
        F.count(F.col("o_orderkey")).alias("c_count"))
    return (per_cust.groupBy("c_count").agg(F.count().alias("custdist"))
            .orderBy(F.col("custdist").desc(), F.col("c_count").desc()))


def q15(t: Dict[str, DataFrame]) -> DataFrame:
    """Top supplier (view + max scalar subquery)."""
    l = t["lineitem"].filter(
        (F.col("l_shipdate") >= F.lit(datetime.date(1996, 1, 1))) &
        (F.col("l_shipdate") < F.lit(datetime.date(1996, 4, 1))))
    rev = l.groupBy("l_suppkey").agg(
        F.sum(F.col("l_extendedprice") * (1 - F.col("l_discount")))
        .alias("total_revenue"))
    m = rev.agg(F.max("total_revenue").alias("m")).collect()[0][0]
    j = _join(t["supplier"].select("s_suppkey", "s_name", "s_address",
                                   "s_phone"),
              rev, "s_suppkey", "l_suppkey")
    return (j.filter(F.col("total_revenue") >= float(m))
            .select("s_suppkey", "s_name", "s_address", "s_phone",
                    "total_revenue")
            .orderBy("s_suppkey"))


def q16(t: Dict[str, DataFrame]) -> DataFrame:
    """Parts/supplier relationship (NOT IN -> anti join, count distinct)."""
    p = t["part"].filter(
        (F.col("p_brand") != F.lit("Brand#45")) &
        ~F.col("p_type").like("MEDIUM POLISHED%") &
        F.col("p_size").isin(49, 14, 23, 45, 19, 3, 36, 9))
    bad = t["supplier"].filter(
        F.col("s_comment").like("%Customer%Complaints%")) \
        .select("s_suppkey")
    ps = _join(t["partsupp"].select("ps_partkey", "ps_suppkey"), bad,
               "ps_suppkey", "s_suppkey", how="anti")
    j = _join(ps, p.select("p_partkey", "p_brand", "p_type", "p_size"),
              "ps_partkey", "p_partkey")
    d = j.select("p_brand", "p_type", "p_size", "ps_suppkey").distinct()
    return (d.groupBy("p_brand", "p_type", "p_size")
            .agg(F.count().alias("supplier_cnt"))
            .orderBy(F.col("supplier_cnt").desc(), "p_brand", "p_type",
                     "p_size"))


def q17(t: Dict[str, DataFrame]) -> DataFrame:
    """Small-quantity-order revenue (correlated avg subquery -> join)."""
    p = t["part"].filter((F.col("p_brand") == F.lit("Brand#23")) &
                         (F.col("p_container") == F.lit("MED BOX"))) \
        .select("p_partkey")
    l = _join(t["lineitem"].select("l_partkey", "l_quantity",
                                   "l_extendedprice"),
              p, "l_partkey", "p_partkey", how="semi")
    avgq = l.groupBy("l_partkey").agg(
        (F.avg("l_quantity") * 0.2).alias("qty_limit"))
    j = _join(l, avgq, "l_partkey")
    return (j.filter(F.col("l_quantity") < F.col("qty_limit"))
            .agg((F.sum("l_extendedprice") / 7.0).alias("avg_yearly")))


def q18(t: Dict[str, DataFrame], threshold: float = 300.0) -> DataFrame:
    """Large volume customer (IN subquery with HAVING)."""
    big = t["lineitem"].groupBy("l_orderkey").agg(
        F.sum("l_quantity").alias("sum_qty"))
    big = big.filter(F.col("sum_qty") > threshold)
    o = _join(t["orders"].select("o_orderkey", "o_custkey", "o_orderdate",
                                 "o_totalprice"),
              big, "o_orderkey", "l_orderkey")
    j = _join(o, t["customer"].select("c_custkey", "c_name"),
              "o_custkey", "c_custkey")
    return (j.select("c_name", "o_custkey", "o_orderkey", "o_orderdate",
                     "o_totalprice", "sum_qty")
            .orderBy(F.col("o_totalprice").desc(), "o_orderdate")
            .limit(100))


def q19(t: Dict[str, DataFrame]) -> DataFrame:
    """Discounted revenue (disjunction of conjunctive predicate groups)."""
    j = _join(t["lineitem"].select("l_partkey", "l_quantity",
                                   "l_extendedprice", "l_discount",
                                   "l_shipmode", "l_shipinstruct"),
              t["part"].select("p_partkey", "p_brand", "p_container",
                               "p_size"),
              "l_partkey", "p_partkey")
    qty, size = F.col("l_quantity"), F.col("p_size")
    g1 = (F.col("p_brand").like("Brand#1%") &
          F.col("p_container").isin("SM CASE", "SM BOX") &
          (qty >= 1) & (qty <= 11) & (size >= 1) & (size <= 15))
    g2 = (F.col("p_brand").like("Brand#2%") &
          F.col("p_container").isin("MED BAG", "MED BOX") &
          (qty >= 10) & (qty <= 20) & (size >= 1) & (size <= 25))
    g3 = (F.col("p_brand").like("Brand#3%") &
          F.col("p_container").isin("LG CASE", "LG BOX") &
          (qty >= 20) & (qty <= 30) & (size >= 1) & (size <= 35))
    common = (F.col("l_shipmode").isin("AIR", "REG AIR") &
              (F.col("l_shipinstruct") == F.lit("DELIVER IN PERSON")))
    rev = F.col("l_extendedprice") * (1 - F.col("l_discount"))
    return (j.filter(common & (g1 | g2 | g3))
            .agg(F.sum(rev).alias("revenue")))


def q20(t: Dict[str, DataFrame]) -> DataFrame:
    """Potential part promotion (nested IN subqueries -> semi joins)."""
    p = t["part"].filter(F.col("p_name").like("forest%")) \
        .select("p_partkey")
    qty = t["lineitem"].filter(
        (F.col("l_shipdate") >= F.lit(datetime.date(1994, 1, 1))) &
        (F.col("l_shipdate") < F.lit(datetime.date(1995, 1, 1)))) \
        .groupBy("l_partkey", "l_suppkey") \
        .agg((F.sum("l_quantity") * 0.5).alias("half_qty"))
    ps = _join(t["partsupp"].select("ps_partkey", "ps_suppkey",
                                    "ps_availqty"),
               p, "ps_partkey", "p_partkey", how="semi")
    ps = _join(ps, qty, ["ps_partkey", "ps_suppkey"],
               ["l_partkey", "l_suppkey"])
    good = ps.filter(F.col("ps_availqty").cast("double") >
                     F.col("half_qty")) \
        .select("ps_suppkey").distinct()
    s = _join(t["supplier"], good, "s_suppkey", "ps_suppkey", how="semi")
    n = t["nation"].filter(F.col("n_name") == F.lit("CANADA")) \
        .select("n_nationkey")
    s = _join(s, n, "s_nationkey", "n_nationkey", how="semi")
    return s.select("s_name", "s_address").orderBy("s_name")


def q21(t: Dict[str, DataFrame]) -> DataFrame:
    """Suppliers who kept orders waiting (EXISTS + NOT EXISTS)."""
    pairs = t["lineitem"].select("l_orderkey", "l_suppkey").distinct()
    cnt_all = pairs.groupBy("l_orderkey").agg(F.count().alias("n_supp"))
    late = t["lineitem"].filter(
        F.col("l_receiptdate") > F.col("l_commitdate")) \
        .select("l_orderkey", "l_suppkey")
    cnt_late = late.distinct().groupBy("l_orderkey").agg(
        F.count().alias("n_late"))
    o = t["orders"].filter(F.col("o_orderstatus") == F.lit("F")) \
        .select("o_orderkey")
    l1 = late
    j = _join(l1, o, "l_orderkey", "o_orderkey", how="semi")
    j = _join(j, cnt_all, "l_orderkey")
    j = _join(j, cnt_late, "l_orderkey")
    j = j.filter((F.col("n_supp") > 1) & (F.col("n_late") == 1))
    n = t["nation"].filter(F.col("n_name") == F.lit("SAUDI ARABIA")) \
        .select("n_nationkey")
    s = _join(t["supplier"].select("s_suppkey", "s_name", "s_nationkey"),
              n, "s_nationkey", "n_nationkey", how="semi")
    j = _join(j, s.select("s_suppkey", "s_name"),
              "l_suppkey", "s_suppkey")
    return (j.groupBy("s_name").agg(F.count().alias("numwait"))
            .orderBy(F.col("numwait").desc(), "s_name")
            .limit(100))


def q22(t: Dict[str, DataFrame]) -> DataFrame:
    """Global sales opportunity (substring country codes, NOT EXISTS)."""
    codes = ["13", "31", "23", "29", "30", "18", "17"]
    cust = t["customer"].withColumn(
        "cntrycode", F.substring(F.col("c_phone"), 1, 2)) \
        .filter(F.col("cntrycode").isin(*codes))
    avg_bal = cust.filter(F.col("c_acctbal") > 0.0) \
        .agg(F.avg("c_acctbal").alias("a")).collect()[0][0]
    good = cust.filter(F.col("c_acctbal") > float(avg_bal))
    noord = _join(good, t["orders"].select("o_custkey"),
                  "c_custkey", "o_custkey", how="anti")
    return (noord.groupBy("cntrycode")
            .agg(F.count().alias("numcust"),
                 F.sum("c_acctbal").alias("totacctbal"))
            .orderBy("cntrycode"))


QUERIES: Dict[str, Callable] = {
    "q1": q1, "q2": q2, "q3": q3, "q4": q4, "q5": q5, "q6": q6, "q7": q7,
    "q8": q8, "q9": q9, "q10": q10, "q11": q11, "q12": q12, "q13": q13,
    "q14": q14, "q15": q15, "q16": q16, "q17": q17, "q18": q18,
    "q19": q19, "q20": q20, "q21": q21, "q22": q22,
}
