"""TPC-H: synthetic data generator and the ported query pipelines.

Counterpart of ``spark_rapids_tpu/models/tpch.py`` (whose copy imports the
JAX engine's session).  ``gen_tables`` is the JAX package's generator,
copied as is: pure numpy/pandas, so at the same ``sf`` and seed it gives
frame for frame the same tables.  ``gen_q3_columns`` draws the same random
stream but builds only the columns q3 reads, so q3 runs at scale factors
where the whole generator would spend minutes and tens of GB of host
memory on string columns q3 never reads.  Queries: q3 and q6; the other
twenty wait for the string, decimal and CASE WHEN slices.

Through ``load`` (pandas -> arrow) the date columns arrive as timestamps,
as they do in the JAX package.
"""

from __future__ import annotations

import datetime
from typing import Dict

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


def _string_buffers(codes: np.ndarray, vocab):
    """(offsets, chars) of the strings ``vocab[codes]``, built without
    Python string objects."""
    words = [w.encode("utf-8") for w in vocab]
    lens = np.array([len(w) for w in words], dtype=np.int64)
    row_lens = lens[codes]
    offsets = np.zeros(len(codes) + 1, dtype=np.int64)
    np.cumsum(row_lens, out=offsets[1:])
    table = np.frombuffer(b"".join(words), dtype=np.uint8)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    # byte j of the output comes from vocab word codes[row] at its offset
    row = np.repeat(np.arange(len(codes)), row_lens)
    src = starts[codes][row] + (np.arange(offsets[-1]) - offsets[row])
    return offsets, table[src]


def gen_q3_columns(sf: float, seed: int = 7) -> Dict[str, Dict]:
    """The columns TPC-H q3 reads, value for value those of
    ``gen_tables(sf, seed)``: the generator's random stream is drawn in
    the same order, with index draws in place of the string columns q3
    does not read (``Generator.choice`` over a list draws the same
    indices as ``integers`` over its length).  Dates are int32 days since
    the epoch and ``c_mktsegment`` is ``(offsets, chars)``, in the form
    ``interop.batch_from_arrays`` takes:
    ``{table: {column: (type name, values, None)}}``."""
    rng = np.random.default_rng(seed)
    n_orders = max(int(1_500_000 * sf), 100)
    n_line = max(int(6_000_000 * sf), 400)
    n_cust = max(int(150_000 * sf), 50)
    n_words = len(COMMENT_WORDS)

    def skip_comments(n, special_frac=0.05):
        rng.integers(0, n_words, (n, 4))
        k = max(int(n * special_frac), 1)
        rng.choice(n, k, replace=False)
        rng.integers(0, n_words, (k, 3))

    day0 = int(_d("1992-01-01").astype(np.int64))
    order_dates = day0 + rng.integers(0, 2405, n_orders)
    with_orders = np.arange(1, n_cust + 1, dtype=np.int64)
    with_orders = with_orders[with_orders % 3 != 0]
    o_custkey = rng.choice(with_orders, n_orders)
    rng.integers(0, 3, n_orders)                  # o_orderstatus
    rng.uniform(800, 500000, n_orders)            # o_totalprice
    rng.integers(0, len(PRIORITIES), n_orders)    # o_orderpriority
    skip_comments(n_orders)                       # o_comment

    okeys = rng.integers(1, n_orders + 1, n_line)
    ship_delay = rng.integers(1, 122, n_line)
    l_shipdate = order_dates[okeys - 1] + ship_delay
    rng.integers(1, max(int(200_000 * sf), 40) + 1, n_line)   # l_partkey
    rng.integers(1, max(int(10_000 * sf), 10) + 1, n_line)    # l_suppkey
    rng.integers(1, 8, n_line)                                 # linenumber
    rng.integers(1, 51, n_line)                                # quantity
    l_extendedprice = rng.uniform(900, 105000, n_line).round(2)
    l_discount = rng.integers(0, 11, n_line) / 100.0
    rng.integers(0, 9, n_line)                                 # l_tax
    rng.integers(0, len(RETURNFLAGS), n_line)
    rng.integers(0, len(LINESTATUS), n_line)
    rng.integers(30, 92, n_line)                               # commitdate
    rng.integers(1, 31, n_line)                                # receiptdate
    rng.integers(0, 4, n_line)                                 # shipinstruct
    rng.integers(0, len(SHIPMODES), n_line)

    cnation = rng.integers(0, 25, n_cust)
    for _ in cnation:                              # c_phone's scalar draws
        rng.integers(100, 999)
        rng.integers(100, 999)
        rng.integers(1000, 9999)
    rng.uniform(-999, 9999, n_cust)                # c_acctbal
    seg_offsets, seg_chars = _string_buffers(
        rng.integers(0, len(SEGMENTS), n_cust), SEGMENTS)
    return {
        "customer": {
            "c_custkey": ("bigint", np.arange(1, n_cust + 1,
                                              dtype=np.int64), None),
            "c_mktsegment": ("string", (seg_offsets, seg_chars), None)},
        "orders": {
            "o_orderkey": ("bigint", np.arange(1, n_orders + 1,
                                               dtype=np.int64), None),
            "o_custkey": ("bigint", o_custkey.astype(np.int64), None),
            "o_orderdate": ("date", order_dates.astype(np.int32), None),
            "o_shippriority": ("int", np.zeros(n_orders, dtype=np.int32),
                               None)},
        "lineitem": {
            "l_orderkey": ("bigint", okeys.astype(np.int64), None),
            "l_extendedprice": ("double", l_extendedprice, None),
            "l_discount": ("double", l_discount, None),
            "l_shipdate": ("date", l_shipdate.astype(np.int32), None)},
    }


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


QUERIES = {"q3": q3, "q6": q6}
