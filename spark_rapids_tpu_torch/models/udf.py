"""UD1-UD9: user code and reuse over TPC-H, with numpy and pandas references.

Nine queries over the TPC-H tables (``models/tpch.py``'s generators,
registered as views by ``models/tpch_sql.register``) that reach the
engine's Python paths the way users write them: business rules as Python
functions, a torch function, pandas code per batch, per group, per window
and per pair of groups, a cached fact slice that several reports read,
and years pivoted into columns.

* UD1 ``ud1``: TPC-H q6 with its predicate (:func:`q6_predicate`) and
  revenue (:func:`revenue`) as compiled UDFs; the same rows and bounds as
  ``tpch.q6``.
* UD2 ``ud2``: TPC-H q1's shape with :func:`charge` (a local and a
  branch) compiled inside ``sum``.
* UD3 ``ud3g`` / ``ud3x``: :func:`phone_cc` (a loop, so a black box)
  over all of customer: grouped by it (the call moves into a projection
  below the aggregate), and inside a larger expression, summed.  By the
  TPC-H spec the code is ``c_nationkey + 10``.
* UD4 ``ud4`` / ``ud4c``: :func:`disc_price` as a ``tpu_udf`` (a torch
  function) summed by return flag, and the same query with columns.
* UD5 ``ud5m``: ``mapInPandas`` (:func:`order_bands`) over orders, then a
  hash group-by on the card; ``ud5g``: ``applyInPandas``
  (:func:`revenue_share`) over the lines shipped in 1995, then per group
  the count, the sum of the shares and the largest.
* UD6 ``ud6a``: grouped-aggregate pandas UDFs (:func:`median`,
  :func:`trimmed_mean`) of ``o_totalprice`` by priority; ``ud6k``: the
  keyless grand total (:func:`total`); ``ud6w``: window pandas UDFs over
  supplier (the mean over ``rowsBetween(-2, 2)`` by ``s_suppkey`` per
  nation, and the partition's max).
* UD7 ``ud7``: customer and supplier cogrouped by nation
  (:func:`nation_balance`).
* UD8 ``ud8a`` / ``ud8b`` / ``ud8c``: over :func:`lineitem_1995` (cache it
  first to read it from the cache): a q6-form keyless sum, a q1-form
  group-by, and a hash join to the orders of January 1995 grouped by
  priority.
* UD9 ``ud9``: lineitem joined to orders, the revenue per return flag
  pivoted over the order years 1992-1998.

``build(F, session, name, base=None)`` builds a query's DataFrame (``F``
is the functions module of the session's engine; ``base`` is UD8's
lineitem slice, cached or not).  :func:`references` computes every answer
from the host columns with numpy and pandas, and :func:`check` holds a
query's arrow result against it.  The functions are defined at module
level, so that a spawned worker process unpickles them by reference; this
module imports neither torch nor the engine.
"""

from __future__ import annotations

import datetime
from typing import Dict, Tuple

import numpy as np
import pandas as pd

D1994 = datetime.date(1994, 1, 1)
D1995 = datetime.date(1995, 1, 1)
Q1_CUTOFF = datetime.date(1998, 9, 2)
SHARE_YEAR = 1995           # UD5g's and UD8's lines: shipped in this year
BAND_WIDTH = 100_000.0      # UD5m's price band width; bands 0..5
PIVOT_YEARS = tuple(range(1992, 1999))
# UD8c's orders: placed in this month (about 190K at SF10, a build side
# the hash join takes)
ORDER_MONTH = (datetime.date(1995, 1, 1), datetime.date(1995, 2, 1))
TRIM = 0.1                  # UD6's trimmed mean cuts this share each side
FLOAT_RTOL = 1e-9           # a float sum against numpy's
SHARE_TOL = 1e-9            # UD5g: each group's shares sum to 1 within this

NAMES = ("ud1", "ud2", "ud3g", "ud3x", "ud4", "ud4c", "ud5m", "ud5g",
         "ud6a", "ud6k", "ud6w", "ud7", "ud8a", "ud8b", "ud8c", "ud9")
UD8 = ("ud8a", "ud8b", "ud8c")
TABLES = {"ud1": ("lineitem",), "ud2": ("lineitem",),
          "ud3g": ("customer",), "ud3x": ("customer",),
          "ud4": ("lineitem",), "ud4c": ("lineitem",),
          "ud5m": ("orders",), "ud5g": ("lineitem",), "ud6a": ("orders",),
          "ud6k": ("orders",), "ud6w": ("supplier",),
          "ud7": ("customer", "supplier"), "ud8a": ("lineitem",),
          "ud8b": ("lineitem",), "ud8c": ("lineitem", "orders"),
          "ud9": ("lineitem", "orders")}
# the queries whose plan holds a black-box Python projection, and those
# with a pandas node
ARROW_EVAL = ("ud3g", "ud3x")
PANDAS = ("ud5m", "ud5g", "ud6a", "ud6k", "ud6w", "ud7")


# --------------------------------------------------------- the user code --

def q6_predicate(sd, d, q):
    return sd >= D1994 and sd < D1995 and 0.05 <= d <= 0.07 and q < 24


def revenue(p, d):
    return p * d


def charge(p, d, t):
    net = p * (1 - d)
    if t > 0.0:
        return net * (1 + t)
    return net


def phone_cc(phone):
    cc = 0
    for ch in phone[:2]:
        cc = cc * 10 + ord(ch) - 48
    return cc


def disc_price(p, d):
    return p * (1 - d)


def _year(dates: pd.Series) -> pd.Series:
    if not pd.api.types.is_datetime64_any_dtype(dates):
        dates = pd.to_datetime(dates)
    return dates.dt.year.astype("int32")


def order_bands(frames):
    for pdf in frames:
        band = np.minimum(pdf["o_totalprice"].to_numpy() // BAND_WIDTH, 5)
        yield pd.DataFrame({"o_orderkey": pdf["o_orderkey"],
                            "o_year": _year(pdf["o_orderdate"]),
                            "band": band.astype("int32"),
                            "o_totalprice": pdf["o_totalprice"]})


def revenue_share(g: pd.DataFrame) -> pd.DataFrame:
    rev = g["l_extendedprice"] * (1.0 - g["l_discount"])
    return pd.DataFrame({"l_returnflag": g["l_returnflag"],
                         "l_linestatus": g["l_linestatus"],
                         "share": rev / rev.sum()})


def median(s: pd.Series) -> float:
    return float(np.median(s.to_numpy())) if len(s) else float("nan")


def trimmed_mean(s: pd.Series) -> float:
    v = np.sort(s.to_numpy())
    k = int(len(v) * TRIM)
    v = v[k:len(v) - k]
    return float(v.mean()) if len(v) else float("nan")


def total(s: pd.Series) -> float:
    return float(s.to_numpy().sum())


def frame_mean(s: pd.Series) -> float:
    return float(s.to_numpy().mean()) if len(s) else float("nan")


def frame_max(s: pd.Series) -> float:
    return float(s.to_numpy().max()) if len(s) else float("nan")


def nation_balance(c: pd.DataFrame, s: pd.DataFrame) -> pd.DataFrame:
    key = c["c_nationkey"].iloc[0] if len(c) else s["s_nationkey"].iloc[0]
    diff = c["c_acctbal"].mean() - s["s_acctbal"].mean() \
        if len(c) and len(s) else float("nan")
    return pd.DataFrame({"nationkey": [int(key)], "n_cust": [len(c)],
                         "n_supp": [len(s)], "bal_diff": [float(diff)]})


# ------------------------------------------------------------ the queries --

def _ud1(F, s, base):
    pred = F.udf(q6_predicate, "boolean")
    rev = F.udf(revenue, "double")
    return s.table("lineitem") \
        .filter(pred("l_shipdate", "l_discount", "l_quantity")) \
        .select(rev("l_extendedprice", "l_discount").alias("rev")) \
        .agg(F.sum("rev").alias("revenue"))


def _ud2(F, s, base):
    ch = F.udf(charge, "double")
    return s.table("lineitem") \
        .filter(F.col("l_shipdate") <= F.lit(Q1_CUTOFF)) \
        .groupBy("l_returnflag", "l_linestatus") \
        .agg(F.sum("l_quantity").alias("sum_qty"),
             F.sum(ch("l_extendedprice", "l_discount", "l_tax"))
             .alias("sum_charge"),
             F.avg("l_extendedprice").alias("avg_price"),
             F.avg("l_discount").alias("avg_disc"),
             F.count().alias("count_order")) \
        .orderBy("l_returnflag", "l_linestatus")


def _ud3g(F, s, base):
    cc = F.udf(phone_cc, "bigint")
    return s.table("customer").groupBy(cc("c_phone").alias("cc")) \
        .agg(F.count().alias("n"), F.sum("c_acctbal").alias("bal")) \
        .orderBy("cc")


def _ud3x(F, s, base):
    cc = F.udf(phone_cc, "bigint")
    return s.table("customer") \
        .select((F.col("c_acctbal") * (cc("c_phone") - 10)).alias("x")) \
        .agg(F.sum("x").alias("weighted"))


def _ud4(F, s, base):
    dp = F.tpu_udf(disc_price, "double")
    return s.table("lineitem").groupBy("l_returnflag") \
        .agg(F.sum(dp("l_extendedprice", "l_discount")).alias("rev")) \
        .orderBy("l_returnflag")


def _ud4c(F, s, base):
    return s.table("lineitem").groupBy("l_returnflag") \
        .agg(F.sum(F.col("l_extendedprice") * (1 - F.col("l_discount")))
             .alias("rev")) \
        .orderBy("l_returnflag")


def _ud5m(F, s, base):
    return s.table("orders") \
        .select("o_orderkey", "o_custkey", "o_totalprice", "o_orderdate") \
        .mapInPandas(order_bands, "o_orderkey bigint, o_year int, "
                     "band int, o_totalprice double") \
        .groupBy("o_year", "band") \
        .agg(F.count().alias("n"), F.sum("o_totalprice").alias("total")) \
        .orderBy("o_year", "band")


def _shipped_in(F, s, year):
    return s.table("lineitem").filter(F.year("l_shipdate") == year)


def _ud5g(F, s, base):
    return _shipped_in(F, s, SHARE_YEAR) \
        .select("l_returnflag", "l_linestatus", "l_extendedprice",
                "l_discount") \
        .groupBy("l_returnflag", "l_linestatus") \
        .applyInPandas(revenue_share, "l_returnflag string, "
                       "l_linestatus string, share double") \
        .groupBy("l_returnflag", "l_linestatus") \
        .agg(F.count().alias("n"), F.sum("share").alias("shares"),
             F.max("share").alias("top")) \
        .orderBy("l_returnflag", "l_linestatus")


def _ud6a(F, s, base):
    med = F.pandas_agg_udf(median, "double")
    trim = F.pandas_agg_udf(trimmed_mean, "double")
    return s.table("orders").select("o_orderpriority", "o_totalprice") \
        .groupBy("o_orderpriority") \
        .agg(med("o_totalprice").alias("median"),
             trim("o_totalprice").alias("trimmed")) \
        .orderBy("o_orderpriority")


def _ud6k(F, s, base):
    tot = F.pandas_agg_udf(total, "double")
    return s.table("orders").select("o_totalprice") \
        .agg(tot("o_totalprice").alias("total"))


def _ud6w(F, s, base):
    mean = F.pandas_agg_udf(frame_mean, "double")
    top = F.pandas_agg_udf(frame_max, "double")
    w = F.Window.partitionBy("s_nationkey").orderBy("s_suppkey")
    return s.table("supplier") \
        .select("s_suppkey", "s_nationkey", "s_acctbal") \
        .select("s_suppkey", "s_nationkey", "s_acctbal",
                mean("s_acctbal").over(w.rowsBetween(-2, 2))
                .alias("rolling"),
                top("s_acctbal").over(F.Window.partitionBy("s_nationkey"))
                .alias("nation_max")) \
        .orderBy("s_suppkey")


def _ud7(F, s, base):
    c = s.table("customer").select("c_nationkey", "c_acctbal")
    sup = s.table("supplier").select("s_nationkey", "s_acctbal")
    return c.groupBy("c_nationkey").cogroup(sup.groupBy("s_nationkey")) \
        .applyInPandas(nation_balance, "nationkey bigint, n_cust bigint, "
                       "n_supp bigint, bal_diff double") \
        .orderBy("nationkey")


def lineitem_1995(F, s):
    """UD8's slice: the lines shipped in 1995, six columns (about 9.1M
    rows at SF10); call ``.cache()`` on it to cache it."""
    return _shipped_in(F, s, SHARE_YEAR).select(
        "l_orderkey", "l_returnflag", "l_linestatus", "l_quantity",
        "l_extendedprice", "l_discount")


def _ud8a(F, s, base):
    return base.filter((F.col("l_discount") >= 0.05) &
                       (F.col("l_discount") <= 0.07) &
                       (F.col("l_quantity") < 24.0)) \
        .agg(F.sum(F.col("l_extendedprice") * F.col("l_discount"))
             .alias("revenue"))


def _ud8b(F, s, base):
    return base.groupBy("l_returnflag", "l_linestatus") \
        .agg(F.sum("l_quantity").alias("sum_qty"),
             F.sum(F.col("l_extendedprice") * (1 - F.col("l_discount")))
             .alias("sum_disc_price"),
             F.count().alias("count_order")) \
        .orderBy("l_returnflag", "l_linestatus")


def _ud8c(F, s, base):
    o = s.table("orders") \
        .filter((F.col("o_orderdate") >= F.lit(ORDER_MONTH[0])) &
                (F.col("o_orderdate") < F.lit(ORDER_MONTH[1]))) \
        .select("o_orderkey", "o_orderpriority")
    return base.join(o, F.col("l_orderkey") == F.col("o_orderkey")) \
        .groupBy("o_orderpriority") \
        .agg(F.sum("l_extendedprice").alias("price"),
             F.count().alias("n")) \
        .orderBy("o_orderpriority")


def _ud9(F, s, base):
    o = s.table("orders").select("o_orderkey", "o_orderdate")
    return s.table("lineitem") \
        .select("l_orderkey", "l_returnflag", "l_extendedprice") \
        .join(o, F.col("l_orderkey") == F.col("o_orderkey")) \
        .select("l_returnflag", F.year("o_orderdate").alias("o_year"),
                "l_extendedprice") \
        .groupBy("l_returnflag").pivot("o_year", list(PIVOT_YEARS)) \
        .sum("l_extendedprice").orderBy("l_returnflag")


_BUILDERS = {"ud1": _ud1, "ud2": _ud2, "ud3g": _ud3g, "ud3x": _ud3x,
             "ud4": _ud4, "ud4c": _ud4c, "ud5m": _ud5m, "ud5g": _ud5g,
             "ud6a": _ud6a, "ud6k": _ud6k, "ud6w": _ud6w, "ud7": _ud7,
             "ud8a": _ud8a, "ud8b": _ud8b, "ud8c": _ud8c, "ud9": _ud9}


def build(F, session, name: str, base=None):
    """The DataFrame of query ``name`` over the session's TPC-H views; a
    UD8 query reads ``base`` (default: an uncached
    :func:`lineitem_1995`)."""
    if name in UD8 and base is None:
        base = lineitem_1995(F, session)
    return _BUILDERS[name](F, session, base)


# ------------------------------------------------------------ references --

def host_columns(cols) -> Dict[str, Dict[str, object]]:
    """``{table: {column: values}}`` of ``tpch.gen_table_columns``'
    output: numbers and dates as numpy arrays, strings as ``(offsets,
    chars)``."""
    return {t: {c: v[1] for c, v in cs.items()} for t, cs in cols.items()}


def _first_char(buf) -> np.ndarray:
    """The first byte of every string of an ``(offsets, chars)`` column."""
    offsets, chars = buf
    return np.asarray(chars)[np.asarray(offsets)[:-1]]


def _days(d: datetime.date) -> int:
    return (d - datetime.date(1970, 1, 1)).days


def _years(days: np.ndarray) -> np.ndarray:
    return days.astype("datetime64[D]").astype("datetime64[Y]") \
        .astype(np.int64) + 1970


def _group_sums(codes: np.ndarray, n: int, **values) -> Dict[str, object]:
    out = {"n": np.bincount(codes, minlength=n)}
    for k, v in values.items():
        out[k] = np.bincount(codes, weights=v, minlength=n)
    return out


def _flags(li, rows):
    """(return flag, line status) code per row of ``rows``: the flag's and
    status's bytes."""
    return _first_char(li["l_returnflag"])[rows], \
        _first_char(li["l_linestatus"])[rows]


def _keyed(flag_b, status_b=None):
    """Sorted distinct keys and each row's key index."""
    key = flag_b.astype(np.int64) if status_b is None else \
        flag_b.astype(np.int64) * 256 + status_b
    uniq, inv = np.unique(key, return_inverse=True)
    return uniq, inv


def _key_strings(uniq, two):
    if two:
        return (np.array([chr(k // 256) for k in uniq], dtype=object),
                np.array([chr(k % 256) for k in uniq], dtype=object))
    return np.array([chr(k) for k in uniq], dtype=object)


def _priorities(buf) -> Dict[int, str]:
    """Each order priority by its first byte ("1-URGENT" ... "5-LOW")."""
    offsets, chars = buf
    first = _first_char(buf)
    out = {}
    for u in np.unique(first):
        i = int(np.nonzero(first == u)[0][0])
        out[int(u)] = bytes(chars[offsets[i]:offsets[i + 1]]).decode()
    return out


def references(cols, names=NAMES) -> Dict[str, Dict[str, object]]:
    """numpy's and pandas' answers of ``names`` from ``host_columns``
    output: per query, per column, the values in the query's row order."""
    li, od = cols["lineitem"], cols["orders"]
    cu, su = cols["customer"], cols["supplier"]
    out: Dict[str, Dict[str, object]] = {}
    sd = li["l_shipdate"]
    price, disc = li["l_extendedprice"], li["l_discount"]
    qty, tax = li["l_quantity"], li["l_tax"]
    if "ud1" in names:
        m = (sd >= _days(D1994)) & (sd < _days(D1995)) & (disc >= 0.05) & \
            (disc <= 0.07) & (qty < 24)
        out["ud1"] = {"revenue": np.array([(price[m] * disc[m]).sum()])}
    if "ud2" in names:
        rows = np.nonzero(sd <= _days(Q1_CUTOFF))[0]
        uniq, inv = _keyed(*_flags(li, rows))
        net = price[rows] * (1 - disc[rows])
        t = tax[rows]
        ch = np.where(t > 0.0, net * (1 + t), net)
        g = _group_sums(inv, len(uniq), qty=qty[rows], charge=ch,
                        price=price[rows], disc=disc[rows])
        f, st = _key_strings(uniq, True)
        out["ud2"] = {"l_returnflag": f, "l_linestatus": st,
                      "sum_qty": g["qty"], "sum_charge": g["charge"],
                      "avg_price": g["price"] / g["n"],
                      "avg_disc": g["disc"] / g["n"],
                      "count_order": g["n"]}
    if {"ud3g", "ud3x"} & set(names):
        nk, bal = cu["c_nationkey"], cu["c_acctbal"]
        uniq, inv = np.unique(nk + 10, return_inverse=True)
        g = _group_sums(inv, len(uniq), bal=bal)
        out["ud3g"] = {"cc": uniq, "n": g["n"], "bal": g["bal"]}
        out["ud3x"] = {"weighted": np.array([(bal * nk).sum()])}
    if {"ud4", "ud4c"} & set(names):
        uniq, inv = _keyed(_first_char(li["l_returnflag"]))
        g = _group_sums(inv, len(uniq), rev=price * (1 - disc))
        ref = {"l_returnflag": _key_strings(uniq, False), "rev": g["rev"]}
        out["ud4"] = out["ud4c"] = ref
    if "ud5m" in names:
        tp = od["o_totalprice"]
        year = _years(od["o_orderdate"])
        band = np.minimum(tp // BAND_WIDTH, 5).astype(np.int64)
        key = year * 8 + band
        uniq, inv = np.unique(key, return_inverse=True)
        g = _group_sums(inv, len(uniq), total=tp)
        out["ud5m"] = {"o_year": uniq // 8, "band": uniq % 8, "n": g["n"],
                       "total": g["total"]}
    if "ud5g" in names:
        rows = np.nonzero(_years(sd) == SHARE_YEAR)[0]
        uniq, inv = _keyed(*_flags(li, rows))
        rev = price[rows] * (1.0 - disc[rows])
        sums = np.bincount(inv, weights=rev, minlength=len(uniq))
        top = np.zeros(len(uniq))
        np.maximum.at(top, inv, rev / sums[inv])
        f, st = _key_strings(uniq, True)
        out["ud5g"] = {"l_returnflag": f, "l_linestatus": st,
                       "n": np.bincount(inv, minlength=len(uniq)),
                       "shares": np.ones(len(uniq)), "top": top}
    if {"ud6a", "ud6k"} & set(names):
        tp = od["o_totalprice"]
        pri = _first_char(od["o_orderpriority"])
        uniq, inv = np.unique(pri, return_inverse=True)
        names_of = _priorities(od["o_orderpriority"])
        labels = np.array([names_of[u] for u in uniq], dtype=object)
        med, trim = [], []
        for k in range(len(uniq)):
            v = tp[inv == k]
            med.append(median(pd.Series(v)))
            trim.append(trimmed_mean(pd.Series(v)))
        out["ud6a"] = {"o_orderpriority": labels, "median": np.array(med),
                       "trimmed": np.array(trim)}
        out["ud6k"] = {"total": np.array([tp.sum()])}
    if "ud6w" in names:
        df = pd.DataFrame({"s_suppkey": su["s_suppkey"],
                           "s_nationkey": su["s_nationkey"],
                           "s_acctbal": su["s_acctbal"]})
        df = df.sort_values(["s_nationkey", "s_suppkey"])
        grp = df.groupby("s_nationkey")["s_acctbal"]
        df["rolling"] = grp.transform(
            lambda x: x.rolling(5, center=True, min_periods=1).mean())
        df["nation_max"] = grp.transform("max")
        df = df.sort_values("s_suppkey")
        out["ud6w"] = {c: df[c].to_numpy() for c in df.columns}
    if "ud7" in names:
        cn, sn = cu["c_nationkey"], su["s_nationkey"]
        keys = np.union1d(cn, sn)
        nc = np.array([(cn == k).sum() for k in keys])
        ns = np.array([(sn == k).sum() for k in keys])
        diff = np.array([cu["c_acctbal"][cn == k].mean() -
                         su["s_acctbal"][sn == k].mean()
                         if nc[i] and ns[i] else np.nan
                         for i, k in enumerate(keys)])
        out["ud7"] = {"nationkey": keys, "n_cust": nc, "n_supp": ns,
                      "bal_diff": diff}
    if {"ud8a", "ud8b"} & set(names):
        rows = np.nonzero(_years(sd) == SHARE_YEAR)[0]
        p, d, q = price[rows], disc[rows], qty[rows]
        m = (d >= 0.05) & (d <= 0.07) & (q < 24.0)
        out["ud8a"] = {"revenue": np.array([(p[m] * d[m]).sum()])}
        uniq, inv = _keyed(*_flags(li, rows))
        g = _group_sums(inv, len(uniq), qty=q, rev=p * (1 - d))
        f, st = _key_strings(uniq, True)
        out["ud8b"] = {"l_returnflag": f, "l_linestatus": st,
                       "sum_qty": g["qty"], "sum_disc_price": g["rev"],
                       "count_order": g["n"]}
    # each line's order (every l_orderkey is an order's key), through a
    # table indexed by the key
    ok = od["o_orderkey"]
    at = np.zeros(int(ok.max()) + 1 if len(ok) else 1, dtype=np.int32)
    at[ok] = np.arange(len(ok), dtype=np.int32)
    line_order = at[li["l_orderkey"]]
    del at
    if "ud8c" in names:
        od_days = od["o_orderdate"][line_order]
        rows = np.nonzero((_years(sd) == SHARE_YEAR) &
                          (od_days >= _days(ORDER_MONTH[0])) &
                          (od_days < _days(ORDER_MONTH[1])))[0]
        pri = _first_char(od["o_orderpriority"])
        labels = _priorities(od["o_orderpriority"])
        uniq, inv = np.unique(pri[line_order[rows]], return_inverse=True)
        g = _group_sums(inv, len(uniq), price=price[rows])
        out["ud8c"] = {"o_orderpriority": np.array(
            [labels[u] for u in uniq], dtype=object),
            "price": g["price"], "n": g["n"]}
    if "ud9" in names:
        year = _years(od["o_orderdate"][line_order]) - PIVOT_YEARS[0]
        uniq, inv = _keyed(_first_char(li["l_returnflag"]))
        ny = len(PIVOT_YEARS)
        inside = (year >= 0) & (year < ny)
        cell = inv[inside] * ny + year[inside]
        sums = np.bincount(cell, weights=price[inside],
                           minlength=len(uniq) * ny).reshape(-1, ny)
        counts = np.bincount(cell, minlength=len(uniq) * ny).reshape(-1, ny)
        sums[counts == 0] = np.nan   # pivot_table's empty cell
        ref = {"l_returnflag": _key_strings(uniq, False)}
        for j, y in enumerate(PIVOT_YEARS):
            ref[str(y)] = sums[:, j]
        out["ud9"] = ref
    return {k: v for k, v in out.items() if k in names}


def _host(col) -> np.ndarray:
    import pyarrow as pa
    col = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
    if pa.types.is_string(col.type) or pa.types.is_large_string(col.type):
        return np.array(col.to_pylist(), dtype=object)
    return col.to_numpy(zero_copy_only=False)


def _same(got: np.ndarray, want: np.ndarray, what: str, rtol: float):
    if got.shape != want.shape:
        return f"{what}: {got.shape} values, want {want.shape}"
    if want.dtype.kind == "f":
        ok = np.allclose(got.astype(np.float64), want, rtol=rtol, atol=0,
                         equal_nan=True)
    elif want.dtype.kind == "O":
        ok = list(got) == list(want)
    else:
        ok = np.array_equal(got.astype(want.dtype), want)
    return None if ok else f"{what}: differs"


def check(name: str, table, refs) -> Tuple[bool, str]:
    """(ok, why) of a query's arrow result against its reference: every
    reference column by name; keys, counts and order exactly, floats
    within ``FLOAT_RTOL`` (UD5g's share sums within ``SHARE_TOL`` of 1)."""
    want = refs[name]
    missing = [c for c in want if c not in table.column_names]
    if missing:
        return False, f"{name}: columns {missing} missing"
    for c, v in want.items():
        got = _host(table.column(c))
        if name == "ud5g" and c == "shares":
            ok = got.shape == v.shape and \
                bool(np.all(np.abs(got - 1.0) <= SHARE_TOL))
            why = None if ok else f"{name}.shares: {got} not 1 within " \
                f"{SHARE_TOL}"
        else:
            why = _same(got, np.asarray(v), f"{name}.{c}", FLOAT_RTOL)
        if why:
            return False, why
    return True, ""
