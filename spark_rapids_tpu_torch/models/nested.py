"""ND1-ND7: nested-data queries over TPC-H, with numpy references.

Seven queries over the TPC-H tables (``models/tpch.py``'s generators,
registered as views by ``models/tpch_sql.register``) that reach the
nested types the way ETL does: roll lines up into arrays per order and
explode them back, join the exploded keys, carry a struct through a sort,
build and explode maps, bucket events into time windows and pull fields
out of JSON text.

* ND1 ``nd1``: ``collect_list`` / ``collect_set`` per order, then
  ``size``, ``sort_array`` (both ways), ``element_at`` (1 and -1),
  ``array_min``/``array_max``, ``array_contains``, ``reverse``, ``slice``.
* ND2 ``nd2``: ``explode`` of ND1's sets, counted by supplier;
  ``nd2p``: ``posexplode`` of ND1's lists.
* ND3 ``nd3``: the exploded sets joined to ``supplier`` (a hash join), a
  filter on ``s_nationkey`` and a keyless sum of ``s_acctbal`` and of
  ones (the row count as a double: both buffers are float sums, so the
  reduction is one ``masked_multi_reduce``).
* ND4 ``nd4``: a struct of four lineitem columns through a filter on one
  field and a top-N sort on two.
* ND5 ``nd5``: ``create_map`` over lineitem, read back by key, size, keys
  and values (summed to one row); ``nd5x``: the map exploded to
  key/value rows, summed by key.
* ND6 ``nd6t`` / ``nd6s``: tumbling 7-day and sliding 30-day/7-day
  windows over the lines shipped in 1995.
* ND7 ``nd7j``: a JSON document built with ``concat`` per order of one
  month, read back with ``get_json_object`` (the CPU fallback) and
  summed by status; ``nd7w``: ``explode(split(o_comment, ' '))`` (the
  CPU fallback) counted by word.

``build(F, session, name)`` builds a query's DataFrame (``F`` is the
functions module of the session's engine); ``SQL[name]`` is the SQL form
of ND1, ND4, ND5 and ND6 (a subset of the DataFrame form's columns, under
the same names; ND5's reads the view ``lineitem_map`` that
:func:`register_map_view` makes, as SQL has no ``map()``).
``FALLBACK_NODES[name]``: the plan nodes each query runs in the CPU
fallback.  :func:`references` computes every answer from the host
columns with numpy, and :func:`check` holds a query's arrow result
against it.  The engine does not import this module.
"""

from __future__ import annotations

import datetime
from typing import Dict, Tuple

import numpy as np

ND1_SUPPLIER = 42          # array_contains(supps, ND1_SUPPLIER)
ND3_NATIONS = 5            # s_nationkey < ND3_NATIONS
ND4_MIN_QUANTITY = 45.0    # s.l_quantity > ND4_MIN_QUANTITY
ND4_LIMIT = 1000
ND6_YEAR = 1995
ND7_MONTH = (1996, 3)
DAY_US = 86_400_000_000
FLOAT_RTOL = 1e-9          # a float sum against numpy's

NAMES = ("nd1", "nd2", "nd2p", "nd3", "nd4", "nd5", "nd5x", "nd6t", "nd6s",
         "nd7j", "nd7w")
TABLES = {"nd1": ("lineitem",), "nd2": ("lineitem",),
          "nd2p": ("lineitem",), "nd3": ("lineitem", "supplier"),
          "nd4": ("lineitem",), "nd5": ("lineitem",),
          "nd5x": ("lineitem",), "nd6t": ("lineitem",),
          "nd6s": ("lineitem",), "nd7j": ("orders",), "nd7w": ("orders",)}
FALLBACK_NODES = {n: [] for n in NAMES}
FALLBACK_NODES["nd7j"] = ["Project"]
FALLBACK_NODES["nd7w"] = ["Generate"]


def _days(y: int, m: int, d: int = 1) -> int:
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


def _collected(F, s):
    return s.table("lineitem").groupBy("l_orderkey").agg(
        F.collect_list("l_partkey").alias("parts"),
        F.collect_set("l_suppkey").alias("supps"),
        F.sum("l_quantity").alias("qty"))


def _nd1(F, s):
    return _collected(F, s).select(
        "l_orderkey", "parts", "supps", "qty",
        F.size("parts").alias("n_parts"),
        F.sort_array("parts").alias("parts_asc"),
        F.sort_array("parts", False).alias("parts_desc"),
        F.element_at("parts", 1).alias("first_part"),
        F.element_at("parts", -1).alias("last_part"),
        F.array_min("parts").alias("min_part"),
        F.array_max("parts").alias("max_part"),
        F.array_contains("supps", ND1_SUPPLIER).alias("has_supp"),
        F.reverse("parts").alias("parts_rev"),
        F.slice("parts", 2, 3).alias("parts_2_3"))


def _nd2(F, s):
    return _collected(F, s).select(F.explode("supps")) \
        .groupBy("col").count()


def _nd2p(F, s):
    return _collected(F, s).select("l_orderkey", F.posexplode("parts"))


def _nd3(F, s):
    sup = s.table("supplier")
    keys = _collected(F, s).select(F.explode("supps").alias("supp"))
    return keys.join(sup, F.col("supp") == F.col("s_suppkey")) \
        .filter(F.col("s_nationkey") < ND3_NATIONS) \
        .agg(F.sum("s_acctbal").alias("balance"),
             F.sum(F.lit(1.0)).alias("rows"))


def _nd4(F, s):
    st = s.table("lineitem").select(F.struct(
        "l_orderkey", "l_linenumber", "l_quantity", "l_shipdate").alias("s"))
    return st.filter(F.col("s").getField("l_quantity") > ND4_MIN_QUANTITY) \
        .orderBy(F.col("s").getField("l_orderkey"),
                 F.col("s").getField("l_linenumber")) \
        .limit(ND4_LIMIT)


def lineitem_map(F, s):
    """lineitem's quantity, price and discount as a map {1: q, 2: p,
    3: d} per line."""
    return s.table("lineitem").select(F.create_map(
        F.lit(1), F.col("l_quantity"), F.lit(2), F.col("l_extendedprice"),
        F.lit(3), F.col("l_discount")).alias("m"))


def register_map_view(F, s) -> None:
    """The view ``lineitem_map`` that ND5's SQL form reads."""
    lineitem_map(F, s).createOrReplaceTempView("lineitem_map")


def _nd5(F, s):
    m = F.col("m")
    return lineitem_map(F, s).select(
        F.element_at("m", 2).alias("price"), m[3].alias("disc"),
        F.size("m").alias("n"),
        F.array_min(F.map_keys("m")).alias("kmin"),
        F.array_max(F.map_keys("m")).alias("kmax"),
        F.element_at(F.map_values("m"), 1).alias("q")).agg(
        F.sum("price").alias("price"), F.sum("disc").alias("disc"),
        F.min("n").alias("min_n"), F.max("n").alias("max_n"),
        F.min("kmin").alias("min_key"), F.max("kmax").alias("max_key"),
        F.sum("q").alias("qty"), F.count("*").alias("n"))


def _nd5x(F, s):
    return lineitem_map(F, s).select(F.explode("m")).groupBy("key").agg(
        F.sum("value").alias("total"), F.count("*").alias("n"))


def _shipped_in_year(F, s):
    lo = datetime.date(ND6_YEAR, 1, 1)
    hi = datetime.date(ND6_YEAR + 1, 1, 1)
    return s.table("lineitem").filter(
        (F.col("l_shipdate") >= F.lit(lo)) & (F.col("l_shipdate") < F.lit(hi))
    ).select(F.col("l_shipdate").cast("timestamp").alias("ts"),
             "l_quantity")


def _windowed(F, s, *durations):
    return _shipped_in_year(F, s).groupBy(F.window("ts", *durations)).agg(
        F.sum("l_quantity").alias("qty"), F.count("*").alias("n")) \
        .orderBy("window.start")


def _nd6t(F, s):
    return _windowed(F, s, "7 days")


def _nd6s(F, s):
    return _windowed(F, s, "30 days", "7 days")


def _month_orders(F, s):
    y, m = ND7_MONTH
    lo, hi = datetime.date(y, m, 1), datetime.date(y, m + 1, 1)
    day = F.col("o_orderdate")
    return s.table("orders").filter((day >= F.lit(lo)) & (day < F.lit(hi)))


def _nd7j(F, s):
    cents = F.round(F.col("o_totalprice") * 100).cast("bigint")
    docs = _month_orders(F, s).select(F.concat(
        F.lit('{"key":'), F.col("o_orderkey").cast("string"),
        F.lit(',"status":"'), F.col("o_orderstatus"),
        F.lit('","price":'), cents.cast("string"), F.lit("}")).alias("j"))
    fields = docs.select(
        F.get_json_object("j", "$.status").alias("status"),
        (F.get_json_object("j", "$.price").cast("bigint") / 100.0)
        .alias("price"))
    return fields.groupBy("status").agg(F.sum("price").alias("total"),
                                        F.count("*").alias("n")) \
        .orderBy("status")


def _nd7w(F, s):
    return _month_orders(F, s).select(
        F.explode(F.split("o_comment", " ")).alias("word")) \
        .groupBy("word").count().orderBy("word")


_BUILDERS = {"nd1": _nd1, "nd2": _nd2, "nd2p": _nd2p, "nd3": _nd3,
             "nd4": _nd4, "nd5": _nd5, "nd5x": _nd5x, "nd6t": _nd6t,
             "nd6s": _nd6s, "nd7j": _nd7j, "nd7w": _nd7w}


def build(F, session, name: str):
    """Query ``name`` as a DataFrame of ``session`` (which holds the TPC-H
    views; ``nd5``'s SQL form also ``lineitem_map``)."""
    return _BUILDERS[name](F, session)


_YEAR = f"DATE '{ND6_YEAR}-01-01'", f"DATE '{ND6_YEAR + 1}-01-01'"
_SHIPPED = (f"SELECT CAST(l_shipdate AS TIMESTAMP) AS ts, l_quantity "
            f"FROM lineitem WHERE l_shipdate >= {_YEAR[0]} "
            f"AND l_shipdate < {_YEAR[1]}")

SQL: Dict[str, str] = {
    "nd1": """
SELECT l_orderkey, parts, supps, qty, size(parts) AS n_parts,
       element_at(parts, 1) AS first_part,
       element_at(parts, -1) AS last_part,
       array_min(parts) AS min_part, array_max(parts) AS max_part,
       reverse(parts) AS parts_rev, slice(parts, 2, 3) AS parts_2_3
FROM (SELECT l_orderkey, collect_list(l_partkey) AS parts,
             collect_set(l_suppkey) AS supps, sum(l_quantity) AS qty
      FROM lineitem GROUP BY l_orderkey) x
""",
    "nd4": f"""
SELECT s FROM (SELECT struct(l_orderkey, l_linenumber, l_quantity,
                             l_shipdate) AS s FROM lineitem) x
WHERE s.l_quantity > {ND4_MIN_QUANTITY}
ORDER BY s.l_orderkey, s.l_linenumber
LIMIT {ND4_LIMIT}
""",
    "nd5": """
SELECT sum(element_at(m, 2)) AS price, sum(element_at(m, 3)) AS disc,
       min(size(m)) AS min_n, max(size(m)) AS max_n,
       min(array_min(map_keys(m))) AS min_key,
       max(array_max(map_keys(m))) AS max_key,
       sum(element_at(map_values(m), 1)) AS qty, count(*) AS n
FROM lineitem_map
""",
    "nd6t": f"""
SELECT * FROM (SELECT window(ts, '7 days') AS window,
                      sum(l_quantity) AS qty, count(*) AS n
               FROM ({_SHIPPED}) y
               GROUP BY window(ts, '7 days')) x
ORDER BY window.start
""",
    "nd6s": f"""
SELECT * FROM (SELECT window(ts, '30 days', '7 days') AS window,
                      sum(l_quantity) AS qty, count(*) AS n
               FROM ({_SHIPPED}) y
               GROUP BY window(ts, '30 days', '7 days')) x
ORDER BY window.start
""",
}


# ------------------------------------------------------------ references --

def host_columns(cols) -> Dict[str, Dict[str, object]]:
    """``{table: {column: values}}`` of ``tpch.gen_table_columns``'s
    output: numbers and dates as numpy arrays, strings as ``(offsets,
    chars)``."""
    return {t: {c: v[1] for c, v in cs.items()} for t, cs in cols.items()}


def _strings(buf, rows) -> list:
    """The strings at ``rows`` of an ``(offsets, chars)`` column."""
    offsets, chars = buf
    return [chars[offsets[i]:offsets[i + 1]].tobytes().decode("utf-8")
            for i in rows]


def _sorted_keys(major: np.ndarray, minor: np.ndarray) -> Tuple:
    """(major, minor) of every row, sorted by major then minor, by one
    sort of the packed int64 keys (both non-negative)."""
    bits = max(int(minor.max()).bit_length(), 1) if len(minor) else 1
    if len(major) and int(major.max()).bit_length() + bits > 62:
        raise ValueError("keys do not pack into an int64")
    packed = np.sort((major.astype(np.int64) << bits) | minor)
    return packed >> bits, packed & ((1 << bits) - 1)


def _segments(offsets: np.ndarray) -> np.ndarray:
    """The segment of every element position."""
    return np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))


def _ranks(offsets: np.ndarray) -> np.ndarray:
    """Each element's position within its segment."""
    seg = _segments(offsets)
    return np.arange(offsets[-1]) - offsets[:-1][seg]


def _reversed(offsets: np.ndarray, flat: np.ndarray) -> np.ndarray:
    seg = _segments(offsets)
    i = np.arange(len(flat))
    return flat[offsets[:-1][seg] + offsets[1:][seg] - 1 - i]


def _nd1_refs(li) -> Dict[str, object]:
    okey, part, supp = li["l_orderkey"], li["l_partkey"], li["l_suppkey"]
    counts_by_key = np.bincount(okey)
    keys = np.nonzero(counts_by_key)[0]
    gid = np.cumsum(counts_by_key > 0) - 1
    g = gid[okey]
    counts = counts_by_key[keys]
    offsets = np.concatenate([[0], np.cumsum(counts)])
    # collect_list: each order's lines in input order
    _, rows = _sorted_keys(g, np.arange(len(okey), dtype=np.int64))
    parts = part[rows]
    # collect_set: each order's distinct suppliers, ascending
    pairs = np.unique((g.astype(np.int64) << 20) | supp) \
        if int(supp.max(initial=0)) < (1 << 20) else None
    if pairs is None:
        raise ValueError("supplier keys past 2**20")
    set_g, supps = pairs >> 20, pairs & ((1 << 20) - 1)
    set_offsets = np.concatenate(
        [[0], np.cumsum(np.bincount(set_g, minlength=len(keys)))])
    _, asc = _sorted_keys(g, part)
    starts = offsets[:-1]
    lens = np.clip(counts - 1, 0, 3)
    slice_offsets = np.concatenate([[0], np.cumsum(lens)])
    slice_flat = parts[np.repeat(starts + 1, lens) + _ranks(slice_offsets)]
    has = np.add.reduceat((supps == ND1_SUPPLIER).astype(np.int64),
                          set_offsets[:-1]) > 0
    return {
        "l_orderkey": keys, "parts": (offsets, parts),
        "supps": (set_offsets, supps),
        "qty": np.bincount(g, weights=li["l_quantity"]),
        "n_parts": counts.astype(np.int32), "parts_asc": (offsets, asc),
        "parts_desc": (offsets, _reversed(offsets, asc)),
        "first_part": parts[starts], "last_part": parts[offsets[1:] - 1],
        "min_part": np.minimum.reduceat(parts, starts),
        "max_part": np.maximum.reduceat(parts, starts),
        "has_supp": has, "parts_rev": (offsets, _reversed(offsets, parts)),
        "parts_2_3": (slice_offsets, slice_flat),
    }


def references(cols, names=NAMES) -> Dict[str, Dict[str, object]]:
    """Every answer of ``names`` from ``host_columns`` output, with numpy
    (and Python for ND7's words): column name -> values, an array column
    as (offsets, flat values)."""
    li, out = cols["lineitem"], {}
    nd1 = _nd1_refs(li) if set(names) & {"nd1", "nd2", "nd2p", "nd3"} \
        else None
    if "nd1" in names:
        out["nd1"] = nd1
    if "nd2" in names:
        counts = np.bincount(nd1["supps"][1])
        key = np.nonzero(counts)[0]
        out["nd2"] = {"col": key, "count": counts[key]}
    if "nd2p" in names:
        offsets, parts = nd1["parts"]
        out["nd2p"] = {"l_orderkey": nd1["l_orderkey"][_segments(offsets)],
                       "pos": _ranks(offsets).astype(np.int32),
                       "col": parts}
    if "nd3" in names:
        sup = cols["supplier"]
        row_of = np.zeros(int(sup["s_suppkey"].max()) + 1, dtype=np.int64)
        row_of[sup["s_suppkey"]] = np.arange(len(sup["s_suppkey"]))
        at = row_of[nd1["supps"][1]]
        keep = sup["s_nationkey"][at] < ND3_NATIONS
        out["nd3"] = {"balance": np.array([sup["s_acctbal"][at][keep].sum()]),
                      "rows": np.array([float(keep.sum())])}
    if "nd4" in names:
        idx = np.nonzero(li["l_quantity"] > ND4_MIN_QUANTITY)[0]
        top = idx[np.lexsort((li["l_linenumber"][idx],
                              li["l_orderkey"][idx]))[:ND4_LIMIT]]
        out["nd4"] = {"s": {f: li[f][top] for f in (
            "l_orderkey", "l_linenumber", "l_quantity", "l_shipdate")}}
    n = len(li["l_orderkey"])
    if "nd5" in names:
        out["nd5"] = {
            "price": np.array([li["l_extendedprice"].sum()]),
            "disc": np.array([li["l_discount"].sum()]),
            "min_n": np.array([3]), "max_n": np.array([3]),
            "min_key": np.array([1]), "max_key": np.array([3]),
            "qty": np.array([li["l_quantity"].sum()]), "n": np.array([n])}
    if "nd5x" in names:
        out["nd5x"] = {"key": np.array([1, 2, 3]), "total": np.array(
            [li[c].sum() for c in ("l_quantity", "l_extendedprice",
                                   "l_discount")]),
            "n": np.array([n, n, n])}
    for name, window, slide in (("nd6t", 7, 7), ("nd6s", 30, 7)):
        if name not in names:
            continue
        days = li["l_shipdate"].astype(np.int64)
        keep = (days >= _days(ND6_YEAR, 1)) & (days < _days(ND6_YEAR + 1, 1))
        us, q = days[keep] * DAY_US, li["l_quantity"][keep]
        w, sl = window * DAY_US, slide * DAY_US
        starts, qs = [], []
        for i in range(-(-window // slide)):
            st = us - np.mod(us, sl) - i * sl
            inside = st + w > us
            starts.append(st[inside])
            qs.append(q[inside])
        st, q = np.concatenate(starts), np.concatenate(qs)
        # the starts are multiples of the slide: bucket them
        slot = (st - st.min()) // sl if len(st) else st
        n = np.bincount(slot)
        used = np.nonzero(n)[0]
        start = (st.min() if len(st) else 0) + used * sl
        out[name] = {"window": {"start": start, "end": start + w},
                     "qty": np.bincount(slot, weights=q)[used],
                     "n": n[used]}
    if set(names) & {"nd7j", "nd7w"}:
        od = cols["orders"]
        y, m = ND7_MONTH
        sel = np.nonzero((od["o_orderdate"] >= _days(y, m)) &
                         (od["o_orderdate"] < _days(y, m + 1)))[0]
    if "nd7j" in names:
        status = np.array(_strings(od["o_orderstatus"], sel), dtype=object)
        price = od["o_totalprice"][sel]
        keys = sorted(set(status))
        out["nd7j"] = {"status": np.array(keys, dtype=object),
                       "total": np.array([price[status == k].sum()
                                          for k in keys]),
                       "n": np.array([(status == k).sum() for k in keys])}
    if "nd7w" in names:
        from collections import Counter
        words = Counter(w for c in _strings(od["o_comment"], sel)
                        for w in c.split(" "))
        keys = sorted(words)
        out["nd7w"] = {"word": np.array(keys, dtype=object),
                       "count": np.array([words[k] for k in keys])}
    return out


def _host(col) -> object:
    """An arrow column as numpy values, or (offsets, flat values) for a
    list column, or a dict of fields for a struct column."""
    import pyarrow as pa
    col = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
    if pa.types.is_struct(col.type):
        return {f.name: _host(col.field(f.name)) for f in col.type}
    if pa.types.is_list(col.type) or pa.types.is_large_list(col.type):
        offs = np.asarray(col.offsets)
        return offs - offs[0], _host(col.values.slice(
            int(offs[0]), int(offs[-1] - offs[0])))
    if pa.types.is_date32(col.type):
        return np.asarray(col.cast(pa.int32()))
    if pa.types.is_timestamp(col.type):
        return np.asarray(col.cast(pa.timestamp("us")).cast(pa.int64()))
    if pa.types.is_string(col.type) or pa.types.is_large_string(col.type):
        return np.array(col.to_pylist(), dtype=object)
    return col.to_numpy(zero_copy_only=False)


def _same(got, want, what: str):
    """None when ``got`` equals ``want`` (floats within FLOAT_RTOL),
    else why not."""
    if isinstance(want, dict):
        for k, v in want.items():
            why = _same(got[k], v, f"{what}.{k}")
            if why:
                return why
        return None
    if isinstance(want, tuple):
        return _same(got[0], want[0], f"{what} offsets") or \
            _same(got[1], want[1], f"{what} values")
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return f"{what}: {got.shape} values, want {want.shape}"
    if want.dtype.kind == "f":
        ok = np.allclose(got.astype(np.float64), want, rtol=FLOAT_RTOL,
                         atol=0)
    else:
        ok = np.array_equal(got.astype(want.dtype) if want.dtype.kind != "O"
                            else got, want)
    if ok:
        return None
    bad = np.nonzero(got != want)[0][:3] if want.dtype.kind != "f" else ""
    return f"{what}: differs (first rows {bad})"


def check(name: str, table, refs) -> Tuple[bool, str]:
    """(ok, why) of a query's arrow result against its reference: every
    reference column, by name; integers, keys, arrays and order exact,
    float sums within ``FLOAT_RTOL``."""
    want = refs[name]
    missing = [c for c in want if c not in table.column_names]
    if missing:
        return False, f"{name}: columns {missing} missing"
    for c, v in want.items():
        why = _same(_host(table.column(c)), v, f"{name}.{c}")
        if why:
            return False, why
    return True, ""
