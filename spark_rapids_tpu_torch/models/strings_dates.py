"""SD1-SD10: string, date-and-time, regex and hash queries over TPC-H.

Ten queries over the TPC-H tables (``models/tpch.py``'s generators,
registered as views by ``models/tpch_sql.register``) that reach the
string, date and time, regex and hash function library the way ETL and
reporting queries do: cleaning names and phone numbers, bucketing dates
by month and weekday, hashing keys, casting text to numbers and dates.
Each is SQL text for ``session.sql``, except SD3, which is a function
that builds a DataFrame (the SQL front end has no ``rlike``):
``QUERIES[name]`` is the text, or a function ``(F, session) ->
DataFrame`` of a functions module and a session holding the views.
Derived group keys group through a subquery.

``FALLBACK_NODES[name]``: the plan nodes each query runs in the CPU
fallback (SD9's outer projection: ``md5``, a double cast to a string and
a regex outside the device subset).  ``run(F, session, name)`` builds the
query.  The engine does not import this module.
"""

from __future__ import annotations

from typing import Dict

QUERIES: Dict[str, object] = {}

QUERIES["sd1"] = """
SELECT seg, nat, count(*) AS n, sum(c_acctbal) AS balance
FROM (SELECT initcap(lower(c_mktsegment)) AS seg,
             lpad(upper(n_name), 16, '.') AS nat, c_acctbal
      FROM customer JOIN nation ON c_nationkey = n_nationkey) x
GROUP BY seg, nat
ORDER BY seg, nat
"""

QUERIES["sd2"] = """
SELECT cc, count(*) AS n, sum(tail) AS sum_tail, max(name_len) AS max_name,
       max(dash) AS max_dash
FROM (SELECT CAST(substring_index(c_phone, '-', 1) AS INT) AS cc,
             CAST(regexp_replace(c_phone, '-', '') AS BIGINT) % 1000
               AS tail,
             length(trim(concat(' ', c_name, ' '))) AS name_len,
             locate('-', c_phone, 4) AS dash
      FROM customer) x
GROUP BY cc
ORDER BY cc
"""


def _sd3(F, session):
    o = session.table("orders")
    hits = o.filter(F.rlike("o_comment", "special.*requests")
                    | F.col("o_comment").rlike("^[a-z]{3}.+ly$"))
    return (hits.select(
        "o_orderpriority", "o_orderstatus",
        F.length(F.replace("o_comment", " ", "")).alias("dense"),
        F.locate("special", F.col("o_comment")).alias("pos"))
        .groupBy("o_orderpriority", "o_orderstatus")
        .agg(F.count("*").alias("n"), F.sum("dense").alias("dense_chars"),
             F.sum("pos").alias("special_at"))
        .orderBy("o_orderpriority", "o_orderstatus"))


QUERIES["sd3"] = _sd3

QUERIES["sd4"] = """
SELECT k, count(*) AS n, sum(ps_supplycost) AS cost, max(m3) AS mfgr3,
       min(t) AS first_type
FROM (SELECT substring_index(
               concat_ws('|', ltrim(concat('  ', p_brand)),
                         rtrim(concat(p_container, '  ')),
                         translate(p_type, 'AEIOU', 'aeiou')), '|', 2) AS k,
             translate(p_type, 'AEIOU', 'aeiou') AS t,
             repeat(substring(p_mfgr, 14, 1), 3) AS m3, ps_supplycost
      FROM part JOIN partsupp ON p_partkey = ps_partkey) x
GROUP BY k
ORDER BY k
"""

QUERIES["sd5"] = """
SELECT ym, wd, count(*) AS n, sum(o_totalprice) AS total,
       min(ld) AS first_month_end, max(tm) AS last_month_start,
       sum(q) AS quarters, sum(dw) AS days_of_week, sum(dy) AS days_of_year
FROM (SELECT date_format(o_orderdate, 'yyyy-MM') AS ym,
             weekday(o_orderdate) AS wd, quarter(o_orderdate) AS q,
             dayofweek(o_orderdate) AS dw, dayofyear(o_orderdate) AS dy,
             last_day(o_orderdate) AS ld, trunc(o_orderdate, 'MM') AS tm,
             o_totalprice
      FROM orders) x
GROUP BY ym, wd
ORDER BY ym, wd
"""

QUERIES["sd6"] = """
SELECT l_shipmode, late, count(*) AS n, sum(dd) AS transit_days,
       sum(mb) AS months, max(nd) AS last_monday
FROM (SELECT l_shipmode, add_months(o_orderdate, 2) < l_shipdate AS late,
             datediff(l_receiptdate, l_shipdate) AS dd,
             months_between(l_receiptdate, o_orderdate) AS mb,
             next_day(o_orderdate, 'MO') AS nd
      FROM lineitem JOIN orders ON l_orderkey = o_orderkey) x
GROUP BY l_shipmode, late
ORDER BY l_shipmode, late
"""

QUERIES["sd7"] = """
SELECT h, count(*) AS n, min(f) AS first_ts, max(f) AS last_ts,
       sum(mi) AS minutes, sum(se) AS seconds, max(u) AS last_epoch
FROM (SELECT hour(ts) AS h, minute(ts) AS mi, second(ts) AS se,
             to_unix_timestamp(ts) AS u,
             date_format(ts, 'yyyy-MM-dd HH:mm:ss') AS f
      FROM (SELECT CAST(from_unixtime(
                     unix_timestamp(CAST(o_orderdate AS TIMESTAMP))
                     + o_orderkey % 86400) AS TIMESTAMP) AS ts
            FROM orders) y) x
GROUP BY h
ORDER BY h
"""

QUERIES["sd8"] = """
SELECT brand, count(*) AS n, sum(ln) AS line_numbers,
       sum(same) AS equal_dates
FROM (SELECT CAST(substring(p_brand, 7) AS INT) AS brand,
             CAST(CAST(l_linenumber AS STRING) AS INT) AS ln,
             CASE WHEN CAST(CAST(l_shipdate AS STRING) AS DATE) = l_shipdate
                   AND CAST('true' AS BOOLEAN) THEN 1 ELSE 0 END AS same
      FROM lineitem JOIN part ON l_partkey = p_partkey) x
GROUP BY brand
ORDER BY brand
"""

QUERIES["sd9"] = """
SELECT b, count(*) AS n, min(m) AS min_md5, max(length(c)) AS max_comment,
       min(a) AS min_balance, max(code) AS max_ascii, min(ch) AS min_chr
FROM (SELECT b, md5(s_name) AS m, CAST(s_acctbal AS STRING) AS a,
             regexp_replace(s_comment, 'Customer (Complaints|Recommends)',
                            'C') AS c, code, ch
      FROM (SELECT hash(s_name, s_suppkey) % 32 AS b,
                   ascii(s_name) AS code, chr(65 + s_nationkey) AS ch,
                   s_name, s_acctbal, s_comment
            FROM supplier JOIN nation ON s_nationkey = n_nationkey) y) x
GROUP BY b
ORDER BY b
"""

QUERIES["sd10"] = """
SELECT y, len, count(*) AS n, sum(datediff(g, l)) AS spread,
       sum(CASE WHEN nan THEN 1 ELSE 0 END) AS nans
FROM (SELECT year(greatest(l_shipdate, l_commitdate, l_receiptdate)) AS y,
             greatest(l_shipdate, l_commitdate, l_receiptdate) AS g,
             least(l_shipdate, l_commitdate, l_receiptdate) AS l,
             length(l_shipinstruct) AS len, isnan(l_discount) AS nan
      FROM lineitem) x
GROUP BY y, len
ORDER BY y, len
"""

# the tables each query reads
TABLES = {"sd1": ("customer", "nation"), "sd2": ("customer",),
          "sd3": ("orders",), "sd4": ("part", "partsupp"),
          "sd5": ("orders",), "sd6": ("lineitem", "orders"),
          "sd7": ("orders",), "sd8": ("lineitem", "part"),
          "sd9": ("supplier", "nation"), "sd10": ("lineitem",)}

# the plan nodes each query runs in the CPU fallback
FALLBACK_NODES = {name: [] for name in QUERIES}
FALLBACK_NODES["sd9"] = ["Project"]


def run(F, session, name: str):
    """Query ``name`` as a DataFrame of ``session`` (which holds the
    TPC-H views); ``F`` is the functions module of the session's
    engine."""
    q = QUERIES[name]
    return q(F, session) if callable(q) else session.sql(q)
