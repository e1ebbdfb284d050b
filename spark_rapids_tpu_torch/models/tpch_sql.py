"""The 22 TPC-H queries as SQL text for ``session.sql``.

Counterpart of ``spark_rapids_tpu/models/tpch_sql.py``: the same text,
letter for letter, over the port's ``models/tpch.load`` tables.

Counterpart of the reference's SQL-side TPC-H coverage (its integration
suite runs the queries through Spark SQL).  The statements follow the
official query set with two systematic adaptations, both standard for
engines without correlated-subquery support (and mirroring how
``models/tpch.py`` translated them for the DataFrame API):

* correlated EXISTS / scalar subqueries decorrelate into joins against
  grouped FROM-subqueries (q2, q4 via LEFT SEMI JOIN, q17, q20, q21);
* ``count(distinct ...)`` becomes DISTINCT in a FROM-subquery + count
  (q16).

Uncorrelated scalar subqueries (q11, q15, q22) and IN-subqueries
(q16, q18, q20, q22) use the SQL frontend's native support.

``register(session, tables)`` installs the temp views; ``QUERIES[name]``
is the SQL text.
"""

from __future__ import annotations

from typing import Dict

TABLES = ("lineitem", "orders", "customer", "supplier", "nation",
          "region", "part", "partsupp")


def register(session, t) -> None:
    """t: dict of table name -> DataFrame (tpch.load output)."""
    for name in TABLES:
        t[name].createOrReplaceTempView(name)


QUERIES: Dict[str, str] = {}

QUERIES["q1"] = """
SELECT l_returnflag, l_linestatus,
       sum(l_quantity) AS sum_qty,
       sum(l_extendedprice) AS sum_base_price,
       sum(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
       sum(l_extendedprice * (1 - l_discount) * (1 + l_tax))
         AS sum_charge,
       avg(l_quantity) AS avg_qty,
       avg(l_extendedprice) AS avg_price,
       avg(l_discount) AS avg_disc,
       count(*) AS count_order
FROM lineitem
WHERE l_shipdate <= DATE '1998-09-02'
GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus
"""

QUERIES["q2"] = """
SELECT s_acctbal, s_name, n_name, ps_partkey, p_mfgr, s_address,
       s_phone
FROM (
  SELECT ps.ps_partkey, ps.ps_supplycost, p.p_mfgr,
         s.s_acctbal, s.s_name, s.s_address, s.s_phone, n.n_name
  FROM partsupp ps
  JOIN part p ON ps.ps_partkey = p.p_partkey
  JOIN supplier s ON ps.ps_suppkey = s.s_suppkey
  JOIN nation n ON s.s_nationkey = n.n_nationkey
  JOIN region r ON n.n_regionkey = r.r_regionkey
  WHERE p.p_size = 15 AND p.p_type LIKE '%BRASS'
    AND r.r_name = 'EUROPE'
) e
JOIN (
  SELECT ps.ps_partkey AS mk, min(ps.ps_supplycost) AS min_cost
  FROM partsupp ps
  JOIN part p ON ps.ps_partkey = p.p_partkey
  JOIN supplier s ON ps.ps_suppkey = s.s_suppkey
  JOIN nation n ON s.s_nationkey = n.n_nationkey
  JOIN region r ON n.n_regionkey = r.r_regionkey
  WHERE p.p_size = 15 AND p.p_type LIKE '%BRASS'
    AND r.r_name = 'EUROPE'
  GROUP BY ps.ps_partkey
) m ON e.ps_partkey = m.mk AND e.ps_supplycost = m.min_cost
ORDER BY s_acctbal DESC, n_name, s_name, ps_partkey
LIMIT 100
"""

QUERIES["q3"] = """
SELECT l_orderkey,
       sum(l_extendedprice * (1 - l_discount)) AS revenue,
       o_orderdate, o_shippriority
FROM customer c
JOIN orders o ON c.c_custkey = o.o_custkey
JOIN lineitem l ON o.o_orderkey = l.l_orderkey
WHERE c.c_mktsegment = 'BUILDING'
  AND o.o_orderdate < DATE '1995-03-15'
  AND l.l_shipdate > DATE '1995-03-15'
GROUP BY l_orderkey, o_orderdate, o_shippriority
ORDER BY revenue DESC, o_orderdate
LIMIT 10
"""

QUERIES["q4"] = """
SELECT o_orderpriority, count(*) AS order_count
FROM orders o
LEFT SEMI JOIN (
  SELECT l_orderkey FROM lineitem WHERE l_commitdate < l_receiptdate
) late ON o.o_orderkey = late.l_orderkey
WHERE o_orderdate >= DATE '1993-07-01'
  AND o_orderdate < DATE '1993-10-01'
GROUP BY o_orderpriority
ORDER BY o_orderpriority
"""

QUERIES["q5"] = """
SELECT n_name, sum(l_extendedprice * (1 - l_discount)) AS revenue
FROM customer c
JOIN orders o ON c.c_custkey = o.o_custkey
JOIN lineitem l ON o.o_orderkey = l.l_orderkey
JOIN supplier s
  ON l.l_suppkey = s.s_suppkey AND c.c_nationkey = s.s_nationkey
JOIN nation n ON s.s_nationkey = n.n_nationkey
JOIN region r ON n.n_regionkey = r.r_regionkey
WHERE r.r_name = 'ASIA'
  AND o.o_orderdate >= DATE '1994-01-01'
  AND o.o_orderdate < DATE '1995-01-01'
GROUP BY n_name
ORDER BY revenue DESC
"""

QUERIES["q6"] = """
SELECT sum(l_extendedprice * l_discount) AS revenue
FROM lineitem
WHERE l_shipdate >= DATE '1994-01-01'
  AND l_shipdate < DATE '1995-01-01'
  AND l_discount BETWEEN 0.05 AND 0.07
  AND l_quantity < 24
"""

QUERIES["q7"] = """
SELECT supp_nation, cust_nation, l_year, sum(volume) AS revenue
FROM (
  SELECT n1.n_name AS supp_nation, n2.n_name AS cust_nation,
         year(l.l_shipdate) AS l_year,
         l.l_extendedprice * (1 - l.l_discount) AS volume
  FROM supplier s
  JOIN lineitem l ON s.s_suppkey = l.l_suppkey
  JOIN orders o ON o.o_orderkey = l.l_orderkey
  JOIN customer c ON c.c_custkey = o.o_custkey
  JOIN nation n1 ON s.s_nationkey = n1.n_nationkey
  JOIN nation n2 ON c.c_nationkey = n2.n_nationkey
  WHERE l.l_shipdate >= DATE '1995-01-01'
    AND l.l_shipdate <= DATE '1996-12-31'
    AND ((n1.n_name = 'FRANCE' AND n2.n_name = 'GERMANY')
         OR (n1.n_name = 'GERMANY' AND n2.n_name = 'FRANCE'))
) shipping
GROUP BY supp_nation, cust_nation, l_year
ORDER BY supp_nation, cust_nation, l_year
"""

QUERIES["q8"] = """
SELECT o_year,
       sum(CASE WHEN nation = 'BRAZIL' THEN volume ELSE 0.0 END)
         / sum(volume) AS mkt_share
FROM (
  SELECT year(o.o_orderdate) AS o_year,
         l.l_extendedprice * (1 - l.l_discount) AS volume,
         n2.n_name AS nation
  FROM part p
  JOIN lineitem l ON p.p_partkey = l.l_partkey
  JOIN supplier s ON s.s_suppkey = l.l_suppkey
  JOIN orders o ON l.l_orderkey = o.o_orderkey
  JOIN customer c ON o.o_custkey = c.c_custkey
  JOIN nation n1 ON c.c_nationkey = n1.n_nationkey
  JOIN region r ON n1.n_regionkey = r.r_regionkey
  JOIN nation n2 ON s.s_nationkey = n2.n_nationkey
  WHERE r.r_name = 'AMERICA'
    AND o.o_orderdate >= DATE '1995-01-01'
    AND o.o_orderdate <= DATE '1996-12-31'
    AND p.p_type = 'ECONOMY ANODIZED STEEL'
) all_nations
GROUP BY o_year
ORDER BY o_year
"""

QUERIES["q9"] = """
SELECT nation, o_year, sum(amount) AS sum_profit
FROM (
  SELECT n.n_name AS nation, year(o.o_orderdate) AS o_year,
         l.l_extendedprice * (1 - l.l_discount)
           - ps.ps_supplycost * l.l_quantity AS amount
  FROM part p
  JOIN lineitem l ON p.p_partkey = l.l_partkey
  JOIN supplier s ON s.s_suppkey = l.l_suppkey
  JOIN partsupp ps
    ON ps.ps_suppkey = l.l_suppkey AND ps.ps_partkey = l.l_partkey
  JOIN orders o ON o.o_orderkey = l.l_orderkey
  JOIN nation n ON s.s_nationkey = n.n_nationkey
  WHERE p.p_name LIKE '%green%'
) profit
GROUP BY nation, o_year
ORDER BY nation, o_year DESC
"""

QUERIES["q10"] = """
SELECT o_custkey, c_name, sum(l_extendedprice * (1 - l_discount))
         AS revenue,
       c_acctbal, n_name, c_phone, c_comment
FROM customer c
JOIN orders o ON c.c_custkey = o.o_custkey
JOIN lineitem l ON l.l_orderkey = o.o_orderkey
JOIN nation n ON c.c_nationkey = n.n_nationkey
WHERE o.o_orderdate >= DATE '1993-10-01'
  AND o.o_orderdate < DATE '1994-01-01'
  AND l.l_returnflag = 'R'
GROUP BY o_custkey, c_name, c_acctbal, c_phone, n_name, c_comment
ORDER BY revenue DESC
LIMIT 20
"""

QUERIES["q11"] = """
SELECT ps_partkey, sum(ps_supplycost * CAST(ps_availqty AS double))
         AS value
FROM partsupp ps
JOIN supplier s ON ps.ps_suppkey = s.s_suppkey
JOIN nation n ON s.s_nationkey = n.n_nationkey
WHERE n.n_name = 'GERMANY'
GROUP BY ps_partkey
HAVING sum(ps_supplycost * CAST(ps_availqty AS double)) > (
  SELECT sum(ps_supplycost * CAST(ps_availqty AS double)) * 0.0001
  FROM partsupp ps
  JOIN supplier s ON ps.ps_suppkey = s.s_suppkey
  JOIN nation n ON s.s_nationkey = n.n_nationkey
  WHERE n.n_name = 'GERMANY'
)
ORDER BY value DESC
"""

QUERIES["q12"] = """
SELECT l_shipmode,
       sum(CASE WHEN o_orderpriority = '1-URGENT'
                  OR o_orderpriority = '2-HIGH'
                THEN 1 ELSE 0 END) AS high_line_count,
       sum(CASE WHEN o_orderpriority <> '1-URGENT'
                 AND o_orderpriority <> '2-HIGH'
                THEN 1 ELSE 0 END) AS low_line_count
FROM orders o
JOIN lineitem l ON o.o_orderkey = l.l_orderkey
WHERE l.l_shipmode IN ('MAIL', 'SHIP')
  AND l.l_commitdate < l.l_receiptdate
  AND l.l_shipdate < l.l_commitdate
  AND l.l_receiptdate >= DATE '1994-01-01'
  AND l.l_receiptdate < DATE '1995-01-01'
GROUP BY l_shipmode
ORDER BY l_shipmode
"""

QUERIES["q13"] = """
SELECT c_count, count(*) AS custdist
FROM (
  SELECT c.c_custkey, count(o.o_orderkey) AS c_count
  FROM customer c
  LEFT JOIN (
    SELECT o_orderkey, o_custkey FROM orders
    WHERE NOT o_comment LIKE '%special%requests%'
  ) o ON c.c_custkey = o.o_custkey
  GROUP BY c.c_custkey
) c_orders
GROUP BY c_count
ORDER BY custdist DESC, c_count DESC
"""

QUERIES["q14"] = """
SELECT 100.00 * sum(CASE WHEN p_type LIKE 'PROMO%'
                         THEN l_extendedprice * (1 - l_discount)
                         ELSE 0.0 END)
         / sum(l_extendedprice * (1 - l_discount)) AS promo_revenue
FROM lineitem l
JOIN part p ON l.l_partkey = p.p_partkey
WHERE l.l_shipdate >= DATE '1995-09-01'
  AND l.l_shipdate < DATE '1995-10-01'
"""

QUERIES["q15"] = """
SELECT s_suppkey, s_name, s_address, s_phone, total_revenue
FROM supplier s
JOIN (
  SELECT l_suppkey, sum(l_extendedprice * (1 - l_discount))
           AS total_revenue
  FROM lineitem
  WHERE l_shipdate >= DATE '1996-01-01'
    AND l_shipdate < DATE '1996-04-01'
  GROUP BY l_suppkey
) revenue ON s.s_suppkey = revenue.l_suppkey
WHERE total_revenue >= (
  SELECT max(total_revenue) FROM (
    SELECT l_suppkey, sum(l_extendedprice * (1 - l_discount))
             AS total_revenue
    FROM lineitem
    WHERE l_shipdate >= DATE '1996-01-01'
      AND l_shipdate < DATE '1996-04-01'
    GROUP BY l_suppkey
  ) r
)
ORDER BY s_suppkey
"""

QUERIES["q16"] = """
SELECT p_brand, p_type, p_size, count(*) AS supplier_cnt
FROM (
  SELECT DISTINCT p.p_brand, p.p_type, p.p_size, ps.ps_suppkey
  FROM partsupp ps
  JOIN part p ON p.p_partkey = ps.ps_partkey
  WHERE p.p_brand <> 'Brand#45'
    AND NOT p.p_type LIKE 'MEDIUM POLISHED%'
    AND p.p_size IN (49, 14, 23, 45, 19, 3, 36, 9)
    AND ps.ps_suppkey NOT IN (
      SELECT s_suppkey FROM supplier
      WHERE s_comment LIKE '%Customer%Complaints%'
    )
) d
GROUP BY p_brand, p_type, p_size
ORDER BY supplier_cnt DESC, p_brand, p_type, p_size
"""

QUERIES["q17"] = """
SELECT sum(l_extendedprice) / 7.0 AS avg_yearly
FROM lineitem l
JOIN (
  SELECT l_partkey AS agg_partkey,
         0.2 * avg(l_quantity) AS avg_quantity
  FROM lineitem
  WHERE l_partkey IN (
    SELECT p_partkey FROM part
    WHERE p_brand = 'Brand#23' AND p_container = 'MED BOX'
  )
  GROUP BY l_partkey
) pa ON l.l_partkey = pa.agg_partkey
WHERE l.l_quantity < pa.avg_quantity
"""

QUERIES["q18"] = """
SELECT c_name, o_custkey, o_orderkey, o_orderdate, o_totalprice,
       sum(l_quantity) AS sum_qty
FROM customer c
JOIN orders o ON c.c_custkey = o.o_custkey
JOIN lineitem l ON o.o_orderkey = l.l_orderkey
WHERE o.o_orderkey IN (
  SELECT l_orderkey FROM lineitem
  GROUP BY l_orderkey HAVING sum(l_quantity) > 300
)
GROUP BY c_name, o_custkey, o_orderkey, o_orderdate, o_totalprice
ORDER BY o_totalprice DESC, o_orderdate
LIMIT 100
"""

QUERIES["q19"] = """
SELECT sum(l_extendedprice * (1 - l_discount)) AS revenue
FROM lineitem l
JOIN part p ON p.p_partkey = l.l_partkey
WHERE l.l_shipmode IN ('AIR', 'REG AIR')
  AND l.l_shipinstruct = 'DELIVER IN PERSON'
  AND ((p.p_brand LIKE 'Brand#1%'
        AND p.p_container IN ('SM CASE', 'SM BOX')
        AND l.l_quantity >= 1 AND l.l_quantity <= 11
        AND p.p_size BETWEEN 1 AND 15)
    OR (p.p_brand LIKE 'Brand#2%'
        AND p.p_container IN ('MED BAG', 'MED BOX')
        AND l.l_quantity >= 10 AND l.l_quantity <= 20
        AND p.p_size BETWEEN 1 AND 25)
    OR (p.p_brand LIKE 'Brand#3%'
        AND p.p_container IN ('LG CASE', 'LG BOX')
        AND l.l_quantity >= 20 AND l.l_quantity <= 30
        AND p.p_size BETWEEN 1 AND 35))
"""

QUERIES["q20"] = """
SELECT s_name, s_address
FROM supplier s
JOIN nation n ON s.s_nationkey = n.n_nationkey
WHERE n.n_name = 'CANADA'
  AND s.s_suppkey IN (
    SELECT ps_suppkey FROM (
      SELECT ps.ps_suppkey, ps.ps_availqty, q.half_qty
      FROM partsupp ps
      JOIN (
        SELECT l_partkey, l_suppkey,
               0.5 * sum(l_quantity) AS half_qty
        FROM lineitem
        WHERE l_shipdate >= DATE '1994-01-01'
          AND l_shipdate < DATE '1995-01-01'
        GROUP BY l_partkey, l_suppkey
      ) q ON ps.ps_partkey = q.l_partkey
         AND ps.ps_suppkey = q.l_suppkey
      WHERE ps.ps_partkey IN (
        SELECT p_partkey FROM part WHERE p_name LIKE 'forest%'
      )
    ) avail
    WHERE CAST(ps_availqty AS double) > half_qty
  )
ORDER BY s_name
"""

QUERIES["q21"] = """
SELECT s_name, count(*) AS numwait
FROM (
  SELECT DISTINCT late.l_orderkey, late.l_suppkey
  FROM (
    SELECT l_orderkey, l_suppkey FROM lineitem
    WHERE l_receiptdate > l_commitdate
  ) late
  JOIN (
    SELECT aa.l_orderkey AS ok2, count(*) AS n_supp FROM (
      SELECT DISTINCT l_orderkey, l_suppkey FROM lineitem
    ) aa GROUP BY aa.l_orderkey
  ) ca ON late.l_orderkey = ca.ok2
  JOIN (
    SELECT bb.l_orderkey AS ok3, count(*) AS n_late FROM (
      SELECT DISTINCT l_orderkey, l_suppkey FROM lineitem
      WHERE l_receiptdate > l_commitdate
    ) bb GROUP BY bb.l_orderkey
  ) cl ON late.l_orderkey = cl.ok3
  WHERE ca.n_supp > 1 AND cl.n_late = 1
    AND late.l_orderkey IN (
      SELECT o_orderkey FROM orders WHERE o_orderstatus = 'F'
    )
) waiting
JOIN supplier s ON waiting.l_suppkey = s.s_suppkey
JOIN nation n ON s.s_nationkey = n.n_nationkey
WHERE n.n_name = 'SAUDI ARABIA'
GROUP BY s_name
ORDER BY numwait DESC, s_name
LIMIT 100
"""

QUERIES["q22"] = """
SELECT cntrycode, count(*) AS numcust, sum(c_acctbal) AS totacctbal
FROM (
  SELECT substring(c_phone, 1, 2) AS cntrycode, c_acctbal, c_custkey
  FROM customer
  WHERE substring(c_phone, 1, 2) IN
        ('13', '31', '23', '29', '30', '18', '17')
) custsale
WHERE c_acctbal > (
  SELECT avg(c_acctbal) FROM customer
  WHERE c_acctbal > 0.0
    AND substring(c_phone, 1, 2) IN
        ('13', '31', '23', '29', '30', '18', '17')
)
AND c_custkey NOT IN (SELECT o_custkey FROM orders)
GROUP BY cntrycode
ORDER BY cntrycode
"""


def dataframe_form(name: str, df):
    """The answer of ``models/tpch.QUERIES[name]`` (a pandas frame) in
    the SQL text's columns: q14's DataFrame form returns both sums of the
    ratio (100 * promo_sum, total_sum) where the SQL text computes it, and
    q3 and q10 list the same columns in another order."""
    import pandas as pd
    if name == "q14":
        return pd.DataFrame({"promo_revenue": [
            df["promo_sum"].iloc[0] / df["total_sum"].iloc[0]]})
    order = {"q3": ["l_orderkey", "revenue", "o_orderdate",
                    "o_shippriority"],
             "q10": ["o_custkey", "c_name", "revenue", "c_acctbal",
                     "n_name", "c_phone", "c_comment"]}
    return df[order[name]] if name in order else df
