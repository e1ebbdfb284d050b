"""The PyTorch port's SQL front end against the JAX package's, on the
CPU.

* The parser on every statement of the two suites (the 22 TPC-H queries
  as SQL, the 29 TPC-DS queries): the port's copy builds the same AST,
  compared as dataclass trees.
* The grammar of ``tests/test_sql.py``, each statement run through both
  engines' ``session.sql`` over the same numpy-seeded tables with nulls:
  CTEs, FROM-subqueries, USING, semi/anti joins, IN and scalar
  subqueries, NOT IN with and without a NULL in the list, HAVING, ORDER
  BY position and alias, DISTINCT, LIMIT, UNION ALL, a FROM-less SELECT,
  windows and rollup.  Output names must be equal letter for letter;
  keys, strings, counts and row order exactly (rows sorted first where
  the statement does not fix their order); floats within a relative
  1e-12 (the port sums in another order).
* What the port does not run raises ``NotImplementedError`` naming it.
"""

import dataclasses

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.models import tpcds as jax_tpcds
from spark_rapids_tpu.models import tpch_sql as jax_tpch_sql
from spark_rapids_tpu.sql import parse as jax_parse
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.sql import parse

RTOL = 1e-12
HASH_ON = {"spark.rapids.tpu.pallas.hash.enabled": True,
           "spark.rapids.tpu.pallas.hash.tableSlots": 1 << 12}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the host: one torch thread here."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def tree(node):
    """A parse tree as nested (class name, fields) tuples, so two
    packages' dataclasses compare by value."""
    if dataclasses.is_dataclass(node):
        return (type(node).__name__,
                tuple((f.name, tree(getattr(node, f.name)))
                      for f in dataclasses.fields(node)))
    if isinstance(node, (list, tuple)):
        return (type(node).__name__, tuple(tree(x) for x in node))
    return node


STATEMENTS = {f"tpch_{k}": v for k, v in jax_tpch_sql.QUERIES.items()}
STATEMENTS.update({f"tpcds_{k}": v for k, v in jax_tpcds.QUERIES.items()})


@pytest.mark.parametrize("name", list(STATEMENTS))
def test_parser_builds_the_jax_tree(name):
    text = STATEMENTS[name]
    assert tree(parse(text)) == tree(jax_parse(text))


def _tables():
    rng = np.random.default_rng(7)
    n = 120
    cust = rng.integers(0, 12, n).tolist()
    for i in rng.choice(n, 9, replace=False):
        cust[i] = None
    notes = [f"order {i} info" if i % 7 else None for i in range(n)]
    notes[5] = "special"
    return {
        "orders": {"o_id": np.arange(n, dtype=np.int64), "cust": cust,
                   "amount": rng.uniform(10, 500, n).round(2),
                   "note": notes},
        "customers": {"c_id": np.arange(12, dtype=np.int64),
                      "name": [f"cust{i}" for i in range(12)],
                      "region": rng.integers(0, 3, 12)},
        "na_a": {"k": np.array([1.0, 2.0])},
        "na_b": {"v": [1.0, None]},
        "na_c": {"v": np.array([1.0])},
        "na_d": {"v": np.array([5.0])},
        "oq": {"cust": np.array([1, 2, 3, 4]),
               "amt": np.array([4.0, 3.0, 2.0, 1.0])},
    }


def _session(make, tables):
    s = make()
    for name, data in tables.items():
        s.create_dataframe(data).createOrReplaceTempView(name)
    return s


@pytest.fixture(scope="module")
def sessions():
    tables = _tables()
    jax = _session(lambda: JaxSession({}), tables)
    out = {"jax": jax,
           "default": _session(lambda: TpuSession({}, device="cpu"),
                               tables),
           "hash": _session(lambda: TpuSession(HASH_ON, device="cpu"),
                            tables)}
    yield out
    jax.stop()


# name -> (statement, whether its ORDER BY fixes the row order)
CASES = {
    "projection_filter": (
        "SELECT o_id, amount * 2 AS dbl FROM orders WHERE amount > 400 "
        "ORDER BY o_id", True),
    "star_limit": ("SELECT * FROM customers ORDER BY c_id LIMIT 3", True),
    "group_having_order": (
        "SELECT cust, count(*) AS n, sum(amount) AS total FROM orders "
        "GROUP BY cust HAVING count(*) >= 5 ORDER BY total DESC", True),
    "agg_arithmetic": (
        "SELECT cust, sum(amount) / count(*) + 1 AS x, avg(amount) "
        "FROM orders GROUP BY cust", False),
    "join_qualifiers": (
        "SELECT c.name, o.amount FROM orders o JOIN customers c "
        "ON o.cust = c.c_id WHERE c.region = 1 ORDER BY o.o_id", True),
    "left_join": (
        "SELECT o.o_id, c.name FROM orders o LEFT JOIN customers c "
        "ON o.cust = c.c_id ORDER BY o.o_id", True),
    "semi_join": (
        "SELECT c_id, name FROM customers LEFT SEMI JOIN orders "
        "ON customers.c_id = orders.cust ORDER BY c_id", True),
    "anti_join": (
        "SELECT c_id FROM customers LEFT ANTI JOIN "
        "(SELECT cust FROM orders WHERE amount > 450) t "
        "ON customers.c_id = t.cust ORDER BY c_id", True),
    "using_join": (
        "SELECT name, amount FROM (SELECT cust AS c_id, amount, o_id "
        "FROM orders) o2 JOIN customers USING (c_id) "
        "ORDER BY amount, o_id LIMIT 5", True),
    "using_join_right_dup": (
        "SELECT o2.o_id, customers.region FROM (SELECT cust AS c_id, "
        "o_id, o_id % 3 AS region FROM orders) o2 JOIN customers "
        "USING (c_id) ORDER BY o2.o_id", True),
    "case_cast_between_in_like": (
        "SELECT o_id, CASE WHEN amount > 250 THEN 'big' ELSE 'small' END "
        "AS sz, CAST(amount AS int) AS amt_i, abs(amount - 300) AS dist "
        "FROM orders WHERE amount BETWEEN 100 AND 300 "
        "AND cust IN (1, 2, 3) AND note LIKE 'order %' ORDER BY o_id",
        True),
    "not_between_not_like": (
        "SELECT o_id FROM orders WHERE amount NOT BETWEEN 100 AND 400 "
        "AND note NOT LIKE '%1%' AND cust NOT IN (4, 5) ORDER BY o_id",
        True),
    "distinct": ("SELECT DISTINCT region FROM customers", False),
    "union_all": (
        "SELECT c_id FROM customers WHERE region = 0 "
        "UNION ALL SELECT c_id FROM customers WHERE region = 0", False),
    "from_subquery": (
        "SELECT t.cust, t.total FROM (SELECT cust, sum(amount) AS total "
        "FROM orders GROUP BY cust) t WHERE t.total > 1000 "
        "ORDER BY t.total DESC", True),
    "window_row_number": (
        "SELECT o_id, cust, row_number() OVER (PARTITION BY cust "
        "ORDER BY amount DESC) AS rk FROM orders ORDER BY cust, rk", True),
    "window_nested_in_arithmetic": (
        "SELECT o_id, cust, amount * 100.0 / sum(amount) OVER "
        "(PARTITION BY cust) AS pct FROM orders ORDER BY o_id", True),
    "window_lag_lead_frames": (
        "SELECT o_id, lag(amount, 1) OVER (PARTITION BY cust ORDER BY "
        "o_id) AS prv, lead(amount, 2, 0.0) OVER (PARTITION BY cust "
        "ORDER BY o_id) AS nxt, avg(amount) OVER (PARTITION BY cust "
        "ORDER BY o_id ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) AS mov "
        "FROM orders ORDER BY o_id", True),
    "rollup_grouping": (
        "SELECT region, c_id % 2 AS par, sum(c_id) AS s, "
        "grouping(region) AS g FROM customers "
        "GROUP BY ROLLUP(region, c_id % 2) "
        "ORDER BY region, par", False),
    "select_without_from": ("SELECT 1 + 1 AS two, 'x' AS s", True),
    "date_literal": (
        "SELECT count(*) AS n FROM orders WHERE o_id < 50", True),
    "not_in_with_null": (
        "SELECT k FROM na_a WHERE k NOT IN (SELECT v FROM na_b)", True),
    "not_in_without_null": (
        "SELECT k FROM na_a WHERE k NOT IN (SELECT v FROM na_c)", True),
    "not_in_empty": (
        "SELECT k FROM na_a WHERE k NOT IN "
        "(SELECT v FROM na_d WHERE v > 99) ORDER BY k", True),
    "in_subquery": (
        "SELECT count(*) AS n FROM orders WHERE cust IN "
        "(SELECT c_id FROM customers WHERE region = 2)", True),
    "scalar_subquery": (
        "SELECT o_id FROM orders WHERE amount > "
        "(SELECT avg(amount) FROM orders) ORDER BY o_id", True),
    "empty_scalar_subquery": (
        "SELECT cust FROM orders WHERE amount > "
        "(SELECT amount FROM orders WHERE amount > 99999)", True),
    "order_by_position_and_alias": (
        "SELECT cust AS c, amount AS a FROM orders ORDER BY 1, a DESC",
        True),
    "order_by_input_column": (
        "SELECT o_id FROM orders ORDER BY amount DESC LIMIT 10", True),
    "order_by_qualified_input": (
        "SELECT amt AS cust FROM oq ORDER BY oq.cust DESC", True),
    "group_expr_reprojection": (
        "SELECT cust / 2 AS h, count(*) AS n FROM orders "
        "GROUP BY cust / 2 ORDER BY h", True),
    "scientific_literal": ("SELECT 1e5 AS big, 2.5e-2 AS small", True),
    "cte_chained": (
        "WITH by_cust AS (SELECT cust, sum(amount) AS total FROM orders "
        "GROUP BY cust), big AS (SELECT cust, total FROM by_cust "
        "WHERE total > 2000) SELECT b.cust, b.total FROM big b "
        "ORDER BY b.cust", True),
    "cte_twice": (
        "WITH t AS (SELECT cust, sum(amount) AS s FROM orders "
        "GROUP BY cust) SELECT a.cust, a.s, b.s AS s2 FROM t a JOIN t b "
        "ON a.cust = b.cust ORDER BY a.cust", True),
    "cte_in_predicate": (
        "WITH rich AS (SELECT cust FROM orders GROUP BY cust "
        "HAVING sum(amount) > 2500) SELECT count(*) AS n FROM orders "
        "WHERE cust IN (SELECT cust FROM rich)", True),
    "distinct_qualified_order": (
        "SELECT DISTINCT cust FROM orders o ORDER BY o.cust", True),
    "join_equi_and_residual": (
        "SELECT o.o_id, c.name FROM orders o JOIN customers c "
        "ON o.cust = c.c_id AND o.amount > c.c_id * 30 ORDER BY o.o_id",
        True),
}


def _same(got, want, ordered):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    if not ordered:
        cols = list(got.columns)
        got = got.sort_values(cols, ignore_index=True, na_position="last")
        want = want.sort_values(cols, ignore_index=True,
                                na_position="last")
    for c in got.columns:
        if got[c].dtype.kind == "f":
            np.testing.assert_allclose(got[c].to_numpy(), want[c].to_numpy(),
                                       rtol=RTOL, atol=0, equal_nan=True)
        else:
            pd.testing.assert_series_equal(got[c], want[c])


@pytest.mark.parametrize("conf", ["default", "hash"])
@pytest.mark.parametrize("case", list(CASES))
def test_statement_matches_jax(case, conf, sessions):
    text, ordered = CASES[case]
    want = sessions["jax"].sql(text).to_pandas()
    got = sessions[conf].sql(text).to_pandas()
    _same(got, want, ordered)


@pytest.mark.parametrize("conf", ["default", "hash"])
def test_cross_join_against_pandas(conf, sessions):
    """SQL CROSS JOIN: the JAX package's resolver passes ``on=None`` to
    its own ``join``, which fails to build a null literal, so the oracle
    here is pandas."""
    got = sessions[conf].sql(
        "SELECT c.c_id, k.k FROM customers c CROSS JOIN na_a k "
        "WHERE c.c_id > k.k * 5 ORDER BY c.c_id, k.k").to_pandas()
    want = [(c, k) for c in range(12) for k in (1.0, 2.0) if c > k * 5]
    assert list(got.columns) == ["c_id", "k"]
    assert list(zip(got.c_id.tolist(), got.k.tolist())) == want


def test_views_and_columns(sessions):
    s = sessions["default"]
    df = s.sql("SELECT cust, amount FROM orders")
    assert df.columns == ["cust", "amount"]
    assert [dt.name for _, dt in df.schema] == ["bigint", "double"]
    df.createOrReplaceTempView("Pairs")
    assert s.table("pairs").columns == ["cust", "amount"]
    with pytest.raises(KeyError, match="unknown table or view"):
        s.table("nope")
    assert s.range(3).collect() == [(0,), (1,), (2,)]
    assert s.range(2, 11, 4).collect() == [(2,), (6,), (10,)]


@pytest.mark.parametrize("text, missing", [
    ("SELECT upper(name) FROM customers", "upper"),
    ("SELECT c_id, sqrt(region) FROM customers", "sqrt"),
    ("SELECT stddev(amount) FROM orders", "stddev"),
    ("SELECT cust, first(amount) FROM orders GROUP BY cust", "first"),
    ("SELECT CAST(amount AS decimal(7,2)) FROM orders", "decimal"),
    ("SELECT CAST(o_id AS string) FROM orders", "string"),
    ("SELECT md5(note) FROM orders", "Md5"),
    ("SELECT size(note) FROM orders", "size"),
    ("SELECT o_id, ntile(4) OVER (ORDER BY o_id) FROM orders", "ntile"),
    ("SELECT o_id, min(note) OVER (PARTITION BY cust) FROM orders",
     "string"),
])
def test_unported_construct_raises_with_its_name(text, missing, sessions):
    """A construct outside the port raises NotImplementedError naming
    it, whether it is caught while lowering the SQL or when the CPU
    fallback meets a node it has no branch for (a window).  ``md5`` is
    tagged by name and runs in the CPU fallback, with the JAX package's
    answer.  The numeric functions, the variance family, ``first``,
    decimal casts, the string functions and casts to strings have since
    been ported: they run on the device, with the JAX package's answer.
    ``size`` is ported with the nested types: over a string it is
    Spark's type mismatch, a ``TypeError`` naming it (the JAX package
    answers the string's byte length)."""
    s = sessions["default"]
    if text in TYPE_ERRORS:
        with pytest.raises(TypeError, match="Size"):
            s.sql(text).collect()
        return
    if text in PORTED_ANSWERS:
        df = s.sql(text)
        assert "CpuFallbackExec" not in df.explain()
        _same(df.to_pandas(), sessions["jax"].sql(text).to_pandas(), True)
        return
    if text in FALLBACK_ANSWERS:
        df = s.sql(text)
        assert "CpuFallbackExec[Project]" in df.explain()
        assert missing in s.overrides.last_explain
        _same(df.to_pandas(), sessions["jax"].sql(text).to_pandas(), True)
        return
    with pytest.raises(NotImplementedError, match=missing):
        s.sql(text).collect()


# the cases above that are a type mismatch since the function is ported
TYPE_ERRORS = {"SELECT size(note) FROM orders"}
# the cases above that the CPU fallback answers
FALLBACK_ANSWERS = {"SELECT md5(note) FROM orders"}
# the cases above that the device now answers
PORTED_ANSWERS = {"SELECT c_id, sqrt(region) FROM customers",
                  "SELECT stddev(amount) FROM orders",
                  "SELECT cust, first(amount) FROM orders GROUP BY cust",
                  "SELECT CAST(amount AS decimal(7,2)) FROM orders",
                  "SELECT upper(name) FROM customers",
                  "SELECT CAST(o_id AS string) FROM orders"}


def test_unknown_function_is_not_a_port_gap(sessions):
    with pytest.raises(ValueError, match="unknown SQL function"):
        sessions["default"].sql("SELECT no_such_fn(c_id) FROM customers")
