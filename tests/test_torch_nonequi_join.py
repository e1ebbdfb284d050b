"""Joins on expression conditions in the PyTorch port, with the CPU
fallback for a residual on an outer join, against the JAX package and
pandas, on the CPU.

The cases of ``tests/test_nonequi_join.py``: equi keys plus a residual
(the device join under a filter), a pure non-equi inner join (the cross
product under a filter), an equi-only expression condition, a residual on
a left join (the join falls back; a matched row that fails the residual
is null-extended, not dropped), a left join on a non-equality alone (the
cross product under the residual, null-extended) and duplicate column
names (rejected).
Then the official text of TPC-H q13 at SF0.1 as SQL (``customer LEFT
OUTER JOIN orders ON c_custkey = o_custkey AND NOT o_comment LIKE
'%special%requests%'``): its join runs in the fallback, both group-bys
and the sort on the device, and its answer equals the rewritten q13's
(the residual pushed into orders as a filter) and the JAX package's.

Keys, counts and order exactly; floats within a relative 1e-12.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.models import tpch as jax_tpch
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.models import tpch

RTOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def session():
    return TpuSession({}, device="cpu")


def _pdf_l(rng, n=200):
    return pd.DataFrame({"lk": rng.integers(0, 20, n),
                         "lv": rng.normal(size=n) * 10})


def _pdf_r(rng, n=60):
    return pd.DataFrame({"rk": rng.integers(0, 20, n),
                         "rv": rng.normal(size=n) * 10})


def test_equi_plus_residual(session):
    rng = np.random.default_rng(0)
    lp, rp = _pdf_l(rng), _pdf_r(rng)
    q = session.create_dataframe(lp).join(
        session.create_dataframe(rp),
        (F.col("lk") == F.col("rk")) & (F.col("lv") > F.col("rv")))
    tree = session.plan(q.plan).tree_string()
    assert "TpuHashJoinExec" in tree and "CpuFallbackExec" not in tree
    got = q.to_pandas().sort_values(["lk", "lv", "rv"]).reset_index(
        drop=True)
    want = lp.merge(rp, left_on="lk", right_on="rk")
    want = want[want.lv > want.rv].sort_values(
        ["lk", "lv", "rv"]).reset_index(drop=True)
    assert len(got) == len(want) > 0
    np.testing.assert_allclose(got["lv"], want["lv"], rtol=RTOL)
    np.testing.assert_allclose(got["rv"], want["rv"], rtol=RTOL)


def test_pure_nonequi_inner(session):
    rng = np.random.default_rng(1)
    lp, rp = _pdf_l(rng, 50), _pdf_r(rng, 20)
    q = session.create_dataframe(lp).join(session.create_dataframe(rp),
                                           F.col("lv") < F.col("rv"))
    got = q.to_pandas()
    want = lp.merge(rp, how="cross")
    want = want[want.lv < want.rv]
    assert len(got) == len(want) > 0
    np.testing.assert_allclose(sorted(got["lv"] + got["rv"]),
                               sorted(want["lv"] + want["rv"]), rtol=RTOL)


def test_equi_only_expression_condition(session):
    """A pure equi expression condition behaves like on=names."""
    rng = np.random.default_rng(2)
    lp, rp = _pdf_l(rng, 80), _pdf_r(rng, 40)
    got = session.create_dataframe(lp).join(
        session.create_dataframe(rp), F.col("lk") == F.col("rk")).to_pandas()
    assert len(got) == len(lp.merge(rp, left_on="lk", right_on="rk"))


def test_residual_outer_join_falls_back(session):
    l = session.create_dataframe({"lk": [1], "lv": [1.0]})
    r = session.create_dataframe({"rk": [1], "rv": [2.0]})
    q = l.join(r, (F.col("lk") == F.col("rk")) &
               (F.col("lv") > F.col("rv")), how="left")
    tree = session.plan(q.plan).tree_string()
    assert tree.splitlines()[0] == "CpuFallbackExec[Join]"
    assert "residual semantics need the nested-loop join" in \
        session.overrides.last_explain


def test_duplicate_names_rejected(session):
    l = session.create_dataframe({"k": [1], "v": [1.0]})
    r = session.create_dataframe({"k": [1], "w": [2.0]})
    with pytest.raises(ValueError, match="distinct column names"):
        l.join(r, F.col("v") > F.col("w"))


def test_residual_left_join_fallback_semantics(session):
    """Left join with a residual: matched-but-failing rows null-extend,
    as in the JAX package's fallback."""
    lp = {"lk": [1, 2, 3, None], "lv": [1.0, 9.0, 5.0, 4.0]}
    rp = {"rk": [1, 2, 2], "rv": [2.0, 3.0, 10.0]}
    q = session.create_dataframe(lp).join(
        session.create_dataframe(rp),
        (F.col("lk") == F.col("rk")) & (F.col("lv") > F.col("rv")),
        how="left")
    got = q.to_pandas().sort_values(["lk", "rv"]).reset_index(drop=True)
    # lk=1: matched rk=1 but 1.0 > 2.0 fails -> null-extended; lk=2:
    # 9.0 > 3.0 matches and 9.0 > 10.0 does not; lk=3 and the null key
    # match nothing
    assert len(got) == 4
    assert [None if pd.isna(v) else v for v in got["rv"]] == \
        [None, 3.0, None, None]
    from spark_rapids_tpu.api import functions as JF
    j = JaxSession({})
    want = j.create_dataframe(lp).join(
        j.create_dataframe(rp),
        (JF.col("lk") == JF.col("rk")) & (JF.col("lv") > JF.col("rv")),
        how="left").to_pandas().sort_values(["lk", "rv"]).reset_index(
            drop=True)
    j.stop()
    pd.testing.assert_frame_equal(got, want, check_dtype=False)


def test_pure_nonequi_left_join(session):
    """A left join whose only condition is a non-equality: no key, so
    every pair is tried (the JAX fallback's cross merge), the residual
    keeps the matches and each left row without one is null-extended."""
    rng = np.random.default_rng(3)
    lp = {"lk": [int(v) for v in rng.integers(0, 20, 30)] + [None],
          "lv": [float(v) for v in rng.normal(size=31) * 10]}
    lp["lv"][5] = None
    rp = {"rk": [int(v) for v in rng.integers(0, 20, 12)],
          "rv": [float(v) for v in rng.normal(size=12) * 10]}
    q = session.create_dataframe(lp).join(
        session.create_dataframe(rp), F.col("lv") > F.col("rv") + 5.0,
        how="left")
    tree = session.plan(q.plan).tree_string()
    assert tree.splitlines()[0] == "CpuFallbackExec[Join]"
    by = ["lv", "rv", "lk", "rk"]
    got = q.to_pandas().sort_values(by).reset_index(drop=True)
    from spark_rapids_tpu.api import functions as JF
    j = JaxSession({})
    try:
        want = j.create_dataframe(lp).join(
            j.create_dataframe(rp), JF.col("lv") > JF.col("rv") + 5.0,
            how="left").to_pandas().sort_values(by).reset_index(drop=True)
    finally:
        j.stop()
    # every left row at least once; the null lv matches nothing
    assert len(got) == len(want) > 31
    assert got["rv"].isna().sum() >= 1
    pd.testing.assert_frame_equal(got, want, check_dtype=False, rtol=RTOL)


# ------------------------------------------------------ official q13 --

Q13_OFFICIAL = """
SELECT c_count, count(*) AS custdist
FROM (
  SELECT c_custkey, count(o_orderkey) AS c_count
  FROM customer LEFT OUTER JOIN orders
    ON c_custkey = o_custkey AND NOT o_comment LIKE '%special%requests%'
  GROUP BY c_custkey
) c_orders
GROUP BY c_count
ORDER BY custdist DESC, c_count DESC
"""


def test_official_q13_matches_rewritten_and_jax():
    tables = tpch.gen_tables(sf=0.1)
    small = {k: tables[k] for k in ("customer", "orders")}
    s = TpuSession({}, device="cpu")
    for name, frame in tpch.load(s, small).items():
        frame.createOrReplaceTempView(name)
    df = s.sql(Q13_OFFICIAL)
    plan = df.explain().split("== Logical Plan ==")[0]
    assert plan.count("CpuFallbackExec") == 1
    assert "CpuFallbackExec[Join]" in plan
    assert plan.splitlines()[0].startswith("TpuSortExec")
    assert plan.count("TpuHashAggregateExec") == 2
    got = df.to_pandas()
    rewritten = tpch.q13(tpch.load(s, small)).to_pandas()
    pd.testing.assert_frame_equal(got, rewritten)
    j = JaxSession({})
    try:
        for name, frame in jax_tpch.load(j, small).items():
            frame.createOrReplaceTempView(name)
        want = j.sql(Q13_OFFICIAL).to_pandas()
    finally:
        j.stop()
    assert got["c_count"].tolist() == want["c_count"].tolist()
    assert got["custdist"].tolist() == want["custdist"].tolist()
    assert got["custdist"].sum() == len(small["customer"])
