"""Joins on expression conditions in the PyTorch port, against the JAX
package, on the CPU.

A condition's equi conjuncts (a left expression == a right expression)
become the hash/sort-merge join keys and the rest a residual: an inner
join with keys and a residual is the equi join then a filter, a pure
residual is the cross product then a filter, and a list of conditions is
their AND.  The two sides must have distinct column names; a residual on
a join that is not inner raises ``NotImplementedError`` with the reason
(the JAX package sends it to its CPU fallback, which the port lacks).
Keys, strings, counts and row order exactly; floats within a relative
1e-12.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.api.session import TpuSession

RTOL = 1e-12
CONFS = {"default": {},
         "hash": {"spark.rapids.tpu.pallas.hash.enabled": True,
                  "spark.rapids.tpu.pallas.hash.tableSlots": 1 << 12},
         "small_batches": {"spark.rapids.sql.tpu.maxBatchRows": 37}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _data():
    rng = np.random.default_rng(11)
    n, m = 300, 40
    lk = rng.integers(0, 50, n).tolist()
    for i in rng.choice(n, 15, replace=False):
        lk[i] = None
    left = {"l_id": np.arange(n, dtype=np.int64), "lk": lk,
            "l2": rng.integers(0, 4, n),
            "lv": rng.uniform(0, 100, n).round(3),
            "ls": [f"w{i % 9}" for i in range(n)]}
    right = {"r_id": np.arange(m, dtype=np.int64),
             "rk": rng.integers(0, 50, m),
             "r2": rng.integers(0, 4, m),
             "rv": rng.uniform(0, 100, m).round(3),
             "rs": [f"w{i % 5}" for i in range(m)]}
    return left, right


def _frames(session_cls, conf, device_kw):
    left, right = _data()
    s = session_cls(conf, **device_kw)
    return s, s.create_dataframe(left), s.create_dataframe(right)


# name -> make(F, left, right) -> DataFrame
CASES = {
    "equi_and_residual": lambda F, l, r: l.join(
        r, on=(F.col("lk") == F.col("rk")) & (F.col("lv") > F.col("rv")),
        how="inner"),
    "two_keys_reversed_sides": lambda F, l, r: l.join(
        r, on=(F.col("rk") == F.col("lk")) & (F.col("l2") == F.col("r2"))),
    "condition_list": lambda F, l, r: l.join(
        r, on=[F.col("lk") == F.col("rk"), F.col("l2") != F.col("r2"),
               F.col("lv") + F.col("rv") > 80.0]),
    "string_key_and_residual": lambda F, l, r: l.join(
        r, on=(F.col("ls") == F.col("rs")) & (F.col("l2") < F.col("r2"))),
    "expression_key": lambda F, l, r: l.join(
        r, on=(F.col("lk") + 1) == F.col("rk")),
    "left_equi_only": lambda F, l, r: l.join(
        r, on=F.col("lk") == F.col("rk"), how="left"),
    "semi_equi_only": lambda F, l, r: l.join(
        r, on=F.col("lk") == F.col("rk"), how="semi"),
    "anti_equi_only": lambda F, l, r: l.join(
        r, on=F.col("lk") == F.col("rk"), how="anti"),
}


@pytest.fixture(scope="module")
def jax_answers():
    cache = {}

    def get(name):
        if name not in cache:
            s, l, r = _frames(JaxSession, {}, {})
            try:
                df = CASES[name](JF, l, r)
                cache[name] = df.orderBy(*df.columns).to_pandas()
            finally:
                s.stop()
        return cache[name]
    return get


@pytest.mark.parametrize("conf", list(CONFS))
@pytest.mark.parametrize("name", list(CASES))
def test_expression_join_matches_jax(name, conf, jax_answers):
    _, l, r = _frames(TpuSession, CONFS[conf], {"device": "cpu"})
    df = CASES[name](TF, l, r)
    got = df.orderBy(*df.columns).to_pandas()
    want = jax_answers(name)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want) > 0
    for c in got.columns:
        if got[c].dtype.kind == "f":
            np.testing.assert_allclose(got[c].to_numpy(), want[c].to_numpy(),
                                       rtol=RTOL, atol=0, equal_nan=True)
        else:
            pd.testing.assert_series_equal(got[c], want[c])


@pytest.mark.parametrize("conf", list(CONFS))
def test_pure_residual_against_pandas(conf):
    """A pure residual: the cross product under a filter.  The oracle is
    pandas: the JAX package's cross join returns wrong string values on
    the CPU (the right side's chars gathered by the left's offsets)."""
    _, l, r = _frames(TpuSession, CONFS[conf], {"device": "cpu"})
    df = l.join(r, on=TF.col("lv") < TF.col("rv") - 95.0)
    got = df.orderBy(*df.columns).to_pandas()
    left, right = (pd.DataFrame(d) for d in _data())
    want = left.merge(right, how="cross")
    want = want[want.lv < want.rv - 95.0].sort_values(
        list(want.columns), ignore_index=True)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want) > 0
    for c in got.columns:
        assert got[c].tolist() == want[c].tolist(), c


def test_plan_shapes():
    """Keys plus a residual: the join under a filter; a pure residual:
    a cross join under a filter; keys only: the join alone."""
    _, l, r = _frames(TpuSession, {}, {"device": "cpu"})
    F = TF
    mixed = l.join(r, on=(F.col("lk") == F.col("rk"))
                   & (F.col("lv") > F.col("rv"))).explain()
    assert mixed.splitlines()[0].startswith("TpuFilterExec")
    assert "TpuHashJoinExec[inner, ['lk']]" in mixed
    pure = l.join(r, on=F.col("lv") > F.col("rv")).explain()
    assert pure.splitlines()[0].startswith("TpuFilterExec")
    assert "TpuHashJoinExec[cross" in pure
    keys = l.join(r, on=F.col("lk") == F.col("rk")).explain()
    assert keys.splitlines()[0].startswith("TpuHashJoinExec[inner")


def test_duplicate_names_raise():
    _, l, r = _frames(TpuSession, {}, {"device": "cpu"})
    r2 = r.withColumnRenamed("rv", "lv")
    with pytest.raises(ValueError, match=r"distinct column names.*'lv'"):
        l.join(r2, on=TF.col("lk") == TF.col("rk"))


@pytest.mark.parametrize("how", ["left", "right", "full", "semi", "anti"])
def test_non_inner_residual_raises_with_reason(how):
    _, l, r = _frames(TpuSession, {}, {"device": "cpu"})
    df = l.join(r, on=(TF.col("lk") == TF.col("rk"))
                & (TF.col("lv") > TF.col("rv")), how=how)
    with pytest.raises(NotImplementedError,
                       match=f"residual.*{how} join.*nested-loop"):
        df.collect()
