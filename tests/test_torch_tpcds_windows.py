"""The 11 TPC-DS queries that plan through Expand (rollup: q27, q36,
q67), Window (q44, q47, q53, q63, q67, q89, q98) or Range (the FROM-less
SELECT of scalar subqueries: q61, q88), through the PyTorch port's
``session.sql`` against the JAX package, on the CPU at ``sf=0.01``.

Each JAX answer is computed once per query (default conf) and held
against the port under its default conf and with the hash path on.
Keys, strings, dates, counts and row order must be equal; float columns
within a relative 1e-12.

One exception, q47, where the JAX package is at fault: it differences
prefix sums taken over the whole sorted input, so its windowed
``avg_monthly_sales`` carries a cancellation error (8.4e-14 relative at
this scale) and two rows whose ORDER BY keys ``sum_sales -
avg_monthly_sales`` are equal in exact arithmetic (-33.61, then
``s_store_name``) come out swapped.  The port's prefix sums restart at
each partition.  So q47's rows and values are held against the JAX
package as a set (same 100 rows, floats within 1e-12), and the port's
row order against the ORDER BY keys with the float key rounded to 1e-9
(the inputs are cents; averages of at most 14 of them).
"""

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.models import tpcds as jax_tpcds
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.models import tpcds

SF = 0.01
RTOL = 1e-12
CONFS = {
    "default": {},
    "hash": {"spark.rapids.tpu.pallas.hash.enabled": True,
             "spark.rapids.tpu.pallas.hash.tableSlots": 1 << 14},
}
QUERIES = ["q27", "q36", "q67", "q44", "q47", "q53", "q63", "q89", "q98",
           "q61", "q88"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the host: one torch thread here."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_answers():
    """Query name -> the JAX package's answer, computed on first use."""
    cache = {}
    session = JaxSession({})
    jax_tpcds.load(session, jax_tpcds.gen_tables(sf=SF))

    def get(name):
        if name not in cache:
            cache[name] = session.sql(jax_tpcds.QUERIES[name]).to_pandas()
        return cache[name]
    yield get
    session.stop()


@pytest.fixture(scope="module")
def port_sessions():
    data = tpcds.gen_tables(sf=SF)
    out = {}
    for conf, settings in CONFS.items():
        s = TpuSession(settings, device="cpu")
        tpcds.load(s, data)
        out[conf] = s
    return out


def assert_frames(got, want, rtol=RTOL):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in got.columns:
        if got[c].dtype.kind == "f":
            np.testing.assert_allclose(got[c].to_numpy(), want[c].to_numpy(),
                                       rtol=rtol, atol=0, equal_nan=True)
        else:
            pd.testing.assert_series_equal(got[c], want[c])


Q47_KEYS = ["i_category", "i_brand", "s_store_name", "d_year", "d_moy"]


def check_q47(got, want):
    """The same rows and values as the JAX package; the port's order is
    the ORDER BY's (sum_sales - avg_monthly_sales, s_store_name, d_moy)
    with the float key rounded to 1e-9."""
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want) == 100
    assert_frames(got.sort_values(Q47_KEYS, ignore_index=True),
                  want.sort_values(Q47_KEYS, ignore_index=True))
    key = list(zip(np.round(got.sum_sales - got.avg_monthly_sales, 9),
                   got.s_store_name, got.d_moy))
    assert key == sorted(key)


def test_window_queries_are_in_the_suite():
    assert set(QUERIES) <= set(tpcds.QUERIES)
    assert tpcds.QUERIES == jax_tpcds.QUERIES


@pytest.mark.parametrize("conf", list(CONFS))
@pytest.mark.parametrize("name", QUERIES)
def test_query_matches_jax(name, conf, port_sessions, jax_answers):
    got = port_sessions[conf].sql(tpcds.QUERIES[name]).to_pandas()
    if name == "q47":
        check_q47(got, jax_answers(name))
    else:
        assert_frames(got, jax_answers(name))


def test_plans_reach_expand_window_and_range(port_sessions):
    """The queries of this file plan the new operators (and none of
    them hides a CPU step: the port has none)."""
    s = port_sessions["default"]
    plans = {q: s.sql(tpcds.QUERIES[q]).explain() for q in QUERIES}
    for q in ("q27", "q36", "q67"):
        assert "TpuExpandExec" in plans[q], q
    for q in ("q44", "q47", "q53", "q63", "q67", "q89", "q98"):
        assert "TpuWindowExec" in plans[q], q
    for q in ("q61", "q88"):
        assert "TpuRangeExec" in plans[q], q
