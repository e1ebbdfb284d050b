"""The 22 TPC-H queries as SQL text through the PyTorch port's
``session.sql``, against the JAX package's ``session.sql`` on the same
text and tables, and against the port's own DataFrame form of each query,
on the CPU at ``sf=0.002``.

Each JAX answer is computed once per query (default conf) and held
against the port under its default conf and with the hash path on.
Keys, strings, dates, counts and row order must be equal; float columns
within a relative 1e-12 (the port sums in another order).  Against the
DataFrame form (``tpch_sql.dataframe_form`` maps q3's and q10's column
order and derives q14's ratio from its two sums) the same rules hold,
with 1e-12 on the floats.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.models import tpch as jax_tpch
from spark_rapids_tpu.models import tpch_sql as jax_tpch_sql
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.models import tpch, tpch_sql

SF = 0.002
RTOL = 1e-12
CONFS = {
    "default": {},
    "hash": {"spark.rapids.tpu.pallas.hash.enabled": True,
             "spark.rapids.tpu.pallas.hash.tableSlots": 1 << 14},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the host: one torch thread here."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tables():
    return jax_tpch.gen_tables(sf=SF)


@pytest.fixture(scope="module")
def jax_answers(tables):
    """Query name -> the JAX package's SQL answer, computed on first use."""
    cache = {}
    session = JaxSession({})
    jax_tpch_sql.register(session, jax_tpch.load(session, tables))

    def get(name):
        if name not in cache:
            cache[name] = session.sql(
                jax_tpch_sql.QUERIES[name]).to_pandas()
        return cache[name]
    yield get
    session.stop()


@pytest.fixture(scope="module")
def port_sessions(tables):
    """conf name -> (session with the views registered, its tables)."""
    out = {}
    for conf, settings in CONFS.items():
        s = TpuSession(settings, device="cpu")
        t = tpch.load(s, tables)
        tpch_sql.register(s, t)
        out[conf] = (s, t)
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


def test_port_has_the_22_sql_queries():
    assert tpch_sql.QUERIES == jax_tpch_sql.QUERIES
    assert tpch_sql.TABLES == jax_tpch_sql.TABLES
    assert len(tpch_sql.QUERIES) == 22


@pytest.mark.parametrize("conf", list(CONFS))
@pytest.mark.parametrize("name", list(jax_tpch_sql.QUERIES))
def test_sql_query_matches_jax(name, conf, port_sessions, jax_answers):
    session, _ = port_sessions[conf]
    got = session.sql(tpch_sql.QUERIES[name]).to_pandas()
    assert_frames(got, jax_answers(name))


@pytest.mark.parametrize("name", list(tpch_sql.QUERIES))
def test_sql_query_equals_dataframe_form(name, port_sessions):
    session, t = port_sessions["hash"]
    got = session.sql(tpch_sql.QUERIES[name]).to_pandas()
    want = tpch_sql.dataframe_form(
        name, tpch.QUERIES[name](t).to_pandas())
    assert_frames(got.reset_index(drop=True), want.reset_index(drop=True))
