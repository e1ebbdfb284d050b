"""TPC-DS through the PyTorch port's ``session.sql`` against the JAX
package, on the CPU at ``sf=0.01``: the port's generator against the
JAX package's, and the 18 queries of the suite that plan without Expand,
Window or Range (``test_torch_tpcds_windows.py`` holds the other 11, so
that ``--dist loadfile`` spreads the JAX answers over two workers).

Each JAX answer is computed once per query (default conf) and held
against the port under its default conf and with the hash path on.
Keys, strings, dates, counts and row order must be equal; float columns
within a relative 1e-12 (the port sums in another order).
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
# planned through Expand, Window or Range: test_torch_tpcds_windows.py
WINDOWED = ("q27", "q36", "q67", "q44", "q47", "q53", "q63", "q89", "q98",
            "q61", "q88")
QUERIES = [q for q in jax_tpcds.QUERIES if q not in WINDOWED]


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
    """conf name -> a session over the port's own generated tables."""
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


def test_port_has_the_29_queries():
    assert tpcds.QUERIES == jax_tpcds.QUERIES
    assert len(tpcds.QUERIES) == 29
    assert len(QUERIES) == 18


@pytest.mark.parametrize("sf", [0.01, 0.05])
def test_gen_tables_equal_jax(sf):
    """Every table and column value for value, and the same column types
    once each package has put the tables in a session."""
    got, want = tpcds.gen_tables(sf=sf), jax_tpcds.gen_tables(sf=sf)
    assert list(got) == list(want)
    for name in want:
        pd.testing.assert_frame_equal(got[name], want[name])
    if sf != 0.01:
        return
    port = TpuSession({}, device="cpu")
    jax = JaxSession({})
    try:
        pt, jt = tpcds.load(port, got), jax_tpcds.load(jax, want)
        for name in want:
            assert [(n, dt.name) for n, dt in pt[name].schema] == \
                [(n, dt.name) for n, dt in jt[name].schema], name
        assert dict(pt["date_dim"].schema)["d_date"].name == "timestamp"
    finally:
        jax.stop()


@pytest.mark.parametrize("conf", list(CONFS))
@pytest.mark.parametrize("name", QUERIES)
def test_query_matches_jax(name, conf, port_sessions, jax_answers):
    got = port_sessions[conf].sql(tpcds.QUERIES[name]).to_pandas()
    assert_frames(got, jax_answers(name))
