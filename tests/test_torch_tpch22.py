"""All 22 TPC-H queries of the PyTorch port against the JAX package's
answers, on the CPU at ``sf=0.002``.

Each query's JAX answer is computed once (default conf) and held against
the port under its default conf and with the hash path on.  Keys,
strings, dates, counts and row order must be equal; float columns within
a relative 1e-12 (the port sums in another order).  No query needs a
looser bound at this scale.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.models import tpch as jax_tpch
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.models import tpch

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
    """Query name -> the JAX package's answer, computed on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            s = JaxSession({})
            try:
                cache[name] = jax_tpch.QUERIES[name](
                    jax_tpch.load(s, tables)).to_pandas()
            finally:
                s.stop()
        return cache[name]
    return get


def test_port_has_the_22_queries():
    assert list(tpch.QUERIES) == list(jax_tpch.QUERIES)
    assert len(tpch.QUERIES) == 22


@pytest.mark.parametrize("conf", list(CONFS))
@pytest.mark.parametrize("name", list(jax_tpch.QUERIES))
def test_query_matches_jax(name, conf, tables, jax_answers):
    want = jax_answers(name)
    got = tpch.QUERIES[name](tpch.load(
        TpuSession(CONFS[conf], device="cpu"), tables)).to_pandas()
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in got.columns:
        if got[c].dtype.kind == "f":
            np.testing.assert_allclose(got[c].to_numpy(), want[c].to_numpy(),
                                       rtol=RTOL, atol=0, equal_nan=True)
        else:
            pd.testing.assert_series_equal(got[c], want[c])
