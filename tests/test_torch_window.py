"""Window functions in the PyTorch port (``ops/window.py`` through
``exec/window.py``), against the JAX package, on the CPU.

Every function over ROWS frames (unbounded, running, sliding, following)
and RANGE frames (running with ties, whole partition): row_number, rank,
dense_rank, percent_rank, lead/lag (with and without a default), and the
windowed sum, count, avg, min and max; ties in the order keys, null
partition and order keys, string partition keys, several specs in one
select, a window nested in arithmetic, batches of a few rows, and an
empty input.  Outputs are ordered by a unique id; every column must be
equal, floats within a relative 1e-12.  The values are quarters (exact
in binary), so every frame sum is exact in both engines whatever the
summation order: the JAX package differences prefix sums over the whole
input, which is not exact in general (see q47 in
``test_torch_tpcds_windows.py``).

Outside the ported set (the JAX package's CPU fallback) a window raises
``NotImplementedError`` naming what is missing.
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
         "small_batches": {"spark.rapids.sql.tpu.maxBatchRows": 29},
         "hash": {"spark.rapids.tpu.pallas.hash.enabled": True,
                  "spark.rapids.tpu.pallas.hash.tableSlots": 1 << 12}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _data(n=300):
    rng = np.random.default_rng(21)
    p = rng.integers(0, 6, n).tolist()
    o = rng.integers(0, 25, n).tolist()        # ties within partitions
    v = (rng.integers(-400, 400, n) / 4.0).tolist()
    iv = rng.integers(-1000, 1000, n).tolist()
    for col, k in ((p, 12), (o, 15), (v, 20), (iv, 20)):
        for i in rng.choice(n, k, replace=False):
            col[i] = None
    words = ["north", "south", "east", "wést", ""]
    ps = [None if rng.random() < 0.05 else words[i]
          for i in rng.integers(0, len(words), n)]
    return {"id": np.arange(n, dtype=np.int64), "p": p, "ps": ps, "o": o,
            "v": v, "iv": iv}


def _frames(F):
    W = F.Window
    by = W.partitionBy("p").orderBy("o")
    return {
        "rows_whole": by.rowsBetween(None, None),
        "rows_running": by.rowsBetween(None, 0),
        "rows_sliding": by.rowsBetween(-2, 1),
        "rows_following": by.rowsBetween(1, 3),
        "rows_to_end": by.rowsBetween(0, None),
        "range_running": by,
        "range_whole": W.partitionBy("p"),
        "range_running_desc": W.partitionBy("ps").orderBy(
            F.col("o").desc(), "id"),
    }


def _aggs(F, win, minmax):
    out = [F.window_sum("v").over(win).alias("sv"),
           F.window_sum("iv").over(win).alias("si"),
           F.window_count("v").over(win).alias("cv"),
           F.window_count().over(win).alias("cn"),
           F.window_avg("v").over(win).alias("av")]
    if minmax:
        out += [F.window_min("v").over(win).alias("mn"),
                F.window_max("iv").over(win).alias("mx")]
    return out


# name -> make(F, df) -> DataFrame (ordered by id last)
CASES = {}
for _frame in ("rows_whole", "rows_running", "rows_sliding",
               "rows_following", "rows_to_end", "range_running",
               "range_whole", "range_running_desc"):
    CASES[f"aggs_{_frame}"] = (
        lambda F, df, fr=_frame: df.select(
            "id", *_aggs(F, _frames(F)[fr],
                         fr in ("rows_whole", "rows_running",
                                "range_running", "range_whole",
                                "range_running_desc"))))
CASES.update({
    "ranking": lambda F, df: df.select(
        "id", *[getattr(F, k)().over(
            F.Window.partitionBy("p").orderBy("o")).alias(k)
            for k in ("row_number", "rank", "dense_rank", "percent_rank")]),
    "ranking_string_partition_desc_nulls_last": lambda F, df: df.select(
        "id", *[getattr(F, k)().over(
            F.Window.partitionBy("ps").orderBy(
                F.col("o").desc_nulls_last(), F.col("v").asc())).alias(k)
            for k in ("row_number", "rank", "dense_rank", "percent_rank")]),
    "row_number_no_partition": lambda F, df: df.select(
        "id", F.row_number().over(
            F.Window.partitionBy().orderBy("o", "id")).alias("rn"),
        F.window_sum("iv").over(F.Window.partitionBy()).alias("total")),
    "lead_lag": lambda F, df: df.select(
        "id",
        F.lead("v").over(F.Window.partitionBy("p").orderBy("o", "id"))
        .alias("ld"),
        F.lag("iv", 2).over(F.Window.partitionBy("p").orderBy("o", "id"))
        .alias("lg"),
        F.lag("v", 1, 0.0).over(F.Window.partitionBy("ps").orderBy("id"))
        .alias("lgd")),
    "several_specs_and_nesting": lambda F, df: df.select(
        "id", "p",
        (F.col("v") * 100.0 / F.window_sum("v").over(
            F.Window.partitionBy("p"))).alias("pct"),
        F.rank().over(F.Window.partitionBy("ps").orderBy("o")).alias("r"),
        (F.window_max("o").over(F.Window.partitionBy("p")) -
         F.col("o")).alias("gap"),
        F.window_avg("v").over(F.Window.partitionBy("p").orderBy("o")
                               .rowsBetween(-1, 1)).alias("m3")),
})


def _query(F, session, name, filt=None):
    df = session.create_dataframe(_data())
    if filt is not None:
        df = df.filter(filt(F))
    return CASES[name](F, df).orderBy("id")


@pytest.fixture(scope="module")
def jax_answers():
    cache = {}

    def get(name):
        if name not in cache:
            s = JaxSession({})
            try:
                cache[name] = _query(JF, s, name).to_pandas()
            finally:
                s.stop()
        return cache[name]
    return get


def _same(got, want):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in got.columns:
        if got[c].dtype.kind == "f":
            np.testing.assert_allclose(got[c].to_numpy(), want[c].to_numpy(),
                                       rtol=RTOL, atol=0, equal_nan=True)
        else:
            pd.testing.assert_series_equal(got[c], want[c])


@pytest.mark.parametrize("conf", list(CONFS))
@pytest.mark.parametrize("name", list(CASES))
def test_window_matches_jax(name, conf, jax_answers):
    s = TpuSession(CONFS[conf], device="cpu")
    _same(_query(TF, s, name).to_pandas(), jax_answers(name))


def test_lead_of_a_string_against_python():
    """lead over a string column (the JAX package's lead gathers only
    fixed-width values, so the oracle is Python)."""
    s = TpuSession({"spark.rapids.sql.tpu.maxBatchRows": 29}, device="cpu")
    got = s.create_dataframe(_data()).select(
        "id", TF.lead("ps", 1).over(
            TF.Window.partitionBy("p").orderBy("id")).alias("nxt")
    ).orderBy("id").to_pandas()
    d = _data()
    want = {}
    for part in set(d["p"]):
        ids = [i for i in range(len(d["id"])) if d["p"][i] == part]
        for a, b in zip(ids, ids[1:] + [None]):
            want[a] = None if b is None else d["ps"][b]
    got_vals = [None if pd.isna(x) else x for x in got.nxt]
    assert got_vals == [want[i] for i in range(len(d["id"]))]


def test_empty_input():
    """A window over no rows: no rows, the window's columns typed."""
    for F, s in ((TF, TpuSession({}, device="cpu")), (JF, JaxSession({}))):
        df = _query(F, s, "ranking", filt=lambda F: F.col("id") < 0)
        got = df.to_pandas()
        assert len(got) == 0
        assert list(got.columns) == ["id", "row_number", "rank",
                                     "dense_rank", "percent_rank"]
    port = _query(TF, TpuSession({}, device="cpu"), "aggs_rows_sliding",
                  filt=lambda F: F.col("id") < 0)
    assert [dt.name for _, dt in port.schema] == [
        "bigint", "double", "bigint", "bigint", "bigint", "double"]


def test_window_plans_a_sort_under_it():
    s = TpuSession({}, device="cpu")
    plan = _query(TF, s, "several_specs_and_nesting").explain()
    # three specs (pct and gap share one), each over its sort, and the
    # final orderBy(id)
    assert plan.count("TpuWindowExec") == 3
    assert plan.count("TpuSortExec") == 4
    assert "TpuWindowExec[['__w0', '__w2'] over part=['p']]" in plan


@pytest.mark.parametrize("build, missing", [
    (lambda F, W: F.window_sum("v").over(
        W.partitionBy("p").orderBy("o").rangeBetween(-2, 2)),
     "range frames with value offsets"),
    (lambda F, W: F.window_min("v").over(
        W.partitionBy("p").orderBy("o").rowsBetween(-2, 1)),
     "min supports only running or whole-partition frames"),
    (lambda F, W: F.rank().over(W.partitionBy("p")),
     "rank requires an ORDER BY"),
    (lambda F, W: F.window_max("ps").over(W.partitionBy("p")),
     "max of a string"),
])
def test_unported_window_raises_with_its_name(build, missing):
    s = TpuSession({}, device="cpu")
    df = s.create_dataframe(_data()).select(
        "id", build(TF, TF.Window).alias("w"))
    with pytest.raises(NotImplementedError, match=missing):
        df.collect()
