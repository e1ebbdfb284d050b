"""Black-box Python UDFs, ``tpu_udf`` and the worker pool of the PyTorch
port, on the CPU, against the JAX package.

The port's ``TpuArrowEvalPythonExec`` (``udf/python_exec.py``) is held
against the JAX package's on the same seeded inputs: a UDF inside a larger
expression beside device columns, a string UDF with nulls, batches
streamed through a union, a result column whose name collides with the
internal ones; the fallback chain (a compiled UDF takes no Python node, a
UDF nested in another's arguments takes the CPU fallback, as in the JAX
planner); ``tpu_udf`` (a torch function, the JAX package's ``JaxUDF``)
with nulls.  Numbers must be equal exactly (both packages call the same
Python function on the same values); a double from a torch function
within a relative 1e-15 of the JAX one's (two libraries' ``sqrt``).  The
worker pool: one test with 2 spawned workers equal to inline evaluation
(the pool ran, and nothing degraded), and one whose function does not
pickle, which degrades to inline evaluation and is counted.
"""

import math

import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.models import udf as UD
from spark_rapids_tpu_torch.udf import worker_pool as WP

N = 3000


def fsum_plus_one(x):
    # math.fsum takes a list: the compilers decline it
    return math.fsum([x, 1.0, x * 0.5])


def shout(s):
    # a slice: the compilers decline it
    return s[::-1].upper() + "!!"


def mirror(x):
    return int(str(int(x))[::-1])


def digits(x):
    return len(str(int(x)))


def doubled(x):
    return int(str(int(x)) * 2)


def simple(x):
    return x * 2.0 + 1.0


def _data(n=64, seed=11):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 10, n).round(3)
    k = rng.integers(1, 999, n)
    s = [None if i % 7 == 3 else f"w{i % 5}é" for i in range(n)]
    xs = [None if i % 9 == 4 else float(v) for i, v in enumerate(x)]
    return {"x": xs, "k": k.astype(np.int64), "s": s}


def _both(build, data, conf=None):
    """(port DataFrame, port pandas, JAX pandas) of ``build(F, df)``."""
    ts = TpuSession(dict(conf or {}), device="cpu")
    tdf = build(TF, ts.create_dataframe(data))
    js = JaxSession()
    jdf = build(JF, js.create_dataframe(data))
    return tdf, tdf.to_pandas(), jdf.to_pandas()


def _nodes(df):
    return df.session.plan(df.plan).tree_string()


def test_arrow_eval_inside_larger_expression():
    def build(F, df):
        w = F.udf(fsum_plus_one, "double")
        return df.select("k", w("x").alias("w"),
                         (w("x") * 2 + F.col("k")).alias("v"),
                         (F.col("k") * 2).alias("k2"))
    tdf, got, want = _both(build, _data())
    tree = _nodes(tdf)
    assert tree.count("TpuArrowEvalPythonExec") == 1
    assert "CpuFallbackExec" not in tree
    pd.testing.assert_frame_equal(got, want, check_dtype=False)
    x = pd.Series(_data()["x"], dtype="float64")
    want_w = [None if pd.isna(v) else fsum_plus_one(v) for v in x]
    assert [None if pd.isna(v) else v for v in got["w"]] == want_w


def test_arrow_eval_string_udf_with_nulls():
    def build(F, df):
        return df.select(F.udf(shout, "string")("s").alias("r"))
    _, got, want = _both(build, _data())
    assert got["r"].tolist() == want["r"].tolist()
    assert got["r"][3] is None or pd.isna(got["r"][3])
    assert got["r"][0] == "É0W!!"


def test_arrow_eval_streams_batches():
    def build(F, df):
        u = df.union(df.filter(F.col("k") > 500))
        return u.select(F.udf(mirror, "bigint")("k").alias("r"), "k")
    _, got, want = _both(build, _data(), {
        "spark.rapids.sql.tpu.maxBatchRows": 16})
    pd.testing.assert_frame_equal(got, want, check_dtype=False)
    assert got["r"].tolist() == [mirror(k) for k in got["k"]]


def test_arrow_eval_result_name_collision():
    data = {"_udf0": np.array([5, 55, 555], dtype=np.int64)}

    def build(F, df):
        return df.select((F.udf(digits, "bigint")("_udf0") * 100)
                         .alias("d"), "_udf0")
    _, got, want = _both(build, data)
    assert got["d"].tolist() == [100, 200, 300] == want["d"].tolist()
    assert got["_udf0"].tolist() == [5, 55, 555]


def test_compiled_udf_takes_no_python_node():
    def build(F, df):
        return df.select(F.udf(simple, "double")("x").alias("r"))
    tdf, got, want = _both(build, _data(), {
        "spark.rapids.sql.test.enabled": True})
    tree = _nodes(tdf)
    assert "TpuArrowEvalPythonExec" not in tree and \
        "CpuFallbackExec" not in tree
    pd.testing.assert_frame_equal(got, want, check_dtype=False)


def test_nested_udfs_take_the_cpu_fallback():
    def build(F, df):
        return df.select(F.udf(doubled, "bigint")(
            F.udf(mirror, "bigint")("k")).alias("r"), "k")
    tdf, got, want = _both(build, _data())
    assert "CpuFallbackExec[Project]" in _nodes(tdf)
    assert got["r"].tolist() == want["r"].tolist() == \
        [doubled(mirror(k)) for k in got["k"]]


def test_tpu_udf_against_jax_udf_with_nulls():
    def build(F, df):
        f = F.tpu_udf(lambda a, b: (a * a + b * b) ** 0.5, "double")
        return df.select(f("x", "k").alias("h"),
                         (f("x", "k") + 1).alias("h1"))
    tdf, got, want = _both(build, _data())
    tree = _nodes(tdf)
    assert "TpuArrowEvalPythonExec" not in tree and \
        "CpuFallbackExec" not in tree
    null = got["h"].isna().to_numpy()
    assert (null == want["h"].isna().to_numpy()).all()
    assert (null == pd.Series(_data()["x"]).isna().to_numpy()).all()
    np.testing.assert_allclose(got["h1"][~null], want["h1"][~null],
                               rtol=1e-15)


def test_tpu_udf_wrong_shape_names_the_udf():
    s = TpuSession({}, device="cpu")
    df = s.create_dataframe(_data())

    def bad(a):
        return a[:3]
    with pytest.raises(ValueError, match="tpu_udf bad"):
        df.select(TF.tpu_udf(bad, "double")("x").alias("r")).to_pandas()


def test_worker_pool_equals_inline():
    phones = [f"{10 + i % 25}-{i % 1000:03d}-555-0101" for i in range(N)]
    phones[17] = None
    data = {"c_phone": phones}
    WP.pool_metrics.reset()
    got = {}
    for workers in (0, 2):
        s = TpuSession({"spark.rapids.sql.python.numWorkers": workers},
                       device="cpu")
        df = s.create_dataframe(data).select(
            TF.udf(UD.phone_cc, "bigint")("c_phone").alias("cc"))
        assert "TpuArrowEvalPythonExec" in _nodes(df)
        got[workers] = df.to_pandas()["cc"]
    WP.shutdown_pool()
    snap = WP.pool_metrics.snapshot()
    assert got[0].equals(got[2])
    assert pd.isna(got[0][17])
    assert got[0][:3].tolist() == [10, 11, 12]
    assert snap["poolStarts"] == 1 and snap["poolChunks"] >= 2 and \
        snap["poolRows"] == N and snap["degradedToInline"] == 0


def test_worker_pool_degrades_an_unpicklable_function():
    WP.pool_metrics.reset()
    s = TpuSession({"spark.rapids.sql.python.numWorkers": 2}, device="cpu")
    offset = 3.0
    # a lambda pickles by reference to a name no worker can import
    local = TF.udf(lambda x: math.fsum([x, offset]), "double")
    df = s.create_dataframe({"x": np.arange(float(N))}).select(
        local("x").alias("y"))
    out = df.to_pandas()
    np.testing.assert_array_equal(out["y"], np.arange(float(N)) + offset)
    snap = WP.pool_metrics.snapshot()
    assert snap["degradedToInline"] == 1 and snap["poolChunks"] == 0
    assert "does not pickle" in snap["lastDegradation"]
