"""The PyTorch port's hashes and per-batch ids (``ops/misc_exprs.py``)
on the CPU.

The cases of the reference's ``tests/test_misc_exprs.py``:
``hash()`` is Spark's Murmur3 (seed 42, int32), bit for bit against a
Python Murmur3_x86_32 over every column type Spark hashes (booleans, the
small integers, bigints, floats with -0.0 and NaN, dates, timestamps,
decimals and UTF-8 strings with their tail bytes), nulls skipped, on the
device and in the CPU fallback; ``md5`` runs in the fallback with
``hashlib``'s digest and the JAX package's answer;
``monotonically_increasing_id()`` and ``spark_partition_id()`` give the
JAX package's ids batch for batch.  The JAX package's ``hash()`` is its
partitioner's mix, not Spark's Murmur3 (``ROADMAP.md`` queue 3), so the
port's is held against Python, and against Spark's published values.
"""

import datetime
import hashlib
import struct

import numpy as np
import pandas as pd
import pytest
import torch

from test_torch_strings import _assert_same
from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.api.session import TpuSession

M32 = 0xFFFFFFFF


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ----------------------------------- Murmur3_x86_32, as Spark's Java has it

def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def _k1(k):
    return (_rotl((k * 0xCC9E2D51) & M32, 15) * 0x1B873593) & M32


def _h1(h, k):
    return (_rotl(h ^ k, 13) * 5 + 0xE6546B64) & M32


def _fmix(h, n):
    h ^= n
    h = ((h ^ (h >> 16)) * 0x85EBCA6B) & M32
    h = ((h ^ (h >> 13)) * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def hash_int(v, seed):
    return _fmix(_h1(seed, _k1(v & M32)), 4)


def hash_long(v, seed):
    v &= (1 << 64) - 1
    return _fmix(_h1(_h1(seed, _k1(v & M32)), _k1(v >> 32)), 8)


def hash_bytes(b, seed):
    h = seed
    n4 = len(b) // 4 * 4
    for i in range(0, n4, 4):
        h = _h1(h, _k1(int.from_bytes(b[i:i + 4], "little")))
    for x in b[n4:]:
        h = _h1(h, _k1((x - 256 if x >= 128 else x) & M32))
    return _fmix(h, len(b))


def spark_hash(row, kinds, seed=42):
    h = seed
    for v, kind in zip(row, kinds):
        if v is None:
            continue
        if kind == "string":
            h = hash_bytes(v.encode("utf-8"), h)
        elif kind == "double":
            v = 0.0 if v == 0 else v
            bits = 0x7FF8000000000000 if v != v else \
                struct.unpack("<q", struct.pack("<d", v))[0]
            h = hash_long(bits, h)
        elif kind == "float":
            v = 0.0 if v == 0 else v
            bits = 0x7FC00000 if v != v else \
                struct.unpack("<I", struct.pack("<f", v))[0]
            h = hash_int(bits, h)
        elif kind in ("bigint", "timestamp", "decimal"):
            h = hash_long(v, h)
        elif kind == "date":
            h = hash_int((v - datetime.date(1970, 1, 1)).days, h)
        else:
            h = hash_int(int(v), h)
    return h - (1 << 32) if h >= 1 << 31 else h


def test_python_murmur3_is_sparks():
    """Spark 3's published values: hash(1), hash(0), hash('abc'),
    hash(1L) and hash(null)."""
    assert spark_hash([1], ["int"]) == -559580957
    assert spark_hash([None], ["int"]) == 42
    assert spark_hash(["abc"], ["string"]) == 1322437556
    assert spark_hash([1], ["bigint"]) == -1712319331


def _hash_table(n=400, seed=21):
    rng = np.random.default_rng(seed)
    words = ["", "a", "ab", "abc", "abcd", "abcde", "Supplier#000000001",
             "héllo", "日本語", "x" * 37, "é", "Customer#0001"]

    def maybe(v, k):
        return None if k % 9 == 0 else v
    f = rng.normal(size=n) * 1e3
    f[::13] = np.nan
    f[3::17] = -0.0
    return {
        "s": [maybe(words[i], k) for k, i in
              enumerate(rng.integers(len(words), size=n))],
        "i": [maybe(int(v), k + 1) for k, v in
              enumerate(rng.integers(-2**31, 2**31, n))],
        "l": [int(v) for v in rng.integers(-2**63, 2**63 - 1, n,
                                            dtype=np.int64)],
        "f": [float(v) for v in f],
        "b": [maybe(bool(v), k + 2) for k, v in
              enumerate(rng.integers(0, 2, n))],
        "d": [datetime.date(1970, 1, 1) + datetime.timedelta(days=int(v))
              for v in rng.integers(-9000, 30000, n)],
    }


def kinds_of(df, cols):
    """Each column's type as Spark hashes it."""
    types = dict((n, t.name) for n, t in df.schema)
    return [types[c] for c in cols]


@pytest.mark.parametrize("cols", [("s",), ("i",), ("l",), ("f",), ("b",),
                                  ("d",), ("s", "l"), ("i", "s", "f"),
                                  ("b", "d", "s", "i")])
def test_hash_matches_spark_murmur3(cols):
    data = _hash_table()
    s = TpuSession({}, device="cpu")
    base = s.create_dataframe(data)
    kinds = kinds_of(base, cols)
    df = base.select(TF.hash(*cols).alias("h"))
    assert "CpuFallbackExec" not in df.explain().split("==")[0]
    got = df.to_pandas()["h"].tolist()
    want = [spark_hash(row, kinds)
            for row in zip(*[data[c] for c in cols])]
    assert got == want
    # the CPU fallback's host Murmur3 gives the same bits
    off = TpuSession({"spark.rapids.sql.expression.Murmur3Hash": "false"},
                     device="cpu")
    dff = off.create_dataframe(data).select(TF.hash(*cols).alias("h"))
    assert dff.explain().splitlines()[0] == "CpuFallbackExec[Project]"
    assert dff.to_pandas()["h"].tolist() == want


def test_hash_of_typed_values():
    """float, timestamp, decimal, tinyint and smallint arguments hash as
    Spark types them (the hash of each cast value)."""
    s = TpuSession({}, device="cpu")
    vals = [1.5, -0.0, float("nan"), None, 3.25, -7.75]
    df = s.create_dataframe({"v": vals})
    finite = s.create_dataframe({"v": [v for v in vals if v == v or
                                       v is None]})
    for target, kind in (("float", "float"), ("timestamp", "timestamp"),
                         ("decimal(7,2)", "decimal"), ("tinyint", "int"),
                         ("smallint", "int")):
        c = TF.col("v").cast(target)
        frame = df if kind == "float" else finite
        out = frame.select(c.alias("x"), TF.hash(c).alias("h")).to_arrow()
        xs = out.column("x").to_pylist()
        if kind == "timestamp":
            xs = [None if x is None else int(pd.Timestamp(x).value // 1000)
                  for x in xs]
        if kind == "decimal":
            xs = [None if x is None else int(x.scaleb(2)) for x in xs]
        assert out.column("h").to_pylist() == \
            [spark_hash([x], [kind]) for x in xs], target


def test_hash_sql_and_bucket(tmp_path):
    data = _hash_table()
    s = TpuSession({}, device="cpu")
    base = s.create_dataframe(data)
    base.createOrReplaceTempView("t")
    got = s.sql("SELECT b, count(*) AS n FROM (SELECT hash(s, i) % 32 "
                "AS b FROM t) x GROUP BY b ORDER BY b").to_pandas()
    h = [spark_hash(r, kinds_of(base, ("s", "i")))
         for r in zip(data["s"], data["i"])]
    want = pd.Series([int(np.fmod(v, 32)) for v in h]).value_counts()
    assert dict(zip(got["b"], got["n"])) == want.to_dict()


def test_jax_hash_is_not_sparks():
    """The divergence queue 3 records: the JAX package's hash(1) is its
    partitioner's mix."""
    js = JaxSession({})
    try:
        jax = js.create_dataframe({"v": np.array([1], dtype=np.int32)}) \
            .select(JF.hash("v").alias("h")).to_pandas()["h"].tolist()
    finally:
        js.stop()
    port = TpuSession({}, device="cpu").create_dataframe(
        {"v": np.array([1], dtype=np.int32)}).select(
        TF.hash("v").alias("h")).to_pandas()["h"].tolist()
    assert port == [-559580957] != jax


def test_md5_host_fallback():
    vals = ["abc", "", None, "héllo", "Supplier#000000042"]
    s = TpuSession({}, device="cpu")
    df = s.create_dataframe({"s": vals}).select(TF.md5("s").alias("m"))
    assert df.explain().splitlines()[0] == "CpuFallbackExec[Project]"
    assert "Md5 has no device implementation" in s.overrides.last_explain
    got = df.to_arrow().column("m").to_pylist()
    assert got == [None if v is None else hashlib.md5(
        v.encode()).hexdigest() for v in vals]
    js = JaxSession({})
    try:
        want = js.create_dataframe({"s": vals}).select(
            JF.md5("s").alias("m")).to_pandas()["m"].tolist()
    finally:
        js.stop()
    assert got == [None if pd.isna(v) else v for v in want]


@pytest.mark.parametrize("batch_rows", [1 << 20, 64])
def test_batch_ids_match_jax(batch_rows):
    """Each batch is a partition: ids (ordinal << 33) + row offset and the
    partition id; in one batch, as the JAX package gives them."""
    n = 300
    data = {"k": list(range(n)), "v": [float(i) * 0.5 for i in range(n)]}
    conf = {"spark.rapids.sql.tpu.maxBatchRows": batch_rows}

    def build(F, df):
        return df.select("k", F.monotonically_increasing_id().alias("mid"),
                         F.spark_partition_id().alias("pid"),
                         (F.monotonically_increasing_id() + 1).alias("m1"))
    port = build(TF, TpuSession(conf, device="cpu").create_dataframe(data))
    got = port.to_pandas()
    assert got["mid"].is_unique
    assert (got["m1"] == got["mid"] + 1).all()
    part = np.arange(n) // min(batch_rows, n)
    assert got["pid"].tolist() == part.tolist()
    assert got["mid"].tolist() == ((part << 33) + np.arange(n) -
                                   part * min(batch_rows, n)).tolist()
    if batch_rows >= n:
        js = JaxSession(conf)
        try:
            want = build(JF, js.create_dataframe(data)).to_pandas()
        finally:
            js.stop()
        _assert_same(got, want)
