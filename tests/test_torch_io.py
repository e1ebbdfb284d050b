"""The PyTorch port's file I/O against the JAX package's, on the CPU.

The cases of ``tests/test_io.py`` and ``tests/test_io_meta.py``, each run
through both packages over the same files (written with pyarrow from
numpy-seeded pandas frames in ``tmp_path``, or by one package's writer
and read by the other's reader): the three multi-file reader strategies,
filter pushdown and column pruning (checked through the scan's
``required_columns`` and decoded columns), parquet, ORC and CSV,
partitioned writes and hive discovery, save modes, ``input_file_name``
and the ``_metadata`` fields, bucket ids equal to the JAX package's bit
for bit, bucketed writes, bucket pruning, the coalesce the planner puts
above a multi-file PERFILE scan, and the arrow layouts pandas writes
(``large_string``, dictionary-encoded, chunked, ``date32``, nullable).
Answers must be equal (rows sorted where the query does not fix their
order); floats exactly, since both packages read the same values.
"""

import os

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.io import bucketing as JB
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.io import bucketing as B

READER_TYPE = "spark.rapids.sql.format.parquet.reader.type"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the host: one torch thread here."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jsess():
    s = JaxSession({})
    yield s
    s.stop()


@pytest.fixture(scope="module")
def psess():
    return TpuSession({}, device="cpu")


def both(jsess, psess, build):
    """``build(session, functions)`` through each package, as pandas."""
    return (build(jsess, JF).to_pandas(), build(psess, F).to_pandas())


def same(a: pd.DataFrame, b: pd.DataFrame, sort=None):
    if sort is not None:
        a = a.sort_values(sort, kind="stable").reset_index(drop=True)
        b = b.sort_values(sort, kind="stable").reset_index(drop=True)
    pd.testing.assert_frame_equal(a, b, check_dtype=False)


def _write_files(tmp_path, n_files=4, rows_per_file=100, seed=5):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n_files):
        pdf = pd.DataFrame({
            "id": np.arange(i * rows_per_file, (i + 1) * rows_per_file),
            "grp": np.arange(rows_per_file) % 5,
            "x": rng.normal(size=rows_per_file),
            "name": [f"f{i}-r{j}" for j in range(rows_per_file)],
        })
        p = str(tmp_path / f"part-{i}.parquet")
        pq.write_table(pa.Table.from_pandas(pdf), p)
        paths.append(p)
    return paths


def _scans(plan):
    out = []

    def walk(n):
        if type(n).__name__ == "TpuFileScanExec":
            out.append(n)
        for c in n.children:
            walk(c)
    walk(plan)
    return out


# ------------------------------------------------ readers and pushdown --

@pytest.mark.parametrize("reader_type",
                         ["PERFILE", "COALESCING", "MULTITHREADED", "AUTO"])
def test_multifile_strategies(tmp_path, reader_type):
    paths = _write_files(tmp_path)
    conf = {READER_TYPE: reader_type}
    js = JaxSession(conf)
    ps = TpuSession(conf, device="cpu")
    want, got = both(js, ps, lambda s, f: s.read.parquet(*paths))
    js.stop()
    assert len(got) == 400 and got["name"][399] == "f3-r99"
    # every strategy keeps the files' row order
    same(want, got)


def test_predicate_pushdown_into_scan(jsess, psess, tmp_path):
    paths = _write_files(tmp_path)
    want, got = both(jsess, psess, lambda s, f: s.read.parquet(*paths)
                     .filter((f.col("id") >= 350) & (f.col("x") > 0)))
    same(want, got)
    df = psess.read.parquet(*paths).filter(f_ge(F, "id", 350))
    plan = psess.plan(df.plan)
    assert "pushdown" in plan.tree_string()
    assert df.plan.child.pushed_filters, "the filter reached the scan"
    assert sorted(df.to_pandas()["id"]) == list(range(350, 400))


def f_ge(fns, name, v):
    return fns.col(name) >= v


def test_pushdown_keeps_nan_order(jsess, psess, tmp_path):
    """NaN is the largest float to the engine: a pushed ``>`` keeps it."""
    p = str(tmp_path / "nan.parquet")
    pq.write_table(pa.table({"v": [1.0, np.nan, 3.0, -2.0],
                             "k": [1, 2, 3, 4]}), p)
    got = psess.read.parquet(p).filter(F.col("v") > 2.0).to_pandas()
    assert sorted(got["k"]) == [2, 3]
    got = psess.read.parquet(p).filter(F.col("v") < 2.0).to_pandas()
    assert sorted(got["k"]) == [1, 4]


def test_column_pruning(jsess, psess, tmp_path):
    paths = _write_files(tmp_path)
    df = psess.read.parquet(*paths).select("id")
    scan, = _scans(psess.plan(df.plan))
    assert scan.columns == ["id"]
    assert df.plan.child.required_columns == {"id"}
    jdf = jsess.read.parquet(*paths).select("id")
    jscan = jsess.plan(jdf.plan)
    while jscan.children:
        jscan = jscan.children[0]
    assert jscan.columns == scan.columns
    same(jdf.to_pandas(), df.to_pandas())
    # a count decodes no column at all; a later query reads again in full
    assert psess.read.parquet(*paths).count() == 400
    rel = psess.read.parquet(*paths)
    assert rel.select("id").count() == 400
    assert rel.plan.required_columns == set()
    full = rel.to_pandas()
    assert rel.plan.required_columns is None and len(full.columns) == 4


def test_pruning_through_joins(psess, tmp_path):
    """The port also prunes through a join and a projection's unread
    outputs (the JAX pass stops at a join): each side reads what the
    join's consumers, keys and condition name on it."""
    paths = _write_files(tmp_path)
    dim = str(tmp_path / "dim.parquet")
    pq.write_table(pa.table({"grp": np.arange(5), "label": list("abcde"),
                             "w": np.arange(5.0)}), dim)
    fact = psess.read.parquet(*paths)
    d = psess.read.parquet(dim)
    q = (fact.withColumnRenamed("x", "xx").join(d, on="grp")
         .groupBy("label").agg(F.sum("xx").alias("s")))
    psess.plan(q.plan)
    assert fact.plan.required_columns == {"grp", "x"}
    assert d.plan.required_columns == {"grp", "label"}
    pdf = pd.concat([pd.read_parquet(p) for p in paths])
    want = pdf.groupby("grp")["x"].sum()
    got = q.orderBy("label").to_pandas()
    np.testing.assert_allclose(got["s"], want.to_numpy(), rtol=1e-12)


def test_relation_read_twice_takes_the_union(psess, tmp_path):
    paths = _write_files(tmp_path)
    rel = psess.read.parquet(*paths)
    a = rel.filter(F.col("grp") == 1).select("id")
    b = rel.select("grp", "name")
    q = a.join(b.withColumnRenamed("grp", "g"), on=[F.col("id") ==
                                                     F.col("g")])
    psess.plan(q.plan)
    assert rel.plan.required_columns == {"id", "grp", "name"}
    assert rel.plan.pushed_filters == []
    got = q.to_pandas()
    assert len(got) == 0 or set(got["id"]) <= {0, 1, 2, 3, 4}


# ---------------------------------------------------------------- writes --

def test_parquet_write_roundtrip(jsess, psess, tmp_path):
    pdf = pd.DataFrame({"a": range(100), "s": [f"x{i}" for i in range(100)]})
    for writer, reader, tag in ((psess, jsess, "p2j"), (jsess, psess, "j2p")):
        out = str(tmp_path / tag)
        stats = writer.create_dataframe(pdf).write.parquet(out)
        assert stats.num_rows == 100 and stats.num_files >= 1
        back = reader.read.parquet(out).to_pandas()
        same(back, pdf, sort="a")


def test_write_keeps_row_order_across_files(psess, jsess, tmp_path):
    pdf = pd.DataFrame({"a": np.arange(1000)[::-1].copy(),
                        "v": np.arange(1000) * 0.5})
    s = TpuSession({"spark.rapids.sql.writer.maxRowsPerFile": 64},
                   device="cpu")
    out = str(tmp_path / "ordered")
    stats = s.create_dataframe(pdf).write.parquet(out)
    assert stats.num_files == 16
    files = sorted(os.listdir(out))
    assert files[-1].endswith("-00015.parquet")
    for reader in (psess, jsess):
        back = reader.read.parquet(out).to_pandas()
        same(back, pdf)
    back = psess.read.parquet(*[os.path.join(out, f) for f in files])
    same(back.to_pandas(), pdf)


def test_partitioned_write_and_discovery(jsess, psess, tmp_path):
    pdf = pd.DataFrame({"k": [1, 2, 1, 2, 3], "v": [10., 20., 30., 40., 50.]})
    for writer, reader, tag in ((psess, jsess, "p2j"), (jsess, psess, "j2p")):
        out = str(tmp_path / tag)
        stats = writer.create_dataframe(pdf).write.partitionBy("k") \
            .parquet(out)
        assert stats.num_partitions == 3
        assert any("k=1" in d for d in os.listdir(out))
        got = psess.read.parquet(out).to_pandas()
        want = jsess.read.parquet(out).to_pandas()
        assert sorted(got.columns) == ["k", "v"]
        same(want, got, sort="v")
        assert got["v"].sum() == 150.0
        got = psess.read.parquet(out).filter(F.col("k") == 1).to_pandas()
        assert sorted(got["v"].tolist()) == [10., 30.]


def test_write_modes(psess, jsess, tmp_path):
    pdf = pd.DataFrame({"a": [1, 2, 3]})
    path = str(tmp_path / "m")
    df = psess.create_dataframe(pdf)
    df.write.parquet(path)
    with pytest.raises(FileExistsError):
        df.write.parquet(path)
    df.write.mode("append").parquet(path)
    assert psess.read.parquet(path).count() == 6
    assert jsess.read.parquet(path).count() == 6
    df.write.mode("overwrite").parquet(path)
    assert psess.read.parquet(path).count() == 3
    df.write.mode("ignore").parquet(path)
    assert psess.read.parquet(path).count() == 3
    with pytest.raises(ValueError, match="save mode"):
        df.write.mode("upsert")


def test_csv_read_and_write(jsess, psess, tmp_path):
    pdf = pd.DataFrame({"x": [1, 2, 3], "y": ["a", "b", "c"],
                        "z": [0.5, -1.25, 2.0]})
    p = str(tmp_path / "t.csv")
    pdf.to_csv(p, index=False)
    want, got = both(jsess, psess, lambda s, f: s.read.csv(p))
    same(want, got)
    same(got, pdf)
    out = str(tmp_path / "csv_out")
    psess.create_dataframe(pdf).write.csv(out)
    same(jsess.read.csv(out).to_pandas(), pdf)
    same(psess.read.csv(out).to_pandas(), pdf)


def test_orc_roundtrip(jsess, psess, tmp_path):
    pdf = pd.DataFrame({"a": range(10), "b": np.linspace(0, 1, 10),
                        "s": [f"s{i % 3}" for i in range(10)]})
    for writer, tag in ((psess, "p"), (jsess, "j")):
        out = str(tmp_path / f"orc_{tag}")
        writer.create_dataframe(pdf).write.orc(out)
        want, got = both(jsess, psess, lambda s, f: s.read.orc(out))
        same(want, got, sort="a")
        same(got, pdf, sort="a")
    out = str(tmp_path / "orc_parts")
    psess.create_dataframe(pdf).write.partitionBy("s").orc(out)
    got = psess.read.orc(out).to_pandas()
    want = jsess.read.orc(out).to_pandas()
    same(want, got, sort="a")
    assert sorted(os.listdir(out)) == ["s=s0", "s=s1", "s=s2"]


# ----------------------------------------------------- metadata columns --

@pytest.fixture()
def two_files(tmp_path):
    paths = []
    for i in range(2):
        p = str(tmp_path / f"f{i}.parquet")
        pq.write_table(pa.table({"a": [i * 10 + 1, i * 10 + 2],
                                 "b": [1.0, 2.0]}), p)
        paths.append(p)
    return paths


def test_input_file_name(jsess, psess, two_files):
    want, got = both(jsess, psess, lambda s, f: s.read.parquet(*two_files)
                     .select("a", f.input_file_name().alias("f")))
    same(want, got, sort="a")
    by_a = dict(zip(got["a"], got["f"]))
    assert by_a[1].endswith("f0.parquet") and by_a[11].endswith("f1.parquet")


def test_input_file_name_above_filter(jsess, psess, two_files):
    want, got = both(jsess, psess, lambda s, f: s.read.parquet(*two_files)
                     .filter(f.col("a") > 5)
                     .select(f.input_file_name().alias("f")))
    same(want, got)
    assert all(f.endswith("f1.parquet") for f in got["f"])


def test_filter_on_input_file_name(jsess, psess, two_files):
    want, got = both(jsess, psess, lambda s, f: s.read.parquet(*two_files)
                     .filter(f.input_file_name().contains("f0")))
    same(want, got, sort="a")
    assert sorted(got["a"].tolist()) == [1, 2]
    assert psess.read.parquet(*two_files).filter(
        F.input_file_name().contains("f0")).count() == 2


def test_input_file_name_without_scan_errors(psess):
    df = psess.create_dataframe(pd.DataFrame({"a": [1]}))
    with pytest.raises(ValueError, match="file scan"):
        df.select(F.input_file_name())


def test_metadata_fields(jsess, psess, two_files):
    """The port holds ``_metadata`` as its four flat fields; they equal
    the JAX package's struct field for field."""
    got = psess.read.parquet(*two_files).select("a", "_metadata") \
        .to_pandas()
    want = jsess.read.parquet(*two_files).select("a", "_metadata") \
        .to_arrow()
    struct = want.column("_metadata").to_pylist()
    for field in ("file_path", "file_name", "file_size",
                  "file_modification_time"):
        assert got[f"_metadata.{field}"].tolist() == \
            [r[field] for r in struct]
    assert got["a"].tolist() == want.column("a").to_pylist()
    row = got.iloc[0]
    assert row["_metadata.file_path"].endswith(row["_metadata.file_name"])
    assert row["_metadata.file_size"] > 0


def test_metadata_field_access(jsess, psess, two_files):
    want, got = both(jsess, psess, lambda s, f: s.read.parquet(*two_files)
                     .select(f.col("_metadata").getField("file_name")
                             .alias("fn"), "a"))
    same(want, got, sort="a")
    assert set(got["fn"]) == {"f0.parquet", "f1.parquet"}


def test_input_file_name_on_hive_partitioned(jsess, psess, tmp_path):
    pdf = pd.DataFrame({"p": [1, 1, 2, 2], "v": [1.0, 2.0, 3.0, 4.0]})
    out = str(tmp_path / "tbl")
    psess.create_dataframe(pdf).write.partitionBy("p").parquet(out)
    want, got = both(jsess, psess, lambda s, f: s.read.parquet(out).select(
        "v", "p", f.input_file_name().alias("f")))
    same(want, got, sort="v")
    for _, r in got.iterrows():
        assert f"p={int(r['p'])}" in r["f"]


# ------------------------------------------------------------- bucketing --

def test_bucket_ids_equal_jax():
    rng = np.random.default_rng(11)
    ints = rng.integers(-1 << 40, 1 << 40, size=500)
    floats = rng.normal(size=500) * 1e6
    floats[::17] = np.nan
    floats[::19] = -0.0
    words = np.array([None if i % 13 == 0 else
                      "".join(chr(97 + c) for c in rng.integers(0, 26, i % 9))
                      + ("é" if i % 7 == 0 else "") for i in range(500)],
                     dtype=object)
    for vals in (ints, floats, words, ints.astype(np.int32)):
        for nb in (1, 4, 7, 64):
            np.testing.assert_array_equal(B.bucket_ids(vals, nb),
                                          JB.bucket_ids(vals, nb))
    for v in (0, 5, 5.0, -3, "alpha", "", 2.5):
        assert B.bucket_id_of(v, 8) == JB.bucket_id_of(v, 8)
    assert B.bucket_id_of(5, 8) == B.bucket_id_of(5.0, 8)


def test_bucketed_write_read_roundtrip(jsess, psess, tmp_path):
    pdf = pd.DataFrame({"k": np.arange(100) % 10, "v": np.arange(100.0)})
    for writer, tag in ((psess, "p"), (jsess, "j")):
        out = str(tmp_path / f"tbl_{tag}")
        stats = writer.create_dataframe(pdf).write.bucketBy(4, "k") \
            .parquet(out)
        assert stats.num_files <= 4
        assert os.path.exists(os.path.join(out, B.SPEC_FILE))
        want, got = both(jsess, psess, lambda s, f: s.read.parquet(out))
        same(want, got, sort=["k", "v"])
        same(got, pdf, sort=["k", "v"])
    # the two packages route every row to the same bucket file
    for b in range(4):
        f = f"part-bucket-{b:05d}.parquet"
        p_rows = pq.read_table(str(tmp_path / "tbl_p" / f)).to_pandas()
        j_rows = pq.read_table(str(tmp_path / "tbl_j" / f)).to_pandas()
        same(p_rows, j_rows, sort=["k", "v"])


@pytest.mark.parametrize("literal", [5, 5.0])
def test_bucket_pruning(jsess, psess, tmp_path, literal):
    pdf = pd.DataFrame({"k": np.arange(200) % 13, "v": np.arange(200)})
    out = str(tmp_path / "tbl")
    jsess.create_dataframe(pdf).write.bucketBy(8, "k").parquet(out)
    df = psess.read.parquet(out).filter(F.col("k") == literal)
    scan, = _scans(psess.plan(df.plan))
    assert len(scan.paths) == 1, "an equality filter prunes to one file"
    want = jsess.read.parquet(out).filter(JF.col("k") == literal) \
        .to_pandas()
    same(want, df.to_pandas(), sort="v")
    assert sorted(df.to_pandas()["v"]) == sorted(pdf[pdf["k"] == 5]["v"])


def test_bucketed_scan_without_filter_reads_all(psess, tmp_path):
    pdf = pd.DataFrame({"k": np.arange(50) % 5, "v": np.arange(50)})
    out = str(tmp_path / "tbl")
    psess.create_dataframe(pdf).write.bucketBy(3, "k").parquet(out)
    assert len(psess.read.parquet(out).to_pandas()) == 50


def test_bucketed_append_rejected(psess, tmp_path):
    pdf = pd.DataFrame({"k": [1, 2], "v": [1, 2]})
    out = str(tmp_path / "tbl")
    psess.create_dataframe(pdf).write.bucketBy(2, "k").parquet(out)
    with pytest.raises(ValueError, match="append"):
        psess.create_dataframe(pdf).write.mode("append").bucketBy(
            2, "k").parquet(out)


# ------------------------------------------------------ planner coalesce --

def test_planner_inserts_coalesce_above_multifile_scan(tmp_path):
    paths = []
    for i in range(6):
        p = str(tmp_path / f"f{i}.parquet")
        pq.write_table(pa.table({"a": list(range(i * 10, i * 10 + 10))}), p)
        paths.append(p)
    s = TpuSession({READER_TYPE: "PERFILE"}, device="cpu")
    df = s.read.parquet(*paths)
    plan = s.plan(df.plan)
    assert "TpuCoalesceBatchesExec" in plan.tree_string()
    batches = list(plan.execute())
    assert len(batches) == 1 and batches[0].nrows == 60
    assert sorted(df.to_pandas()["a"]) == list(range(60))
    s2 = TpuSession({}, device="cpu")
    assert "TpuCoalesceBatchesExec" not in \
        s2.plan(s2.read.parquet(paths[0]).plan).tree_string()
    assert "TpuCoalesceBatchesExec" not in \
        s2.plan(s2.read.parquet(*paths).plan).tree_string()


# ----------------------------------------------- arrow layouts and gates --

def _layout_table(kind, n=300, seed=3):
    rng = np.random.default_rng(seed)
    words = [f"w{int(v)}" for v in rng.integers(0, 40, n)]
    ints = rng.integers(-1000, 1000, n)
    if kind == "large_string":
        return pa.table({"k": ints, "s": pa.array(words,
                                                  type=pa.large_string())})
    if kind == "dictionary":
        return pa.table({"k": ints,
                         "s": pa.array(words).dictionary_encode()})
    if kind == "date32":
        days = rng.integers(0, 20000, n).astype(np.int32)
        return pa.table({"k": ints, "d": pa.array(days, type=pa.int32())
                         .cast(pa.date32())})
    if kind == "timestamp":
        us = rng.integers(0, 1 << 50, n)
        return pa.table({"k": ints,
                         "t": pa.array(us * 1000, type=pa.timestamp("ns")),
                         "tz": pa.array(us, type=pa.timestamp("ms",
                                                              tz="UTC"))})
    if kind == "nullable":
        mask = rng.random(n) < 0.2
        return pa.table({
            "k": pa.array(ints, mask=mask),
            "x": pa.array(rng.normal(size=n), mask=rng.random(n) < 0.2),
            "s": pa.array([None if m else w for m, w in
                           zip(rng.random(n) < 0.2, words)]),
            "b": pa.array(rng.random(n) < 0.5, mask=mask)})
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["large_string", "dictionary", "chunked",
                                  "date32", "timestamp", "nullable"])
def test_arrow_layouts(jsess, psess, tmp_path, kind):
    p = str(tmp_path / f"{kind}.parquet")
    if kind == "chunked":
        # many row groups: every column arrives as a chunked array
        table = _layout_table("nullable")
        pq.write_table(table, p, row_group_size=37)
    else:
        table = _layout_table(kind)
        pq.write_table(table, p)
    got = psess.read.parquet(p).to_pandas()
    if kind != "timestamp":
        same(jsess.read.parquet(p).to_pandas(), got)
    want = table.to_pandas()
    for c in want.columns:
        w = want[c]
        g = got[c]
        if kind == "timestamp" and c != "k":
            w = pd.to_datetime(w, utc=True).dt.as_unit("us")
        elif kind == "dictionary" and c == "s":
            w = w.astype(g.dtype)
        elif kind == "date32":
            w = pd.Series([None if v is None else v for v in w], name=c)
            g = pd.Series(list(g), name=c)
        pd.testing.assert_series_equal(g.reset_index(drop=True),
                                       w.reset_index(drop=True),
                                       check_dtype=False)
    # the same columns through a pushed filter and a string group-by
    if kind in ("large_string", "dictionary"):
        want, got = both(jsess, psess, lambda s, f: s.read.parquet(p)
                         .filter(f.col("s") == "w3")
                         .groupBy("s").agg(f.sum("k").alias("n")))
        same(want, got)


@pytest.mark.parametrize("key", ["spark.rapids.sql.format.parquet.enabled",
                                 "spark.rapids.sql.format.parquet."
                                 "read.enabled"])
def test_disabled_format_raises_naming_key(tmp_path, key):
    """A disabled format's scan is tagged with its key and reads on the
    CPU fallback, with the JAX package's answer; another format's switch
    leaves the columnar scan alone."""
    paths = _write_files(tmp_path, n_files=1)
    s = TpuSession({key: False}, device="cpu")
    df = s.read.parquet(*paths).filter(F.col("grp") < 3)
    assert "CpuFallbackExec[FileRelation]" in df.explain()
    assert f"parquet scan disabled by {key}" in s.overrides.last_explain
    j = JaxSession({key: False})
    try:
        want = j.read.parquet(*paths).filter(JF.col("grp") < 3).to_pandas()
    finally:
        j.stop()
    same(df.to_pandas(), want)
    t = TpuSession({"spark.rapids.sql.format.orc.enabled": False},
                   device="cpu")
    assert "CpuFallbackExec" not in t.read.parquet(*paths).explain()
    assert len(t.read.parquet(*paths).to_pandas()) == 100


def test_reader_options_raise_naming_the_option(psess, tmp_path):
    """The readers honour no option yet: setting one (on the reader, or
    on a FileRelation built by hand) raises instead of reading the files
    some other way."""
    from spark_rapids_tpu_torch.plan import logical as PL
    paths = _write_files(tmp_path, n_files=1)
    with pytest.raises(NotImplementedError, match="'header'"):
        psess.read.option("header", "true")
    rel = psess.read.parquet(*paths).plan
    hand = PL.FileRelation(rel.paths, rel.file_format, rel.schema,
                           {"sep": "|"})
    with pytest.raises(NotImplementedError, match="'sep'"):
        psess.plan(hand)


def test_scan_lands_on_the_session_device(psess, tmp_path):
    paths = _write_files(tmp_path, n_files=2)
    plan = psess.plan(psess.read.parquet(*paths).plan)
    for b in plan.execute():
        assert all(c.device.type == "cpu" for c in b.columns.values())
    scan, = _scans(plan)
    assert scan.metrics["bytesDecoded"].value > 0
    assert scan.metrics["numInputBatches"].value >= 1


def test_reader_error_raises_on_the_driving_thread(psess, tmp_path):
    paths = _write_files(tmp_path, n_files=2)
    df = psess.read.parquet(*paths)
    os.unlink(paths[1])
    with pytest.raises(Exception) as info:
        df.to_pandas()
    assert "part-1" in str(info.value)


def test_sharded_planner_falls_back_on_files(psess, tmp_path):
    """The sharded planner no longer falls back on files: the file list
    shards over the group, each shard reads its own files, and the answer
    is the single device's."""
    paths = _write_files(tmp_path)
    s = TpuSession({"spark.rapids.sql.distributed.numShards": 4},
                   device="cpu")
    q = s.read.parquet(*paths).groupBy("grp").agg(F.sum("x").alias("sx"))
    got = q.orderBy("grp").to_pandas()
    assert s.last_dist_explain == "distributed"
    st = s.last_scan_stats
    assert st["sharded_files"] and st["files"] == len(paths)
    assert st["peak_host_rows"] <= st["shard_bound_rows"] < st["total_rows"]
    want = psess.read.parquet(*paths).groupBy("grp").agg(
        F.sum("x").alias("sx")).orderBy("grp").to_pandas()
    same(want, got)


def test_staging_ring_packs_parts_across_slots(monkeypatch):
    """The upload's staging ring (CUDA only in use; here over plain
    memory): parts of every size, runs of one value and parts larger than
    a slot land end to end, across slot turns, in the right dtype."""
    from spark_rapids_tpu_torch.columnar import column as C
    monkeypatch.setattr(C, "STAGING_SLOT_BYTES", 64)   # 8 int64 a slot
    rng = np.random.default_rng(23)
    for dtype in (np.int64, np.int32, np.uint8, np.bool_):
        parts, want = [], []
        for k in (0, 3, 8, 1, 21, 5, 0, 17):
            if k % 2:
                v = rng.integers(0, 2 if dtype == np.bool_ else 100, k)
                parts.append(v.astype(dtype))
                want.append(v.astype(dtype))
            else:
                parts.append((k, 1))
                want.append(np.ones(k, dtype=dtype))
        ring = C.StagingRing(torch.device("cpu"))
        out = torch.empty(sum(len(w) for w in want),
                          dtype=torch.from_numpy(want[0][:0]).dtype)
        ring.upload(parts, out)
        np.testing.assert_array_equal(out.numpy(), np.concatenate(want))


def test_pushdown_of_dates_strings_and_sets(jsess, psess, tmp_path):
    """Date, string, IN and IS NULL predicates reach arrow (the scan
    shows ``pushdown``) and the answers equal the JAX package's."""
    import datetime
    rng = np.random.default_rng(29)
    n = 500
    days = rng.integers(9000, 11000, n).astype(np.int32)
    p = str(tmp_path / "d.parquet")
    pq.write_table(pa.table({
        "d": pa.array(days).cast(pa.date32()),
        "s": pa.array([None if i % 11 == 0 else f"k{i % 7}"
                       for i in range(n)]),
        "k": rng.integers(0, 50, n)}), p)
    lo, hi = datetime.date(1995, 1, 1), datetime.date(1997, 6, 30)

    def q(s, f):
        return s.read.parquet(p).filter(
            (f.col("d") >= f.lit(lo)) & (f.col("d") < f.lit(hi))
            & f.col("s").isin("k1", "k3") & f.col("k").isNotNull())

    want, got = both(jsess, psess, q)
    same(want, got, sort=["k", "s"])
    assert len(got) > 0
    df = q(psess, F)
    assert "pushdown" in psess.plan(df.plan).tree_string()
    nulls = psess.read.parquet(p).filter(F.col("s").isNull()).count()
    assert nulls == len(range(0, n, 11))


@pytest.mark.parametrize("goal", ["target_size", "target_rows"])
def test_coalesce_goals(tmp_path, goal):
    """``memory/coalesce.py``'s goals over a PERFILE scan: a byte target
    emits a batch before the next input would pass it; a row target
    emits a batch once it holds at least that many rows."""
    from spark_rapids_tpu_torch.exec.basic import TpuCoalesceBatchesExec
    from spark_rapids_tpu_torch.memory.coalesce import (
        TargetRows, TargetSize)
    paths = _write_files(tmp_path, n_files=5)
    s = TpuSession({READER_TYPE: "PERFILE"}, device="cpu")
    scan, = _scans(s.plan(s.read.parquet(*paths).plan))
    one = next(iter(scan.execute())).device_size_bytes()
    g = TargetSize(2 * one) if goal == "target_size" else TargetRows(250)
    out = list(TpuCoalesceBatchesExec(scan, goal=g).execute())
    assert [b.nrows for b in out] == \
        ([200, 200, 100] if goal == "target_size" else [300, 200])
    assert sorted(np.concatenate([b.to_arrow().column("id").to_numpy()
                                  for b in out])) == list(range(500))
    with pytest.raises(ValueError, match="exactly one"):
        TpuCoalesceBatchesExec(scan)
