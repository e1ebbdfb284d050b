"""The PyTorch port's host runtime (``spark_rapids_tpu_torch/native``), on
the CPU: the cases of ``tests/test_native.py`` over the port's own copy of
the C++, built with g++.

The port's frames are byte for byte the JAX package's ``serialize_batch``
output for the same buffers at each codec level (raw, zrle, zrle+lzb),
each package decodes the other's, and the C++ codec equals the plain
Python codec (``py_serialize_batch``).  A build that fails raises with the
compiler's message: there is no quiet fallback.
"""

import numpy as np
import pytest

from spark_rapids_tpu import native as jax_native
from spark_rapids_tpu_torch import native


def _columns(seed=1):
    rng = np.random.default_rng(seed)
    text = b"spark rapids tpu " * 40
    return [
        (5, np.arange(1000, dtype=np.int64), None, None),
        (7, rng.uniform(size=500), np.asarray([True] * 400 + [False] * 100),
         None),
        (8, np.frombuffer(text, dtype=np.uint8),
         None, np.arange(0, len(text) + 1, 17, dtype=np.int32)),
        (4, np.zeros(0, dtype=np.int32), None, None),      # empty column
        (5, np.tile(np.arange(64, dtype=np.int64), 40), None, None),
        (2, rng.integers(0, 256, 4000).astype(np.uint8), None, None),
        (1, np.zeros(9000, dtype=np.bool_), None, None),   # zero runs
        (4, np.arange(10, dtype=np.int32), None, None),    # under 64 bytes
    ]


def _same(a, b):
    assert a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        assert (x is None and y is None) or np.array_equal(x, y)


def test_native_builds():
    assert native.library() is not None


@pytest.mark.parametrize("level", [0, 1, 2])
def test_frames_equal_jax_frames(level):
    cols = _columns()
    mine = native.serialize_batch(1000, cols, level)
    theirs = jax_native.serialize_batch(1000, cols, compress=level)
    assert mine == theirs
    # each package decodes the other's frame
    n1, a = native.deserialize_batch(theirs)
    n2, b = jax_native.deserialize_batch(mine)
    assert n1 == n2 == 1000
    for x, y in zip(a, b):
        _same(x, y)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_large_frames_equal_jax_frames(level):
    """Past 1 MiB of buffers the port encodes and decodes a frame's
    buffers on several threads: the bytes stay the JAX package's."""
    rng = np.random.default_rng(7)
    n = 1 << 18
    text = np.frombuffer(b"".join(b"row %d special requests " % i
                                  for i in range(n // 8)), dtype=np.uint8)
    cols = [(5, rng.integers(0, 1 << 40, n), None, None),
            (7, rng.normal(size=n), rng.random(n) > 0.1, None),
            (4, np.repeat(np.arange(n // 64, dtype=np.int32), 64), None,
             None),
            (8, text, None, np.linspace(0, len(text), n // 8 + 1)
             .astype(np.int32)),
            (1, np.zeros(n, dtype=np.bool_), None, None)]
    mine = native.serialize_batch(n, cols, level)
    assert mine == jax_native.serialize_batch(n, cols, compress=level)
    _, a = native.deserialize_batch(mine)
    _, b = jax_native.deserialize_batch(mine)
    for x, y in zip(a, b):
        _same(x, y)
    bad = bytearray(mine)
    bad[-1] ^= 0xFF
    try:
        native.deserialize_batch(bytes(bad))
    except ValueError:
        pass


@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("seed", [1, 2])
def test_cpp_codec_equals_python_codec(level, seed):
    cols = _columns(seed)
    blob = native.serialize_batch(1000, cols, level)
    assert blob == native.py_serialize_batch(1000, cols, level)
    n1, a = native.deserialize_batch(blob)
    n2, b = native.py_deserialize_batch(blob)
    assert n1 == n2
    for x, y in zip(a, b):
        _same(x, y)


def test_frame_roundtrip_values():
    cols = _columns()
    for level in (0, 2):
        nrows, got = native.deserialize_batch(
            native.serialize_batch(1000, cols, level))
        assert nrows == 1000
        assert np.array_equal(got[0][1].view(np.int64), cols[0][1])
        assert np.array_equal(got[1][1].view(np.float64), cols[1][1])
        assert got[1][2].view(np.bool_).sum() == 400
        assert got[2][3].view(np.int32).tolist() == cols[2][3].tolist()
        assert got[3][1] is None


def test_zrle_compresses_sparse():
    sparse = np.zeros(1 << 20, dtype=np.uint8)
    sparse[::4096] = 1
    blob = native.serialize_batch(1 << 20, [(0, sparse, None, None)], 1)
    assert len(blob) < 1 << 14


def test_lzb_ratio_and_random_stays_raw():
    text = np.frombuffer(b"hello world, hello gpu! " * 4000,
                         dtype=np.uint8).copy()
    rnd = np.random.default_rng(0).integers(0, 256, 100000).astype(np.uint8)
    for arr, ratio in ((text, 0.05), (rnd, 1.01)):
        blob = native.serialize_batch(len(arr), [(1, arr, None, None)], 2)
        assert len(blob) <= arr.nbytes * ratio + 64
        _, cols = native.deserialize_batch(blob)
        assert np.array_equal(cols[0][1], arr)


def test_frame_rejects_corrupt_and_truncated():
    cols = [(5, np.arange(4096, dtype=np.int64), None, None)]
    blob = native.serialize_batch(4096, cols, 2)
    for cut in (4, 10, 17, len(blob) // 2, len(blob) - 3):
        with pytest.raises(ValueError):
            native.deserialize_batch(blob[:cut])
        with pytest.raises(ValueError):
            native.py_deserialize_batch(blob[:cut])
    bad = bytearray(blob)
    hdr = 16 + 26
    bad[hdr + 1:hdr + 9] = (1 << 40).to_bytes(8, "little")
    with pytest.raises(ValueError):
        native.deserialize_batch(bytes(bad))
    with pytest.raises(ValueError):
        native.py_deserialize_batch(bytes(bad))


def test_codec_levels_by_name():
    assert [native.codec_level(n) for n in ("none", "zrle", "lz4", "zstd")] \
        == [0, 1, 2, 2]
    with pytest.raises(ValueError):
        native.codec_level("snappy")


def test_pager_roundtrip(tmp_path):
    blob = np.random.default_rng(2).bytes(100_000)
    p = str(tmp_path / "page.bin")
    assert native.write_spill_file(p, blob) == len(blob)
    assert native.read_spill_file(p) == blob
    with pytest.raises(FileNotFoundError):
        native.read_spill_file(str(tmp_path / "missing.bin"))


def test_prefetcher_out_of_order(tmp_path):
    paths = []
    for i in range(16):
        fp = tmp_path / f"f{i}.bin"
        fp.write_bytes(bytes([i]) * (1000 + i))
        paths.append(str(fp))
    pf = native.FilePrefetcher(4)
    try:
        pf.submit(paths)
        for i in reversed(range(16)):
            assert pf.get(i) == bytes([i]) * (1000 + i)
    finally:
        pf.close()


def test_prefetcher_missing_file(tmp_path):
    pf = native.FilePrefetcher(2)
    try:
        pf.submit([str(tmp_path / "nope.bin")])
        with pytest.raises(OSError):
            pf.get(0)
    finally:
        pf.close()


def test_prefetcher_incremental_sliding_window(tmp_path):
    paths = []
    for i in range(400):
        p = tmp_path / f"f{i}.bin"
        p.write_bytes(bytes([i % 256]) * (100 + i))
        paths.append(str(p))
    pf = native.FilePrefetcher(nthreads=4)
    try:
        submitted = 0
        for i in range(len(paths)):
            while submitted < min(i + 8, len(paths)):
                pf.submit([paths[submitted]])
                submitted += 1
            data = pf.get(i)
            assert len(data) == 100 + i and data[0] == i % 256
    finally:
        pf.close()


@pytest.mark.parametrize("columns", [None, ["a"]], ids=["whole", "pruned"])
def test_multithreaded_reader(tmp_path, columns):
    """The MULTITHREADED strategy's tables equal PERFILE's, for a scan of
    every column and for a pruned one."""
    import pyarrow as pa
    import pyarrow.dataset as ds
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch.io.multifile import iter_file_tables
    paths = []
    for i in range(6):
        t = pa.table({"a": np.arange(i * 100, i * 100 + 100),
                      "s": [f"x{j}" for j in range(100)]})
        p = str(tmp_path / f"p{i}.parquet")
        pq.write_table(t, p)
        paths.append(p)
    args = (paths, "parquet", columns, ds.field("a") > 250)
    mt = list(iter_file_tables(*args, "MULTITHREADED", 64,
                               max_files_parallel=2))
    pf = list(iter_file_tables(*args, "PERFILE", 64))
    assert len(mt) == len(pf) == 6
    for a, b in zip(mt, pf):
        assert a.equals(b)


def test_arena_alloc_recycle_and_close():
    a = native.HostArena(1 << 20)
    b1 = a.alloc(1024)
    b1[:] = 42
    s1 = a.stats()
    a.free(b1)
    b2 = a.alloc(1024)  # from the free list
    assert a.stats()["reserved"] == s1["reserved"]
    big = a.alloc(3 << 20)  # past one slab
    assert a.stats()["reserved"] >= 3 << 20
    with pytest.raises(RuntimeError):
        a.close()  # live views would dangle
    a.free(b2)
    a.free(big)
    a.close()


def test_failed_build_raises(tmp_path):
    """A source that does not compile raises NativeBuildError with the
    compiler's message; so does a missing compiler."""
    src = tmp_path / "broken.cpp"
    src.write_text("extern \"C\" int f( { return 0; }\n")
    with pytest.raises(native.NativeBuildError) as e:
        native.build_library(src, tmp_path / "build")
    assert "broken.cpp" in str(e.value)
    with pytest.raises(native.NativeBuildError):
        native.build_library(native._SRC, tmp_path / "build2",
                             compiler=str(tmp_path / "no-such-g++"))
