"""ctypes binding of the host runtime (``native/host_runtime.cpp``).

Counterpart of ``spark_rapids_tpu/native/__init__.py``, over the port's
own copy of the C++ source.  The shared library is built with ``g++`` on
first use into ``spark_rapids_tpu_torch/_build/host-<digest>/`` (keyed by
a hash of the source and the flags, so a stale library is never loaded).
A failed build raises ``NativeBuildError`` carrying the compiler's
message: the port has no quiet fallback to Python.

Components:

- ``HostArena``       -- a slab arena for host staging buffers;
- ``serialize_batch`` / ``deserialize_batch`` -- the columnar frame codec
  of spilled batches: raw, zrle (zero runs) or zrle and lzb (an
  LZ4-class byte codec), the smaller per buffer.  The frames are byte for
  byte those of the JAX package for the same buffers and level;
- ``write_spill_file`` / ``read_spill_file`` -- the spill pager;
- ``FilePrefetcher``  -- background whole-file reads (the MULTITHREADED
  reader's pool, ``io/multifile.py``).

``py_serialize_batch`` / ``py_deserialize_batch`` are the codec's plain
Python version, the one the tests hold the C++ against (slow: a byte loop
for lzb).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "host_runtime.cpp"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]
_COMPILER = "g++"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    """The host runtime did not compile or load."""


def build_library(src: Path = _SRC, build_root: Path = _BUILD,
                  compiler: str = _COMPILER) -> Path:
    """Compile ``src`` into a shared library under ``build_root`` (once
    per source digest) and return its path; raises ``NativeBuildError``
    with the compiler's output when the build fails."""
    digest = hashlib.sha256(
        (" ".join([compiler] + _FLAGS)).encode() + src.read_bytes()
    ).hexdigest()[:16]
    out_dir = build_root / f"host-{digest}"
    lib_path = out_dir / "libsrt_host.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libsrt_host.{os.getpid()}.so"
    try:
        res = subprocess.run([compiler, *_FLAGS, str(src), "-o", str(tmp)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             timeout=600)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(
            f"building the host runtime with {compiler} failed: {e}") from e
    if res.returncode != 0:
        raise NativeBuildError(
            f"building the host runtime with {compiler} failed:\n"
            + res.stdout.decode(errors="replace"))
    os.replace(tmp, lib_path)
    return lib_path


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = build_library()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise NativeBuildError(
                    f"loading the host runtime {path} failed: {e}") from e
            _declare(lib)
            _lib = lib
    return _lib


def library() -> ctypes.CDLL:
    """The loaded host runtime (built on first call)."""
    return _load()


def _declare(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.arena_create.restype = ctypes.c_void_p
    lib.arena_create.argtypes = [ctypes.c_size_t]
    lib.arena_alloc.restype = ctypes.c_void_p
    lib.arena_alloc.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.arena_free.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_size_t]
    lib.arena_stats.argtypes = [ctypes.c_void_p] + \
        [ctypes.POINTER(ctypes.c_size_t)] * 3
    lib.arena_destroy.argtypes = [ctypes.c_void_p]

    lib.frame_serialize.restype = ctypes.c_void_p
    lib.frame_serialize.argtypes = [
        ctypes.c_uint64, ctypes.c_uint32, ctypes.POINTER(u8p),
        ctypes.POINTER(ctypes.c_uint64), u8p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64)]
    lib.frame_data.restype = u8p
    lib.frame_data.argtypes = [ctypes.c_void_p]
    lib.frame_release.argtypes = [ctypes.c_void_p]
    lib.frame_header.restype = ctypes.c_int
    lib.frame_header.argtypes = [
        u8p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint64),
        u8p, ctypes.c_uint32]
    lib.frame_deserialize.restype = ctypes.c_int
    lib.frame_deserialize.argtypes = [
        u8p, ctypes.c_uint64, ctypes.POINTER(u8p),
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint32, ctypes.c_int]

    lib.pager_write.restype = ctypes.c_int64
    lib.pager_write.argtypes = [ctypes.c_char_p, u8p, ctypes.c_uint64]
    lib.pager_read.restype = ctypes.c_int64
    lib.pager_read.argtypes = [ctypes.c_char_p, u8p, ctypes.c_uint64]
    lib.pager_file_size.restype = ctypes.c_int64
    lib.pager_file_size.argtypes = [ctypes.c_char_p]

    lib.prefetcher_create.restype = ctypes.c_void_p
    lib.prefetcher_create.argtypes = [ctypes.c_int]
    lib.prefetcher_submit.restype = ctypes.c_int
    lib.prefetcher_submit.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int]
    lib.prefetcher_wait.restype = ctypes.c_int64
    lib.prefetcher_wait.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.prefetcher_data.restype = u8p
    lib.prefetcher_data.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.prefetcher_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.prefetcher_destroy.argtypes = [ctypes.c_void_p]


# ------------------------------------------------------------------ arena --

class HostArena:
    """Staging-buffer arena; ``alloc`` returns numpy views over arena
    memory."""

    def __init__(self, slab_bytes: int = 64 << 20):
        self._lib = _load()
        self._handle = self._lib.arena_create(slab_bytes)
        self._live: Dict[int, Tuple[int, int]] = {}

    def alloc(self, nbytes: int) -> np.ndarray:
        ptr = self._lib.arena_alloc(self._handle, nbytes)
        if not ptr:
            raise MemoryError(f"arena_alloc({nbytes}) failed")
        buf = (ctypes.c_uint8 * nbytes).from_address(ptr)
        # the view chain arr -> buf -> arena keeps the slabs alive while
        # a view is outstanding
        buf._arena_keepalive = self
        arr = np.frombuffer(buf, dtype=np.uint8)
        self._live[arr.__array_interface__["data"][0]] = (ptr, nbytes)
        return arr

    def free(self, arr: np.ndarray) -> None:
        ptr, nbytes = self._live.pop(arr.__array_interface__["data"][0])
        self._lib.arena_free(self._handle, ptr, nbytes)

    def stats(self) -> Dict[str, int]:
        r, a, w = ctypes.c_size_t(), ctypes.c_size_t(), ctypes.c_size_t()
        self._lib.arena_stats(self._handle, ctypes.byref(r),
                              ctypes.byref(a), ctypes.byref(w))
        return {"reserved": r.value, "allocated": a.value,
                "watermark": w.value}

    def close(self) -> None:
        if self._handle is None:
            return
        if self._live:
            # freeing the slabs would leave the outstanding views dangling
            raise RuntimeError(
                f"HostArena.close with {len(self._live)} live allocations")
        self._lib.arena_destroy(self._handle)
        self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            # live views hold a reference to the arena, so this is not
            # reached with allocations outstanding; anything else leaks
            pass


# ------------------------------------------------------- frame serializer --

# dtype codes of the frame format (part of the on-disk format: the JAX
# package's numbering); strings travel as uint8 chars plus int32 offsets
DTYPE_CODES = {
    "boolean": 1, "tinyint": 2, "smallint": 3, "int": 4, "bigint": 5,
    "float": 6, "double": 7, "string": 8, "date": 9, "timestamp": 10,
}
CODE_TO_DTYPE = {v: k for k, v in DTYPE_CODES.items()}

FRAME_MAGIC = 0x31464354  # 'TCF1'


def dtype_code(dt) -> int:
    """Frame dtype code of a DataType (0 = unknown)."""
    return DTYPE_CODES.get(getattr(dt, "name", str(dt)), 0)


def codec_level(name: str) -> int:
    """Conf codec name -> frame codec level (0 raw, 1 zrle, 2 zrle+lzb);
    "zstd" is an alias of the strongest level."""
    levels = {"none": 0, "zrle": 1, "lz4": 2, "zstd": 2}
    if name not in levels:
        raise ValueError(f"unknown compression codec {name!r}")
    return levels[name]


def _as_bytes(a: Optional[np.ndarray]) -> Optional[np.ndarray]:
    if a is None:
        return None
    return np.ascontiguousarray(a).view(np.uint8).reshape(-1)


def serialize_batch(nrows: int,
                    columns: Sequence[Tuple[int, Optional[np.ndarray],
                                            Optional[np.ndarray],
                                            Optional[np.ndarray]]],
                    level: int = 2) -> bytes:
    """One frame of ``columns``, each (dtype_code, data, validity,
    offsets) with None or an empty array for an absent buffer, at codec
    ``level``."""
    lib = _load()
    ncols = len(columns)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    bufs = (u8p * (3 * ncols))()
    lens = (ctypes.c_uint64 * (3 * ncols))()
    keepalive = []
    for c, (_, data, validity, offsets) in enumerate(columns):
        for k, a in enumerate((data, validity, offsets)):
            a = _as_bytes(a)
            if a is None or a.size == 0:
                bufs[3 * c + k] = None
                lens[3 * c + k] = 0
            else:
                keepalive.append(a)
                bufs[3 * c + k] = a.ctypes.data_as(u8p)
                lens[3 * c + k] = a.nbytes
    codes = (ctypes.c_uint8 * ncols)(*[c[0] for c in columns])
    out_len = ctypes.c_uint64()
    frame = lib.frame_serialize(nrows, ncols, bufs, lens, codes,
                                int(level), ctypes.byref(out_len))
    try:
        return ctypes.string_at(lib.frame_data(frame), out_len.value)
    finally:
        lib.frame_release(frame)


def deserialize_batch(blob: bytes, max_cols: int = 4096
                      ) -> Tuple[int, List[Tuple[int, Optional[np.ndarray],
                                                 Optional[np.ndarray],
                                                 Optional[np.ndarray]]]]:
    """(nrows, [(dtype_code, data, validity, offsets)]) of a frame, each
    buffer raw uint8 (None when absent); raises ValueError on a corrupt
    or truncated frame."""
    lib = _load()
    src = np.frombuffer(blob, dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    srcp = src.ctypes.data_as(u8p)
    nrows = ctypes.c_uint64()
    ncols = ctypes.c_uint32()
    lens = (ctypes.c_uint64 * (3 * max_cols))()
    codes = (ctypes.c_uint8 * max_cols)()
    off = lib.frame_header(srcp, len(blob), ctypes.byref(nrows),
                           ctypes.byref(ncols), lens, codes, max_cols)
    if off < 0:
        raise ValueError(f"bad frame (err {off})")
    nc = ncols.value
    outs: List[Optional[np.ndarray]] = []
    dst = (u8p * (3 * nc))()
    for i in range(3 * nc):
        if lens[i] == 0:
            outs.append(None)
            dst[i] = None
        else:
            try:
                a = np.empty(lens[i], dtype=np.uint8)
            except (MemoryError, ValueError, OverflowError) as e:
                # a flipped bit in a length field: no real frame
                # decodes to this much
                raise ValueError(
                    f"bad frame: buffer length {lens[i]}") from e
            outs.append(a)
            dst[i] = a.ctypes.data_as(u8p)
    rc = lib.frame_deserialize(srcp, len(blob), dst, lens, nc, off)
    if rc != 0:
        raise ValueError(f"frame payload corrupt (err {rc})")
    return nrows.value, [(codes[c], outs[3 * c], outs[3 * c + 1],
                          outs[3 * c + 2]) for c in range(nc)]


# ------------------------------------------------- the plain Python codec --

def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _get_varint(src: bytes, p: int, end: int) -> Tuple[int, int]:
    v, shift = 0, 0
    while p < end and src[p] & 0x80:
        v |= (src[p] & 0x7F) << shift
        p += 1
        shift += 7
        if shift > 63:
            raise ValueError("varint overflow")
    if p >= end:
        raise ValueError("truncated varint")
    return v | (src[p] << shift), p + 1


def _zrle_encode(src: np.ndarray) -> Optional[bytes]:
    """zero runs as (0x00, varint len), other runs as (0x01, varint len,
    bytes); None when the encoding is not smaller."""
    n = src.size
    zero = src == 0
    edges = np.flatnonzero(np.diff(zero.view(np.int8))) + 1
    starts = np.concatenate([[0], edges])
    ends = np.concatenate([edges, [n]])
    out = bytearray()
    for s, e in zip(starts.tolist(), ends.tolist()):
        if zero[s]:
            out += b"\x00" + _varint(e - s)
        else:
            out += b"\x01" + _varint(e - s) + src[s:e].tobytes()
        if len(out) >= n:
            return None
    return bytes(out) if len(out) < n else None


def _zrle_decode(src: bytes, n: int) -> bytes:
    out = bytearray()
    p, end = 0, len(src)
    while p < end and len(out) < n:
        tag = src[p]
        length, p = _get_varint(src, p + 1, end)
        if length > n - len(out):
            raise ValueError("zrle run past the buffer")
        if tag == 0:
            out += bytes(length)
        else:
            if length > end - p:
                raise ValueError("zrle literal past the input")
            out += src[p:p + length]
            p += length
    if len(out) != n:
        raise ValueError("zrle stream under-fills the buffer")
    return bytes(out)


def _lzb_encode(src: bytes) -> Optional[bytes]:
    """Greedy LZ4-class encoding (the C++ ``lzb_encode`` step for step);
    None when it is not smaller."""
    n = len(src)
    if n < 16:
        return None
    hbits = 13
    head = [-1] * (1 << hbits)
    out = bytearray()
    i = anchor = 0
    while i + 4 <= n:
        v = int.from_bytes(src[i:i + 4], "little")
        h = ((v * 2654435761) & 0xFFFFFFFF) >> (32 - hbits)
        cand = head[h]
        head[h] = i
        if cand >= 0 and i - cand <= 0xFFFF and \
                src[cand:cand + 4] == src[i:i + 4]:
            m = 4
            while i + m < n and src[cand + m] == src[i + m]:
                m += 1
            lit, ml = i - anchor, m - 4
            out.append((min(lit, 15) << 4) | min(ml, 15))
            if lit >= 15:
                out += _varint(lit - 15)
            out += src[anchor:i]
            off = i - cand
            out += bytes((off & 0xFF, off >> 8))
            if ml >= 15:
                out += _varint(ml - 15)
            i += m
            anchor = i
            if len(out) >= n:
                return None
            continue
        i += 1
    lit = n - anchor
    out.append(min(lit, 15) << 4)
    if lit >= 15:
        out += _varint(lit - 15)
    out += src[anchor:n]
    out += b"\x00\x00"
    return bytes(out) if len(out) < n else None


def _lzb_decode(src: bytes, n: int) -> bytes:
    out = bytearray()
    p, end = 0, len(src)
    while p < end:
        tok = src[p]
        p += 1
        lit = tok >> 4
        if lit == 15:
            ext, p = _get_varint(src, p, end)
            lit += ext
        if lit > n - len(out) or lit > end - p:
            raise ValueError("lzb literal out of bounds")
        out += src[p:p + lit]
        p += lit
        if end - p < 2:
            raise ValueError("lzb stream truncated")
        off = src[p] | (src[p + 1] << 8)
        p += 2
        if off == 0:
            if len(out) != n:
                raise ValueError("lzb stream under-fills the buffer")
            return bytes(out)
        ml = tok & 15
        if ml == 15:
            ext, p = _get_varint(src, p, end)
            ml += ext
        ml += 4
        if off > len(out) or ml > n - len(out):
            raise ValueError("lzb match out of bounds")
        for _ in range(ml):  # overlap-safe byte copy
            out.append(out[-off])
    raise ValueError("lzb stream ended before its end marker")


def py_serialize_batch(nrows: int, columns, level: int = 2) -> bytes:
    """The plain Python version of ``serialize_batch``: the same bytes."""
    head = bytearray()
    head += FRAME_MAGIC.to_bytes(4, "little")
    head += len(columns).to_bytes(4, "little")
    head += int(nrows).to_bytes(8, "little")
    bufs = []
    for code, data, validity, offsets in columns:
        parts = [_as_bytes(a) for a in (data, validity, offsets)]
        parts = [None if a is None or a.size == 0 else a for a in parts]
        flags = (1 if parts[1] is not None else 0) | \
            (2 if parts[2] is not None else 0)
        head += bytes((code, flags))
        for a in parts:
            head += (0 if a is None else a.size).to_bytes(8, "little")
        bufs.extend(parts)
    body = bytearray()
    for a in bufs:
        if a is None:
            continue
        n = a.size
        z = _zrle_encode(a) if level >= 1 and n >= 64 else None
        lz = _lzb_encode(a.tobytes()) if level >= 2 and n >= 64 else None
        if lz is not None and (z is None or len(lz) < len(z)):
            body += b"\x02" + len(lz).to_bytes(8, "little") + lz
        elif z is not None:
            body += b"\x01" + len(z).to_bytes(8, "little") + z
        else:
            body += b"\x00" + n.to_bytes(8, "little") + a.tobytes()
    return bytes(head + body)


def py_deserialize_batch(blob: bytes):
    """The plain Python version of ``deserialize_batch``."""
    if len(blob) < 16:
        raise ValueError("bad frame (err -1)")
    if int.from_bytes(blob[:4], "little") != FRAME_MAGIC:
        raise ValueError("bad frame (err -2)")
    nc = int.from_bytes(blob[4:8], "little")
    nrows = int.from_bytes(blob[8:16], "little")
    if len(blob) < 16 + 26 * nc:
        raise ValueError("bad frame (err -4)")
    codes, lens, p = [], [], 16
    for _ in range(nc):
        codes.append(blob[p])
        lens.extend(int.from_bytes(blob[p + 2 + 8 * k:p + 10 + 8 * k],
                                   "little") for k in range(3))
        p += 26
    outs: List[Optional[np.ndarray]] = []
    for n in lens:
        if n == 0:
            outs.append(None)
            continue
        if len(blob) - p < 9:
            raise ValueError("frame payload corrupt (err -1)")
        codec = blob[p]
        enc = int.from_bytes(blob[p + 1:p + 9], "little")
        p += 9
        if enc > len(blob) - p:
            raise ValueError("frame payload corrupt (err -2)")
        chunk = blob[p:p + enc]
        if codec == 0:
            if enc != n:
                raise ValueError("frame payload corrupt (err -3)")
            raw = chunk
        elif codec == 1:
            raw = _zrle_decode(chunk, n)
        elif codec == 2:
            raw = _lzb_decode(chunk, n)
        else:
            raise ValueError("frame payload corrupt (err -6)")
        outs.append(np.frombuffer(raw, dtype=np.uint8).copy())
        p += enc
    return nrows, [(codes[c], outs[3 * c], outs[3 * c + 1],
                    outs[3 * c + 2]) for c in range(nc)]


# ------------------------------------------------------------ spill pager --

def write_spill_file(path: str, blob: bytes) -> int:
    lib = _load()
    src = np.frombuffer(blob, dtype=np.uint8)
    n = lib.pager_write(path.encode(), src.ctypes.data_as(
        ctypes.POINTER(ctypes.c_uint8)), len(blob))
    if n < 0:
        raise OSError(f"pager_write({path}) failed: {n}")
    return int(n)


def read_spill_file(path: str) -> bytes:
    lib = _load()
    size = lib.pager_file_size(path.encode())
    if size < 0:
        raise FileNotFoundError(path)
    dst = np.empty(size, dtype=np.uint8)
    n = lib.pager_read(path.encode(), dst.ctypes.data_as(
        ctypes.POINTER(ctypes.c_uint8)), size)
    if n != size:
        raise OSError(f"pager_read({path}) short read: {n} of {size}")
    return dst.tobytes()


# ------------------------------------------------------------- prefetcher --

class FilePrefetcher:
    """Background whole-file reads on the runtime's own threads (the IO
    runs without the GIL); ``get(i)`` waits for the i-th submitted path,
    in any order."""

    def __init__(self, nthreads: int = 4):
        self._lib = _load()
        self._handle = self._lib.prefetcher_create(nthreads)
        self._paths: List[str] = []

    def submit(self, paths: Sequence[str]) -> None:
        self._paths.extend(paths)
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._lib.prefetcher_submit(self._handle, arr, len(paths))

    def get(self, idx: int) -> bytes:
        n = self._lib.prefetcher_wait(self._handle, idx)
        if n < 0:
            raise OSError(f"prefetch of {self._paths[idx]} failed")
        out = ctypes.string_at(self._lib.prefetcher_data(self._handle, idx),
                               n)
        self._lib.prefetcher_release(self._handle, idx)
        return out

    def close(self) -> None:
        if self._handle is not None:
            self._lib.prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
