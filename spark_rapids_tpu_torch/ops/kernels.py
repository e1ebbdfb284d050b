"""The engine's hand-written GPU kernels and their plain versions.

Counterpart of ``spark_rapids_tpu/ops/pallas_kernels.py``.  Each kernel is
CUDA C++ under ``spark_rapids_tpu_torch/csrc/``, compiled for ``sm_90a``
with ``nvcc`` at first use into one shared library with a plain C
interface (``_build/``, listed in ``.gitignore``) and called through
``ctypes`` on PyTorch's current stream.  Beside each kernel sits a plain
PyTorch version with the same contract.

Dispatch: a wrapper takes the plain version only because the tensors it
was given lie on the CPU (the tests).  For CUDA tensors it launches the
kernel or raises; nothing falls back.

- ``masked_multi_reduce``: per column, the sum of the values where
  ``mask & validity`` and the count of those rows, in one pass.  The JAX
  package reaches its Pallas kernel only on a TPU and only with
  ``SPARK_RAPIDS_TPU_PALLAS_REDUCE`` set, because float64 lowering in
  Pallas on a TPU was unproven.  An H100 has native float64, so here the
  same condition applies without the environment variable: every buffer
  of a keyless aggregation is a float ``sum`` and the tensors are on
  CUDA.  That puts the kernel on TPC-H q6's path by default
  (``ops/aggregates.reduce_aggregate``).  The kernel reads the mask 16
  bytes a lane, loads only the passing rows' values, and merges its block
  partials in the same launch: the last block to take a ticket (an int32
  word per device and stream, made zero once and left zero by the
  kernel) adds them in block order.  The wrapper computes the mask's
  scalar head, 16-byte body and tail (:func:`mmr_split`) and a one-wave
  grid (:func:`mmr_grid`).  The summation order, and so the last bits of
  a sum, depends on the mask's address modulo 16 besides ``n``, the
  column count and the card; the engine's masks are fresh, aligned
  tensors.
- ``hash_insert``: open-addressing insert of 64-bit codes carried as two
  int32 lanes, the hashed group-by's directory
  (``ops/aggregates.groupby_aggregate_hashed``).  Only the set of stored
  codes is contractual; the kernel (parallel linear probing) and the plain
  version (the JAX package's salted sub-table cascade) lay tables out
  differently.  The kernel's table is one int64 word a slot
  (``csrc/hash_common.cuh``: empty slots hold :data:`HASH_EMPTY`, the key
  equal to it sits at a reserved slot), and the ``table_lo`` /
  ``table_hi`` it returns are strided views of those words.
- ``hash_probe``: for each live row, the slot of a ``hash_insert`` table
  holding its code, or ``T`` on a miss; the probe half of the single-key
  equi-join's hash phase A (``ops/joins.hash_join_match``).  A table is
  valid only against the probe of its own pair: the CUDA probe walks the
  CUDA insert's linear-probing layout, the plain probe the plain insert's
  cascade.  Both wrappers follow the tensors' device, so a table and its
  probe always come from the same pair.  The CUDA probe reads the words
  under the two lane views; lanes handed as two separate arrays are
  packed into words first (:func:`packed_table`).
- ``partition_histogram``: per destination, the number of live rows whose
  partition id is that destination; it sizes every exchange of the
  sharded query path (``parallel/partitioning.layout_by_partition`` and
  the stats passes of ``parallel/distributed.py`` and
  ``parallel/distsort.py``), through the dispatcher :func:`histogram`.

Each wrapper adds one to ``launches`` where it calls into the library,
and nowhere else, under its kernel's name and the shape of the call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch

MAX_PROBE = 256
# The word of an empty slot in the CUDA insert's table, 0x8080808080808080
# as int64 (csrc/hash_common.cuh).  A code equal to it is stored all the
# same, at a reserved slot.
HASH_EMPTY = -0x7F7F7F7F7F7F7F80
_MMR_MAX_COLS = 8
_MMR_WARPS = 8          # csrc/masked_multi_reduce.cu: 256 threads a block
_MMR_TILE_WORDS = 32    # 16-byte mask words (512 rows) a warp tile
_U32 = 0xFFFFFFFF

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC"]


class KernelLaunches:
    """Process-wide launch counts, one plain integer per kernel, and the
    same launches split by the shape of the call (a short string such as
    ``"n=4194304 T=2097152"``)."""

    NAMES = ("masked_multi_reduce", "hash_insert", "hash_probe",
             "partition_histogram")

    def __init__(self):
        self._lock = threading.Lock()
        self.counts = {k: 0 for k in self.NAMES}
        self.by_shape = {k: {} for k in self.NAMES}

    def bump(self, name: str, shape: str) -> None:
        with self._lock:
            self.counts[name] += 1
            shapes = self.by_shape[name]
            shapes[shape] = shapes.get(shape, 0) + 1

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.counts)

    def shape_snapshot(self) -> dict:
        with self._lock:
            return {k: dict(v) for k, v in self.by_shape.items()}

    def reset(self) -> None:
        with self._lock:
            for k in self.counts:
                self.counts[k] = 0
                self.by_shape[k] = {}


launches = KernelLaunches()


# ------------------------------------------------------------ the library --

class _KernelLibrary:
    """Builds ``csrc/*.cu`` into one shared library on first use and loads
    it.  The build directory is keyed by a hash of the sources and flags,
    so a stale library is never loaded.  Sources compile in parallel (one
    ``nvcc -c`` each), then link with ``nvcc -shared``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib = None
        self.build_seconds: Optional[float] = None
        self.path: Optional[Path] = None

    def _nvcc(self) -> str:
        found = shutil.which("nvcc")
        if found:
            return found
        cand = Path("/usr/local/cuda/bin/nvcc")
        if cand.exists():
            return str(cand)
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "spark_rapids_tpu_torch need the CUDA toolkit")

    def _sources(self) -> List[Path]:
        return sorted(_CSRC.glob("*.cu"))

    def _digest(self, sources) -> str:
        h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
        for src in sorted(sources + list(_CSRC.glob("*.cuh"))):
            h.update(src.name.encode())
            h.update(src.read_bytes())
        return h.hexdigest()[:16]

    def _build(self) -> Path:
        sources = self._sources()
        out_dir = _BUILD / self._digest(sources)
        lib_path = out_dir / "libsrt_kernels.so"
        if lib_path.exists():
            self.build_seconds = 0.0
            return lib_path
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = self._nvcc()
        t0 = time.perf_counter()
        procs = []
        objs = []
        for src in sources:
            obj = out_dir / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *_NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for src, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"{src.name}:\n{out.decode(errors='replace')}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp = out_dir / f"libsrt_kernels.{os.getpid()}.so"
        link = subprocess.run(
            [nvcc, *_NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n"
                               + link.stdout.decode(errors="replace"))
        os.replace(tmp, lib_path)
        self.build_seconds = time.perf_counter() - t0
        return lib_path

    def get(self):
        with self._lock:
            if self._lib is None:
                self.path = self._build()
                lib = ctypes.CDLL(str(self.path))
                vp = ctypes.c_void_p
                ll = ctypes.c_longlong
                lib.srt_masked_multi_reduce.argtypes = [
                    ctypes.POINTER(vp), ctypes.POINTER(vp), ctypes.c_int,
                    vp, ll, ll, ll, ctypes.c_int, vp, vp, vp, vp, vp, vp]
                lib.srt_masked_multi_reduce.restype = ctypes.c_int
                lib.srt_mmr_blocks_per_sm.argtypes = [ctypes.c_int]
                lib.srt_mmr_blocks_per_sm.restype = ctypes.c_int
                lib.srt_hash_insert.argtypes = [
                    vp, vp, vp, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_int, vp, vp, vp, vp, vp]
                lib.srt_hash_insert.restype = ctypes.c_int
                lib.srt_hash_probe.argtypes = [
                    vp, vp, vp, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_int, vp, vp, vp, vp]
                lib.srt_hash_probe.restype = ctypes.c_int
                lib.srt_partition_histogram.argtypes = [
                    vp, vp, ctypes.c_longlong, ctypes.c_int, vp,
                    ctypes.c_int, vp]
                lib.srt_partition_histogram.restype = ctypes.c_int
                lib.srt_partition_histogram_max_parts.argtypes = []
                lib.srt_partition_histogram_max_parts.restype = ctypes.c_int
                self._lib = lib
            return self._lib


_LIBRARY = _KernelLibrary()


def library():
    """The loaded kernel library (built from ``csrc/`` on first call)."""
    return _LIBRARY.get()


def build_seconds() -> Optional[float]:
    """Wall time of this process's kernel build (0.0 when a library
    built earlier from the same sources was reused; None before the
    first load)."""
    return _LIBRARY.build_seconds


def _check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


def _require(t: torch.Tensor, what: str, dtype, device, n=None) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous 1-D tensor")
    if n is not None and t.shape[0] != n:
        raise ValueError(f"{what} has {t.shape[0]} rows, expected {n}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_SM_COUNT = {}


def _sm_count(device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = \
            torch.cuda.get_device_properties(idx).multi_processor_count
    return _SM_COUNT[idx]


# ---------------------------------------------------- masked multi-reduce --

def masked_multi_reduce(values: Sequence[torch.Tensor],
                        validities: Sequence[Optional[torch.Tensor]],
                        mask: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per column c: (sum of ``values[c]`` where ``mask & validities[c]``,
    count of those rows) as ``(float64[N], int32[N])``.  ``values`` are
    float64, ``mask`` and each validity bool; a validity of None means all
    rows are valid.

    On CUDA, repeated calls on the same tensors give bit-identical sums.
    The kernel's summation order depends on ``n``, the column count, the
    card and the mask's address modulo 16 (the rows before its first
    16-byte boundary are the scalar head), so the same data in a view at
    another alignment may differ in the last bits.  The engine's masks are
    fresh tensors (a comparison or ``logical_and``), which PyTorch's
    allocator aligns to 512 bytes: there the order depends on ``n`` alone.
    """
    if len(values) != len(validities) or not values:
        raise ValueError("masked_multi_reduce needs one validity per value "
                         "column and at least one column")
    if mask.device.type == "cpu":
        return masked_multi_reduce_plain(values, validities, mask)
    return _masked_multi_reduce_cuda(values, validities, mask)


def masked_multi_reduce_plain(values, validities, mask):
    """Plain PyTorch version: ``torch.where`` plus ``sum`` per column (the
    JAX package's ``masked_multi_reduce_xla``)."""
    sums, cnts = [], []
    for v, ok in zip(values, validities):
        live = mask if ok is None else torch.logical_and(mask, ok)
        sums.append(torch.where(live, v.to(torch.float64),
                                torch.zeros((), dtype=torch.float64,
                                            device=v.device)).sum())
        cnts.append(live.sum(dtype=torch.int32))
    return torch.stack(sums), torch.stack(cnts)


def mmr_split(mask_addr: int, n: int) -> Tuple[int, int, int]:
    """``(head, nvec, tail)``: the kernel's scalar head (the rows before
    the mask's first 16-byte-aligned byte), its body of ``nvec`` 16-byte
    mask words (16 rows each), and its scalar tail (the rows after the
    last full word), for a mask of ``n`` bytes at address ``mask_addr``.
    head + 16 * nvec + tail == n, head and tail below 16."""
    head = min((-mask_addr) % 16, n)
    nvec = (n - head) // 16
    return head, nvec, n - head - 16 * nvec


def mmr_grid(nvec: int, sms: int, blocks_per_sm: int) -> int:
    """Blocks of the kernel's launch: one 512-row warp tile (32 mask
    words) a warp, as many warps as the card holds at once at most (one
    wave; the warps then stride over the tiles), and at least one block
    (the head and tail rows and the merge)."""
    tiles = -(-nvec // _MMR_TILE_WORDS)
    return max(1, min(-(-tiles // _MMR_WARPS), sms * blocks_per_sm))


class _MmrState:
    """Per device: the kernel instances' resident blocks an SM holds; per
    device and stream: the ticket word the kernel's last block resets
    (made zero once, so a call launches no fill of its own)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._blocks = {}
        self._tickets = {}

    def blocks_per_sm(self, lib, device, ncols: int) -> int:
        # the instance that serves ncols columns (csrc: 1, 4 or 8)
        key = (device.index, 1 if ncols <= 1 else 4 if ncols <= 4 else 8)
        with self._lock:
            if key not in self._blocks:
                with torch.cuda.device(device.index):
                    got = lib.srt_mmr_blocks_per_sm(ncols)
                if got < 1:
                    raise RuntimeError("masked_multi_reduce: occupancy "
                                       f"query failed on {device}")
                self._blocks[key] = got
            return self._blocks[key]

    def ticket(self, device, stream: int) -> torch.Tensor:
        key = (device.index, stream)
        with self._lock:
            if key not in self._tickets:
                self._tickets[key] = torch.zeros(1, dtype=torch.int32,
                                                 device=device)
            return self._tickets[key]


_MMR = _MmrState()


def _masked_multi_reduce_cuda(values, validities, mask):
    lib = library()
    device = mask.device
    if device.type != "cuda":
        raise ValueError(f"masked_multi_reduce: unsupported device {device}")
    n = mask.shape[0]
    _require(mask, "mask", torch.bool, device, n)
    for c, (v, ok) in enumerate(zip(values, validities)):
        _require(v, f"values[{c}]", torch.float64, device, n)
        if ok is not None:
            _require(ok, f"validities[{c}]", torch.bool, device, n)
    ncols = len(values)
    if n == 0:
        return (torch.zeros(ncols, dtype=torch.float64, device=device),
                torch.zeros(ncols, dtype=torch.int32, device=device))
    if n >= (1 << 31):
        raise ValueError("masked_multi_reduce counts are int32: "
                         f"{n} rows is too many for one call")
    head, nvec, _ = mmr_split(mask.data_ptr(), n)
    stream = _stream(device)
    ticket = _MMR.ticket(device, stream)
    sums, cnts = [], []
    for start in range(0, ncols, _MMR_MAX_COLS):
        vs = values[start:start + _MMR_MAX_COLS]
        oks = validities[start:start + _MMR_MAX_COLS]
        k = len(vs)
        nblocks = mmr_grid(nvec, _sm_count(device),
                           _MMR.blocks_per_sm(lib, device, k))
        psum = torch.empty(nblocks * k, dtype=torch.float64, device=device)
        pcnt = torch.empty(nblocks * k, dtype=torch.int32, device=device)
        out_sum = torch.empty(k, dtype=torch.float64, device=device)
        out_cnt = torch.empty(k, dtype=torch.int32, device=device)
        vptrs = (ctypes.c_void_p * k)(*[v.data_ptr() for v in vs])
        okptrs = (ctypes.c_void_p * k)(
            *[None if ok is None else ok.data_ptr() for ok in oks])
        err = lib.srt_masked_multi_reduce(
            vptrs, okptrs, k, mask.data_ptr(), n, head, nvec, nblocks,
            psum.data_ptr(), pcnt.data_ptr(), ticket.data_ptr(),
            out_sum.data_ptr(), out_cnt.data_ptr(), stream)
        launches.bump("masked_multi_reduce", f"n={n} cols={k}")
        _check_launch(err, "masked_multi_reduce")
        sums.append(out_sum)
        cnts.append(out_cnt)
    if len(sums) == 1:
        return sums[0], cnts[0]
    return torch.cat(sums), torch.cat(cnts)


# ------------------------------------------------------------- hash insert --

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32): split x into 16-bit
    halves so no int64 product overflows."""
    lo16 = x & 0xFFFF
    hi16 = x >> 16
    return (lo16 * c + (((hi16 * c) & 0xFFFF) << 16)) & _U32


def hash_index_plain(lo: torch.Tensor, hi: torch.Tensor, num_slots: int,
                     salt: int = 0) -> torch.Tensor:
    """murmur3 fmix32 over the two code lanes -> slot in [0, num_slots),
    bit for bit the JAX package's ``_hash_index``.  torch has few uint32
    ops, so the arithmetic runs in int64 masked to 32 bits after every
    multiply and shift; ``& 0xFFFFFFFF`` on the int64 view of a negative
    lane is its two's-complement uint32 value."""
    a = lo.to(torch.int64) & _U32
    b = hi.to(torch.int64) & _U32
    h = a ^ (salt & _U32) ^ _mul32(b, 0x85EBCA6B)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return (h & (num_slots - 1)).to(torch.int32)


_PLAIN_LEVELS = 6


def _plain_level_plan(num_slots: int):
    """[(offset, size)] of the plain version's sub-table cascade: T/2,
    T/4, ..., the last two equal, summing to exactly T."""
    if num_slots < 64 or num_slots & (num_slots - 1):
        raise ValueError(f"table slots must be a power of two >= 64, "
                         f"got {num_slots}")
    sizes = []
    s = num_slots // 2
    for _ in range(_PLAIN_LEVELS - 1):
        sizes.append(s)
        s //= 2
    sizes.append(sizes[-1])
    plan, off = [], 0
    for s in sizes:
        plan.append((off, s))
        off += s
    return plan


def _to_i32_wrapping(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> the int32 with the same low 32 bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def hash_insert(code_lo: torch.Tensor, code_hi: torch.Tensor,
                live: torch.Tensor, num_slots: int,
                max_probe: int = MAX_PROBE):
    """Insert each live row's code ``(hi << 32) | (lo & 0xFFFFFFFF)``.

    Returns ``(slot int32[n], table_lo int32[T], table_hi int32[T],
    occupied bool[T], overflow bool[])``.  Dead rows, and every row when
    ``overflow`` is set, may sit at ``slot == T``; on overflow the caller
    discards the whole output.  From the CUDA kernel, ``table_lo`` and
    ``table_hi`` are strided views of one int64 word a slot."""
    if num_slots < 1 or num_slots & (num_slots - 1):
        raise ValueError(f"num_slots must be a power of two, "
                         f"got {num_slots}")
    if live.device.type == "cpu":
        return hash_insert_plain(code_lo, code_hi, live, num_slots)
    return _hash_insert_cuda(code_lo, code_hi, live, num_slots, max_probe)


def _empty_table(n, T, device):
    return (torch.zeros(n, dtype=torch.int32, device=device),
            torch.zeros(T, dtype=torch.int32, device=device),
            torch.zeros(T, dtype=torch.int32, device=device),
            torch.zeros(T, dtype=torch.bool, device=device),
            torch.zeros((), dtype=torch.bool, device=device))


def hash_insert_plain(code_lo, code_hi, live, num_slots: int):
    """Plain PyTorch version: the JAX package's ``hash_insert_xla``.  Per
    level of the sub-table cascade every unresolved row scatter-writes its
    code into its salted-hash slot (any writer may win), then a gather
    checks which rows' codes were stored; those resolve, the rest descend
    a level.  A key still homeless after the last level sets overflow."""
    n = code_lo.shape[0]
    T = num_slots
    device = code_lo.device
    if n == 0:
        return _empty_table(0, T, device)
    lo = code_lo.to(torch.int64)
    hi = code_hi.to(torch.int64)
    code64 = (hi << 32) | (lo & _U32)
    t64 = torch.zeros(T + 1, dtype=torch.int64, device=device)
    slot = torch.where(live, torch.tensor(-1, device=device),
                       torch.tensor(T, device=device)).to(torch.int64)
    for lvl, (off, size) in enumerate(_plain_level_plan(T)):
        idx = off + hash_index_plain(code_lo, code_hi, size,
                                     salt=lvl * 0x9E3779B9).to(torch.int64)
        unresolved = slot < 0
        t64.index_put_((torch.where(unresolved, idx, T),), code64)
        placed = unresolved & (t64[idx] == code64)
        slot = torch.where(placed, idx, slot)
    overflow = (slot < 0).any()
    slot = torch.where(slot < 0, T, slot)
    occ = torch.zeros(T + 1, dtype=torch.bool, device=device)
    occ[slot] = True
    t64 = t64[:T]
    return (slot.to(torch.int32), _to_i32_wrapping(t64 & _U32),
            (t64 >> 32).to(torch.int32), occ[:T], overflow)


def _hash_insert_cuda(code_lo, code_hi, live, num_slots: int,
                      max_probe: int):
    lib = library()
    device = live.device
    if device.type != "cuda":
        raise ValueError(f"hash_insert: unsupported device {device}")
    n = live.shape[0]
    _require(code_lo, "code_lo", torch.int32, device, n)
    _require(code_hi, "code_hi", torch.int32, device, n)
    _require(live, "live", torch.bool, device, n)
    T = num_slots
    if T >= (1 << 31):
        raise ValueError(f"hash_insert: {T} slots do not fit int32 slots")
    if max_probe < 1:
        raise ValueError(f"hash_insert: max_probe must be positive, "
                         f"got {max_probe}")
    slot = torch.empty(n, dtype=torch.int32, device=device)
    words = torch.empty(T, dtype=torch.int64, device=device)
    occ = torch.empty(T, dtype=torch.bool, device=device)
    flags = torch.empty(2, dtype=torch.bool, device=device)
    # n == 0 still launches: the probe needs a cleared table
    err = lib.srt_hash_insert(
        code_lo.data_ptr(), code_hi.data_ptr(), live.data_ptr(), n, T,
        max_probe, slot.data_ptr(), words.data_ptr(), occ.data_ptr(),
        flags.data_ptr(), _stream(device))
    launches.bump("hash_insert", f"n={n} T={T}")
    _check_launch(err, "hash_insert")
    tlo, thi = lane_views(words)
    return slot, tlo, thi, occ, flags[0]


def lane_views(words: torch.Tensor):
    """``(lo, hi)``: int32 views of int64 table words (little-endian, so
    lo is the first int32 of each word), strided by two."""
    lanes = words.view(torch.int32).view(words.shape[0], 2)
    return lanes[:, 0], lanes[:, 1]


def packed_table(table_lo: torch.Tensor,
                 table_hi: torch.Tensor) -> torch.Tensor:
    """The int64 words (``(hi << 32) | (lo & 0xFFFFFFFF)``) under a
    table's two lanes: the words themselves, without a copy, when the
    lanes are the views that the CUDA insert returns (:func:`lane_views`);
    otherwise a packed copy (one ``torch.stack``)."""
    T = table_lo.shape[0]
    if (table_lo.dim() == 1 and table_hi.shape == table_lo.shape
            and table_lo.stride() == (2,) and table_hi.stride() == (2,)
            and table_lo.storage_offset() % 2 == 0
            and table_hi.storage_offset() == table_lo.storage_offset() + 1
            and table_lo.untyped_storage().data_ptr()
            == table_hi.untyped_storage().data_ptr()):
        return torch.as_strided(table_lo, (T, 2), (2, 1)).view(
            torch.int64).view(T)
    return torch.stack([table_lo, table_hi], dim=1).view(torch.int64).view(T)


# -------------------------------------------------------------- hash probe --

def hash_probe(code_lo: torch.Tensor, code_hi: torch.Tensor,
               live: torch.Tensor, table_lo: torch.Tensor,
               table_hi: torch.Tensor, occupied: torch.Tensor,
               max_probe: int = MAX_PROBE) -> torch.Tensor:
    """Slot (int32[n]) of a ``hash_insert`` table holding each live row's
    code ``(hi << 32) | (lo & 0xFFFFFFFF)``, or ``T`` on a miss and for
    dead rows.  The table must come from :func:`hash_insert` on the same
    device (the pairs lay tables out differently).  On CUDA the kernel
    reads the int64 words under the lanes (:func:`packed_table`): the
    insert's own lane views cost nothing, separate lane arrays one pack."""
    if live.device.type == "cpu":
        return hash_probe_plain(code_lo, code_hi, live, table_lo, table_hi,
                                occupied)
    return _hash_probe_cuda(code_lo, code_hi, live, table_lo, table_hi,
                            occupied, max_probe)


def hash_probe_plain(code_lo, code_hi, live, table_lo, table_hi, occupied):
    """Plain PyTorch version: the JAX package's ``hash_probe_xla``.  One
    salted-hash lookup per level of the plain insert's cascade; a stored
    code sits at exactly the level that stored it, so the levels OR
    together.  Valid only against a table from :func:`hash_insert_plain`."""
    T = occupied.shape[0]
    code64 = (code_hi.to(torch.int64) << 32) | (code_lo.to(torch.int64)
                                                & _U32)
    t64 = (table_hi.to(torch.int64) << 32) | (table_lo.to(torch.int64)
                                              & _U32)
    slot = torch.full((code_lo.shape[0],), T, dtype=torch.int64,
                      device=code_lo.device)
    for lvl, (off, size) in enumerate(_plain_level_plan(T)):
        idx = off + hash_index_plain(code_lo, code_hi, size,
                                     salt=lvl * 0x9E3779B9).to(torch.int64)
        hit = live & occupied[idx] & (t64[idx] == code64)
        slot = torch.where(hit, idx, slot)
    return slot.to(torch.int32)


def _hash_probe_cuda(code_lo, code_hi, live, table_lo, table_hi, occupied,
                     max_probe: int):
    lib = library()
    device = live.device
    if device.type != "cuda":
        raise ValueError(f"hash_probe: unsupported device {device}")
    n = live.shape[0]
    T = occupied.shape[0]
    _require(code_lo, "code_lo", torch.int32, device, n)
    _require(code_hi, "code_hi", torch.int32, device, n)
    _require(live, "live", torch.bool, device, n)
    _require(occupied, "occupied", torch.bool, device, T)
    for what, t in (("table_lo", table_lo), ("table_hi", table_hi)):
        if t.device != device or t.dtype != torch.int32 \
                or t.shape != (T,):
            raise ValueError(f"hash_probe: {what} must be int32[{T}] on "
                             f"{device}")
    if T < 1 or T & (T - 1) or T >= (1 << 31):
        raise ValueError(f"hash_probe: table of {T} slots is not a power "
                         "of two below 2^31")
    if max_probe < 1:
        raise ValueError(f"hash_probe: max_probe must be positive, "
                         f"got {max_probe}")
    slot = torch.empty(n, dtype=torch.int32, device=device)
    if n == 0:
        return slot
    words = packed_table(table_lo, table_hi)
    err = lib.srt_hash_probe(
        code_lo.data_ptr(), code_hi.data_ptr(), live.data_ptr(), n, T,
        max_probe, words.data_ptr(), occupied.data_ptr(), slot.data_ptr(),
        _stream(device))
    launches.bump("hash_probe", f"n={n} T={T}")
    _check_launch(err, "hash_probe")
    return slot


# ----------------------------------------------------- partition histogram --

_PH_THREADS = 256


def partition_histogram(pids: torch.Tensor, mask: torch.Tensor,
                        num_parts: int) -> torch.Tensor:
    """counts[p] (int32[num_parts]) = number of rows with ``pids[i] == p``
    and ``mask[i]``.  ``pids`` int32, ``mask`` bool, of one length; a pid
    outside ``[0, num_parts)`` is counted nowhere."""
    if num_parts < 1:
        raise ValueError(f"num_parts must be positive, got {num_parts}")
    if mask.device.type == "cpu":
        return partition_histogram_plain(pids, mask, num_parts)
    return _partition_histogram_cuda(pids, mask, num_parts)


def partition_histogram_plain(pids, mask, num_parts: int):
    """Plain PyTorch version, the contract of the JAX package's non-TPU
    ``histogram`` branch: ``index_add_`` of ones onto
    ``where(mask & (0 <= pid < num_parts), pid, num_parts)``, then the
    last (trash) bin dropped."""
    p = pids.to(torch.int64)
    ok = mask & (p >= 0) & (p < num_parts)
    key = torch.where(ok, p, num_parts)
    counts = torch.zeros(num_parts + 1, dtype=torch.int32,
                         device=pids.device)
    counts.index_add_(0, key, torch.ones_like(key, dtype=torch.int32))
    return counts[:num_parts]


_PH_MAX_PARTS = {}


def _partition_histogram_cuda(pids, mask, num_parts: int):
    lib = library()
    device = mask.device
    if device.type != "cuda":
        raise ValueError(f"partition_histogram: unsupported device {device}")
    n = mask.shape[0]
    _require(pids, "pids", torch.int32, device, n)
    _require(mask, "mask", torch.bool, device, n)
    if n >= (1 << 31):
        raise ValueError("partition_histogram counts are int32: "
                         f"{n} rows is too many for one call")
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _PH_MAX_PARTS:
        with torch.cuda.device(idx):
            _PH_MAX_PARTS[idx] = lib.srt_partition_histogram_max_parts()
    if num_parts > _PH_MAX_PARTS[idx]:
        raise ValueError(
            f"partition_histogram: {num_parts} bins do not fit one block's "
            f"shared memory (at most {_PH_MAX_PARTS[idx]} on {device})")
    out = torch.zeros(num_parts, dtype=torch.int32, device=device)
    if n == 0:
        return out
    blocks = max(1, min(-(-n // (4 * _PH_THREADS)), 8 * _sm_count(device)))
    err = lib.srt_partition_histogram(
        pids.data_ptr(), mask.data_ptr(), n, num_parts, out.data_ptr(),
        blocks, _stream(device))
    launches.bump("partition_histogram", f"n={n} parts={num_parts}")
    _check_launch(err, "partition_histogram")
    return out


def histogram(pids: torch.Tensor, mask: torch.Tensor,
              num_parts: int) -> torch.Tensor:
    """Partition counts for the sharded path's callers (the JAX package's
    dispatcher of the same name): :func:`partition_histogram`, the
    hand-written kernel for CUDA tensors and its plain version for CPU
    tensors."""
    return partition_histogram(pids.to(torch.int32).contiguous(),
                               mask.contiguous(), num_parts)
