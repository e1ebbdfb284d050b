"""Bucketed table layout: write-side bucket assignment and read-side
pruning.

Counterpart of ``spark_rapids_tpu/io/bucketing.py``, kept value for value
so that files either package writes prune correctly when the other reads
them.  Without a metastore the spec travels as a ``_bucket_spec.json``
sidecar in the table directory:

    {"column": "k", "num_buckets": 8, "version": 1}

Write: rows hash-route to ``part-bucket-NNNNN.<fmt>`` files.  Read: an
equality filter on the bucket column prunes the scan to one file.  The
hash is a fixed fmix32 (the murmur3 finalizer) over a canonical float64
image of numbers and over the UTF-8 words of strings.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np

SPEC_FILE = "_bucket_spec.json"


def _fmix32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32, copy=True)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return x


def bucket_ids(values: np.ndarray, num_buckets: int) -> np.ndarray:
    """Vectorized bucket assignment for an int/float/bool/string host
    array.  Nulls (None/NaN) go to bucket 0.

    Numerics hash under a canonical float64 representation so the
    bucket of a value never depends on the numpy dtype it happens to
    arrive in (int64 5, float64 5.0, and a nullable-int column gone
    float at write time all land in the same bucket)."""
    if values.dtype.kind in ("O", "U", "S"):
        # pack utf-8 bytes into a rows x words uint32 matrix and fold
        # word-columns through fmix: the loop is over WORD POSITIONS of
        # the longest string, each step vectorized across all rows
        enc = [b"" if v is None else str(v).encode("utf-8")
               for v in values]
        lens = np.array([len(b) for b in enc], dtype=np.uint32)
        width = max(int(lens.max(initial=0)), 1)
        words = -(-width // 4)
        mat = np.zeros((len(enc), words * 4), dtype=np.uint8)
        for i, b in enumerate(enc):
            mat[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
        u32 = mat.reshape(len(enc), words, 4).astype(np.uint32)
        folded = (u32[..., 0] | (u32[..., 1] << np.uint32(8)) |
                  (u32[..., 2] << np.uint32(16)) |
                  (u32[..., 3] << np.uint32(24)))
        h = lens.copy()
        for w in range(words):
            h = _fmix32(h ^ folded[:, w])
        return (h % np.uint32(num_buckets)).astype(np.int64)
    v = values.astype(np.float64, copy=True)
    # canonicalize -0.0 and NaN like the device partitioner
    v[np.isnan(v)] = 0.0
    v = v + 0.0
    bits = v.view(np.uint64)
    mixed = _fmix32((bits & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                    ^ (bits >> np.uint64(32)).astype(np.uint32))
    return (mixed % np.uint32(num_buckets)).astype(np.int64)


def bucket_id_of(value, num_buckets: int) -> int:
    """Scalar wrapper used by read-side pruning."""
    return int(bucket_ids(np.array([value]), num_buckets)[0])


def write_spec(dir_path: str, column: str, num_buckets: int) -> None:
    with open(os.path.join(dir_path, SPEC_FILE), "w") as f:
        json.dump({"column": column, "num_buckets": num_buckets,
                   "version": 1}, f)


def read_spec(path: str) -> Optional[dict]:
    """Bucket spec of a table directory, or None."""
    if not os.path.isdir(path):
        return None
    spec_path = os.path.join(path, SPEC_FILE)
    if not os.path.exists(spec_path):
        return None
    with open(spec_path) as f:
        spec = json.load(f)
    if spec.get("version") != 1 or "column" not in spec \
            or "num_buckets" not in spec:
        return None
    return spec


def bucket_file(dir_path: str, bucket: int, file_format: str) -> str:
    return os.path.join(dir_path,
                        f"part-bucket-{bucket:05d}.{file_format}")


def prune_paths(paths: List[str], spec: dict, file_format: str,
                literal_value) -> Tuple[List[str], int]:
    """Paths for the single bucket that can contain literal_value.
    Returns (paths, bucket_id); missing files (empty buckets) drop out."""
    b = bucket_id_of(literal_value, spec["num_buckets"])
    f = bucket_file(paths[0], b, file_format)
    return ([f] if os.path.exists(f) else []), b
