"""Host-side string key encoding.

Counterpart of ``spark_rapids_tpu/ops/dictionary.py``: string group, sort
and join keys become integer codes on the host, and the device kernels see
plain integers.  A string column's offsets, chars and validity come to the
host through :func:`host_strings` in one counted sync
(``utils/hostsync.fetch``); the encoders then work on those numpy buffers:

* :func:`row_byte_matrix`: a zero-padded ``(nrows, width + 4)`` byte
  matrix of every row's UTF-8 bytes plus a big-endian length tail, whose
  row-wise lexicographic order is Spark's string order;
* :func:`rank_encode`: order-preserving dense int32 ranks (sort keys);
* :func:`ordered_dict_encode`: order-preserving codes plus the sorted
  distinct values (string min/max);
* :func:`dict_encode_stable`: codes stable across batches, the first
  appearance of a value fixing its code (group-by and join keys).

Arrow's hash dictionary encode and its sort over the distinct values do
the work where pyarrow is present, as in the JAX package; the byte-matrix
path is the fallback.  Encoding on the device is not ported.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from spark_rapids_tpu_torch.utils import hostsync


class HostStrings(NamedTuple):
    """A string column's first ``nrows`` rows on the host."""
    offsets: np.ndarray   # int64[nrows + 1], from the column's own base
    chars: np.ndarray     # uint8
    valid: np.ndarray     # bool[nrows]

    @property
    def nrows(self) -> int:
        return self.offsets.shape[0] - 1


def host_strings(c, nrows: int) -> HostStrings:
    """Offsets, chars and validity of the first ``nrows`` rows of a string
    ``ColVal`` or ``Column`` (``values``/``data`` are its chars), fetched
    in one counted sync."""
    chars = c.values if hasattr(c, "values") else c.data
    bufs = [c.offsets[: nrows + 1], chars]
    if c.validity is not None:
        bufs.append(c.validity[:nrows])
    got = hostsync.fetch_all(bufs)
    offsets = got[0].astype(np.int64)
    valid = got[2].astype(np.bool_) if len(got) > 2 else \
        np.ones(nrows, dtype=np.bool_)
    return HostStrings(offsets, got[1], valid)


def row_byte_matrix(col: HostStrings) -> Tuple[np.ndarray, np.ndarray]:
    """``(nrows, width+4)`` uint8 matrix of each row's bytes (zero-padded)
    with a big-endian length tail, plus the row validity.  Null rows
    encode as all-zero."""
    n = col.nrows
    offs, chars, valid = col.offsets, col.chars, col.valid
    lens = (offs[1:] - offs[:-1]) if n else np.zeros(0, dtype=np.int64)
    if not valid.all():
        lens = np.where(valid, lens, 0)
    width = int(lens.max()) if n else 0
    mat = np.zeros((n, width + 4), dtype=np.uint8)
    if width and len(chars):
        idx = offs[:-1, None] + np.arange(width, dtype=np.int64)[None, :]
        mask = np.arange(width, dtype=np.int64)[None, :] < lens[:, None]
        np.copyto(mat[:, :width],
                  np.where(mask, chars[np.minimum(idx, len(chars) - 1)], 0))
    for i, shift in enumerate((24, 16, 8, 0)):
        mat[:, width + i] = (lens >> shift) & 0xFF
    return mat, valid


def _unique_rows(mat: np.ndarray):
    """(uniq_rows, inverse): uniques in string order and each row's
    order-preserving dense rank."""
    uniq, inverse = np.unique(mat, axis=0, return_inverse=True)
    return uniq, inverse.reshape(-1)


def _unique_bytes(uniq_row: np.ndarray) -> bytes:
    length = int.from_bytes(uniq_row[-4:].tobytes(), "big")
    return uniq_row[:length].tobytes()


def _arrow_dictionary(col: HostStrings):
    """Arrow's hash dictionary encode over the buffers: ``(inverse,
    dictionary)``, or None without pyarrow."""
    try:
        import pyarrow as pa
    except ImportError:
        return None
    n = col.nrows
    validity_buf = None
    if not col.valid.all():
        validity_buf = pa.py_buffer(np.packbits(col.valid,
                                                bitorder="little"))
    offs = np.ascontiguousarray((col.offsets - col.offsets[0])
                                .astype(np.int32))
    chars = np.ascontiguousarray(
        col.chars[int(col.offsets[0]): int(col.offsets[-1])])
    arr = pa.Array.from_buffers(
        pa.utf8(), n, [validity_buf, pa.py_buffer(offs), pa.py_buffer(chars)])
    d = arr.dictionary_encode()
    inverse = np.asarray(d.indices.fill_null(0)).astype(np.int64)
    return inverse, d.dictionary


def _encode_distinct(col: HostStrings):
    """(inverse, distinct): each row's index into the batch's distinct
    values (any index for a null row), and those values as str."""
    enc = _arrow_dictionary(col)
    if enc is not None:
        inverse, dictionary = enc
        distinct = dictionary.to_pylist()
        if not distinct and col.nrows:  # all rows null
            return np.zeros(col.nrows, dtype=np.int64), [""]
        return inverse, distinct
    mat, _ = row_byte_matrix(col)
    uniq, inverse = _unique_rows(mat)
    return inverse, [_unique_bytes(u).decode("utf-8") for u in uniq]


def rank_encode(col: HostStrings) -> np.ndarray:
    """Order-preserving int32 dense ranks of the column's values, within
    this column's value set only.  Null rows get rank 0; callers order
    them through the validity."""
    n = col.nrows
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    enc = _arrow_dictionary(col)
    if enc is not None:
        import pyarrow.compute as pc
        inverse, dictionary = enc
        k = len(dictionary)
        if k == 0:
            return np.zeros(n, dtype=np.int32)
        order = np.asarray(pc.sort_indices(dictionary))
        rank = np.empty(k, dtype=np.int32)
        rank[order] = np.arange(k, dtype=np.int32)
        return rank[inverse]
    mat, _ = row_byte_matrix(col)
    _, inverse = _unique_rows(mat)
    return inverse.astype(np.int32)


def ordered_dict_encode(col: HostStrings) -> Tuple[np.ndarray, List[str]]:
    """(codes int64, sorted distinct values): an order-preserving
    dictionary encode (code order is Spark's string order).  Null rows
    get code 0; callers keep the validity."""
    n = col.nrows
    if n == 0:
        return np.zeros(0, dtype=np.int64), []
    enc = _arrow_dictionary(col)
    if enc is not None:
        import pyarrow.compute as pc
        inverse, dictionary = enc
        k = len(dictionary)
        if k == 0:
            return np.zeros(n, dtype=np.int64), []
        order = np.asarray(pc.sort_indices(dictionary))
        rank = np.empty(k, dtype=np.int64)
        rank[order] = np.arange(k, dtype=np.int64)
        return rank[inverse], dictionary.take(order).to_pylist()
    mat, _ = row_byte_matrix(col)
    uniq, inverse = _unique_rows(mat)
    return (inverse.astype(np.int64),
            [_unique_bytes(u).decode("utf-8") for u in uniq])


def dict_encode_stable(col: HostStrings, codes: Dict[Optional[str], int],
                       values: List[Optional[str]],
                       null_code: Optional[int] = None) -> np.ndarray:
    """Codes stable across batches: the first appearance of a value
    (across every call sharing ``codes``/``values``) fixes its code.
    Python work is O(distinct values per batch), not O(rows).
    ``null_code``: the code of null rows; None interns null like a value
    (the group-by's encoder)."""
    n = col.nrows
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    inverse, distinct = _encode_distinct(col)
    lut = np.empty(len(distinct), dtype=np.int64)
    for j, s in enumerate(distinct):
        code = codes.get(s)
        if code is None:
            code = len(values)
            codes[s] = code
            values.append(s)
        lut[j] = code
    out = lut[inverse]
    valid = col.valid
    if not valid.all():
        if null_code is not None:
            out = np.where(valid, out, null_code)
        else:
            code = codes.get(None)
            if code is None:
                code = len(values)
                codes[None] = code
                values.append(None)
            out = np.where(valid, out, code)
    return out


class StableDictionary:
    """Codes stable across batches, and across the two sides of a join:
    the JAX package's ``_StringKeyEncoder`` (group keys) and
    ``_JoinKeyEncoder`` (join keys) in one."""

    def __init__(self):
        self.codes: Dict[Optional[str], int] = {}
        self.values: List[Optional[str]] = []

    def encode(self, c, nrows: int,
               null_code: Optional[int] = None) -> np.ndarray:
        """int64 codes of the first ``nrows`` rows of a string column (see
        :func:`dict_encode_stable` for ``null_code``)."""
        return dict_encode_stable(host_strings(c, nrows), self.codes,
                                  self.values, null_code)


def string_table(values: List[Optional[str]]):
    """(offsets int64, chars uint8, validity bool) of a list of str or
    None, built by arrow."""
    import pyarrow as pa
    n = len(values)
    arr = pa.array(values, type=pa.string())
    bufs = arr.buffers()
    offs = np.frombuffer(bufs[1], dtype=np.int32)[
        arr.offset: arr.offset + n + 1].astype(np.int64)
    chars = np.frombuffer(bufs[2], dtype=np.uint8) \
        if bufs[2] is not None else np.zeros(0, dtype=np.uint8)
    valid = np.array([v is not None for v in values], dtype=np.bool_)
    return offs, chars, valid


def decode(values: List[Optional[str]], codes, validity=None):
    """String ``ColVal`` of ``values[codes]`` on the codes' device: the
    dictionary goes to the card once and the rows gather from it (one
    counted fetch sizes the chars).  A ``None`` entry decodes to null,
    and so does a row whose ``validity`` is False."""
    import torch
    from spark_rapids_tpu_torch.columnar import dtypes as dts
    from spark_rapids_tpu_torch.ops import selection
    from spark_rapids_tpu_torch.ops.expressions import (
        ColVal, combine_validity)
    device = codes.device
    n = int(codes.shape[0])
    if not values:
        return ColVal(dts.STRING, torch.zeros(0, dtype=torch.uint8,
                                              device=device),
                      torch.zeros(n, dtype=torch.bool, device=device),
                      torch.zeros(n + 1, dtype=torch.int32, device=device))
    offs, chars, valid = string_table(values)
    table = ColVal(
        dts.STRING, torch.from_numpy(chars.copy()).to(device),
        None if valid.all() else torch.from_numpy(valid).to(device),
        torch.from_numpy(offs.astype(np.int32)).to(device))
    idx = codes.to(torch.int64).clamp(0, len(values) - 1)
    out = selection.gather([table], idx)[0]
    return ColVal(dts.STRING, out.values,
                  combine_validity(out.validity, validity), out.offsets)
