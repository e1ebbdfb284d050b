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
path is the fallback.

:class:`StableDictionary` (group and join keys) and
:func:`string_sort_keys` (sort keys) work on the device instead while
the strings are at most ``MAX_PACKED_BYTES`` long: a string becomes its
bytes packed eight to an int64 word plus its length, which compare as
the strings do, exactly.
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


# strings of at most this many bytes encode on the device as packed words
MAX_PACKED_BYTES = 256


def _string_parts(c, nrows: int):
    """(chars, int64 row starts, int64 lengths, validity or None) of the
    first ``nrows`` rows of a string ``ColVal`` or ``Column``."""
    import torch
    chars = c.values if hasattr(c, "values") else c.data
    offs = c.offsets[: nrows + 1].to(torch.int64)
    validity = None if c.validity is None else c.validity[:nrows]
    return chars, offs[:-1], offs[1:] - offs[:-1], validity


def max_length(c, nrows: int) -> int:
    """The longest of the first ``nrows`` rows, in bytes (one counted
    fetch)."""
    if nrows == 0:
        return 0
    _, _, lengths, _ = _string_parts(c, nrows)
    return int(hostsync.fetch(lengths.max()))


def pack_words(chars, starts, lengths, width: int):
    """int64 ``[n, width]``: each row's first ``8 * width`` bytes, zero
    padded, eight to a word, big-endian with the sign bit flipped, so that
    comparing the words as signed integers, then the lengths, is
    comparing the strings byte by byte (Spark's string order)."""
    import torch
    n = starts.shape[0]
    out = torch.zeros((n, width), dtype=torch.int64, device=starts.device)
    if n == 0 or chars.shape[0] == 0:
        out[:, :] = -(1 << 63)
        return out
    top = chars.shape[0] - 1
    for k in range(width):
        word = torch.zeros(n, dtype=torch.int64, device=starts.device)
        for b in range(8):
            j = 8 * k + b
            byte = chars[(starts + j).clamp(max=top)].to(torch.int64)
            byte = torch.where(j < lengths, byte, torch.zeros_like(byte))
            if b == 0:
                byte = byte - 128  # the sign flip, without overflow
            word = word + byte * (1 << (56 - 8 * b))
        out[:, k] = word
    return out


def _unpack_bytes(words):
    """uint8 ``[n, 8 * width]`` of :func:`pack_words` output."""
    import torch
    n, width = words.shape
    parts = []
    for b in range(8):
        shifted = words >> (56 - 8 * b)
        if b == 0:
            shifted = shifted + 128
        parts.append((shifted & 0xFF).to(torch.uint8))
    # [n, width, 8] -> bytes in row order
    return torch.stack(parts, dim=2).reshape(n, width * 8)


def string_sort_keys(c, nrows: int):
    """Sort keys of a string column, most significant first: its packed
    words and then its length, each an int64 ``ColVal`` with the column's
    validity; or None when a row is longer than ``MAX_PACKED_BYTES``."""
    from spark_rapids_tpu_torch.columnar import dtypes as dts
    from spark_rapids_tpu_torch.ops.expressions import ColVal
    maxlen = max_length(c, nrows)
    if maxlen > MAX_PACKED_BYTES:
        return None
    chars, starts, lengths, validity = _string_parts(c, nrows)
    words = pack_words(chars, starts, lengths, max(1, -(-maxlen // 8)))
    return [ColVal(dts.INT64, words[:, k].contiguous(), validity)
            for k in range(words.shape[1])] + \
        [ColVal(dts.INT64, lengths, validity)]


def _groups(keys, live):
    """(row -> group of equal keys, group -> its first row): groups are
    numbered in key order, dead rows map to group ``n`` (a trash slot),
    and a group slot with no row holds ``n`` as its first row."""
    import torch
    from spark_rapids_tpu_torch.ops import aggregates as agg
    from spark_rapids_tpu_torch.ops.expressions import ColVal
    n = live.shape[0]
    device = live.device
    perm = agg.sort_permutation(keys, live)
    sorted_keys = [ColVal(k.dtype, k.values[perm]) for k in keys]
    slive = live[perm]
    boundary = ~agg._keys_equal_prev(sorted_keys, n, device) & slive
    gid = torch.cumsum(boundary.to(torch.int64), 0) - 1
    group = torch.empty(n, dtype=torch.int64, device=device)
    group[perm] = torch.where(slive, gid, torch.full_like(gid, n))
    first = torch.full((n + 1,), n, dtype=torch.int64, device=device)
    first.scatter_reduce_(0, group, torch.arange(n, device=device), "amin")
    return group, first[:n]


class StableDictionary:
    """Codes stable across batches, and across the two sides of a join:
    the JAX package's ``_StringKeyEncoder`` (group keys) and
    ``_JoinKeyEncoder`` (join keys) in one.  A value's code is fixed by
    its first appearance (across every batch this dictionary encodes),
    as there; a null interns as a value of its own unless the caller
    gives ``null_code``.

    The JAX package keeps the dictionary on the host.  Here it stays on
    the column's device while every string is at most
    ``MAX_PACKED_BYTES`` long: each string is its packed words plus its
    length (exact, no hashing), a batch's distinct values come from one
    sort of those keys, and one more sort against the known values finds
    their codes.  A batch costs two counted fetches (the longest string
    and the number of new values) instead of fetching the column.  Past
    that length the dictionary moves to the host (arrow's hash encode)
    for good."""

    def __init__(self):
        self.words = None   # int64 [K, W] of the known values, by code
        self.lengths = None  # int64 [K]; -1 is the null value
        self.host_codes: Optional[Dict[Optional[str], int]] = None
        self.host_values: List[Optional[str]] = []

    def __len__(self) -> int:
        if self.host_codes is not None:
            return len(self.host_values)
        return 0 if self.lengths is None else int(self.lengths.shape[0])

    def encode(self, c, nrows: int, null_code: Optional[int] = None):
        """int64 codes (a tensor on the column's device) of the first
        ``nrows`` rows of a string column; null rows get ``null_code``, or
        with None, the code of the null value."""
        import torch
        chars, starts, lengths, validity = _string_parts(c, nrows)
        if nrows == 0:
            return torch.zeros(0, dtype=torch.int64, device=starts.device)
        if self.host_codes is None:
            maxlen = max_length(c, nrows)
            if maxlen > MAX_PACKED_BYTES:
                self._to_host()
        if self.host_codes is not None:
            codes = dict_encode_stable(host_strings(c, nrows),
                                       self.host_codes, self.host_values,
                                       null_code)
            return torch.from_numpy(codes).to(starts.device)
        return self._encode_device(chars, starts, lengths, validity,
                                   max(1, -(-maxlen // 8)), null_code)

    def _encode_device(self, chars, starts, lengths, validity, width,
                       null_code):
        import torch
        from spark_rapids_tpu_torch.columnar import dtypes as dts
        from spark_rapids_tpu_torch.ops.expressions import ColVal
        n = starts.shape[0]
        device = starts.device
        known = 0 if self.lengths is None else int(self.lengths.shape[0])
        if known:
            width = max(width, int(self.words.shape[1]))
            if self.words.shape[1] < width:
                # wider strings arrived: known values gain zero words
                pad = torch.full((known, width - self.words.shape[1]),
                                 -(1 << 63), dtype=torch.int64,
                                 device=device)
                self.words = torch.cat([self.words, pad], dim=1)
        words = pack_words(chars, starts, lengths, width)
        key_len = lengths
        live = torch.ones(n, dtype=torch.bool, device=device)
        if validity is not None:
            words = torch.where(validity[:, None], words,
                                torch.full_like(words, -(1 << 63)))
            if null_code is None:
                key_len = torch.where(validity, lengths,
                                      torch.full_like(lengths, -1))
            else:
                live = validity

        def cols(w, ln):
            return [ColVal(dts.INT64, w[:, k]) for k in range(width)] + \
                [ColVal(dts.INT64, ln)]

        # the batch's distinct values, each with its first row
        group, first = _groups(cols(words, key_len), live)
        exists = first < n
        rep = first.clamp(max=n - 1)
        cand_words, cand_len = words[rep], key_len[rep]
        # which of them the dictionary knows: sort them with the known
        # values (known first, so a group's first member says)
        if known:
            all_words = torch.cat([self.words, cand_words])
            all_len = torch.cat([self.lengths, cand_len])
            all_live = torch.cat([torch.ones(known, dtype=torch.bool,
                                             device=device), exists])
            g2, first2 = _groups(cols(all_words, all_len), all_live)
            head = first2[g2.clamp(max=known + n - 1)][known:]
            code = torch.where(head < known, head,
                               torch.full_like(head, -1))
        else:
            code = torch.full((n,), -1, dtype=torch.int64, device=device)
        # new values take the next codes in order of first appearance,
        # the null value after the batch's other new values (as the host
        # encoder interns it)
        is_new = exists & (code < 0)
        appear = torch.where(cand_len < 0, torch.full_like(first, n), first)
        order = torch.argsort(torch.where(is_new, appear,
                                          torch.full_like(first, n + 1)),
                              stable=True)
        rank = torch.empty(n, dtype=torch.int64, device=device)
        rank[order] = torch.arange(n, device=device)
        code = torch.where(is_new, known + rank, code)
        out = code[group.clamp(max=n - 1)]
        if validity is not None and null_code is not None:
            out = torch.where(validity, out, torch.full_like(out, null_code))
        n_new = int(hostsync.fetch(is_new.sum()))
        if n_new:
            take = order[:n_new]
            new_words, new_len = cand_words[take], cand_len[take]
            self.words = new_words if not known else \
                torch.cat([self.words, new_words])
            self.lengths = new_len if not known else \
                torch.cat([self.lengths, new_len])
        return out

    def _to_host(self) -> None:
        """Move the known values to the host dictionary, in code order."""
        known = len(self)
        if not known:
            self.host_codes, self.host_values = {}, []
            return
        host = host_strings(self._table(), known)
        values = [None if not host.valid[i] else
                  host.chars[host.offsets[i]:host.offsets[i + 1]]
                  .tobytes().decode("utf-8") for i in range(host.nrows)]
        self.host_values = values
        self.host_codes = {v: i for i, v in enumerate(values)}
        self.words = self.lengths = None

    def _table(self):
        """The known values as a string ``ColVal``, one row per code."""
        import torch
        codes = torch.arange(self.lengths.shape[0],
                             device=self.lengths.device)
        return self.decode(codes)

    def decode(self, codes, validity=None):
        """String ``ColVal`` of the values at ``codes`` on the codes'
        device; the null value and rows whose ``validity`` is False
        decode to null."""
        if self.host_codes is not None or self.lengths is None:
            return decode(self.host_values, codes, validity)
        return self._decode_device(codes, validity)

    def _decode_device(self, codes, validity):
        import torch
        from spark_rapids_tpu_torch.columnar import dtypes as dts
        from spark_rapids_tpu_torch.ops.expressions import (
            ColVal, combine_validity)
        from spark_rapids_tpu_torch.ops.stringops import build_strings
        idx = codes.to(torch.int64).clamp(0, self.lengths.shape[0] - 1)
        lengths = self.lengths[idx]
        valid = combine_validity(lengths >= 0, validity)
        lengths = lengths.clamp(min=0)
        if validity is not None:
            lengths = torch.where(validity, lengths,
                                  torch.zeros_like(lengths))
        flat = _unpack_bytes(self.words).reshape(-1)
        row_bytes = 8 * int(self.words.shape[1])
        total = int(hostsync.fetch(lengths.sum()))
        chars, offsets = build_strings(lengths, idx * row_bytes, flat,
                                       total)
        return ColVal(dts.STRING, chars, valid, offsets)


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
