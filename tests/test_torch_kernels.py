"""The PyTorch port's kernels against the JAX package's, on the CPU.

On the CPU the port's kernel wrappers run their plain PyTorch versions;
these are held against the JAX package's Pallas kernels (interpret mode)
and their XLA formulations on the same numpy-seeded inputs.  Tolerances:
counts, slots and stored codes exactly; float sums to a relative 1e-12
(the summation order differs between the implementations).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu.ops import pallas_kernels as pk
from spark_rapids_tpu_torch.ops import kernels as K

RTOL = 1e-12


# ------------------------------------------------------ masked multi-reduce --

def _mmr_inputs(n, ncols, case, seed):
    rng = np.random.default_rng(seed)
    values = [rng.normal(size=n) * 1e3 for _ in range(ncols)]
    validities = [rng.random(n) < 0.8 for _ in range(ncols)]
    mask = rng.random(n) < 0.6
    if case == "nan":
        for v in values:
            v[rng.random(n) < 0.05] = np.nan
    elif case == "neg_zero":
        for v in values:
            v[rng.random(n) < 0.5] = -0.0
    elif case == "all_masked":
        mask[:] = False
    elif case == "no_validity":
        validities = [np.ones(n, dtype=bool) for _ in range(ncols)]
    return values, validities, mask


@pytest.mark.parametrize("case", ["mixed", "nan", "neg_zero", "all_masked",
                                  "no_validity"])
@pytest.mark.parametrize("ncols", [1, 3])
@pytest.mark.parametrize("n", [1, 1000, 4097])
def test_masked_multi_reduce_matches_jax(n, ncols, case):
    values, validities, mask = _mmr_inputs(n, ncols, case, seed=n + ncols)
    j_vals = [jnp.asarray(v) for v in values]
    j_ok = [jnp.asarray(ok) for ok in validities]
    j_mask = jnp.asarray(mask)
    want = [pk.masked_multi_reduce(j_vals, j_ok, j_mask, interpret=True),
            pk.masked_multi_reduce_xla(j_vals, j_ok, j_mask)]
    t_vals = [torch.from_numpy(v) for v in values]
    t_ok = [None if case == "no_validity" else torch.from_numpy(ok)
            for ok in validities]
    t_mask = torch.from_numpy(mask)
    got = [K.masked_multi_reduce_plain(t_vals, t_ok, t_mask),
           K.masked_multi_reduce(t_vals, t_ok, t_mask)]
    for sums, cnts in got:
        assert sums.dtype == torch.float64 and cnts.dtype == torch.int32
        for w_sums, w_cnts in want:
            np.testing.assert_array_equal(cnts.numpy(), np.asarray(w_cnts))
            np.testing.assert_allclose(sums.numpy(), np.asarray(w_sums),
                                       rtol=RTOL, atol=0, equal_nan=True)
    if case == "all_masked":
        assert (got[0][1].numpy() == 0).all()
        assert (got[0][0].numpy() == 0.0).all()


def _mmr_edge_case(case, seed):
    """The edge cases ``chip_smoke.py`` runs on the card (``check_mmr_edges``),
    at CPU sizes: (values, validities or None, mask) as numpy arrays, views
    where the case starts some rows into its buffers."""
    rng = np.random.default_rng(seed)

    def columns(n, ncols):
        vals = [rng.normal(size=n) * 1e3 for _ in range(ncols)]
        for v in vals:
            v[:: 97] = -0.0
        oks = [None] + [rng.random(n) < 0.8 for _ in range(ncols - 1)]
        return vals, oks, rng.random(n) < 0.3

    kind, _, arg = case.partition(" ")
    if kind == "view":          # mask, values and validity 1/3/15 rows in
        off, n = int(arg), 1000 + 5
        vals, oks, mask = columns(n + 32, 3)
        cut = slice(off, off + n)
        return ([v[cut] for v in vals],
                [None if ok is None else ok[cut] for ok in oks], mask[cut])
    if kind == "n":             # head, tail and a ragged last tile
        n, off = (int(x) for x in arg.split("@"))
        vals, oks, mask = columns(n + 3, 2)
        cut = slice(off, off + n)
        return ([v[cut] for v in vals],
                [None if ok is None else ok[cut] for ok in oks], mask[cut])
    if kind in ("all_pass", "last_row"):
        n = 1000 + 3
        vals, oks, _ = columns(n, 2)
        mask = np.zeros(n, dtype=bool)
        mask[-1] = True
        return vals, oks, np.ones(n, dtype=bool) if kind == "all_pass" \
            else mask
    if kind == "cols":          # 9 splits into two launches on the card
        ncols, n = int(arg), 1000 + 9
        vals, oks, mask = columns(n, ncols)
        vals[1][:: 101] = np.nan
        vals[2][:] = -0.0
        oks = [ok if c % 3 else None for c, ok in enumerate(oks)]
        return vals, oks, mask
    assert kind == "misaligned"  # validity one row off the mask's start
    n = 1000
    vals, oks, mask = columns(n + 16, 2)
    return [v[1:n + 1] for v in vals], [None, oks[1][:n]], mask[1:n + 1]


_MMR_EDGES = (["view 1", "view 3", "view 15"]
              + [f"n {n}@{off}" for n in (1, 15, 17, 511, 513, (1 << 22) + 7)
                 for off in (0, 3)]
              + ["all_pass", "last_row", "cols 8", "cols 9", "misaligned"])


@pytest.mark.parametrize("case", _MMR_EDGES)
def test_masked_multi_reduce_edges_match_jax(case):
    """The port's plain version and its wrapper against the JAX package's
    Pallas kernel (interpret mode) and XLA formulation on the edge cases
    of the CUDA kernel.  At 2^22 + 7 rows only the XLA formulation: the
    interpret mode walks its 4097 grid steps for half a minute."""
    values, validities, mask = _mmr_edge_case(case,
                                               seed=sum(map(ord, case)))
    n = len(mask)
    j_vals = [jnp.asarray(v) for v in values]
    j_ok = [jnp.ones(n, dtype=bool) if ok is None else jnp.asarray(ok)
            for ok in validities]
    j_mask = jnp.asarray(mask)
    want = [pk.masked_multi_reduce_xla(j_vals, j_ok, j_mask)]
    if n < (1 << 20):
        want.append(pk.masked_multi_reduce(j_vals, j_ok, j_mask,
                                           interpret=True))
    t_vals = [torch.from_numpy(v) for v in values]
    t_ok = [None if ok is None else torch.from_numpy(ok)
            for ok in validities]
    t_mask = torch.from_numpy(mask)
    got = [K.masked_multi_reduce_plain(t_vals, t_ok, t_mask),
           K.masked_multi_reduce(t_vals, t_ok, t_mask)]
    for sums, cnts in got:
        assert sums.shape == (len(values),) and cnts.dtype == torch.int32
        for w_sums, w_cnts in want:
            np.testing.assert_array_equal(cnts.numpy(), np.asarray(w_cnts))
            np.testing.assert_allclose(sums.numpy(), np.asarray(w_sums),
                                       rtol=RTOL, atol=0, equal_nan=True)


def _mmr_rows(mask_addr, n, sms, blocks_per_sm):
    """The rows the CUDA kernel visits, in the order of its indexing
    (csrc/masked_multi_reduce.cu): block 0's warp 0 takes the head and
    the tail, one row a lane; warp ``w`` of the grid takes the 512-row
    tiles w, w + W, ... (W warps in all), lane ``l`` of a tile its 16-byte
    mask word 32 t + l if that word is inside the body."""
    head, nvec, tail = K.mmr_split(mask_addr, n)
    blocks = K.mmr_grid(nvec, sms, blocks_per_sm)
    warps = blocks * K._MMR_WARPS
    tiles = -(-nvec // K._MMR_TILE_WORDS)
    rows = list(range(head)) + list(range(head + 16 * nvec, n))
    for w in range(warps):
        for t in range(w, tiles, warps):
            for lane in range(K._MMR_TILE_WORDS):
                word = t * K._MMR_TILE_WORDS + lane
                if word < nvec:
                    rows.extend(range(head + 16 * word,
                                      head + 16 * word + 16))
    return rows, head, nvec, tail, blocks


@pytest.mark.parametrize("n", [1, 15, 16, 17, 511, 513, 16 * 32 * 8 + 5,
                               (1 << 16) + 3])
@pytest.mark.parametrize("offset", [0, 1, 3, 15])
@pytest.mark.parametrize("sms,blocks_per_sm", [(1, 1), (2, 8), (132, 8)])
def test_mmr_split_and_grid_cover_every_row_once(n, offset, sms,
                                                 blocks_per_sm):
    addr = 4096 + offset
    rows, head, nvec, tail, blocks = _mmr_rows(addr, n, sms, blocks_per_sm)
    assert sorted(rows) == list(range(n))
    assert 0 <= head < 16 and 0 <= tail < 16
    assert nvec == 0 or (addr + head) % 16 == 0
    assert 1 <= blocks <= max(1, sms * blocks_per_sm)


# --------------------------------------------------------------- hash insert --

def _split(codes):
    codes = np.asarray(codes, dtype=np.int64)
    lo = (codes & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    hi = (codes >> 32).astype(np.int32)
    return lo, hi


def _stored_codes(tlo, thi, occ):
    tlo = np.asarray(tlo).astype(np.int64)
    thi = np.asarray(thi).astype(np.int64)
    t64 = (thi << 32) | (tlo & 0xFFFFFFFF)
    return np.sort(t64[np.asarray(occ)])


def _check_contract(codes, live, out, T):
    slot, tlo, thi, occ, ovf = [np.asarray(x) for x in out]
    assert not bool(ovf)
    t64 = (thi.astype(np.int64) << 32) | (tlo.astype(np.int64) & 0xFFFFFFFF)
    assert (slot[~live] == T).all()
    live_slots = slot[live]
    assert (live_slots < T).all()
    assert occ[live_slots].all()
    np.testing.assert_array_equal(t64[live_slots], codes[live])


@pytest.mark.parametrize("n,T", [(37, 64), (512, 1024), (2048, 4096)])
def test_hash_insert_matches_jax(n, T):
    rng = np.random.default_rng(n)
    extremes = np.array([0, -1, np.iinfo(np.int64).min,
                         np.iinfo(np.int64).max, 1, -(1 << 32)],
                        dtype=np.int64)
    distinct = np.unique(np.concatenate([
        extremes, rng.integers(-(1 << 62), 1 << 62, max(n // 4, 1),
                               dtype=np.int64)]))
    codes = distinct[rng.integers(0, len(distinct), n)]
    codes[: len(extremes)] = extremes[: min(n, len(extremes))]
    live = rng.random(n) < 0.85
    live[: len(extremes)] = True
    lo, hi = _split(codes)
    t_out = K.hash_insert_plain(torch.from_numpy(lo), torch.from_numpy(hi),
                                torch.from_numpy(live), T)
    w_out = K.hash_insert(torch.from_numpy(lo), torch.from_numpy(hi),
                          torch.from_numpy(live), T)
    j_args = (jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(live), T)
    jax_outs = [pk.hash_insert(*j_args, interpret=True),
                pk.hash_insert_xla(*j_args)]
    t_np = [x.numpy() for x in t_out]
    for out in [t_np, [x.numpy() for x in w_out]] + jax_outs:
        _check_contract(codes, live, out, T)
    want = np.unique(codes[live])
    for out in [t_np] + jax_outs:
        np.testing.assert_array_equal(_stored_codes(*out[1:4]), want)
    assert t_np[0].dtype == np.int32 and t_np[3].dtype == np.bool_


def test_hash_insert_forced_overflow_flags_on_both():
    rng = np.random.default_rng(3)
    codes = np.unique(rng.integers(-(1 << 40), 1 << 40, 600,
                                   dtype=np.int64))[:500]
    live = np.ones(len(codes), dtype=bool)
    lo, hi = _split(codes)
    T = 64  # 500 distinct keys cannot fit 64 slots
    t_ovf = K.hash_insert_plain(torch.from_numpy(lo), torch.from_numpy(hi),
                                torch.from_numpy(live), T)[4]
    j_args = (jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(live), T)
    assert bool(t_ovf)
    assert bool(pk.hash_insert(*j_args, interpret=True)[4])
    assert bool(pk.hash_insert_xla(*j_args)[4])


def test_hash_insert_empty_and_all_dead():
    T = 64
    empty = torch.zeros(0, dtype=torch.int32)
    slot, tlo, thi, occ, ovf = K.hash_insert(empty, empty,
                                             torch.zeros(0, dtype=torch.bool),
                                             T)
    assert slot.shape == (0,) and occ.shape == (T,) and not bool(ovf)
    lo = torch.arange(10, dtype=torch.int32)
    slot, _, _, occ, ovf = K.hash_insert(lo, lo,
                                         torch.zeros(10, dtype=torch.bool), T)
    assert (slot == T).all() and not occ.any() and not bool(ovf)


@pytest.mark.parametrize("num_slots,salt", [
    (64, 0), (1 << 10, 0), (1 << 21, 0), (1 << 12, 3 * 0x9E3779B9),
    (1 << 16, 5 * 0x9E3779B9)])
def test_hash_index_bit_for_bit(num_slots, salt):
    rng = np.random.default_rng(num_slots)
    lo = rng.integers(-(1 << 31), 1 << 31, 5000).astype(np.int32)
    hi = rng.integers(-(1 << 31), 1 << 31, 5000).astype(np.int32)
    lo[:4] = [0, -1, np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    hi[:4] = [0, -1, np.iinfo(np.int32).max, np.iinfo(np.int32).min]
    want = np.asarray(pk._hash_index(jnp.asarray(lo), jnp.asarray(hi),
                                     num_slots, salt=salt))
    got = K.hash_index_plain(torch.from_numpy(lo), torch.from_numpy(hi),
                             num_slots, salt=salt).numpy()
    np.testing.assert_array_equal(got, want)


# -------------------------------------------------------------- hash probe --

_EXTREMES = np.array([0, -1, np.iinfo(np.int64).min, np.iinfo(np.int64).max],
                     dtype=np.int64)


def _probe_case(n, T, case, seed):
    """Build codes (distinct, with the int64 extremes) and probe codes:
    about half hits, the rest absent keys, 10% dead; or an all-dead
    batch."""
    rng = np.random.default_rng(seed)
    pool = np.unique(np.concatenate([
        _EXTREMES, rng.integers(-(1 << 62), 1 << 62, 2 * n,
                                dtype=np.int64)]))
    rng.shuffle(pool)
    build = np.concatenate([_EXTREMES, pool[~np.isin(pool, _EXTREMES)]])
    build = build[: max(min(T // 2, n), len(_EXTREMES))]
    absent = pool[~np.isin(pool, build)]
    hits = build[rng.integers(0, len(build), n)]
    misses = absent[rng.integers(0, len(absent), n)]
    probe = np.where(rng.random(n) < 0.5, hits, misses)
    probe[: len(_EXTREMES)] = _EXTREMES[: min(n, len(_EXTREMES))]
    live = rng.random(n) >= 0.1
    if case == "all_dead":
        live[:] = False
    return build, probe, live


def _check_probe_contract(build, probe, live, table, slot, T):
    """Per row: hit iff live and the code is stored; on a hit the stored
    code at the slot is the row's; misses and dead rows sit at T."""
    _, tlo, thi, occ, ovf = [np.asarray(x) for x in table]
    slot = np.asarray(slot).astype(np.int64)
    assert not bool(ovf)
    t64 = (thi.astype(np.int64) << 32) | (tlo.astype(np.int64) & 0xFFFFFFFF)
    want_hit = live & np.isin(probe, build)
    np.testing.assert_array_equal(slot < T, want_hit)
    assert (slot[~want_hit] == T).all()
    hit_slots = slot[want_hit]
    assert occ[hit_slots].all()
    np.testing.assert_array_equal(t64[hit_slots], probe[want_hit])
    return want_hit


@pytest.mark.parametrize("case", ["mixed", "all_dead"])
@pytest.mark.parametrize("n,T", [(64, 64), (700, 1024), (2048, 4096)])
def test_hash_probe_matches_jax(n, T, case):
    build, probe, live = _probe_case(n, T, case, seed=n + T)
    blo, bhi = _split(build)
    plo, phi = _split(probe)
    blive = np.ones(len(build), dtype=bool)
    t_table = K.hash_insert_plain(torch.from_numpy(blo),
                                  torch.from_numpy(bhi),
                                  torch.from_numpy(blive), T)
    t_args = (torch.from_numpy(plo), torch.from_numpy(phi),
              torch.from_numpy(live)) + tuple(t_table[1:4])
    t_plain = K.hash_probe_plain(*t_args)
    t_wrap = K.hash_probe(*t_args)
    assert t_plain.dtype == torch.int32
    j_build = (jnp.asarray(blo), jnp.asarray(bhi), jnp.asarray(blive), T)
    j_probe = (jnp.asarray(plo), jnp.asarray(phi), jnp.asarray(live))
    j_xla = pk.hash_insert_xla(*j_build)
    j_pallas = pk.hash_insert(*j_build, interpret=True)
    pairs = [(t_table, t_plain), (t_table, t_wrap),
             (j_xla, pk.hash_probe_xla(*j_probe, *j_xla[1:4])),
             (j_pallas, pk.hash_probe(*j_probe, *j_pallas[1:4],
                                      interpret=True))]
    hits = [_check_probe_contract(build, probe, live,
                                  [x.numpy() if hasattr(x, "numpy") else x
                                   for x in table], slot, T)
            for table, slot in pairs]
    for h in hits[1:]:
        np.testing.assert_array_equal(h, hits[0])
    # the plain pair shares the XLA pair's layout: slots agree exactly
    np.testing.assert_array_equal(t_plain.numpy(), np.asarray(pairs[2][1]))
    if case == "all_dead":
        assert not hits[0].any()
    else:
        assert 0 < hits[0].sum() < n


def test_hash_probe_empty():
    e = torch.zeros(0, dtype=torch.int32)
    table = K.hash_insert(torch.arange(5, dtype=torch.int32),
                          torch.zeros(5, dtype=torch.int32),
                          torch.ones(5, dtype=torch.bool), 64)
    out = K.hash_probe(e, e, torch.zeros(0, dtype=torch.bool), *table[1:4])
    assert out.shape == (0,) and out.dtype == torch.int32


# ------------------------------------------------ hash contract edge cases --

_EDGE = np.array([0, -1, np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                  K.HASH_EMPTY], dtype=np.int64)


def _edge_case(case, seed):
    """(codes, live, T, expect_overflow) of one edge case of the hash
    contract: the extreme codes and the CUDA table's empty word among
    random keys; every row on one key (an ordinary one and the empty
    word); no rows; every row dead; more distinct keys than slots."""
    rng = np.random.default_rng(seed)
    n, T = 300, 256
    if case == "extremes":
        keys = np.concatenate([_EDGE, rng.integers(-(1 << 62), 1 << 62, 60,
                                                   dtype=np.int64)])
        codes = keys[rng.integers(0, len(keys), n)]
        codes[: len(_EDGE)] = _EDGE
        live = rng.random(n) < 0.85
        live[: len(_EDGE)] = True
        return codes, live, T, False
    if case in ("one key", "one key = HASH_EMPTY"):
        key = 12345 if case == "one key" else K.HASH_EMPTY
        return np.full(n, key, dtype=np.int64), np.ones(n, bool), T, False
    if case == "no rows":
        return np.zeros(0, dtype=np.int64), np.zeros(0, bool), T, False
    if case == "all dead":
        return _EDGE.copy(), np.zeros(len(_EDGE), bool), T, False
    assert case == "overflow"
    codes = np.unique(rng.integers(-(1 << 40), 1 << 40, 2 * T,
                                   dtype=np.int64))[: T + T // 2]
    return np.concatenate([_EDGE, codes]), \
        np.ones(len(codes) + len(_EDGE), bool), T, True


@pytest.mark.parametrize("case", ["extremes", "one key",
                                  "one key = HASH_EMPTY", "no rows",
                                  "all dead", "overflow"])
def test_hash_edge_cases_match_jax(case):
    """The plain insert and probe against the JAX package's Pallas kernels
    (interpret mode) and XLA formulations at the contract's edges: the
    same stored code set (or overflow on all), every placed row's slot
    holding its code, and the same hit/miss for every probe row, the
    extreme codes and the empty word among them."""
    codes, live, T, overflow = _edge_case(case, seed=len(case))
    lo, hi = _split(codes)
    t_in = (torch.from_numpy(lo), torch.from_numpy(hi),
            torch.from_numpy(live))
    j_in = (jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(live))
    tables = {"plain": [x.numpy() for x in K.hash_insert_plain(*t_in, T)],
              "wrapper": [x.numpy() for x in K.hash_insert(*t_in, T)],
              "pallas": [np.asarray(x) for x in
                         pk.hash_insert(*j_in, T, interpret=True)],
              "xla": [np.asarray(x) for x in pk.hash_insert_xla(*j_in, T)]}
    want = np.unique(codes[live])
    for name, out in tables.items():
        if overflow:
            assert bool(out[4]), name
            continue
        _check_contract(codes, live, out, T)
        np.testing.assert_array_equal(_stored_codes(*out[1:4]), want,
                                      err_msg=name)
    if overflow:
        return
    rng = np.random.default_rng(7)
    absent = rng.integers(-(1 << 62), 1 << 62, 40, dtype=np.int64)
    probe = np.concatenate([_EDGE, want, absent[~np.isin(absent, want)]])
    plive = np.ones(len(probe), bool)
    plive[-3:] = False
    plo, phi = _split(probe)
    t_probe = (torch.from_numpy(plo), torch.from_numpy(phi),
               torch.from_numpy(plive))
    j_probe = (jnp.asarray(plo), jnp.asarray(phi), jnp.asarray(plive))
    slots = {
        "plain": K.hash_probe_plain(
            *t_probe, *[torch.from_numpy(x) for x in tables["plain"][1:4]]),
        "pallas": pk.hash_probe(*j_probe, *tables["pallas"][1:4],
                                interpret=True),
        "xla": pk.hash_probe_xla(*j_probe, *tables["xla"][1:4])}
    want_hit = plive & np.isin(probe, want)
    for name, slot in slots.items():
        got_hit = _check_probe_contract(want, probe, plive,
                                        tables[name], slot, T)
        np.testing.assert_array_equal(got_hit, want_hit, err_msg=name)


def test_lane_views_are_the_packed_words():
    """The CUDA insert's table is one int64 word a slot and its lanes are
    strided views: lo is the word's first int32, hi its second, for every
    extreme code and the empty word."""
    codes = np.concatenate([_EDGE, np.arange(-3, 4, dtype=np.int64)])
    words = torch.from_numpy(codes.copy())
    lo_v, hi_v = K.lane_views(words)
    lo, hi = _split(codes)
    np.testing.assert_array_equal(lo_v.numpy(), lo)
    np.testing.assert_array_equal(hi_v.numpy(), hi)
    assert lo_v.stride() == (2,) and hi_v.stride() == (2,)
    assert lo_v.dtype == torch.int32 and hi_v.dtype == torch.int32
    words[3] = 99  # views, not copies
    assert int(lo_v[3]) == 99 and int(hi_v[3]) == 0


def test_packed_table_reads_views_and_packs_separate_lanes():
    """``packed_table``: the insert's lane views give back their words
    without a copy; two separate contiguous arrays, or lanes that are not
    one word's halves, give a packed copy with the same codes."""
    codes = np.concatenate([_EDGE, np.arange(-5, 6, dtype=np.int64) << 31])
    words = torch.from_numpy(codes.copy())
    lo_v, hi_v = K.lane_views(words)
    same = K.packed_table(lo_v, hi_v)
    assert same.data_ptr() == words.data_ptr()
    np.testing.assert_array_equal(same.numpy(), codes)
    lo, hi = _split(codes)
    packed = K.packed_table(torch.from_numpy(lo), torch.from_numpy(hi))
    assert packed.data_ptr() != words.data_ptr()
    np.testing.assert_array_equal(packed.numpy(), codes)
    # lanes of two different words' halves: hi of word p is not beside lo
    shifted = K.packed_table(lo_v[1:], hi_v[:-1])
    want = (codes[:-1] >> 32 << 32) | (codes[1:] & 0xFFFFFFFF)
    np.testing.assert_array_equal(shifted.numpy(), want)
    # lanes swapped: hi's storage sits before lo's
    swapped = K.packed_table(hi_v, lo_v)
    np.testing.assert_array_equal(
        swapped.numpy(), (codes << 32) | ((codes >> 32) & 0xFFFFFFFF))


def test_hash_empty_matches_the_cuda_header():
    """The Python side's empty word is the one the kernels clear tables
    to (``csrc/hash_common.cuh``): one repeated byte, so one memset."""
    import re
    from pathlib import Path
    src = (Path(K.__file__).resolve().parent.parent / "csrc" /
           "hash_common.cuh").read_text()
    word = int(re.search(r"#define HASH_EMPTY (0x[0-9A-Fa-f]+)ull",
                         src).group(1), 16)
    byte = int(re.search(r"#define HASH_EMPTY_BYTE (0x[0-9A-Fa-f]+)",
                         src).group(1), 16)
    assert K.HASH_EMPTY % (1 << 64) == word
    assert word == int.from_bytes(bytes([byte]) * 8, "little")


def test_launch_counts_by_shape():
    counter = K.KernelLaunches()
    counter.bump("hash_insert", "n=8 T=64")
    counter.bump("hash_insert", "n=8 T=64")
    counter.bump("hash_probe", "n=3 T=64")
    assert counter.snapshot() == {"masked_multi_reduce": 0,
                                  "hash_insert": 2, "hash_probe": 1,
                                  "partition_histogram": 0}
    shapes = counter.shape_snapshot()
    assert shapes["hash_insert"] == {"n=8 T=64": 2}
    assert shapes["hash_probe"] == {"n=3 T=64": 1}
    shapes["hash_insert"]["n=8 T=64"] = 5  # a copy
    assert counter.shape_snapshot()["hash_insert"] == {"n=8 T=64": 2}
    counter.reset()
    assert counter.snapshot()["hash_insert"] == 0
    assert counter.shape_snapshot()["hash_insert"] == {}


# ------------------------------------------------- no fallback on the card --

def _raise_loader():
    raise RuntimeError("kernel library unavailable")


def test_cuda_branch_raises_and_never_runs_plain(monkeypatch):
    """A tensor that is not on the CPU takes the kernel branch: with the
    library's loader failing, each wrapper raises instead of returning
    the plain version's result."""
    calls = []
    monkeypatch.setattr(K, "library", _raise_loader)
    monkeypatch.setattr(K, "masked_multi_reduce_plain",
                        lambda *a: calls.append("mmr"))
    monkeypatch.setattr(K, "hash_insert_plain",
                        lambda *a: calls.append("hash"))
    monkeypatch.setattr(K, "hash_probe_plain",
                        lambda *a: calls.append("probe"))
    monkeypatch.setattr(K, "partition_histogram_plain",
                        lambda *a: calls.append("hist"))
    dev = torch.device("meta")
    v = torch.empty(8, dtype=torch.float64, device=dev)
    m = torch.empty(8, dtype=torch.bool, device=dev)
    i = torch.empty(8, dtype=torch.int32, device=dev)
    t = torch.empty(64, dtype=torch.int32, device=dev)
    occ = torch.empty(64, dtype=torch.bool, device=dev)
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        K.masked_multi_reduce([v], [None], m)
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        K.hash_insert(i, i, m, 64)
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        K.hash_probe(i, i, m, t, t, occ)
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        K.partition_histogram(i, m, 8)
    assert calls == []
    assert K.launches.snapshot() == {"masked_multi_reduce": 0,
                                     "hash_insert": 0, "hash_probe": 0,
                                     "partition_histogram": 0}
