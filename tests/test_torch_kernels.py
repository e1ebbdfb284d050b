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
    dev = torch.device("meta")
    v = torch.empty(8, dtype=torch.float64, device=dev)
    m = torch.empty(8, dtype=torch.bool, device=dev)
    i = torch.empty(8, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        K.masked_multi_reduce([v], [None], m)
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        K.hash_insert(i, i, m, 64)
    assert calls == []
    assert K.launches.snapshot() == {"masked_multi_reduce": 0,
                                     "hash_insert": 0}
