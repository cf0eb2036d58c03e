"""The PyTorch port's threefry sampler is bit-identical to jax.random."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlos_surface_optimization_tpu.geometry import sampling as jsampling
from nlos_surface_optimization_torch.geometry import sampling

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 3, 11, 2**31 - 1, 2**40 + 5])
def test_key_matches_jax(seed):
    got = sampling.key(seed).numpy()
    want = np.asarray(jax.random.key_data(jax.random.key(seed)))
    np.testing.assert_array_equal(got, want)


def test_key_from_data_round_trip():
    k = jax.random.fold_in(jax.random.key(7), 123)
    data = np.asarray(jax.random.key_data(k))
    np.testing.assert_array_equal(sampling.key_from_data(data).numpy(), data)


@pytest.mark.parametrize("seed", [0, 23, 2**31 - 1])
def test_fold_in_matches_jax(seed):
    """The outer loop's per-iteration key (frozen_sampling=False)."""
    ts = [0, 1, 6, 15, 499, 2**31 - 1]
    got = sampling.fold_in(sampling.key(seed), torch.tensor(ts)).numpy()
    for t, row in zip(ts, got):
        want = jax.random.key_data(jax.random.fold_in(jax.random.key(seed),
                                                      t))
        np.testing.assert_array_equal(row, np.asarray(want))


@pytest.mark.parametrize("seed,offset,num_faces,spt", [
    (0, 0, 37, 7), (3, 5, 3, 1), (11, 4095, 50, 2), (12345, 70000, 9, 128),
])
def test_uniforms_bit_identical(seed, offset, num_faces, spt):
    L = 3
    S, T = sampling.uniforms_for(sampling.key(seed), L, num_faces, spt,
                                 source_offset=offset, device="cpu")
    k = jax.random.key(seed)
    for s in range(L):
        u = np.asarray(jax.random.uniform(jax.random.fold_in(k, s + offset),
                                          (num_faces, spt, 2),
                                          dtype=jnp.float32))
        np.testing.assert_array_equal(S[s].numpy(), u[..., 0])
        np.testing.assert_array_equal(T[s].numpy(), u[..., 1])


def test_stratified_barycoords_match_jax():
    k = jax.random.key(5)
    want = np.asarray(jsampling.stratified_barycoords(k, 4, 13, 3, 8))
    got = sampling.stratified_barycoords(sampling.key(5), 4, 13, 3, 8,
                                         device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_chunk_invariance():
    """The draw of a (global source, face, slot) ignores chunking."""
    k = sampling.key(9)
    S_all, T_all = sampling.uniforms_for(k, 6, 5, 3, device="cpu")
    S_hi, T_hi = sampling.uniforms_for(k, 2, 5, 3, source_offset=4,
                                       device="cpu")
    assert torch.equal(S_all[4:], S_hi) and torch.equal(T_all[4:], T_hi)
