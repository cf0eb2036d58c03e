"""Stratified area sampling on triangles with a counter-based RNG.

The draws are bit-identical to the JAX package's
``jax.random.uniform(jax.random.fold_in(key, s), (F, spt, 2), float32)``
under JAX's default (partitionable) threefry: threefry-2x32 with 20
rounds, ``fold_in(key, s) = threefry(key, (0, s))``, element i of the
draw = ``threefry(ks, (i >> 32, i & 0xffffffff))`` with the two output
words xor-ed, and the float ``((bits >> 9) | 0x3f800000) - 1``.  The
arithmetic runs in int64 tensors masked to 32 bits, so it is exact on
every device.  The draw for a given (global source index, face, slot)
does not depend on chunking.

A key is an int64 tensor of shape [2] holding two uint32 words.  ``split``
and ``uniform`` are jax 0.9's ``jax.random.split`` and float32
``jax.random.uniform`` bit for bit under the same threefry, for a key or
a batch of keys [..., 2].  ``choice`` and ``poisson`` make the draws of
the SPAD model (noise/spad.py): ``choice`` searches jax's r = cdf[-1] *
(1 - u) with the same u in exact running sums, ``poisson`` is torch's
sampler under a generator seeded from the key's words, so both are
functions of the key alone (on a device) and agree with JAX's in
distribution.
"""

from __future__ import annotations

import math

import torch

from .mesh import sqrt_rn

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def key(seed: int) -> torch.Tensor:
    """Key words of ``jax.random.key(seed)`` (seed taken as a 64-bit int)."""
    s = int(seed) % (1 << 64)
    return torch.tensor([s >> 32, s & _MASK], dtype=torch.int64)


def key_from_data(data) -> torch.Tensor:
    """Key from its two uint32 words, e.g. ``jax.random.key_data(k)``."""
    words = torch.as_tensor(data).reshape(-1).to(torch.int64) & _MASK
    if words.numel() != 2:
        raise ValueError(f"a threefry key has 2 words, got {words.numel()}")
    return words.cpu()


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on int64 tensors of uint32 values; k0/k1
    broadcast against the counters x0/x1."""
    ks = (k0, k1, (k0 ^ k1 ^ 0x1BD11BDA) & _MASK)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def fold_in(k: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` for a vector of data words -> keys [N, 2]."""
    data = data.to(torch.int64) & _MASK
    y0, y1 = threefry2x32(k[0], k[1], torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def _counter_bits(keys: torch.Tensor, n: int):
    """(bits1, bits2) [..., n]: threefry of each key [..., 2] over the
    counters 0..n-1 split into (high, low) words, jax's partitionable
    ``iota_2x32_shape``."""
    idx = torch.arange(n, device=keys.device, dtype=torch.int64)
    return threefry2x32(keys[..., 0:1], keys[..., 1:2], idx >> 32,
                        idx & _MASK)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(k, num)`` -> keys [..., num, 2]."""
    b1, b2 = _counter_bits(k, num)
    return torch.stack([b1, b2], dim=-1)


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1) from uint32 values: the top 23 bits as the
    mantissa of a number in [1, 2), minus 1."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform(k: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32)`` -> [..., *shape] for keys
    [..., 2]."""
    shape = tuple(shape)
    b1, b2 = _counter_bits(k, math.prod(shape))
    return _unit_floats(b1 ^ b2).reshape(*k.shape[:-1], *shape)


def choice(k: torch.Tensor, n: int, shape, p: torch.Tensor) -> torch.Tensor:
    """Indices into range(n) drawn with weights p >= 0 ([n], or a row
    [..., n] a key; any scale) for keys [..., 2] -> int64 [..., *shape]:
    as jax.random.choice with replacement, the first index whose running
    sum reaches r = cdf[-1] * (1 - u), with jax's u.  The running sums are
    exact: each weight in 40-bit fixed point of its row's largest, summed
    in int64.  A float cumsum (or a sum to normalize) adds in an order
    that depends on the device and on how many rows a call holds, and a
    draw near a boundary then moves with the chunk of rows."""
    if p.shape[-1] != n:
        raise ValueError(f"p has {p.shape[-1]} entries, expected {n}")
    shape = tuple(shape)
    u = uniform(k, (math.prod(shape),))
    top = p.amax(dim=-1, keepdim=True).double()
    q = torch.floor(p.double() / torch.where(top > 0, top, 1.0) * 2.0 ** 40)
    cdf = torch.cumsum(q.long(), dim=-1).double()        # exact below 2^53
    ind = torch.searchsorted(cdf, cdf[..., -1:] * (1.0 - u.double()))
    return ind.reshape(*u.shape[:-1], *shape)


def poisson(k: torch.Tensor, lam: torch.Tensor, shape) -> torch.Tensor:
    """Poisson counts [..., *shape] (float32) of mean lam for keys
    [..., 2]: for each key, torch.poisson on lam's device under a
    generator seeded with its words, (k0 << 32) | k1."""
    lam = torch.as_tensor(lam, dtype=torch.float32)
    rates = lam.expand(tuple(shape)).contiguous()
    gen = torch.Generator(device=lam.device)
    draws = []
    for k0, k1 in k.reshape(-1, 2).tolist():
        gen.manual_seed((k0 << 32) | k1)
        draws.append(torch.poisson(rates, generator=gen))
    return torch.stack(draws).reshape(*k.shape[:-1], *rates.shape)


def uniforms_for(k: torch.Tensor, num_sources: int, num_faces: int, spt: int,
                 source_offset: int = 0, device=None):
    """Per-(source, face, sample) uniforms (S, T), each [L, F, spt] f32."""
    device = torch.device("cuda") if device is None else torch.device(device)
    k = k.to(device)
    src = torch.arange(num_sources, device=device, dtype=torch.int64)
    keys = fold_in(k, src + int(source_offset))               # [L, 2]
    u = uniform(keys, (num_faces, spt, 2))
    return u[..., 0], u[..., 1]


def barycoords_from_uniforms(S: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """u = 1 - sqrt(T), v = (1 - S) sqrt(T), w = S sqrt(T)."""
    sqrtT = sqrt_rn(T)
    return torch.stack([1.0 - sqrtT, (1.0 - S) * sqrtT, S * sqrtT], dim=-1)


def stratified_barycoords(k: torch.Tensor, num_sources: int, num_faces: int,
                          spt: int, source_offset: int = 0, device=None):
    """Barycoords [L, F, spt, 3]."""
    S, T = uniforms_for(k, num_sources, num_faces, spt, source_offset, device)
    return barycoords_from_uniforms(S, T)
