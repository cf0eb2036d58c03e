"""A frozen copy of the counter-based sampler: threefry-2x32 (20 rounds),
``fold_in`` and the float32 uniforms of JAX's partitionable threefry, in
int64 tensors masked to 32 bits.

Draw for (global source l, face j, slot s): the key fold_in(key, l), the
counters c = 2*(j*spt + s) and c + 1, each float
((bits >> 9) | 0x3f800000) - 1 with bits the two output words xor-ed;
S is the first, T the second.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def key(seed: int) -> torch.Tensor:
    """The two words of the key of ``seed`` (a 64-bit integer)."""
    s = int(seed) % (1 << 64)
    return torch.tensor([s >> 32, s & MASK], dtype=torch.int64)


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1):
    ks = (k0, k1, (k0 ^ k1 ^ 0x1BD11BDA) & MASK)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def fold_in(k: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Keys [N, 2] of k folded with each data word."""
    data = data.to(torch.int64) & MASK
    y0, y1 = threefry2x32(k[0], k[1], torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def _unit(bits: torch.Tensor) -> torch.Tensor:
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniforms(k: torch.Tensor, source: torch.Tensor, face: torch.Tensor,
             slot: torch.Tensor, spt: int):
    """(S, T) float32 [N] of the rays (source [N] key index, face [N],
    slot [N]); ``source`` is the index the key is folded with."""
    keys = fold_in(k.to(source.device), source)
    c = 2 * (face.to(torch.int64) * spt + slot.to(torch.int64))
    out = []
    for cc in (c, c + 1):
        b1, b2 = threefry2x32(keys[:, 0], keys[:, 1], cc >> 32, cc & MASK)
        out.append(_unit(b1 ^ b2))
    return out[0], out[1]
