"""Morton face ordering (numpy, host side, between optimizer steps).

Spatially compact face groups are what keep the occlusion kernel's
candidate lists short: raster-ordered height-field groups span the whole
mesh, Morton-ordered ones are patch shaped.  Copied from the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def _morton3(x: np.ndarray, bits: int = 10) -> np.ndarray:
    """Interleave 3x bits-bit integers -> Morton codes."""
    def part(v):
        v = v.astype(np.uint64)
        v = (v | (v << 32)) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << 16)) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << 8)) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << 4)) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << 2)) & np.uint64(0x1249249249249249)
        return v

    q = np.clip((x * (2 ** bits - 1)).astype(np.int64), 0, 2 ** bits - 1)
    return (part(q[:, 0]) | (part(q[:, 1]) << np.uint64(1))
            | (part(q[:, 2]) << np.uint64(2)))


def morton_order_faces(v: np.ndarray, f: np.ndarray) -> np.ndarray:
    """Faces reordered by centroid Morton code (stable)."""
    v = np.asarray(v)
    f = np.asarray(f)
    if f.shape[0] < 2:
        return f
    cent = (v[f[:, 0]] + v[f[:, 1]] + v[f[:, 2]]) / 3.0
    lo = cent.min(axis=0)
    span = np.maximum(cent.max(axis=0) - lo, 1e-12)
    codes = _morton3((cent - lo) / span)
    return f[np.argsort(codes, kind="stable")]


def morton_order_torch(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """``morton_order_faces`` as a permutation [F] int64, on the tensors'
    device: the same f32 steps as the numpy version (true divisions), so
    faces already in that order get the identity."""
    F = f.shape[0]
    if F < 2:
        return torch.arange(F, device=f.device)
    three = torch.full((), 3.0, dtype=v.dtype, device=v.device)
    cent = (v[f[:, 0]] + v[f[:, 1]] + v[f[:, 2]]) / three
    lo = cent.amin(dim=0)
    span = torch.clamp(cent.amax(dim=0) - lo, min=1e-12)
    q = torch.clamp(((cent - lo) / span * 1023).to(torch.int64), 0, 1023)
    code = torch.zeros(F, dtype=torch.int64, device=f.device)
    for axis in range(3):
        x = q[:, axis]
        for shift, mask in ((32, 0x1F00000000FFFF), (16, 0x1F0000FF0000FF),
                            (8, 0x100F00F00F00F00F), (4, 0x10C30C30C30C30C3),
                            (2, 0x1249249249249249)):
            x = (x | (x << shift)) & mask
        code |= x << axis
    return torch.sort(code, stable=True).indices
