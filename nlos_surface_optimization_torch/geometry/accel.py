"""Morton face ordering (numpy, host side, between optimizer steps).

Spatially compact face groups are what keep the occlusion kernel's
candidate lists short: raster-ordered height-field groups span the whole
mesh, Morton-ordered ones are patch shaped.  Copied from the JAX package.
"""

from __future__ import annotations

import numpy as np


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
