"""Morton face ordering and Möller–Trumbore as a matrix product.

Spatially compact face groups are what keep the occlusion kernel's
candidate lists short: raster-ordered height-field groups span the whole
mesh, Morton-ordered ones are patch shaped.  The ordering is numpy, run on
the host between optimizer steps, copied from the JAX package.

``mt_coefficients`` gives the per-face block of the matrix form of
Möller–Trumbore that ``geometry.intersect.segment_occluded_mxu`` uses.
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


def cross3(a, b):
    """a x b over the last axis, component by component as jnp.cross."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def mt_coefficients(soup: torch.Tensor):
    """Möller–Trumbore as a matrix product: per-face coefficient blocks.

    MT's quantities are bilinear in per-ray and per-face data:
        det   = d . (e2 x e1)
        u_num = (o x d) . e2  -  d . (e2 x p1)
        v_num = -(o x d) . e1 +  d . (e1 x p1)
        t_num = o . (e1 x e2) -  p1 . (e1 x e2)
    so with the per-ray features phi = [d, o x d, o, 1] (10) and a 10 x 4
    block per face, (det, u_num, v_num, t_num) of every (ray, face) pair
    come from one product phi @ B; the sign tests avoid the divides.

    soup [..., CS, 10] (p1 | e1 | e2 | valid) -> (B [..., 10, 4*CS] with
    the columns (det, u, v, t) of face 0, then of face 1, ...; the valid
    plane [..., CS])."""
    p1, e1, e2, val = soup[..., 0:3], soup[..., 3:6], soup[..., 6:9], \
        soup[..., 9]
    n2 = cross3(e2, e1)
    m1 = cross3(e2, p1)
    k1 = cross3(e1, p1)
    n12 = -n2
    zeros = torch.zeros_like(p1)
    zcol = torch.zeros_like(val)[..., None]
    b_det = torch.cat([n2, zeros, zeros, zcol], dim=-1)
    b_u = torch.cat([-m1, e2, zeros, zcol], dim=-1)
    b_v = torch.cat([k1, -e1, zeros, zcol], dim=-1)
    offset = -(p1[..., 0] * n12[..., 0] + p1[..., 1] * n12[..., 1]
               + p1[..., 2] * n12[..., 2])
    b_t = torch.cat([zeros, zeros, n12, offset[..., None]], dim=-1)
    B = torch.stack([b_det, b_u, b_v, b_t], dim=-2)      # [..., CS, 4, 10]
    B = B.reshape(*B.shape[:-3], -1, 10).transpose(-1, -2)
    return B, val
