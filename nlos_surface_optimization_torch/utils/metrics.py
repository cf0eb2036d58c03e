"""Evaluation metrics.

compute_v2: mean UNSIGNED distance from the current vertices to the GT mesh
(the reference's igl.signed_distance with SIGNED_DISTANCE_TYPE_UNSIGNED), as
the JAX package computes it: an exact point-triangle distance (Ericson,
Real-Time Collision Detection §5.1.5) min-reduced over faces, dense over
[points, faces] in batches of points so the working set stays bounded.
"""

from __future__ import annotations

import torch

from ..geometry.mesh import Mesh

POINT_BATCH = 1024


def _dot(a, b):
    return (a * b).sum(-1)


def _point_triangle_dist2(p, a, b, c):
    """Squared distance point->triangle; p, a, b, c broadcast over [.., 3]."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = _dot(ab, ap)
    d2 = _dot(ac, ap)
    bp = p - b
    d3 = _dot(ab, bp)
    d4 = _dot(ac, bp)
    cp = p - c
    d5 = _dot(ab, cp)
    d6 = _dot(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    # region tests in priority order, composed with where: vertex regions,
    # then edge regions, then the face interior
    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    v_ab = torch.where(torch.abs(d1 - d3) > 0, d1 / (d1 - d3 + 1e-300), 0.0)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    w_ac = torch.where(torch.abs(d2 - d6) > 0, d2 / (d2 - d6 + 1e-300), 0.0)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    w_bc = torch.where(
        torch.abs((d4 - d3) + (d5 - d6)) > 0,
        (d4 - d3) / ((d4 - d3) + (d5 - d6) + 1e-300), 0.0)
    on_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)

    denom = 1.0 / torch.clamp(va + vb + vc, min=1e-300)
    v_in = vb * denom
    w_in = vc * denom

    closest = a + v_in[..., None] * ab + w_in[..., None] * ac
    closest = torch.where(on_bc[..., None], b + w_bc[..., None] * (c - b),
                          closest)
    closest = torch.where(on_ac[..., None], a + w_ac[..., None] * ac, closest)
    closest = torch.where(on_ab[..., None], a + v_ab[..., None] * ab, closest)
    closest = torch.where(in_c[..., None], c, closest)
    closest = torch.where(in_b[..., None], b, closest)
    closest = torch.where(in_a[..., None], a, closest)
    d = p - closest
    return _dot(d, d)


def point_mesh_distance(points, v, f, f_valid,
                        batch: int = POINT_BATCH) -> torch.Tensor:
    """Unsigned distance [P] from each point to the mesh surface (points
    taken in the mesh's dtype, on its device)."""
    points = torch.as_tensor(points).to(device=v.device, dtype=v.dtype)
    a, b, c = (v[f[:, k]][None] for k in range(3))           # [1, F, 3]
    out = []
    for p0 in range(0, points.shape[0], batch):
        p = points[p0:p0 + batch, None, :]                   # [P, 1, 3]
        d2 = _point_triangle_dist2(p, a, b, c)
        d2 = torch.where(f_valid[None, :], d2, torch.inf)
        out.append(torch.sqrt(d2.amin(dim=1)))
    if not out:
        return points.new_zeros(0)
    return torch.cat(out)


def compute_v2(v, gt_mesh: Mesh) -> torch.Tensor:
    """Mean unsigned distance of vertices to the GT mesh."""
    return point_mesh_distance(v, gt_mesh.v, gt_mesh.f,
                               gt_mesh.f_valid).mean()
