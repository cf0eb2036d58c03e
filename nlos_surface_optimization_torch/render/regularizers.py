"""Mesh regularizers: total-area (curvature) gradient and normal smoothness.

The formulas are the intended per-face sums (the reference's native code
overwrites shared vertices in a per-thread race); vertex scatters use the
deterministic ``segment_sum``.
"""

from __future__ import annotations

import torch

from ..geometry.mesh import face_normals_areas, norm3, scatter_faces
from ..geometry.mesh import total_area  # noqa: F401  (re-exported)


def _scatter_cross(term, p1, p2, p3, f, num_v):
    """Scatter cross(term, opposite_edge/2) into the 3 vertex slots."""
    per_face = torch.stack([
        torch.linalg.cross(term, (p3 - p2) / 2.0),
        torch.linalg.cross(term, (p1 - p3) / 2.0),
        torch.linalg.cross(term, (p2 - p1) / 2.0),
    ], dim=1)
    return scatter_faces(per_face, f, num_v)


def curvature_gradient(v, f, f_valid):
    """d(total mesh area)/d(vertices) -> [V,3]."""
    p1, p2, p3 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    n, _ = face_normals_areas(v, f)
    n = torch.where(f_valid[:, None], n, 0.0)
    return _scatter_cross(n, p1, p2, p3, f, v.shape[0])


def normal_smoothing(v, f, f_valid, affinity):
    """(value, gradient [V,3]) of the area-weighted neighbour-normal
    misalignment:  m_i = normalize(a_i n_i + sum_{j in N(i)} a_j n_j),
    value = sum_i a_i (1 - m_i . n_i),  grad = scatter cross(n_i - m_i,
    e_opp/2).  affinity [F,3], -1 = border."""
    affinity = torch.as_tensor(affinity, device=v.device).to(torch.int64)
    p1, p2, p3 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    n, area = face_normals_areas(v, f)
    area = torch.where(f_valid, area, 0.0)
    wn = n * area[:, None]
    nb = torch.clamp(affinity, 0, f.shape[0] - 1)
    nb_ok = (affinity >= 0) & f_valid[:, None] & f_valid[nb]
    acc = wn + torch.where(nb_ok[..., None], wn[nb], 0.0).sum(dim=1)
    m = acc / torch.clamp(norm3(acc, keepdim=True), min=1e-30)
    value = (area * (1.0 - (m * n).sum(dim=-1))).sum()
    residual = torch.where(f_valid[:, None], n - m, 0.0)
    return value, _scatter_cross(residual, p1, p2, p3, f, v.shape[0])


def curvature_gradient_mesh(mesh):
    return curvature_gradient(mesh.v, mesh.f, mesh.f_valid)


def normal_smoothing_mesh(mesh, affinity):
    return normal_smoothing(mesh.v, mesh.f, mesh.f_valid, affinity)
