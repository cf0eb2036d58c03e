"""Delaunay-based height-field re-triangulation and midpoint upsampling.

The JAX package's geometry/delaunay.py with the port's mesh and
nearest-hit query (reference: exp_bunny/rendering.py):
  recompute_connectivity (:103-136): re-triangulate the vertices' xy by
    Delaunay, flip winding to face the wall, keep only triangles whose
    centroid's +z ray from the wall hits the current mesh (against the
    overhangs and concavities the 2-D triangulation fakes).
  grid_resample ('remesh', :138-179): resample the surface on a regular
    res x res grid of +z rays, append the border vertices, Delaunay the
    xy, validate the same way.
  upsample (:95-100): igl.upsample, 1-to-4 midpoint subdivision.

The triangulations are scipy's, on the host; the ray casts run on
``device`` (CUDA unless told otherwise), whose nearest-hit query equals
the CPU's bit for bit, so the faces do not depend on the device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from scipy.spatial import Delaunay

from .intersect import nearest_hit
from .mesh import Mesh, make_mesh


def _up_rays(o: np.ndarray, device):
    """+z rays from the points o [R, 3] (their z set to 0) on device."""
    o = torch.from_numpy(np.array(o, np.float32)).to(device)
    o[:, 2] = 0.0
    d = torch.zeros_like(o)
    d[:, 2] = 1.0
    return o, d


def _validate_faces(new_v: np.ndarray, new_f: np.ndarray, mesh: Mesh
                    ) -> np.ndarray:
    """Keep faces whose xy-centroid's upward ray hits the current mesh
    (rendering.py:106-136 / :166-178)."""
    c = (new_v[new_f[:, 0]] + new_v[new_f[:, 1]] + new_v[new_f[:, 2]]) / 3.0
    fid = nearest_hit(*_up_rays(c, mesh.device), mesh.v, mesh.f,
                      mesh.f_valid)[0]
    return fid.cpu().numpy() >= 0


def recompute_connectivity(v: np.ndarray, f: np.ndarray, device="cuda"
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Delaunay xy re-triangulation of the existing vertices, validated by
    upward ray casts (rendering.py:103-136)."""
    tri = Delaunay(v[:, :2])
    new_f = np.asarray(tri.simplices[:, [0, 2, 1]], np.int32)  # flip winding
    keep = _validate_faces(v, new_f, make_mesh(v, f, device=device))
    return v, new_f[keep]


def grid_resample(v: np.ndarray, f: np.ndarray, res: int,
                  border_v: np.ndarray,
                  lower=(-0.25, -0.25), upper=(0.25, 0.25), device="cuda"
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Resample the surface on a res x res grid of +z rays, append border
    vertices, re-Delaunay, validate (rendering.py:138-179 'remesh')."""
    xs = np.linspace(lower[0], upper[0], res)
    ys = np.linspace(lower[1], upper[1], res)
    gx, gy = np.meshgrid(xs, ys)
    o = np.stack([gx.ravel(), gy.ravel(), np.zeros(res * res)], 1
                 ).astype(np.float32)
    mesh = make_mesh(v, f, device=device)
    fid, _, _, t = nearest_hit(*_up_rays(o, device), mesh.v, mesh.f,
                               mesh.f_valid)
    hit = fid.cpu().numpy() >= 0
    p = o.copy()
    p[:, 2] = t.cpu().numpy()
    pts = p[hit]

    new_v = np.vstack([pts, v[border_v == 1]]).astype(np.float32)
    tri = Delaunay(new_v[:, :2])
    new_f = np.asarray(tri.simplices[:, [0, 2, 1]], np.int32)
    keep = _validate_faces(new_v, new_f, mesh)
    return new_v, new_f[keep]


def upsample(v: np.ndarray, f: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray]:
    """1-to-4 midpoint subdivision (igl.upsample semantics,
    rendering.py:95-100): every edge gets a midpoint vertex; each triangle
    becomes 4."""
    v = np.asarray(v, np.float64)
    f = np.asarray(f, np.int64)
    edge_id = {}
    verts = [v[i] for i in range(v.shape[0])]

    def mid(a: int, b: int) -> int:
        key = (min(a, b), max(a, b))
        if key not in edge_id:
            edge_id[key] = len(verts)
            verts.append((v[a] + v[b]) / 2.0)
        return edge_id[key]

    out = []
    for a, b, c in f:
        ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
        out.extend([[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]])
    return (np.asarray(verts, np.float32),
            np.asarray(out, np.int32).reshape(-1, 3))
