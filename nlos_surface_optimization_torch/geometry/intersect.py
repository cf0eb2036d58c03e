"""Ray-triangle intersection and segment visibility (eager PyTorch).

A sample at distance t_self along its ray is visible iff no OTHER valid
face crosses the segment strictly before it.  ``segment_occluded`` is the
divide-based Möller–Trumbore reference, tiled over faces and rays to bound
the [rays, faces] working set.  The occlusion kernel's predicate (sign-safe,
no divide) lives beside the kernel in render/fused_kernels.py.

``segment_occluded_mxu`` is the same query with Möller–Trumbore cast as
one float32 matrix product per (ray chunk, face tile) (geometry/accel.py
``mt_coefficients``, TF32 off) and divide-free sign tests: the JAX
package's matmul-form narrow phase, there for the TPU's matrix unit.

``nearest_hit`` is the nearest-hit query the geometry pipeline and the
evaluation use (an Embree ray stream in the reference), with the same
tiling: it serves initialization and evaluation, not the descent step.
"""

from __future__ import annotations

import torch

from .accel import cross3, mt_coefficients
from .mesh import matmul_f32

_DEF_TILE = 512
_RAY_CHUNK = 16384
# nearest_hit's rays a chunk on the CPU: [1,024, 512] temporaries stay in
# cache (about 1.25x the speed of 16,384 there)
_CPU_RAY_CHUNK = 1024


def _cross(ax, ay, az, bx, by, bz):
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def moller_trumbore(o, d, p1, e1, e2, eps_det=1e-12):
    """Batched Möller–Trumbore.  o, d [R,3]; p1, e1, e2 [K,3] (first vertex,
    edges v2-v1, v3-v1).  Returns (t, u, v, hit), each [R, K]."""
    ox, oy, oz = (o[:, None, i] for i in range(3))
    dx, dy, dz = (d[:, None, i] for i in range(3))
    p1x, p1y, p1z = (p1[None, :, i] for i in range(3))
    e1x, e1y, e1z = (e1[None, :, i] for i in range(3))
    e2x, e2y, e2z = (e2[None, :, i] for i in range(3))
    pvx, pvy, pvz = _cross(dx, dy, dz, e2x, e2y, e2z)
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = torch.abs(det) > eps_det
    inv_det = torch.where(ok, 1.0 / det, 0.0)
    tvx, tvy, tvz = ox - p1x, oy - p1y, oz - p1z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx, qvy, qvz = _cross(tvx, tvy, tvz, e1x, e1y, e1z)
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, hit


def _face_edges(v, f):
    """(p1, e1, e2) each [F,3] f32."""
    p1 = v[f[:, 0]]
    return p1, v[f[:, 1]] - p1, v[f[:, 2]] - p1


def segment_occluded(o, d, t_self, self_fid, v, f, f_valid,
                     t_rel=1e-4, t_min=1e-6, tile=_DEF_TILE,
                     ray_chunk=_RAY_CHUNK):
    """[R] bool: the segment o -> o + d*t_self is blocked by another valid
    face at t in (t_min, t_self*(1-t_rel))."""
    p1, e1, e2 = _face_edges(v, f)
    F = f.shape[0]
    R = o.shape[0]
    occ = torch.zeros(R, dtype=torch.bool, device=o.device)
    t_cut = t_self * (1.0 - t_rel)
    fids = torch.arange(F, device=o.device)
    for r0 in range(0, R, ray_chunk):
        rs = slice(r0, min(r0 + ray_chunk, R))
        acc = occ[rs]
        for f0 in range(0, F, tile):
            fs = slice(f0, min(f0 + tile, F))
            t, _, _, hit = moller_trumbore(o[rs], d[rs], p1[fs], e1[fs], e2[fs])
            blocked = (hit & f_valid[None, fs] & (t > t_min)
                       & (t < t_cut[rs, None])
                       & (fids[None, fs] != self_fid[rs, None]))
            acc = acc | blocked.any(dim=1)
        occ[rs] = acc
    return occ


def segment_occluded_mxu(o, d, t_self, self_fid, v, f, f_valid,
                         t_rel=1e-4, t_min=1e-6, tile=_DEF_TILE,
                         ray_chunk=_RAY_CHUNK):
    """``segment_occluded`` through the matrix form: for each chunk of
    ``ray_chunk`` rays and tile of ``tile`` faces, phi [r, 10] @ B [10,
    4*tile] gives (det, u_num, v_num, t_num) of every pair, and the
    sign tests decide."""
    p1, e1, e2 = _face_edges(v, f)
    soup = torch.cat([p1, e1, e2, f_valid.to(p1.dtype)[:, None]], dim=1)
    B_all, val = mt_coefficients(soup)                  # [10, 4F], [F]
    phi = torch.cat([d, cross3(o, d), o, torch.ones_like(o[:, :1])], dim=1)
    F, R = f.shape[0], o.shape[0]
    occ = torch.zeros(R, dtype=torch.bool, device=o.device)
    t_cut = t_self * (1.0 - t_rel)
    fids = torch.arange(F, device=o.device)
    for f0 in range(0, F, tile):
        fs = slice(f0, min(f0 + tile, F))
        B = B_all[:, 4 * fs.start:4 * fs.stop]
        for r0 in range(0, R, ray_chunk):
            rs = slice(r0, min(r0 + ray_chunk, R))
            out = matmul_f32(phi[rs], B).reshape(-1, fs.stop - fs.start, 4)
            det, u_num, v_num, t_num = out.unbind(-1)
            tc = t_cut[rs, None]
            blocked = ((torch.abs(det) > 1e-12)
                       & (u_num * det >= 0.0) & (v_num * det >= 0.0)
                       & ((u_num + v_num - det) * det <= 0.0)
                       & ((t_num - t_min * det) * det > 0.0)
                       & ((t_num - tc * det) * det < 0.0)
                       & (val[None, fs] != 0.0)
                       & (fids[None, fs] != self_fid[rs, None]))
            occ[rs] |= blocked.any(dim=1)
    return occ


def nearest_hit(o, d, v, f, f_valid, t_min=1e-6, tile=_DEF_TILE,
                ray_chunk=None):
    """The nearest valid face each ray [R] hits at t > t_min ->
    (fid int32, u, v, t); fid -1, u = v = 0 and t -1 on a miss.  The
    smallest t wins, and on equal t the lowest face id, whatever the
    tile.  ``ray_chunk`` rays a chunk (None: 16,384 on a card, 1,024 on
    the CPU); the result does not depend on it."""
    p1, e1, e2 = _face_edges(v, f)
    F, R = f.shape[0], o.shape[0]
    dev, dt = o.device, o.dtype
    best_t = torch.full((R,), float("inf"), dtype=dt, device=dev)
    best_f = torch.full((R,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros(R, dtype=dt, device=dev)
    best_v = torch.zeros(R, dtype=dt, device=dev)
    if ray_chunk is None:
        ray_chunk = _CPU_RAY_CHUNK if dev.type == "cpu" else _RAY_CHUNK
    for r0 in range(0, R, ray_chunk):
        rs = slice(r0, min(r0 + ray_chunk, R))
        rows = torch.arange(rs.stop - rs.start, device=dev)
        for f0 in range(0, F, tile):
            fs = slice(f0, min(f0 + tile, F))
            t, u, w, hit = moller_trumbore(o[rs], d[rs], p1[fs], e1[fs],
                                           e2[fs])
            t = torch.where(hit & f_valid[None, fs] & (t > t_min), t,
                            float("inf"))
            j = t.argmin(dim=1)             # the first of equal minima
            tj = t[rows, j]
            better = tj < best_t[rs]
            best_t[rs] = torch.where(better, tj, best_t[rs])
            best_f[rs] = torch.where(better, j + f0, best_f[rs])
            best_u[rs] = torch.where(better, u[rows, j], best_u[rs])
            best_v[rs] = torch.where(better, w[rows, j], best_v[rs])
    t = torch.where(torch.isfinite(best_t), best_t, -1.0)
    return best_f.to(torch.int32), best_u, best_v, t


def ray_mesh_barycoords(o, d, v, f, f_valid=None):
    """[R, 3] (fid, u, v) of each ray's nearest hit, fid as a float and -1
    on a miss (the reference's embree_intersector module API)."""
    if f_valid is None:
        f_valid = torch.ones(f.shape[0], dtype=torch.bool, device=f.device)
    fid, u, w, _ = nearest_hit(o, d, v, f, f_valid)
    return torch.stack([fid.to(u.dtype), u, w], dim=-1)
