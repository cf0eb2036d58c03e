"""Fused analytic backward for one source chunk (kernel K2).

``backward_face_sums`` replaces the JAX package's Pallas kernel
(render/bwd_kernels.py ``_bwd_kernel`` / ``backward_face_sums_pallas``):
per ray it looks up the tap tables at the ray's fine bin, evaluates the
Lambertian gradient terms and reduces per face, over sources and samples,
to 12 floats (P*b1, P*b2, P*b3, S2).  On a CUDA tensor it runs
csrc/backward_face_sums.cu; on a CPU tensor, ``backward_face_sums_plain``
(the same per-ray arithmetic, operation for operation).

``backward_chunk_fused`` is the drop-in for core.backward_chunk
(Lambertian BRDF): it builds the tables, calls the face sums, and keeps the
per-face cross(T2f, opposite edge) epilogue and the face -> vertex sum.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _cuda
from ..geometry.mesh import scatter_faces
from .core import _EPS, _div, _tap_tables, opposite_edges

NV = 12      # per-face terms
SLAB = 16    # sources per kernel block (partial sums added in slab order)


def backward_face_sums_plain(dirs, normal, h, albw, bary, onorm, inv2a,
                             tables, spt: int, use_gn: bool,
                             bin_lower: float, fine_res: float, Bf: int):
    """Plain PyTorch version of ``backward_face_sums`` -> [F, 12]."""
    Lc, F = h.shape[0], h.shape[1]
    qf = torch.floor(_div(2.0 * h - bin_lower, fine_res))
    ok = (torch.abs(qf) < 2.0e9) & (qf >= 0.0) & (qf <= float(Bf))
    q = torch.where(ok, qf, 0.0).to(torch.int64)
    l_idx = torch.arange(Lc, device=h.device)[:, None, None]
    flat = (l_idx * 2) * (Bf + 1) + q
    tab = tables.reshape(-1)
    A = torch.where(ok, tab[flat], 0.0)
    Bw = torch.where(ok, tab[flat + (Bf + 1)], 0.0)

    dx, dy, dz = dirs.unbind(-1)
    nx, ny, nz = normal.unbind(-1)
    b1, b2, b3 = bary.unbind(-1)
    ox, oy, oz = (onorm[:, i, None, None] for i in range(3))
    inv2a = inv2a[None, :, None]

    cos2 = torch.clamp(ox * dx + oy * dy + oz * dz, min=0.0)
    cos3 = torch.clamp(-(nx * dx + ny * dy + nz * dz), min=0.0)
    hs = torch.clamp(h, min=1e-12)
    inv_h2 = 1.0 / (hs * hs)
    cc = cos2 * cos3
    ff = cc * inv_h2
    inten = albw * ff * ff
    s1 = albw * 2.0 * cc * inv_h2 * inv_h2 / hs
    t1x = s1 * (ox * cos3 - nx * cos2 - 4.0 * dx * cc)
    t1y = s1 * (oy * cos3 - ny * cos2 - 4.0 * dy * cc)
    t1z = s1 * (oz * cos3 - nz * cos2 - 4.0 * dz * cc)
    t2x, t2y, t2z = nx * inten, ny * inten, nz * inten
    if use_gn:
        sg = -2.0 * albw * cos3 * cos2 * cos2 * inv_h2 * inv_h2
        gx, gy, gz = sg * dx, sg * dy, sg * dz
        dot = gx * nx + gy * ny + gz * nz
        t2x = t2x + (gx - nx * dot)
        t2y = t2y + (gy - ny * dot)
        t2z = t2z + (gz - nz * dot)
    t2x, t2y, t2z = t2x * inv2a, t2y * inv2a, t2z * inv2a
    gsc = inten * Bw
    px = t1x * A + dx * gsc
    py = t1y * A + dy * gsc
    pz = t1z * A + dz * gsc
    terms = torch.stack([px * b1, py * b1, pz * b1, px * b2, py * b2, pz * b2,
                         px * b3, py * b3, pz * b3,
                         t2x * A, t2y * A, t2z * A], dim=-1)
    return terms.sum(dim=(0, 2))


def _check(name, t, shape, device):
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected float32 {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, rays on {device}")


def backward_face_sums(dirs, normal, h, albw, bary, onorm, inv2a, tables,
                       spt: int, use_gn: bool, bin_lower: float,
                       fine_res: float, Bf: int):
    """Per-face gradient sums [F, 12] for one source chunk.

    dirs, normal, bary [Lc,F,spt,3]; h, albw [Lc,F,spt] (albw = albedo *
    valid * area * (-2/spt)); onorm [Lc,3]; inv2a [F] = 1/(2*area);
    tables [Lc, 2, Bf+1] = (A_tab, Bw_tab * 2/sigma^2).
    Columns: 0:3 sum P*b1, 3:6 P*b2, 6:9 P*b3, 9:12 S2."""
    args = (dirs, normal, h, albw, bary, onorm, inv2a, tables, spt, use_gn,
            bin_lower, fine_res, Bf)
    if h.device.type == "cpu":
        return backward_face_sums_plain(*args)
    if h.device.type != "cuda":
        raise ValueError(f"backward_face_sums: unsupported device {h.device}")
    Lc, F = h.shape[0], h.shape[1]
    for name, t, shape in (
            ("dirs", dirs, (Lc, F, spt, 3)), ("normal", normal, (Lc, F, spt, 3)),
            ("h", h, (Lc, F, spt)), ("albw", albw, (Lc, F, spt)),
            ("bary", bary, (Lc, F, spt, 3)), ("onorm", onorm, (Lc, 3)),
            ("inv2a", inv2a, (F,)), ("tables", tables, (Lc, 2, Bf + 1))):
        _check(name, t, shape, h.device)
    nslab = -(-Lc // SLAB)
    partial = torch.empty((nslab, F, NV), dtype=torch.float32,
                          device=h.device)
    fn = _launcher()
    status = fn(*(_cuda.ptr(t) for t in (dirs, normal, h, albw, bary, onorm,
                                         inv2a, tables)),
                Lc, F, spt, Bf, SLAB, int(use_gn), bin_lower, fine_res,
                _cuda.ptr(partial), _cuda.stream(h.device))
    _cuda.check(status, "backward_face_sums")
    backward_face_sums.launches += 1
    return partial.sum(dim=0)


backward_face_sums.launches = 0


def _launcher():
    fn = _cuda.library("backward_face_sums").backward_face_sums_launch
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P] * 8 + [I] * 6 + [Fl] * 2 + [P, P]
    fn.restype = ctypes.c_int
    return fn


def face_sum_inputs(rays, lighting_normal, difference, source_offset: int,
                    cfg, spt: int):
    """The arguments of ``backward_face_sums`` for one source chunk: the
    rays' rows, the tap tables (Bw scaled by 2/sigma^2) and the scalars."""
    if cfg.brdf != "lambertian":
        raise NotImplementedError(f"brdf={cfg.brdf!r} is not ported yet")
    Lc = rays.h.shape[0]
    refine = cfg.bin_refine_resolution
    sigma2 = cfg.sigma * cfg.sigma
    A_tab, Bw_tab = _tap_tables(difference, source_offset, Lc, cfg)
    tables = torch.stack([A_tab, Bw_tab * (2.0 / sigma2)], dim=1).contiguous()
    albw = (rays.albedo * torch.where(rays.valid, 1.0, 0.0)
            * rays.area[None, :, None] * (-2.0 / float(spt)))
    inv2a = 1.0 / (2.0 * torch.clamp(rays.area, min=_EPS))
    use_gn = cfg.normal == "vn" and cfg.testing_flag == 0
    return (rays.dirs.contiguous(), rays.normal.contiguous(),
            rays.h.contiguous(), albw.contiguous(), rays.bary.contiguous(),
            lighting_normal.contiguous(), inv2a.contiguous(), tables, spt,
            use_gn, float(cfg.bin_lower),
            float(cfg.distance_resolution / refine), cfg.num_bins * refine)


def vertex_gradient(sums, mesh):
    """Face sums [F, 12] -> vertex gradient [V,3]: adds the per-face
    cross(T2f, opposite edge) and sums faces into their vertices."""
    T2f = sums[:, 9:12]
    edges = opposite_edges(mesh)
    per_face = torch.stack(
        [sums[:, 3 * k:3 * k + 3] + torch.linalg.cross(T2f, edges[k])
         for k in range(3)], dim=1)
    return scatter_faces(per_face, mesh.f, mesh.v.shape[0])


def backward_chunk_fused(rays, mesh, lighting_normal, difference,
                         source_offset: int, cfg, spt: int):
    """Drop-in for core.backward_chunk (Lambertian BRDF) -> [V,3]; the gn
    term is active exactly when backward_chunk's is (normal == 'vn' and
    testing_flag == 0)."""
    sums = backward_face_sums(*face_sum_inputs(
        rays, lighting_normal, difference, source_offset, cfg, spt))
    return vertex_gradient(sums, mesh)
