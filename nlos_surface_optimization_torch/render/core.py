"""Core confocal transient rendering: forward splat + analytic backward.

Work for one source chunk is a dense set of rays [Lc, F, spt] (source x
face x sample).  The forward bins each visible sample's contribution into
a fine per-source histogram; the backward collapses the K-tap Gaussian
loop of the gradient into two per-fine-bin table lookups per ray
(``_tap_tables``), then reduces per face and scatters to vertices.

Deliberate deviations kept from the JAX package: out-of-range kernel taps
are masked to zero, and a sample whose coarse bin lands exactly on
num_bins is dropped.

Divisions by a configuration constant that decide a histogram bin go
through ``_div``, a division by a 0-dim tensor on the operand's device:
PyTorch on CUDA turns division by a Python scalar into multiplication by
its reciprocal, which can move a sample across a bin boundary.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..config import RenderConfig
from ..geometry.intersect import segment_occluded
from ..geometry.mesh import Mesh, face_normals_areas, norm3, scatter_faces
from ..geometry.sampling import stratified_barycoords
from .kernels import grouped_gaussian_tables

_EPS = 1e-30


class RayBatch(NamedTuple):
    """Per-ray quantities for a source chunk; leading shape [Lc, F, spt].

    ``valid`` = f_valid & in-range & visible, meaningful only for rays with
    a nonzero shading contribution (zero-contribution rays skip the
    visibility query, see ``_occl_skip_mask``)."""

    dirs: torch.Tensor    # [Lc,F,spt,3] unit ray directions
    h: torch.Tensor       # [Lc,F,spt]   half path length |p - o|
    normal: torch.Tensor  # [Lc,F,spt,3] shading normal
    albedo: torch.Tensor  # [Lc,F,spt]
    bary: torch.Tensor    # [Lc,F,spt,3]
    valid: torch.Tensor   # [Lc,F,spt] bool
    area: torch.Tensor    # [F]
    face_n: torch.Tensor  # [F,3]


def _div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s rounded as a true f32 division on every device."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def fine_bins(h: torch.Tensor, bin_lower: float, fine_res: float) -> torch.Tensor:
    """floor((2h - bin_lower) / fine_res) as int32."""
    return torch.floor(_div(2.0 * h - bin_lower, fine_res)).to(torch.int32)


def _dot(a, b):
    """Sum of a*b over the last axis of length 3, x, y, z in order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _sample_chunk(mesh: Mesh, lighting, key, cfg: RenderConfig, spt: int,
                  source_offset: int):
    """Stratified sampling + ray setup for one source chunk (no occlusion).

    Returns (bary, dirs, hs, in_range, face_n, area, flat o/d/t/fid)."""
    Lc = lighting.shape[0]
    F = mesh.f.shape[0]
    v1, v2, v3 = (mesh.v[mesh.f[:, k]] for k in range(3))
    face_n, area = face_normals_areas(mesh.v, mesh.f)

    bary = stratified_barycoords(key, Lc, F, spt, source_offset,
                                 device=mesh.device)           # [Lc,F,spt,3]
    p = (bary[..., 0:1] * v1[None, :, None, :]
         + bary[..., 1:2] * v2[None, :, None, :]
         + bary[..., 2:3] * v3[None, :, None, :])
    o = lighting[:, None, None, :]
    dvec = p - o
    h = norm3(dvec)
    hs = torch.clamp(h, min=1e-12)
    dirs = dvec / hs[..., None]
    in_range = (h >= cfg.bin_lower / 2.0) & (h <= cfg.bin_upper / 2.0)

    R = Lc * F * spt
    o_flat = o.expand(p.shape).reshape(R, 3)
    d_flat = dirs.reshape(R, 3)
    t_flat = hs.reshape(R)
    fid = torch.arange(F, dtype=torch.int32, device=mesh.device)[None, :, None]
    fid = fid.expand(Lc, F, spt).reshape(R)
    return bary, dirs, hs, in_range, face_n, area, o_flat, d_flat, t_flat, fid


def _interp_attrs(mesh: Mesh, bary, dirs, face_n, cfg: RenderConfig):
    """(shading normal, interpolated albedo) per ray; 'vn' normals are
    interpolated and NOT renormalized, as in the reference."""
    if cfg.normal == "vn":
        n1, n2, n3 = (mesh.vn[mesh.f[:, k]] for k in range(3))
        normal = (bary[..., 0:1] * n1[None, :, None, :]
                  + bary[..., 1:2] * n2[None, :, None, :]
                  + bary[..., 2:3] * n3[None, :, None, :])
    else:
        normal = face_n[None, :, None, :].expand(dirs.shape)
    a1, a2, a3 = (mesh.albedo[mesh.f[:, k]] for k in range(3))
    alb = (bary[..., 0] * a1[None, :, None]
           + bary[..., 1] * a2[None, :, None]
           + bary[..., 2] * a3[None, :, None])
    return normal, alb


def _occl_skip_mask(dirs, normal, face_n, lighting_normal, pre_valid):
    """Rays whose contribution is exactly zero in every consumer (forward
    splat, backward, intensity pass), so their occlusion is irrelevant:
      forward   max(0, cos2*cos3m)   -> cos2*cos3m <= 0
      intensity max(0, cos2*cos3f)   -> cos2*cos3f <= 0
      backward  separate clamps      -> cos2 <= 0 or cos3m <= 0."""
    cos2 = _dot(lighting_normal[:, None, None, :], dirs)
    cos3m = -_dot(normal, dirs)
    cos3f = -_dot(face_n[None, :, None, :], dirs)
    dead = ((cos2 * cos3m <= 0.0) & (cos2 * cos3f <= 0.0)
            & ((cos2 <= 0.0) | (cos3m <= 0.0)))
    return ~pre_valid | dead


def _pre_valid(mesh: Mesh, in_range, area):
    return mesh.f_valid[None, :, None] & in_range & (area > 0)[None, :, None]


def occlusion_inputs(mesh: Mesh, lighting, lighting_normal, key,
                     cfg: RenderConfig, spt: int, source_offset: int = 0):
    """(RayBatch before occlusion, args, kwargs) of the visibility query
    for one source chunk: ``segment_occluded(*args, **kwargs)``.  Rays
    whose contribution is zero in every consumer get t_self = 0 and skip
    the test."""
    (bary, dirs, hs, in_range, face_n, area,
     o_flat, d_flat, t_flat, fid) = _sample_chunk(
        mesh, lighting, key, cfg, spt, source_offset)
    normal, alb = _interp_attrs(mesh, bary, dirs, face_n, cfg)
    pre_valid = _pre_valid(mesh, in_range, area)
    skip = _occl_skip_mask(dirs, normal, face_n, lighting_normal, pre_valid)
    t_flat = torch.where(skip.reshape(-1), 0.0, t_flat)
    rays_pre = RayBatch(dirs=dirs, h=hs, normal=normal, albedo=alb,
                        bary=bary, valid=pre_valid, area=area, face_n=face_n)
    args = (o_flat.contiguous(), d_flat, t_flat, fid, mesh.v, mesh.f,
            mesh.f_valid)
    return rays_pre, args, dict(t_rel=cfg.occl_t_rel, t_min=cfg.occl_t_min)


def trace_chunk(mesh: Mesh, lighting, lighting_normal, key, cfg: RenderConfig,
                spt: int, source_offset: int = 0, hier=None) -> RayBatch:
    """Sample every face from every source in the chunk and run the
    visibility query: the standalone visibility kernel
    (render/occl_kernels.segment_occluded, its plain version on the CPU;
    ``hier`` the mesh's fused_kernels.face_hierarchy, built per call when
    None), or with occl_backend 'jnp' the eager divide-based
    segment_occluded."""
    rays_pre, args, kwargs = occlusion_inputs(mesh, lighting, lighting_normal,
                                              key, cfg, spt, source_offset)
    if cfg.occl_backend == "jnp":
        occ = segment_occluded(*args, **kwargs)
    else:
        from .occl_kernels import segment_occluded as occl

        occ = occl(*args, **kwargs, hier=hier)
    return rays_pre._replace(
        valid=rays_pre.valid & ~occ.reshape(rays_pre.h.shape))


def _contrib_and_bins(rays: RayBatch, lighting_normal, cfg: RenderConfig,
                      spt: int, refine: int):
    """Per-ray forward contribution (masked by rays.valid and the bin
    range) and its fine bin clipped to [0, Bf)."""
    cos2 = _dot(lighting_normal[:, None, None, :], rays.dirs)
    cos3 = -_dot(rays.normal, rays.dirs)
    ff = torch.clamp(cos3 * cos2, min=0.0) / (rays.h * rays.h)
    contrib = rays.area[None, :, None] * rays.albedo * ff * ff
    contrib = contrib * _brdf_value(rays, cfg)
    contrib = torch.where(rays.valid, contrib, 0.0) / float(spt)
    Bf = cfg.num_bins * refine
    bin_f = fine_bins(rays.h, cfg.bin_lower, cfg.distance_resolution / refine)
    ok = (bin_f >= 0) & (bin_f < Bf)
    contrib = torch.where(ok, contrib, 0.0)
    return contrib, torch.clamp(bin_f, 0, Bf - 1)


def splat_inputs(mesh: Mesh, lighting, lighting_normal, key,
                 cfg: RenderConfig, spt: int, refine: int,
                 source_offset: int = 0):
    """(RayBatch before occlusion, args, kwargs) of the fused occlusion +
    splat call for one source chunk: ``occluded_splat(*args, **kwargs)``.

    The contribution is computed before occlusion (the kernel zeroes
    occluded rays); rays whose contribution is zero everywhere get
    t_self = 0 and skip the visibility test."""
    rays_pre, (o, d, t, fid, v, f, f_valid), kwargs = occlusion_inputs(
        mesh, lighting, lighting_normal, key, cfg, spt, source_offset)
    contrib, bin_f = _contrib_and_bins(rays_pre, lighting_normal, cfg, spt,
                                       refine)
    args = (o, d, t, fid, contrib.reshape(-1), bin_f.reshape(-1), v, f,
            f_valid, lighting.shape[0], cfg.num_bins * refine)
    return rays_pre, args, kwargs


def trace_forward_fused(mesh: Mesh, lighting, lighting_normal, key,
                        cfg: RenderConfig, spt: int, refine: int,
                        source_offset: int = 0, hier=None):
    """(RayBatch, fine histogram [Lc, num_bins*refine]) through the fused
    occlusion + splat kernel (render/fused_kernels.occluded_splat; ``hier``
    as for trace_chunk).

    Same semantics as trace_chunk + forward_chunk."""
    from .fused_kernels import occluded_splat

    rays_pre, args, kwargs = splat_inputs(mesh, lighting, lighting_normal,
                                          key, cfg, spt, refine,
                                          source_offset)
    occ, hist = occluded_splat(*args, **kwargs, hier=hier)
    rays = rays_pre._replace(
        valid=rays_pre.valid & ~occ.reshape(rays_pre.h.shape))
    return rays, hist


def _brdf_value(rays: RayBatch, cfg: RenderConfig):
    """BRDF multiplier per ray (1 for Lambertian)."""
    if cfg.brdf != "lambertian":
        raise NotImplementedError(f"brdf={cfg.brdf!r} is not ported yet")
    return torch.ones_like(rays.h)


def forward_chunk(rays: RayBatch, lighting_normal, cfg: RenderConfig,
                  spt: int, refine: int):
    """Fine histogram [Lc, num_bins*refine] for one source chunk (eager
    splat; the forward clamps the cosine product)."""
    Lc = rays.h.shape[0]
    Bf = cfg.num_bins * refine
    contrib, bin_f = _contrib_and_bins(rays, lighting_normal, cfg, spt, refine)
    l_idx = torch.arange(Lc, device=bin_f.device)[:, None, None]
    seg = (l_idx * Bf + bin_f).reshape(-1)
    hist = torch.zeros(Lc * Bf, dtype=contrib.dtype, device=contrib.device)
    return hist.index_add_(0, seg, contrib.reshape(-1)).reshape(Lc, Bf)


def intensity_chunk(rays: RayBatch, lighting_normal, cfg: RenderConfig,
                    spt: int):
    """Per-face visibility intensity [F] summed over the chunk's sources
    (face normals, unit albedo)."""
    cos2 = _dot(lighting_normal[:, None, None, :], rays.dirs)
    cos3 = -_dot(rays.face_n[None, :, None, :], rays.dirs)
    ff = torch.clamp(cos3 * cos2, min=0.0) / (rays.h * rays.h)
    contrib = rays.area[None, :, None] * ff * ff
    contrib = torch.where(rays.valid, contrib, 0.0) / float(spt)
    return contrib.sum(dim=(0, 2))


def _gradient_terms(rays: RayBatch, lighting_normal, cfg: RenderConfig):
    """Per-ray gradient ingredients (t1 [.,3], t2 [.,3], intensity, ff2),
    Lambertian BRDF, cosines clamped separately."""
    if cfg.brdf != "lambertian":
        raise NotImplementedError(f"brdf={cfg.brdf!r} is not ported yet")
    onorm = lighting_normal[:, None, None, :]
    cos2 = torch.clamp(_dot(onorm, rays.dirs), min=0.0)
    cos3 = torch.clamp(-_dot(rays.normal, rays.dirs), min=0.0)
    h = rays.h
    ff = cos2 * cos3 / (h * h)
    ff2 = ff * ff
    area_s = torch.clamp(rays.area, min=_EPS)[None, :, None, None]
    # 2*cos2*cos3*(onorm*cos3 - normal*cos2 + 4*(-dir)*cos2*cos3)/h^5
    t1_base = (2.0 * (cos2 * cos3)[..., None]
               * (onorm * cos3[..., None] - rays.normal * cos2[..., None]
                  + 4.0 * (-rays.dirs) * (cos2 * cos3)[..., None])
               / (h ** 5)[..., None])
    intensity = rays.albedo * ff2
    t1 = rays.albedo[..., None] * t1_base
    t2 = rays.normal * intensity[..., None]
    if cfg.normal == "vn" and cfg.testing_flag == 0:
        gn = (-2.0 * rays.albedo[..., None] * rays.dirs
              * (cos3 * cos2 * cos2)[..., None] / (h ** 4)[..., None])
        gn = gn - rays.normal * _dot(gn, rays.normal)[..., None]
        t2 = t2 + gn
    t2 = t2 / (2.0 * area_s)
    return t1, t2, intensity, ff2


@functools.lru_cache(maxsize=8)
def _tap_index_tables(num_bins: int, refine: int, sigma_bin: int,
                      resolution: float, device: str, dtype):
    """Per tap group j, (in-range mask, clipped coarse bin, W, WD) over the
    fine bins q in [0, Bf] (q == Bf at 2h == bin_upper): they depend on
    the configuration only, so they go to the device once."""
    W, WD = grouped_gaussian_tables(resolution, refine, sigma_bin)
    qs_tab = np.arange(num_bins * refine + 1) - 2 * refine * sigma_bin
    p_tab = qs_tab % refine
    b0_tab = qs_tab // refine
    out = []
    for j in range(W.shape[1]):
        b = b0_tab + j
        out.append((torch.from_numpy((b >= 0) & (b < num_bins)).to(device),
                    torch.from_numpy(np.clip(b, 0, num_bins - 1)).to(device),
                    torch.from_numpy(W[p_tab, j]).to(device, dtype),
                    torch.from_numpy(WD[p_tab, j]).to(device, dtype)))
    return tuple(out)


def _tap_tables(difference, source_offset: int, Lc: int, cfg: RenderConfig,
                dtype=torch.float32):
    """Per-fine-bin tap-reduction tables (A_tab, Bw_tab), each [Lc, Bf+1]:
    the K taps of a sample with fine bin q land on G consecutive coarse
    bins with phase-grouped weights, so the reduction depends on the ray
    only through q."""
    Bf = cfg.num_bins * cfg.bin_refine_resolution
    dev = difference.device
    diff_c = difference[source_offset:source_offset + Lc].to(dtype)
    A_tab = torch.zeros((Lc, Bf + 1), dtype=dtype, device=dev)
    Bw_tab = torch.zeros((Lc, Bf + 1), dtype=dtype, device=dev)
    for ok, idx, wa, wd in _tap_index_tables(
            cfg.num_bins, cfg.bin_refine_resolution, cfg.sigma_bin,
            float(cfg.distance_resolution), str(dev), dtype):
        d = torch.where(ok[None, :], diff_c[:, idx], 0.0)
        A_tab = A_tab + wa[None, :] * d
        Bw_tab = Bw_tab + wd[None, :] * d
    return A_tab, Bw_tab


def _tap_reductions(rays: RayBatch, difference, source_offset: int,
                    cfg: RenderConfig):
    """(A, Bw) per ray: A = sum_i w_i*d_i, Bw = sum_i w_i*delta_i*d_i, read
    from the _tap_tables at the ray's fine bin (zero outside [0, Bf])."""
    Lc = rays.h.shape[0]
    refine = cfg.bin_refine_resolution
    Bf = cfg.num_bins * refine
    A_tab, Bw_tab = _tap_tables(difference, source_offset, Lc, cfg,
                                rays.h.dtype)
    q = fine_bins(rays.h, cfg.bin_lower, cfg.distance_resolution / refine)
    qc = torch.clamp(q, 0, Bf).to(torch.int64)
    l_local = torch.arange(Lc, device=q.device)[:, None, None]
    flat = l_local * (Bf + 1) + qc
    zero = (q < 0) | (q > Bf)
    A = torch.where(zero, 0.0, A_tab.reshape(-1)[flat])
    Bw = torch.where(zero, 0.0, Bw_tab.reshape(-1)[flat])
    return A, Bw


def opposite_edges(mesh: Mesh):
    """Per-face edge opposite each vertex slot: (v3-v2, v1-v3, v2-v1)."""
    v1, v2, v3 = (mesh.v[mesh.f[:, k]] for k in range(3))
    return v3 - v2, v1 - v3, v2 - v1


def backward_chunk(rays: RayBatch, mesh: Mesh, lighting_normal, difference,
                   source_offset: int, cfg: RenderConfig, spt: int):
    """Analytic vertex gradient for one source chunk -> [V,3] (sum over the
    chunk's sources; the caller divides by the total source count).

    The cross-product term is hoisted from per ray to per face: cross(t2,
    e_k) is linear in t2 and e_k is constant per face."""
    t1, t2, intensity, _ = _gradient_terms(rays, lighting_normal, cfg)
    A, Bw = _tap_reductions(rays, difference, source_offset, cfg)
    sigma2 = cfg.sigma * cfg.sigma
    w = (torch.where(rays.valid, 1.0, 0.0) * rays.area[None, :, None]
         * (-2.0 / float(spt)))
    Aw = A * w
    # P = (t1*A + gauss_vec) * w, gauss_vec = (2/s^2)*dir*intensity*Bw
    P = t1 * Aw[..., None] + rays.dirs * (
        (2.0 / sigma2) * intensity * Bw * w)[..., None]
    S2 = t2 * Aw[..., None]
    T2f = S2.sum(dim=(0, 2))
    edges = opposite_edges(mesh)
    per_face = torch.stack(
        [(P * rays.bary[..., k:k + 1]).sum(dim=(0, 2))
         + torch.linalg.cross(T2f, edges[k]) for k in range(3)], dim=1)
    return scatter_faces(per_face, mesh.f, mesh.v.shape[0])
