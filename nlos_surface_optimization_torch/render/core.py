"""Core confocal transient rendering: forward splat + analytic backward.

Work for one source chunk is a dense set of rays [Lc, F, spt] (source x
face x sample).  The forward bins each visible sample's contribution into
a fine per-source histogram; the backward collapses the K-tap Gaussian
loop of the gradient into two per-fine-bin table lookups per ray
(``_tap_tables``), then reduces per face and scatters to vertices.  The
same structure gives the GGX vertex gradient, the measured-jitter
gradient (per-bin correlation tables), the scalar albedo and roughness
gradients and the per-bin diagnostic of one vertex.

Deliberate deviations kept from the JAX package: out-of-range kernel taps
are masked to zero, and a sample whose coarse bin lands exactly on
num_bins is dropped.

Divisions by a configuration constant that decide a histogram bin go
through ``_div``, a division by a 0-dim tensor on the operand's device:
PyTorch on CUDA turns division by a Python scalar into multiplication by
its reciprocal, which can move a sample across a bin boundary.

A chunk's trace records two program spans (utils/timers.span):
``render.sample``, everything before the visibility call (the draws, the
ray setup, the skip mask and, for the fused kernel, the contribution with
its BRDF: sample_kernels.sample_rays, one kernel on the card), then
``render.k1`` (the fused kernel's wrapper) or ``render.k3`` (the
visibility query of ``trace_chunk``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..config import RenderConfig
from ..geometry.intersect import segment_occluded, segment_occluded_mxu
from ..geometry.mesh import Mesh, scatter_faces
from ..utils import timers
from . import brdf as ggx
from .kernels import correlate_rows, gaussian_kernel, grouped_gaussian_tables

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


def occlusion_inputs(mesh: Mesh, lighting, lighting_normal, key,
                     cfg: RenderConfig, spt: int, source_offset: int = 0,
                     faces=None):
    """(RayBatch before occlusion, args, kwargs) of the visibility query
    for one source chunk: ``segment_occluded(*args, **kwargs)``.  Rays
    whose contribution is zero in every consumer get t_self = 0 and skip
    the test.  The sampling and ray setup is sample_kernels.sample_rays
    (one kernel on the card); ``faces``: the mesh's (face_n, area), once
    a render, computed here when None."""
    from .sample_kernels import sample_rays

    c = sample_rays(mesh, lighting, lighting_normal, key.to(mesh.device),
                    cfg, spt, source_offset, faces)
    args = (c.o, c.rays.dirs.reshape(-1, 3), c.t_self, c.fid, mesh.v,
            mesh.f, mesh.f_valid)
    return c.rays, args, dict(t_rel=cfg.occl_t_rel, t_min=cfg.occl_t_min)


def trace_chunk(mesh: Mesh, lighting, lighting_normal, key, cfg: RenderConfig,
                spt: int, source_offset: int = 0, hier=None,
                faces=None) -> RayBatch:
    """Sample every face from every source in the chunk and run the
    visibility query: the standalone visibility kernel
    (render/occl_kernels.segment_occluded, its plain version on the CPU;
    ``hier`` the mesh's fused_kernels.face_hierarchy, built per call when
    None), or with occl_backend 'jnp' the eager divide-based
    segment_occluded, with 'mxu' its matrix-product form.  ``faces`` as
    for occlusion_inputs."""
    with timers.span("render.sample"):
        rays_pre, args, kwargs = occlusion_inputs(
            mesh, lighting, lighting_normal, key, cfg, spt, source_offset,
            faces)
    with timers.span("render.k3"):
        if cfg.occl_backend == "jnp":
            occ = segment_occluded(*args, **kwargs)
        elif cfg.occl_backend == "mxu":
            occ = segment_occluded_mxu(*args, **kwargs)
        else:
            from .occl_kernels import segment_occluded as occl

            occ = occl(*args, **kwargs, hier=hier)
        return rays_pre._replace(
            valid=rays_pre.valid & ~occ.reshape(rays_pre.h.shape))


def _contrib_and_bins(rays: RayBatch, lighting_normal, cfg: RenderConfig,
                      spt: int, refine: int, alpha=None):
    """Per-ray forward contribution (masked by rays.valid and the bin
    range) and its fine bin clipped to [0, Bf)."""
    cos2 = _dot(lighting_normal[:, None, None, :], rays.dirs)
    cos3 = -_dot(rays.normal, rays.dirs)
    ff = torch.clamp(cos3 * cos2, min=0.0) / (rays.h * rays.h)
    contrib = rays.area[None, :, None] * rays.albedo * ff * ff
    contrib = contrib * _brdf_value(rays, cfg, alpha)
    contrib = torch.where(rays.valid, contrib, 0.0) / float(spt)
    Bf = cfg.num_bins * refine
    bin_f = fine_bins(rays.h, cfg.bin_lower, cfg.distance_resolution / refine)
    ok = (bin_f >= 0) & (bin_f < Bf)
    contrib = torch.where(ok, contrib, 0.0)
    return contrib, torch.clamp(bin_f, 0, Bf - 1)


def splat_inputs(mesh: Mesh, lighting, lighting_normal, key,
                 cfg: RenderConfig, spt: int, refine: int,
                 source_offset: int = 0, alpha=None, faces=None):
    """(RayBatch before occlusion, args, kwargs) of the fused occlusion +
    splat call for one source chunk: ``occluded_splat(*args, **kwargs)``.

    The contribution (with the BRDF, GGX at roughness ``alpha``) is
    computed before occlusion (the kernel zeroes occluded rays); rays
    whose contribution is zero everywhere get t_self = 0 and skip the
    visibility test.  Sampling, ray setup and contribution are one
    sample_kernels.sample_rays call; ``faces`` as for occlusion_inputs."""
    from .sample_kernels import sample_rays

    c = sample_rays(mesh, lighting, lighting_normal, key.to(mesh.device),
                    cfg, spt, source_offset, faces, refine, alpha)
    args = (c.o, c.rays.dirs.reshape(-1, 3), c.t_self, c.fid, c.contrib,
            c.bin_f, mesh.v, mesh.f, mesh.f_valid, lighting.shape[0],
            cfg.num_bins * refine)
    return c.rays, args, dict(t_rel=cfg.occl_t_rel, t_min=cfg.occl_t_min)


def trace_forward_fused(mesh: Mesh, lighting, lighting_normal, key,
                        cfg: RenderConfig, spt: int, refine: int,
                        source_offset: int = 0, hier=None, alpha=None,
                        faces=None):
    """(RayBatch, fine histogram [Lc, num_bins*refine]) through the fused
    occlusion + splat kernel (render/fused_kernels.occluded_splat; ``hier``
    and ``faces`` as for trace_chunk).

    Same semantics as trace_chunk + forward_chunk."""
    from .fused_kernels import occluded_splat

    with timers.span("render.sample"):
        rays_pre, args, kwargs = splat_inputs(mesh, lighting, lighting_normal,
                                              key, cfg, spt, refine,
                                              source_offset, alpha, faces)
    with timers.span("render.k1"):
        occ, hist = occluded_splat(*args, **kwargs, hier=hier)
        rays = rays_pre._replace(
            valid=rays_pre.valid & ~occ.reshape(rays_pre.h.shape))
    return rays, hist


def _alpha_like(alpha, x: torch.Tensor) -> torch.Tensor:
    """The GGX roughness as a 0-dim tensor of x's dtype on x's device: a
    tensor as it is, a number rounded to f32 first, None the JAX
    package's default f32 0.1."""
    if torch.is_tensor(alpha):
        return alpha.to(x.device, x.dtype)
    return torch.full((), 0.1 if alpha is None else float(alpha),
                      dtype=torch.float32, device=x.device).to(x.dtype)


def _shading_cos(rays: RayBatch) -> torch.Tensor:
    """c = dot(shading normal, -dir), the GGX cosine."""
    return -_dot(rays.normal, rays.dirs)


def _brdf_value(rays: RayBatch, cfg: RenderConfig, alpha=None):
    """BRDF multiplier per ray (1 for Lambertian)."""
    if cfg.brdf == "ggx":
        return ggx.eval_scalar(_alpha_like(alpha, rays.h), _shading_cos(rays))
    return torch.ones_like(rays.h)


def forward_chunk(rays: RayBatch, lighting_normal, cfg: RenderConfig,
                  spt: int, refine: int, alpha=None):
    """Fine histogram [Lc, num_bins*refine] for one source chunk (eager
    splat; the forward clamps the cosine product)."""
    Lc = rays.h.shape[0]
    Bf = cfg.num_bins * refine
    contrib, bin_f = _contrib_and_bins(rays, lighting_normal, cfg, spt, refine,
                                       alpha)
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


def _clamped_cosines(rays: RayBatch, lighting_normal):
    """(cos2, cos3, ff2): the source and shading cosines clamped at 0
    separately, as the gradients clamp them, and the squared form factor
    (cos2*cos3/h^2)^2 without albedo or BRDF."""
    cos2 = torch.clamp(_dot(lighting_normal[:, None, None, :], rays.dirs),
                       min=0.0)
    cos3 = torch.clamp(-_dot(rays.normal, rays.dirs), min=0.0)
    ff = cos2 * cos3 / (rays.h * rays.h)
    return cos2, cos3, ff * ff


def _gradient_terms(rays: RayBatch, lighting_normal, cfg: RenderConfig,
                    alpha=None):
    """Per-ray gradient ingredients (t1 [.,3], t2 [.,3], intensity, ff2),
    cosines clamped separately; the GGX BRDF at roughness ``alpha`` where
    cfg.brdf is 'ggx'."""
    onorm = lighting_normal[:, None, None, :]
    cos2, cos3, ff2 = _clamped_cosines(rays, lighting_normal)
    h = rays.h
    area_s = torch.clamp(rays.area, min=_EPS)[None, :, None, None]
    # 2*cos2*cos3*(onorm*cos3 - normal*cos2 + 4*(-dir)*cos2*cos3)/h^5
    t1_base = (2.0 * (cos2 * cos3)[..., None]
               * (onorm * cos3[..., None] - rays.normal * cos2[..., None]
                  + 4.0 * (-rays.dirs) * (cos2 * cos3)[..., None])
               / (h ** 5)[..., None])
    use_gn = cfg.normal == "vn" and cfg.testing_flag == 0
    if cfg.brdf == "ggx":
        a = _alpha_like(alpha, h)
        c = _shading_cos(rays)
        bval = ggx.eval_scalar(a, c)
        dscale = ggx.eval_cdiff(a, c)
        # d(BRDF)/dn = dscale*w and d(BRDF)/dw = dscale*normal, w = -dir;
        # d(BRDF)/d(point) = (-BRDF_dw + dir*dot(dir, BRDF_dw)) / h, or with
        # ggx_compat_dx the reference's form dividing only the parallel
        # part by h
        brdf_dw = dscale[..., None] * rays.normal
        par = rays.dirs * _dot(rays.dirs, brdf_dw)[..., None]
        if cfg.ggx_compat_dx:
            brdf_dx = -brdf_dw + par / h[..., None]
        else:
            brdf_dx = (-brdf_dw + par) / h[..., None]
        intensity = rays.albedo * ff2 * bval
        # the GGX t1 carries no albedo factor
        t1 = t1_base * bval[..., None] + ff2[..., None] * brdf_dx
        t2 = rays.normal * intensity[..., None]
        if use_gn:
            gn = (-2.0 * rays.dirs * (cos3 * cos2 * cos2 * bval)[..., None]
                  / (h ** 4)[..., None])
            gn = gn + ff2[..., None] * (dscale[..., None] * (-rays.dirs))
            gn = gn - rays.normal * _dot(gn, rays.normal)[..., None]
            t2 = t2 + gn
    else:
        intensity = rays.albedo * ff2
        t1 = rays.albedo[..., None] * t1_base
        t2 = rays.normal * intensity[..., None]
        if use_gn:
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


def _ray_weight(rays: RayBatch, spt: int) -> torch.Tensor:
    """valid * area * (-2/spt) per ray."""
    return (torch.where(rays.valid, 1.0, 0.0) * rays.area[None, :, None]
            * (-2.0 / float(spt)))


def _vertex_sums(rays: RayBatch, mesh: Mesh, P, S2):
    """[V,3] from per-ray P (bary-weighted into the face's slots) and S2
    (summed per face, crossed with each slot's opposite edge): the cross
    product is hoisted from per ray to per face, as cross(t2, e_k) is
    linear in t2 and e_k is constant per face."""
    T2f = S2.sum(dim=(0, 2))
    edges = opposite_edges(mesh)
    per_face = torch.stack(
        [(P * rays.bary[..., k:k + 1]).sum(dim=(0, 2))
         + torch.linalg.cross(T2f, edges[k]) for k in range(3)], dim=1)
    return scatter_faces(per_face, mesh.f, mesh.v.shape[0])


def backward_chunk(rays: RayBatch, mesh: Mesh, lighting_normal, difference,
                   source_offset: int, cfg: RenderConfig, spt: int,
                   alpha=None):
    """Analytic vertex gradient for one source chunk -> [V,3] (sum over the
    chunk's sources; the caller divides by the total source count); GGX
    at roughness ``alpha`` where cfg.brdf is 'ggx'."""
    t1, t2, intensity, _ = _gradient_terms(rays, lighting_normal, cfg, alpha)
    A, Bw = _tap_reductions(rays, difference, source_offset, cfg)
    sigma2 = cfg.sigma * cfg.sigma
    w = _ray_weight(rays, spt)
    Aw = A * w
    # P = (t1*A + gauss_vec) * w, gauss_vec = (2/s^2)*dir*intensity*Bw
    P = t1 * Aw[..., None] + rays.dirs * (
        (2.0 / sigma2) * intensity * Bw * w)[..., None]
    return _vertex_sums(rays, mesh, P, t2 * Aw[..., None])


def _lambertian_only(cfg: RenderConfig, what: str) -> None:
    """The JAX package computes these gradients with the Lambertian terms
    only (it passes no roughness and fails for 'ggx'); say so."""
    if cfg.brdf != "lambertian":
        raise ValueError(f"{what} is defined for brdf='lambertian' only, "
                         f"got {cfg.brdf!r}")


def backward_jitter_chunk(rays: RayBatch, mesh: Mesh, lighting_normal,
                          difference, source_offset: int, cfg: RenderConfig,
                          spt: int, jitter_weight, jitter_grad,
                          jitter_offset: int):
    """Analytic vertex gradient under a measured temporal kernel -> [V,3].

    Taps are integer shifts delta_i = i - offset of the sample's coarse
    bin; per tap the gradient is
        (t1*w_i + jg_i*intensity*(-2)*dir/res)*bary + cross(t2,e)*w_i
    times -2*difference[bin + delta_i].  Both tap sums depend on the ray
    only through its coarse bin, so they are per-bin tables, each a
    correlation of the difference rows with the kernel (K can be ~901),
    read with one gather per ray; taps outside the bins read zero."""
    _lambertian_only(cfg, "the jitter gradient")
    t1, t2, intensity, _ = _gradient_terms(rays, lighting_normal, cfg)
    B = cfg.num_bins
    res = cfg.distance_resolution
    Lc = rays.h.shape[0]
    dtype = rays.h.dtype
    bin0 = fine_bins(rays.h, cfg.bin_lower, res)
    # T[l, b] = sum_i k_i * diff[l, b + i - offset], b in [0, B]
    diff_c = torch.nn.functional.pad(
        difference[source_offset:source_offset + Lc].to(dtype), (0, 1))
    K = len(jitter_weight)
    A_tab, C_tab = (correlate_rows(diff_c, k, jitter_offset, K - 1
                                   - jitter_offset)
                    for k in (jitter_weight, jitter_grad))
    bc = torch.clamp(bin0, 0, B).to(torch.int64)
    flat = torch.arange(Lc, device=bc.device)[:, None, None] * (B + 1) + bc
    zero = (bin0 < 0) | (bin0 > B)
    A = torch.where(zero, 0.0, A_tab.reshape(-1)[flat])
    C = torch.where(zero, 0.0, C_tab.reshape(-1)[flat])
    w = _ray_weight(rays, spt)
    Aw = A * w
    P = t1 * Aw[..., None] + rays.dirs * (
        (-2.0 / res) * intensity * C * w)[..., None]
    return _vertex_sums(rays, mesh, P, t2 * Aw[..., None])


def backward_albedo_chunk(rays: RayBatch, lighting_normal, difference,
                          source_offset: int, cfg: RenderConfig, spt: int):
    """Scalar albedo gradient of one source chunk: -2/spt * sum of
    valid * area * ff^2 * A (cosines clamped separately, no albedo or
    BRDF factor)."""
    _lambertian_only(cfg, "the albedo gradient")
    _, _, ff2 = _clamped_cosines(rays, lighting_normal)
    A, _ = _tap_reductions(rays, difference, source_offset, cfg)
    g = torch.where(rays.valid, ff2 * A, 0.0) * rays.area[None, :, None]
    return (-2.0 / float(spt)) * g.sum()


def backward_alpha_chunk(rays: RayBatch, lighting_normal, difference,
                         source_offset: int, cfg: RenderConfig, spt: int,
                         alpha):
    """Scalar GGX-roughness gradient of one source chunk: -2/spt * sum of
    valid * area * albedo * ff^2 * d(BRDF)/d(alpha) * A."""
    adiff = ggx.eval_adiff(_alpha_like(alpha, rays.h), _shading_cos(rays))
    _, _, ff2 = _clamped_cosines(rays, lighting_normal)
    A, _ = _tap_reductions(rays, difference, source_offset, cfg)
    g = torch.where(rays.valid, rays.albedo * ff2 * adiff * A, 0.0)
    g = g * rays.area[None, :, None]
    return (-2.0 / float(spt)) * g.sum()


def vertex_gradient_bins_chunk(rays: RayBatch, mesh: Mesh, lighting_normal,
                               vertex_num: int, cfg: RenderConfig, spt: int):
    """Per-bin gradient diagnostic of one vertex -> [B,3] ('fn' gradient
    terms, no difference weighting; the face-normal term is always on).
    The K Gaussian taps each scatter into the coarse bins."""
    _lambertian_only(cfg, "vertex_gradient_bins")
    t1, _, intensity, _ = _gradient_terms(rays, lighting_normal,
                                          cfg.replace(normal="fn"))
    cos2, _, _ = _clamped_cosines(rays, lighting_normal)
    fnb = rays.face_n[None, :, None, :].expand(rays.dirs.shape)
    cos3 = torch.clamp(-_dot(fnb, rays.dirs), min=0.0)
    gn = (-2.0 * rays.albedo[..., None] * rays.dirs
          * (cos3 * cos2 * cos2)[..., None] / (rays.h ** 4)[..., None])
    gn = gn - fnb * _dot(gn, fnb)[..., None]
    area_s = torch.clamp(rays.area, min=_EPS)[None, :, None, None]
    t2 = (fnb * intensity[..., None] + gn) / (2.0 * area_s)

    weights, deltas = gaussian_kernel(cfg.distance_resolution,
                                      cfg.bin_refine_resolution,
                                      cfg.sigma_bin)
    sigma2 = cfg.sigma * cfg.sigma
    edges = opposite_edges(mesh)
    # the vertex's barycentric slot (if any) per face
    slot = [(mesh.f[:, k] == vertex_num)[None, :, None] for k in range(3)]
    bary_k = sum(torch.where(slot[k], rays.bary[..., k], 0.0)
                 for k in range(3))
    edge_k = sum(torch.where(slot[k][..., None],
                             edges[k][None, :, None, :].expand(t2.shape), 0.0)
                 for k in range(3))
    involved = slot[0] | slot[1] | slot[2]
    scale = (torch.where(rays.valid & involved, 1.0, 0.0)
             * rays.area[None, :, None] / float(spt))

    B = cfg.num_bins
    out = torch.zeros((B, 3), dtype=rays.h.dtype, device=rays.h.device)
    two_h = 2.0 * rays.h
    cross_term = torch.linalg.cross(t2, edge_k)
    for w_i, d_i in zip(weights.tolist(), deltas.tolist()):
        gauss = (2.0 * d_i / sigma2) * rays.dirs * intensity[..., None]
        g = ((t1 + gauss) * bary_k[..., None] + cross_term) * w_i
        g = g * scale[..., None]
        b = torch.floor(_div(two_h + d_i - cfg.bin_lower,
                             cfg.distance_resolution)).to(torch.int64)
        ok = (b >= 0) & (b < B)
        g = torch.where(ok[..., None], g, 0.0)
        b = torch.clamp(b, 0, B - 1)
        out = out + torch.zeros_like(out).index_add_(0, b.reshape(-1),
                                                     g.reshape(-1, 3))
    return out
