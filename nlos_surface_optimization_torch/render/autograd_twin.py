"""Differentiable "autograd twin" of the transient renderer.

A forward model that torch.autograd differentiates with respect to the
vertex positions: each path sample is splatted into the time bins with
the exact Gaussian-CDF integral instead of quantized kernel taps, and the
sampling and visibility come detached from a traced RayBatch.  It is the
independent ground truth the analytic backward is held to.

    T[l,b] = sum_s c_s(v) * (Phi(ub - 2h_s(v)) - Phi(lb - 2h_s(v)))

with c_s = area*albedo*ff^2 (*BRDF) and Phi the N(0, sigma) CDF; bin edges
lb/ub at b*res+lo and (b+1)*res+lo.  The analytic pass approximates the
integral by K kernel taps.
"""

from __future__ import annotations

import math

import torch

from ..config import RenderConfig
from ..geometry.mesh import Mesh, norm3
from . import brdf as ggx
from .core import RayBatch, _alpha_like, trace_chunk


def _phi(x, sigma: float):
    return 0.5 * (1.0 + torch.special.erf(x / (sigma * math.sqrt(2.0))))


def twin_transient_from_rays(v, mesh: Mesh, rays: RayBatch, lighting,
                             lighting_normal, cfg: RenderConfig, spt: int,
                             alpha=None, detach_normal: bool = True):
    """Smoothed transient [Lc, B] as a differentiable function of the
    vertex positions ``v`` [V,3]; barycoords, visibility and face validity
    come detached from ``rays``.

    The cosines are clamped one by one, as the gradient does.
    detach_normal=True holds the shading normal fixed, as the analytic
    gradient does (no d(normal)/dv term in 'fn' mode); False gives the
    true gradient of the smoothed render."""
    f = mesh.f
    bary = rays.bary.detach()
    valid = rays.valid.detach()

    v1, v2, v3 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    nvec = torch.linalg.cross(v2 - v1, v3 - v1)
    dbl = norm3(nvec)
    area = dbl / 2.0
    fn = nvec / torch.clamp(dbl, min=1e-30)[:, None]

    p = (bary[..., 0:1] * v1[None, :, None, :]
         + bary[..., 1:2] * v2[None, :, None, :]
         + bary[..., 2:3] * v3[None, :, None, :])
    dvec = p - lighting[:, None, None, :]
    h = torch.clamp(norm3(dvec), min=1e-12)
    d = dvec / h[..., None]

    if cfg.normal == "vn":
        n1, n2, n3 = (mesh.vn[f[:, k]] for k in range(3))
        nrm = (bary[..., 0:1] * n1[None, :, None, :]
               + bary[..., 1:2] * n2[None, :, None, :]
               + bary[..., 2:3] * n3[None, :, None, :])
    else:
        nrm = fn[None, :, None, :].expand(p.shape)
    if detach_normal:
        nrm = nrm.detach()

    a1, a2, a3 = (mesh.albedo[f[:, k]] for k in range(3))
    alb = (bary[..., 0] * a1[None, :, None] + bary[..., 1] * a2[None, :, None]
           + bary[..., 2] * a3[None, :, None])

    onorm = lighting_normal[:, None, None, :]
    cos2 = (onorm * d).sum(-1)
    cos3 = -(nrm * d).sum(-1)
    ff = torch.clamp(cos2, min=0.0) * torch.clamp(cos3, min=0.0) / (h * h)
    c = alb * ff * ff
    if cfg.brdf == "ggx":
        c = c * ggx.eval_scalar(_alpha_like(alpha, h), cos3)
    c = torch.where(valid, c * area[None, :, None] / float(spt), 0.0)

    B = cfg.num_bins
    edges = cfg.bin_lower + torch.arange(
        B + 1, dtype=h.dtype, device=h.device) * cfg.distance_resolution
    cdf = _phi(edges - 2.0 * h[..., None], cfg.sigma)
    w = cdf[..., 1:] - cdf[..., :-1]
    return torch.einsum("lfs,lfsb->lb", c, w)


def twin_transient(mesh: Mesh, lighting, lighting_normal, cfg: RenderConfig,
                   key, alpha=None):
    """Differentiable smoothed transient [L,B] of one chunk of all sources;
    the gradient flows to mesh.v."""
    spt = cfg.samples_per_face(int(mesh.f.shape[0]))
    with torch.no_grad():
        rays = trace_chunk(mesh, lighting, lighting_normal, key, cfg, spt)
    return twin_transient_from_rays(mesh.v, mesh, rays, lighting,
                                    lighting_normal, cfg, spt, alpha=alpha)
