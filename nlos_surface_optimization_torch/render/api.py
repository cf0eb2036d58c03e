"""Rendering entry points: the confocal transient and its vertex gradient.

  render_transient   forward transient [L, B] (+ pathlengths [B])
  render_intensity   per-face visibility intensity [F] (culling)
  inverse_render     (transient, vertex gradient [V,3], pathlengths)

Sources are processed in chunks of cfg.source_chunk by a Python loop;
the ``*_host`` names are the same functions (in the JAX package they
differ in where the chunk loop runs).  Everything runs on the mesh's
device; numpy inputs are moved there.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..config import RenderConfig, check_backends
from ..geometry.mesh import Mesh
from .core import (
    backward_chunk,
    forward_chunk,
    intensity_chunk,
    trace_chunk,
    trace_forward_fused,
)
from .kernels import smooth_and_coarsen


def _spt(cfg: RenderConfig, mesh: Mesh) -> int:
    """Samples per face from the VALID face count (padding faces must not
    dilute the per-face budget)."""
    return cfg.samples_per_face(int(mesh.f_valid.sum()))


def _as_tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(device)


def pathlengths(cfg: RenderConfig, device="cpu") -> torch.Tensor:
    return (cfg.bin_lower + torch.arange(cfg.num_bins, dtype=torch.float64,
                                         device=device)
            * cfg.distance_resolution)


def _chunks(lighting, lighting_normal, cfg: RenderConfig):
    """Sources as [nc, Lc, 3] with zero padding (padded sources have zero
    normals and contribute exactly zero) -> (lit, nrm, L, Lc, nc)."""
    L = lighting.shape[0]
    Lc = min(cfg.source_chunk if cfg.source_chunk > 0 else L, L)
    nc = math.ceil(L / Lc)
    pad = nc * Lc - L
    if pad:
        lighting = torch.nn.functional.pad(lighting, (0, 0, 0, pad))
        lighting_normal = torch.nn.functional.pad(lighting_normal,
                                                  (0, 0, 0, pad))
    return (lighting.reshape(nc, Lc, 3), lighting_normal.reshape(nc, Lc, 3),
            L, Lc, nc)


def _trace_and_forward(mesh: Mesh, lc, nc_, key, cfg: RenderConfig, spt: int,
                       off: int, refine: int):
    """(RayBatch, fine histogram) for one source chunk, through the fused
    kernel or the eager trace + splat pair (same semantics)."""
    if cfg.occl_backend in ("auto", "fused"):  # K1; 'pallas', 'jnp': below
        return trace_forward_fused(mesh, lc, nc_, key, cfg, spt, refine,
                                   source_offset=off)
    rays = trace_chunk(mesh, lc, nc_, key, cfg, spt, source_offset=off)
    return rays, forward_chunk(rays, nc_, cfg, spt, refine)


def render_transient(mesh: Mesh, lighting, lighting_normal,
                     cfg: RenderConfig, key, refine: Optional[int] = None):
    """Forward confocal transient [L, B] and pathlengths [B].

    ``refine`` defaults to cfg.bin_refine_resolution; refine=1 gives the
    raw (unsmoothed) histogram."""
    check_backends(cfg)
    dev = mesh.device
    spt = _spt(cfg, mesh)
    r = cfg.bin_refine_resolution if refine is None else refine
    lit, nrm, L, Lc, nc = _chunks(_as_tensor(lighting, dev),
                                  _as_tensor(lighting_normal, dev), cfg)
    fine = torch.cat([
        _trace_and_forward(mesh, lit[i], nrm[i], key, cfg, spt, i * Lc, r)[1]
        for i in range(nc)], dim=0)[:L]
    t = smooth_and_coarsen(fine, cfg.distance_resolution, r, cfg.sigma_bin)
    return t, pathlengths(cfg, dev)


render_transient_host = render_transient


def render_intensity(mesh: Mesh, lighting, lighting_normal,
                     cfg: RenderConfig, key) -> torch.Tensor:
    """Per-face visibility intensity [F] summed over sources, for
    invisible-triangle culling: the per-chunk intensities, each traced
    through ``trace_chunk`` (the standalone visibility kernel), added in
    chunk order."""
    check_backends(cfg)
    dev = mesh.device
    spt = _spt(cfg, mesh)
    lit, nrm, L, Lc, nc = _chunks(_as_tensor(lighting, dev),
                                  _as_tensor(lighting_normal, dev), cfg)
    out = None
    for i in range(nc):
        rays = trace_chunk(mesh, lit[i], nrm[i], key, cfg, spt,
                           source_offset=i * Lc)
        part = intensity_chunk(rays, nrm[i], cfg, spt)
        out = part if out is None else out + part
    return out


render_intensity_host = render_intensity


def _difference(data, transient, weight, cfg: RenderConfig):
    """weight * f(data - transient), f = identity or 2d^3."""
    if cfg.loss_smooth_width > 0:
        raise NotImplementedError("loss_smooth_width is not ported yet")
    d = data - transient
    if cfg.loss_flag == 1:
        d = 2.0 * d * d * d
    return d * weight


def _use_fused_bwd(cfg: RenderConfig) -> bool:
    return cfg.brdf == "lambertian" and cfg.bwd_backend in ("auto", "fused")


def _fused_chunk_body(mesh: Mesh, lc, nc_, off: int, key, dat, w,
                      cfg: RenderConfig, spt: int):
    """(transient rows, vertex gradient) for one source chunk: one trace
    serves the forward and the backward (the difference is row-local)."""
    refine = cfg.forward_refine
    rays, fine = _trace_and_forward(mesh, lc, nc_, key, cfg, spt, off, refine)
    transient = smooth_and_coarsen(fine, cfg.distance_resolution, refine,
                                   cfg.sigma_bin)
    diff = _difference(dat, transient, w, cfg)
    if _use_fused_bwd(cfg):
        from .bwd_kernels import backward_chunk_fused

        g = backward_chunk_fused(rays, mesh, nc_, diff, 0, cfg, spt)
    else:
        g = backward_chunk(rays, mesh, nc_, diff, 0, cfg, spt)
    return transient, g


def inverse_render(mesh: Mesh, data, weight, lighting, lighting_normal,
                   cfg: RenderConfig, key):
    """(transient [L,B], vertex gradient [V,3], pathlengths [B]).

    The gradient is of sum_{l,b} weight*(data - T_smooth)^2 averaged over
    sources; per-chunk gradients are summed in chunk order, then divided
    by L."""
    check_backends(cfg)
    dev = mesh.device
    spt = _spt(cfg, mesh)
    lit, nrm, L, Lc, nc = _chunks(_as_tensor(lighting, dev),
                                  _as_tensor(lighting_normal, dev), cfg)
    pad = nc * Lc - L
    # padded rows carry zero weight => zero difference => zero gradient
    data_p = torch.nn.functional.pad(_as_tensor(data, dev), (0, 0, 0, pad))
    weight_p = torch.nn.functional.pad(_as_tensor(weight, dev),
                                       (0, 0, 0, pad))
    parts, grad = [], None
    for i in range(nc):
        rows = slice(i * Lc, (i + 1) * Lc)
        t, g = _fused_chunk_body(mesh, lit[i], nrm[i], i * Lc, key,
                                 data_p[rows], weight_p[rows], cfg, spt)
        parts.append(t)
        grad = g if grad is None else grad + g
    transient = torch.cat(parts, dim=0)[:L]
    return transient, grad / float(L), pathlengths(cfg, dev)


inverse_render_host = inverse_render
