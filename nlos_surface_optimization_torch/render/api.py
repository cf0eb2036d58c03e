"""Rendering entry points: the confocal transient and its gradients.

  render_transient         forward transient [L, B] (+ pathlengths [B])
  render_intensity         per-face visibility intensity [F] (culling)
  inverse_render           (transient, vertex gradient [V,3], pathlengths)
  inverse_shading_render   inverse_render with fresh vertex normals, 'vn'
  inverse_render_albedo    (transient, scalar albedo gradient)
  inverse_render_alpha     (transient, scalar GGX-roughness gradient)
  render_transient_jitter  forward under a measured temporal kernel
  inverse_render_jitter    (transient, vertex gradient, pathlengths) under it
  vertex_gradient_bins     per-bin gradient diagnostic of one vertex [B,3]
  transient_loss_and_grad  (weighted L2 loss, transient, vertex gradient)

``transient_rows`` and ``inverse_rows`` are the chunk loops of
render_transient and inverse_render over a block of sources whose first
global index is given (each shard of parallel/shard.py is one).

Sources are processed in chunks of cfg.source_chunk by a Python loop;
on the card the kernels' view of the mesh (fused_kernels.face_hierarchy)
and the face normals and areas the sampler reads are built once per call
and handed to every chunk (``_prepare``), as are the sampler's
key and the jitter kernel (moved to the mesh's device once) and, for the
fused backward, the vertex CSR of its epilogue
(bwd_kernels.vertex_csr).  The ``*_host`` names are the same functions
(in the JAX package they differ in where the chunk loop runs).
Everything runs on the mesh's device; numpy inputs are moved there.

``alpha``, the GGX roughness, defaults to f32 0.1, as in the JAX
package; a Python float is rounded to f32 first (core._alpha_like).  The jitter
forward and gradient trace through ``trace_chunk`` (the standalone
visibility kernel) and splat eagerly at refine 1, as the JAX package does.

Program spans (utils/timers.span; recorded only under torch.profiler):
``render.call`` around each render_transient, inverse render and
render_intensity; inside it ``render.prepare`` (the face hierarchy, the
face normals and areas and the vertex CSR, once a call) and, per chunk,
``render.sample`` and ``render.k1`` or ``render.k3`` (core.py),
``render.smooth`` (the smoothing and the difference) and
``render.backward`` (K2 and its epilogue, or an eager backward).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..config import RenderConfig, check_backends
from ..geometry.mesh import Mesh, face_normals_areas, vertex_normals
from ..utils import timers
from .bwd_kernels import VertexCSR, backward_chunk_fused, vertex_csr
from .fused_kernels import FaceHierarchy, face_hierarchy
from .core import (
    _lambertian_only,
    backward_albedo_chunk,
    backward_alpha_chunk,
    backward_chunk,
    backward_jitter_chunk,
    forward_chunk,
    intensity_chunk,
    trace_chunk,
    trace_forward_fused,
    vertex_gradient_bins_chunk,
)
from .kernels import box_smooth_difference, jitter_convolve, smooth_and_coarsen

MODES = ("vertex", "albedo", "alpha", "jitter")


def _spt(cfg: RenderConfig, mesh: Mesh) -> int:
    """Samples per face from the VALID face count (padding faces must not
    dilute the per-face budget)."""
    return cfg.samples_per_face(int(mesh.f_valid.sum()))


def _as_tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(device)


def pathlengths(cfg: RenderConfig, device="cuda") -> torch.Tensor:
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


def _setup(mesh: Mesh, lighting, lighting_normal, cfg: RenderConfig, key):
    """Checks and the per-call state of a render: (spt, key on the mesh's
    device, lit, nrm, L, Lc, nc)."""
    check_backends(cfg)
    dev = mesh.device
    lit, nrm, L, Lc, nc = _chunks(_as_tensor(lighting, dev),
                                  _as_tensor(lighting_normal, dev), cfg)
    return _spt(cfg, mesh), key.to(dev), lit, nrm, L, Lc, nc


def _padded_rows(x, rows: int, device) -> torch.Tensor:
    """x [L, B] as f32 on device, zero rows appended up to ``rows`` (zero
    weight => zero difference => zero gradient)."""
    x = _as_tensor(x, device)
    return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[0]))


def _prepare(mesh: Mesh, cfg: RenderConfig):
    """What every chunk of a call reads of the mesh, built once per call:
    (the kernels' view of the mesh, (face normals [F,3], areas [F]) for
    the sampler).  The view is None where no kernel reads it: on the CPU
    (the wrappers run their plain versions) and with occl_backend 'jnp'
    or 'mxu'."""
    faces = face_normals_areas(mesh.v, mesh.f)
    if mesh.device.type != "cuda" or cfg.occl_backend in ("jnp", "mxu"):
        return None, faces
    return face_hierarchy(mesh.v, mesh.f, mesh.f_valid), faces


def _trace_and_forward(mesh: Mesh, lc, nc_, key, cfg: RenderConfig, spt: int,
                       off: int, refine: int, hier: Optional[FaceHierarchy],
                       alpha=None, faces=None):
    """(RayBatch, fine histogram) for one source chunk, through the fused
    kernel or the eager trace + splat pair (same semantics)."""
    if cfg.occl_backend in ("auto", "fused"):  # K1; the others: below
        return trace_forward_fused(mesh, lc, nc_, key, cfg, spt, refine,
                                   source_offset=off, hier=hier, alpha=alpha,
                                   faces=faces)
    rays = trace_chunk(mesh, lc, nc_, key, cfg, spt, source_offset=off,
                       hier=hier, faces=faces)
    return rays, forward_chunk(rays, nc_, cfg, spt, refine, alpha=alpha)


def render_transient(mesh: Mesh, lighting, lighting_normal,
                     cfg: RenderConfig, key, refine: Optional[int] = None,
                     alpha=None):
    """Forward confocal transient [L, B] and pathlengths [B].

    ``refine`` defaults to cfg.bin_refine_resolution; refine=1 gives the
    raw (unsmoothed) histogram."""
    check_backends(cfg)
    dev = mesh.device
    r = cfg.bin_refine_resolution if refine is None else refine
    with timers.span("render.call"):
        with timers.span("render.prepare"):
            hier, faces = _prepare(mesh, cfg)
        t = transient_rows(mesh, _as_tensor(lighting, dev),
                           _as_tensor(lighting_normal, dev), key.to(dev), cfg,
                           _spt(cfg, mesh), r, hier, alpha, faces=faces)
    return t, pathlengths(cfg, dev)


def transient_rows(mesh: Mesh, lighting, lighting_normal, key,
                   cfg: RenderConfig, spt: int, refine: int,
                   hier: Optional[FaceHierarchy], alpha=None,
                   source_offset: int = 0, faces=None) -> torch.Tensor:
    """The smoothed transient [L, B] of the sources lighting [L, 3] (f32
    tensors on the mesh's device) whose first global index is
    ``source_offset``, in chunks of cfg.source_chunk; ``hier`` and
    ``faces`` as ``_prepare`` gives them (faces computed a chunk when
    None)."""
    lit, nrm, L, Lc, nc = _chunks(lighting, lighting_normal, cfg)
    fine = torch.cat([
        _trace_and_forward(mesh, lit[i], nrm[i], key, cfg, spt,
                           source_offset + i * Lc, refine, hier, alpha,
                           faces)[1]
        for i in range(nc)], dim=0)[:L]
    with timers.span("render.smooth"):
        return smooth_and_coarsen(fine, cfg.distance_resolution, refine,
                                  cfg.sigma_bin)


render_transient_host = render_transient


def render_intensity(mesh: Mesh, lighting, lighting_normal,
                     cfg: RenderConfig, key) -> torch.Tensor:
    """Per-face visibility intensity [F] summed over sources, for
    invisible-triangle culling: the per-chunk intensities, each traced
    through ``trace_chunk`` (the standalone visibility kernel), added in
    chunk order."""
    with timers.span("render.call"):
        spt, key, lit, nrm, L, Lc, nc = _setup(mesh, lighting,
                                               lighting_normal, cfg, key)
        with timers.span("render.prepare"):
            hier, faces = _prepare(mesh, cfg)
        out = None
        for i in range(nc):
            rays = trace_chunk(mesh, lit[i], nrm[i], key, cfg, spt,
                               source_offset=i * Lc, hier=hier, faces=faces)
            part = intensity_chunk(rays, nrm[i], cfg, spt)
            out = part if out is None else out + part
    return out


render_intensity_host = render_intensity


def _difference(data, transient, weight, cfg: RenderConfig):
    """weight * f(data - transient), f = identity or 2d^3, then the legacy
    box smoothing where cfg.loss_smooth_width > 0."""
    d = data - transient
    if cfg.loss_flag == 1:
        d = 2.0 * d * d * d
    if cfg.loss_smooth_width > 0:
        d = box_smooth_difference(d, cfg.loss_smooth_width)
    return d * weight


def _use_fused_bwd(cfg: RenderConfig) -> bool:
    return cfg.brdf == "lambertian" and cfg.bwd_backend in ("auto", "fused")


def _fused_chunk_body(mesh: Mesh, lc, nc_, off: int, key, dat, w,
                      cfg: RenderConfig, spt: int,
                      hier: Optional[FaceHierarchy],
                      csr: Optional[VertexCSR], grad, mode: str = "vertex",
                      alpha=None, jitter=None, faces=None):
    """(transient rows, running gradient + this chunk's gradient) for one
    source chunk: one trace serves the forward and the backward (the
    difference is row-local).  ``mode``: 'vertex' ([V,3]), 'albedo' or
    'alpha' (scalars), or 'jitter' ([V,3] under ``jitter`` = (weight,
    grad, offset): traced through ``trace_chunk``, splatted at refine 1
    and convolved).  The fused backward adds into grad in place on the
    card; grad None starts the sum.  ``faces``: the mesh's (face normals,
    areas), as ``_prepare`` gives them (computed here when None)."""
    if mode == "jitter":
        jw, jg, joff = jitter
        rays = trace_chunk(mesh, lc, nc_, key, cfg, spt, source_offset=off,
                           hier=hier, faces=faces)
        fine = forward_chunk(rays, nc_, cfg, spt, refine=1)
    else:
        refine = cfg.forward_refine
        rays, fine = _trace_and_forward(mesh, lc, nc_, key, cfg, spt, off,
                                        refine, hier, alpha, faces)
    with timers.span("render.smooth"):
        if mode == "jitter":
            transient = jitter_convolve(fine, jw, joff)
        else:
            transient = smooth_and_coarsen(fine, cfg.distance_resolution,
                                           refine, cfg.sigma_bin)
        diff = _difference(dat, transient, w, cfg)
    with timers.span("render.backward"):
        if mode == "vertex" and _use_fused_bwd(cfg):
            return transient, backward_chunk_fused(
                rays, mesh, nc_, diff, 0, cfg, spt, csr=csr, grad=grad)
        if mode == "vertex":
            g = backward_chunk(rays, mesh, nc_, diff, 0, cfg, spt, alpha)
        elif mode == "albedo":
            g = backward_albedo_chunk(rays, nc_, diff, 0, cfg, spt)
        elif mode == "alpha":
            g = backward_alpha_chunk(rays, nc_, diff, 0, cfg, spt, alpha)
        elif mode == "jitter":
            g = backward_jitter_chunk(rays, mesh, nc_, diff, 0, cfg, spt, jw,
                                      jg, joff)
        else:
            raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
        return transient, g if grad is None else grad + g


def vertex_csr_for(mesh: Mesh, cfg: RenderConfig,
                   mode: str) -> Optional[VertexCSR]:
    """The fused backward's vertex CSR, built once per call; None where the
    call runs no fused backward."""
    if mode == "vertex" and _use_fused_bwd(cfg):
        return vertex_csr(mesh.f, mesh.f_valid, mesh.v.shape[0])
    return None


def inverse_rows(mesh: Mesh, data, weight, lighting, lighting_normal, key,
                 cfg: RenderConfig, spt: int, mode: str, alpha,
                 hier: Optional[FaceHierarchy], csr: Optional[VertexCSR],
                 jitter=None, source_offset: int = 0, faces=None):
    """(transient [L,B], gradient summed over the chunks in chunk order,
    not yet divided by the source count) of the sources lighting [L, 3]
    (f32 tensors on the mesh's device) whose first global index is
    ``source_offset``; data and weight are their rows [L, B]; ``hier``
    and ``faces`` as ``_prepare`` gives them."""
    lit, nrm, L, Lc, nc = _chunks(lighting, lighting_normal, cfg)
    dev = mesh.device
    data_p = _padded_rows(data, nc * Lc, dev)
    weight_p = _padded_rows(weight, nc * Lc, dev)
    parts, grad = [], None
    for i in range(nc):
        rows = slice(i * Lc, (i + 1) * Lc)
        t, grad = _fused_chunk_body(mesh, lit[i], nrm[i],
                                    source_offset + i * Lc, key,
                                    data_p[rows], weight_p[rows], cfg, spt,
                                    hier, csr, grad, mode, alpha, jitter,
                                    faces)
        parts.append(t)
    return torch.cat(parts, dim=0)[:L], grad


def _inverse(mesh: Mesh, data, weight, lighting, lighting_normal,
             cfg: RenderConfig, key, mode: str, alpha, jitter=None):
    """(transient [L,B], gradient) of sum_{l,b} weight*(data - T)^2
    averaged over sources: per-chunk gradients summed in chunk order, then
    divided by L."""
    check_backends(cfg)
    dev = mesh.device
    lighting = _as_tensor(lighting, dev)
    with timers.span("render.call"):
        with timers.span("render.prepare"):
            hier, faces = _prepare(mesh, cfg)
            csr = vertex_csr_for(mesh, cfg, mode)
        t, grad = inverse_rows(mesh, data, weight, lighting,
                               _as_tensor(lighting_normal, dev), key.to(dev),
                               cfg, _spt(cfg, mesh), mode, alpha, hier, csr,
                               jitter, faces=faces)
    return t, grad / float(lighting.shape[0])


def inverse_render(mesh: Mesh, data, weight, lighting, lighting_normal,
                   cfg: RenderConfig, key, alpha=None):
    """(transient [L,B], vertex gradient [V,3], pathlengths [B])."""
    t, g = _inverse(mesh, data, weight, lighting, lighting_normal, cfg, key,
                    "vertex", alpha)
    return t, g, pathlengths(cfg, mesh.device)


inverse_render_host = inverse_render


def inverse_shading_render(mesh: Mesh, data, weight, lighting,
                           lighting_normal, cfg: RenderConfig, key):
    """inverse_render with freshly computed vertex normals and 'vn'
    shading -> (transient, vertex gradient, pathlengths)."""
    mesh = mesh._replace(vn=vertex_normals(mesh.v, mesh.f, mesh.f_valid))
    return inverse_render(mesh, data, weight, lighting, lighting_normal,
                          cfg.replace(normal="vn"), key)


def inverse_render_albedo(mesh: Mesh, data, weight, lighting,
                          lighting_normal, cfg: RenderConfig, key):
    """(transient, scalar albedo gradient); Lambertian only (the JAX
    package's albedo mode fails for 'ggx')."""
    _lambertian_only(cfg, "inverse_render_albedo")
    return _inverse(mesh, data, weight, lighting, lighting_normal, cfg, key,
                    "albedo", None)


def inverse_render_alpha(mesh: Mesh, data, weight, lighting, lighting_normal,
                         cfg: RenderConfig, key, alpha):
    """(transient, scalar GGX-roughness gradient at ``alpha``)."""
    return _inverse(mesh, data, weight, lighting, lighting_normal, cfg, key,
                    "alpha", alpha)


def vertex_gradient_bins(mesh: Mesh, lighting, lighting_normal,
                         cfg: RenderConfig, key, vertex_num: int):
    """Per-bin single-vertex gradient diagnostic [B,3], summed over the
    chunks in order; traced through ``trace_chunk``."""
    spt, key, lit, nrm, L, Lc, nc = _setup(mesh, lighting, lighting_normal,
                                           cfg, key)
    hier, faces = _prepare(mesh, cfg)
    out = None
    for i in range(nc):
        rays = trace_chunk(mesh, lit[i], nrm[i], key, cfg, spt,
                           source_offset=i * Lc, hier=hier, faces=faces)
        part = vertex_gradient_bins_chunk(rays, mesh, nrm[i], vertex_num, cfg,
                                          spt)
        out = part if out is None else out + part
    return out


def render_transient_jitter(mesh: Mesh, lighting, lighting_normal,
                            cfg: RenderConfig, key, jitter_weight,
                            jitter_offset: int):
    """Forward transient [L,B] smoothed by a measured temporal kernel [K]
    (T[l,b] = sum_i weight[i] * raw[l, b + offset - i]), pathlengths."""
    _lambertian_only(cfg, "the jitter render")
    spt, key, lit, nrm, L, Lc, nc = _setup(mesh, lighting, lighting_normal,
                                           cfg, key)
    hier, faces = _prepare(mesh, cfg)
    hist = torch.cat([
        forward_chunk(trace_chunk(mesh, lit[i], nrm[i], key, cfg, spt,
                                  source_offset=i * Lc, hier=hier,
                                  faces=faces),
                      nrm[i], cfg, spt, refine=1)
        for i in range(nc)], dim=0)[:L]
    t = jitter_convolve(hist, _as_tensor(jitter_weight, mesh.device),
                        jitter_offset)
    return t, pathlengths(cfg, mesh.device)


def inverse_render_jitter(mesh: Mesh, data, weight, lighting,
                          lighting_normal, cfg: RenderConfig, key,
                          jitter_weight, jitter_grad, jitter_offset: int):
    """(transient, vertex gradient, pathlengths) under the measured jitter
    kernel and its derivative ``jitter_grad``."""
    _lambertian_only(cfg, "the jitter render")
    jitter = (_as_tensor(jitter_weight, mesh.device),
              _as_tensor(jitter_grad, mesh.device), jitter_offset)
    t, g = _inverse(mesh, data, weight, lighting, lighting_normal, cfg, key,
                    "jitter", None, jitter)
    return t, g, pathlengths(cfg, mesh.device)


def transient_loss_and_grad(mesh: Mesh, data, weight, lighting,
                            lighting_normal, cfg: RenderConfig, key,
                            alpha=None):
    """(weighted L2 loss sum(w*(T - data)^2)/L, transient, vertex
    gradient), without the smoothness term."""
    t, g, _ = inverse_render(mesh, data, weight, lighting, lighting_normal,
                             cfg, key, alpha)
    diff = (t - _as_tensor(data, t.device)) * torch.sqrt(
        _as_tensor(weight, t.device))
    return (diff * diff).sum() / diff.shape[0], t, g
