"""One source chunk's sampling and ray setup, in one kernel on the card.

``sample_rays`` computes what the chunk's visibility query and forward
splat read, for rays ordered (source, face, sample): the stratified draws
(geometry/sampling.py: threefry-2x32 under fold_in(key, global source
index)), the barycoords, the rays from each source to its samples, the
shading normal and albedo, the skip mask of rays whose contribution is
zero in every consumer (t_self = 0: no visibility test) and, where the
caller splats, the contribution (the Lambertian or GGX BRDF) and its
clipped fine bin.  On CUDA tensors it runs csrc/sample_rays.cu, one launch
a chunk, bit for bit the plain version's outputs; on CPU tensors it runs
``sample_rays_plain``, the eager PyTorch composition.

It replaces no TPU kernel: the JAX package leaves this work to XLA's
fusion.  Eager PyTorch runs the composition as ~470 elementwise launches a
chunk (most of them 20 rounds of int64 threefry arithmetic), so the chunk
loop waits on the host; the kernel is bound by the bytes it writes (~61 a
ray: ~93 MB, ~28 us at 3.35 TB/s, for a 64-source chunk of 23,762 faces).

A face's unit normal and area (``face_normals_areas``) are per mesh: the
render entry points compute them once a call and hand them in as
``faces``; without them they are computed here.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _cuda
from ..config import RenderConfig
from ..geometry.mesh import Mesh, face_normals_areas, norm3
from ..geometry.sampling import stratified_barycoords
from .core import RayBatch, _contrib_and_bins, _dot

_MODES = {None: 0, "lambertian": 1, "ggx": 2}   # the kernel's contribution


class ChunkRays(NamedTuple):
    """A source chunk's rays before occlusion and the visibility query's
    and splat's inputs; R = Lc * F * spt."""

    rays: RayBatch                   # valid: before occlusion
    o: torch.Tensor                  # [R,3] each ray's source
    t_self: torch.Tensor             # [R]   hs, 0 where skipped
    fid: torch.Tensor                # [R]   int32 face
    contrib: Optional[torch.Tensor]  # [R]   before occlusion, or None
    bin_f: Optional[torch.Tensor]    # [R]   int32 in [0, Bf), or None


def _sample_chunk(mesh: Mesh, lighting, key, cfg: RenderConfig, spt: int,
                  source_offset: int):
    """Stratified sampling + ray setup for one source chunk (no occlusion).

    Returns (bary, dirs, hs, in_range, flat o, flat t, fid)."""
    Lc = lighting.shape[0]
    F = mesh.f.shape[0]
    v1, v2, v3 = (mesh.v[mesh.f[:, k]] for k in range(3))
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
    t_flat = hs.reshape(R)
    fid = torch.arange(F, dtype=torch.int32, device=mesh.device)[None, :, None]
    fid = fid.expand(Lc, F, spt).reshape(R)
    return bary, dirs, hs, in_range, o_flat, t_flat, fid


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


def sample_rays_plain(mesh: Mesh, lighting, lighting_normal, key,
                      cfg: RenderConfig, spt: int, source_offset: int = 0,
                      faces=None, refine: Optional[int] = None,
                      alpha=None) -> ChunkRays:
    """Plain PyTorch version of ``sample_rays``: the eager composition."""
    face_n, area = (face_normals_areas(mesh.v, mesh.f) if faces is None
                    else faces)
    bary, dirs, hs, in_range, o_flat, t_flat, fid = _sample_chunk(
        mesh, lighting, key, cfg, spt, source_offset)
    normal, alb = _interp_attrs(mesh, bary, dirs, face_n, cfg)
    pre_valid = (mesh.f_valid[None, :, None] & in_range
                 & (area > 0)[None, :, None])
    skip = _occl_skip_mask(dirs, normal, face_n, lighting_normal, pre_valid)
    rays = RayBatch(dirs=dirs, h=hs, normal=normal, albedo=alb, bary=bary,
                    valid=pre_valid, area=area, face_n=face_n)
    contrib = bin_f = None
    if refine is not None:
        contrib, bin_f = (x.reshape(-1) for x in _contrib_and_bins(
            rays, lighting_normal, cfg, spt, refine, alpha))
    return ChunkRays(rays, o_flat.contiguous(),
                     torch.where(skip.reshape(-1), 0.0, t_flat), fid,
                     contrib, bin_f)


def _check(name, t, dtype, shape, device):
    """dtype None: any floating type (the plain version's f64 renders)."""
    if dtype is None and not t.is_floating_point():
        raise ValueError(f"{name}: expected a floating dtype, got {t.dtype}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the mesh on {device}")


def _checked(mesh: Mesh, lighting, lighting_normal, key, faces, alpha):
    """Check every input (f32 throughout on the card) -> (face_n, area)."""
    dev = mesh.device
    fl = torch.float32 if dev.type == "cuda" else None
    V, F, Lc = mesh.v.shape[0], mesh.f.shape[0], lighting.shape[0]
    if faces is None:
        faces = face_normals_areas(mesh.v, mesh.f)
    for name, t, dt, shape in (
            ("v", mesh.v, fl, (V, 3)), ("f", mesh.f, torch.int64, (F, 3)),
            ("f_valid", mesh.f_valid, torch.bool, (F,)),
            ("vn", mesh.vn, fl, (V, 3)), ("albedo", mesh.albedo, fl, (V,)),
            ("face_n", faces[0], fl, (F, 3)), ("area", faces[1], fl, (F,)),
            ("lighting", lighting, fl, (Lc, 3)),
            ("lighting_normal", lighting_normal, fl, (Lc, 3)),
            ("key", key, torch.int64, (2,))):
        _check(name, t, dt, shape, dev)
    if torch.is_tensor(alpha) and alpha.numel() != 1:
        raise ValueError(f"alpha: expected one value, got shape "
                         f"{tuple(alpha.shape)}")
    return faces


def sample_rays(mesh: Mesh, lighting, lighting_normal, key,
                cfg: RenderConfig, spt: int, source_offset: int = 0,
                faces=None, refine: Optional[int] = None,
                alpha=None) -> ChunkRays:
    """Sampling and ray setup for the chunk of sources ``lighting`` [Lc,3]
    (normals [Lc,3]) whose first global index is ``source_offset``.

    key: the sampler's int64 [2] on the mesh's device; faces: (face_n
    [F,3], area [F]) of the mesh, computed here when None; refine: the
    fine bins per coarse bin of the splat, None where the caller needs no
    contribution (the visibility query alone); alpha: the GGX roughness
    under cfg.brdf 'ggx' (a 0-dim tensor, read on the device, or a number;
    None the default 0.1).  Inputs must be contiguous, of matching shapes,
    f32 on the card.  Returns a ``ChunkRays``."""
    face_n, area = _checked(mesh, lighting, lighting_normal, key, faces,
                            alpha)
    if mesh.device.type == "cpu":
        return sample_rays_plain(mesh, lighting, lighting_normal, key, cfg,
                                 spt, source_offset, (face_n, area), refine,
                                 alpha)
    if mesh.device.type != "cuda":
        raise ValueError(f"sample_rays: unsupported device {mesh.device}")
    dev = mesh.device
    Lc, F = lighting.shape[0], mesh.f.shape[0]
    shape = (Lc, F, spt)
    R = Lc * F * spt

    def empty(*s, dtype=torch.float32):
        return torch.empty(s, dtype=dtype, device=dev)

    dirs, bary = empty(*shape, 3), empty(*shape, 3)
    h, alb = empty(*shape), empty(*shape)
    valid = empty(*shape, dtype=torch.bool)
    vn = cfg.normal == "vn"
    normal = empty(*shape, 3) if vn else face_n[None, :, None, :].expand(
        dirs.shape)
    o, t, fid = empty(R, 3), empty(R), empty(R, dtype=torch.int32)
    mode = _MODES[cfg.brdf if refine is not None else None]
    contrib = empty(R) if mode else None
    bin_f = empty(R, dtype=torch.int32) if mode else None
    refine_ = 1 if refine is None else int(refine)
    if torch.is_tensor(alpha):   # read on the device, as core._alpha_like
        alpha = alpha.detach().to(dev, torch.float32).reshape(())
    status = _launcher()(
        *(_cuda.ptr(x) for x in (mesh.v, mesh.f, mesh.f_valid, mesh.vn,
                                 mesh.albedo, face_n, area, lighting,
                                 lighting_normal, key)),
        _cuda.ptr(alpha) if torch.is_tensor(alpha) else None,
        0.0 if torch.is_tensor(alpha)
        else float(np.float32(0.1 if alpha is None else alpha)),
        R, F, int(spt), int(source_offset),
        float(np.float32(cfg.bin_lower / 2.0)),
        float(np.float32(cfg.bin_upper / 2.0)),
        float(np.float32(1.0) / np.float32(spt)),
        float(np.float32(cfg.bin_lower)),
        float(np.float32(cfg.distance_resolution / refine_)),
        cfg.num_bins * refine_, int(vn), mode,
        *(_cuda.ptr(x) for x in (dirs, h, bary, alb, valid)),
        _cuda.ptr(normal) if vn else None,
        *(_cuda.ptr(x) for x in (o, t, fid)),
        _cuda.ptr(contrib) if mode else None,
        _cuda.ptr(bin_f) if mode else None, _cuda.stream(dev))
    _cuda.check(status, "sample_rays")
    sample_rays.launches += 1
    rays = RayBatch(dirs=dirs, h=h, normal=normal, albedo=alb, bary=bary,
                    valid=valid, area=area, face_n=face_n)
    return ChunkRays(rays, o, t, fid, contrib, bin_f)


sample_rays.launches = 0

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ARGTYPES = ([_P] * 11 + [_F, _L, _I, _I, _L] + [_F] * 5 + [_I] * 3
             + [_P] * 12)
_bound = []


def _launcher():
    """The C launcher, bound (argument types set) once per process."""
    if not _bound:
        fn = _cuda.library("sample_rays").sample_rays_launch
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _bound.append(fn)
    return _bound[0]
