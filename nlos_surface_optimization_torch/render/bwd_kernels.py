"""Fused analytic backward for one source chunk (kernel K2 and its
face -> vertex epilogue).

``backward_face_sums`` replaces the JAX package's Pallas kernel
(render/bwd_kernels.py ``_bwd_kernel`` / ``backward_face_sums_pallas``)
together with its prep: per ray it reduces the Gaussian taps at the ray's
fine bin from the source's row of the coarse weighted difference (A, Bw;
the same f32 sums as core._tap_tables, whose tables are no longer built),
evaluates the Lambertian gradient terms and reduces per face, over
sources and samples, to 12 floats (P*b1, P*b2, P*b3, S2), one partial sum
per slab of sources.  ``vertex_epilogue`` replaces the XLA epilogue of
JAX's ``backward_chunk_fused``: the slabs added in order, the per-face
cross(T2f, opposite edge) term, the face -> vertex sum (walked through a
``VertexCSR`` built once per render) and the add into the running
gradient.  On CUDA tensors both run csrc/backward_face_sums.cu; on CPU
tensors their plain versions (``backward_face_sums_plain``, the kernel's
per-ray arithmetic operation for operation, and ``vertex_gradient``).

``backward_chunk_fused`` is the drop-in for core.backward_chunk
(Lambertian BRDF).  On the card it is two launches and no host <-> device
copy or synchronization: the tap weights are cached on the device per
configuration, and the caller builds the CSR once per render.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _cuda
from ..geometry.mesh import scatter_faces
from .core import _EPS, _div, opposite_edges
from .kernels import grouped_gaussian_tables

NV = 12             # per-face terms
NT = 128            # kernel threads a block, one (face, sample) slot each
BLOCKS_PER_SM = 8   # the slab size keeps at least this many blocks a SM


class FaceSumScalars(NamedTuple):
    """The scalars of ``backward_face_sums``."""

    spt: int
    use_gn: bool            # the shading-normal term (vn, testing_flag 0)
    per_ray_normal: bool    # 'vn': normal is [Lc,F,spt,3], else face_n [F,3]
    bin_lower: float
    fine_res: float         # distance_resolution / refine
    num_bins: int           # B, the difference rows' length
    refine: int
    rsig: int               # 2 * refine * sigma_bin
    bw_scale: float         # 2 / sigma^2


class VertexCSR(NamedTuple):
    """Each vertex's (face, slot) entries: ``entries[offsets[v]:
    offsets[v+1]]`` are the flat indices 3*face + slot of f.reshape(-1)
    equal to v, in index order (a stable sort, as ``scatter_faces``
    groups them), valid faces only; the invalid faces' entries follow
    ``offsets[V]``."""

    offsets: torch.Tensor   # [V+1] int32
    entries: torch.Tensor   # [3F] int32


def vertex_csr(f, f_valid, num_vertices: int) -> VertexCSR:
    """The CSR of ``vertex_epilogue``, built once per render.  Padding
    faces (f_valid False) are left out: their rays carry albw = 0 and
    their edges are zero, so they add exact zeros (a bucketed mesh puts
    all of them on vertex 0, which would serialize its sum)."""
    ids = f.reshape(-1)
    keep = f_valid[:, None].expand(-1, 3).reshape(-1)
    key = torch.where(keep, ids, num_vertices)
    order = torch.argsort(key, stable=True)
    offsets = torch.searchsorted(key[order], torch.arange(
        num_vertices + 1, dtype=key.dtype, device=key.device))
    return VertexCSR(offsets.to(torch.int32), order.to(torch.int32))


def segment_sum_csr(values, csr: VertexCSR):
    """[3F, 3] per-(face, slot) vectors -> [V, 3] sums over each vertex's
    entries in order (plain version of the epilogue's walk)."""
    n = int(csr.offsets[-1])
    lengths = (csr.offsets[1:] - csr.offsets[:-1]).long()
    return torch.segment_reduce(values[csr.entries[:n].long()], "sum",
                                lengths=lengths, axis=0)


@functools.lru_cache(maxsize=16)
def _tap_weights(resolution: float, refine: int, sigma_bin: int,
                 device: str) -> torch.Tensor:
    W, WD = grouped_gaussian_tables(resolution, refine, sigma_bin)
    return torch.from_numpy(np.stack([W, WD])).to(device, torch.float32)


def tap_weights(cfg, device) -> torch.Tensor:
    """[2, refine, G] f32: the phase-grouped tap weights W, WD of
    ``grouped_gaussian_tables``, moved to the device once per
    configuration."""
    return _tap_weights(float(cfg.distance_resolution),
                        int(cfg.bin_refine_resolution), int(cfg.sigma_bin),
                        str(torch.device(device)))


def tap_sums_plain(h, diff, wtab, p: FaceSumScalars):
    """(A, Bw) per ray [Lc,F,spt] (Bw not yet scaled by 2/sigma^2): the
    kernel's tap reduction from the difference rows diff [Lc, B], operation
    for operation.  Bit for bit the tap-table lookups of
    core._tap_reductions: A = sum_j W[p,j]*d[b0+j] over j in order from
    zero, p = qs mod refine, b0 = floor(qs/refine), qs = q - rsig; zero
    where the fine bin q is outside [0, Bf]."""
    Lc, B = h.shape[0], p.num_bins
    Bf = B * p.refine
    qf = torch.floor(_div(2.0 * h - p.bin_lower, p.fine_res))
    ok = (torch.abs(qf) < 2.0e9) & (qf >= 0.0) & (qf <= float(Bf))
    qs = torch.where(ok, qf, 0.0).to(torch.int64) - p.rsig
    phase = torch.remainder(qs, p.refine)
    b0 = torch.div(qs, p.refine, rounding_mode="floor")
    row = torch.arange(Lc, device=h.device)[:, None, None] * B
    rows = diff.reshape(-1)
    A = torch.zeros_like(h)
    Bw = torch.zeros_like(h)
    for j in range(wtab.shape[-1]):
        b = b0 + j
        d = torch.where((b >= 0) & (b < B), rows[row + b.clamp(0, B - 1)],
                        0.0)
        A = A + wtab[0, :, j][phase] * d
        Bw = Bw + wtab[1, :, j][phase] * d
    return torch.where(ok, A, 0.0), torch.where(ok, Bw, 0.0)


def backward_face_sums_plain(dirs, h, albedo, valid, bary, normal, area,
                             onorm, diff, wtab, p: FaceSumScalars):
    """Plain PyTorch version of ``backward_face_sums`` -> [F, 12] (the
    slabs' sum)."""
    A, Bw = tap_sums_plain(h, diff, wtab, p)
    Bw = Bw * p.bw_scale
    albw = (albedo * torch.where(valid, 1.0, 0.0) * area[None, :, None]
            * (-2.0 / float(p.spt)))
    inv2a = (1.0 / (2.0 * torch.clamp(area, min=_EPS)))[None, :, None]
    if not p.per_ray_normal:
        normal = normal[None, :, None, :].expand(dirs.shape)

    dx, dy, dz = dirs.unbind(-1)
    nx, ny, nz = normal.unbind(-1)
    b1, b2, b3 = bary.unbind(-1)
    ox, oy, oz = (onorm[:, i, None, None] for i in range(3))

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
    if p.use_gn:
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


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, rays on {device}")


def face_sums_slab(Lc: int, F: int, spt: int, sms: int) -> int:
    """Sources a kernel block walks: Lc // n, n the fewest slabs for which
    the grid (face tiles x slabs) has at least BLOCKS_PER_SM blocks a SM
    (or every source its own slab)."""
    tiles = -(-F // (NT // spt if spt < NT else 1))
    return Lc // min(Lc, max(1, -(-BLOCKS_PER_SM * sms // tiles)))


def backward_face_sums(dirs, h, albedo, valid, bary, normal, area, onorm,
                       diff, wtab, p: FaceSumScalars,
                       slab: Optional[int] = None):
    """Per-face gradient sums of one source chunk, one partial sum per slab
    of sources -> [nslab, F, 12] (the slabs add in order; [1, F, 12] on the
    CPU).

    dirs, bary [Lc,F,spt,3]; h, albedo [Lc,F,spt] f32; valid [Lc,F,spt]
    bool; normal [Lc,F,spt,3] (p.per_ray_normal) or face normals [F,3];
    area [F]; onorm [Lc,3]; diff [Lc,B] the chunk's rows of the weighted
    difference; wtab ``tap_weights``.  ``slab``: sources a block walks
    (``face_sums_slab`` by default).  Columns: 0:3 sum P*b1, 3:6 P*b2,
    6:9 P*b3, 9:12 S2."""
    args = (dirs, h, albedo, valid, bary, normal, area, onorm, diff, wtab)
    if h.device.type == "cpu":
        return backward_face_sums_plain(*args, p)[None]
    if h.device.type != "cuda":
        raise ValueError(f"backward_face_sums: unsupported device {h.device}")
    Lc, F, spt = h.shape
    G = wtab.shape[-1]
    if spt != p.spt:
        raise ValueError(f"rays hold {spt} samples a face, p.spt={p.spt}")
    f32 = torch.float32
    for name, t, dt, shape in (
            ("dirs", dirs, f32, (Lc, F, spt, 3)), ("h", h, f32, (Lc, F, spt)),
            ("albedo", albedo, f32, (Lc, F, spt)),
            ("valid", valid, torch.bool, (Lc, F, spt)),
            ("bary", bary, f32, (Lc, F, spt, 3)),
            ("normal", normal, f32,
             (Lc, F, spt, 3) if p.per_ray_normal else (F, 3)),
            ("area", area, f32, (F,)), ("onorm", onorm, f32, (Lc, 3)),
            ("diff", diff, f32, (Lc, p.num_bins)),
            ("wtab", wtab, f32, (2, p.refine, G))):
        _check(name, t, dt, shape, h.device)
    if slab is None:
        slab = face_sums_slab(Lc, F, spt, _cuda.sm_count(h.device))
    partial = torch.empty((-(-Lc // slab), F, NV), dtype=f32,
                          device=h.device)
    status = _launcher("backward_face_sums_launch")(
        *(_cuda.ptr(t) for t in args), Lc, F, spt, slab, p.num_bins,
        p.refine, G, p.rsig, int(p.per_ray_normal), int(p.use_gn),
        p.bin_lower, p.fine_res, -2.0 / float(spt), p.bw_scale,
        _cuda.ptr(partial), _cuda.stream(h.device))
    _cuda.check(status, "backward_face_sums")
    backward_face_sums.launches += 1
    return partial


backward_face_sums.launches = 0


def slab_sum(partial):
    """[nslab, F, 12] -> [F, 12], the slabs added in slab order."""
    s = partial[0]
    for i in range(1, partial.shape[0]):
        s = s + partial[i]
    return s


def vertex_gradient(sums, mesh, csr: Optional[VertexCSR] = None):
    """Face sums [F, 12] -> vertex gradient [V,3]: adds the per-face
    cross(T2f, opposite edge) and sums faces into their vertices
    (``scatter_faces``, or ``segment_sum_csr`` through csr: the same sums,
    bit for bit, where csr's left-out faces carry zeros)."""
    T2f = sums[:, 9:12]
    edges = opposite_edges(mesh)
    per_face = torch.stack(
        [sums[:, 3 * k:3 * k + 3] + torch.linalg.cross(T2f, edges[k])
         for k in range(3)], dim=1)
    if csr is None:
        return scatter_faces(per_face, mesh.f, mesh.v.shape[0])
    return segment_sum_csr(per_face.reshape(-1, 3), csr)


def vertex_epilogue_plain(partial, mesh, csr: VertexCSR, grad=None):
    """Plain PyTorch version of ``vertex_epilogue``."""
    g = vertex_gradient(slab_sum(partial), mesh, csr)
    return g if grad is None else grad + g


def vertex_epilogue(partial, mesh, csr: VertexCSR, grad=None):
    """Slab partials [nslab, F, 12] -> the chunk's vertex gradient [V,3],
    or, given the running gradient ``grad`` [V,3], grad + that (on the
    card grad is updated in place and returned).  Each vertex adds its
    entries in csr order, each entry its slabs in slab order: the same
    result from run to run."""
    if partial.device.type == "cpu":
        return vertex_epilogue_plain(partial, mesh, csr, grad)
    if partial.device.type != "cuda":
        raise ValueError(f"vertex_epilogue: unsupported device "
                         f"{partial.device}")
    nslab, F = partial.shape[0], partial.shape[1]
    V = mesh.v.shape[0]
    dev = partial.device
    out = (torch.empty((V, 3), dtype=torch.float32, device=dev)
           if grad is None else grad)
    for name, t, dt, shape in (
            ("partial", partial, torch.float32, (nslab, F, NV)),
            ("v", mesh.v, torch.float32, (V, 3)),
            ("f", mesh.f, torch.int64, (F, 3)),
            ("csr.offsets", csr.offsets, torch.int32, (V + 1,)),
            ("csr.entries", csr.entries, torch.int32, (3 * F,)),
            ("grad", out, torch.float32, (V, 3))):
        _check(name, t, dt, shape, dev)
    status = _launcher("vertex_epilogue_launch")(
        _cuda.ptr(partial), nslab, F,
        *(_cuda.ptr(t) for t in (mesh.v, mesh.f, csr.offsets, csr.entries)),
        V, int(grad is not None), _cuda.ptr(out), _cuda.stream(dev))
    _cuda.check(status, "vertex_epilogue")
    vertex_epilogue.launches += 1
    return out


vertex_epilogue.launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "backward_face_sums_launch": [_P] * 10 + [_I] * 10 + [_F] * 4 + [_P, _P],
    "vertex_epilogue_launch": [_P, _I, _I] + [_P] * 4 + [_I, _I, _P, _P],
}
_bound = {}


def _launcher(name: str):
    """The C launcher, bound (argument types set) once per process."""
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(_cuda.library("backward_face_sums"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


def face_sum_inputs(rays, lighting_normal, difference, source_offset: int,
                    cfg, spt: int):
    """The arguments of ``backward_face_sums`` for one source chunk: the
    rays' tensors as the RayBatch holds them (face normals in 'fn' mode),
    the chunk's difference rows, the tap weights and the scalars.  No
    tensor is computed here."""
    if cfg.brdf != "lambertian":
        raise NotImplementedError(f"brdf={cfg.brdf!r} is not ported yet")
    Lc = rays.h.shape[0]
    refine = cfg.bin_refine_resolution
    vn = cfg.normal == "vn"
    p = FaceSumScalars(
        spt=spt, use_gn=vn and cfg.testing_flag == 0, per_ray_normal=vn,
        bin_lower=float(cfg.bin_lower),
        fine_res=float(cfg.distance_resolution / refine),
        num_bins=cfg.num_bins, refine=refine,
        rsig=2 * refine * cfg.sigma_bin,
        bw_scale=2.0 / (cfg.sigma * cfg.sigma))
    return (rays.dirs, rays.h, rays.albedo, rays.valid, rays.bary,
            rays.normal if vn else rays.face_n, rays.area, lighting_normal,
            difference[source_offset:source_offset + Lc],
            tap_weights(cfg, rays.h.device), p)


def backward_chunk_fused(rays, mesh, lighting_normal, difference,
                         source_offset: int, cfg, spt: int,
                         csr: Optional[VertexCSR] = None, grad=None):
    """Drop-in for core.backward_chunk (Lambertian BRDF) -> [V,3], or
    grad + that given the running gradient (updated in place on the card);
    csr: ``vertex_csr`` of the mesh, built here when not given.  The gn
    term is active exactly when backward_chunk's is (normal == 'vn' and
    testing_flag == 0)."""
    partial = backward_face_sums(*face_sum_inputs(
        rays, lighting_normal, difference, source_offset, cfg, spt))
    if csr is None:
        csr = vertex_csr(mesh.f, mesh.f_valid, mesh.v.shape[0])
    return vertex_epilogue(partial, mesh, csr, grad)
