"""Fused visibility + histogram splat for one source chunk (kernel K1).

``occluded_splat`` replaces the JAX package's Pallas kernel
(render/fused_kernels.py ``_fused_kernel`` / ``occluded_splat_pallas``).
For rays ordered (source, face, sample) it returns

  occ[r]     another valid face crosses o -> o + d*t at t in
             (t_min, t_self*(1-t_rel)), by sign-safe Möller–Trumbore with
             the ray's own face excluded;
  hist[l,k]  the sum of contrib_pre over source l's unoccluded rays in
             fine bin k.

On a CUDA tensor it runs csrc/occluded_splat.cu: one 128-ray block of one
source per CUDA block, whose broad phase (over the ``face_hierarchy`` of
8-face groups and 64-face supergroups, built once per render) and narrow
phase both run in the kernel, then a deterministic splat (block-sorted
runs, reduced per (bin range, source, slab of blocks) in block order, the
slabs then added in order).  On a CPU tensor it
runs ``occluded_splat_plain``, which tests every face.  ``broad_phase`` is
the plain version of the kernel's candidate lists, pass by pass, and
``narrow_plain`` of its narrow phase on one pass (the per-ray group cull
included).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _cuda
from ..geometry.accel import morton_order_torch

RB = 128          # rays per block; a block never spans two sources
GF = 8            # faces per group
SG = 8            # groups per supergroup (64 faces)
LIST_CAP = 1024   # groups a block lists before it tests them (one pass)
REDUCE_SLAB = 128  # block runs one reduce block adds; slabs then add in order
SOUP_W = 12       # floats per face in the soup: p1, e1, e2, valid, id, pad
EPS_DET = 1e-12
_SMEM_MAX = 227 * 1024


class FaceHierarchy(NamedTuple):
    """What the kernels read of a mesh: its faces in Morton order, padded
    to whole supergroups -- the face soup, each soup face's index in the
    mesh, and the boxes (lo | hi over VALID vertices; an empty box has
    lo > hi) of the 8-face groups and of the 64-face supergroups."""

    soup: torch.Tensor          # [ns*SG*GF, SOUP_W] f32; column 10: faces
    faces: torch.Tensor         # [ns*SG*GF] int32 mesh face (-1: padding)
    group_boxes: torch.Tensor   # [ns*SG, 6] f32
    super_boxes: torch.Tensor   # [ns, 6] f32


def face_soup(v, f, f_valid, num_groups: int):
    """[num_groups*GF, SOUP_W] f32: p1 | e1 | e2 | valid | 0 0 per face;
    padding faces are invalid."""
    F = f.shape[0]
    p1 = v[f[:, 0]].float()
    e1 = (v[f[:, 1]] - v[f[:, 0]]).float()
    e2 = (v[f[:, 2]] - v[f[:, 0]]).float()
    soup = torch.zeros((num_groups * GF, SOUP_W), dtype=torch.float32,
                       device=v.device)
    soup[:F] = torch.cat([p1, e1, e2, f_valid.float()[:, None],
                          p1.new_zeros(F, 2)], dim=1)
    return soup


def _group_boxes(v, f, f_valid, num_groups: int, gf: int):
    """[num_groups, 6] AABBs (lo|hi) over each gf-face group's VALID
    vertices (empty groups get lo > hi)."""
    F = f.shape[0]
    pad = num_groups * gf - F
    verts = v[f].float()                                     # [F, 3, 3]
    verts = torch.nn.functional.pad(verts, (0, 0, 0, 0, 0, pad))
    val = torch.nn.functional.pad(f_valid, (0, pad))
    verts = verts.reshape(num_groups, gf, 3, 3)
    w = val.reshape(num_groups, gf)[..., None, None]
    lo = torch.where(w, verts, 1e30).amin(dim=(1, 2))
    hi = torch.where(w, verts, -1e30).amax(dim=(1, 2))
    return torch.cat([lo, hi], dim=1)


def face_hierarchy(v, f, f_valid) -> FaceHierarchy:
    """The kernels' view of a mesh: build it once per render and hand it
    to every chunk.  The faces go in Morton order (the identity for a mesh
    already in that order, as the loop's and the GT's are), so that groups
    and supergroups are compact whatever order the caller's faces are in
    (the loop renders the cull intensities in geomlib's order).  Torch ops
    on the mesh's device: a sort of F codes, the rest O(F)."""
    F = f.shape[0]
    ns = -(-F // (GF * SG))
    order = morton_order_torch(v, f)
    fo, fvo = f[order], f_valid[order]
    faces = torch.full((ns * SG * GF,), -1, dtype=torch.int32,
                       device=f.device)
    faces[:F] = order.to(torch.int32)
    soup = face_soup(v, fo, fvo, ns * SG)
    soup[:, 10] = faces.view(torch.float32)
    groups = _group_boxes(v, fo, fvo, ns * SG, GF)
    g = groups.reshape(ns, SG, 6)
    supers = torch.cat([g[..., :3].amin(dim=1), g[..., 3:].amax(dim=1)], 1)
    return FaceHierarchy(soup, faces, groups.contiguous(),
                         supers.contiguous())


def check_hierarchy(hier: FaceHierarchy, num_faces: int, device) -> None:
    ns = -(-num_faces // (GF * SG))
    for name, t, dt, shape in (
            ("soup", hier.soup, torch.float32, (ns * SG * GF, SOUP_W)),
            ("faces", hier.faces, torch.int32, (ns * SG * GF,)),
            ("group_boxes", hier.group_boxes, torch.float32, (ns * SG, 6)),
            ("super_boxes", hier.super_boxes, torch.float32, (ns, 6))):
        _check(f"hier.{name}", t, dt, shape)
        if t.device != device:
            raise ValueError(f"hier.{name} is on {t.device}, rays on {device}")


def _slab_hits(a, b, half, boxes):
    """The kernels' slab test, operation for operation, broadcast over
    pairs: segment a -> b [..., 3] widened by half [..., 3] (+ 1e-5)
    crosses box lo | hi [..., 6]; an empty box is never crossed."""
    lo = boxes[..., 0:3] - (half + 1e-5)
    hi = boxes[..., 3:6] + (half + 1e-5)
    ab = b - a
    par = torch.abs(ab) <= 1e-30
    inv = torch.where(par, 0.0, 1.0 / ab)
    t0 = (lo - a) * inv
    t1 = (hi - a) * inv
    tmin = torch.minimum(t0, t1)
    tmax = torch.maximum(t0, t1)
    inside = (a >= lo) & (a <= hi)
    inf = torch.tensor(float("inf"), device=a.device)
    tmin = torch.where(par, torch.where(inside, -inf, inf), tmin)
    tmax = torch.where(par, torch.where(inside, inf, -inf), tmax)
    enter = torch.clamp(tmin.amax(dim=-1), min=0.0)
    exit_ = torch.clamp(tmax.amin(dim=-1), max=1.0)
    empty = (boxes[..., 0:3] > boxes[..., 3:6]).any(dim=-1)
    return (enter <= exit_) & ~empty


def hier_candidates(a, b, half, live, hier: FaceHierarchy):
    """Plain version of the kernels' broad phase for nb blocks, block k
    bounded by segment a[k] -> b[k] widened by half[k] ([nb, 3] each; a
    block with live[k] False lists nothing) -> (counts [nb] int32, lists
    [nb, max count] int32).

    lists[k, :counts[k]] are block k's candidate groups in the kernel's
    order (supergroups that pass, then their groups that pass: increasing),
    padded with -1.  The kernel tests them in passes of its list capacity
    cap: pass p is lists[k, p*cap:(p+1)*cap]."""
    nb, dev = a.shape[0], a.device
    ns = hier.super_boxes.shape[0]
    step = max(1, (1 << 22) // max(ns, 1))   # ~4 M block x supergroup pairs
    blk, gid = [], []
    for b0 in range(0, nb, step):
        s = slice(b0, min(b0 + step, nb))
        sup = _slab_hits(a[s, None], b[s, None], half[s, None],
                         hier.super_boxes[None]) & live[s, None]
        bi, si = torch.nonzero(sup, as_tuple=True)
        g = si[:, None] * SG + torch.arange(SG, device=dev)       # [P, SG]
        hit = _slab_hits(a[s][bi][:, None], b[s][bi][:, None],
                         half[s][bi][:, None], hier.group_boxes[g])
        blk.append((bi + b0)[:, None].expand_as(g)[hit])
        gid.append(g[hit])
    blk = torch.cat(blk) if blk else torch.zeros(0, dtype=torch.int64,
                                                 device=dev)
    gid = torch.cat(gid) if gid else blk
    counts = torch.bincount(blk, minlength=nb)
    width = int(counts.max()) if nb else 0
    pos = torch.arange(blk.shape[0], device=dev) - (
        torch.cumsum(counts, 0) - counts)[blk]
    lists = torch.full((nb, width), -1, dtype=torch.int32, device=dev)
    lists[blk, pos] = gid.to(torch.int32)
    return counts.to(torch.int32), lists


def block_hulls(o, d, t_self, Lc: int):
    """Per 128-ray block of one source (Lc*nbs blocks): (a, b, half [.,3],
    live [.], nbs).  The block's segments run from its source (one point)
    to the box around its live endpoints, b its centre and half its
    half-extents; dead rays (t == 0) widen nothing, and a block without a
    live ray has live False."""
    R = o.shape[0]
    rs = R // Lc
    nbs = -(-rs // RB)
    pad = nbs * RB - rs
    p_end = (o + d * t_self[:, None]).reshape(Lc, rs, 3)
    live = (t_self > 0.0).reshape(Lc, rs, 1)
    p_end = torch.nn.functional.pad(p_end, (0, 0, 0, pad))
    live = torch.nn.functional.pad(live, (0, 0, 0, pad))
    pb = p_end.reshape(Lc * nbs, RB, 3)
    mb = live.reshape(Lc * nbs, RB, 1)
    a_seg = o.reshape(Lc, rs, 3)[:, 0, :].repeat_interleave(nbs, dim=0)
    any_live = mb.any(dim=1)
    plo = torch.where(any_live, torch.where(mb, pb, float("inf")).amin(1),
                      a_seg)
    phi = torch.where(any_live, torch.where(mb, pb, float("-inf")).amax(1),
                      a_seg)
    return a_seg, 0.5 * (plo + phi), 0.5 * (phi - plo), any_live[:, 0], nbs


def broad_phase(o, d, t_self, Lc: int, hier: FaceHierarchy):
    """Plain version of K1's candidate lists: (counts [Lc*nbs] int32,
    lists, nbs) as ``hier_candidates`` gives them for ``block_hulls``."""
    a, b, half, live, nbs = block_hulls(o, d, t_self, Lc)
    counts, lists = hier_candidates(a, b, half, live, hier)
    return counts, lists, nbs


def sign_safe_blocked(o, d, t_cut, self_fid, soup, fids, t_min: float,
                      eps_det: float = EPS_DET, pairs: bool = False):
    """[r, k] bool: face k blocks ray r (the kernel's predicate, operation
    for operation: no divide, each product and sum rounded on its own).
    With ``pairs``, ray i is tested against face i only -> [n]."""
    ray = (slice(None),) if pairs else (slice(None), None)
    face = (slice(None),) if pairs else (None, slice(None))
    t_cut, self_fid = t_cut[ray], self_fid[ray]
    ox, oy, oz = (o[ray + (i,)] for i in range(3))
    dx, dy, dz = (d[ray + (i,)] for i in range(3))
    p1x, p1y, p1z, e1x, e1y, e1z, e2x, e2y, e2z, val = (
        soup[face + (i,)] for i in range(10))
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    tvx = ox - p1x
    tvy = oy - p1y
    tvz = oz - p1z
    u_num = tvx * pvx + tvy * pvy + tvz * pvz
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v_num = dx * qvx + dy * qvy + dz * qvz
    t_num = e2x * qvx + e2y * qvy + e2z * qvz
    s = torch.where(det >= 0.0, 1.0, -1.0)
    dd = det * s
    un = u_num * s
    vn = v_num * s
    tn = t_num * s
    return ((dd > eps_det) & (un >= 0.0) & (vn >= 0.0) & (un + vn <= dd)
            & (val > 0.5) & (tn > t_min * dd) & (tn < t_cut * dd)
            & (fids[face] != self_fid))


def narrow_plain(o, d, t_cut, self_fid, hier: FaceHierarchy, groups,
                 t_min: float, eps_det: float = EPS_DET):
    """Plain version of the kernels' narrow phase on one pass's list: [r]
    bool, ray i blocked by a face of the listed groups [k].  As in the
    kernel, a ray tests a group's faces only when its own segment
    o -> o + d*t_cut crosses the group's box widened by 1e-5 (the per-ray
    group cull, ``_slab_hits`` with no half-extent)."""
    r, k = o.shape[0], groups.shape[0]
    end = o + d * t_cut[:, None]
    cross = _slab_hits(o[:, None], end[:, None], torch.zeros_like(o)[:, None],
                       hier.group_boxes[groups][None])               # [r, k]
    faces = (groups[:, None] * GF
             + torch.arange(GF, device=o.device)).reshape(-1)
    hit = sign_safe_blocked(o, d, t_cut, self_fid, hier.soup[faces],
                            hier.faces[faces], t_min, eps_det)   # [r, k*GF]
    return (hit.reshape(r, k, GF).any(2) & cross).any(1)


def _face_columns(soup, rows: int):
    """The soup's p1 | e1 | e2 | valid columns, each expanded to a
    contiguous [rows, k]: every operation of ``_blocked_any`` then pairs a
    full tile with a ray column or another full tile, PyTorch's fast
    cases (a product of a row by a column is several times slower)."""
    return [soup[:, i].expand(rows, soup.shape[0]).contiguous()
            for i in range(10)]


def _blocked_any(o, d, t_cut, self_fid, soup, fids, cols, t_min: float,
                 eps_det: float = EPS_DET):
    """[r] bool: ``sign_safe_blocked(...).any(1)`` for r rays against the
    k faces of ``soup`` (``cols``: ``_face_columns(soup, >= r)``), in two
    stages.  The first evaluates the predicate's u conditions (dd > eps,
    0 <= un <= dd; un + vn <= dd with vn >= 0 implies un <= dd) for every
    pair; the second the whole predicate, operation for operation, for the
    surviving pairs only (about a tenth)."""
    n = o.shape[0]
    ox, oy, oz = (o[:, i:i + 1] for i in range(3))
    dx, dy, dz = (d[:, i:i + 1] for i in range(3))
    p1x, p1y, p1z, e1x, e1y, e1z, e2x, e2y, e2z, val = (c[:n] for c in cols)
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    u_num = (ox - p1x) * pvx + (oy - p1y) * pvy + (oz - p1z) * pvz
    s = torch.where(det >= 0.0, 1.0, -1.0)
    dd = det * s
    un = u_num * s
    i, j = torch.nonzero((dd > eps_det) & (un >= 0.0) & (un <= dd)
                         & (val > 0.5), as_tuple=True)
    hit = sign_safe_blocked(o[i], d[i], t_cut[i], self_fid[i],
                            soup[j], fids[j], t_min, eps_det, pairs=True)
    out = torch.zeros(n, dtype=torch.bool, device=o.device)
    return out.index_fill_(0, i[hit], True)


def occluded_plain(o, d, t_self, self_fid, v, f, f_valid, t_rel=1e-4,
                   t_min=1e-6, ray_tile=None, face_tile: int = 512):
    """[R] bool occlusion by the kernel's predicate against every face
    (rays with t_cut <= t_min, which no face can block, are not tested).
    Tiles of ray_tile x face_tile pairs, by default about 64 K on the CPU
    (each temporary stays in cache) and 4 M on a card."""
    F = f.shape[0]
    soup = face_soup(v, f, f_valid, -(-F // GF))[:F]
    fids = torch.arange(F, dtype=torch.int32, device=o.device)
    t_cut = t_self * (1.0 - t_rel)
    sfid = self_fid.to(torch.int32)
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    live = torch.nonzero(t_cut > t_min)[:, 0]
    if ray_tile is None:
        pairs = 1 << 16 if o.device.type == "cpu" else 1 << 22
        ray_tile = max(1, pairs // max(min(face_tile, F), 1))
    for f0 in range(0, F, face_tile):
        fs = slice(f0, min(f0 + face_tile, F))
        cols = _face_columns(soup[fs], min(ray_tile, live.shape[0]))
        for r0 in range(0, live.shape[0], ray_tile):
            rs = live[r0:r0 + ray_tile]
            occ[rs] |= _blocked_any(o[rs], d[rs], t_cut[rs], sfid[rs],
                                    soup[fs], fids[fs], cols, t_min)
    return occ


def occluded_splat_plain(o, d, t_self, self_fid, contrib_pre, bin_idx,
                         v, f, f_valid, Lc: int, num_fine_bins: int,
                         t_rel=1e-4, t_min=1e-6):
    """Plain PyTorch version of ``occluded_splat`` (same results; the
    histogram up to f32 summation order)."""
    occ = occluded_plain(o, d, t_self, self_fid, v, f, f_valid, t_rel, t_min)
    R = o.shape[0]
    l_idx = torch.arange(Lc, device=o.device).repeat_interleave(R // Lc)
    seg = l_idx * num_fine_bins + bin_idx.to(torch.int64)
    hist = torch.zeros(Lc * num_fine_bins, dtype=torch.float32,
                       device=o.device)
    hist.index_add_(0, seg, torch.where(occ, 0.0, contrib_pre))
    return occ, hist.reshape(Lc, num_fine_bins)


def _check(name, t, dtype, shape):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def occluded_splat(o, d, t_self, self_fid, contrib_pre, bin_idx, v, f,
                   f_valid, Lc: int, num_fine_bins: int, t_rel=1e-4,
                   t_min=1e-6, hier: FaceHierarchy | None = None):
    """Fused occlusion + histogram splat for one source chunk.

    o, d [R,3] f32; t_self [R] f32 (0 = dead ray, never occluded);
    self_fid [R] int32; contrib_pre [R] f32 (occlusion not yet applied);
    bin_idx [R] int32 in [0, num_fine_bins).  R = Lc * (rays per source),
    ordered by source.  hier: ``face_hierarchy(v, f, f_valid)``, built here
    when not given.  Returns (occluded [R] bool, hist [Lc, bins] f32).
    """
    if o.device.type == "cpu":
        return occluded_splat_plain(o, d, t_self, self_fid, contrib_pre,
                                    bin_idx, v, f, f_valid, Lc,
                                    num_fine_bins, t_rel, t_min)
    if o.device.type != "cuda":
        raise ValueError(f"occluded_splat: unsupported device {o.device}")
    R = o.shape[0]
    if R % Lc:
        raise ValueError(f"ray count {R} is not a multiple of Lc={Lc}")
    for name, t, dt, shape in (
            ("o", o, torch.float32, (R, 3)), ("d", d, torch.float32, (R, 3)),
            ("t_self", t_self, torch.float32, (R,)),
            ("self_fid", self_fid, torch.int32, (R,)),
            ("contrib_pre", contrib_pre, torch.float32, (R,)),
            ("bin_idx", bin_idx, torch.int32, (R,)),
            ("v", v, torch.float32, v.shape), ("f", f, torch.int64, f.shape),
            ("f_valid", f_valid, torch.bool, f.shape[:1])):
        _check(name, t, dt, shape)
        if t.device != o.device:
            raise ValueError(f"{name} is on {t.device}, rays on {o.device}")
    if hier is None:
        hier = face_hierarchy(v, f, f_valid)
    check_hierarchy(hier, f.shape[0], o.device)
    occ, hist, _ = kernel_call(o, d, t_self, self_fid, contrib_pre, bin_idx,
                               hier, Lc, num_fine_bins, t_rel, t_min)
    return occ, hist


def reduce_plan(Lc: int, num_fine_bins: int, nbs: int, sms: int):
    """(ranges, slabs) of the splat reduce for Lc sources of nbs blocks:
    slabs of REDUCE_SLAB blocks' runs, and bin ranges per source for about
    two reduce blocks per SM, at least 128 bins a range, and each range's
    histogram within the shared memory of a block."""
    slabs = -(-nbs // REDUCE_SLAB)
    want = min(-(-2 * sms // (Lc * slabs)), -(-num_fine_bins // RB))
    return max(1, want, -(-4 * num_fine_bins // _SMEM_MAX)), slabs


def occlusion_call(o, d, t_self, self_fid, contrib_pre, bin_idx,
                   hier: FaceHierarchy, Lc: int, num_fine_bins: int, t_rel,
                   t_min, cap: int = LIST_CAP):
    """Launch K1's occlusion kernel on checked inputs -> (occ [R] uint8,
    counts [Lc*nbs] int32: groups listed per block, summed over passes,
    blk_bins, blk_vals: each block's sorted (bin, sum) runs)."""
    R = o.shape[0]
    rs = R // Lc
    nbs = -(-rs // RB)
    nbm = Lc * nbs
    occ = torch.empty(R, dtype=torch.uint8, device=o.device)
    counts = torch.empty(nbm, dtype=torch.int32, device=o.device)
    blk_bins = torch.empty(nbm * RB, dtype=torch.int32, device=o.device)
    blk_vals = torch.empty(nbm * RB, dtype=torch.float32, device=o.device)
    fn = _launcher("occluded_splat_occlusion_launch",
                   [_P] * 9 + [_I] * 6 + [_F] * 3 + [_P] * 5)
    status = fn(
        *(_cuda.ptr(t) for t in (o, d, t_self, self_fid, contrib_pre,
                                 bin_idx, hier.soup, hier.group_boxes,
                                 hier.super_boxes)),
        hier.super_boxes.shape[0], cap, Lc, rs, nbs, int(num_fine_bins),
        1.0 - t_rel, t_min, EPS_DET,
        *(_cuda.ptr(t) for t in (occ, counts, blk_bins, blk_vals)),
        _cuda.stream(o.device))
    _cuda.check(status, "occluded_splat (occlusion)")
    return occ, counts, blk_bins, blk_vals


def reduce_call(blk_bins, blk_vals, Lc: int, num_fine_bins: int,
                ranges: int | None = None):
    """Launch K1's splat reduce -> hist [Lc, bins]: one block per (bin
    range, source, slab of REDUCE_SLAB blocks' runs), then the slabs'
    partial histograms added in slab order; ``ranges`` bin ranges per
    source (``reduce_plan``'s by default; the result is the same for
    any)."""
    dev = blk_bins.device
    Bf = int(num_fine_bins)
    nbs = blk_bins.shape[0] // (Lc * RB)
    auto, slabs = reduce_plan(Lc, Bf, nbs, _cuda.sm_count(dev))
    ranges = auto if ranges is None else ranges
    hist = torch.empty((Lc, Bf), dtype=torch.float32, device=dev)
    partial = torch.empty(Lc * slabs * Bf if slabs > 1 else 0,
                          dtype=torch.float32, device=dev)
    fn = _launcher("occluded_splat_reduce_launch", [_P, _P] + [_I] * 5
                   + [_P, _P, _P])
    status = fn(_cuda.ptr(blk_bins), _cuda.ptr(blk_vals), Lc, nbs, Bf,
                int(ranges), REDUCE_SLAB, _cuda.ptr(partial),
                _cuda.ptr(hist), _cuda.stream(dev))
    _cuda.check(status, "occluded_splat (reduce)")
    return hist


def kernel_call(o, d, t_self, self_fid, contrib_pre, bin_idx,
                hier: FaceHierarchy, Lc: int, num_fine_bins: int, t_rel,
                t_min, cap: int = LIST_CAP, ranges: int | None = None):
    """K1 on checked inputs: the occlusion kernel, then the splat reduce
    -> (occluded [R] bool, hist [Lc, bins], counts [Lc*nbs] int32)."""
    occ, counts, blk_bins, blk_vals = occlusion_call(
        o, d, t_self, self_fid, contrib_pre, bin_idx, hier, Lc,
        num_fine_bins, t_rel, t_min, cap)
    hist = reduce_call(blk_bins, blk_vals, Lc, num_fine_bins, ranges)
    occluded_splat.launches += 1
    return occ.bool(), hist, counts


occluded_splat.launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _launcher(name: str, argtypes):
    fn = getattr(_cuda.library("occluded_splat"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
