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
source per CUDA block, tested against the 8-face groups of that block's
candidate list (built here by the broad phase, as torch ops), then a
deterministic splat (block-sorted runs, reduced per source in block
order).  On a CPU tensor it runs ``occluded_splat_plain``, which tests
every face.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _cuda

RB = 128          # rays per block; a block never spans two sources
GF = 8            # faces per candidate group
KA_MAX = 256      # candidate-list slots per block; more means a full scan
SOUP_W = 12       # floats per face in the soup: p1, e1, e2, valid, pad
EPS_DET = 1e-12
_SMEM_MAX = 227 * 1024


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


def _slab_candidates(a, b, half, boxes, l_store: int):
    """Swept-box-vs-AABB broad phase -> (counts [nb], lists [nb, l_store]).

    a/b [nb,3] segment endpoints, half [nb,3] inflation of the boxes,
    boxes [ng,6].  Lists hold the candidate group ids in increasing order,
    padded with the sentinel ng; counts above l_store mean: scan all."""
    ng = boxes.shape[0]
    lo = boxes[None, :, 0:3] - (half[:, None, :] + 1e-5)
    hi = boxes[None, :, 3:6] + (half[:, None, :] + 1e-5)
    ab = (b - a)[:, None, :]
    par = torch.abs(ab) <= 1e-30
    inv = torch.where(par, 0.0, 1.0 / ab)
    t0 = (lo - a[:, None, :]) * inv
    t1 = (hi - a[:, None, :]) * inv
    tmin = torch.minimum(t0, t1)
    tmax = torch.maximum(t0, t1)
    inside = (a[:, None, :] >= lo) & (a[:, None, :] <= hi)
    inf = torch.tensor(float("inf"), device=a.device)
    tmin = torch.where(par, torch.where(inside, -inf, inf), tmin)
    tmax = torch.where(par, torch.where(inside, inf, -inf), tmax)
    enter = torch.clamp(tmin.amax(dim=-1), min=0.0)
    exit_ = torch.clamp(tmax.amin(dim=-1), max=1.0)
    empty = (boxes[:, 0:3] > boxes[:, 3:6]).any(dim=1)
    cand = (enter <= exit_) & ~empty[None, :]
    counts = cand.sum(dim=1, dtype=torch.int32)
    iota = torch.arange(ng, dtype=torch.int32, device=a.device)[None, :]
    idx = torch.where(cand, iota, ng)
    k = min(ng, l_store)
    lists = torch.sort(idx, dim=1).values[:, :k]
    if k < l_store:
        lists = torch.nn.functional.pad(lists, (0, l_store - k), value=ng)
    return counts, lists.to(torch.int32).contiguous()


def broad_phase(o, d, t_self, Lc: int, v, f, f_valid, ka_max: int = KA_MAX):
    """Per 128-ray block of one source: (counts [Lc*nbs] int32, lists
    [Lc*nbs, ka_max] int32, nbs).  The block's segments run from the
    source (one point per block) to the box around its live endpoints;
    dead rays (t == 0) do not widen the box."""
    R = o.shape[0]
    rs = R // Lc
    nbs = -(-rs // RB)
    pad = nbs * RB - rs
    ng = -(-f.shape[0] // GF)
    boxes = _group_boxes(v, f, f_valid, ng, GF)
    p_end = (o + d * t_self[:, None]).reshape(Lc, rs, 3)
    live = (t_self > 0.0).reshape(Lc, rs, 1)
    p_end = torch.nn.functional.pad(p_end, (0, 0, 0, pad))
    live = torch.nn.functional.pad(live, (0, 0, 0, pad))
    pb = p_end.reshape(Lc * nbs, RB, 3)
    mb = live.reshape(Lc * nbs, RB, 1)
    a_seg = o.reshape(Lc, rs, 3)[:, 0, :].repeat_interleave(nbs, dim=0)
    plo = torch.where(mb, pb, float("inf")).amin(dim=1)
    phi = torch.where(mb, pb, float("-inf")).amax(dim=1)
    none = ~mb.any(dim=1)
    plo = torch.where(none, a_seg, plo)
    phi = torch.where(none, a_seg, phi)
    counts, lists = _slab_candidates(a_seg, 0.5 * (plo + phi),
                                     0.5 * (phi - plo), boxes, ka_max)
    return counts, lists, nbs


def sign_safe_blocked(o, d, t_cut, self_fid, soup, fids, t_min: float,
                      eps_det: float = EPS_DET):
    """[r, k] bool: face k blocks ray r (the kernel's predicate, operation
    for operation: no divide, each product and sum rounded on its own)."""
    ox, oy, oz = (o[:, None, i] for i in range(3))
    dx, dy, dz = (d[:, None, i] for i in range(3))
    p1x, p1y, p1z, e1x, e1y, e1z, e2x, e2y, e2z, val = (
        soup[None, :, i] for i in range(10))
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
            & (val > 0.5) & (tn > t_min * dd) & (tn < t_cut[:, None] * dd)
            & (fids[None, :] != self_fid[:, None]))


def occluded_plain(o, d, t_self, self_fid, v, f, f_valid, t_rel=1e-4,
                   t_min=1e-6, ray_tile: int = 8192, face_tile: int = 512):
    """[R] bool occlusion by the kernel's predicate against every face."""
    F = f.shape[0]
    soup = face_soup(v, f, f_valid, -(-F // GF))[:F]
    fids = torch.arange(F, dtype=torch.int32, device=o.device)
    t_cut = t_self * (1.0 - t_rel)
    sfid = self_fid.to(torch.int32)
    R = o.shape[0]
    occ = torch.zeros(R, dtype=torch.bool, device=o.device)
    for r0 in range(0, R, ray_tile):
        rs = slice(r0, min(r0 + ray_tile, R))
        acc = occ[rs]
        for f0 in range(0, F, face_tile):
            fs = slice(f0, min(f0 + face_tile, F))
            acc = acc | sign_safe_blocked(o[rs], d[rs], t_cut[rs], sfid[rs],
                                          soup[fs], fids[fs], t_min).any(1)
        occ[rs] = acc
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
                   t_min=1e-6):
    """Fused occlusion + histogram splat for one source chunk.

    o, d [R,3] f32; t_self [R] f32 (0 = dead ray, never occluded);
    self_fid [R] int32; contrib_pre [R] f32 (occlusion not yet applied);
    bin_idx [R] int32 in [0, num_fine_bins).  R = Lc * (rays per source),
    ordered by source.  Returns (occluded [R] bool, hist [Lc, bins] f32).
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
    if 4 * num_fine_bins > _SMEM_MAX:
        raise ValueError(f"{num_fine_bins} fine bins exceed the splat's "
                         "shared memory")
    counts, lists, nbs = broad_phase(o, d, t_self, Lc, v, f, f_valid,
                                     ka_max=KA_MAX)
    soup = face_soup(v, f, f_valid, -(-f.shape[0] // GF))
    return kernel_call(o, d, t_self, self_fid, contrib_pre, bin_idx, soup,
                       counts, lists, nbs, Lc, num_fine_bins, t_rel, t_min)


def kernel_call(o, d, t_self, self_fid, contrib_pre, bin_idx, soup, counts,
                lists, nbs: int, Lc: int, num_fine_bins: int, t_rel, t_min):
    """Launch csrc/occluded_splat.cu on checked inputs, the broad phase's
    lists and the face soup -> (occluded [R] bool, hist [Lc, bins])."""
    R = o.shape[0]
    Bf = int(num_fine_bins)
    nbm = Lc * nbs
    occ = torch.empty(R, dtype=torch.uint8, device=o.device)
    hist = torch.empty((Lc, Bf), dtype=torch.float32, device=o.device)
    blk_bins = torch.empty(nbm * RB, dtype=torch.int32, device=o.device)
    blk_vals = torch.empty(nbm * RB, dtype=torch.float32, device=o.device)
    fn = _launcher()
    status = fn(
        *(_cuda.ptr(t) for t in (o, d, t_self, self_fid, contrib_pre,
                                 bin_idx, soup, counts, lists)),
        lists.shape[1], soup.shape[0] // GF, Lc, R // Lc, nbs, Bf,
        1.0 - t_rel, t_min, EPS_DET,
        *(_cuda.ptr(t) for t in (occ, hist, blk_bins, blk_vals)),
        _cuda.stream(o.device))
    _cuda.check(status, "occluded_splat")
    occluded_splat.launches += 1
    return occ.bool(), hist


occluded_splat.launches = 0


def _launcher():
    fn = _cuda.library("occluded_splat").occluded_splat_launch
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P] * 9 + [I] * 6 + [Fl] * 3 + [P] * 4 + [P]
    fn.restype = ctypes.c_int
    return fn
