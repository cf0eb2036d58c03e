"""Segment occlusion for any set of rays (kernel K3).

``segment_occluded`` replaces the JAX package's Pallas kernel
(render/pallas_kernels.py ``_occl_kernel`` / ``segment_occluded_pallas``).
For rays o, d with sample distance t_self it returns

  occ[r]  another valid face crosses o -> o + d*t at t in
          (t_min, t_self*(1-t_rel)), by sign-safe Möller–Trumbore with the
          ray's own face excluded

-- K1's occlusion without the splat, for rays in any order and any number
of faces.  On a CUDA tensor it runs csrc/segment_occluded.cu: one 128-ray
block per CUDA block, tested against the 8-face groups of that block's
candidate list.  The broad phase here (torch ops) bounds each block's rays
by a swept box and slab-tests it against the groups' boxes; rays are taken
in groups so the [blocks, groups] candidate matrix stays near GROUP_PAIRS
entries, one kernel launch per group.  On a CPU tensor it runs
``occluded_plain`` (render/fused_kernels.py), which tests every face.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _cuda
from .fused_kernels import (
    EPS_DET,
    GF,
    _check,
    _group_boxes,
    _slab_candidates,
    face_soup,
    occluded_plain,
)

RB = 128                # rays per block
KA_MAX = 256            # candidate-list slots per block; more means a full scan
GROUP_PAIRS = 1 << 24   # block x face-group pairs per broad-phase group
MAX_GROUP_BLOCKS = 1 << 16  # keeps a group's [blocks, KA_MAX] lists at 64 MB


def ray_groups(num_rays: int, num_groups: int):
    """[(r0, r1)] ray ranges, whole blocks each, with about GROUP_PAIRS
    block x face-group pairs per range."""
    nb = -(-num_rays // RB)
    per = max(1, min(GROUP_PAIRS // max(num_groups, 1), MAX_GROUP_BLOCKS))
    return [(b0 * RB, min((b0 + per) * RB, num_rays))
            for b0 in range(0, nb, per)]


def block_boxes(o, d, t_self):
    """Per 128-ray block (the last one ragged): (a [nb,3], b [nb,3],
    half [nb,3], live [nb]).  Every live ray's segment o -> o + d*t_self
    lies in segment(a -> b) widened by the box of half-extents ``half``:
    a and b are the centres of the live rays' origin and endpoint boxes,
    half the larger of their half-extents.  Dead rays (t_self == 0) are
    never occluded and widen nothing; a block without a live ray has
    live False."""
    R = o.shape[0]
    nb = -(-R // RB)
    pad = nb * RB - R
    live = torch.nn.functional.pad(t_self > 0.0, (0, pad)).reshape(nb, RB, 1)

    def box(x):
        x = torch.nn.functional.pad(x, (0, 0, 0, pad)).reshape(nb, RB, 3)
        lo = torch.where(live, x, float("inf")).amin(dim=1)
        hi = torch.where(live, x, float("-inf")).amax(dim=1)
        return lo, hi

    olo, ohi = box(o)
    plo, phi = box(o + d * t_self[:, None])
    any_live = live.any(dim=1)                                # [nb, 1]
    zero = torch.zeros_like(olo)
    olo, ohi, plo, phi = (torch.where(any_live, x, zero)
                          for x in (olo, ohi, plo, phi))
    half = torch.maximum(0.5 * (ohi - olo), 0.5 * (phi - plo))
    return 0.5 * (olo + ohi), 0.5 * (plo + phi), half, any_live[:, 0]


def broad_phase(o, d, t_self, boxes, ka_max: int = KA_MAX):
    """(counts [nb] int32, lists [nb, ka_max] int32) for 128-ray blocks of
    the given rays against face-group boxes [ng, 6] (``_group_boxes``).
    Lists hold candidate group ids in increasing order, padded with ng; a
    count above ka_max means: scan every group."""
    a, b, half, live = block_boxes(o, d, t_self)
    counts, lists = _slab_candidates(a, b, half, boxes, ka_max)
    counts = torch.where(live, counts, 0)
    lists = torch.where(live[:, None], lists, boxes.shape[0])
    return counts, lists.contiguous()


def segment_occluded(o, d, t_self, self_fid, v, f, f_valid, t_rel=1e-4,
                     t_min=1e-6):
    """[R] bool occlusion of the segments o -> o + d*t_self.

    o, d [R,3] f32; t_self [R] f32 (0 = dead ray, never occluded);
    self_fid [R] int32; v [V,3] f32, f [F,3] int64, f_valid [F] bool."""
    if o.device.type == "cpu":
        return occluded_plain(o, d, t_self, self_fid, v, f, f_valid, t_rel,
                              t_min)
    if o.device.type != "cuda":
        raise ValueError(f"segment_occluded: unsupported device {o.device}")
    R, F = o.shape[0], f.shape[0]
    for name, t, dt, shape in (
            ("o", o, torch.float32, (R, 3)), ("d", d, torch.float32, (R, 3)),
            ("t_self", t_self, torch.float32, (R,)),
            ("self_fid", self_fid, torch.int32, (R,)),
            ("v", v, torch.float32, v.shape), ("f", f, torch.int64, f.shape),
            ("f_valid", f_valid, torch.bool, (F,))):
        _check(name, t, dt, shape)
        if t.device != o.device:
            raise ValueError(f"{name} is on {t.device}, rays on {o.device}")
    occ = torch.zeros(R, dtype=torch.uint8, device=o.device)
    if R == 0 or F == 0:
        return occ.bool()
    ng = -(-F // GF)
    boxes = _group_boxes(v, f, f_valid, ng, GF)
    soup = face_soup(v, f, f_valid, ng)
    for r0, r1 in ray_groups(R, ng):
        counts, lists = broad_phase(o[r0:r1], d[r0:r1], t_self[r0:r1], boxes,
                                    ka_max=KA_MAX)
        kernel_call(o[r0:r1], d[r0:r1], t_self[r0:r1], self_fid[r0:r1], soup,
                    counts, lists, t_rel, t_min, occ[r0:r1])
    return occ.bool()


def kernel_call(o, d, t_self, self_fid, soup, counts, lists, t_rel, t_min,
                out):
    """Launch csrc/segment_occluded.cu on checked, contiguous inputs, the
    broad phase's lists and the face soup; writes the mask into the uint8
    tensor ``out`` [R]."""
    fn = _launcher()
    status = fn(
        *(_cuda.ptr(t) for t in (o, d, t_self, self_fid, soup, counts,
                                 lists)),
        lists.shape[1], soup.shape[0] // GF, o.shape[0], 1.0 - t_rel, t_min,
        EPS_DET, _cuda.ptr(out), _cuda.stream(o.device))
    _cuda.check(status, "segment_occluded")
    segment_occluded.launches += 1
    return out


segment_occluded.launches = 0


def _launcher():
    fn = _cuda.library("segment_occluded").segment_occluded_launch
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P] * 7 + [I] * 3 + [Fl] * 3 + [P, P]
    fn.restype = ctypes.c_int
    return fn
