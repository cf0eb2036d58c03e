"""Segment occlusion for any set of rays (kernel K3).

``segment_occluded`` replaces the JAX package's Pallas kernel
(render/pallas_kernels.py ``_occl_kernel`` / ``segment_occluded_pallas``).
For rays o, d with sample distance t_self it returns

  occ[r]  another valid face crosses o -> o + d*t at t in
          (t_min, t_self*(1-t_rel)), by sign-safe Möller–Trumbore with the
          ray's own face excluded

-- K1's occlusion without the splat, for rays in any order and any number
of faces.  On a CUDA tensor it runs csrc/segment_occluded.cu, one launch
per call: one 128-ray block per CUDA block, bounded by ``block_boxes``,
with K1's hierarchical broad phase and narrow phase in the kernel.  On a
CPU tensor it runs ``occluded_plain`` (render/fused_kernels.py), which
tests every face; ``broad_phase`` is the plain version of the kernel's
candidate lists.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _cuda
from .fused_kernels import (
    EPS_DET,
    LIST_CAP,
    FaceHierarchy,
    _check,
    check_hierarchy,
    face_hierarchy,
    hier_candidates,
    occluded_plain,
)

RB = 128                # rays per block


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


def broad_phase(o, d, t_self, hier: FaceHierarchy):
    """Plain version of K3's candidate lists: (counts [nb] int32, lists) as
    ``hier_candidates`` gives them for ``block_boxes``."""
    return hier_candidates(*block_boxes(o, d, t_self), hier)


def segment_occluded(o, d, t_self, self_fid, v, f, f_valid, t_rel=1e-4,
                     t_min=1e-6, hier: FaceHierarchy | None = None):
    """[R] bool occlusion of the segments o -> o + d*t_self.

    o, d [R,3] f32; t_self [R] f32 (0 = dead ray, never occluded);
    self_fid [R] int32; v [V,3] f32, f [F,3] int64, f_valid [F] bool;
    hier: ``face_hierarchy(v, f, f_valid)``, built here when not given."""
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
    if R == 0 or F == 0:
        return torch.zeros(R, dtype=torch.bool, device=o.device)
    if hier is None:
        hier = face_hierarchy(v, f, f_valid)
    check_hierarchy(hier, F, o.device)
    return kernel_call(o, d, t_self, self_fid, hier, t_rel, t_min)[0]


def kernel_call(o, d, t_self, self_fid, hier: FaceHierarchy, t_rel, t_min,
                cap: int = LIST_CAP):
    """Launch csrc/segment_occluded.cu once on checked, contiguous inputs
    -> (occluded [R] bool, counts [nb] int32: groups listed per block,
    summed over passes)."""
    R = o.shape[0]
    occ = torch.empty(R, dtype=torch.uint8, device=o.device)
    counts = torch.empty(-(-R // RB), dtype=torch.int32, device=o.device)
    fn = _launcher()
    status = fn(
        *(_cuda.ptr(t) for t in (o, d, t_self, self_fid, hier.soup,
                                 hier.group_boxes, hier.super_boxes)),
        hier.super_boxes.shape[0], cap, R, 1.0 - t_rel, t_min, EPS_DET,
        _cuda.ptr(occ), _cuda.ptr(counts), _cuda.stream(o.device))
    _cuda.check(status, "segment_occluded")
    segment_occluded.launches += 1
    return occ.bool(), counts


segment_occluded.launches = 0


def _launcher():
    fn = _cuda.library("segment_occluded").segment_occluded_launch
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P] * 7 + [I] * 3 + [Fl] * 3 + [P] * 3
    fn.restype = ctypes.c_int
    return fn
