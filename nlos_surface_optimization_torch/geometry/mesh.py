"""Mesh container and differential-geometry helpers.

The mesh is a NamedTuple of padded tensors on one device.  Padding faces
carry ``f_valid = False`` and are excluded from every reduction.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class Mesh(NamedTuple):
    """v [V,3] f32, f [F,3] int64, f_valid [F] bool, vn [V,3] f32 (zeros
    unless 'vn' shading), albedo [V] f32 (ones unless given); float64 where
    ``make_mesh`` is given that dtype (a GT mesh for compute_v2)."""

    v: torch.Tensor
    f: torch.Tensor
    f_valid: torch.Tensor
    vn: torch.Tensor
    albedo: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.v.device


def make_mesh(
    v: np.ndarray,
    f: np.ndarray,
    vn: Optional[np.ndarray] = None,
    albedo: Optional[np.ndarray] = None,
    pad_v: Optional[int] = None,
    pad_f: Optional[int] = None,
    device="cuda",
    dtype=np.float32,
) -> Mesh:
    v = np.asarray(v, dtype=dtype)
    f = np.asarray(f, dtype=np.int64)
    V, F = v.shape[0], f.shape[0]
    pv = V if pad_v is None else pad_v
    pf = F if pad_f is None else pad_f
    if pv < V or pf < F:
        raise ValueError(f"padding ({pv}, {pf}) below mesh size ({V}, {F})")
    vpad = np.zeros((pv, 3), dtype)
    vpad[:V] = v
    fpad = np.zeros((pf, 3), np.int64)
    fpad[:F] = f
    valid = np.zeros((pf,), bool)
    valid[:F] = True
    vnp = np.zeros((pv, 3), dtype)
    if vn is not None:
        vnp[:V] = vn
    alb = np.ones((pv,), dtype)
    if albedo is not None:
        alb[:V] = albedo

    def dev(x):
        return torch.from_numpy(x).to(device)

    return Mesh(v=dev(vpad), f=dev(fpad), f_valid=dev(valid), vn=dev(vnp),
                albedo=dev(alb))


def bucket_size(n: int, growth: float = 1.3, base: int = 256) -> int:
    """Smallest padded size >= n from a geometric bucket ladder."""
    size = base
    while size < n:
        size = int(np.ceil(size * growth))
    return size


def pad_mesh(v: np.ndarray, f: np.ndarray, **kw) -> Mesh:
    return make_mesh(
        v, f, pad_v=bucket_size(v.shape[0]), pad_f=bucket_size(f.shape[0]), **kw
    )


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root on every device.

    PyTorch's CPU sqrt is within 0.5 ulp but not always the nearest float;
    the square root taken in f64 and rounded to f32 is (f64 carries more
    than the 2*24+2 bits that make the double rounding exact)."""
    return torch.sqrt(x.double()).to(x.dtype)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in full float32 (TF32 off for the call)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def norm3(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over the last axis of length 3, summed x, y, z in
    order and correctly rounded (the rounding the JAX package's norm
    gives)."""
    n = sqrt_rn(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]
                + x[..., 2] * x[..., 2])
    return n[..., None] if keepdim else n


def face_normals_areas(v: torch.Tensor, f: torch.Tensor):
    """Unit face normals [F,3] and areas [F]; degenerate faces get area 0
    and a zero normal."""
    p1, p2, p3 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    n = torch.linalg.cross(p2 - p1, p3 - p1)
    double_area = norm3(n)
    area = double_area / 2.0
    n = n / torch.clamp(double_area, min=1e-30)[:, None]
    return n, area


def segment_sum(values: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """out[s] = sum of values[i] with ids[i] == s, summed in index order.

    Deterministic on every device (no atomics): entries are grouped by a
    stable sort, and ``torch.segment_reduce`` adds each segment's entries
    one after another.  Its cost does not grow with the largest segment
    (the padding faces of a bucketed mesh all sit on vertex 0)."""
    ids = ids.reshape(-1)
    order = torch.argsort(ids, stable=True)
    bounds = torch.searchsorted(ids[order], torch.arange(
        num_segments + 1, dtype=ids.dtype, device=ids.device))
    return torch.segment_reduce(values[order], "sum",
                                lengths=bounds[1:] - bounds[:-1], axis=0)


def scatter_faces(per_face: torch.Tensor, f: torch.Tensor,
                  num_vertices: int) -> torch.Tensor:
    """[F, 3 slots, 3] per-(face, slot) vectors -> [V, 3] per-vertex sums."""
    return segment_sum(per_face.reshape(-1, 3), f.reshape(-1), num_vertices)


def vertex_normals(v: torch.Tensor, f: torch.Tensor,
                   f_valid: torch.Tensor) -> torch.Tensor:
    """Area-weighted per-vertex normals, normalized to unit length."""
    n, area = face_normals_areas(v, f)
    w = torch.where(f_valid, area, 0.0)[:, None] * n
    acc = scatter_faces(w[:, None, :].expand(-1, 3, -1), f, v.shape[0])
    return acc / torch.clamp(norm3(acc, keepdim=True), min=1e-30)


def total_area(v: torch.Tensor, f: torch.Tensor,
               f_valid: torch.Tensor) -> torch.Tensor:
    _, area = face_normals_areas(v, f)
    return torch.where(f_valid, area, 0.0).sum()
