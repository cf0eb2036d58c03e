"""Non-confocal angular-sampling transient renderer (differentiable).

The JAX package's render/nonconfocal.py in PyTorch: separate light and
sensor positions, uniform hemisphere directions from the light, the
nearest hit, an explicit shadow ray from the sensor to the hit point,
binning by the total path length d1 + d2 with intensity cos(theta2)/d2^2,
and the 2*pi/N solid-angle estimator.

Differentiable with respect to the mesh vertices through autograd: the
nearest face is found without gradient (geometry/intersect.nearest_hit),
then (t, u, w) are solved again on that face with Möller–Trumbore algebra
so that the gradient flows through the hit point.

The shadow rays go through the visibility kernel K3
(render/occl_kernels.segment_occluded: the CUDA kernel on the card, its
plain version on the CPU).  A direction that hits nothing is solved on
face 0, where its t is arbitrary: the renderer puts its point at the
light (every masked value and its gradient stay finite) and gives its
shadow ray t_self = 0, K3's dead ray, which is never occluded and bounds
no ray block.  Its contribution is zero either way.

Numerics shared with the JAX package op by op: the threefry draws are
``sampling.split`` / ``uniform`` / ``fold_in``; every root is correctly
rounded (``sqrt_rn``); sin and cos are taken in float64 and rounded, the
same on every device (XLA's float32 sin and cos differ from them by an ulp
in a few per cent of values); the rotation is written out as sums; the
bin index divides by the resolution as a true division (core._div); the
histogram is a deterministic segment sum, without float atomics, so two
calls give the same bits.  Pairs are rendered in batches, each pair's
directions drawn from ``fold_in(key, i)`` with its global index i, so the
result does not depend on the batch size.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..config import RenderConfig
from ..geometry import sampling
from ..geometry.accel import cross3
from ..geometry.intersect import nearest_hit
from ..geometry.mesh import Mesh, norm3, segment_sum, sqrt_rn
from .core import _div, _dot
from .occl_kernels import segment_occluded

# pairs a batch: 64 x 20,000 directions is 1.28 M rays
_PAIRS_PER_BATCH = 64


def _rotation(normal: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotations taking +z to each unit-scaled normal [..., 3]
    (the rotation_matrix.py R_2vect role), as the JAX package builds
    them."""
    n_ = normal / norm3(normal, keepdim=True)
    z = torch.zeros_like(n_)
    z[..., 2] = 1.0
    v = cross3(z, n_)
    c = _dot(z, n_)
    s = norm3(v)
    vx_, vy_, vz_ = v.unbind(-1)
    zero = torch.zeros_like(c)
    vx = torch.stack([torch.stack([zero, -vz_, vy_], -1),
                      torch.stack([vz_, zero, -vx_], -1),
                      torch.stack([-vy_, vx_, zero], -1)], -2)
    vx2 = sum(vx[..., :, k, None] * vx[..., None, k, :] for k in range(3))
    eye = torch.eye(3, dtype=normal.dtype, device=normal.device)
    scale = (1.0 - c) / torch.clamp(s * s, min=1e-30)
    general = eye + vx + vx2 * scale[..., None, None]
    flat = torch.where(c[..., None, None] > 0, eye, -eye)
    return torch.where(s[..., None, None] < 1e-12, flat, general)


def hemisphere_directions(key: torch.Tensor, n: int,
                          normal: torch.Tensor) -> torch.Tensor:
    """n directions uniform over the hemisphere around ``normal``
    (phi ~ U(0, 2 pi), cos theta ~ U(0, 1)): [..., n, 3] float32 for keys
    [..., 2] and normals [..., 3] on the key's device."""
    k = sampling.split(key)                           # [..., 2, 2]
    phi = sampling.uniform(k[..., 0, :], (n,)) * 2.0 * math.pi
    cos_t = sampling.uniform(k[..., 1, :], (n,))
    sin_t = sqrt_rn(1.0 - cos_t * cos_t)
    phi64 = phi.double()
    local = torch.stack([sin_t * torch.cos(phi64).float(),
                         sin_t * torch.sin(phi64).float(), cos_t], dim=-1)
    R = _rotation(normal.to(local.dtype))[..., None, :, :]  # [..., 1, 3, 3]
    # local @ R.T, each component summed x, y, z in order
    return ((local[..., 0, None] * R[..., :, 0]
             + local[..., 1, None] * R[..., :, 1])
            + local[..., 2, None] * R[..., :, 2])


class _GatherRows(torch.autograd.Function):
    """v[idx] whose gradient is summed into v by ``segment_sum``: the same
    bits on every call (advanced indexing's backward on CUDA adds with
    float atomics)."""

    @staticmethod
    def forward(ctx, v, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = v.shape[0]
        return v[idx]

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        return segment_sum(grad.reshape(-1, grad.shape[-1]),
                           idx.reshape(-1), ctx.num_rows), None


def _solve_hit(v, f, fid, o, d):
    """Differentiable (t, u, w, p1, e1, e2) on each ray's selected face
    (face 0 for a miss)."""
    tri = _GatherRows.apply(v, f[torch.clamp(fid, min=0).long()])  # [R,3,3]
    p1 = tri[:, 0]
    e1 = tri[:, 1] - p1
    e2 = tri[:, 2] - p1
    pvec = cross3(d, e2)
    det = _dot(e1, pvec)
    inv = 1.0 / torch.where(torch.abs(det) > 1e-14, det, 1.0)
    tvec = o - p1
    u = _dot(tvec, pvec) * inv
    qvec = cross3(tvec, e1)
    w = _dot(d, qvec) * inv
    t = _dot(e2, qvec) * inv
    return t, u, w, p1, e1, e2


def _pair_transients(mesh: Mesh, directions, lighting, sensors,
                     cfg: RenderConfig, hier=None) -> torch.Tensor:
    """Transients [P, B] of P (light, sensor) pairs over their directions
    [P, N, 3]; lighting, sensors [P, 3]."""
    P, N = directions.shape[:2]
    B = cfg.num_bins
    d = directions.reshape(-1, 3)
    o = lighting[:, None, :].expand(P, N, 3).reshape(-1, 3)
    sensor = sensors[:, None, :].expand(P, N, 3).reshape(-1, 3)
    with torch.no_grad():
        fid = nearest_hit(o, d, mesh.v.detach(), mesh.f, mesh.f_valid)[0]
    hit = fid >= 0
    t, _, _, p1, e1, e2 = _solve_hit(mesh.v, mesh.f, fid, o, d)
    # a miss's t (solved on face 0) is arbitrary: put its point at the
    # light, so that every masked value below, and its gradient, is finite
    t = torch.where(hit, t, 0.0)
    d1 = torch.abs(t)
    p = o + d * t[:, None]
    v2 = sensor - p
    d2 = norm3(v2)
    d2s = torch.clamp(d2, min=1e-12)
    v2u = v2 / d2s[:, None]

    # shadow ray sensor -> p: unobstructed except by the hit face; a miss
    # is a dead ray
    occ = segment_occluded(
        sensor.contiguous(), (-v2u).detach(),
        torch.where(hit, d2s, 0.0).detach(),
        fid.contiguous(), mesh.v.detach(), mesh.f, mesh.f_valid,
        t_rel=cfg.occl_t_rel, t_min=cfg.occl_t_min, hier=hier)

    fn = cross3(e1, e2)
    fn = fn / torch.clamp(norm3(fn, keepdim=True), min=1e-30)
    cos2 = torch.clamp(_dot(fn, v2u), min=0.0)

    bins = torch.ceil(_div(d1 + d2, cfg.distance_resolution)).to(
        torch.int32) - 1
    ok = hit & ~occ & (bins >= 0) & (bins < B)
    intensity = torch.where(ok, cos2 / (d2s * d2s), 0.0)
    bins = torch.clamp(bins, 0, B - 1).long()
    pair = torch.arange(P, device=d.device).repeat_interleave(N)
    out = segment_sum(intensity, pair * B + bins, P * B).reshape(P, B)
    return out * (2.0 * math.pi / N)


def angular_transient(mesh: Mesh, directions, lighting, sensor,
                      sensor_normal, cfg: RenderConfig) -> torch.Tensor:
    """Transient [B] of one (light, sensor) pair over the directions
    [N, 3] (rendering_grad.py:16-126 semantics); ``sensor_normal`` is
    unused, as in the JAX package."""
    directions, lighting, sensor = (_as(x, mesh)
                                    for x in (directions, lighting, sensor))
    return _pair_transients(mesh, directions[None], lighting[None],
                            sensor[None], cfg, _hierarchy(mesh))[0]


def _hierarchy(mesh: Mesh):
    """K3's view of the mesh, once per render; None on the CPU, where K3
    runs its plain version."""
    if mesh.device.type != "cuda":
        return None
    from .fused_kernels import face_hierarchy

    return face_hierarchy(mesh.v.detach(), mesh.f, mesh.f_valid)


def _as(x, mesh: Mesh) -> torch.Tensor:
    return torch.as_tensor(x, dtype=mesh.v.dtype).to(mesh.device)


def render_nonconfocal(mesh: Mesh, lighting, sensors, lighting_normal,
                       sensor_normal, cfg: RenderConfig, key,
                       num_dirs: Optional[int] = None) -> torch.Tensor:
    """Transients [L, B] of L (light, sensor) pairs, on the mesh's device
    (``make_mesh`` puts it on CUDA unless told otherwise).  Pair i draws
    ``num_dirs`` (default cfg.num_samples) directions from
    ``fold_in(key, i)``; _PAIRS_PER_BATCH pairs share one nearest-hit
    query and one K3 launch."""
    n = num_dirs or cfg.num_samples
    lighting, sensors, lighting_normal = (
        _as(x, mesh) for x in (lighting, sensors, lighting_normal))
    L = lighting.shape[0]
    keys = sampling.fold_in(key.to(mesh.device),
                            torch.arange(L, device=mesh.device))
    hier = _hierarchy(mesh)
    rows = []
    for s in range(0, L, _PAIRS_PER_BATCH):
        b = slice(s, min(s + _PAIRS_PER_BATCH, L))
        dirs = hemisphere_directions(keys[b], n, lighting_normal[b])
        rows.append(_pair_transients(mesh, dirs.to(mesh.v.dtype),
                                     lighting[b], sensors[b], cfg, hier))
    return torch.cat(rows, dim=0)
