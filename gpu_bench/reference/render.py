"""The confocal renderer, its vertex gradient and the culling intensity,
in plain PyTorch at the precision of the tensors it is given.

A ray is (source l, face j, slot s) with s < spt: its sample point is
p = b1*v1 + b2*v2 + b3*v3, b = (1 - sqrt(T), (1 - S) sqrt(T), S sqrt(T))
from the uniforms (S, T) of the sampler at key index ``keyidx[l]``.  It
counts where another face blocks o -> p before p, by Moller-Trumbore in
the reference's precision (``Occluder``).  Each function computes only
the answers it is asked for: rows of the transient, the gradient of
chosen vertices, the intensity of chosen faces.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import sampler
from .geometry import cross, dot, normals_areas, vertex_normals

GROUP = 32          # faces a broad-phase group holds
BOX_MARGIN = 1e-5   # widening of a group box, metres (f32 broad phase)
RAY_BATCH = 1 << 19


@dataclasses.dataclass(frozen=True)
class Optics:
    """The renderer's settings: bins, the Gaussian of the backward, the
    shading normal, the gn term, the BRDF and the occlusion margins."""

    num_bins: int
    res: float
    lo: float
    refine: int
    sigma_bin: int
    normal: str = "fn"
    gn: bool = False
    brdf: str = "lambertian"
    alpha: float = float(np.float32(0.1))
    t_rel: float = 1e-4
    t_min: float = 1e-6

    @property
    def hi(self) -> float:
        return self.lo + self.num_bins * self.res

    @property
    def sigma(self) -> float:
        return self.res * self.sigma_bin / 2.355


def spt_for(num_samples: int, num_faces: int) -> int:
    return 1 + (num_samples - 1) // max(num_faces, 1)


class Scene:
    """A mesh (valid faces only), the scan and the key, as tensors of one
    dtype on one device, with what the reference derives from them."""

    def __init__(self, v, f, lighting, lnormal, key_words, dtype, device):
        self.dtype, self.device = dtype, torch.device(device)
        self.v = torch.as_tensor(np.asarray(v, np.float64)).to(device, dtype)
        self.f = torch.as_tensor(np.asarray(f, np.int64)).to(device)
        self.lighting = torch.as_tensor(
            np.asarray(lighting, np.float64)).to(device, dtype)
        self.lnormal = torch.as_tensor(
            np.asarray(lnormal, np.float64)).to(device, dtype)
        self.key = torch.as_tensor(np.asarray(key_words, np.int64))
        self.fn, self.area = normals_areas(self.v, self.f)
        self.vn = vertex_normals(self.v, self.f)
        self.occluder = Occluder(self.v, self.f)


def _ggx_parts(alpha, c):
    """(value, d value / dc) of the confocal GGX BRDF at c = n . w."""
    pi = math.pi
    a2 = alpha * alpha
    c2 = c * c
    pos = c > 0
    beck = (1.0 - c2) / torch.clamp(a2 * c2, min=1e-30)
    root = (1.0 + beck) * c2
    D = 1.0 / torch.clamp(pi * a2 * root * root, min=1e-30)
    D = torch.where(pos & (D * c >= 1e-20), D, 0.0)
    s = torch.sqrt(torch.clamp(a2 + (1.0 - a2) * c2, min=0.0))
    edge = (c >= 1.0) | (c <= -1.0)
    G1 = torch.where(edge, 1.0, 2.0 / torch.clamp(c + s, min=1e-30))
    G1 = torch.where(pos, G1, 0.0)
    ok = pos & (D > 0)
    value = torch.where(ok, D * G1 * G1 / 4.0, 0.0)
    r3 = (a2 - 1.0) * c2 + 1.0
    dD = -(4.0 * a2 * c * (a2 - 1.0)) / torch.clamp(pi * r3 * r3 * r3,
                                                  min=1e-30)
    t = torch.sqrt(torch.clamp(a2 - c2 * (a2 - 1.0), min=1e-30))
    dG = -2.0 * (1.0 - (c * (a2 - 1.0)) / t) / torch.clamp((c + t) ** 2,
                                                           min=1e-30)
    dG = torch.where(edge | ~pos, 0.0, dG)
    dvalue = torch.where(ok, (torch.where(pos, dD, 0.0) * G1 * G1
                              + 2.0 * dG * G1 * D) / 4.0, 0.0)
    return value, dvalue


class Rays:
    """The rays (source rows ``src``, key indices ``keyidx``, faces, slots)
    of a scene, with what every consumer reads."""

    def __init__(self, sc: Scene, opt: Optics, src, keyidx, face, slot,
                 spt: int):
        self.src, self.face, self.slot = src, face, slot
        S, T = sampler.uniforms(sc.key, keyidx, face, slot, spt)
        S, T = S.to(sc.dtype), T.to(sc.dtype)
        sq = torch.sqrt(T)
        self.bary = torch.stack([1.0 - sq, (1.0 - S) * sq, S * sq], -1)
        tri = sc.v[sc.f[face]]                                  # [N, 3, 3]
        p = (self.bary[:, :, None] * tri).sum(1)
        o = sc.lighting[src]
        D = p - o
        self.h = torch.sqrt(dot(D, D))
        self.d = D / torch.clamp(self.h, min=1e-12)[:, None]
        self.o, self.D, self.tri = o, D, tri
        self.area = sc.area[face]
        self.fn = sc.fn[face]
        if opt.normal == "vn":
            self.n = (self.bary[:, :, None] * sc.vn[sc.f[face]]).sum(1)
        else:
            self.n = self.fn
        self.ln = sc.lnormal[src]
        self.cos2 = dot(self.ln, self.d)
        self.cos3 = -dot(self.n, self.d)
        self.cos3f = -dot(self.fn, self.d)
        pre = ((self.h >= opt.lo / 2) & (self.h <= opt.hi / 2)
               & (self.area > 0))
        live = ((self.cos2 * self.cos3 > 0) | (self.cos2 * self.cos3f > 0)
                | ((self.cos2 > 0) & (self.cos3 > 0)))
        self.valid = pre & live
        need = torch.nonzero(self.valid).squeeze(1)
        if need.numel():
            occ = sc.occluder.blocked(o[need], D[need], face[need], opt)
            self.valid[need[occ]] = False


class Occluder:
    """Which faces block a segment o -> o + D*s, s in (t_min/|D|, 1 - t_rel),
    other than the ray's own: faces sorted by the Morton code of their
    centroids into groups of GROUP, a float32 slab test of the segments
    against the groups' boxes (widened by BOX_MARGIN), then
    sign-folded Moller-Trumbore against the listed groups' faces in the
    mesh's precision."""

    def __init__(self, v: torch.Tensor, f: torch.Tensor):
        F = f.shape[0]
        cent = v[f].mean(1).double().cpu().numpy()
        lo = cent.min(0)
        span = np.maximum(cent.max(0) - lo, 1e-12)
        q = np.clip(((cent - lo) / span * 1023).astype(np.int64), 0, 1023)
        code = np.zeros(F, np.int64)
        for b in range(10):
            for a in range(3):
                code |= ((q[:, a] >> b) & 1) << (3 * b + a)
        order = torch.as_tensor(np.argsort(code, kind="stable")).to(f.device)
        G = -(-F // GROUP)
        members = torch.full((G * GROUP,), -1, dtype=torch.int64,
                             device=f.device)
        members[:F] = order
        self.members = members.reshape(G, GROUP)
        tri = v[f[order]].float()                              # [F, 3, 3]
        tri = torch.nn.functional.pad(tri, (0, 0, 0, 0, 0, G * GROUP - F),
                                      value=float("nan"))
        tri = tri.reshape(G, GROUP, 3, 3)
        self.box_lo = (torch.nan_to_num(tri, nan=1e30).amin((1, 2))
                       - BOX_MARGIN)
        self.box_hi = (torch.nan_to_num(tri, nan=-1e30).amax((1, 2))
                       + BOX_MARGIN)
        p1 = v[f[:, 0]]
        self.p1, self.e1, self.e2 = p1, v[f[:, 1]] - p1, v[f[:, 2]] - p1

    def _pairs(self, o, D, smax):
        """(ray, group) pairs whose segment crosses the group's box."""
        o32, D32 = o.float(), D.float()
        D32 = torch.where(D32.abs() < 1e-20,
                          torch.where(D32 < 0, -1e-20, 1e-20), D32)
        inv = 1.0 / D32
        tn = torch.zeros((o.shape[0], self.box_lo.shape[0]),
                         device=o.device)
        tf = torch.full_like(tn, smax)
        for a in range(3):
            t0 = (self.box_lo[None, :, a] - o32[:, a:a + 1]) * inv[:, a:a + 1]
            t1 = (self.box_hi[None, :, a] - o32[:, a:a + 1]) * inv[:, a:a + 1]
            tn = torch.maximum(tn, torch.minimum(t0, t1))
            tf = torch.minimum(tf, torch.maximum(t0, t1))
        return torch.nonzero(tn <= tf, as_tuple=True)

    def blocked(self, o, D, own, opt: Optics) -> torch.Tensor:
        """[N] bool: the segment of each ray is blocked."""
        N = o.shape[0]
        smax = 1.0 - opt.t_rel
        out = torch.zeros(N, dtype=torch.int32, device=o.device)
        tile = max(256, min(1 << 16, (1 << 24) // self.box_lo.shape[0]))
        for r0 in range(0, N, tile):
            ri, gi = self._pairs(o[r0:r0 + tile], D[r0:r0 + tile], smax)
            ri = ri + r0
            for p0 in range(0, ri.numel(), 1 << 16):
                r = ri[p0:p0 + (1 << 16)]
                fj = self.members[gi[p0:p0 + (1 << 16)]]       # [P, GROUP]
                ok = (fj >= 0) & (fj != own[r][:, None])
                fc = fj.clamp(min=0)
                hit = self._mt(o[r][:, None], D[r][:, None], fc, opt, smax)
                out.index_add_(0, r, (hit & ok).any(1).to(torch.int32))
        return out > 0

    def _mt(self, o, D, fc, opt, smax):
        p1, e1, e2 = self.p1[fc], self.e1[fc], self.e2[fc]
        pv = cross(D, e2)
        det = dot(e1, pv)
        tv = o - p1
        u = dot(tv, pv)
        qv = cross(tv, e1)
        w = dot(D, qv)
        t = dot(e2, qv)
        s = torch.where(det >= 0, 1.0, -1.0).to(det.dtype)
        dd, u, w, t = det * s, u * s, w * s, t * s
        h = torch.sqrt(dot(D, D))
        return ((dd > 1e-12 * h) & (u >= 0) & (w >= 0) & (u + w <= dd)
                & (t > (opt.t_min / h) * dd) & (t < smax * dd))


def _contrib(r: Rays, opt: Optics, spt: int):
    """Forward contribution of each ray (0 where not valid)."""
    ff = torch.clamp(r.cos3 * r.cos2, min=0.0) / (r.h * r.h)
    c = r.area * ff * ff / spt
    if opt.brdf == "ggx":
        c = c * _ggx_parts(torch.as_tensor(opt.alpha, dtype=r.h.dtype,
                                           device=r.h.device), r.cos3)[0]
    return torch.where(r.valid, c, 0.0)


def transient_rows(sc: Scene, opt: Optics, rows, keyidx, spt: int,
                   refine: int = 1) -> torch.Tensor:
    """Rows [R, num_bins] of the raw transient (the forward at refine 1)
    of the sources ``rows``, whose key indices are ``keyidx``."""
    if refine != 1:
        raise ValueError("the reference renders the raw transient (refine 1)")
    dev = sc.device
    F = sc.f.shape[0]
    rows = torch.as_tensor(rows, dtype=torch.int64, device=dev)
    keyidx = torch.as_tensor(keyidx, dtype=torch.int64, device=dev)
    per_row = F * spt
    out = torch.zeros((rows.numel(), opt.num_bins), dtype=sc.dtype,
                      device=dev)
    step = max(1, RAY_BATCH // per_row)
    j = torch.arange(per_row, device=dev)
    for r0 in range(0, rows.numel(), step):
        n = min(step, rows.numel() - r0)
        loc = torch.arange(r0, r0 + n, device=dev).repeat_interleave(per_row)
        ray = Rays(sc, opt, rows[loc], keyidx[loc], j.repeat(n) // spt,
                   j.repeat(n) % spt, spt)
        b = torch.floor((2.0 * ray.h - opt.lo) / opt.res).to(torch.int64)
        ok = (b >= 0) & (b < opt.num_bins)
        c = torch.where(ok, _contrib(ray, opt, spt), 0.0)
        flat = loc * opt.num_bins + b.clamp(0, opt.num_bins - 1)
        out.view(-1).index_add_(0, flat, c)
    return out


def _taps(opt: Optics, dtype, device):
    K = 4 * opt.refine * opt.sigma_bin + 1
    delta = (-2.0 * opt.refine * opt.sigma_bin
             + np.arange(K)) * opt.res / opt.refine
    w = (np.exp(-((delta / opt.sigma) ** 2) / 2.0) / opt.sigma
         / np.sqrt(2.0 * np.pi) * opt.res / opt.refine)
    return (torch.as_tensor(w).to(device, dtype),
            torch.as_tensor(delta).to(device, dtype))


def _ray_gradient(r: Rays, opt: Optics, diff, spt: int):
    """Per ray (P [N, 3], S2 [N, 3]): the gradient of a slot k is
    P*b_k + cross(S2, e_k), e_k the edge opposite the slot."""
    h = r.h
    c2 = torch.clamp(r.cos2, min=0.0)
    c3 = torch.clamp(r.cos3, min=0.0)
    ff = c2 * c3 / (h * h)
    ff2 = ff * ff
    t1 = (2.0 * (c2 * c3)[:, None]
          * (r.ln * c3[:, None] - r.n * c2[:, None]
             + 4.0 * (-r.d) * (c2 * c3)[:, None]) / (h ** 5)[:, None])
    gn = -2.0 * r.d * (c3 * c2 * c2)[:, None] / (h ** 4)[:, None]
    if opt.brdf == "ggx":
        bval, dscale = _ggx_parts(torch.as_tensor(opt.alpha, dtype=h.dtype,
                                                  device=h.device), r.cos3)
        dw = dscale[:, None] * r.n
        dx = (-dw + r.d * dot(r.d, dw)[:, None]) / h[:, None]
        inten = ff2 * bval
        t1 = t1 * bval[:, None] + ff2[:, None] * dx
        gn = gn * bval[:, None] + ff2[:, None] * (dscale[:, None] * (-r.d))
    else:
        inten = ff2
    t2 = r.n * inten[:, None]
    if opt.gn:
        t2 = t2 + gn - r.n * dot(gn, r.n)[:, None]
    t2 = t2 / (2.0 * torch.clamp(r.area, min=1e-30))[:, None]
    kw, kd = _taps(opt, h.dtype, h.device)
    A = torch.zeros_like(h)
    Bw = torch.zeros_like(h)
    for i in range(kw.numel()):
        b = torch.floor((2.0 * h + kd[i] - opt.lo) / opt.res).to(torch.int64)
        ok = (b >= 0) & (b < opt.num_bins)
        dv = torch.where(ok, diff[r.src, b.clamp(0, opt.num_bins - 1)], 0.0)
        A = A + kw[i] * dv
        Bw = Bw + kw[i] * kd[i] * dv
    wgt = torch.where(r.valid, r.area * (-2.0 / spt), 0.0)
    P = (t1 * A[:, None] + r.d * ((2.0 / opt.sigma ** 2) * inten
                                  * Bw)[:, None]) * wgt[:, None]
    return P, t2 * (A * wgt)[:, None]


def vertex_gradient(sc: Scene, opt: Optics, verts, diff, spt: int
                    ) -> torch.Tensor:
    """[len(verts), 3]: the vertex gradient of sum w*(data - T)^2 over all
    sources, divided by their count, at the chosen (distinct) vertices;
    diff [L, B] is weight * (data - T)."""
    dev = sc.device
    verts = torch.as_tensor(verts, dtype=torch.int64, device=dev)
    fj, slot, which = torch.nonzero(
        sc.f[:, :, None] == verts[None, None, :], as_tuple=True)
    L = sc.lighting.shape[0]
    diff = diff.to(dev, sc.dtype)
    out = torch.zeros((verts.numel(), 3), dtype=sc.dtype, device=dev)
    per = fj.numel() * spt
    if per == 0:
        return out
    step = max(1, RAY_BATCH // per)
    k = torch.arange(per, device=dev)
    for l0 in range(0, L, step):
        n = min(step, L - l0)
        src = torch.arange(l0, l0 + n, device=dev).repeat_interleave(per)
        pair = k.repeat(n) // spt
        r = Rays(sc, opt, src, src, fj[pair], k.repeat(n) % spt, spt)
        P, S2 = _ray_gradient(r, opt, diff, spt)
        sl = slot[pair]
        tri = r.tri
        e = torch.stack([tri[:, 2] - tri[:, 1], tri[:, 0] - tri[:, 2],
                         tri[:, 1] - tri[:, 0]], 1)            # [N, 3, 3]
        ek = e[torch.arange(e.shape[0], device=dev), sl]
        bk = r.bary.gather(1, sl[:, None])
        out.index_add_(0, which[pair], P * bk + cross(S2, ek))
    return out / L


def face_intensity(sc: Scene, opt: Optics, faces, spt: int) -> torch.Tensor:
    """[len(faces)]: each face's culling intensity, sum over sources and
    samples of area*(max(0, cos2*cos3)/h^2)^2/spt with face normals, unit
    albedo, over its visible in-range samples."""
    dev = sc.device
    faces = torch.as_tensor(faces, dtype=torch.int64, device=dev)
    L = sc.lighting.shape[0]
    per = faces.numel() * spt
    out = torch.zeros(faces.numel(), dtype=sc.dtype, device=dev)
    step = max(1, RAY_BATCH // per)
    k = torch.arange(per, device=dev)
    for l0 in range(0, L, step):
        n = min(step, L - l0)
        src = torch.arange(l0, l0 + n, device=dev).repeat_interleave(per)
        which = k.repeat(n) // spt
        r = Rays(sc, opt, src, src, faces[which], k.repeat(n) % spt, spt)
        ff = torch.clamp(r.cos3f * r.cos2, min=0.0) / (r.h * r.h)
        c = torch.where(r.valid, r.area * ff * ff / spt, 0.0)
        out.index_add_(0, which, c)
    return out
