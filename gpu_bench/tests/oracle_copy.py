"""A frozen copy of the repository's float64 NumPy oracle (tests/oracle.py),
held here so that the benchmark's reference is tested against it.

Independent NumPy oracle for the confocal transient renderer.

A slow, loop-free-but-dense re-derivation of the reference semantics
(smoothed_transient/transient_and_gradient.cpp) used to validate the JAX/TPU
path bin-for-bin.  It takes the barycentric samples as an explicit input so
the production renderer and the oracle can be compared on identical sample
sets ("frozen sampling", the reference's gradcheck methodology,
check_matlab/check_mesh_sampling_grad.m).

This is test code: clarity over speed, float64 throughout.
"""

from __future__ import annotations

import numpy as np


def _face_geom(v, f):
    p1, p2, p3 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    n = np.cross(p2 - p1, p3 - p1)
    dbl = np.linalg.norm(n, axis=-1)
    area = dbl / 2.0
    n = n / np.maximum(dbl, 1e-300)[:, None]
    return p1, p2, p3, n, area


def _nearest_face(o, d, v, f):
    """Nearest-hit face index per ray (brute force Moller-Trumbore), -1 if
    none.  o,d: [R,3]."""
    p1 = v[f[:, 0]]
    e1 = v[f[:, 1]] - p1
    e2 = v[f[:, 2]] - p1
    pvec = np.cross(d[:, None, :], e2[None])
    det = np.einsum("fk,rfk->rf", e1, pvec)
    inv = np.where(np.abs(det) > 1e-14, 1.0 / np.where(det == 0, 1, det), 0.0)
    tvec = o[:, None, :] - p1[None]
    u = np.einsum("rfk,rfk->rf", tvec, pvec) * inv
    qvec = np.cross(tvec, e1[None])
    w = np.einsum("rk,rfk->rf", d, qvec) * inv
    t = np.einsum("fk,rfk->rf", e2, qvec) * inv
    hit = (np.abs(det) > 1e-14) & (u >= 0) & (w >= 0) & (u + w <= 1) & (t > 1e-6)
    t = np.where(hit, t, np.inf)
    j = np.argmin(t, axis=1)
    ok = np.isfinite(t[np.arange(len(j)), j])
    return np.where(ok, j, -1)


def _ray_quantities(v, f, lighting, lnormal, bary):
    """Common per-sample quantities.  bary: [L, F, spt, 3]."""
    L, F, spt, _ = bary.shape
    p1, p2, p3, fn, area = _face_geom(v, f)
    p = (
        bary[..., 0:1] * p1[None, :, None]
        + bary[..., 1:2] * p2[None, :, None]
        + bary[..., 2:3] * p3[None, :, None]
    )
    o = lighting[:, None, None, :]
    dv = p - o
    h = np.linalg.norm(dv, axis=-1)
    d = dv / np.maximum(h, 1e-300)[..., None]

    # visibility: nearest hit must be the sampled face
    of = np.broadcast_to(o, p.shape).reshape(-1, 3)
    df = d.reshape(-1, 3)
    nf = _nearest_face(of, df, v, f)
    fid = np.broadcast_to(np.arange(F)[None, :, None], (L, F, spt)).reshape(-1)
    vis = (nf == fid).reshape(L, F, spt)
    return p, h, d, vis, fn, area


def forward_transient(v, f, lighting, lnormal, bary, lo, res, B, refine=1,
                      sigma_bin=1, albedo=None, vn=None):
    """Raw or Gaussian-smoothed transient [L, B] (float64)."""
    L, F, spt, _ = bary.shape
    p, h, d, vis, fn, area = _ray_quantities(v, f, lighting, lnormal, bary)
    hi = lo + B * res

    if vn is not None:
        nrm = (
            bary[..., 0:1] * vn[f[:, 0]][None, :, None]
            + bary[..., 1:2] * vn[f[:, 1]][None, :, None]
            + bary[..., 2:3] * vn[f[:, 2]][None, :, None]
        )
    else:
        nrm = np.broadcast_to(fn[None, :, None], p.shape)
    alb = (
        (
            bary[..., 0] * albedo[f[:, 0]][None, :, None]
            + bary[..., 1] * albedo[f[:, 1]][None, :, None]
            + bary[..., 2] * albedo[f[:, 2]][None, :, None]
        )
        if albedo is not None
        else 1.0
    )

    cos2 = np.einsum("lk,lfsk->lfs", lnormal, d)
    cos3 = -np.einsum("lfsk,lfsk->lfs", nrm, d)
    ff = np.maximum(0.0, cos2 * cos3) / (h * h)
    w = area[None, :, None] * alb * ff * ff / spt
    in_rng = (h >= lo / 2) & (h <= hi / 2)
    fine_res = res / refine
    Bf = B * refine
    binf = np.floor((2 * h - lo) / fine_res).astype(int)
    ok = vis & in_rng & (binf >= 0) & (binf < Bf) & (area > 0)[None, :, None]

    hist = np.zeros((L, Bf))
    li = np.broadcast_to(np.arange(L)[:, None, None], h.shape)
    np.add.at(hist, (li[ok], binf[ok]), w[ok])

    if refine == 1:
        return hist
    # Gaussian smoothing + coarsen
    K = 4 * refine * sigma_bin + 1
    sigma = res * sigma_bin / 2.355
    i = np.arange(K)
    deltas = (-2 * refine * sigma_bin + i) * res / refine
    kern = np.exp(-((deltas / sigma) ** 2) / 2) / sigma / np.sqrt(2 * np.pi) * res / refine
    out = np.zeros((L, B))
    for l in range(L):
        sm = np.convolve(hist[l], kern, mode="same")
        out[l] = sm.reshape(B, refine).sum(-1)
    return out


def forward_transient_jitter(v, f, lighting, lnormal, bary, lo, res, B,
                             weight, offset):
    """Coarse histogram convolved with the measured kernel
    (jitter/transient_and_gradient.cpp:333-351)."""
    hist = forward_transient(v, f, lighting, lnormal, bary, lo, res, B,
                             refine=1)
    out = np.zeros_like(hist)
    for l in range(hist.shape[0]):
        full = np.convolve(hist[l], weight, mode="full")
        out[l] = full[offset:offset + B]
    return out


def vertex_gradient_jitter(v, f, lighting, lnormal, bary, difference, lo,
                           res, B, jitter_weight, jitter_grad, jitter_offset,
                           vn=None, testing_flag=1):
    """Loop re-derivation of the jitter gradient kernel
    (jitter/transient_and_gradient.cpp:900-975), OOB taps masked."""
    L, F, spt, _ = bary.shape
    p, h, d, vis, fn, area = _ray_quantities(v, f, lighting, lnormal, bary)
    hi = lo + B * res
    p1, p2, p3 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]

    if vn is not None:
        nrm = (
            bary[..., 0:1] * vn[f[:, 0]][None, :, None]
            + bary[..., 1:2] * vn[f[:, 1]][None, :, None]
            + bary[..., 2:3] * vn[f[:, 2]][None, :, None]
        )
    else:
        nrm = np.broadcast_to(fn[None, :, None], p.shape).copy()
    alb = np.ones_like(h)

    cos2 = np.maximum(np.einsum("lk,lfsk->lfs", lnormal, d), 0.0)
    cos3 = np.maximum(-np.einsum("lfsk,lfsk->lfs", nrm, d), 0.0)
    ff = cos2 * cos3 / (h * h)
    inten = alb * ff * ff

    t1 = (
        2.0
        * (alb * cos2 * cos3)[..., None]
        * (
            lnormal[:, None, None, :] * cos3[..., None]
            - nrm * cos2[..., None]
            + 4.0 * (-d) * (cos2 * cos3)[..., None]
        )
        / (h**5)[..., None]
    )
    gn = np.zeros_like(t1)
    if vn is not None and testing_flag == 0:
        gn = -2.0 * alb[..., None] * d * (cos3 * cos2 * cos2)[..., None] / (h**4)[..., None]
        gn -= nrm * np.einsum("lfsk,lfsk->lfs", gn, nrm)[..., None]
    t2 = (nrm * inten[..., None] + gn) / np.maximum(2 * area, 1e-300)[None, :, None, None]

    in_rng = (h >= lo / 2) & (h <= hi / 2)
    ok = vis & in_rng & (area > 0)[None, :, None]
    li = np.broadcast_to(np.arange(L)[:, None, None], h.shape)

    bin0 = np.floor((2 * h - lo) / res).astype(int)
    K = len(jitter_weight)
    A = np.zeros_like(h)
    C = np.zeros_like(h)
    for i in range(K):
        b = bin0 + (i - jitter_offset)
        good = (b >= 0) & (b < B)
        dif = np.where(good, difference[li, np.clip(b, 0, B - 1)], 0.0)
        A += jitter_weight[i] * dif
        C += jitter_grad[i] * dif

    jvec = (-2.0 / res) * d * (inten * C)[..., None]
    grad = np.zeros_like(v, dtype=np.float64)
    edges = (p3 - p2, p1 - p3, p2 - p1)
    for k in range(3):
        e = np.broadcast_to(edges[k][None, :, None], t2.shape)
        gk = (t1 * A[..., None] + jvec) * bary[..., k : k + 1] + np.cross(t2, e) * A[..., None]
        gk = gk * (-2.0) * area[None, :, None, None] / spt
        gk = np.where(ok[..., None], gk, 0.0)
        np.add.at(grad, f[:, k], gk.sum(axis=(0, 2)))
    return grad / L


def vertex_gradient(v, f, lighting, lnormal, bary, difference, lo, res, B,
                    refine, sigma_bin, albedo=None, vn=None, testing_flag=1):
    """Analytic vertex gradient [V,3] of the weighted smoothed-L2 loss, summed
    over sources and divided by num sources (parity with
    render_smoothed_gradients + driver)."""
    L, F, spt, _ = bary.shape
    p, h, d, vis, fn, area = _ray_quantities(v, f, lighting, lnormal, bary)
    hi = lo + B * res
    p1, p2, p3 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]

    if vn is not None:
        nrm = (
            bary[..., 0:1] * vn[f[:, 0]][None, :, None]
            + bary[..., 1:2] * vn[f[:, 1]][None, :, None]
            + bary[..., 2:3] * vn[f[:, 2]][None, :, None]
        )
    else:
        nrm = np.broadcast_to(fn[None, :, None], p.shape).copy()
    alb = (
        (
            bary[..., 0] * albedo[f[:, 0]][None, :, None]
            + bary[..., 1] * albedo[f[:, 1]][None, :, None]
            + bary[..., 2] * albedo[f[:, 2]][None, :, None]
        )
        if albedo is not None
        else np.ones_like(h)
    )

    cos2 = np.maximum(np.einsum("lk,lfsk->lfs", lnormal, d), 0.0)
    cos3 = np.maximum(-np.einsum("lfsk,lfsk->lfs", nrm, d), 0.0)
    ff = cos2 * cos3 / (h * h)
    inten = alb * ff * ff

    t1 = (
        2.0
        * (alb * cos2 * cos3)[..., None]
        * (
            lnormal[:, None, None, :] * cos3[..., None]
            - nrm * cos2[..., None]
            + 4.0 * (-d) * (cos2 * cos3)[..., None]
        )
        / (h**5)[..., None]
    )
    gn = np.zeros_like(t1)
    if vn is not None and testing_flag == 0:
        gn = -2.0 * alb[..., None] * d * (cos3 * cos2 * cos2)[..., None] / (h**4)[..., None]
        gn -= nrm * np.einsum("lfsk,lfsk->lfs", gn, nrm)[..., None]
    t2 = (nrm * inten[..., None] + gn) / np.maximum(2 * area, 1e-300)[None, :, None, None]

    K = 4 * refine * sigma_bin + 1
    sigma = res * sigma_bin / 2.355
    sigma2 = sigma * sigma
    taps = np.arange(K)
    deltas = (-2 * refine * sigma_bin + taps) * res / refine
    kern = np.exp(-((deltas / sigma) ** 2) / 2) / sigma / np.sqrt(2 * np.pi) * res / refine

    in_rng = (h >= lo / 2) & (h <= hi / 2)
    ok = vis & in_rng & (area > 0)[None, :, None]

    grad = np.zeros_like(v, dtype=np.float64)
    edges = (p3 - p2, p1 - p3, p2 - p1)
    li = np.broadcast_to(np.arange(L)[:, None, None], h.shape)

    # tap reductions
    A = np.zeros_like(h)
    Bw = np.zeros_like(h)
    for i in range(K):
        b = np.floor((2 * h + deltas[i] - lo) / res).astype(int)
        good = (b >= 0) & (b < B)
        dif = np.where(good, difference[li, np.clip(b, 0, B - 1)], 0.0)
        A += kern[i] * dif
        Bw += kern[i] * deltas[i] * dif

    gauss_vec = (2.0 / sigma2) * d * (inten * Bw)[..., None]
    for k in range(3):
        e = np.broadcast_to(edges[k][None, :, None], t2.shape)
        gk = (t1 * A[..., None] + gauss_vec) * bary[..., k : k + 1] + np.cross(t2, e) * A[..., None]
        gk = gk * (-2.0) * area[None, :, None, None] / spt
        gk = np.where(ok[..., None], gk, 0.0)
        np.add.at(grad, f[:, k], gk.sum(axis=(0, 2)))
    return grad / L
