"""Confocal NLOS reconstruction by the light-cone transform (LCT).

The JAX package's recon/lct.py in PyTorch (after the reference's MATLAB
cnlos.m, O'Toole et al., Nature 2018):

  radiometric scale data * z^4
  resample time axis t -> sqrt(t) (a matrix product)
  pad x2, FFT, multiply by the Wiener inverse PSF, IFFT, unpad
  resample depth axis back, clamp >= 0
  crop to ind = round(M*2*width/(range/2)), flip x
  depth = argmax_z vol; albedo = max_z vol

The FFTs are torch.fft (the JAX package leaves them to XLA, outside any
kernel); the two resampling products are float32 matrix products with
TF32 off.  The reconstruction runs on the device of ``device``.

The depth and lateral grids are float32, each point the one jax 0.9's
``jnp.linspace`` gives with x64 off, as the JAX package's runner runs it
(``linspace_f32``): the depth of a voxel and the init mesh's vertices
then equal the JAX package's bit for bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch


def define_psf(N: int, M: int, slope: float) -> np.ndarray:
    """NLOS blur kernel: the light-cone surface |(4*slope)^2*(x^2+y^2) - z|
    arg-min'd over z, normalized, circularly shifted to the corner."""
    x = np.linspace(-1, 1, 2 * N)
    y = np.linspace(-1, 1, 2 * N)
    z = np.linspace(0, 2, 2 * M)
    gz, gy, gx = np.meshgrid(z, y, x, indexing="ij")
    psf = np.abs((4.0 * slope) ** 2 * (gx ** 2 + gy ** 2) - gz)
    psf = (psf == psf.min(axis=0, keepdims=True)).astype(np.float64)
    psf = psf / psf[:, N, N].sum()
    psf = psf / np.linalg.norm(psf.ravel())
    psf = np.roll(psf, (0, N, N), axis=(0, 1, 2))
    return psf


def resampling_operator(M: int) -> Tuple[np.ndarray, np.ndarray]:
    """(mtx, mtxi) [M,M]: t -> sqrt-resampled axis."""
    x = np.arange(1, M * M + 1)
    rows = (x - 1) // M
    cols = np.ceil(np.sqrt(x)).astype(int) - 1
    vals = 1.0 / np.sqrt(x)
    mtx = np.zeros((M, M))
    np.add.at(mtx, (rows, cols), vals)
    return mtx, mtx.T


def _fma_f32(a, b, c) -> np.ndarray:
    """f32(a*b + c) with one rounding, as a fused multiply-add gives it, for
    float32 a, b, c: the product is exact in float64, the sum is rounded to
    odd there (TwoSum, then one ulp toward the lost part), and rounding
    that to float32 is then the correctly rounded result."""
    a, b, c = (np.atleast_1d(np.asarray(x, np.float32)).astype(np.float64)
               for x in (a, b, c))
    p = a * b
    s = p + c
    z = s - p
    err = (p - (s - z)) + (c - z)
    nudge = (err != 0) & ((s.view(np.int64) & 1) == 0)
    s = np.where(nudge, np.nextafter(s, np.copysign(np.inf, err)), s)
    return s.astype(np.float32)


def linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` with x64 off, bit for bit, as
    XLA's CPU code computes it in jax 0.9: ``start*(1 - i*r) + i*(stop*r)``
    in float32 with r = f32(1/(num-1)) (the division is rewritten as that
    product), the constants 1 - i*r folded, the sum fused as
    fma(i, stop*r, start*(1 - i*r)); up to 34 points the loop is unrolled
    and point 1 (where i*(stop*r) is stop*r) fuses the other product,
    fma(start, 1 - r, stop*r).  The last point is stop."""
    start, stop = np.float32(start), np.float32(stop)
    if num < 2:
        return np.full(max(num, 0), start, np.float32)
    div = num - 1
    r = np.float32(1) / np.float32(div)
    i = np.arange(div, dtype=np.float32)
    c = np.float32(1) - i * r
    s = stop * r
    out = _fma_f32(i, s, start * c)
    if 1 < div <= 33:
        out[1] = _fma_f32(start, c[1], s)[0]
    return np.append(out, stop)


class LCTResult(NamedTuple):
    x: torch.Tensor        # [N,N] lateral grid (f32)
    y: torch.Tensor        # [N,N] (f32)
    depth: torch.Tensor    # [N,N] argmax depth, meters from wall (f32)
    albedo: torch.Tensor   # [N,N] max projection (f32)
    vol: torch.Tensor      # [Mc,N,N] cropped reconstruction volume (f32)


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in full float32 (TF32 off for the call)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _lct_core(data, psf, mtx, mtxi, snr: float, N: int, M: int,
              isdiffuse: bool, isbackprop: bool):
    fpsf = torch.fft.fftn(psf)
    if isbackprop:
        invpsf = torch.conj(fpsf)
    else:
        invpsf = torch.conj(fpsf) / (torch.abs(fpsf) ** 2 + 1.0 / snr)

    grid_z = torch.from_numpy(linspace_f32(0.0, 1.0, M)).to(
        data.device)[:, None, None]
    # z^4 as (z*z)*(z*z), z^2 as z*z: XLA's integer power
    z2 = grid_z * grid_z
    data = data * (z2 * z2 if isdiffuse else z2)

    tdata = torch.zeros((2 * M, 2 * N, 2 * N), dtype=data.dtype,
                        device=data.device)
    tdata[:M, :N, :N] = _matmul_f32(mtx, data.reshape(M, -1)).reshape(M, N, N)

    tvol = torch.fft.ifftn(torch.fft.fftn(tdata) * invpsf)
    tvol = tvol[:M, :N, :N]
    vol = _matmul_f32(mtxi, tvol.reshape(M, -1).real.contiguous())
    return torch.clamp(vol.reshape(M, N, N), min=0.0)


def lct_reconstruct(transient, width: float,
                    bin_resolution_m: float = 1.2e-3,
                    snr: float = 0.8, isdiffuse: bool = True,
                    isbackprop: bool = False, z_offset: int = 0,
                    device="cuda") -> LCTResult:
    """LCT reconstruction of a confocal transient [L=N^2, M] (float32).

    ``width`` is the scan half-width ((max_x - min_x)/2);
    ``bin_resolution_m`` the path-length bin width in meters."""
    transient = torch.as_tensor(np.asarray(transient),
                                dtype=torch.float32).to(device)
    L, M = transient.shape
    N = int(math.isqrt(L))
    assert N * N == L, "confocal scan must be square"
    rng = M * bin_resolution_m  # 'range' in cnlos.m (path length, meters)

    def dev(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(device)

    psf = dev(define_psf(N, M, width / rng))
    mtx, mtxi = resampling_operator(M)

    # permute(reshape(t, N,N,M), [3 2 1]): data[m, col, row], scan rows = y
    data = transient.reshape(N, N, M).permute(2, 1, 0)
    vol = _lct_core(data, psf, dev(mtx), dev(mtxi), snr, N, M, isdiffuse,
                    isbackprop)

    tic_z = torch.from_numpy(linspace_f32(0.0, rng / 2.0, M)).to(device)
    tic_xy = torch.from_numpy(linspace_f32(-width, width, N)).to(device)

    # crop + flip
    ind = int(round(M * 2.0 * width / (rng / 2.0)))
    vol = torch.flip(vol, dims=(2,))
    hi = min(ind + z_offset, vol.shape[0])
    vol_c = vol[z_offset:hi]
    tic_z = tic_z[z_offset:hi]

    albedo, imax = torch.max(vol_c, dim=0)
    depth = tic_z[imax]
    gx, gy = torch.meshgrid(tic_xy, tic_xy, indexing="xy")
    return LCTResult(x=gx, y=gy, depth=depth, albedo=albedo, vol=vol_c)


def _grid_faces(mask: np.ndarray) -> np.ndarray:
    """Two triangles per grid quad whose 4 corners are all masked, indices
    into the compacted masked-vertex array."""
    H, W = mask.shape
    remap = -np.ones(H * W, np.int64)
    remap[np.flatnonzero(mask.ravel())] = np.arange(int(mask.sum()))
    faces = []
    for i in range(H - 1):
        for j in range(W - 1):
            a, b = i * W + j, i * W + j + 1
            c, d = (i + 1) * W + j, (i + 1) * W + j + 1
            if mask.ravel()[[a, b, c, d]].all():
                faces.append([remap[a], remap[c], remap[b]])
                faces.append([remap[c], remap[d], remap[b]])
    return np.asarray(faces, np.int32).reshape(-1, 3)


def init_mesh_from_lct(res: LCTResult, threshold: float = 0.8e-3
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Threshold the albedo map and triangulate the masked height field
    (vertices [-x, y, depth]), wound so normals face the wall (-z)."""
    albedo = res.albedo.cpu().numpy()
    mask = albedo > threshold
    v_all = np.stack([-res.x.cpu().numpy().ravel(),
                      res.y.cpu().numpy().ravel(),
                      res.depth.cpu().numpy().ravel()], axis=1)
    v = v_all[mask.ravel()].astype(np.float32)
    f = _grid_faces(mask)
    # a backwards init renders a ~zero transient (all faces backfacing)
    if f.shape[0]:
        n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        if n[:, 2].sum() > 0:
            f = f[:, ::-1].copy()
    return v, f
