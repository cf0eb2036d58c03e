"""Temporal kernels: Gaussian smoothing of the fine histogram, the measured
SPAD jitter kernel, and the legacy box smoothing of the difference.

  sigma   = resolution * sigma_bin / 2.355
  taps    = 4 * refine * sigma_bin + 1 sub-bins of width resolution/refine
  delta_i = (-2*refine*sigma_bin + i) * resolution / refine
  w_i     = exp(-(delta_i/sigma)^2/2) / (sigma*sqrt(2*pi)) * resolution/refine
The forward convolves the fine histogram with w ('same' alignment) and sums
each group of `refine` fine bins into a coarse bin.

A measured jitter kernel has ~900 taps, so the jitter and box filters run
as one ``conv1d`` (``correlate_rows``) with TF32 off, whatever the global
cuDNN setting.
"""

from __future__ import annotations

import numpy as np
import torch


def gaussian_kernel(resolution: float, refine: int, sigma_bin: int):
    """(weights [K], deltas [K]) as numpy f64 (host-side constants)."""
    K = 4 * refine * sigma_bin + 1
    sigma = resolution * sigma_bin / 2.355
    i = np.arange(K)
    deltas = (-2.0 * refine * sigma_bin + i) * resolution / refine
    norm = 1.0 / sigma / np.sqrt(2.0 * np.pi) * resolution / refine
    weights = np.exp(-((deltas / sigma) ** 2) / 2.0) * norm
    return weights, deltas


def grouped_gaussian_tables(resolution: float, refine: int, sigma_bin: int):
    """Phase-grouped tap tables (W, WD), each [refine, G], G = 4*sigma_bin+2:
    tap i of a sample with fine-bin phase p lands on coarse bin
    b0 + (p + i) // refine, so
        W[p, j]  = sum_i w_i          [(p+i)//refine == j]
        WD[p, j] = sum_i w_i*delta_i  [(p+i)//refine == j]."""
    w, d = gaussian_kernel(resolution, refine, sigma_bin)
    K = w.shape[0]
    G = 4 * sigma_bin + 2
    W = np.zeros((refine, G))
    WD = np.zeros((refine, G))
    for p in range(refine):
        for i in range(K):
            j = (p + i) // refine
            W[p, j] += w[i]
            WD[p, j] += w[i] * d[i]
    return W, WD


def smooth_and_coarsen(fine_hist: torch.Tensor, resolution: float,
                       refine: int, sigma_bin: int) -> torch.Tensor:
    """[L, B*refine] fine histogram -> [L, B] smoothed coarse transient.

    The 'same' convolution is a sum of K shifted slices in the histogram's
    own dtype (no TF32 convolution on the card)."""
    if refine == 1:
        return fine_hist
    w, _ = gaussian_kernel(resolution, refine, sigma_bin)
    K = w.shape[0]
    c = (K - 1) // 2
    L, Bf = fine_hist.shape
    padded = torch.nn.functional.pad(fine_hist, (c, c))
    smoothed = torch.zeros_like(fine_hist)
    # same[i] = sum_k w[k] * x[i + c - k]
    for k in range(K):
        smoothed = smoothed + float(w[k]) * padded[:, 2 * c - k:2 * c - k + Bf]
    return smoothed.reshape(L, Bf // refine, refine).sum(dim=-1)


def correlate_rows(x: torch.Tensor, kernel, left: int, right: int
                   ) -> torch.Tensor:
    """out[l, b] = sum_i kernel[i] * xp[l, b + i] for each row of x [L, n],
    xp = x with ``left`` zeros before and ``right`` after each row (a
    negative count crops); [L, n + left + right - K + 1].  One conv1d in
    x's dtype, with TF32 off on the card."""
    k = torch.as_tensor(kernel, dtype=x.dtype, device=x.device)
    xp = torch.nn.functional.pad(x, (left, right))
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        out = torch.nn.functional.conv1d(xp[:, None, :], k.reshape(1, 1, -1))
    return out[:, 0, :]


def jitter_convolve(hist: torch.Tensor, weight, offset: int) -> torch.Tensor:
    """Measured-SPAD-jitter smoothing of a coarse histogram [L, B]:
    T[l, b] = sum_i weight[i] * hist[l, b + offset - i] (the full
    convolution windowed at ``offset``)."""
    w = torch.as_tensor(weight, dtype=hist.dtype, device=hist.device)
    K = w.shape[0]
    return correlate_rows(hist, torch.flip(w, (0,)), K - 1 - offset, offset)


def box_smooth_difference(diff: torch.Tensor, width: int) -> torch.Tensor:
    """Legacy loss smoothing: the difference convolved twice with a
    normalized box of 2*width+1 taps, 'same' alignment (width 0: the
    identity)."""
    if width <= 0:
        return diff
    k = torch.full((2 * width + 1,), 1.0 / (2 * width + 1), dtype=diff.dtype,
                   device=diff.device)
    return correlate_rows(correlate_rows(diff, k, width, width), k, width,
                          width)
