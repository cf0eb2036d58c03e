"""Temporal kernels: Gaussian smoothing of the fine histogram.

  sigma   = resolution * sigma_bin / 2.355
  taps    = 4 * refine * sigma_bin + 1 sub-bins of width resolution/refine
  delta_i = (-2*refine*sigma_bin + i) * resolution / refine
  w_i     = exp(-(delta_i/sigma)^2/2) / (sigma*sqrt(2*pi)) * resolution/refine
The forward convolves the fine histogram with w ('same' alignment) and sums
each group of `refine` fine bins into a coarse bin.
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
