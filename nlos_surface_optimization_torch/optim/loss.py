"""Loss evaluation, the intensity weighting function, and the legacy
height-field smoothness gradients."""

from __future__ import annotations

from typing import Tuple

import torch


def create_weighting_function(data: torch.Tensor, gamma: float = 1.0):
    """w = (data/max(data) + 0.1)^gamma, normalized so sum(w) = L*B."""
    w = (data / data.max() + 0.1) ** gamma
    w = w / w.sum()
    return w * (data.shape[0] * data.shape[1])


def weighted_l2(gt_transient, weight, transient):
    """||sqrt(w) * (T - gt)||^2 / L."""
    d = (transient - gt_transient) * torch.sqrt(weight)
    return (d * d).sum() / d.shape[0]


def evaluate_loss_with_normal_smoothness(gt_transient, weight, transient,
                                         smoothing_val, smooth_weight
                                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(total, data term): data L2 + smooth_weight * smoothing value."""
    l1 = weighted_l2(gt_transient, weight, transient)
    return l1 + smooth_weight * smoothing_val, l1


def evaluate_loss_with_curvature(gt_transient, weight, transient, area_total,
                                 smooth_weight):
    """(total, data term, total area): data L2 + smooth_weight * area."""
    l1 = weighted_l2(gt_transient, weight, transient)
    return l1 + smooth_weight * area_total, l1, area_total


def _scatter_stencil(s, axis: int, d, taps):
    """Zeros shaped like s with taps[j] * d added at offset j along axis:
    the gradient of 0.5*sum(d^2) for d = sum_j taps[j] * s[i + j]."""
    g = torch.zeros_like(s)
    n = d.shape[axis]
    for j, c in enumerate(taps):
        g.narrow(axis, j, n).add_(c * d)
    return g


def _z_only(gz, weight: float):
    out = torch.zeros((gz.numel(), 3), dtype=gz.dtype, device=gz.device)
    out[:, 2] = gz.reshape(-1) * weight
    return out


def smooth_grad(v, grid_shape: Tuple[int, int], weight: float = 1.0):
    """Legacy height-field smoothness gradient [V,3] (z only) for vertices
    on a grid_shape grid (row-major): the gradient of half the squared
    second differences of z along x and y."""
    s = torch.as_tensor(v)[:, 2].reshape(grid_shape)
    dx = 2 * s[:, 1:-1] - s[:, :-2] - s[:, 2:]
    dy = 2 * s[1:-1, :] - s[:-2, :] - s[2:, :]
    return _z_only(_scatter_stencil(s, 1, dx, (-1, 2, -1))
                   + _scatter_stencil(s, 0, dy, (-1, 2, -1)), weight)


def smooth_grad_first_order(v, grid_shape: Tuple[int, int],
                            weight: float = 1.0):
    """The first-difference variant of ``smooth_grad``."""
    s = torch.as_tensor(v)[:, 2].reshape(grid_shape)
    dx = s[:, 1:] - s[:, :-1]
    dy = s[1:, :] - s[:-1, :]
    return _z_only(_scatter_stencil(s, 1, dx, (-1, 1))
                   + _scatter_stencil(s, 0, dy, (-1, 1)), weight)
