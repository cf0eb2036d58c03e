"""Loss evaluation and the intensity weighting function."""

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
