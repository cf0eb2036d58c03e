"""The descent step around the renderer: the intensity weighting, the
weighted L2 loss, the normal-smoothness regularizer and Adam_Modified
(Adam whose denominator is averaged over each vertex's xyz), at the
precision of the tensors given."""

from __future__ import annotations

import numpy as np
import torch

from .geometry import cross, dot, normals_areas


def weighting(data: torch.Tensor, gamma: float) -> torch.Tensor:
    """w = (data/max + 0.1)^gamma, scaled so that it sums to L*B."""
    w = (data / data.max() + 0.1) ** gamma
    return w / w.sum() * (data.shape[0] * data.shape[1])


def data_l2(data, weight, transient) -> torch.Tensor:
    d = transient - data
    return (weight * d * d).sum() / d.shape[0]


def normal_smoothing(v: torch.Tensor, f: torch.Tensor, affinity):
    """(value, gradient [V, 3]) of sum_i a_i (1 - m_i . n_i), m_i the
    normalized area-weighted sum of face i's normal and its neighbours'
    (affinity [F, 3], -1 none); the gradient scatters
    cross(n_i - m_i, e_opposite / 2) to each face's vertices."""
    n, area = normals_areas(v, f)
    aff = torch.as_tensor(np.asarray(affinity, np.int64)).to(v.device)
    wn = n * area[:, None]
    nb = aff.clamp(min=0)
    acc = wn + torch.where((aff >= 0)[..., None], wn[nb], 0.0).sum(1)
    m = acc / torch.clamp(torch.sqrt(dot(acc, acc)), min=1e-30)[:, None]
    value = (area * (1.0 - dot(m, n))).sum()
    res = n - m
    p1, p2, p3 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    grad = torch.zeros_like(v)
    for k, e in enumerate((p3 - p2, p1 - p3, p2 - p1)):
        grad.index_add_(0, f[:, k], cross(res, e / 2.0))
    return value, grad


def adam_modified(grad, m, v, step: int, lr_scale, b1=0.9, b2=0.999,
                  eps=1e-8):
    """(update, m, v) of step ``step + 1`` with per-vertex lr_scale [V]
    (the learning rate folded in): bias correction in the step size,
    the denominator sqrt(v) + eps averaged over each vertex's xyz."""
    t = step + 1
    m = b1 * m + (1.0 - b1) * grad
    v = b2 * v + (1.0 - b2) * grad * grad
    denom = (torch.sqrt(v) + eps).mean(1, keepdim=True)
    size = float(np.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t))
    return -size * m / denom * lr_scale[:, None], m, v
