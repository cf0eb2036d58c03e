"""Adam_Modified: Adam with a per-vertex isotropic denominator.

Adam's elementwise denominator sqrt(v_t)+eps is replaced by its mean over
each vertex's xyz row, so a vertex moves isotropically.  Bias correction
is folded into the step size as lr*sqrt(1-b2^t)/(1-b1^t) (the second
moment is not bias-corrected before the sqrt).  Border vertices get their
own learning rate through a per-vertex ``lr_scale``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class AdamModifiedState(NamedTuple):
    step: int              # completed steps
    m: torch.Tensor        # [V,3] first moment
    v: torch.Tensor        # [V,3] second moment


def adam_modified(lr: float, b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8):
    """(init_fn, update_fn); update_fn(grads, state, lr_scale=None) ->
    (updates, state), lr_scale an optional [V] or [V,1] multiplier."""

    def init_fn(params: torch.Tensor) -> AdamModifiedState:
        return AdamModifiedState(step=0, m=torch.zeros_like(params),
                                 v=torch.zeros_like(params))

    def update_fn(grads: torch.Tensor, state: AdamModifiedState,
                  lr_scale: Optional[torch.Tensor] = None):
        step = state.step + 1
        m = b1 * state.m + (1.0 - b1) * grads
        v = b2 * state.v + (1.0 - b2) * grads * grads
        denom = torch.sqrt(v) + eps
        new_denom = denom.mean(dim=1, keepdim=True)
        t = torch.tensor(float(step), dtype=grads.dtype, device=grads.device)
        step_size = lr * torch.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
        updates = -step_size * m / new_denom
        if lr_scale is not None:
            updates = updates * torch.as_tensor(
                lr_scale, dtype=grads.dtype, device=grads.device).reshape(-1, 1)
        return updates, AdamModifiedState(step=step, m=m, v=v)

    return init_fn, update_fn
