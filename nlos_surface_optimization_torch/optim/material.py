"""Material estimation: a scalar albedo or a GGX roughness, and the
fixed-topology shape leg they alternate with.

  initial_fitting_albedo  closed-form projection sum(gt*T)/||T||^2
  optimize_albedo         Adam on the scalar albedo, plateau stop
  optimize_alpha          Adam on the GGX roughness, plateau stop
  optimize_shape          Adam_Modified + normal smoothing on the vertices

Each step draws its samples with fold_in(key, t), as the JAX package
does, so with the same key the draws are the same.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..config import RenderConfig
from ..geometry.mesh import Mesh
from ..geometry.sampling import fold_in
from ..geometry.topology import border_vertices, face_affinity
from ..render.api import (
    inverse_render,
    inverse_render_albedo,
    inverse_render_alpha,
    render_transient,
)
from ..render.regularizers import normal_smoothing
from .adam_modified import adam_modified
from .loss import evaluate_loss_with_normal_smoothness, weighted_l2


def _with_albedo(mesh: Mesh, albedo: float) -> Mesh:
    return mesh._replace(albedo=torch.full_like(mesh.albedo, albedo))


def _step_key(key, t: int):
    return fold_in(key, torch.tensor([t]))[0]


def _on(x, mesh: Mesh) -> torch.Tensor:
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    return x.to(mesh.device, torch.float32)


def initial_fitting_albedo(mesh: Mesh, gt_transient, lighting,
                           lighting_normal, cfg: RenderConfig, key) -> float:
    """Closed-form albedo by projection: sum(gt*T)/||T||^2 for T rendered
    at albedo 1 (raw histogram)."""
    t, _ = render_transient(_with_albedo(mesh, 1.0), lighting,
                            lighting_normal, cfg, key, refine=1)
    t = t.cpu().numpy()
    return float(np.sum(np.asarray(gt_transient) * t)
                 / max(np.linalg.norm(t) ** 2, 1e-300))


def _scalar_adam_loop(value0: float,
                      grad_fn: Callable[[float, int], Tuple[float, float]],
                      lr: float, T: int, loss_epsilon: float,
                      log=print) -> Tuple[float, list]:
    """Plain Adam on one scalar, stopping when the relative loss decrease
    falls below loss_epsilon (from the fourth step)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    m = v = 0.0
    x = float(value0)
    losses = []
    for t in range(T):
        loss, g = grad_fn(x, t)
        losses.append(loss)
        if t > 2 and (losses[-2] - loss) / max(losses[-2], 1e-300) \
                < loss_epsilon:
            break
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / (1 - b1 ** (t + 1))
        vh = v / (1 - b2 ** (t + 1))
        x = x - lr * mh / (np.sqrt(vh) + eps)
        log(f"{t:05d} loss {loss:.8f} value {x:.6f}")
    return x, losses


def optimize_albedo(mesh: Mesh, gt_transient, weight, lighting,
                    lighting_normal, cfg: RenderConfig, key,
                    albedo0: float, lr: float = 1e-2, T: int = 50,
                    loss_epsilon: float = 1e-4, log=print):
    """Scalar albedo descent -> (albedo, losses)."""
    gt, w = _on(gt_transient, mesh), _on(weight, mesh)

    def grad_fn(a, t):
        transient, g = inverse_render_albedo(
            _with_albedo(mesh, a), gt, w, lighting, lighting_normal, cfg,
            _step_key(key, t))
        return float(weighted_l2(gt, w, transient)), float(g)

    return _scalar_adam_loop(albedo0, grad_fn, lr, T, loss_epsilon, log)


def optimize_alpha(mesh: Mesh, gt_transient, weight, lighting,
                   lighting_normal, cfg: RenderConfig, key,
                   alpha0: float, lr: float = 5e-3, T: int = 50,
                   loss_epsilon: float = 1e-4, log=print):
    """GGX roughness descent -> (alpha, losses); cfg.brdf must be 'ggx'."""
    if cfg.brdf != "ggx":
        raise ValueError(f"optimize_alpha needs brdf='ggx', got {cfg.brdf!r}")
    gt, w = _on(gt_transient, mesh), _on(weight, mesh)

    def grad_fn(a, t):
        transient, g = inverse_render_alpha(
            mesh, gt, w, lighting, lighting_normal, cfg, _step_key(key, t),
            torch.full((), a, dtype=mesh.v.dtype, device=mesh.device))
        return float(weighted_l2(gt, w, transient)), float(g)

    return _scalar_adam_loop(alpha0, grad_fn, lr, T, loss_epsilon, log)


def optimize_shape(mesh: Mesh, gt_transient, weight, lighting,
                   lighting_normal, cfg: RenderConfig, key,
                   lr: float = 1e-4 / 3, T: int = 50,
                   loss_epsilon: float = 1e-4, smooth_ratio: float = 100.0,
                   edge_lr_ratio: float = 0.1, alpha=None, log=print):
    """Fixed-topology shape descent: inverse_render, normal smoothing with
    the smooth weight set at the first step, Adam_Modified with the border
    learning-rate scale, and a stop at the first plateau of either loss
    (from the fourth step).  Returns (mesh, plateaued, data l2, losses)."""
    gt, w = _on(gt_transient, mesh), _on(weight, mesh)
    f = mesh.f.cpu().numpy()
    affinity = torch.from_numpy(face_affinity(f).astype(np.int64)).to(
        mesh.device)
    border = border_vertices(f, int(mesh.v.shape[0]))
    lr_scale = torch.from_numpy(
        np.where(border == 1, edge_lr_ratio, 1.0) * lr).to(mesh.device)
    opt_init, opt_update = adam_modified(lr=1.0)
    opt_state = opt_init(mesh.v)

    smooth_weight = None
    losses, losses_o = [], []
    original_l2 = float("nan")
    for t in range(T):
        transient, grad, _ = inverse_render(
            mesh, gt, w, lighting, lighting_normal, cfg, _step_key(key, t),
            alpha=alpha)
        sval, sgrad = normal_smoothing(mesh.v, mesh.f, mesh.f_valid, affinity)
        sval = float(sval)
        if smooth_weight is None:
            l2_0 = float(weighted_l2(gt, w, transient))
            smooth_weight = l2_0 / max(sval, 1e-300) / smooth_ratio
            log(f"smoothness weight {smooth_weight:f}")
        l2, original_l2 = evaluate_loss_with_normal_smoothness(
            gt, w, transient, sval, smooth_weight)
        l2, original_l2 = float(l2), float(original_l2)
        losses.append(l2)
        losses_o.append(original_l2)
        log(f"{t:05d} L2 {l2:.8f} old_l2 {original_l2:.8f}")
        if t > 2:
            if (losses_o[-2] - original_l2) / max(losses_o[-2], 1e-300) \
                    < loss_epsilon:
                return mesh, True, original_l2, losses
            if (losses[-2] - l2) / max(losses[-2], 1e-300) < loss_epsilon:
                return mesh, True, original_l2, losses
        g = grad + smooth_weight * sgrad
        updates, opt_state = opt_update(g, opt_state, lr_scale=lr_scale)
        mesh = mesh._replace(v=mesh.v + updates)
    return mesh, False, original_l2, losses
