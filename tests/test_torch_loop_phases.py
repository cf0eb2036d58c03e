"""The port's outer loop on its own: a short optimization that crosses a
forced remesh and drives the loss down, and the plateau phase machine
(mirrors of tests/test_outer_loop.py, at its sizes, on the CPU)."""

import numpy as np
import torch

import nlos_surface_optimization_torch as pt
from nlos_surface_optimization_torch.optim.outer_loop import (
    InverseRenderingLoop,
    LoopConfig,
)

torch.set_num_threads(1)

KEY = pt.key(17)


def _grid_mesh(n, zfn, extent=0.28):
    xs = np.linspace(-extent, extent, n)
    gx, gy = np.meshgrid(xs, xs)
    z = zfn(gx, gy)
    v = np.stack([gx.ravel(), gy.ravel(), z.ravel()], 1).astype(np.float32)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            faces.append([a, a + n, a + 1])
            faces.append([a + n, a + n + 1, a + 1])
    return v, np.array(faces, np.int32)


def test_outer_loop_descends_and_remeshes():
    """20 iterations on a small scene: loss decreases, the forced remesh at
    15 runs without breaking state, v2 improves or holds."""
    v_gt, f_gt = _grid_mesh(8, lambda x, y: 0.5 + 0.04 * np.sin(6 * x))
    gt_mesh = pt.make_mesh(v_gt, f_gt, device="cpu", dtype=np.float64)
    cfg = pt.RenderConfig(num_samples=2500, num_bins=220,
                          distance_resolution=6e-3)
    lighting, lnormal = pt.make_confocal_scan(8)
    gt, _ = pt.render_transient(pt.make_mesh(v_gt, f_gt, device="cpu"),
                                lighting, lnormal, cfg, KEY, refine=1)
    v0, f0 = _grid_mesh(8, lambda x, y: np.full_like(x, 0.5))
    loop_cfg = LoopConfig(lr0=2e-3, T=20, smooth_ratio=100.0,
                          loss_epsilon=1e-6, scan_resolution=8,
                          forced_remesh_every=15)
    loop = InverseRenderingLoop(gt.numpy(), lighting, lnormal, cfg, loop_cfg,
                                v0, f0, KEY, gt_mesh=gt_mesh,
                                log=lambda s: None, device="cpu")
    state, hist = loop.run(max_iters=20)
    assert len(hist["l2_original"]) >= 15
    first = np.mean(hist["l2_original"][:3])
    last = np.mean(hist["l2_original"][-3:])
    assert last < first, (first, last)
    assert np.isfinite(state.v).all()
    assert state.f.shape[0] > 0
    assert hist["v2"][-1] <= hist["v2"][0] * 1.2
    kinds = [r["kind"] for r in loop.stats]
    assert kinds.count("remesh") >= 1 and kinds.count("step") == 20


def test_outer_loop_plateau_switches_phase():
    """With loss_epsilon = 1 every step is a 'plateau': after 3 runs the
    machine must switch to shading mode then coarse-to-fine."""
    v_gt, f_gt = _grid_mesh(6, lambda x, y: 0.5 + 0.03 * np.cos(5 * y))
    cfg = pt.RenderConfig(num_samples=1200, num_bins=200,
                          distance_resolution=6e-3)
    lighting, lnormal = pt.make_confocal_scan(6)
    gt, _ = pt.render_transient(pt.make_mesh(v_gt, f_gt, device="cpu"),
                                lighting, lnormal, cfg, KEY, refine=1)
    v0, f0 = _grid_mesh(6, lambda x, y: np.full_like(x, 0.5))
    loop_cfg = LoopConfig(lr0=1e-3, T=12, smooth_ratio=100.0,
                          loss_epsilon=1.0, scan_resolution=6)
    loop = InverseRenderingLoop(gt.numpy(), lighting, lnormal, cfg, loop_cfg,
                                v0, f0, KEY, log=lambda s: None, device="cpu")
    saw_shading = False
    saw_c2f = False
    for _ in range(12):
        if not loop.step():
            break
        if loop.state.testing_flag == 0:
            saw_shading = True
        if loop.state.scan_resolution > 6:
            saw_c2f = True
    assert saw_shading
    assert saw_c2f
    assert loop.state.sample_num > cfg.num_samples  # coarse-to-fine bumped
