"""The port's outer loop (optim/outer_loop.py) against the JAX package's, on
the scene of tests/test_outer_loop.py (an 8x8 grid GT, 2,500 samples, 220
bins), with the same init and key: the iterations before the first remesh,
the remesh itself from a shared state, and a resume from a checkpoint that
the JAX loop wrote."""

import copy
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

import nlos_surface_optimization_tpu as nst
from nlos_surface_optimization_tpu.geometry.mesh import make_mesh as jmake_mesh
from nlos_surface_optimization_tpu.optim import outer_loop as jloop
from nlos_surface_optimization_tpu.render import render_transient as jrender

import nlos_surface_optimization_torch as pt
from nlos_surface_optimization_torch.optim import outer_loop as ploop

torch.set_num_threads(1)

SEED = 17
CFG = dict(num_samples=2500, num_bins=220, distance_resolution=6e-3)
# test_outer_loop's settings at the default learning rate (1e-4/3): at its
# 2e-3, Adam's normalized step turns f32 summation-order differences in
# near-zero gradient components into full-size moves of either sign
LOOP = dict(T=20, smooth_ratio=100.0, loss_epsilon=1e-6, scan_resolution=8,
            forced_remesh_every=5)
HIST = ("l2", "l2_original", "v2")


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


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """One JAX loop with a checkpoint every iteration and a forced remesh
    after iteration 4, run through iteration 6.  Keeps its state just
    before the remesh and the loop's topology just after it."""
    v_gt, f_gt = _grid_mesh(8, lambda x, y: 0.5 + 0.04 * np.sin(6 * x))
    cfg = nst.RenderConfig(**CFG)
    lighting, lnormal = nst.make_confocal_scan(8)
    gt, _ = jrender(jmake_mesh(v_gt, f_gt), lighting, lnormal, cfg,
                    jax.random.key(SEED), refine=1)
    gt = np.array(gt, np.float32)
    v0, f0 = _grid_mesh(8, lambda x, y: np.full_like(x, 0.5))
    ckpt = str(tmp_path_factory.mktemp("jax_loop"))
    loop = jloop.InverseRenderingLoop(
        gt, lighting, lnormal, cfg,
        jloop.LoopConfig(checkpoint_dir=ckpt, **LOOP), v0, f0,
        jax.random.key(SEED),
        gt_mesh=jmake_mesh(v_gt, f_gt, dtype=np.float64), log=lambda s: None)
    for _ in range(5):
        loop.step()
    assert loop.state.remesh_flag
    before = copy.deepcopy(loop.state)
    history5 = copy.deepcopy(loop.history)
    after = {}
    remesh = loop._remesh

    def recording_remesh():
        ok = remesh()
        after.update(state=copy.deepcopy(loop.state),
                     affinity=loop.affinity.copy(), border=loop.border.copy(),
                     lr_scale=loop.lr_scale.copy())
        return ok

    loop._remesh = recording_remesh
    loop.run(max_iters=7)
    assert after and loop.state.t == 7
    return types.SimpleNamespace(
        gt=gt, lighting=lighting, lnormal=lnormal, v0=v0, f0=f0, ckpt=ckpt,
        gt_mesh=pt.make_mesh(v_gt, f_gt, device="cpu", dtype=np.float64),
        before=before, history5=history5, after=after, loop=loop)


def _port_loop(run, **kw):
    return ploop.InverseRenderingLoop(
        run.gt, run.lighting, run.lnormal, pt.RenderConfig(**CFG),
        ploop.LoopConfig(**LOOP, **kw), run.v0, run.f0, pt.key(SEED),
        gt_mesh=run.gt_mesh, log=lambda s: None, device="cpu")


def test_loop_config_and_state_carry_the_jax_fields():
    for a, b in ((ploop.LoopConfig, jloop.LoopConfig),
                 (ploop.LoopState, jloop.LoopState)):
        fa = [(x.name, x.default) for x in dataclasses.fields(a)]
        fb = [(x.name, x.default) for x in dataclasses.fields(b)]
        assert fa == fb


def test_first_iterations_match_jax(jax_run):
    """Iterations 0-4, before any remesh: the histories and the vertices."""
    loop = _port_loop(jax_run)
    np.testing.assert_array_equal(loop.state.f, jax_run.before.f)
    for _ in range(5):
        loop.step()
    for k in HIST:
        np.testing.assert_allclose(loop.history[k], jax_run.history5[k],
                                   rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(loop.state.v, jax_run.before.v, rtol=1e-4,
                               atol=1e-7)
    assert loop.state.remesh_flag
    assert loop.state.smooth_weight == pytest.approx(
        jax_run.before.smooth_weight, rel=1e-4)


def test_remesh_matches_jax(jax_run):
    """_remesh from the JAX loop's state just before its remesh: integrate,
    El Topo-role and isotropic remesh, the render_intensity cull, Morton
    order."""
    loop = _port_loop(jax_run)
    before = jax_run.before
    loop.state = ploop.LoopState(**{
        x.name: copy.deepcopy(getattr(before, x.name))
        for x in dataclasses.fields(before)})
    assert loop._remesh()
    want = jax_run.after
    np.testing.assert_array_equal(loop.state.f, want["state"].f)
    np.testing.assert_allclose(loop.state.v, want["state"].v, rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(loop.state.old_v, loop.state.v)
    for name in ("affinity", "border", "lr_scale"):
        np.testing.assert_array_equal(getattr(loop, name), want[name])
    assert not loop.state.remesh_flag and loop.state.run_count == 0
    rec = loop.stats[-1]
    assert rec["kind"] == "remesh"
    assert rec["faces_after"] == want["state"].f.shape[0]


def test_resume_from_a_jax_checkpoint(jax_run):
    """from_checkpoint reads the JAX loop's iteration-6 checkpoint (after
    its remesh) and re-executes iteration 6 as the JAX loop did."""
    path = f"{jax_run.ckpt}/00006.mat"
    loop = ploop.InverseRenderingLoop.from_checkpoint(
        path, jax_run.gt, jax_run.lighting, jax_run.lnormal,
        pt.RenderConfig(**CFG), ploop.LoopConfig(**LOOP),
        gt_mesh=jax_run.gt_mesh, log=lambda s: None, device="cpu")
    want = jax_run.loop.history
    assert loop.state.t == 6
    for k in HIST:
        np.testing.assert_array_equal(loop.history[k], want[k][:6])
    loop.step()
    for k in HIST:
        np.testing.assert_allclose(loop.history[k][6], want[k][6], rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(loop.state.v, jax_run.loop.state.v, rtol=1e-4,
                               atol=1e-7)
