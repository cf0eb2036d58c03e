"""The port's real-capture path (io/mat.py load_real_capture and
load_jitter_calibration, experiments/run.py run_real_experiment) against
the JAX package's, on the CPU, with a synthetic stand-in of the
reference's measured capture (exp_s/transient.mat: 'transient' [4096,
2048] and 'lighting' [4096, 3])."""

import os

import jax
import numpy as np
import scipy.io
import torch

import nlos_surface_optimization_tpu as nst
from nlos_surface_optimization_tpu.geometry.mesh import make_mesh as jmake
from nlos_surface_optimization_tpu.io import mat as jmat
from nlos_surface_optimization_tpu.recon import lct as jlct
from nlos_surface_optimization_tpu.render import api as japi

import nlos_surface_optimization_torch as pt
from nlos_surface_optimization_torch.experiments import run as prun
from nlos_surface_optimization_torch.io.mat import (
    load_jitter_calibration,
    load_real_capture,
)
from nlos_surface_optimization_torch.recon import lct

torch.set_num_threads(1)

KEY = 29


def _standin_capture(path, n=64, bins=2048, res=1.2e-3):
    """A measured capture's layout: 'transient' [n*n, bins] and
    'lighting' [n*n, 3].  Signal: a Gaussian pulse at each pixel's path
    length to a plane at z = 0.55 (past the 600 zeroed bins), plus a
    direct-bounce spike in the early bins that loading must wipe."""
    xs = np.linspace(-0.35, 0.35, n)
    gx, gy = np.meshgrid(xs, xs)
    lighting = np.stack([gx.ravel(), gy.ravel(), np.zeros(n * n)], axis=1)
    h = np.sqrt(gx.ravel() ** 2 + gy.ravel() ** 2 + 0.55 ** 2)
    center = 2.0 * h / res
    b = np.arange(bins)
    t = np.exp(-((b[None, :] - center[:, None]) / 6.0) ** 2)
    t[:, :600] += 5.0
    scipy.io.savemat(path, {"transient": t, "lighting": lighting})
    return t, lighting


def test_load_real_capture_layout(tmp_path):
    p = os.path.join(tmp_path, "transient.mat")
    t_raw, lighting_raw = _standin_capture(p)
    t, lighting, n = load_real_capture(p)
    assert n == 64 and t.shape == (4096, 2048) and t.dtype == np.float64
    assert (t[:, :600] == 0).all()
    np.testing.assert_allclose(t[:, 600:], t_raw[:, 600:])
    np.testing.assert_allclose(lighting, lighting_raw.astype(np.float32),
                               rtol=1e-6)
    for a, b in zip((t, lighting, n), jmat.load_real_capture(p)):
        np.testing.assert_array_equal(a, b)


def test_load_real_capture_rect_data_and_downsample(tmp_path):
    """'rect_data' [N, N, B] and a scan downsample, as JAX's."""
    n, bins = 16, 256
    rect = np.random.RandomState(0).rand(n, n, bins)
    p = os.path.join(tmp_path, "rect.mat")
    scipy.io.savemat(p, {"rect_data": rect})
    t, lighting, n_out = load_real_capture(p, zero_bins=32, downsample=4)
    assert lighting is None and n_out == 4 and t.shape == (16, bins)
    assert (t[:, :32] == 0).all()
    flat = rect.reshape(n * n, bins)
    idx = (np.arange(0, n, 4)[:, None] * n + np.arange(0, n, 4)).ravel()
    np.testing.assert_allclose(t[:, 32:], flat[idx, 32:])
    want = jmat.load_real_capture(p, zero_bins=32, downsample=4)
    np.testing.assert_array_equal(t, want[0])
    assert want[1] is None and want[2] == n_out


def test_measured_jitter_calibration(bumpy_mesh, tmp_path):
    """A jitter_info.mat calibration (asymmetric kernel, off-centre
    offset) loaded and run through the jitter renderer and its inverse,
    held to JAX's on the same file (the tolerances of
    tests/test_torch_jitter.py)."""
    rng = np.random.RandomState(7)
    K, off = 13, 3
    w = rng.rand(K) * np.exp(-0.4 * np.arange(K))
    w /= w.sum()
    jg = np.gradient(w)
    p = os.path.join(tmp_path, "jitter_info.mat")
    scipy.io.savemat(p, {"jitter_weight": w[:, None],
                         "jitter_grad": jg[:, None],
                         "jitter_offset": np.uint8(off)})
    w2, jg2, off2 = load_jitter_calibration(p)
    np.testing.assert_allclose(w2, w)
    np.testing.assert_allclose(jg2, jg)
    assert off2 == off

    v, f = bumpy_mesh
    base = dict(num_samples=500, num_bins=500, distance_resolution=5e-3)
    lighting, lnormal = nst.make_confocal_scan(6)
    t_p, _ = pt.render_transient_jitter(pt.make_mesh(v, f, device="cpu"),
                                        lighting, lnormal,
                                        pt.RenderConfig(**base), pt.key(KEY),
                                        w2, off2)
    t_j, _ = japi.render_transient_jitter(jmake(v, f), lighting, lnormal,
                                          nst.RenderConfig(**base),
                                          jax.random.key(KEY), w2, off2)
    t = t_p.numpy()
    assert t.sum() > 0 and np.isfinite(t).all()
    np.testing.assert_allclose(t, np.asarray(t_j), rtol=2e-5, atol=1e-8)
    data = (t * (1 + 0.2 * rng.rand(*t.shape))).astype(np.float32)
    weight = (0.5 + rng.rand(*data.shape)).astype(np.float32)
    _, g_p, _ = pt.inverse_render_jitter(
        pt.make_mesh(v, f, device="cpu"), data, weight, lighting, lnormal,
        pt.RenderConfig(**base), pt.key(KEY), w2, jg2, off2)
    _, g_j, _ = japi.inverse_render_jitter(
        jmake(v, f), data, weight, lighting, lnormal,
        nst.RenderConfig(**base), jax.random.key(KEY), w2, jg2, off2)
    scale = np.abs(np.asarray(g_j)).max()
    assert scale > 0
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_j), rtol=2e-4,
                               atol=2e-5 * scale)


def test_run_real_scene_end_to_end(tmp_path):
    """run_experiment('s') on the stand-in (64x64, B = 2048) downsampled
    to 8x8: the LCT init from the data is JAX's (x64 off) bit for bit,
    two loop iterations run, no v2 (no GT mesh), a checkpoint each."""
    workdir = os.path.join(tmp_path, "s")
    os.makedirs(workdir)
    path = os.path.join(workdir, "transient.mat")
    _standin_capture(path)
    logs = []
    state, history = prun.run_experiment(
        "s", workdir, max_iters=2, scan_resolution=8, sample_num=300,
        log=logs.append, device="cpu")
    assert len(history["l2"]) == 2
    assert all(np.isfinite(history["l2"]))
    assert np.isnan(history["v2"]).all()
    assert os.path.exists(os.path.join(workdir, "progress", "00000.mat"))
    assert any("closed-form albedo fit" in m for m in logs)

    gt, lighting, _ = load_real_capture(path, downsample=8)
    width = float((lighting[:, 0].max() - lighting[:, 0].min()) / 2)
    got = lct.lct_reconstruct(gt, width=width, bin_resolution_m=1.2e-3,
                              device="cpu")
    with jax.enable_x64(False):
        want = jlct.lct_reconstruct(gt, width=width, bin_resolution_m=1.2e-3)
        thr = float(np.asarray(want.albedo).max()) * 0.25
        v_j, f_j = jlct.init_mesh_from_lct(want, threshold=thr)
    v_p, f_p = lct.init_mesh_from_lct(got, threshold=float(got.albedo.max())
                                      * 0.25)
    np.testing.assert_array_equal(f_p, f_j)
    np.testing.assert_array_equal(v_p.view(np.int32), v_j.view(np.int32))
    assert f"init mesh: V={v_p.shape[0]} F={f_p.shape[0]}" in logs
