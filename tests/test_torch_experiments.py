"""The port's LCT initialization, GT generation and experiment runner
(recon/lct.py, experiments/) against the JAX package's, on the CPU."""

import os

import jax
import numpy as np
import pytest
import scipy.io
import torch

import nlos_surface_optimization_tpu as nst
from nlos_surface_optimization_tpu.experiments.create_gt import (
    create_gt as jax_create_gt,
)
from nlos_surface_optimization_tpu.experiments import run as jrun
from nlos_surface_optimization_tpu.geometry.mesh import make_mesh as jmake_mesh
from nlos_surface_optimization_tpu.recon import lct as jlct
from nlos_surface_optimization_tpu.render import render_transient as jrender

import nlos_surface_optimization_torch as pt
from nlos_surface_optimization_torch.experiments import SCENES, create_gt
from nlos_surface_optimization_torch.experiments import run as prun
from nlos_surface_optimization_torch.io.mat import load_checkpoint
from nlos_surface_optimization_torch.io.obj import write_obj
from nlos_surface_optimization_torch.recon import lct

torch.set_num_threads(1)

SPEC = SCENES["armadillo"]


def _grid_mesh(n, zfn, extent=0.2):
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


def test_lct_matches_jax(bumpy_mesh):
    """lct_reconstruct on a rendered 8x8 transient (the scene's bins), and
    the init mesh it gives."""
    v, f = bumpy_mesh
    cfg = nst.RenderConfig(num_samples=4000, num_bins=SPEC.num_bins,
                           distance_resolution=SPEC.distance_resolution)
    lighting, lnormal = nst.make_confocal_scan(8)
    t, _ = jrender(jmake_mesh(v, f), lighting, lnormal, cfg,
                   jax.random.key(5))
    t = np.array(t, np.float32)
    width = float((lighting[:, 0].max() - lighting[:, 0].min()) / 2)
    want = jlct.lct_reconstruct(t, width=width,
                                bin_resolution_m=SPEC.distance_resolution)
    got = lct.lct_reconstruct(t, width=width,
                              bin_resolution_m=SPEC.distance_resolution,
                              device="cpu")
    a_j = np.asarray(want.albedo)
    a_p = got.albedo.numpy()
    assert a_p.shape == a_j.shape == (8, 8) and a_j.max() > 0
    np.testing.assert_allclose(a_p, a_j, rtol=0, atol=1e-4 * a_j.max())
    bright = a_j > 0.25 * a_j.max()
    assert bright.sum() >= 8
    # the same depth bin; the f64 grids themselves differ by an ulp
    # (torch.linspace and jnp.linspace round differently)
    dz = SPEC.num_bins * SPEC.distance_resolution / 2 / (SPEC.num_bins - 1)
    np.testing.assert_array_equal(np.rint(got.depth.numpy() / dz)[bright],
                                  np.rint(np.asarray(want.depth) / dz)[bright])
    for a, b in ((got.x, want.x), (got.y, want.y), (got.depth, want.depth)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-15)
    thr = 0.25 * float(a_j.max())
    v_j, f_j = jlct.init_mesh_from_lct(want, threshold=thr)
    v_p, f_p = lct.init_mesh_from_lct(got, threshold=thr)
    np.testing.assert_array_equal(f_p, f_j)
    np.testing.assert_array_equal(v_p, v_j)
    assert f_p.shape[0] > 0


def test_create_gt_matches_jax(tmp_path, bumpy_mesh):
    """GT shards at 8x8, 3,000 samples, 2 shards: the same files, keys and
    shapes, and the same transients up to f32 summation order.

    JAX runs with jit off: XLA's fused CPU code rounds the ray lengths h
    differently from its own op-by-op arithmetic (which the port equals bit
    for bit), and in this raw histogram (1.2 mm bins, no smoothing) that
    moves a few samples lying within an ulp of a bin edge into the next
    bin."""
    v, f = bumpy_mesh
    kw = dict(num_shards=2, resolution=8, sample_num=3000)
    with jax.disable_jit():
        files_j = jax_create_gt(SPEC, v, f, str(tmp_path / "jax"),
                                key=jax.random.key(1), **kw)
    files_p = create_gt(SPEC, v, f, str(tmp_path / "port"), key=pt.key(1),
                        device="cpu", **kw)
    assert [os.path.basename(p) for p in files_p] == \
        [os.path.basename(p) for p in files_j]
    for a, b in zip(files_p, files_j):
        ma, mb = scipy.io.loadmat(a), scipy.io.loadmat(b)
        keys = sorted(k for k in mb if not k.startswith("__"))
        assert sorted(k for k in ma if not k.startswith("__")) == keys
        for k in keys:
            assert ma[k].shape == mb[k].shape, k
            if k != "gt_transient":
                np.testing.assert_array_equal(ma[k], mb[k], err_msg=k)
        np.testing.assert_allclose(ma["gt_transient"], mb["gt_transient"],
                                   rtol=2e-5, atol=1e-8)
        assert mb["gt_transient"].max() > 0


def test_create_gt_refuses_a_device_mesh(tmp_path, bumpy_mesh):
    v, f = bumpy_mesh
    with pytest.raises(NotImplementedError, match="queue 1, item 12"):
        create_gt(SPEC, v, f, str(tmp_path), dmesh=object(), device="cpu")


def test_synthetic_gt_mesh_matches_jax():
    """Without the asset, both runners stand the same height field in."""
    for a, b in zip(prun._load_gt_mesh(SPEC, None),
                    jrun._load_gt_mesh(SPEC, None)):
        np.testing.assert_array_equal(a, b)


def test_run_experiment_end_to_end(tmp_path):
    """The runner on the CPU: GT shards, LCT init, two loop iterations, a
    checkpoint per iteration."""
    meshes = tmp_path / "meshes"
    meshes.mkdir()
    v, f = _grid_mesh(8, lambda x, y: 0.5 + 0.04 * np.sin(6 * x))
    write_obj(str(meshes / SPEC.mesh_file), v, f)
    work = str(tmp_path / "run")
    logs = []
    state, hist = prun.run_experiment(
        "armadillo", work, max_iters=2, scan_resolution=8, sample_num=2000,
        gt_sample_num=2000, meshes=str(meshes), log=logs.append,
        device="cpu")
    assert len(hist["l2"]) == 2 and np.isfinite(hist["l2"]).all()
    assert np.isfinite(hist["v2"]).all()
    assert state.t == 2 and np.isfinite(state.v).all()
    assert sorted(os.listdir(os.path.join(work, "setup"))) == sorted(
        f"armadillo_transient_8_{i}.mat" for i in range(8))
    d = load_checkpoint(os.path.join(work, "progress", "00000.mat"))
    assert int(np.asarray(d["iteration"]).ravel()[0]) == 0
    assert any("init mesh" in m for m in logs)


def test_run_experiment_ggx_end_to_end(tmp_path):
    """The ggx scene on the CPU: GT shards rendered with GGX at the
    scene's roughness 0.2, equal to JAX's create_gt (jit off, as in
    test_create_gt_matches_jax) within its tolerance, then LCT init and
    two loop iterations (GGX at the loop's default roughness 0.1)."""
    spec = SCENES["ggx"]
    assert spec.brdf == "ggx" and spec.ggx_alpha == 0.2
    meshes = tmp_path / "meshes"
    meshes.mkdir()
    v, f = _grid_mesh(8, lambda x, y: 0.5 + 0.04 * np.sin(6 * x))
    write_obj(str(meshes / spec.mesh_file), v, f)
    work = str(tmp_path / "run")
    logs = []
    state, hist = prun.run_experiment(
        "ggx", work, max_iters=2, scan_resolution=8, sample_num=2000,
        gt_sample_num=2000, meshes=str(meshes), log=logs.append,
        device="cpu")
    assert len(hist["l2"]) == 2 and np.isfinite(hist["l2"]).all()
    assert np.isfinite(hist["v2"]).all()
    assert state.t == 2 and np.isfinite(state.v).all()
    assert any("init mesh" in m for m in logs)

    with jax.disable_jit():
        files_j = jax_create_gt(jrun.SCENES["ggx"], v, f,
                                str(tmp_path / "jax"), num_shards=8,
                                resolution=8, sample_num=2000,
                                key=jax.random.key(0))
    files_p = sorted(os.listdir(os.path.join(work, "setup")))
    assert files_p == sorted(os.path.basename(p) for p in files_j)
    lam = scipy.io.loadmat(create_gt(SCENES["armadillo"], v, f,
                                     str(tmp_path / "lam"), num_shards=8,
                                     resolution=8, sample_num=2000,
                                     key=pt.key(0), device="cpu")[3])
    for fj in files_j:
        got = scipy.io.loadmat(os.path.join(work, "setup",
                                            os.path.basename(fj)))
        want = scipy.io.loadmat(fj)
        np.testing.assert_allclose(got["gt_transient"], want["gt_transient"],
                                   rtol=2e-5, atol=1e-8)
        assert want["gt_transient"].max() > 0
    # the GGX GT is not the Lambertian one
    assert not np.allclose(got["gt_transient"], lam["gt_transient"])


@pytest.mark.parametrize("scene,what", [("noise", "queue 1, item 11")])
def test_unported_scenes_raise(tmp_path, scene, what):
    with pytest.raises(NotImplementedError, match=what):
        prun.run_experiment(scene, str(tmp_path), max_iters=1, device="cpu")
