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
from nlos_surface_optimization_tpu.recon import lct as jlct

import nlos_surface_optimization_torch as pt
from nlos_surface_optimization_torch.experiments import SCENES, create_gt
from nlos_surface_optimization_torch.experiments import run as prun
from nlos_surface_optimization_torch.io.mat import (
    load_checkpoint,
    load_real_capture,
)
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


def _splat_gt(v, f, res, spec):
    """A cheap stand-in for a scene's GT transients at its bins: each face
    centre's 1/d^4 cosine-weighted return, binned at path length 2d and
    blurred by a 2-bin Gaussian (no occlusion, no sampling)."""
    lighting, _ = nst.make_confocal_scan(res, lower=spec.scan_lower,
                                         upper=spec.scan_upper)
    tri = v[f].astype(np.float64)
    c = tri.mean(1)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area = np.linalg.norm(n, axis=1) / 2
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    w = c[None] - lighting[:, None].astype(np.float64)
    d = np.linalg.norm(w, axis=2)
    val = (area * np.clip(w[..., 2] / d, 0, None)
           * np.abs((n[None] * w).sum(-1)) / d / d ** 4)
    B = spec.num_bins
    b = np.minimum((2 * d / spec.distance_resolution).astype(np.int64), B - 1)
    rows = np.arange(res * res)[:, None] * B
    t = np.bincount((rows + b).ravel(), val.ravel(), res * res * B)
    k = np.exp(-0.5 * (np.arange(-6, 7) / 2.0) ** 2)
    t = np.apply_along_axis(np.convolve, 1, t.reshape(-1, B), k / k.sum(),
                            "same")
    return t.astype(np.float32), lighting


def _lct_input(case, tmp_path):
    """(transient [L, B] f32, width, bin resolution) of a case: the 's'
    stand-in capture downsampled to 8x8, or the armadillo scene's
    synthetic GT mesh at 16, 32 or 64."""
    if case == "s8":
        from test_torch_real import _standin_capture

        p = str(tmp_path / "transient.mat")
        _standin_capture(p)
        gt, lighting, _ = load_real_capture(p, downsample=8)
        res = SCENES["s"].distance_resolution
    else:
        n = int(case[len("armadillo"):])
        gt, lighting = _splat_gt(*prun._load_gt_mesh(SPEC, None), n, SPEC)
        res = SPEC.distance_resolution
    width = float((lighting[:, 0].max() - lighting[:, 0].min()) / 2)
    return gt, width, res


@pytest.mark.parametrize("case", [
    "s8", "armadillo16", "armadillo32",
    pytest.param("armadillo64", marks=pytest.mark.slow)])
def test_lct_matches_jax(case, tmp_path):
    """lct_reconstruct against JAX's with x64 off, as its runner runs it:
    the lateral and depth grids and the init mesh bit for bit, the
    albedo within 1e-6 of its max (torch.fft against XLA's FFT)."""
    gt, width, res = _lct_input(case, tmp_path)
    with jax.enable_x64(False):
        want = jlct.lct_reconstruct(gt, width=width, bin_resolution_m=res)
        thr = 0.25 * float(np.asarray(want.albedo).max())
        v_j, f_j = jlct.init_mesh_from_lct(want, threshold=thr)
    got = lct.lct_reconstruct(gt, width=width, bin_resolution_m=res,
                              device="cpu")
    for a, b in ((got.x, want.x), (got.y, want.y), (got.depth, want.depth)):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and b.dtype == np.float32
        np.testing.assert_array_equal(a.numpy().view(np.int32),
                                      b.view(np.int32))
    a_j = np.asarray(want.albedo)
    np.testing.assert_allclose(got.albedo.numpy(), a_j, rtol=0,
                               atol=1e-6 * a_j.max())
    v_p, f_p = lct.init_mesh_from_lct(got, threshold=0.25 * float(
        got.albedo.max()))
    assert f_p.shape[0] > 0
    np.testing.assert_array_equal(f_p, f_j)
    np.testing.assert_array_equal(v_p.view(np.int32), v_j.view(np.int32))


def _scan_widths(n):
    """The half-widths the runner takes from an n x n scan: the scenes'
    (+-0.25 and +-0.35 grids in float32) and, where n divides 64, the
    stand-in capture's downsampled one."""
    out = []
    for ext in (0.25, 0.35):
        lighting, _ = nst.make_confocal_scan(n, lower=(-ext, -ext),
                                             upper=(ext, ext))
        out.append(float((lighting[:, 0].max() - lighting[:, 0].min()) / 2))
    if 64 % n == 0:
        xs = np.linspace(-0.35, 0.35, 64)[::64 // n].astype(np.float32)
        out.append(float((xs.max() - xs.min()) / 2))
    return out


@pytest.mark.parametrize("n", range(2, 129))
def test_lct_lateral_grid_matches_jnp_linspace(n):
    """linspace_f32(-w, w, n) is jnp.linspace's with x64 off, bit for
    bit, at each width the runner gives an n x n scan."""
    with jax.enable_x64(False):
        for w in _scan_widths(n):
            want = np.asarray(jax.numpy.linspace(-w, w, n))
            got = lct.linspace_f32(-w, w, n)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32), err_msg=w)


@pytest.mark.parametrize("M,res", [(1200, 1.2e-3), (2048, 1.2e-3)])
def test_lct_depth_grids_match_jnp_linspace(M, res):
    """The depth grid (0 to M*res/2) and the radiometric grid (0 to 1)."""
    with jax.enable_x64(False):
        for stop in (M * res / 2.0, 1.0):
            want = np.asarray(jax.numpy.linspace(0.0, stop, M))
            got = lct.linspace_f32(0.0, stop, M)
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))


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

