"""The port's measured-jitter path, legacy box-smoothed loss, per-bin
vertex-gradient diagnostic, shading-normal entry point and the small
loss/regularizer helpers against the JAX package's, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

import nlos_surface_optimization_tpu as nst
from nlos_surface_optimization_tpu.experiments import run as jrun
from nlos_surface_optimization_tpu.geometry import mesh as jmesh
from nlos_surface_optimization_tpu.io import mat as jmat
from nlos_surface_optimization_tpu.optim import loss as jloss
from nlos_surface_optimization_tpu.render import api as japi
from nlos_surface_optimization_tpu.render import kernels as jkernels
from nlos_surface_optimization_tpu.render import regularizers as jreg

import nlos_surface_optimization_torch as pt
from nlos_surface_optimization_torch.experiments import run as prun
from nlos_surface_optimization_torch.io.mat import load_jitter_calibration
from nlos_surface_optimization_torch.optim import loss as ploss
from nlos_surface_optimization_torch.render import api as papi
from nlos_surface_optimization_torch.render import kernels as pkernels
from nlos_surface_optimization_torch.render import regularizers as preg

torch.set_num_threads(1)

KEY = 13


def _setup(vf, res=6, **kw):
    v, f = vf
    base = dict(num_samples=500, num_bins=500, distance_resolution=5e-3)
    base.update(kw)
    lighting, lnormal = nst.make_confocal_scan(res)
    return (jmesh.make_mesh(v, f), pt.make_mesh(v, f, device="cpu"),
            nst.RenderConfig(**base), pt.RenderConfig(**base), lighting,
            lnormal)


def _kernel(K, seed):
    w = np.random.RandomState(seed).rand(K)
    return w / w.sum()


# ---------------------------------------------------------------- jitter


@pytest.mark.parametrize("K,offset", [(7, 3), (11, 0), (9, 8), (40, 12)])
def test_jitter_convolve_matches_jax(K, offset):
    """T[l,b] = sum_i w[i] * hist[l, b + offset - i] (K-term f32 sums in
    another order: rtol 1e-5 / atol 1e-6*max)."""
    hist = np.random.RandomState(K).rand(5, 64).astype(np.float32)
    w = _kernel(K, offset)
    want = np.asarray(jkernels.jitter_convolve(jnp.asarray(hist), w, offset))
    got = pkernels.jitter_convolve(torch.from_numpy(hist), w, offset).numpy()
    assert got.shape == (5, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * want.max())


def test_delta_kernel_equals_raw(bumpy_mesh):
    """A delta at the offset gives the raw (refine 1) render exactly."""
    _, pm, _, pcfg, lighting, lnormal = _setup(bumpy_mesh)
    t_raw, _ = pt.render_transient(pm, lighting, lnormal, pcfg, pt.key(KEY),
                                   refine=1)
    w = np.zeros(7)
    w[3] = 1.0
    t_jit, _ = pt.render_transient_jitter(pm, lighting, lnormal, pcfg,
                                          pt.key(KEY), w, 3)
    torch.testing.assert_close(t_jit, t_raw, rtol=0, atol=0)
    assert float(t_raw.max()) > 0


@pytest.mark.parametrize("source_chunk", [0, 10])
def test_render_transient_jitter_matches_jax(bumpy_mesh, source_chunk):
    jm, pm, jcfg, pcfg, lighting, lnormal = _setup(
        bumpy_mesh, source_chunk=source_chunk)
    w = _kernel(11, 2)
    t_j, _ = japi.render_transient_jitter(jm, lighting, lnormal, jcfg,
                                          jax.random.key(KEY), w, 4)
    t_p, path = pt.render_transient_jitter(pm, lighting, lnormal, pcfg,
                                           pt.key(KEY), w, 4)
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_j), rtol=2e-5,
                               atol=1e-8)
    assert path.shape == (500,)


@pytest.mark.parametrize("source_chunk,K,offset", [(0, 9, 4), (7, 31, 25)])
def test_inverse_render_jitter_matches_jax(bumpy_mesh, source_chunk, K,
                                           offset):
    """Transient and vertex gradient (rtol 2e-4 / atol 2e-5*max|g|, as the
    other vertex gradients)."""
    jm, pm, jcfg, pcfg, lighting, lnormal = _setup(
        bumpy_mesh, source_chunk=source_chunk)
    w = _kernel(K, 3)
    jg = np.gradient(w)
    rng = np.random.RandomState(3)
    t0, _ = pt.render_transient_jitter(pm, lighting, lnormal, pcfg,
                                       pt.key(KEY), w, offset)
    data = (t0.numpy() * (1 + 0.2 * rng.rand(*t0.shape))).astype(np.float32)
    weight = (0.5 + rng.rand(*data.shape)).astype(np.float32)
    t_j, g_j, _ = japi.inverse_render_jitter(
        jm, data, weight, lighting, lnormal, jcfg, jax.random.key(KEY), w,
        jg, offset)
    t_p, g_p, _ = pt.inverse_render_jitter(pm, data, weight, lighting,
                                           lnormal, pcfg, pt.key(KEY), w, jg,
                                           offset)
    torch.testing.assert_close(t_p, t0, rtol=0, atol=0)
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_j), rtol=2e-5,
                               atol=1e-8)
    scale = np.abs(np.asarray(g_j)).max()
    assert scale > 0
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_j), rtol=2e-4,
                               atol=2e-5 * scale)


def test_jitter_refuses_ggx(bumpy_mesh):
    """The JAX package's jitter path passes no roughness and fails for
    'ggx'; the port says so."""
    _, pm, _, pcfg, lighting, lnormal = _setup(bumpy_mesh, res=2)
    with pytest.raises(ValueError, match="lambertian"):
        pt.render_transient_jitter(pm, lighting, lnormal,
                                   pcfg.replace(brdf="ggx"), pt.key(0),
                                   np.ones(3) / 3, 1)


def test_load_jitter_calibration(tmp_path):
    rng = np.random.RandomState(4)
    w, g = rng.rand(901, 1), rng.randn(901, 1)
    path = str(tmp_path / "jitter_info.mat")
    scipy.io.savemat(path, {"jitter_weight": w, "jitter_grad": g,
                            "jitter_offset": np.array([[21]])})
    got = load_jitter_calibration(path)
    want = jmat.load_jitter_calibration(path)
    for a, b in zip(got[:2], want[:2]):
        assert a.shape == (901,) and a.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    assert got[2] == want[2] == 21 and isinstance(got[2], int)


def test_synthetic_jitter_calibration_matches_jax(tmp_path):
    got = prun._find_jitter_calibration(str(tmp_path))
    want = jrun._find_jitter_calibration(str(tmp_path))
    for a, b in zip(got, want):
        assert a.shape == (901,)
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------- legacy variant


def _oracle_box_smooth(diff, width):
    """The reference's double full convolution, windowed at width."""
    k = np.full(2 * width + 1, 1.0 / (2 * width + 1))
    out = np.empty_like(diff)
    for i, row in enumerate(diff):
        y = np.convolve(k, row, mode="full")
        y2 = np.convolve(k, y[width:width + row.shape[0]], mode="full")
        out[i] = y2[width:width + row.shape[0]]
    return out


@pytest.mark.parametrize("width", [0, 1, 3, 7])
def test_box_smooth_difference_matches_jax(width):
    """f32: against JAX (rtol 1e-5 / atol 1e-6) and the f64 oracle."""
    diff = np.random.RandomState(0).randn(5, 64).astype(np.float32)
    want = np.asarray(jkernels.box_smooth_difference(jnp.asarray(diff),
                                                     width))
    got = pkernels.box_smooth_difference(torch.from_numpy(diff),
                                         width).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if width == 0:
        np.testing.assert_array_equal(got, diff)
    else:
        np.testing.assert_allclose(got, _oracle_box_smooth(
            diff.astype(np.float64), width), rtol=1e-5, atol=1e-6)


def test_difference_applies_box_smoothing():
    rng = np.random.RandomState(1)
    data, tr, w = (rng.rand(4, 32).astype(np.float32) for _ in range(3))
    for cfg_kw in (dict(loss_smooth_width=2),
                   dict(loss_smooth_width=2, loss_flag=1)):
        want = np.asarray(japi._difference(
            jnp.asarray(data), jnp.asarray(tr), jnp.asarray(w),
            nst.RenderConfig(**cfg_kw)))
        got = papi._difference(torch.from_numpy(data), torch.from_numpy(tr),
                               torch.from_numpy(w),
                               pt.RenderConfig(**cfg_kw)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("loss_flag", [0, 1])
def test_inverse_render_with_loss_smooth_width_matches_jax(bumpy_mesh,
                                                           loss_flag):
    jm, pm, jcfg, pcfg, lighting, lnormal = _setup(
        bumpy_mesh, res=4, num_samples=400, num_bins=300,
        loss_smooth_width=2, loss_flag=loss_flag, source_chunk=6)
    data = (np.random.RandomState(1).rand(16, 300) * 1e-3).astype(np.float32)
    w = np.ones((16, 300), np.float32)
    t_j, g_j, _ = japi.inverse_render(jm, jnp.asarray(data), jnp.asarray(w),
                                      lighting, lnormal, jcfg,
                                      jax.random.key(3))
    t_p, g_p, _ = pt.inverse_render(pm, data, w, lighting, lnormal, pcfg,
                                    pt.key(3))
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_j), rtol=2e-5,
                               atol=1e-8)
    scale = np.abs(np.asarray(g_j)).max()
    assert scale > 0
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_j), rtol=2e-4,
                               atol=2e-5 * scale)
    # the smoothing is live: without it the gradient differs
    _, g_0, _ = pt.inverse_render(pm, data, w, lighting, lnormal,
                                  pcfg.replace(loss_smooth_width=0),
                                  pt.key(3))
    assert float((g_0 - g_p).abs().max()) > 1e-2 * float(g_p.abs().max())


# --------------------------------------- per-bin diagnostic and shading


@pytest.mark.parametrize("vertex_num,normal", [(14, "fn"), (0, "fn"),
                                               (20, "vn")])
def test_vertex_gradient_bins_matches_jax(bumpy_mesh, vertex_num, normal):
    """[B,3] per-bin gradient of one vertex (a corner: vertex 0), summed
    over chunks: rtol 2e-4 / atol 2e-5*max."""
    jm, pm, jcfg, pcfg, lighting, lnormal = _setup(
        bumpy_mesh, res=4, num_samples=400, num_bins=300, source_chunk=5,
        normal=normal)
    if normal == "vn":
        jm = jm._replace(vn=jmesh.vertex_normals(jm.v, jm.f, jm.f_valid))
        pm = pm._replace(vn=pt.vertex_normals(pm.v, pm.f, pm.f_valid))
    want = np.asarray(japi.vertex_gradient_bins(
        jm, lighting, lnormal, jcfg, jax.random.key(3), vertex_num))
    got = pt.vertex_gradient_bins(pm, lighting, lnormal, pcfg, pt.key(3),
                                  vertex_num)
    assert got.shape == (300, 3)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                               atol=2e-5 * scale)


def test_inverse_shading_render_matches_jax(bumpy_mesh):
    jm, pm, jcfg, pcfg, lighting, lnormal = _setup(
        bumpy_mesh, res=4, num_samples=400, num_bins=400, testing_flag=0,
        source_chunk=8)
    data = (np.random.RandomState(2).rand(16, 400) * 1e-3).astype(np.float32)
    w = np.ones_like(data)
    t_j, g_j, _ = japi.inverse_shading_render(jm, jnp.asarray(data),
                                              jnp.asarray(w), lighting,
                                              lnormal, jcfg, jax.random.key(3))
    t_p, g_p, _ = pt.inverse_shading_render(pm, data, w, lighting, lnormal,
                                            pcfg, pt.key(3))
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_j), rtol=2e-5,
                               atol=1e-8)
    scale = np.abs(np.asarray(g_j)).max()
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_j), rtol=2e-4,
                               atol=2e-5 * scale)
    # the same as inverse_render with fresh vertex normals and 'vn'
    pm_vn = pm._replace(vn=pt.vertex_normals(pm.v, pm.f, pm.f_valid))
    t_2, g_2, _ = pt.inverse_render(pm_vn, data, w, lighting, lnormal,
                                    pcfg.replace(normal="vn"), pt.key(3))
    torch.testing.assert_close(t_p, t_2, rtol=0, atol=0)
    torch.testing.assert_close(g_p, g_2, rtol=0, atol=0)


# ----------------------------------------------- loss and regularizers


def _grid(n=6, seed=5):
    xs = np.linspace(-0.2, 0.2, n)
    gx, gy = np.meshgrid(xs, xs)
    z = 0.5 + 0.03 * np.random.RandomState(seed).randn(n, n)
    return np.stack([gx.ravel(), gy.ravel(), z.ravel()], 1), (n, n)


@pytest.mark.parametrize("name", ["smooth_grad", "smooth_grad_first_order"])
@pytest.mark.parametrize("shape", [(6, 6), (5, 7)])
def test_smooth_grads_match_jax_and_autograd(name, shape):
    """Bit for bit against JAX (the same f64 stencils in the same order),
    and the gradient of its energy through torch.autograd."""
    v, _ = _grid(max(shape))
    v = v[:shape[0] * shape[1]]
    want = np.asarray(getattr(jloss, name)(jnp.asarray(v), shape, 0.7))
    got = getattr(ploss, name)(torch.from_numpy(v), shape, 0.7)
    np.testing.assert_array_equal(got.numpy(), want)

    z = torch.from_numpy(v[:, 2].copy()).requires_grad_(True)
    s = z.reshape(shape)
    if name == "smooth_grad":
        dx = 2 * s[:, 1:-1] - s[:, :-2] - s[:, 2:]
        dy = 2 * s[1:-1, :] - s[:-2, :] - s[2:, :]
    else:
        dx, dy = s[:, 1:] - s[:, :-1], s[1:, :] - s[:-1, :]
    (g,) = torch.autograd.grad(0.35 * ((dx * dx).sum() + (dy * dy).sum()), z)
    torch.testing.assert_close(got[:, 2], g, rtol=1e-10, atol=1e-12)
    assert (got[:, :2] == 0).all()


def test_evaluate_loss_with_curvature_matches_jax(bumpy_mesh):
    v, f = bumpy_mesh
    rng = np.random.RandomState(6)
    gt, t, w = (rng.rand(9, 40).astype(np.float32) for _ in range(3))
    area_j = jreg.total_area(*jmesh.make_mesh(v, f)[:3])
    pm = pt.make_mesh(v, f, device="cpu")
    area_p = preg.total_area(pm.v, pm.f, pm.f_valid)
    np.testing.assert_allclose(float(area_p), float(area_j), rtol=1e-6)
    want = jloss.evaluate_loss_with_curvature(gt, w, t, area_j, 0.3)
    got = ploss.evaluate_loss_with_curvature(
        torch.from_numpy(gt), torch.from_numpy(w), torch.from_numpy(t),
        area_p, 0.3)
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


def test_mesh_regularizer_wrappers_match_jax(bumpy_mesh):
    from nlos_surface_optimization_tpu.geometry import topology as jtopo

    v, f = bumpy_mesh
    jm, pm = jmesh.make_mesh(v, f), pt.make_mesh(v, f, device="cpu")
    aff = jtopo.face_affinity(f)
    np.testing.assert_allclose(preg.curvature_gradient_mesh(pm).numpy(),
                               np.asarray(jreg.curvature_gradient_mesh(jm)),
                               rtol=1e-5, atol=1e-7)
    (sv, sg), (jv, jg) = (preg.normal_smoothing_mesh(pm, aff),
                          jreg.normal_smoothing_mesh(jm, jnp.asarray(aff)))
    np.testing.assert_allclose(float(sv), float(jv), rtol=1e-4)
    np.testing.assert_allclose(sg.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-6)
