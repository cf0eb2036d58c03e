"""The port's GGX BRDF, albedo and roughness gradients, autograd twin and
material estimation (render/brdf.py, render/autograd_twin.py,
optim/material.py) against the JAX package's, on the CPU."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nlos_surface_optimization_tpu as nst
from nlos_surface_optimization_tpu.geometry import mesh as jmesh
from nlos_surface_optimization_tpu.optim import material as jmaterial
from nlos_surface_optimization_tpu.render import brdf as jbrdf
from nlos_surface_optimization_tpu.render import inverse_render as jinverse
from nlos_surface_optimization_tpu.render import (
    inverse_render_albedo as jinverse_albedo,
)
from nlos_surface_optimization_tpu.render import (
    inverse_render_alpha as jinverse_alpha,
)
from nlos_surface_optimization_tpu.render import render_transient as jrender
from nlos_surface_optimization_tpu.render import (
    transient_loss_and_grad as jloss_and_grad,
)

import nlos_surface_optimization_torch as pt
from nlos_surface_optimization_torch.optim import material
from nlos_surface_optimization_torch.render import brdf
from nlos_surface_optimization_torch.render.autograd_twin import (
    twin_transient,
    twin_transient_from_rays,
)
from nlos_surface_optimization_torch.render.core import (
    backward_chunk,
    trace_chunk,
)

torch.set_num_threads(1)

KEY = 3


def _cfgs(**kw):
    base = dict(num_samples=400, num_bins=300, distance_resolution=5e-3,
                brdf="ggx")
    base.update(kw)
    return nst.RenderConfig(**base), pt.RenderConfig(**base)


def _meshes(v, f, normal="fn"):
    jm = jmesh.make_mesh(v, f)
    pm = pt.make_mesh(v, f, device="cpu")
    if normal == "vn":
        jm = jm._replace(vn=jmesh.vertex_normals(jm.v, jm.f, jm.f_valid))
        pm = pm._replace(vn=pt.vertex_normals(pm.v, pm.f, pm.f_valid))
    return jm, pm


def _data(L=16, B=300, seed=1):
    data = (np.random.RandomState(seed).rand(L, B) * 1e-3).astype(np.float32)
    return data, np.ones((L, B), np.float32)


# ------------------------------------------------------------------ brdf

_C = np.concatenate([np.linspace(-1.2, 1.2, 481),
                     [0.0, 1.0, -1.0]]).astype(np.float32)


@pytest.mark.parametrize("fn", ["eval_scalar", "eval_adiff", "eval_cdiff"])
@pytest.mark.parametrize("alpha", [0.05, 0.2, 0.5, 1.0])
def test_brdf_matches_jax(fn, alpha):
    """On a grid of c in [-1.2, 1.2] with 0 and +-1 exactly, at an f32
    alpha: bit for bit (the same f32 operations in the same order)."""
    want = np.asarray(getattr(jbrdf, fn)(jnp.float32(alpha),
                                         jnp.asarray(_C)))
    got = getattr(brdf, fn)(torch.tensor(alpha, dtype=torch.float32),
                            torch.from_numpy(_C)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if fn == "eval_scalar":
        assert (got[_C <= 0] == 0).all() and (got[_C > 0] > 0).any()


def test_brdf_python_alpha_rounding():
    """A Python 0.2 inside a jitted JAX call (as create_gt passes it) is a
    weakly typed f64: JAX forms alpha*alpha and pi*alpha^2 in f64 and
    rounds at the first product with the f32 cosine; the port rounds
    alpha to f32 first.  For c in [-1, 1] (every unit shading normal) the
    two differ by a few f32 ulps (rtol 1e-6); past 1, where 1 - c^2
    cancels, by up to 4.1e-6 (rtol 5e-6)."""
    want = np.asarray(jax.jit(jbrdf.eval_scalar)(0.2, jnp.asarray(_C)))
    got = brdf.eval_scalar(torch.tensor(0.2, dtype=torch.float32),
                           torch.from_numpy(_C)).numpy()
    unit = np.abs(_C) <= 1.0
    np.testing.assert_allclose(got[unit], want[unit], rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, want, rtol=5e-6, atol=0)


# ------------------------------------------------------------ GGX render


@pytest.mark.parametrize("refine", [None, 1])
def test_ggx_render_transient_matches_jax(bumpy_mesh, refine):
    v, f = bumpy_mesh
    jcfg, pcfg = _cfgs(source_chunk=7)
    jm, pm = _meshes(v, f)
    lighting, lnormal = nst.make_confocal_scan(4)
    t_j, _ = jrender(jm, lighting, lnormal, jcfg, jax.random.key(KEY),
                     refine=refine, alpha=jnp.float32(0.3))
    t_p, _ = pt.render_transient(pm, lighting, lnormal, pcfg, pt.key(KEY),
                                 refine=refine, alpha=0.3)
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_j), rtol=2e-5,
                               atol=1e-8)
    assert float(t_p.max()) > 0
    # the default roughness is 0.1, as in the JAX package
    t_d, _ = pt.render_transient(pm, lighting, lnormal, pcfg, pt.key(KEY),
                                 refine=refine)
    t_01, _ = pt.render_transient(pm, lighting, lnormal, pcfg, pt.key(KEY),
                                  refine=refine, alpha=0.1)
    torch.testing.assert_close(t_d, t_01, rtol=0, atol=0)


@pytest.mark.parametrize("normal,testing_flag,compat", [
    ("fn", 1, False), ("fn", 1, True), ("vn", 0, False), ("vn", 0, True),
    ("vn", 1, False)])
def test_ggx_inverse_render_matches_jax(bumpy_mesh, normal, testing_flag,
                                        compat):
    """The GGX vertex gradient (eager backward: the fused backward is
    Lambertian) at test_bwd_kernel's tolerance, rtol 2e-4 / atol
    2e-5*max|g|; the gn term in 'vn' with testing_flag 0."""
    v, f = bumpy_mesh
    jcfg, pcfg = _cfgs(source_chunk=5, normal=normal,
                       testing_flag=testing_flag, ggx_compat_dx=compat)
    jm, pm = _meshes(v, f, normal)
    lighting, lnormal = nst.make_confocal_scan(4)
    data, w = _data()
    t_j, g_j, _ = jinverse(jm, jnp.asarray(data), jnp.asarray(w), lighting,
                           lnormal, jcfg, jax.random.key(KEY),
                           alpha=jnp.float32(0.25))
    t_p, g_p, _ = pt.inverse_render(pm, data, w, lighting, lnormal, pcfg,
                                    pt.key(KEY), alpha=0.25)
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_j), rtol=2e-5,
                               atol=1e-8)
    scale = np.abs(np.asarray(g_j)).max()
    assert scale > 1e-4
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_j), rtol=2e-4,
                               atol=2e-5 * scale)


def test_ggx_compat_dx_changes_the_gradient(bumpy_mesh):
    """The two brdf_dx forms give different gradients (the option is
    live), and the same transient."""
    v, f = bumpy_mesh
    _, pm = _meshes(v, f)
    lighting, lnormal = pt.make_confocal_scan(4)
    data, w = _data()
    out = [pt.inverse_render(pm, data, w, lighting, lnormal,
                             _cfgs(ggx_compat_dx=c)[1], pt.key(KEY))
           for c in (False, True)]
    torch.testing.assert_close(out[0][0], out[1][0], rtol=0, atol=0)
    assert float((out[0][1] - out[1][1]).abs().max()) > 1e-3 * float(
        out[0][1].abs().max())


def test_transient_loss_and_grad_matches_jax(bumpy_mesh):
    v, f = bumpy_mesh
    jcfg, pcfg = _cfgs(source_chunk=8)
    jm, pm = _meshes(v, f)
    lighting, lnormal = nst.make_confocal_scan(4)
    data, _ = _data()
    w = (0.5 + np.random.RandomState(2).rand(16, 300)).astype(np.float32)
    l_j, t_j, g_j = jloss_and_grad(jm, jnp.asarray(data), jnp.asarray(w),
                                   lighting, lnormal, jcfg,
                                   jax.random.key(KEY))
    l_p, t_p, g_p = pt.transient_loss_and_grad(pm, data, w, lighting,
                                               lnormal, pcfg, pt.key(KEY))
    # f32 sums over 4,800 bins in another order
    np.testing.assert_allclose(float(l_p), float(l_j), rtol=5e-5)
    scale = np.abs(np.asarray(g_j)).max()
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_j), rtol=2e-4,
                               atol=2e-5 * scale)


# ------------------------------------------------ albedo and roughness


@pytest.mark.parametrize("source_chunk", [0, 6])
def test_inverse_render_albedo_matches_jax(bumpy_mesh, source_chunk):
    v, f = bumpy_mesh
    jcfg, pcfg = _cfgs(brdf="lambertian", source_chunk=source_chunk)
    jm, pm = _meshes(v, f)
    lighting, lnormal = nst.make_confocal_scan(4)
    data, w = _data()
    t_j, g_j = jinverse_albedo(jm, jnp.asarray(data), jnp.asarray(w),
                               lighting, lnormal, jcfg, jax.random.key(KEY))
    t_p, g_p = pt.inverse_render_albedo(pm, data, w, lighting, lnormal, pcfg,
                                        pt.key(KEY))
    assert g_p.shape == ()
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_j), rtol=2e-5,
                               atol=1e-8)
    np.testing.assert_allclose(float(g_p), float(g_j), rtol=1e-5)
    assert abs(float(g_j)) > 0


def test_inverse_render_albedo_refuses_ggx(bumpy_mesh):
    """JAX's albedo mode fails inside for 'ggx' (no roughness reaches its
    gradient terms); the port says so."""
    v, f = bumpy_mesh
    _, pm = _meshes(v, f)
    lighting, lnormal = pt.make_confocal_scan(2)
    data, w = _data(4)
    with pytest.raises(ValueError, match="lambertian"):
        pt.inverse_render_albedo(pm, data, w, lighting, lnormal, _cfgs()[1],
                                 pt.key(0))


@pytest.mark.parametrize("alpha,normal", [(0.2, "fn"), (0.45, "vn")])
def test_inverse_render_alpha_matches_jax(bumpy_mesh, alpha, normal):
    v, f = bumpy_mesh
    jcfg, pcfg = _cfgs(source_chunk=5, normal=normal)
    jm, pm = _meshes(v, f, normal)
    lighting, lnormal = nst.make_confocal_scan(4)
    data, w = _data()
    t_j, g_j = jinverse_alpha(jm, jnp.asarray(data), jnp.asarray(w),
                              lighting, lnormal, jcfg, jax.random.key(KEY),
                              jnp.float32(alpha))
    t_p, g_p = pt.inverse_render_alpha(pm, data, w, lighting, lnormal, pcfg,
                                       pt.key(KEY), alpha)
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_j), rtol=2e-5,
                               atol=1e-8)
    np.testing.assert_allclose(float(g_p), float(g_j), rtol=1e-5)
    assert abs(float(g_j)) > 0


# ------------------------------------------------------------ the twin


def _twin_compare(v, f, cfg, alpha=None, rtol=1e-2):
    """torch.autograd through the twin against the analytic backward on a
    linear functional sum(ct * T): ct = -2*difference.  In f64, as
    test_twin_gradient.py."""
    mesh = pt.make_mesh(v, f, device="cpu", dtype=np.float64)
    lighting, lnormal = (torch.from_numpy(x.astype(np.float64))
                         for x in pt.make_confocal_scan(4))
    spt = cfg.samples_per_face(f.shape[0])
    rays = trace_chunk(mesh, lighting, lnormal, pt.key(11), cfg, spt)
    ct = torch.from_numpy(np.random.RandomState(5).randn(16, cfg.num_bins))
    vv = mesh.v.clone().requires_grad_(True)
    t = twin_transient_from_rays(vv, mesh._replace(v=vv), rays, lighting,
                                 lnormal, cfg, spt, alpha=alpha)
    (g_twin,) = torch.autograd.grad((ct * t).sum(), vv)
    g_an = backward_chunk(rays, mesh, lnormal, -ct / 2.0, 0, cfg, spt,
                          alpha=alpha)
    gt, ga = g_twin[:v.shape[0]], g_an[:v.shape[0]]
    denom = float(torch.linalg.norm(gt))
    assert denom > 0 and bool(torch.isfinite(ga).all())
    assert float(torch.linalg.norm(ga - gt)) / denom < rtol


def _twin_cfg(**kw):
    base = dict(num_samples=300, num_bins=200, distance_resolution=8e-3,
                sigma_bin=5, bin_refine_resolution=10)
    base.update(kw)
    return pt.RenderConfig(**base)


def test_twin_plane_fn(plane_mesh):
    _twin_compare(*plane_mesh, _twin_cfg())


def test_twin_bumpy_fn(bumpy_mesh):
    _twin_compare(*bumpy_mesh, _twin_cfg(num_samples=800))


def test_twin_ggx(bumpy_mesh):
    _twin_compare(*bumpy_mesh, _twin_cfg(num_samples=800, brdf="ggx"),
                  alpha=torch.tensor(0.3, dtype=torch.float64), rtol=2e-2)


@pytest.mark.parametrize("detach", [False, True])
def test_twin_gradient_matches_jax_and_fd(plane_mesh, detach):
    """Mirror of test_render.py::test_gradient_finite_difference in f64:
    the twin's autograd gradient with the shading normal detached or not
    equals jax.grad of JAX's twin on the same rays (rtol 1e-9, the same
    f64 operations summed in another order).  Not detached it is the true
    gradient: central differences of the loss agree (rtol 1e-4), and the
    analytic gradient, which omits d(normal)/dv in 'fn', points the same
    way (cosine > 0.9, norm ratio in (0.5, 2))."""
    from nlos_surface_optimization_tpu.render.autograd_twin import (
        twin_transient_from_rays as jtwin,
    )
    from nlos_surface_optimization_tpu.render.core import (
        trace_chunk as jtrace,
    )

    v, f = plane_mesh
    v = v.astype(np.float64)
    kw = dict(num_samples=400, num_bins=150, distance_resolution=1e-2,
              sigma_bin=5, bin_refine_resolution=4)
    jcfg, pcfg = nst.RenderConfig(**kw), pt.RenderConfig(**kw)
    lighting, lnormal = (x.astype(np.float64)
                         for x in nst.make_confocal_scan(4))
    spt = pcfg.samples_per_face(f.shape[0])
    jm = jmesh.make_mesh(v, f, dtype=np.float64)
    pm = pt.make_mesh(v, f, device="cpu", dtype=np.float64)
    jl, jn = jnp.asarray(lighting), jnp.asarray(lnormal)
    pl, pn = torch.from_numpy(lighting), torch.from_numpy(lnormal)
    jrays = jtrace(jm, jl, jn, jax.random.key(KEY), jcfg, spt)
    prays = trace_chunk(pm, pl, pn, pt.key(KEY), pcfg, spt)
    # the production renders are f32
    pm32 = pt.make_mesh(plane_mesh[0], f, device="cpu")
    t_ref, _ = pt.render_transient(pm32, lighting, lnormal, pcfg, pt.key(KEY))
    data = t_ref.numpy() * (1 + 0.3 * np.random.RandomState(0).rand(
        *t_ref.shape))

    def jloss(vv):
        t = jtwin(vv, jm._replace(v=vv), jrays, jl, jn, jcfg, spt,
                  detach_normal=detach)
        return jnp.sum((jnp.asarray(data) - t) ** 2)

    def ploss(vv):
        t = twin_transient_from_rays(vv, pm._replace(v=vv), prays, pl, pn,
                                     pcfg, spt, detach_normal=detach)
        return ((torch.from_numpy(data) - t) ** 2).sum()

    want = np.asarray(jax.grad(jloss)(jm.v))
    vv = pm.v.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(ploss(vv), vv)
    got = got.numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-9,
                               atol=1e-12 * np.abs(want).max())
    if detach:
        return
    eps = 1e-5
    checks = [(0, 2), (1, 2), (3, 2), (0, 0), (2, 1)]
    fd, an = np.zeros(len(checks)), np.zeros(len(checks))
    for i, (vi, ci) in enumerate(checks):
        vp, vm = pm.v.clone(), pm.v.clone()
        vp[vi, ci] += eps
        vm[vi, ci] -= eps
        fd[i] = (float(ploss(vp)) - float(ploss(vm))) / (2 * eps)
        an[i] = got[vi, ci]
    np.testing.assert_allclose(an, fd, rtol=1e-4, atol=1e-8 * np.abs(fd).max())
    _, g, _ = pt.inverse_render(pm32, data, np.ones_like(data), lighting,
                                lnormal, pcfg, pt.key(KEY))
    g_an = g.numpy()[:v.shape[0]] * lighting.shape[0]
    gt = got[:v.shape[0]]
    cos = np.sum(g_an * gt) / (np.linalg.norm(g_an) * np.linalg.norm(gt))
    assert cos > 0.9, cos
    assert 0.5 < np.linalg.norm(g_an) / np.linalg.norm(gt) < 2.0


def test_twin_transient_matches_jax(bumpy_mesh):
    """The twin's forward against JAX's on the same rays (f32)."""
    from nlos_surface_optimization_tpu.render.autograd_twin import (
        twin_transient as jtwin,
    )

    v, f = bumpy_mesh
    jcfg = nst.RenderConfig(**dict(num_samples=300, num_bins=200,
                                   distance_resolution=8e-3, sigma_bin=5,
                                   brdf="ggx"))
    pcfg = _twin_cfg(brdf="ggx")
    jm, pm = _meshes(v, f)
    lighting, lnormal = nst.make_confocal_scan(4)
    want = np.asarray(jtwin(jm, jnp.asarray(lighting), jnp.asarray(lnormal),
                            jcfg, jax.random.key(KEY), alpha=jnp.float32(0.3)))
    got = twin_transient(pm, torch.from_numpy(lighting),
                         torch.from_numpy(lnormal), pcfg, pt.key(KEY),
                         alpha=0.3)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-6 * np.abs(want).max())


# ------------------------------------------------- material estimation

MKEY = 31


def _scene(bumpy_mesh, brdf_="lambertian"):
    v, f = bumpy_mesh
    mesh = pt.make_mesh(v, f, device="cpu")
    cfg = pt.RenderConfig(num_samples=800, num_bins=400,
                          distance_resolution=5e-3, brdf=brdf_)
    lighting, lnormal = pt.make_confocal_scan(5)
    return mesh, cfg, lighting, lnormal


def test_initial_fitting_albedo_recovers_scale(bumpy_mesh):
    mesh, cfg, lighting, lnormal = _scene(bumpy_mesh)
    gt, _ = pt.render_transient(material._with_albedo(mesh, 0.37), lighting,
                                lnormal, cfg, pt.key(MKEY), refine=1)
    a0 = material.initial_fitting_albedo(mesh, gt.numpy(), lighting, lnormal,
                                         cfg, pt.key(MKEY))
    np.testing.assert_allclose(a0, 0.37, rtol=1e-6)
    # and the same projection as the JAX package's on the same GT
    v, f = bumpy_mesh
    a_j = jmaterial.initial_fitting_albedo(
        jmesh.make_mesh(v, f), gt.numpy(), lighting, lnormal,
        nst.RenderConfig(num_samples=800, num_bins=400,
                         distance_resolution=5e-3), jax.random.key(MKEY))
    np.testing.assert_allclose(a0, a_j, rtol=1e-5)


def test_optimize_albedo_descends(bumpy_mesh):
    mesh, cfg, lighting, lnormal = _scene(bumpy_mesh)
    gt, _ = pt.render_transient(material._with_albedo(mesh, 0.6), lighting,
                                lnormal, cfg, pt.key(MKEY), refine=1)
    a, losses = material.optimize_albedo(
        mesh, gt, torch.ones_like(gt), lighting, lnormal, cfg, pt.key(MKEY),
        albedo0=0.2, lr=5e-2, T=30, loss_epsilon=1e-7, log=lambda s: None)
    assert abs(a - 0.6) < 0.1, a
    assert losses[-1] < losses[0]


def test_optimize_alpha_descends(bumpy_mesh):
    mesh, cfg, lighting, lnormal = _scene(bumpy_mesh, "ggx")
    gt, _ = pt.render_transient(mesh, lighting, lnormal, cfg, pt.key(MKEY),
                                refine=1, alpha=0.3)
    a, losses = material.optimize_alpha(
        mesh, gt, torch.ones_like(gt), lighting, lnormal, cfg, pt.key(MKEY),
        alpha0=0.6, lr=3e-2, T=40, loss_epsilon=1e-8, log=lambda s: None)
    assert abs(a - 0.3) < 0.1, a
    assert losses[-1] < losses[0]


def test_optimize_alpha_refuses_lambertian(bumpy_mesh):
    mesh, cfg, lighting, lnormal = _scene(bumpy_mesh)
    with pytest.raises(ValueError, match="ggx"):
        material.optimize_alpha(mesh, np.zeros((25, 400)),
                                np.ones((25, 400)), lighting, lnormal, cfg,
                                pt.key(0), 0.5, T=1)


def test_optimize_shape_descends(bumpy_mesh):
    mesh, cfg, lighting, lnormal = _scene(bumpy_mesh, "ggx")
    gt, _ = pt.render_transient(mesh, lighting, lnormal, cfg, pt.key(MKEY),
                                alpha=0.2)
    v0 = mesh.v.clone()
    v0[:, 2] += 0.008
    k = pt.geometry.sampling.fold_in(pt.key(MKEY), torch.tensor([1]))[0]
    m2, plateaued, l2_final, losses = material.optimize_shape(
        mesh._replace(v=v0), gt, torch.ones_like(gt), lighting, lnormal, cfg,
        k, lr=2e-3, T=10, loss_epsilon=1e-9, alpha=0.2, log=lambda s: None)
    assert np.isfinite(l2_final)
    assert losses[-1] < losses[0]
    assert float((m2.v - v0).abs().sum()) > 0


def _trajectory(lines):
    return [float(m.group(1)) for m in
            (re.search(r"value (\S+)$", s) for s in lines) if m]


def test_optimize_alpha_tracks_jax(bumpy_mesh):
    """The first 3 scalar-Adam steps of optimize_alpha with one key: the
    same draws (fold_in(key, t)) give the same alpha trajectory within
    1e-5.  The losses agree within 1e-3: each is the squared residual of
    a fit near its GT, so the transients' f32 differences (2e-5 of a bin)
    weigh more in it."""
    v, f = bumpy_mesh
    lighting, lnormal = pt.make_confocal_scan(5)
    cfg_kw = dict(num_samples=800, num_bins=400, distance_resolution=5e-3,
                  brdf="ggx")
    gt_j, _ = jrender(jmesh.make_mesh(v, f), lighting, lnormal,
                      nst.RenderConfig(**cfg_kw), jax.random.key(7),
                      refine=1, alpha=jnp.float32(0.3))
    gt = np.asarray(gt_j, np.float32)
    w = np.ones_like(gt)
    log_j, log_p = [], []
    a_j, l_j = jmaterial.optimize_alpha(
        jmesh.make_mesh(v, f), gt, w, lighting, lnormal,
        nst.RenderConfig(**cfg_kw), jax.random.key(MKEY), alpha0=0.6,
        lr=3e-2, T=3, log=log_j.append)
    a_p, l_p = material.optimize_alpha(
        pt.make_mesh(v, f, device="cpu"), gt, w, lighting, lnormal,
        pt.RenderConfig(**cfg_kw), pt.key(MKEY), alpha0=0.6, lr=3e-2, T=3,
        log=log_p.append)
    assert len(log_p) == len(log_j) == 3
    np.testing.assert_allclose(_trajectory(log_p), _trajectory(log_j),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(a_p, a_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(l_p, l_j, rtol=1e-3)
    assert a_p < 0.6
