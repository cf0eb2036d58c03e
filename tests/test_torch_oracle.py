"""The port's core renderer against the independent float64 NumPy oracle
(tests/oracle.py) on the same samples: the barycentric coordinates the
port's own sampler draws (geometry/sampling.py::stratified_barycoords).
The cases and tolerances are tests/test_render.py's for the JAX package.

The port renders in float32, the oracle in float64: a sample whose path
length lies within float32 rounding of a bin edge can land in the next
bin (or move a gradient tap there), as it does in the JAX package run in
float32 (measured: one sample of 38,400 in the plane's forward).  So
where the port misses the oracle at test_render.py's tolerance, the JAX
package in float32 (x64 off, op by op, its own sampler: the same samples)
must miss it at the same elements, and the port must agree with it there
at tests/test_torch_inverse.py's tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nlos_surface_optimization_tpu as nst
from nlos_surface_optimization_tpu.geometry import mesh as jmesh
from nlos_surface_optimization_tpu.render import inverse_render as jinverse
from nlos_surface_optimization_tpu.render import render_transient as jrender

import nlos_surface_optimization_torch as pt
from nlos_surface_optimization_torch.geometry.sampling import (
    stratified_barycoords,
)

import oracle

torch.set_num_threads(1)

KEY = 7


def _setup(vf, res=8, num_samples=600, num_bins=600, dres=5e-3, vn=None,
           **cfg_kw):
    v, f = vf
    mesh = pt.make_mesh(v, f, vn=vn, device="cpu")
    cfg = pt.RenderConfig(num_samples=num_samples, num_bins=num_bins,
                          distance_resolution=dres, **cfg_kw)
    lighting, lnormal = pt.make_confocal_scan(res)
    spt = cfg.samples_per_face(f.shape[0])
    bary = stratified_barycoords(pt.key(KEY), lighting.shape[0], f.shape[0],
                                 spt, device="cpu").numpy().astype(np.float64)
    return mesh, cfg, lighting, lnormal, bary


def _jax_f32(vf, cfg, lighting, lnormal, vn=None, data=None, weight=None,
             **kw):
    """The JAX package's float32 transient (data None) or vertex gradient
    on the same scene, x64 off and op by op."""
    jcfg = nst.RenderConfig(**{k: getattr(cfg, k) for k in (
        "num_samples", "num_bins", "distance_resolution", "sigma_bin",
        "bin_refine_resolution", "normal", "testing_flag", "loss_flag")})
    with jax.enable_x64(False), jax.disable_jit():
        m = jmesh.make_mesh(*vf, vn=vn)
        if data is None:
            return np.asarray(jrender(m, lighting, lnormal, jcfg,
                                      jax.random.key(KEY), **kw)[0])
        return np.asarray(jinverse(
            m, jnp.asarray(data, jnp.float32),
            jnp.asarray(weight, jnp.float32), lighting, lnormal, jcfg,
            jax.random.key(KEY))[1])


def _hold(got, want, jax32, rtol, atol, f32_rtol, f32_atol):
    """got within (rtol, atol) of the oracle, except where the JAX package
    in float32 misses it too; there got is within (f32_rtol, f32_atol) of
    JAX's."""
    bad = ~np.isclose(got, want, rtol=rtol, atol=atol)
    assert bad.sum() <= 0.01 * bad.size
    assert not np.isclose(jax32[bad], want[bad], rtol=rtol, atol=atol).any()
    np.testing.assert_allclose(got[bad], jax32[bad], rtol=f32_rtol,
                               atol=f32_atol)


def _oracle_forward(v, f, lighting, lnormal, bary, cfg, refine, **kw):
    return oracle.forward_transient(
        v.astype(np.float64), f, lighting.astype(np.float64),
        lnormal.astype(np.float64), bary, cfg.bin_lower,
        cfg.distance_resolution, cfg.num_bins, refine=refine, **kw)


def _oracle_gradient(v, f, lighting, lnormal, bary, diff, cfg, **kw):
    return oracle.vertex_gradient(
        v.astype(np.float64), f, lighting.astype(np.float64),
        lnormal.astype(np.float64), bary, diff, cfg.bin_lower,
        cfg.distance_resolution, cfg.num_bins, cfg.bin_refine_resolution,
        cfg.sigma_bin, **kw)


@pytest.mark.parametrize("scene", ["plane_mesh", "bumpy_mesh"])
def test_forward_matches_oracle(scene, request):
    v, f = request.getfixturevalue(scene)
    mesh, cfg, lighting, lnormal, bary = _setup((v, f))
    t, _ = pt.render_transient(mesh, lighting, lnormal, cfg, pt.key(KEY),
                               refine=1)
    t_ref = _oracle_forward(v, f, lighting, lnormal, bary, cfg, 1)
    _hold(t.numpy(), t_ref, _jax_f32((v, f), cfg, lighting, lnormal,
                                     refine=1), 2e-4, 1e-7, 2e-5, 1e-8)
    assert t_ref.sum() > 0


def test_forward_smoothed_matches_oracle(plane_mesh):
    """refine 4, sigma_bin 5."""
    v, f = plane_mesh
    mesh, cfg, lighting, lnormal, bary = _setup(
        (v, f), res=4, num_bins=300, sigma_bin=5, bin_refine_resolution=4)
    t, _ = pt.render_transient(mesh, lighting, lnormal, cfg, pt.key(KEY))
    t_ref = _oracle_forward(v, f, lighting, lnormal, bary, cfg, 4,
                            sigma_bin=5)
    np.testing.assert_allclose(t.numpy(), t_ref, rtol=2e-4, atol=1e-9)
    assert t_ref.sum() > 0


@pytest.mark.parametrize("scene", ["plane_mesh", "bumpy_mesh"])
def test_gradient_matches_oracle(scene, request):
    """'fn' shading; the difference of the raw transient scaled by
    1 + 0.2·U with weights 0.5 + U."""
    v, f = request.getfixturevalue(scene)
    mesh, cfg, lighting, lnormal, bary = _setup((v, f))
    rng = np.random.RandomState(3)
    t, _ = pt.render_transient(mesh, lighting, lnormal, cfg, pt.key(KEY),
                               refine=1)
    t = t.numpy().astype(np.float64)
    data = t * (1.0 + 0.2 * rng.rand(*t.shape))
    weight = 0.5 + rng.rand(*t.shape)
    _, g, _ = pt.inverse_render(mesh, data, weight, lighting, lnormal, cfg,
                                pt.key(KEY))
    # the port runs in f32: the oracle's difference is of the f32 inputs
    d32 = data.astype(np.float32).astype(np.float64)
    w32 = weight.astype(np.float32).astype(np.float64)
    g_ref = _oracle_gradient(v, f, lighting, lnormal, bary, (d32 - t) * w32,
                             cfg)
    scale = np.abs(g_ref).max()
    assert scale > 0
    _hold(g.numpy(), g_ref, _jax_f32((v, f), cfg, lighting, lnormal,
                                     data=data, weight=weight),
          5e-3, 2e-4 * scale, 2e-4, 1e-7)


def test_gradient_vn_matches_oracle(bumpy_mesh):
    """'vn' shading with the gn term (testing_flag 0)."""
    v, f = bumpy_mesh
    m0 = pt.make_mesh(v, f, device="cpu")
    vn = pt.vertex_normals(m0.v, m0.f, m0.f_valid).numpy()
    mesh, cfg, lighting, lnormal, bary = _setup(
        (v, f), res=6, vn=vn, normal="vn", testing_flag=0)
    t, _ = pt.render_transient(mesh, lighting, lnormal, cfg, pt.key(KEY),
                               refine=1)
    t = t.numpy().astype(np.float64)
    rng = np.random.RandomState(9)
    data = (t * (1 + 0.2 * rng.rand(*t.shape))).astype(np.float32)
    weight = np.ones_like(data)
    _, g, _ = pt.inverse_render(mesh, data, weight, lighting, lnormal, cfg,
                                pt.key(KEY))
    g_ref = _oracle_gradient(v, f, lighting, lnormal, bary,
                             data.astype(np.float64) - t, cfg,
                             vn=vn.astype(np.float64), testing_flag=0)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=5e-3,
                               atol=1e-6 * np.abs(g_ref).max())


def test_loss_flag_cubed_difference(plane_mesh):
    """loss_flag 1: the difference is 2·d³ before the weight."""
    v, f = plane_mesh
    mesh, cfg, lighting, lnormal, bary = _setup((v, f), res=4)
    t, _ = pt.render_transient(mesh, lighting, lnormal, cfg, pt.key(KEY),
                               refine=1)
    t = t.numpy().astype(np.float64)
    data = (t * 1.3).astype(np.float32)
    weight = np.ones_like(data)
    _, g, _ = pt.inverse_render(mesh, data, weight, lighting, lnormal,
                                cfg.replace(loss_flag=1), pt.key(KEY))
    d = data.astype(np.float64) - t
    g_ref = _oracle_gradient(v, f, lighting, lnormal, bary, 2 * d ** 3, cfg)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=5e-3,
                               atol=1e-5 * np.abs(g_ref).max())
