"""The port's non-confocal renderer (render/nonconfocal.py) against the JAX
package's, on the CPU.

JAX runs at x64 off, as its runner does (under the conftest's x64 its
draws are float64), except in the float64 oracle case.  On the CPU the
shadow rays go through K3's plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nlos_surface_optimization_tpu as nst
from nlos_surface_optimization_tpu.geometry.mesh import make_mesh as jmake
from nlos_surface_optimization_tpu.render import nonconfocal as jnc
from test_nonconfocal import _oracle

import nlos_surface_optimization_torch as pt
from nlos_surface_optimization_torch.geometry import intersect, sampling
from nlos_surface_optimization_torch.render import nonconfocal as nc

torch.set_num_threads(1)

SEED = 41
LIGHT = np.array([0.05, 0.0, 0.0], np.float32)
SENSOR = np.array([-0.05, 0.02, 0.0], np.float32)
UP = np.array([0.0, 0.0, 1.0], np.float32)
# one ulp at 1.0: the float32 sin and cos of XLA and the correctly rounded
# ones the port takes differ by an ulp in a few per cent of values
DIR_ATOL = 2.0 ** -23


def _pairs(L=4):
    lighting = np.array([[0.1 * i - 0.15, 0.0, 0.0] for i in range(L)],
                        np.float32)
    sensors = (lighting + np.array([0.02, 0.01, 0.0])).astype(np.float32)
    return lighting, sensors, np.tile(UP, (L, 1))


def _cfgs(**kw):
    kw = dict(num_samples=300, num_bins=300, distance_resolution=6e-3, **kw)
    return nst.RenderConfig(**kw), pt.RenderConfig(**kw)


def _jax_dirs(n, normal=UP):
    with jax.enable_x64(False):
        return np.array(jnc.hemisphere_directions(
            jax.random.key(SEED), n, jnp.asarray(normal, jnp.float32)))


def test_angular_matches_oracle(bumpy_mesh):
    """The port in float64 on JAX's float64 directions against the loop
    oracle of tests/test_nonconfocal.py, at that test's tolerance."""
    v, f = bumpy_mesh
    mesh = pt.make_mesh(v, f, device="cpu", dtype=np.float64)
    cfg = pt.RenderConfig(num_bins=400, distance_resolution=5e-3)
    light, sensor = LIGHT.astype(np.float64), SENSOR.astype(np.float64)
    dirs = np.array(jnc.hemisphere_directions(
        jax.random.key(SEED), 400, jnp.asarray(UP, jnp.float64)))
    assert dirs.dtype == np.float64
    t = nc.angular_transient(mesh, dirs, light, sensor, UP, cfg)
    assert t.dtype == torch.float64
    t_ref = _oracle(v.astype(np.float64), f, dirs, light, sensor,
                    cfg.distance_resolution, cfg.num_bins)
    assert t_ref.sum() > 0
    np.testing.assert_allclose(t.numpy(), t_ref, rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("normal", [[0.0, 0.0, 1.0], [1.0, 0.0, 0.0],
                                    [0.3, -0.2, 0.9]])
def test_directions_match_jax(normal):
    """Same threefry draws; each component within one ulp at 1.0."""
    normal = np.array(normal, np.float32)
    want = _jax_dirs(20000, normal)
    got = nc.hemisphere_directions(pt.key(SEED), 20000,
                                   torch.from_numpy(normal)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=DIR_ATOL)


def test_angular_transient_matches_jax(bumpy_mesh):
    """On JAX's own directions: equal to JAX op by op (disable_jit), bit
    for bit; within 1e-6 of the peak of JAX's jitted version, whose fused
    arithmetic rounds otherwise.  The scene has both hits and misses."""
    v, f = bumpy_mesh
    dirs = _jax_dirs(4000)
    jcfg = nst.RenderConfig(num_bins=400, distance_resolution=5e-3)
    cfg = pt.RenderConfig(num_bins=400, distance_resolution=5e-3)
    args = (jnp.asarray(dirs), jnp.asarray(LIGHT), jnp.asarray(SENSOR),
            jnp.asarray(UP))
    with jax.enable_x64(False):
        jm = jmake(v, f)
        want_jit = np.asarray(jnc.angular_transient(jm, *args, jcfg))
        with jax.disable_jit():
            want = np.asarray(jnc.angular_transient(jm, *args, jcfg))
    mesh = pt.make_mesh(v, f, device="cpu")
    got = nc.angular_transient(mesh, dirs, LIGHT, SENSOR, UP, cfg).numpy()
    fid = intersect.nearest_hit(
        torch.from_numpy(np.tile(LIGHT, (len(dirs), 1))),
        torch.from_numpy(dirs), mesh.v, mesh.f, mesh.f_valid)[0]
    assert 0 < int((fid >= 0).sum()) < len(dirs)
    assert got.sum() > 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, want_jit, rtol=0,
                               atol=1e-6 * want_jit.max())


def _port_render_and_grad(v, f, cfg, **kw):
    mesh = pt.make_mesh(v, f, device="cpu")
    vv = mesh.v.clone().requires_grad_()
    lighting, sensors, nrm = _pairs()
    t = nc.render_nonconfocal(mesh._replace(v=vv), lighting, sensors, nrm,
                              nrm, cfg, pt.key(SEED), **kw)
    (t ** 2).sum().backward()
    return t.detach(), vv.grad


def test_render_and_grad_match_jax(bumpy_mesh):
    """render_nonconfocal and the gradient of sum(t^2) with respect to the
    vertices against JAX's (jitted, jax.grad): each within 1e-5 of its
    largest magnitude; the gradient finite and nonzero."""
    v, f = bumpy_mesh
    jcfg, cfg = _cfgs()
    lighting, sensors, nrm = _pairs()
    with jax.enable_x64(False):
        jm = jmake(v, f)
        key = jax.random.key(SEED)
        want = np.asarray(jnc.render_nonconfocal(jm, lighting, sensors, nrm,
                                                 nrm, jcfg, key))

        def loss(vv):
            return jnp.sum(jnc.render_nonconfocal(
                jm._replace(v=vv), lighting, sensors, nrm, nrm, jcfg,
                key) ** 2)

        g_want = np.asarray(jax.grad(loss)(jm.v))
    t, g = _port_render_and_grad(v, f, cfg)
    assert t.shape == (4, 300) and float(t.sum()) > 0
    np.testing.assert_allclose(t.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    g = g.numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    np.testing.assert_allclose(g, g_want, rtol=0,
                               atol=1e-5 * np.abs(g_want).max())


@pytest.mark.parametrize("pairs_per_batch", [1, 3])
def test_result_does_not_depend_on_the_batch(bumpy_mesh, pairs_per_batch,
                                             monkeypatch):
    """Each pair's draws come from fold_in(key, global index): batches of
    1 or 3 pairs give the transient bits of one batch of 4.  The gradient
    adds the batches' vertex sums one after another, so it agrees within
    1e-6 of its largest magnitude."""
    v, f = bumpy_mesh
    _, cfg = _cfgs()
    t, g = _port_render_and_grad(v, f, cfg)
    monkeypatch.setattr(nc, "_PAIRS_PER_BATCH", pairs_per_batch)
    t_b, g_b = _port_render_and_grad(v, f, cfg)
    assert torch.equal(t, t_b)
    torch.testing.assert_close(g_b, g, rtol=0,
                               atol=1e-6 * float(g.abs().max()))


def test_missed_directions_are_dead_shadow_rays(bumpy_mesh, monkeypatch):
    """The shadow rays reach K3's wrapper with t_self = 0 exactly where
    the direction missed, and positive elsewhere; K3's mask equals the
    divide-based eager predicate's on the live rays (the JAX package's
    shadow test)."""
    v, f = bumpy_mesh
    _, cfg = _cfgs()
    seen = []
    k3 = nc.segment_occluded

    def spy(*args, **kwargs):
        seen.append((args, kwargs))
        return k3(*args, **kwargs)

    monkeypatch.setattr(nc, "segment_occluded", spy)
    mesh = pt.make_mesh(v, f, device="cpu")
    lighting, _, nrm = _pairs()
    # sensors off to the side, level with the bumps: grazing shadow rays
    sensors = np.array([[0.8, y, 0.45] for y in (-0.2, -0.05, 0.1, 0.2)],
                       np.float32)
    nc.render_nonconfocal(mesh, lighting, sensors, nrm, nrm, cfg,
                          pt.key(SEED), num_dirs=2000)
    assert len(seen) == 1
    (o, d, t_self, fid, vv, ff, fv), kwargs = seen[0]
    miss = fid < 0
    assert bool(miss.any()) and bool((~miss).any())
    assert bool((t_self[miss] == 0).all()) and bool((t_self[~miss] > 0).all())
    assert bool(torch.isfinite(d).all())
    live = ~miss
    got = k3(o, d, t_self, fid, vv, ff, fv, **kwargs)[live]
    want = intersect.segment_occluded(o[live], d[live], t_self[live],
                                      fid[live], vv, ff, fv,
                                      t_rel=kwargs["t_rel"],
                                      t_min=kwargs["t_min"])
    print("shadow rays differing from the eager predicate:",
          int((got != want).sum()), "of", int(live.sum()))
    assert bool(got.any())
    assert torch.equal(got, want)


def test_hemisphere_directions_distribution():
    """tests/test_nonconfocal.py's distribution checks, on a batch of two
    keys: upper hemisphere, unit norm, cos(theta) ~ U[0, 1], a tilted
    normal."""
    keys = sampling.fold_in(pt.key(SEED), torch.arange(2))
    normals = torch.tensor([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])
    d = nc.hemisphere_directions(keys, 5000, normals).numpy()
    assert d.shape == (2, 5000, 3)
    up, tilted = d
    assert (up[:, 2] >= -1e-6).all()
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-6)
    assert abs(up[:, 2].mean() - 0.5) < 0.03
    assert (tilted[:, 0] >= -1e-6).all()
    assert abs(tilted[:, 0].mean() - 0.5) < 0.03
