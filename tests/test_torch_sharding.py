"""The port's source-axis sharding (parallel/shard.py) against the JAX
package's on the conftest's 8 virtual CPU devices, and against the
port's own unsharded render, on the JAX sharding tests' scene and data
(bumpy_mesh; the raw transient scaled by 1 + 0.2·U, weights 0.5 + U).

On the CPU every shard runs the kernels' plain versions; the splat is one
index_add_ in ray order, so the transient is bit-identical to the
unsharded one for any shard count.  The gradient differs from it only in
the order of its f32 sums (shard partials, then the reduce): measured
within 2.3e-7 of max|g| on these cases, held at 1e-6 (about 8 ulps of the
largest component).

Against JAX's sharded_* the port is held at tests/test_torch_inverse.py's
tolerances.  JAX's jitted bodies are compiled at XLA's backend
optimization level 0 (the ``jax_o0`` fixture): at the default level LLVM
rounds the ray lengths apart from JAX's own op-by-op arithmetic (ROADMAP.md
queue 3), which the port follows, and where the difference rows jump from
bin to bin a tap landing in the next bin moves the gradient by up to
1.8e-3 of max|g|.  At level 0 the port agrees within 1.0e-7 of max|g|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nlos_surface_optimization_tpu as nst
from nlos_surface_optimization_tpu.geometry import mesh as jmesh
from nlos_surface_optimization_tpu.parallel import shard as jshard

import nlos_surface_optimization_torch as pt
from nlos_surface_optimization_torch.parallel import (
    make_source_mesh,
    sharded_inverse_render,
    sharded_render_transient,
)

torch.set_num_threads(1)

KEY = 21
SELF_ATOL = 1e-6   # sharded against unsharded gradient, times max|g|
O0 = {"xla_backend_optimization_level": 0}


@pytest.fixture
def jax_o0(monkeypatch):
    """JAX's sharded_render_transient and sharded_inverse_render with their
    jitted bodies (shard.py's _sharded_forward, _sharded_inverse: 5 and 7
    array arguments, then the static ones) compiled at level 0."""
    for name, n_arrays in (("_sharded_forward", 5), ("_sharded_inverse", 7)):
        jitted = getattr(jshard, name)

        def at_o0(*args, _jitted=jitted, _n=n_arrays):
            return _jitted.lower(*args).compile(compiler_options=O0)(
                *args[:_n])

        monkeypatch.setattr(jshard, name, at_o0)
    return jshard


def _scene(bumpy_mesh, res=6, **kw):
    v, f = bumpy_mesh
    base = dict(num_samples=500, num_bins=400, distance_resolution=5e-3)
    base.update(kw)
    lighting, lnormal = nst.make_confocal_scan(res)
    jm, pm = jmesh.make_mesh(v, f), pt.make_mesh(v, f, device="cpu")
    if base.get("normal") == "vn":
        jm = jm._replace(vn=jmesh.vertex_normals(jm.v, jm.f, jm.f_valid))
        pm = pm._replace(vn=pt.vertex_normals(pm.v, pm.f, pm.f_valid))
    return (jm, pm, nst.RenderConfig(**base), pt.RenderConfig(**base),
            lighting, lnormal)


def _data(pm, pcfg, lighting, lnormal, seed=4):
    t0, _ = pt.render_transient(pm, lighting, lnormal, pcfg, pt.key(KEY),
                                refine=1)
    rng = np.random.RandomState(seed)
    data = (t0.numpy() * (1 + 0.2 * rng.rand(*t0.shape))).astype(np.float32)
    return data, (0.5 + rng.rand(*data.shape)).astype(np.float32)


def _hold_to_jax(t, g, t_j, g_j=None):
    np.testing.assert_allclose(t.numpy(), np.asarray(t_j), rtol=2e-5,
                               atol=1e-8)
    if g_j is not None:
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=2e-4,
                                   atol=1e-7)


@pytest.mark.parametrize("n,res,refine", [
    (1, 6, 1), (2, 6, 1), (8, 6, 1), (8, 5, 1), (8, 4, None)])
def test_forward_shard_invariance(bumpy_mesh, jax_o0, n, res, refine):
    """n shards (L = 25 over 8 pads 7 sources; refine None: the config's
    10, then smoothed): the transient equals the unsharded render bit for
    bit, and JAX's sharded render."""
    jm, pm, jcfg, pcfg, lighting, lnormal = _scene(bumpy_mesh, res)
    want, _ = pt.render_transient(pm, lighting, lnormal, pcfg, pt.key(KEY),
                                  refine=refine)
    got = sharded_render_transient(pm, lighting, lnormal, pcfg, pt.key(KEY),
                                   make_source_mesh(["cpu"] * n),
                                   refine=refine)
    assert got.shape == (res * res, 400) and float(got.max()) > 0
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    _hold_to_jax(got, None, jax_o0.sharded_render_transient(
        jm, lighting, lnormal, jcfg, jax.random.key(KEY),
        jshard.make_source_mesh(jax.devices()[:n]), refine=refine))


def _unsharded(pm, data, w, lighting, lnormal, pcfg, mode, alpha):
    if mode == "albedo":
        return pt.inverse_render_albedo(pm, data, w, lighting, lnormal,
                                        pcfg, pt.key(KEY))
    if mode == "alpha":
        return pt.inverse_render_alpha(pm, data, w, lighting, lnormal, pcfg,
                                       pt.key(KEY), alpha)
    return pt.inverse_render(pm, data, w, lighting, lnormal, pcfg,
                             pt.key(KEY), alpha)[:2]


@pytest.mark.parametrize("case,n,res,mode,kw", [
    ("grad", 2, 6, "vertex", {}),
    ("grad", 8, 6, "vertex", {}),
    ("nondivisible", 8, 5, "vertex", {}),
    ("vn", 8, 4, "vertex", dict(normal="vn", testing_flag=0)),
    ("albedo", 8, 4, "albedo", {}),
    ("alpha", 8, 4, "alpha", dict(brdf="ggx")),
    ("ggx_vertex", 4, 4, "vertex", dict(brdf="ggx")),
    ("loss_flag", 8, 4, "vertex", dict(loss_flag=1)),
    ("more_shards_than_chunks", 8, 4, "vertex", dict(source_chunk=8)),
    ("chunked", 2, 6, "vertex", dict(source_chunk=5)),
])
def test_inverse_shard_invariance(bumpy_mesh, jax_o0, case, n, res, mode,
                                  kw):
    """The sharded inverse render: its transient equals the unsharded one
    bit for bit and its gradient within f32 order; both agree with JAX's
    sharded_inverse_render."""
    jm, pm, jcfg, pcfg, lighting, lnormal = _scene(bumpy_mesh, res, **kw)
    alpha = 0.3 if pcfg.brdf == "ggx" else None
    data, w = _data(pm, pcfg, lighting, lnormal)
    t_ref, g_ref = _unsharded(pm, data, w, lighting, lnormal, pcfg, mode,
                              alpha)
    t, g = sharded_inverse_render(pm, data, w, lighting, lnormal, pcfg,
                                  pt.key(KEY), make_source_mesh(["cpu"] * n),
                                  alpha=alpha, mode=mode)
    torch.testing.assert_close(t, t_ref, rtol=0, atol=0)
    scale = float(g_ref.abs().max())
    assert scale > 0
    torch.testing.assert_close(g, g_ref, rtol=0, atol=SELF_ATOL * scale)
    _hold_to_jax(t, g, *jax_o0.sharded_inverse_render(
        jm, data, w, lighting, lnormal, jcfg, jax.random.key(KEY),
        jshard.make_source_mesh(jax.devices()[:n]),
        alpha=None if alpha is None else jnp.float32(alpha), mode=mode))


def test_sharded_difference_skips_the_loss_smoothing(bumpy_mesh, jax_o0):
    """loss_smooth_width 2: JAX's sharded body builds the difference
    without the box smoothing its own inverse_render applies; the port's
    sharded path does the same, so it equals the unsharded render at width
    0 and JAX's sharded render at width 2."""
    jm, pm, jcfg, pcfg, lighting, lnormal = _scene(bumpy_mesh, 4,
                                                   loss_smooth_width=2)
    data, w = _data(pm, pcfg, lighting, lnormal)
    t, g = sharded_inverse_render(pm, data, w, lighting, lnormal, pcfg,
                                  pt.key(KEY), make_source_mesh(["cpu"] * 8))
    _, g0, _ = pt.inverse_render(pm, data, w, lighting, lnormal,
                                 pcfg.replace(loss_smooth_width=0),
                                 pt.key(KEY))
    _, g2, _ = pt.inverse_render(pm, data, w, lighting, lnormal, pcfg,
                                 pt.key(KEY))
    scale = float(g0.abs().max())
    torch.testing.assert_close(g, g0, rtol=0, atol=SELF_ATOL * scale)
    assert float((g2 - g0).abs().max()) > 1e-3 * scale
    _hold_to_jax(t, g, *jax_o0.sharded_inverse_render(
        jm, data, w, lighting, lnormal, jcfg, jax.random.key(KEY),
        jshard.make_source_mesh(jax.devices())))


@pytest.mark.parametrize("mode,brdf,error", [
    ("alpha", "ggx", "needs the roughness"),
    ("albedo", "ggx", "lambertian"),
    ("jitter", "lambertian", "unknown mode"),
])
def test_sharded_inverse_refuses(bumpy_mesh, mode, brdf, error):
    """mode='alpha' without an alpha (JAX fails inside), the albedo mode
    with GGX, and a mode the sharded path has not."""
    _, pm, _, pcfg, lighting, lnormal = _scene(bumpy_mesh, 2, brdf=brdf)
    data = np.ones((4, 400), np.float32)
    with pytest.raises(ValueError, match=error):
        sharded_inverse_render(pm, data, data, lighting, lnormal, pcfg,
                               pt.key(KEY), make_source_mesh(["cpu"] * 2),
                               mode=mode)


def test_source_mesh_shape(monkeypatch):
    m = make_source_mesh(["cpu"] * 3)
    assert (m.size, m.rank, m.world, m.group) == (3, 0, 1, None)
    assert m.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_source_mesh()   # no CPU fallback


def test_nccl_without_a_card_raises(monkeypatch):
    """The backend is the caller's choice: no card, no silent gloo."""
    from nlos_surface_optimization_torch.parallel import multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        multihost.initialize("127.0.0.1:1", 1, 0)
