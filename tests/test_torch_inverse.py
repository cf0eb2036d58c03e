"""The port's slice end to end against the JAX package: render_transient,
inverse_render and a few descent steps on the CPU, plus the guard that the
port never imports JAX."""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nlos_surface_optimization_tpu as nst
from nlos_surface_optimization_tpu.geometry import mesh as jmesh
from nlos_surface_optimization_tpu.geometry import topology as jtopology
from nlos_surface_optimization_tpu.optim import loss as jloss
from nlos_surface_optimization_tpu.optim.adam_modified import (
    adam_modified as jadam,
)
from nlos_surface_optimization_tpu.render import inverse_render as jinverse
from nlos_surface_optimization_tpu.render import regularizers as jreg
from nlos_surface_optimization_tpu.render import render_transient as jrender

import nlos_surface_optimization_torch as pt

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "nlos_surface_optimization_torch")
KEY = 3


def _cfgs(**kw):
    base = dict(num_samples=400, num_bins=300, distance_resolution=5e-3)
    base.update(kw)
    return nst.RenderConfig(**base), pt.RenderConfig(**base)


def _meshes(v, f, normal):
    jm = jmesh.make_mesh(v, f)
    pm = pt.make_mesh(v, f, device="cpu")
    if normal == "vn":
        jm = jm._replace(vn=jmesh.vertex_normals(jm.v, jm.f, jm.f_valid))
        pm = pm._replace(vn=pt.vertex_normals(pm.v, pm.f, pm.f_valid))
    return jm, pm


@pytest.mark.parametrize("source_chunk,normal,testing_flag", [
    (0, "fn", 1), (3, "fn", 1), (5, "vn", 0)])
def test_inverse_render_matches_jax(bumpy_mesh, source_chunk, normal,
                                    testing_flag):
    v, f = bumpy_mesh
    jcfg, pcfg = _cfgs(source_chunk=source_chunk, normal=normal,
                       testing_flag=testing_flag)
    jm, pm = _meshes(v, f, normal)
    lighting, lnormal = nst.make_confocal_scan(4)
    data = (np.random.RandomState(1).rand(16, 300) * 1e-3).astype(np.float32)
    w = np.ones((16, 300), np.float32)
    t_j, g_j, _ = jinverse(jm, jnp.asarray(data), jnp.asarray(w), lighting,
                           lnormal, jcfg, jax.random.key(KEY))
    t_p, g_p, path = pt.inverse_render(pm, data, w, lighting, lnormal, pcfg,
                                       pt.key(KEY))
    assert t_p.shape == (16, 300) and g_p.shape == (v.shape[0], 3)
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_j), rtol=2e-5,
                               atol=1e-8)
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_j), rtol=2e-4,
                               atol=1e-7)
    assert np.abs(np.asarray(g_j)).max() > 1e-4
    np.testing.assert_allclose(path.numpy(), np.asarray(
        nst.render.api.pathlengths(jcfg)), rtol=1e-12)


@pytest.mark.parametrize("refine", [None, 1])
def test_render_transient_matches_jax(bumpy_mesh, refine):
    v, f = bumpy_mesh
    jcfg, pcfg = _cfgs(source_chunk=7)
    jm, pm = _meshes(v, f, "fn")
    lighting, lnormal = nst.make_confocal_scan(4)
    t_j, _ = jrender(jm, lighting, lnormal, jcfg, jax.random.key(KEY),
                     refine=refine)
    t_p, _ = pt.render_transient(pm, lighting, lnormal, pcfg, pt.key(KEY),
                                 refine=refine)
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_j), rtol=2e-5,
                               atol=1e-8)
    assert float(t_p.max()) > 0


def test_eager_backends_match_the_kernel_path(bumpy_mesh):
    """occl_backend='jnp' / bwd_backend='xla' (divide-based visibility,
    eager splat and backward) agree with the kernels' plain versions."""
    v, f = bumpy_mesh
    _, cfg = _cfgs(source_chunk=6)
    mesh = pt.make_mesh(v, f, device="cpu")
    lighting, lnormal = pt.make_confocal_scan(4)
    data = np.full((16, 300), 1e-3, np.float32)
    w = np.ones((16, 300), np.float32)
    t_k, g_k, _ = pt.inverse_render(mesh, data, w, lighting, lnormal, cfg,
                                    pt.key(KEY))
    t_e, g_e, _ = pt.inverse_render(
        mesh, data, w, lighting, lnormal,
        cfg.replace(occl_backend="jnp", bwd_backend="xla"), pt.key(KEY))
    torch.testing.assert_close(t_e, t_k, rtol=2e-5, atol=1e-8)
    torch.testing.assert_close(g_e, g_k, rtol=2e-4, atol=1e-7)


@pytest.mark.parametrize("field,value,error", [
    ("occl_backend", "pallas", NotImplementedError),
    ("occl_backend", "mxu", NotImplementedError),
    ("bwd_backend", "nope", ValueError),
    ("brdf", "ggx", NotImplementedError),
])
def test_unported_options_raise(bumpy_mesh, field, value, error):
    v, f = bumpy_mesh
    _, cfg = _cfgs()
    mesh = pt.make_mesh(v, f, device="cpu")
    lighting, lnormal = pt.make_confocal_scan(2)
    with pytest.raises(error):
        pt.render_transient(mesh, lighting, lnormal,
                            cfg.replace(**{field: value}), pt.key(0))


def test_descent_steps_match_jax(bumpy_mesh):
    """Three steps of chip_smoke's descent (inverse_render, normal
    smoothing, auto smooth weight, Adam_Modified with the border lr scale)
    against the same steps through the JAX package."""
    import chip_smoke

    v, f = bumpy_mesh
    plane = v.copy()
    plane[:, 2] = 0.5
    jcfg, pcfg = _cfgs(source_chunk=8)
    lighting, lnormal = nst.make_confocal_scan(4)
    gt_j, _ = jrender(jmesh.make_mesh(v, f), lighting, lnormal, jcfg,
                      jax.random.key(KEY))
    gt = np.array(gt_j, np.float32)
    descent = chip_smoke.Descent(plane, f, torch.from_numpy(gt),
                                 torch.from_numpy(lighting),
                                 torch.from_numpy(lnormal), pcfg,
                                 pt.key(KEY), "cpu")

    weight = jloss.create_weighting_function(jnp.asarray(gt), 1.0)
    aff = jnp.asarray(jtopology.face_affinity(f))
    border = jtopology.border_vertices(f, v.shape[0])
    lr_scale = jnp.asarray(np.where(border == 1, 0.1, 1.0) * (1e-4 / 3),
                           jnp.float32)
    init, update = jadam(lr=1.0)
    vj = jnp.asarray(plane)
    opt = init(vj)
    smooth_weight = 1e-3
    for i in range(3):
        mesh = jmesh.make_mesh(np.asarray(vj), f)
        t, g, _ = jinverse(mesh, jnp.asarray(gt), weight, lighting, lnormal,
                           jcfg, jax.random.key(KEY))
        sval, sgrad = jreg.normal_smoothing(mesh.v, mesh.f, mesh.f_valid, aff)
        l2, data_l2 = jloss.evaluate_loss_with_normal_smoothness(
            jnp.asarray(gt), weight, t, sval, smooth_weight)
        if i == 0:
            smooth_weight = (float(data_l2) / float(sval) / 100.0
                             if float(sval) > 1e-12 else 0.0)
        upd, opt = update(g + smooth_weight * sgrad, opt, lr_scale=lr_scale)
        vj = (vj + upd).astype(jnp.float32)

        l2_p, data_p, g_p = descent.step()
        np.testing.assert_allclose(l2_p, float(l2), rtol=1e-4)
        np.testing.assert_allclose(data_p, float(data_l2), rtol=1e-4)
        # from the second step on the two meshes differ by rounding, so
        # the gradient is held at the backward kernel's tolerance
        scale = np.abs(np.asarray(g)).max()
        np.testing.assert_allclose(g_p.numpy(), np.asarray(g), rtol=2e-4,
                                   atol=2e-5 * scale, err_msg=f"step {i}")
        np.testing.assert_allclose(descent.mesh.v.numpy(), np.asarray(vj),
                                   rtol=0, atol=1e-7)
    assert descent.smooth_weight == pytest.approx(smooth_weight, rel=1e-4)


_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|nlos_surface_optimization_tpu)\b",
    re.M)


def test_no_jax_imports_in_port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    for path in files:
        with open(path) as fh:
            src = fh.read()
        assert not _IMPORT.search(src), path


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import nlos_surface_optimization_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'nlos_surface_optimization_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith(p.__name__)]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
