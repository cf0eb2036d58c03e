"""The PyTorch port's geometry, smoothing, regularizer and optimizer
functions against their JAX counterparts, on the conftest fixtures."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nlos_surface_optimization_tpu as nst
from nlos_surface_optimization_tpu.geometry import accel as jaccel
from nlos_surface_optimization_tpu.geometry import intersect as jintersect
from nlos_surface_optimization_tpu.geometry import mesh as jmesh
from nlos_surface_optimization_tpu.geometry import topology as jtopology
from nlos_surface_optimization_tpu.optim import loss as jloss
from nlos_surface_optimization_tpu.optim.adam_modified import (
    adam_modified as jadam,
)
from nlos_surface_optimization_tpu.render import kernels as jkernels
from nlos_surface_optimization_tpu.render import regularizers as jreg

import nlos_surface_optimization_torch as pt
from nlos_surface_optimization_torch import convert
from nlos_surface_optimization_torch.geometry import accel, intersect, mesh
from nlos_surface_optimization_torch.geometry import topology
from nlos_surface_optimization_torch.optim import loss
from nlos_surface_optimization_torch.optim.adam_modified import adam_modified
from nlos_surface_optimization_torch.render import kernels, regularizers

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_mesh(v, f):
    m = jmesh.make_mesh(v, f)
    return m, m._replace(vn=jmesh.vertex_normals(m.v, m.f, m.f_valid))


@pytest.mark.parametrize("fixture", ["plane_mesh", "bumpy_mesh"])
def test_face_normals_areas_and_vertex_normals(fixture, request):
    v, f = request.getfixturevalue(fixture)
    n_j, a_j = jmesh.face_normals_areas(jnp.asarray(v), jnp.asarray(f))
    n_p, a_p = mesh.face_normals_areas(_t(v), _t(f).long())
    np.testing.assert_allclose(n_p.numpy(), np.asarray(n_j), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(a_p.numpy(), np.asarray(a_j), rtol=1e-6)
    valid = np.ones(f.shape[0], bool)
    vn_j = jmesh.vertex_normals(jnp.asarray(v), jnp.asarray(f),
                                jnp.asarray(valid))
    vn_p = mesh.vertex_normals(_t(v), _t(f).long(), _t(valid))
    np.testing.assert_allclose(vn_p.numpy(), np.asarray(vn_j), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(
        float(mesh.total_area(_t(v), _t(f).long(), _t(valid))),
        float(jmesh.total_area(jnp.asarray(v), jnp.asarray(f),
                               jnp.asarray(valid))), rtol=1e-6)


def test_make_mesh_padding_matches_jax(bumpy_mesh):
    v, f = bumpy_mesh
    mj = jmesh.pad_mesh(v, f)
    mp = mesh.pad_mesh(v, f, device="cpu")
    for a, b in zip(mp, mj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert mesh.bucket_size(1000) == jmesh.bucket_size(1000)


def test_segment_sum_is_ordered_and_exact():
    """Also the heavy segment that a bucketed mesh's padding faces make on
    vertex 0, and no entries at all."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 7, 200)
    ids[::2] = 0
    vals = rng.randn(200, 3).astype(np.float32)
    got = mesh.segment_sum(_t(vals), _t(ids), 9).numpy()
    want = np.zeros((9, 3), np.float32)
    for i, s in enumerate(ids):        # sequential, in index order
        want[s] += vals[i]
    np.testing.assert_array_equal(got, want)
    assert mesh.segment_sum(_t(vals[:0]), _t(ids[:0]), 4).shape == (4, 3)


def _rays_from_scene(v, f, n_rays=700):
    rng = np.random.RandomState(0)
    o = np.zeros((n_rays, 3), np.float32)
    o[:, 0] = rng.uniform(-0.25, 0.25, n_rays)
    o[:, 1] = rng.uniform(-0.25, 0.25, n_rays)
    tgt = np.stack([rng.uniform(-0.25, 0.25, n_rays),
                    rng.uniform(-0.25, 0.25, n_rays),
                    rng.uniform(0.4, 0.6, n_rays)], 1).astype(np.float32)
    d = tgt - o
    t = np.linalg.norm(d, axis=1)
    d = (d / t[:, None]).astype(np.float32)
    fid = rng.randint(0, f.shape[0], n_rays).astype(np.int32)
    return o, d, t.astype(np.float32), fid


@pytest.mark.parametrize("n_rays,valid_frac", [(700, 1.0), (513, 0.7)])
def test_segment_occluded_matches_jax(bumpy_mesh, n_rays, valid_frac):
    v, f = bumpy_mesh
    o, d, t, fid = _rays_from_scene(v, f, n_rays)
    f_valid = np.random.RandomState(1).rand(f.shape[0]) < valid_frac
    want = np.asarray(jintersect.segment_occluded(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), jnp.asarray(fid),
        jnp.asarray(v), jnp.asarray(f), jnp.asarray(f_valid)))
    got = intersect.segment_occluded(_t(o), _t(d), _t(t), _t(fid), _t(v),
                                     _t(f).long(), _t(f_valid), tile=64,
                                     ray_chunk=256)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and (~want).any()


@pytest.mark.parametrize("refine,sigma_bin", [(10, 1), (4, 2), (1, 1)])
def test_smooth_and_coarsen_matches_jax(refine, sigma_bin):
    rng = np.random.RandomState(2)
    fine = rng.rand(4, 300 * refine).astype(np.float32)
    fine[:, ::7] = 0.0
    want = np.asarray(jkernels.smooth_and_coarsen(jnp.asarray(fine), 5e-3,
                                                  refine, sigma_bin))
    got = kernels.smooth_and_coarsen(_t(fine), 5e-3, refine, sigma_bin)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_gaussian_tables_are_the_jax_tables():
    for args in ((1.2e-3, 10, 1), (5e-3, 4, 2)):
        for a, b in zip(kernels.gaussian_kernel(*args),
                        jkernels.gaussian_kernel(*args)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(kernels.grouped_gaussian_tables(*args),
                        jkernels.grouped_gaussian_tables(*args)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fixture", ["plane_mesh", "bumpy_mesh"])
def test_normal_smoothing_and_curvature_match_jax(fixture, request):
    v, f = request.getfixturevalue(fixture)
    v = v + np.random.RandomState(3).randn(*v.shape).astype(np.float32) * 0.01
    aff = jtopology.face_affinity(f)
    valid = np.ones(f.shape[0], bool)
    val_j, g_j = jreg.normal_smoothing(jnp.asarray(v), jnp.asarray(f),
                                       jnp.asarray(valid), jnp.asarray(aff))
    val_p, g_p = regularizers.normal_smoothing(_t(v), _t(f).long(),
                                               _t(valid), _t(aff))
    # value = sum area*(1 - m.n) cancels: each face's term carries a few
    # f32 ulps of 1 times its area, whatever the order of operations
    area = float(mesh.total_area(_t(v), _t(f).long(), _t(valid)))
    np.testing.assert_allclose(float(val_p), float(val_j), rtol=1e-5,
                               atol=4 * np.finfo(np.float32).eps * area)
    scale = np.abs(np.asarray(g_j)).max()
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_j), rtol=1e-5,
                               atol=1e-6 * scale)
    c_j = jreg.curvature_gradient(jnp.asarray(v), jnp.asarray(f),
                                  jnp.asarray(valid))
    c_p = regularizers.curvature_gradient(_t(v), _t(f).long(), _t(valid))
    np.testing.assert_allclose(c_p.numpy(), np.asarray(c_j), rtol=1e-5,
                               atol=1e-7)


def test_adam_modified_three_steps_match_jax():
    rng = np.random.RandomState(4)
    V = 11
    params = rng.randn(V, 3).astype(np.float32)
    lr_scale = np.where(rng.rand(V) < 0.3, 0.5, 1.0).astype(np.float32) * 1e-3
    ji, ju = jadam(lr=1.0)
    pi, pu = adam_modified(lr=1.0)
    js, ps = ji(jnp.asarray(params)), pi(_t(params))
    for _ in range(3):
        g = rng.randn(V, 3).astype(np.float32)
        uj, js = ju(jnp.asarray(g), js, lr_scale=jnp.asarray(lr_scale))
        up, ps = pu(_t(g), ps, lr_scale=_t(lr_scale))
        np.testing.assert_allclose(up.numpy(), np.asarray(uj), rtol=1e-6,
                                   atol=1e-12)
    assert ps.step == int(js.step) == 3
    np.testing.assert_allclose(ps.m.numpy(), np.asarray(js.m), rtol=1e-6)
    np.testing.assert_allclose(ps.v.numpy(), np.asarray(js.v), rtol=1e-6)
    # a checkpoint's moments carry across
    st = convert.adam_state_from_numpy(np.asarray(js.step), np.asarray(js.m),
                                       np.asarray(js.v), device="cpu")
    assert st.step == 3 and torch.equal(st.m, _t(np.asarray(js.m)))


def test_losses_match_jax():
    rng = np.random.RandomState(5)
    gt = rng.rand(6, 40).astype(np.float32)
    tr = rng.rand(6, 40).astype(np.float32)
    wj = np.asarray(jloss.create_weighting_function(jnp.asarray(gt), 1.0))
    wp = loss.create_weighting_function(_t(gt), 1.0)
    np.testing.assert_allclose(wp.numpy(), wj, rtol=1e-6)
    tot_j, l1_j = jloss.evaluate_loss_with_normal_smoothness(
        gt, wj, tr, 0.3, 0.01)
    tot_p, l1_p = loss.evaluate_loss_with_normal_smoothness(
        _t(gt), _t(wj), _t(tr), 0.3, 0.01)
    np.testing.assert_allclose(float(tot_p), float(tot_j), rtol=1e-6)
    np.testing.assert_allclose(float(l1_p), float(l1_j), rtol=1e-6)


def test_numpy_copies_equal_jax(bumpy_mesh):
    v, f = bumpy_mesh
    np.testing.assert_array_equal(topology.face_affinity(f),
                                  jtopology.face_affinity(f))
    np.testing.assert_array_equal(topology.border_vertices(f, v.shape[0]),
                                  jtopology.border_vertices(f, v.shape[0]))
    np.testing.assert_array_equal(accel.morton_order_faces(v, f),
                                  jaccel.morton_order_faces(v, f))
    lj, nj = nst.make_confocal_scan(5)
    lp, np_ = pt.make_confocal_scan(5)
    np.testing.assert_array_equal(lp, lj)
    np.testing.assert_array_equal(np_, nj)


def test_config_and_mesh_carry_across(bumpy_mesh):
    jcfg = nst.RenderConfig(num_samples=123, normal="vn", testing_flag=0,
                            source_chunk=5)
    pcfg = convert.config_from_fields(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert pcfg.kernel_taps == jcfg.kernel_taps
    assert pcfg.forward_refine == jcfg.forward_refine
    with pytest.raises(ValueError):
        convert.config_from_fields({"no_such_field": 1})
    _, mj = _jax_mesh(*bumpy_mesh)
    mp = convert.mesh_from_numpy(*(np.asarray(x) for x in mj), device="cpu")
    for a, b in zip(mp, mj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    k = jax.random.fold_in(jax.random.key(2), 9)
    np.testing.assert_array_equal(
        convert.key_from_data(np.asarray(jax.random.key_data(k))).numpy(),
        np.asarray(jax.random.key_data(k)))


# ------------------------------------------------- the loop's numpy copies

from nlos_surface_optimization_tpu.geometry import native as jnative  # noqa: E402
from nlos_surface_optimization_tpu.geometry import remesh as jremesh  # noqa: E402
from nlos_surface_optimization_tpu.io import mat as jmat  # noqa: E402
from nlos_surface_optimization_tpu.utils import metrics as jmetrics  # noqa: E402

from nlos_surface_optimization_torch.geometry import native, remesh  # noqa: E402
from nlos_surface_optimization_torch.io import mat  # noqa: E402
from nlos_surface_optimization_torch.utils import metrics  # noqa: E402


def _edge_len(v, f):
    return float(np.linalg.norm(v[f[:, 0]] - v[f[:, 1]], axis=1).mean())


@pytest.mark.parametrize("backend", ["native", "python"])
@pytest.mark.parametrize("scale", [0.5, 1.5])
def test_isotropic_remesh_equals_jax(bumpy_mesh, backend, scale):
    v, f = bumpy_mesh
    target = _edge_len(v, f) * scale
    vj, fj = jremesh.isotropic_remesh(v, f, target, iterations=3,
                                      backend=backend)
    vp, fp = remesh.isotropic_remesh(v, f, target, iterations=3,
                                     backend=backend)
    np.testing.assert_array_equal(fp, fj)
    np.testing.assert_array_equal(vp, vj)
    assert fp.shape[0] != f.shape[0]


def test_el_topo_remesh_equals_jax(bumpy_mesh):
    v, f = bumpy_mesh
    assert native.available() and jnative.available()
    target = _edge_len(v, f) * 0.7
    out_j = jremesh.el_topo_remesh(v, f, target, iterations=1)
    out_p = remesh.el_topo_remesh(v, f, target, iterations=1)
    for a, b in zip(out_p, out_j):
        np.testing.assert_array_equal(a, b)


def _moved(v):
    """A proposed vertex update: small drift, and a few vertices pushed
    through the surface so that some paths collide."""
    rng = np.random.RandomState(7)
    new = v.astype(np.float64) + 0.01 * rng.randn(*v.shape)
    new[::5, 2] += 0.15
    return new


@pytest.mark.parametrize("use_native", [True, False])
def test_integrate_vertices_equals_jax(bumpy_mesh, monkeypatch, use_native):
    v, f = bumpy_mesh
    new = _moved(v)
    # a mesh folded over itself so the moving vertices meet faces
    v2 = np.concatenate([v, v + np.array([0.01, 0.01, 0.05], np.float32)])
    f2 = np.concatenate([f, f + v.shape[0]]).astype(np.int32)
    new2 = np.concatenate([new, v2[v.shape[0]:]])
    if not use_native:
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(native, "available", lambda: False)
    want = jremesh.integrate_vertices(v2, f2, new2)
    got = remesh.integrate_vertices(v2, f2, new2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)
    stopped = np.linalg.norm(got - new2, axis=1) > 1e-9
    assert stopped.any() and (~stopped).any()


def test_topology_additions_equal_jax(bumpy_mesh):
    v, f = bumpy_mesh
    # two components: the mesh and a shifted copy of its first 10 faces
    f2 = np.concatenate([f, f[:10] + v.shape[0]]).astype(np.int32)
    v2 = np.concatenate([v, v + 1.0]).astype(np.float32)
    np.testing.assert_array_equal(
        topology.connected_components(f2, v2.shape[0]),
        jtopology.connected_components(f2, v2.shape[0]))
    for a, b in zip(topology.keep_largest_component(v2, f2),
                    jtopology.keep_largest_component(v2, f2)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(topology.remove_unreferenced(v2, f2[5:40]),
                    jtopology.remove_unreferenced(v2, f2[5:40])):
        np.testing.assert_array_equal(a, b)
    pts = np.random.RandomState(2).randn(60, 3)
    np.testing.assert_array_equal(topology.convex_hull_2d(pts),
                                  jtopology.convex_hull_2d(pts))
    aff = jtopology.face_affinity(f)
    inten = np.random.RandomState(3).rand(f.shape[0]) - 0.5
    keep = topology.remove_triangles(f, aff, inten)
    np.testing.assert_array_equal(keep,
                                  jtopology.remove_triangles(f, aff, inten))
    assert (~keep).any() and keep.any()


def _checkpoint_payload():
    rng = np.random.RandomState(4)
    v = rng.randn(9, 3).astype(np.float32)
    return dict(
        v=v, f=np.asarray([[0, 1, 2], [1, 3, 2], [4, 5, 6]], np.int32),
        iteration=7,
        rng_key=np.asarray(jax.random.key_data(jax.random.key(23))),
        opt_m=v * 2, opt_v=v * v, opt_step=7,
        loop_state={"old_v": v + 1, "run_count": 3, "weight_flag": 1,
                    "testing_flag": 0, "smooth_weight": 2.5e-3,
                    "lr": 1.1e-4, "loss_epsilon": 5e-5,
                    "scan_resolution": 96.0, "sample_num": 30000.0,
                    "smooth_ratio": 12.5, "l2_first": np.nan},
        history={"l2": [1.0, 0.5], "l2_original": [1.1, 0.6],
                 "v2": [0.01, np.nan]},
        extra={"transient": rng.rand(4, 5).astype(np.float32), "l2": 0.25})


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_load_in_either_package(tmp_path, writer):
    path = str(tmp_path / "ck.mat")
    save = mat.save_checkpoint if writer == "port" else jmat.save_checkpoint
    save(path, **_checkpoint_payload())
    d_p = mat.load_checkpoint(path)
    d_j = jmat.load_checkpoint(path)
    assert sorted(d_p) == sorted(d_j) and len(d_p) == 23
    for k in d_j:
        np.testing.assert_array_equal(np.asarray(d_p[k]), np.asarray(d_j[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(d_p["rng_key"],
                                  _checkpoint_payload()["rng_key"])


def _voronoi_points(v, f):
    """Points in every region of the mesh's triangles: above face
    interiors, beyond edges and beyond vertices (off the mesh's border),
    and scattered above and below it (at least 5 cm away, so that the
    f32 distance is not dominated by the rounding of the coordinates)."""
    rng = np.random.RandomState(6)
    a, b, c = (v[f[:, k]].astype(np.float64) for k in range(3))
    n = np.cross(b - a, c - a)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    cen = (a + b + c) / 3
    mid = (a + b) / 2
    out = mid + (mid - c) * 0.8
    pts = [cen + 0.03 * n, out + 0.02 * n, a + (a - cen) * 1.5 - 0.01 * n,
           rng.uniform([-0.4, -0.4, 0.25], [0.4, 0.4, 0.33], (100, 3)),
           rng.uniform([-0.4, -0.4, 0.67], [0.4, 0.4, 0.75], (100, 3))]
    return np.concatenate(pts)


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12),
                                        (np.float32, 1e-5)])
def test_point_mesh_distance_and_v2_match_jax(bumpy_mesh, dtype, rtol):
    v, f = bumpy_mesh
    pts64 = _voronoi_points(v, f)
    v = v.astype(dtype)
    pts = pts64.astype(dtype)
    a, b, c = (v[f[:, k]] for k in range(3))
    d2_j = np.asarray(jmetrics._point_triangle_dist2(
        jnp.asarray(pts)[:, None], *(jnp.asarray(x)[None] for x in (a, b, c))))
    d2_p = metrics._point_triangle_dist2(
        _t(pts)[:, None], *(_t(x)[None] for x in (a, b, c))).numpy()
    assert d2_p.dtype == dtype
    np.testing.assert_allclose(d2_p, d2_j, rtol=rtol, atol=0)
    # the mesh distance of points at least 1 cm from the surface: nearer,
    # an f32 distance is dominated by the rounding of the coordinates
    # (~0.4 * 2**-24 absolute), whatever the order of the operations
    far = metrics.point_mesh_distance(
        _t(pts64), _t(v.astype(np.float64)), _t(f).long(),
        torch.ones(f.shape[0], dtype=torch.bool)).numpy() > 0.01
    assert far.sum() > 300
    pts = pts[far]
    gj = jmesh.make_mesh(v, f, dtype=dtype)
    gp = mesh.make_mesh(v, f, device="cpu", dtype=dtype)
    dist_j = np.asarray(jmetrics.point_mesh_distance(
        jnp.asarray(pts), gj.v, gj.f, gj.f_valid))
    dist_p = metrics.point_mesh_distance(_t(pts), gp.v, gp.f, gp.f_valid,
                                         batch=97).numpy()
    np.testing.assert_allclose(dist_p, dist_j, rtol=rtol)
    np.testing.assert_allclose(float(metrics.compute_v2(_t(pts), gp)),
                               float(jmetrics.compute_v2(jnp.asarray(pts),
                                                         gj)), rtol=rtol)
    assert dist_j.min() < 0.03 < dist_j.max()
