"""The port's nearest-hit query and the small tools around it
(geometry/intersect.py nearest_hit and ray_mesh_barycoords,
utils/metrics.py average_z_distance, io/progress.py collect_progress,
utils/timers.py) against the JAX package's, on the CPU."""

import json
import os
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nlos_surface_optimization_tpu.geometry import intersect as jint
from nlos_surface_optimization_tpu.geometry.mesh import make_mesh as jmake
from nlos_surface_optimization_tpu.io.mat import save_checkpoint
from nlos_surface_optimization_tpu.io.progress import (
    collect_progress as jcollect,
)
from nlos_surface_optimization_tpu.utils.metrics import (
    average_z_distance as javg,
)
from nlos_surface_optimization_tpu.utils.timers import PhaseTimer as JTimer

from nlos_surface_optimization_torch.geometry import intersect
from nlos_surface_optimization_torch.geometry.mesh import make_mesh
from nlos_surface_optimization_torch.io.progress import collect_progress
from nlos_surface_optimization_torch.utils import metrics, timers

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _both(o, d, v, f, valid=None, tile=512, ray_chunk=16384):
    """nearest_hit of the port and of JAX on the same f32 inputs."""
    valid = np.ones(f.shape[0], bool) if valid is None else valid
    got = intersect.nearest_hit(_t(o), _t(d), _t(v), _t(f.astype(np.int64)),
                                _t(valid), tile=tile, ray_chunk=ray_chunk)
    want = jint.nearest_hit(jnp.asarray(o), jnp.asarray(d), jnp.asarray(v),
                            jnp.asarray(f), jnp.asarray(valid), tile=tile)
    return [x.numpy() for x in got], [np.asarray(x) for x in want]


def _hold(got, want, min_hits=1):
    """fid exactly; u and v (in [0, 1]) within 2e-5, t within 1e-5
    relative: XLA fuses the dot products of the JAX package's
    Möller–Trumbore and rounds them otherwise than torch, and u and v are
    differences of such products."""
    fid, u, v, t = got
    assert fid.dtype == np.int32 and u.dtype == np.float32
    np.testing.assert_array_equal(fid, want[0])
    assert (fid >= 0).sum() >= min_hits
    np.testing.assert_array_equal(t < 0, fid < 0)
    np.testing.assert_allclose(u, want[1], rtol=0, atol=2e-5)
    np.testing.assert_allclose(v, want[2], rtol=0, atol=2e-5)
    np.testing.assert_allclose(t, want[3], rtol=1e-5, atol=0)


def _z_rays(n, extent, seed):
    """+z rays from a jittered n x n grid on the wall (z = 0)."""
    rng = np.random.RandomState(seed)
    xs = np.linspace(-extent, extent, n)
    gx, gy = np.meshgrid(xs, xs)
    o = np.stack([gx.ravel(), gy.ravel(), np.zeros(n * n)], 1)
    o[:, :2] += rng.uniform(-0.01, 0.01, (n * n, 2))
    d = np.tile([0.0, 0.0, 1.0], (n * n, 1))
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("tile,ray_chunk", [(512, 16384), (7, 13)])
def test_nearest_hit_matches_jax(bumpy_mesh, tile, ray_chunk):
    """+z rays over the fixture and past its border (misses), and rays in
    random directions from off-axis points (some hit twice: nearest)."""
    v, f = bumpy_mesh
    o, d = _z_rays(12, 0.35, 0)
    _hold(*_both(o, d, v, f, tile=tile, ray_chunk=ray_chunk), min_hits=50)
    rng = np.random.RandomState(1)
    o2 = np.stack([rng.uniform(0.5, 0.8, 300), rng.uniform(-0.2, 0.2, 300),
                   rng.uniform(0.3, 0.7, 300)], 1).astype(np.float32)
    tgt = v[f[rng.randint(0, f.shape[0], 300)]].mean(1)
    d2 = tgt - o2
    d2 = (d2 / np.linalg.norm(d2, axis=1, keepdims=True)).astype(np.float32)
    got, want = _both(o2, d2, v, f, tile=tile, ray_chunk=ray_chunk)
    _hold(got, want, min_hits=250)


def test_nearest_hit_respects_f_valid_and_t_min(plane_mesh):
    v, f = plane_mesh
    o, d = _z_rays(9, 0.28, 2)
    valid = np.array([True, False])
    got, want = _both(o, d, v, f, valid)
    _hold(got, want)
    assert set(got[0].tolist()) == {-1, 0}
    # origins on the plane: t = 0 is not past t_min, so every ray misses
    o_on = o.copy()
    o_on[:, 2] = 0.5
    got, want = _both(o_on, d, v, f)
    np.testing.assert_array_equal(got[0], -1)
    np.testing.assert_array_equal(want[0], -1)
    np.testing.assert_array_equal(got[3], -1.0)


@pytest.mark.parametrize("tile", [512, 1, 2])
def test_nearest_hit_tie_takes_lowest_face(plane_mesh, tile):
    """The plane's two faces twice over (faces 2, 3 = faces 0, 1): every
    hit is at equal t on a face and its copy, and the lower id wins, in
    one tile or across tiles; rays through the shared diagonal hit both
    faces at equal t, and face 0 wins."""
    v, f = plane_mesh
    f2 = np.concatenate([f, f])
    o, d = _z_rays(7, 0.25, 3)
    diag = np.array([[x, x, 0.0] for x in (-0.2, -0.05, 0.1)], np.float32)
    o = np.concatenate([o, diag])
    d = np.concatenate([d, np.tile(np.float32([0, 0, 1]), (3, 1))])
    got, want = _both(o, d, v, f2, tile=tile)
    _hold(got, want, min_hits=40)
    assert got[0].max() <= 1
    np.testing.assert_array_equal(got[0][-3:], want[0][-3:])


def test_nearest_hit_grazing_rays(bumpy_mesh, plane_mesh):
    """Rays in the plane's own plane (det 0: no hit), and rays that skim
    the bumpy field at about 1 degree to a point inside each face (the
    nearest hit is often another face on the way)."""
    v, f = plane_mesh
    o = np.float32([[-0.5, 0.0, 0.5], [-0.5, 0.3, 0.5], [0.0, -0.5, 0.5]])
    d = np.float32([[1, 0, 0], [1, 0, 0], [0, 1, 0]])
    got, want = _both(o, d, v, f)
    np.testing.assert_array_equal(got[0], -1)
    np.testing.assert_array_equal(want[0], -1)

    bv, bf = bumpy_mesh
    rng = np.random.RandomState(5)
    w = rng.dirichlet([4.0, 4.0, 4.0], bf.shape[0]).astype(np.float32)
    tgt = (bv[bf] * w[:, :, None]).sum(1)
    o = np.stack([np.full(len(tgt), 0.9), tgt[:, 1], tgt[:, 2] - 0.02],
                 1).astype(np.float32)
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    _hold(*_both(o, d, bv, bf), min_hits=30)


def test_ray_mesh_barycoords_matches_jax(bumpy_mesh):
    v, f = bumpy_mesh
    o, d = _z_rays(10, 0.3, 4)
    got = intersect.ray_mesh_barycoords(_t(o), _t(d), _t(v),
                                        _t(f.astype(np.int64))).numpy()
    want = np.asarray(jint.ray_mesh_barycoords(jnp.asarray(o),
                                               jnp.asarray(d),
                                               jnp.asarray(v),
                                               jnp.asarray(f)))
    assert got.shape == want.shape == (100, 3)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    assert (got[:, 0] == -1).any() and (got[:, 0] >= 0).sum() > 50
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=0, atol=2e-5)


def test_average_z_distance(plane_mesh):
    """tests/test_integrate_progress.py::test_average_z_distance, on the
    port (a float64 mesh)."""
    v, f = plane_mesh
    gt = make_mesh(v, f, device="cpu", dtype=np.float64)
    pts = torch.tensor([[0.0, 0.0, 0.52], [0.1, -0.1, 0.47]],
                       dtype=torch.float64)
    d = float(metrics.average_z_distance(pts, gt))
    np.testing.assert_allclose(d, (0.02 + 0.03) / 2, atol=1e-9)
    pts2 = torch.tensor([[0.0, 0.0, 0.52], [5.0, 5.0, 0.1]],
                        dtype=torch.float64)
    d2 = float(metrics.average_z_distance(pts2, gt))
    np.testing.assert_allclose(d2, 0.02, atol=1e-9)


def test_average_z_distance_matches_jax(bumpy_mesh):
    """Points above and below the bumpy field (some past its border)
    against JAX's, float32."""
    v, f = bumpy_mesh
    rng = np.random.RandomState(6)
    pts = np.stack([rng.uniform(-0.3, 0.3, 200), rng.uniform(-0.3, 0.3, 200),
                    rng.uniform(0.4, 0.6, 200)], 1).astype(np.float32)
    got = metrics.average_z_distance(torch.from_numpy(pts),
                                     make_mesh(v, f, device="cpu"))
    want = javg(jnp.asarray(pts), jmake(v, f))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_collect_progress(tmp_path):
    """tests/test_integrate_progress.py::test_collect_progress, and the
    same as JAX's on the same directory."""
    for t in range(3):
        save_checkpoint(
            str(tmp_path / f"{t:05d}.mat"), v=np.random.rand(4 + t, 3),
            f=np.array([[0, 1, 2]]), iteration=t,
            rng_key=np.zeros(2, np.uint32),
            extra={"l2": 1.0 / (t + 1), "l2_original": 2.0 / (t + 1)},
        )
    out = collect_progress(str(tmp_path))
    np.testing.assert_array_equal(out["iteration"], [0, 1, 2])
    np.testing.assert_allclose(out["l2"], [1.0, 0.5, 1 / 3])
    np.testing.assert_array_equal(out["num_vertices"], [4, 5, 6])
    assert out["final_v"].shape == (6, 3)
    want = jcollect(str(tmp_path))
    assert sorted(out) == sorted(want)
    for k in out:
        np.testing.assert_array_equal(out[k], want[k])
    assert collect_progress(str(tmp_path / "none"))["l2"].size == 0


def test_phase_timer():
    """Totals and counts per phase, the summary in JAX's format; a phase
    that raises is still timed; block=True waits for the device."""
    timer, jtimer = timers.PhaseTimer(), JTimer()
    for tm in (timer, jtimer):
        for _ in range(2):
            with tm.phase("render"):
                time.sleep(0.01)
        with tm.phase("remesh", block=True):
            pass
        with pytest.raises(ValueError):
            with tm.phase("fail"):
                raise ValueError
    assert dict(timer.counts) == dict(jtimer.counts) == {
        "render": 2, "remesh": 1, "fail": 1}
    assert timer.totals["render"] >= 0.02
    names = [row.split(":")[0] for row in timer.summary().split("; ")]
    assert names == [row.split(":")[0]
                     for row in jtimer.summary().split("; ")]
    assert timer.summary().startswith("fail: ")


def test_trace_writes_a_chrome_trace(tmp_path):
    with timers.trace(str(tmp_path)):
        torch.ones(64).cumsum(0)
    with open(os.path.join(tmp_path, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
