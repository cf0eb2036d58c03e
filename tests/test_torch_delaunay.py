"""The port's Delaunay re-triangulation, grid resampling and upsampling
(geometry/delaunay.py) against the JAX package's, on the CPU: the same
scipy triangulation, validated by the port's nearest-hit query, gives
JAX's faces.

One known difference: a validation ray that falls exactly on an edge
shared by two faces of the mesh (the centroid of a Delaunay triangle
across a grid square lies on the square's other diagonal) can miss both
faces in JAX's fused Möller–Trumbore, and hits one of them in the port.
The port then keeps a face JAX drops; the tests allow only such faces."""

import numpy as np
import pytest

from nlos_surface_optimization_tpu.geometry import delaunay as jd
from nlos_surface_optimization_tpu.geometry.topology import border_vertices

from nlos_surface_optimization_torch.geometry import delaunay as pd


def _height_field(n, seed):
    """An n x n bumpy height field over [-0.25, 0.25]^2 (the tests'
    fixture at n = 6)."""
    rng = np.random.RandomState(seed)
    xs = np.linspace(-0.25, 0.25, n)
    gx, gy = np.meshgrid(xs, xs)
    z = 0.5 + 0.08 * np.sin(6 * gx) * np.cos(5 * gy) + 0.02 * rng.randn(n, n)
    v = np.stack([gx.ravel(), gy.ravel(), z.ravel()], 1).astype(np.float32)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            faces += [[a, a + n, a + 1], [a + n, a + n + 1, a + 1]]
    return v, np.array(faces, np.int32)


def _edge_distance(p, v, f):
    """xy distance of the point p to the nearest edge of the mesh."""
    a = v[f].reshape(-1, 3)[:, :2].astype(np.float64)
    b = v[np.roll(f, -1, axis=1)].reshape(-1, 3)[:, :2].astype(np.float64)
    ab = b - a
    s = np.clip(((p[:2] - a) * ab).sum(1) / (ab * ab).sum(1), 0.0, 1.0)
    return np.linalg.norm(a + s[:, None] * ab - p[:2], axis=1).min()


def _hold_faces(new_v, got, want, v, f, max_extra):
    """got is want, in want's order, plus at most max_extra faces whose
    validation ray (the centroid's) lies on an edge of the mesh (v, f)."""
    extra = ~(got[:, None, :] == want[None, :, :]).all(-1).any(1)
    print("faces kept beyond JAX's (rays on a mesh edge):",
          int(extra.sum()), "of", len(got))
    np.testing.assert_array_equal(got[~extra], want)
    assert extra.sum() <= max_extra
    for tri in got[extra]:
        c = new_v[tri].astype(np.float32).sum(0) / np.float32(3.0)
        assert _edge_distance(c, v, f) < 1e-6


@pytest.mark.parametrize("n,seed,max_extra", [(6, 0, 0), (13, 1, 2)])
def test_recompute_connectivity_matches_jax(n, seed, max_extra):
    v, f = _height_field(n, seed)
    v_w, f_w = jd.recompute_connectivity(v, f)
    v_g, f_g = pd.recompute_connectivity(v, f, device="cpu")
    assert f_g.dtype == np.int32 and f_g.shape[0] > 0
    np.testing.assert_array_equal(v_g, v_w)
    _hold_faces(v_g, f_g, f_w, v, f, max_extra)
    nrm = np.cross(v_g[f_g[:, 1]] - v_g[f_g[:, 0]],
                   v_g[f_g[:, 2]] - v_g[f_g[:, 0]])
    assert (nrm[:, 2] < 0).mean() > 0.9        # wound toward the wall


@pytest.mark.parametrize("n,res,box", [(6, 9, 0.2), (13, 16, 0.3)])
def test_grid_resample_matches_jax(n, res, box):
    """Faces equal; the resampled z (nearest_hit's t) within 1e-5
    relative, since XLA fuses the JAX query's products; a box past the
    mesh (0.3) leaves rays that miss."""
    v, f = _height_field(n, 0)
    border = border_vertices(f, v.shape[0])
    kw = dict(res=res, border_v=border, lower=(-box, -box), upper=(box, box))
    v_w, f_w = jd.grid_resample(v, f, **kw)
    v_g, f_g = pd.grid_resample(v, f, **kw, device="cpu")
    assert f_g.shape[0] > 0
    _hold_faces(v_g, f_g, f_w, v, f, max_extra=0)
    np.testing.assert_allclose(v_g, v_w, rtol=1e-5, atol=0)
    assert v_g[:, 2].min() >= v[:, 2].min() - 1e-3
    assert v_g[:, 2].max() <= v[:, 2].max() + 1e-3


def test_upsample_matches_jax(bumpy_mesh):
    v, f = bumpy_mesh
    v_w, f_w = jd.upsample(v, f)
    v_g, f_g = pd.upsample(v, f)
    assert f_g.shape[0] == 4 * f.shape[0]
    np.testing.assert_array_equal(v_g, v_w)
    np.testing.assert_array_equal(f_g, f_w)
