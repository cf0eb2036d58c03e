"""The port's space carving (recon/carving.py) against the JAX package's,
on the CPU.

JAX's grids come from ``jnp.arange`` with a step, which jax 0.9 hands to
NumPy: float32 at x64 off, as its runner runs, float64 under the
conftest's x64.  So JAX's side runs with x64 off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlos_surface_optimization_tpu.geometry.mesh import make_mesh as jmake
from nlos_surface_optimization_tpu.recon import carving as jc
from test_recon_io_metrics import _plane_scene

import nlos_surface_optimization_torch as pt
from nlos_surface_optimization_torch.recon import carving as pc

torch.set_num_threads(1)

# a voxel may fall on the other side of the threshold than in JAX's fused
# (jitted) carve only when its margin |2*d1 - (fd - thr)| is within this
# many float32 ulps of 2*d1; at most this many such voxels
MARGIN_ULPS = 4
MAX_MARGIN_VOXELS = 8


@pytest.fixture(scope="module")
def plane():
    """tests/test_recon_io_metrics.py's rendered plane at z = 0.5 (JAX,
    16x16 scan, 256 bins of 5 mm), as float32."""
    t, lighting, cfg = _plane_scene()
    return t.astype(np.float32), lighting, cfg.distance_resolution


def _flagship_like(L, seed=0):
    """L random scan points, each row nonzero from a random first bin on:
    the flagship's 1,200 bins of 1.2 mm (a 121 x 78 x 78 grid)."""
    rng = np.random.RandomState(seed)
    lighting = np.zeros((L, 3), np.float32)
    lighting[:, :2] = rng.uniform(-0.25, 0.25, (L, 2))
    first = rng.randint(700, 900, L)
    t = (np.arange(1200)[None, :] >= first[:, None]).astype(np.float32)
    return t, lighting, 1.2e-3


def _jax_carve(t, lighting, res, **kw):
    with jax.enable_x64(False):
        g = jc.space_carve_occupancy(t, lighting, res, **kw)
        return [np.asarray(x) for x in g]


def _hold_occupancy(got, want, t, lighting, res, xs, zs):
    """Equal, except at voxels within MARGIN_ULPS of the threshold."""
    bad = np.argwhere(got != want)
    print("voxels differing from JAX's jitted carve:", len(bad), "of",
          got.size)
    assert len(bad) <= MAX_MARGIN_VOXELS
    fd = np.asarray(pc.first_photon_distance(torch.from_numpy(t), res))
    thr = fd - np.float32(10 * res)
    for z, y, x in bad:
        p = np.array([xs[x], xs[y], zs[z]], np.float64)
        two_d1 = 2.0 * np.linalg.norm(p[None] - lighting, axis=1)
        ulp = np.spacing(np.float32(two_d1.max()))
        assert np.abs(two_d1 - thr).min() <= MARGIN_ULPS * ulp


@pytest.mark.parametrize("interval_x", [0.5 / 64, 0.01, 1 / 30])
@pytest.mark.parametrize("z_max", [None, 0.4, 0.77])
def test_grids_and_occupancy_match_jax(plane, interval_x, z_max):
    """xs, ys, zs bit for bit; the occupancy under the margin rule."""
    t, lighting, res = plane
    want = _jax_carve(t, lighting, res, interval_x=interval_x, z_max=z_max)
    got = pc.space_carve_occupancy(t, lighting, res, interval_x=interval_x,
                                   z_max=z_max, device="cpu")
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.float32 and w.dtype == np.float32
        np.testing.assert_array_equal(g.numpy(), w)
    assert got.occupancy.shape == want[0].shape
    _hold_occupancy(got.occupancy.numpy(), want[0], t, lighting, res,
                    want[1], want[3])


def test_plane_is_carved_below_and_kept_at_the_plane(plane):
    """tests/test_recon_io_metrics.py's check on the port's occupancy."""
    t, lighting, res = plane
    grid = pc.space_carve_occupancy(t, lighting, res, device="cpu")
    col = grid.occupancy[:, len(grid.ys) // 2, len(grid.xs) // 2].numpy()
    zs = grid.zs.numpy()
    assert not col[zs < 0.45].any()
    assert col[zs >= 0.5].all()


@pytest.mark.parametrize("chunk", [None, 1, 7])
def test_flagship_grid_matches_jax(chunk, monkeypatch):
    """64 random scan points over the flagship's 121 x 78 x 78 grid; the
    result does not depend on the scan-point chunk (None: the default
    bound, 5 points)."""
    t, lighting, res = _flagship_like(64)
    want = _jax_carve(t, lighting, res)
    if chunk:
        monkeypatch.setattr(pc, "_CARVE_ELEMENTS", chunk * 121 * 78 * 78)
    got = pc.space_carve_occupancy(t, lighting, res, device="cpu")
    assert got.occupancy.shape == (121, 78, 78)
    assert 0 < want[0].mean() < 1
    _hold_occupancy(got.occupancy.numpy(), want[0], t, lighting, res,
                    want[1], want[3])


def test_first_photon_distance_matches_jax():
    """The first nonzero bin (1-based) times the bin width; inf for an
    all-zero row; the first of several maxima."""
    rng = np.random.RandomState(3)
    t = np.zeros((6, 50), np.float32)
    for i, b in enumerate([0, 7, 49, 13, 20]):
        t[i, b:] = rng.rand(50 - b) + 0.1
    t[3, 30] = 0.0
    with jax.enable_x64(False):
        want = np.asarray(jc.first_photon_distance(t, 1.2e-3))
    got = pc.first_photon_distance(torch.from_numpy(t), 1.2e-3).numpy()
    assert got.dtype == np.float32 and np.isinf(got[5])
    np.testing.assert_array_equal(got, want)


def _sphere_field(n=24):
    xs = np.linspace(-1.2, 1.2, n)
    gz, gy, gx = np.meshgrid(xs, xs, xs, indexing="ij")
    return 1.0 - np.sqrt(gx ** 2 + gy ** 2 + gz ** 2), xs


def _mushroom():
    """tests/test_recon_io_metrics.py's overhang occupancy."""
    xs = np.linspace(-0.3, 0.3, 21)
    zs = np.linspace(0.0, 0.9, 30)
    occ = np.zeros((30, 21, 21), bool)
    r2 = xs[None, :] ** 2 + xs[:, None] ** 2
    occ[((zs >= 0.2) & (zs < 0.5))[:, None, None]
        & (r2 < 0.05 ** 2)[None]] = True
    occ[((zs >= 0.5) & (zs < 0.7))[:, None, None]
        & (r2 < 0.2 ** 2)[None]] = True
    return occ, xs, zs


def test_marching_tetrahedra_matches_jax():
    field, xs = _sphere_field()
    want = jc.marching_tetrahedra(field, xs, xs, xs, level=0.0)
    got = pc.marching_tetrahedra(field, xs, xs, xs, level=0.0)
    assert want[1].shape[0] > 100
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("method", ["mc", "heightfield"])
def test_carve_mesh_matches_jax(method):
    """The mushroom's carve mesh, from a grid of torch tensors and from
    JAX's grid of jnp arrays: equal vertices and faces."""
    occ, xs, zs = _mushroom()
    want = jc.carve_mesh(jc.CarveGrid(
        occupancy=jnp.asarray(occ), xs=jnp.asarray(xs), ys=jnp.asarray(xs),
        zs=jnp.asarray(zs)), method=method)
    got = pc.carve_mesh(pc.CarveGrid(
        occupancy=torch.from_numpy(occ), xs=torch.from_numpy(xs),
        ys=torch.from_numpy(xs), zs=torch.from_numpy(zs)), method=method)
    assert want[1].shape[0] > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_space_carving_projection_matches_jax(plane):
    """The plane's carve mesh from the port's occupancy; random vertices
    below and beyond it projected as JAX projects them: z equal within
    1e-5 relative (nearest_hit's t, whose products XLA fuses), x and y
    untouched."""
    t, lighting, res = plane
    grid = pc.space_carve_occupancy(t, lighting, res, device="cpu")
    cv, cf = pc.carve_mesh(grid)
    rng = np.random.RandomState(4)
    v = np.stack([rng.uniform(-0.2, 0.2, 200), rng.uniform(-0.2, 0.2, 200),
                  rng.uniform(0.05, 0.7, 200)], 1).astype(np.float32)
    with jax.enable_x64(False):
        want = np.asarray(jc.space_carving_projection(jnp.asarray(v),
                                                      jmake(cv, cf)))
    got = pc.space_carving_projection(
        v, pt.make_mesh(cv, cf, device="cpu")).numpy()
    np.testing.assert_array_equal(got[:, :2], v[:, :2])
    assert (got[:, 2] > v[:, 2]).any() and (got[:, 2] == v[:, 2]).any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
