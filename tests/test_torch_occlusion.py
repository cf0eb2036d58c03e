"""The port's standalone visibility (kernel K3, render/occl_kernels.py),
its matmul-form narrow phase (geometry/intersect.segment_occluded_mxu,
occl_backend 'mxu'), trace_chunk and render_intensity against the JAX
package.

On the CPU the K3 wrapper runs its plain version (fused_kernels.
occluded_plain, every face tested); the JAX kernel runs in interpret
mode.  The kernel's plan, which only the CUDA path runs, is checked here
by emulating its narrow phase over the plain broad phase's lists (the
hierarchical candidate groups of each 128-ray block, in passes of the
list capacity) with the plain predicate."""

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
from nlos_surface_optimization_tpu.geometry.intersect import segment_occluded
from nlos_surface_optimization_tpu.render import pallas_kernels as jpk
from nlos_surface_optimization_tpu.render import render_intensity as jintensity

import nlos_surface_optimization_torch as pt
from nlos_surface_optimization_torch.geometry import intersect, topology
from nlos_surface_optimization_torch.geometry.accel import (
    morton_order_faces,
    mt_coefficients,
)
from nlos_surface_optimization_torch.render import core
from nlos_surface_optimization_torch.render import fused_kernels as fk
from nlos_surface_optimization_torch.render import occl_kernels as ok
from test_accel import _layered_mesh

torch.set_num_threads(1)

KEY = 3


def _t(x):
    return torch.from_numpy(np.array(x))


def _rays_from_scene(v, f, n_rays):
    """test_pallas.py's rays: random wall origins (a block mixes origins)
    toward random surface-ish targets."""
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


def _graze(v, f, Lc, spt, seed=1):
    """Rays ordered (source, face, sample) from sources far off-axis that
    graze the bumps (test_pallas.py's fused-kernel rays)."""
    rng = np.random.RandomState(seed)
    F = f.shape[0]
    R = Lc * F * spt
    src = np.stack([rng.uniform(0.7, 0.9, Lc),
                    rng.uniform(-0.25, 0.25, Lc), 0.45 + np.zeros(Lc)], 1)
    fi = np.tile(np.repeat(np.arange(F), spt), Lc).astype(np.int32)
    u = rng.rand(R).astype(np.float32)
    w = rng.rand(R).astype(np.float32)
    m = u + w > 1
    u[m], w[m] = 1 - u[m], 1 - w[m]
    p = (v[f[fi, 0]] * (1 - u - w)[:, None] + v[f[fi, 1]] * u[:, None]
         + v[f[fi, 2]] * w[:, None])
    o = np.repeat(src, F * spt, 0).astype(np.float32)
    d = p - o
    t = np.linalg.norm(d, axis=1).astype(np.float32)
    return o, (d / t[:, None]).astype(np.float32), t, fi


def _grid_mesh(n=12, flat=False):
    """A Morton-ordered height field of 2(n-1)^2 faces (242 at n = 12: four
    supergroups, the last one partly padding); with ``flat`` the plane
    z = 0.5."""
    rng = np.random.RandomState(2)
    xs = np.linspace(-0.25, 0.25, n)
    gx, gy = np.meshgrid(xs, xs)
    z = 0.5 + 0.08 * np.sin(6 * gx) * np.cos(5 * gy) + 0.02 * rng.randn(n, n)
    if flat:
        z = np.full_like(gx, 0.5)
    v = np.stack([gx.ravel(), gy.ravel(), z.ravel()], 1).astype(np.float32)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            faces += [[a, a + n, a + 1], [a + n, a + n + 1, a + 1]]
    f = np.array(faces, np.int32)
    return v, morton_order_faces(v, f).astype(np.int32)


def _face_valid(valid, F):
    """'all', 'none', or 'super0': the first 64-face supergroup invalid."""
    fv = np.full(F, valid != "none")
    if valid == "super0":
        fv[:fk.GF * fk.SG] = False
    return fv


def _emulated_kernel(o, d, t, fid, v, f, fv, cap, t_rel=1e-4, t_min=1e-6):
    """K3's plan on the CPU: the face hierarchy, the plain broad phase's
    lists per 128-ray block and, pass by pass (cap groups a pass), the
    plain narrow phase (the per-ray group cull, then the predicate)
    against the listed groups' faces -> (mask, passes, counts, lists)."""
    hier = fk.face_hierarchy(v, f, fv)
    counts, lists = ok.broad_phase(o, d, t, hier)
    occ = torch.zeros(o.shape[0], dtype=torch.bool)
    passes = 0
    for k in range(counts.shape[0]):
        rows = slice(k * ok.RB, (k + 1) * ok.RB)
        for p0 in range(0, int(counts[k]), cap):
            gids = lists[k, p0:min(p0 + cap, int(counts[k]))].long()
            assert (gids >= 0).all()
            occ[rows] |= fk.narrow_plain(o[rows], d[rows],
                                         t[rows] * (1 - t_rel), fid[rows],
                                         hier, gids, t_min)
            passes += 1
    return occ, passes, counts, lists


@pytest.mark.parametrize("n_rays,valid,cap,mesh", [
    (700, "all", fk.LIST_CAP, "bumpy"),    # test_pallas: the reference
    (513, "all", fk.LIST_CAP, "bumpy"),    # not a multiple of the block
    (256, "none", fk.LIST_CAP, "bumpy"),   # nothing can occlude
    (700, "all", 1, "bumpy"),              # capacity 1: a pass per group
    (700, "super0", 3, "grid"),            # F % 64 != 0, an invalid supergroup
    (700, "all", fk.LIST_CAP, "shuffled"),  # faces in no spatial order
])
def test_segment_occluded_matches_jax(bumpy_mesh, n_rays, valid, cap, mesh):
    v, f = bumpy_mesh if mesh == "bumpy" else _grid_mesh()
    if mesh == "shuffled":
        f = f[np.random.RandomState(4).permutation(f.shape[0])]
    o, d, t, fid = _rays_from_scene(v, f, n_rays)
    fv = _face_valid(valid, f.shape[0])
    args = [jnp.asarray(x) for x in (o, d, t, fid, v, f, fv)]
    ref = np.asarray(segment_occluded(*args))
    pal = jpk.segment_occluded_pallas(*args, interpret=True)
    pargs = [_t(x) for x in (o, d, t, fid, v, f, fv)]
    pargs[5] = pargs[5].long()
    got = ok.segment_occluded(*pargs).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.asarray(pal))
    if valid == "none":
        assert not got.any()
    else:
        assert ref.any() and (~ref).any()
    emu, passes, counts, lists = _emulated_kernel(*pargs, cap=cap)
    np.testing.assert_array_equal(emu.numpy(), ref)
    assert passes == int(sum(-(-int(c) // cap) for c in counts))
    if cap == 1:
        assert passes == int(counts.sum()) > counts.shape[0]
    if valid == "super0":   # no group of the invalid supergroup is listed
        sup = fk.face_hierarchy(*pargs[4:]).super_boxes
        assert f.shape[0] % 64 and not ((lists >= 0) & (lists < fk.SG)).any()
        assert bool((sup[0, :3] > sup[0, 3:]).all())


def _flat_grazing_rays(v, f, n_rays, slope, seed=6):
    """Rays that cross the flat grid (z = 0.5) at a shallow slope, at grid
    lines and vertices, or stop just short of it.  Every group box of the
    flat grid is flat in z and has its x and y faces on grid lines, so each
    hit lies on a face of the boxes that the per-ray group cull tests."""
    rng = np.random.RandomState(seed)
    lines = np.unique(v[:, 0])[1:-1]
    kind = np.arange(n_rays) % 4
    p = rng.uniform(-0.24, 0.24, (n_rays, 3))
    p[kind % 2 == 1, 0] = rng.choice(lines, int((kind % 2 == 1).sum()))
    p[kind >= 2, 1] = rng.choice(lines, int((kind >= 2).sum()))
    p[:, 2] = 0.5
    phi = rng.uniform(0.0, 2.0 * np.pi, n_rays)
    d = np.stack([np.cos(phi), np.sin(phi), np.full(n_rays, -slope)], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    a = rng.uniform(0.05, 0.2, n_rays)
    t = a + np.where(rng.rand(n_rays) < 0.7, 0.02, -0.002)
    fid = rng.randint(0, f.shape[0], n_rays)
    return ((p - a[:, None] * d).astype(np.float32), d.astype(np.float32),
            t.astype(np.float32), fid.astype(np.int32))


@pytest.mark.parametrize("slope,cap", [(1e-3, fk.LIST_CAP), (3e-2, 2)])
def test_group_cull_keeps_hits_on_box_faces(slope, cap):
    """K3's plan with the narrow phase's per-ray group cull gives the plain
    mask on grazing rays whose hits lie on the faces of the group boxes
    (the flat grid), and the cull does drop listed groups.  (Not held to
    JAX here: rays through a shared edge or vertex sit on the predicate's
    rounding boundary, where JAX's own eager and Pallas masks differ.)"""
    v, f = _grid_mesh(flat=True)
    o, d, t, fid = _flat_grazing_rays(v, f, 640, slope)
    fv = np.ones(f.shape[0], bool)
    pargs = [_t(x) for x in (o, d, t, fid, v, f, fv)]
    pargs[5] = pargs[5].long()
    want = fk.occluded_plain(*pargs)
    emu, _, _, lists = _emulated_kernel(*pargs, cap=cap)
    assert torch.equal(emu, want)
    assert want.any() and (~want).any()
    hier = fk.face_hierarchy(*pargs[4:])
    listed = lists[torch.arange(o.shape[0]) // ok.RB].long()   # [R, width]
    end = pargs[0] + pargs[1] * (pargs[2] * (1.0 - 1e-4))[:, None]
    cross = fk._slab_hits(pargs[0][:, None], end[:, None],
                          torch.zeros_like(end)[:, None],
                          hier.group_boxes[listed.clamp(min=0)])
    assert bool((~cross & (listed >= 0)).any())


@pytest.mark.parametrize("scene,valid_frac,dead_frac", [
    ("scene", 1.0, 0.0), ("scene", 0.7, 0.2), ("graze", 1.0, 0.2)])
def test_broad_phase_lists_cover_every_blocker(scene, valid_frac, dead_frac):
    """Every 8-face group holding a face that blocks one of a block's rays
    is on that block's list, also for blocks whose rays come from
    different origins; the lists are increasing, and a block without a
    live ray lists nothing."""
    v, f = _grid_mesh()
    F = f.shape[0]
    rng = np.random.RandomState(5)
    if scene == "scene":
        o, d, t, fid = _rays_from_scene(v, f, 900)
    else:
        o, d, t, fid = _graze(v, f, 2, 2)
    t = t.copy()
    t[rng.rand(t.shape[0]) < dead_frac] = 0.0
    t[:ok.RB] = 0.0                                  # one all-dead block
    fv = rng.rand(F) < valid_frac
    hier = fk.face_hierarchy(_t(v), _t(f).long(), _t(fv))
    counts, lists = ok.broad_phase(_t(o), _t(d), _t(t), hier)
    blocked = fk.sign_safe_blocked(
        _t(o), _t(d), _t(t) * (1.0 - 1e-4), _t(fid),
        fk.face_soup(_t(v), _t(f).long(), _t(fv), -(-F // fk.GF))[:F],
        torch.arange(F, dtype=torch.int32), 1e-6).numpy()      # [R, F]
    group_of = _group_of(hier, F)
    assert blocked.any() and int(counts[0]) == 0
    mixed = 0
    for b in range(counts.shape[0]):
        rows = slice(b * ok.RB, (b + 1) * ok.RB)
        need = set(group_of[np.nonzero(blocked[rows].any(0))[0]])
        mixed += len(np.unique(o[rows], axis=0)) > 1
        cnt = int(counts[b])
        have = lists[b, :cnt]
        assert need <= set(have.tolist()), (b, sorted(need - set(have.tolist())))
        assert bool((have[1:] > have[:-1]).all())
        assert (lists[b, cnt:] == -1).all()
        if not (t[rows] > 0).any():
            assert cnt == 0
    assert mixed > 0 or scene == "graze"
    assert 0 < float(counts.float().mean()) < hier.group_boxes.shape[0]


def _group_of(hier, F):
    """[F] the hierarchy group that holds each mesh face."""
    group_of = np.empty(F, np.int64)
    group_of[hier.faces[:F].numpy()] = np.arange(F) // fk.GF
    return group_of


def test_face_hierarchy_does_not_depend_on_the_face_order():
    """The hierarchy orders the faces by Morton code itself: a shuffled
    mesh gives the same soup and boxes (the identity order for a mesh in
    Morton order already), with each soup face's index in the mesh."""
    v, f = _grid_mesh()
    perm = np.random.RandomState(4).permutation(f.shape[0])
    fv = np.random.RandomState(3).rand(f.shape[0]) < 0.8
    a = fk.face_hierarchy(_t(v), _t(f).long(), _t(fv))
    b = fk.face_hierarchy(_t(v), _t(f[perm]).long(), _t(fv[perm]))
    F = f.shape[0]
    assert torch.equal(a.faces[:F], torch.arange(F, dtype=torch.int32))
    assert (a.faces[F:] == -1).all()
    assert torch.equal(torch.from_numpy(perm)[b.faces[:F].long()],
                       a.faces[:F].long())
    assert torch.equal(a.soup[:, :10], b.soup[:, :10])
    assert torch.equal(a.soup[:, 10].view(torch.int32), a.faces)
    assert torch.equal(a.group_boxes, b.group_boxes)
    assert torch.equal(a.super_boxes, b.super_boxes)


@pytest.mark.parametrize("kind", ["k1", "k3"])
def test_hierarchy_lists_equal_the_flat_slab_test(kind):
    """A group's box lies in its supergroup's, so the two-level lists are
    exactly the groups that the one-level slab test keeps."""
    v, f = _grid_mesh()
    fv = np.random.RandomState(3).rand(f.shape[0]) < 0.8
    hier = fk.face_hierarchy(_t(v), _t(f).long(), _t(fv))
    if kind == "k1":
        o, d, t, _ = _graze(v, f, 2, 2)
        a, b, half, live, _ = fk.block_hulls(_t(o), _t(d), _t(t), 2)
    else:
        o, d, t, _ = _rays_from_scene(v, f, 900)
        a, b, half, live = ok.block_boxes(_t(o), _t(d), _t(t))
    counts, lists = fk.hier_candidates(a, b, half, live, hier)
    flat = fk._slab_hits(a[:, None], b[:, None], half[:, None],
                         hier.group_boxes[None]) & live[:, None]
    assert torch.equal(counts, flat.sum(1).int())
    for k in range(counts.shape[0]):
        assert torch.equal(lists[k, :counts[k]].long(),
                           torch.nonzero(flat[k])[:, 0])
    assert 0 < int(counts.sum()) < flat.numel()


@pytest.mark.parametrize("ray_tile,face_tile", [(None, 512), (37, 9)])
def test_plain_stages_equal_the_whole_predicate(bumpy_mesh, ray_tile,
                                                face_tile):
    """occluded_plain's two-stage evaluation (u conditions first, the whole
    predicate on the surviving pairs) gives the predicate's any over every
    face, also with dead rays and invalid faces."""
    v, f = bumpy_mesh
    rng = np.random.RandomState(8)
    o, d, t, fid = (np.concatenate(x) for x in zip(
        _rays_from_scene(v, f, 400), _graze(v, f, 2, 3)))
    t = np.where(rng.rand(t.shape[0]) < 0.1, 0.0, t).astype(np.float32)
    fv = rng.rand(f.shape[0]) < 0.9
    args = [_t(x) for x in (o, d, t, fid, v, f, fv)]
    args[5] = args[5].long()
    got = fk.occluded_plain(*args, ray_tile=ray_tile, face_tile=face_tile)
    soup = fk.face_soup(args[4], args[5], args[6], -(-f.shape[0] // fk.GF))
    want = fk.sign_safe_blocked(
        args[0], args[1], args[2] * (1.0 - 1e-4), args[3],
        soup[:f.shape[0]], torch.arange(f.shape[0], dtype=torch.int32),
        1e-6).any(1)
    assert torch.equal(got, want)
    assert want.any() and (~want).any()


def test_trace_chunk_backends_agree(bumpy_mesh):
    """trace_chunk with 'auto' (K3's plain version) and 'jnp' (divide-based)
    give the same rays on the tests' scene."""
    v, f = bumpy_mesh
    mesh = pt.make_mesh(v, f, device="cpu")
    cfg = pt.RenderConfig(num_samples=400, num_bins=300,
                          distance_resolution=5e-3)
    lighting, lnormal = (_t(x) for x in pt.make_confocal_scan(4))
    spt = cfg.samples_per_face(f.shape[0])
    a = core.trace_chunk(mesh, lighting, lnormal, pt.key(KEY), cfg, spt)
    b = core.trace_chunk(mesh, lighting, lnormal, pt.key(KEY),
                         cfg.replace(occl_backend="jnp"), spt)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert (~a.valid).any()


@pytest.mark.parametrize("jax_backend,source_chunk", [
    ("auto", 0), ("pallas", 0), ("auto", 3)])
def test_render_intensity_matches_jax(bumpy_mesh, jax_backend, source_chunk):
    """render_intensity on the CPU against JAX's default (the divide-based
    jnp visibility on the CPU) and JAX's Pallas K3 in interpret mode; the
    cull masks it gives are equal."""
    v, f = bumpy_mesh
    kw = dict(num_samples=400, num_bins=300, distance_resolution=5e-3,
              source_chunk=source_chunk)
    lighting, lnormal = nst.make_confocal_scan(4)
    want = np.asarray(jintensity(
        jmesh.make_mesh(v, f), lighting, lnormal,
        nst.RenderConfig(occl_backend=jax_backend, **kw),
        jax.random.key(KEY)))
    got = pt.render_intensity(pt.make_mesh(v, f, device="cpu"), lighting,
                              lnormal, pt.RenderConfig(**kw), pt.key(KEY))
    assert got.shape == (f.shape[0],) and want.max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)
    aff = jtopology.face_affinity(f)
    keep_j = jtopology.remove_triangles(f, aff, want)
    keep_p = topology.remove_triangles(f, topology.face_affinity(f),
                                       got.numpy())
    np.testing.assert_array_equal(keep_p, keep_j)


def test_pallas_backend_end_to_end(bumpy_mesh):
    """occl_backend='pallas' (K3 + the eager splat) gives the transient of
    'auto' (K1), as the JAX package's test of the same name checks."""
    v, f = bumpy_mesh
    mesh = pt.make_mesh(v, f, device="cpu")
    lighting, lnormal = pt.make_confocal_scan(4)
    cfg = pt.RenderConfig(num_samples=400, num_bins=300,
                          distance_resolution=5e-3)
    t_auto, _ = pt.render_transient(mesh, lighting, lnormal, cfg, pt.key(3),
                                    refine=1)
    t_pal, _ = pt.render_transient(mesh, lighting, lnormal,
                                   cfg.replace(occl_backend="pallas"),
                                   pt.key(3), refine=1)
    torch.testing.assert_close(t_pal, t_auto, rtol=2e-5, atol=1e-8)
    assert float(t_auto.max()) > 0


def test_segment_occluded_refuses_other_devices():
    x = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError):
        ok.segment_occluded(x, x, x[:, 0], x[:, 0].int(), x, x.long(),
                            x[:, 0].bool())


def test_mt_coefficients_match_jax():
    """The matmul form's per-face blocks: JAX's op by op (disable_jit) bit
    for bit; JAX's eager call, whose jnp.cross XLA compiles and fuses,
    within 1e-6 of the largest coefficient."""
    soup = np.random.RandomState(2).randn(3, 5, 10).astype(np.float32)
    soup[..., 9] = soup[..., 9] > 0
    B, val = mt_coefficients(_t(soup))
    assert B.shape == (3, 10, 20) and val.shape == (3, 5)
    with jax.enable_x64(False):
        want_fused = np.asarray(jaccel.mt_coefficients(jnp.asarray(soup))[0])
        with jax.disable_jit():
            want, want_val = (np.asarray(x) for x in
                              jaccel.mt_coefficients(jnp.asarray(soup)))
    np.testing.assert_array_equal(B.numpy(), want)
    np.testing.assert_array_equal(val.numpy(), want_val)
    np.testing.assert_allclose(B.numpy(), want_fused, rtol=0,
                               atol=1e-6 * np.abs(want_fused).max())


def _mxu_rays(f, n=700, seed=1):
    """tests/test_mxu_narrow.py's rays: wall origins to random targets
    above and beyond the layered mesh, each with a random self face."""
    rng = np.random.RandomState(seed)
    o = np.zeros((n, 3), np.float32)
    o[:, :2] = rng.uniform(-0.25, 0.25, (n, 2))
    tgt = np.stack([rng.uniform(-0.25, 0.25, n), rng.uniform(-0.25, 0.25, n),
                    rng.uniform(0.25, 0.6, n)], 1).astype(np.float32)
    d = tgt - o
    t = np.linalg.norm(d, axis=1)
    d = (d / t[:, None]).astype(np.float32)
    return o, d, t.astype(np.float32), rng.randint(
        0, f.shape[0], n).astype(np.int32)


@pytest.mark.parametrize("tile,ray_chunk,valid", [
    (512, 16384, "all"), (7, 13, "all"), (512, 100, "half")])
def test_segment_occluded_mxu_matches_jax(tile, ray_chunk, valid):
    """The matmul-form narrow phase against JAX's (jitted) and against the
    divide-based eager predicate: each disagreeing on fewer than 1e-3 of
    the rays (tests/test_mxu_narrow.py's bound); the count is printed."""
    v, f = _layered_mesh()
    fv = np.ones(f.shape[0], bool)
    if valid == "half":
        fv[::2] = False
    rays = _mxu_rays(f)
    jargs = [jnp.asarray(x) for x in rays + (v, f, fv)]
    with jax.enable_x64(False):
        want = np.asarray(jintersect.segment_occluded_mxu(*jargs))
    pargs = [_t(x) for x in rays + (v, f.astype(np.int64), fv)]
    got = intersect.segment_occluded_mxu(*pargs, tile=tile,
                                         ray_chunk=ray_chunk).numpy()
    eager = intersect.segment_occluded(*pargs).numpy()
    print("mxu rays differing: from JAX's", int((got != want).sum()),
          "from the eager predicate", int((got != eager).sum()), "of",
          len(got))
    assert want.any() and (~want).any()
    assert (got != want).mean() < 1e-3
    assert (got != eager).mean() < 1e-3


def test_render_intensity_mxu_matches_jax(bumpy_mesh):
    """render_intensity through the matmul form (trace_chunk with
    occl_backend 'mxu') against JAX's with 'mxu'; equal cull masks."""
    v, f = bumpy_mesh
    kw = dict(num_samples=400, num_bins=300, distance_resolution=5e-3,
              occl_backend="mxu")
    lighting, lnormal = nst.make_confocal_scan(4)
    want = np.asarray(jintensity(jmesh.make_mesh(v, f), lighting, lnormal,
                                 nst.RenderConfig(**kw), jax.random.key(KEY)))
    got = pt.render_intensity(pt.make_mesh(v, f, device="cpu"), lighting,
                              lnormal, pt.RenderConfig(**kw), pt.key(KEY))
    assert want.max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)
    aff = topology.face_affinity(f)
    np.testing.assert_array_equal(
        topology.remove_triangles(f, aff, got.numpy()),
        topology.remove_triangles(f, aff, want))


def test_trace_chunk_mxu_agrees_with_jnp(bumpy_mesh):
    """trace_chunk with 'mxu' gives the rays of the divide-based 'jnp' on
    the tests' scene."""
    v, f = bumpy_mesh
    mesh = pt.make_mesh(v, f, device="cpu")
    cfg = pt.RenderConfig(num_samples=400, num_bins=300,
                          distance_resolution=5e-3)
    lighting, lnormal = (_t(x) for x in pt.make_confocal_scan(4))
    spt = cfg.samples_per_face(f.shape[0])
    a = core.trace_chunk(mesh, lighting, lnormal, pt.key(KEY),
                         cfg.replace(occl_backend="mxu"), spt)
    b = core.trace_chunk(mesh, lighting, lnormal, pt.key(KEY),
                         cfg.replace(occl_backend="jnp"), spt)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert (~a.valid).any()
