"""The port's standalone visibility (kernel K3, render/occl_kernels.py),
trace_chunk and render_intensity against the JAX package.

On the CPU the K3 wrapper runs its plain version (fused_kernels.
occluded_plain, every face tested); the JAX kernel runs in interpret
mode.  The broad phase and the per-group launch plan, which only the CUDA
path runs, are checked here by emulating the kernel's narrow phase over
the broad phase's lists with the plain predicate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nlos_surface_optimization_tpu as nst
from nlos_surface_optimization_tpu.geometry import mesh as jmesh
from nlos_surface_optimization_tpu.geometry import topology as jtopology
from nlos_surface_optimization_tpu.geometry.intersect import segment_occluded
from nlos_surface_optimization_tpu.render import pallas_kernels as jpk
from nlos_surface_optimization_tpu.render import render_intensity as jintensity

import nlos_surface_optimization_torch as pt
from nlos_surface_optimization_torch.geometry import topology
from nlos_surface_optimization_torch.render import core
from nlos_surface_optimization_torch.render import fused_kernels as fk
from nlos_surface_optimization_torch.render import occl_kernels as ok

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


def _emulated_kernel(o, d, t, fid, v, f, fv, t_rel=1e-4, t_min=1e-6):
    """The CUDA path's plan on the CPU: ray groups, the broad phase's
    candidate lists per 128-ray block, and the plain predicate against the
    listed groups' faces only (every group when the list overflowed)."""
    F = f.shape[0]
    ng = -(-F // fk.GF)
    boxes = fk._group_boxes(v, f, fv, ng, fk.GF)
    soup = fk.face_soup(v, f, fv, ng)
    fids = torch.arange(ng * fk.GF, dtype=torch.int32)
    occ = torch.zeros(o.shape[0], dtype=torch.bool)
    groups = ok.ray_groups(o.shape[0], ng)
    for r0, r1 in groups:
        counts, lists = ok.broad_phase(o[r0:r1], d[r0:r1], t[r0:r1], boxes,
                                       ka_max=ok.KA_MAX)
        for b in range(counts.shape[0]):
            rows = slice(r0 + b * ok.RB, min(r0 + (b + 1) * ok.RB, r1))
            cnt = int(counts[b])
            gids = (torch.arange(ng) if cnt > ok.KA_MAX
                    else lists[b, :cnt].long())
            faces = (gids[:, None] * fk.GF + torch.arange(fk.GF)).reshape(-1)
            hit = fk.sign_safe_blocked(o[rows], d[rows], t[rows] * (1 - t_rel),
                                       fid[rows], soup[faces], fids[faces],
                                       t_min)
            occ[rows] = hit.any(1)
    return occ, len(groups)


@pytest.mark.parametrize("n_rays,valid,group_pairs,ka_max", [
    (700, "all", ok.GROUP_PAIRS, ok.KA_MAX),  # test_pallas: the reference
    (513, "all", ok.GROUP_PAIRS, ok.KA_MAX),  # not a multiple of the block
    (256, "none", ok.GROUP_PAIRS, ok.KA_MAX),  # nothing can occlude
    (1300, "all", 1, ok.KA_MAX),      # multigroup: one block per group
    (700, "all", ok.GROUP_PAIRS, 1),  # lists overflow: full-scan blocks
])
def test_segment_occluded_matches_jax(bumpy_mesh, monkeypatch, n_rays, valid,
                                      group_pairs, ka_max):
    v, f = bumpy_mesh
    o, d, t, fid = _rays_from_scene(v, f, n_rays)
    fv = np.full(f.shape[0], valid == "all")
    args = [jnp.asarray(x) for x in (o, d, t, fid, v, f, fv)]
    ref = np.asarray(segment_occluded(*args))
    if group_pairs == 1:   # JAX's grouped path: 1 block (512 rays) a call
        monkeypatch.setattr(jpk, "MAX_NB", 1)
        pal = jpk.segment_occluded_pallas.__wrapped__(*args, interpret=True)
    else:
        pal = jpk.segment_occluded_pallas(*args, interpret=True)
    pargs = [_t(x) for x in (o, d, t, fid, v, f, fv)]
    pargs[5] = pargs[5].long()
    got = ok.segment_occluded(*pargs).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.asarray(pal))
    if valid == "all":
        assert ref.any() and (~ref).any()
    else:
        assert not got.any()
    monkeypatch.setattr(ok, "GROUP_PAIRS", group_pairs)
    monkeypatch.setattr(ok, "KA_MAX", ka_max)
    emu, n_groups = _emulated_kernel(*pargs)
    assert n_groups == (-(-n_rays // ok.RB) if group_pairs == 1 else 1)
    np.testing.assert_array_equal(emu.numpy(), ref)


@pytest.mark.parametrize("scene,valid_frac,dead_frac", [
    ("scene", 1.0, 0.0), ("scene", 0.7, 0.2), ("graze", 1.0, 0.2)])
def test_broad_phase_lists_cover_every_blocker(bumpy_mesh, scene, valid_frac,
                                               dead_frac):
    """Every 8-face group holding a face that blocks one of a block's rays
    is on that block's list (or the block scans everything), also for
    blocks whose rays come from different origins."""
    v, f = bumpy_mesh
    F = f.shape[0]
    rng = np.random.RandomState(5)
    if scene == "scene":
        o, d, t, fid = _rays_from_scene(v, f, 900)
    else:
        o, d, t, fid = _graze(v, f, 3, 3)
    t = t.copy()
    t[rng.rand(t.shape[0]) < dead_frac] = 0.0
    fv = rng.rand(F) < valid_frac
    ng = -(-F // fk.GF)
    boxes = fk._group_boxes(_t(v), _t(f).long(), _t(fv), ng, fk.GF)
    counts, lists = ok.broad_phase(_t(o), _t(d), _t(t), boxes)
    soup = fk.face_soup(_t(v), _t(f).long(), _t(fv), ng)[:F]
    blocked = fk.sign_safe_blocked(
        _t(o), _t(d), _t(t) * (1.0 - 1e-4), _t(fid), soup,
        torch.arange(F, dtype=torch.int32), 1e-6).numpy()      # [R, F]
    assert blocked.any()
    mixed = 0
    for b in range(counts.shape[0]):
        rows = slice(b * ok.RB, (b + 1) * ok.RB)
        need = set(np.nonzero(blocked[rows].any(0))[0] // fk.GF)
        mixed += len(np.unique(o[rows], axis=0)) > 1
        cnt = int(counts[b])
        if cnt > ok.KA_MAX:
            continue
        have = set(lists[b, :cnt].tolist())
        assert need <= have, (b, sorted(need - have))
        assert (lists[b, cnt:] == ng).all()
        if not (t[rows] > 0).any():
            assert cnt == 0
    assert mixed > 0 or scene == "graze"


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
