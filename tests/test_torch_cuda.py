"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports nothing of JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py

(--noconftest: the repository's conftest imports JAX).  Where there is no
CUDA device every test here skips."""

import numpy as np
import pytest
import torch

import nlos_surface_optimization_torch as pt
from nlos_surface_optimization_torch.render import bwd_kernels as bk
from nlos_surface_optimization_torch.render import core
from nlos_surface_optimization_torch.render import fused_kernels as fk
from nlos_surface_optimization_torch.render import occl_kernels as ok

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bumpy(n=6):
    """The tests' small irregular height field (tests/conftest.py)."""
    rng = np.random.RandomState(0)
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


def _graze(v, f, Lc, spt, num_bins, seed=1):
    """Rays from far off-axis sources that graze the bumps."""
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
    d = (d / t[:, None]).astype(np.float32)
    contrib = rng.rand(R).astype(np.float32)
    bins = rng.randint(0, num_bins, R).astype(np.int32)
    return o, d, t, fi, contrib, bins


@pytest.mark.parametrize("cap", [fk.LIST_CAP, 1])   # 1: a pass per group
@pytest.mark.parametrize("num_bins", [384, 12000])
def test_occluded_splat_kernel_matches_plain(cuda, cap, num_bins):
    v, f = _bumpy()
    mesh = pt.make_mesh(v, f, device=cuda)
    args = tuple(torch.from_numpy(x).to(cuda)
                 for x in _graze(v, f, 3, 2, num_bins))
    args += (mesh.v, mesh.f, mesh.f_valid, 3, num_bins)
    hier = fk.face_hierarchy(mesh.v, mesh.f, mesh.f_valid)
    before = fk.occluded_splat.launches
    occ, hist, _ = fk.kernel_call(*args[:6], hier, 3, num_bins, 1e-4, 1e-6,
                                  cap=cap)
    occ2, hist2 = fk.occluded_splat(*args)
    occ_p, hist_p = fk.occluded_splat_plain(*args)
    torch.cuda.synchronize()
    assert occ.any() and torch.equal(occ, occ_p)
    assert torch.equal(occ, occ2) and torch.equal(hist, hist2)
    torch.testing.assert_close(hist, hist_p, rtol=2e-6,
                               atol=1e-7 * float(hist_p.abs().max()))
    assert fk.occluded_splat.launches - before == 2


@pytest.mark.parametrize("kind", ["k1", "k3"])
def test_kernel_counts_equal_the_plain_broad_phase(cuda, kind):
    """The groups each block lists (summed over its passes) are the plain
    broad phase's, at capacity 1 as at the default."""
    v, f = _bumpy(12)
    mesh = pt.make_mesh(v, f, device=cuda)
    hier = fk.face_hierarchy(mesh.v, mesh.f, mesh.f_valid)
    if kind == "k1":
        rays = [torch.from_numpy(x).to(cuda) for x in _graze(v, f, 2, 2, 64)]
        rays[2][::7] = 0.0                                      # dead rays
        want, _, _ = fk.broad_phase(*rays[:3], 2, hier)
        for cap in (fk.LIST_CAP, 1):
            got = fk.kernel_call(*rays, hier, 2, 64, 1e-4, 1e-6, cap=cap)[2]
            assert torch.equal(got, want)
    else:
        rays = [torch.from_numpy(x).to(cuda) for x in _mixed_rays(v, f, 900)]
        rays[2][::5] = 0.0
        want, _ = ok.broad_phase(*rays[:3], hier)
        for cap in (fk.LIST_CAP, 1):
            got = ok.kernel_call(*rays, hier, 1e-4, 1e-6, cap=cap)[1]
            assert torch.equal(got, want)
    assert int(want.sum()) > 0


def test_splat_reduce_split_over_bin_ranges_is_bit_identical(cuda):
    """The reduce (two slabs of block runs a source here) gives the same
    histogram, bit for bit, for any split of the bins into ranges and from
    launch to launch, within the tolerance of the plain splat."""
    v, f = _bumpy()
    mesh = pt.make_mesh(v, f, device=cuda)
    args = tuple(torch.from_numpy(x).to(cuda)
                 for x in _graze(v, f, 3, 400, 5000))
    hier = fk.face_hierarchy(mesh.v, mesh.f, mesh.f_valid)
    _, _, bins, vals = fk.occlusion_call(*args, hier, 3, 5000, 1e-4, 1e-6)
    hists = [fk.reduce_call(bins, vals, 3, 5000, ranges)
             for ranges in (1, None, None, 7, 40)]
    _, hist_p = fk.occluded_splat_plain(*args, mesh.v, mesh.f, mesh.f_valid,
                                        3, 5000)
    torch.cuda.synchronize()
    nbs = bins.shape[0] // (3 * fk.RB)
    ranges, slabs = fk.reduce_plan(3, 5000, nbs, torch.cuda.
                                   get_device_properties(cuda)
                                   .multi_processor_count)
    assert ranges > 1 and slabs == 2
    assert float(hists[0].abs().max()) > 0
    for h in hists[1:]:
        assert torch.equal(h, hists[0])
    torch.testing.assert_close(hists[0], hist_p, rtol=2e-6,
                               atol=1e-7 * float(hist_p.abs().max()))


def _k2_chunk(cuda, normal, testing_flag, num_samples, scan=5, n=6):
    """One traced chunk of the small height field on the card: (mesh,
    cfg, lnormal, spt, rays, diff); scan x scan sources (25 > one slab)."""
    v, f = _bumpy(n)
    mesh = pt.make_mesh(v, f, device=cuda)
    if normal == "vn":
        mesh = mesh._replace(vn=pt.vertex_normals(mesh.v, mesh.f,
                                                  mesh.f_valid))
    cfg = pt.RenderConfig(num_samples=num_samples, num_bins=300,
                          distance_resolution=5e-3, normal=normal,
                          testing_flag=testing_flag)
    lighting, lnormal = (torch.from_numpy(x).to(cuda)
                         for x in pt.make_confocal_scan(scan))
    spt = cfg.samples_per_face(f.shape[0])
    rays = core.trace_chunk(mesh, lighting, lnormal, pt.key(11), cfg, spt)
    diff = torch.from_numpy((np.random.RandomState(0).randn(
        scan * scan, 300) * 1e-3).astype(np.float32)).to(cuda)
    return mesh, cfg, lnormal, spt, rays, diff


@pytest.mark.parametrize("num_samples", [50, 350, 5250, 20000])  # spt 1, 7,
@pytest.mark.parametrize("normal,testing_flag", [                # 105, 400
    ("fn", 1), ("vn", 0), ("vn", 1)])
def test_backward_face_sums_kernel_matches_plain(cuda, normal, testing_flag,
                                                 num_samples):
    """K2 and its epilogue against their plain versions and the eager
    backward_chunk (tap tables); two launches bit-identical; the epilogue
    adds into a running gradient exactly as torch adds."""
    mesh, cfg, lnormal, spt, rays, diff = _k2_chunk(cuda, normal,
                                                    testing_flag, num_samples)
    args = bk.face_sum_inputs(rays, lnormal, diff, 0, cfg, spt)
    before = (bk.backward_face_sums.launches, bk.vertex_epilogue.launches)
    partial = bk.backward_face_sums(*args)
    partial2 = bk.backward_face_sums(*args)
    sums_p = bk.backward_face_sums_plain(*args)
    csr = bk.vertex_csr(mesh.f, mesh.f_valid, mesh.v.shape[0])
    g = bk.vertex_epilogue(partial, mesh, csr)
    g2 = bk.vertex_epilogue(partial2, mesh, csr)
    g0 = torch.randn(g.shape, generator=torch.Generator().manual_seed(0)).to(
        cuda)
    acc = bk.vertex_epilogue(partial, mesh, csr, g0.clone())
    torch.cuda.synchronize()
    assert torch.equal(partial, partial2) and torch.equal(g, g2)
    assert torch.equal(acc, g0 + g)
    assert (bk.backward_face_sums.launches - before[0],
            bk.vertex_epilogue.launches - before[1]) == (2, 3)
    sums = bk.slab_sum(partial)
    torch.testing.assert_close(sums, sums_p, rtol=2e-4,
                               atol=2e-5 * float(sums_p.abs().max()))
    g_ref = core.backward_chunk(rays, mesh, lnormal, diff, 0, cfg, spt)
    scale = float(g_ref.abs().max())
    assert scale > 0
    torch.testing.assert_close(g, g_ref, rtol=2e-4, atol=2e-5 * scale)
    torch.testing.assert_close(g, bk.vertex_gradient(sums, mesh), rtol=2e-4,
                               atol=2e-5 * scale)


@pytest.mark.parametrize("slab", [4, 7, 25])
def test_backward_face_sums_any_slab(cuda, slab):
    """Slabs that do not divide the 25 sources (4, 7) and one slab: the
    same sums as the default plan within the plain version's tolerance."""
    mesh, cfg, lnormal, spt, rays, diff = _k2_chunk(cuda, "vn", 0, 350)
    args = bk.face_sum_inputs(rays, lnormal, diff, 0, cfg, spt)
    partial = bk.backward_face_sums(*args, slab=slab)
    assert partial.shape[0] == -(-25 // slab)
    sums_p = bk.backward_face_sums_plain(*args)
    torch.testing.assert_close(bk.slab_sum(partial), sums_p, rtol=2e-4,
                               atol=2e-5 * float(sums_p.abs().max()))
    assert torch.equal(partial, bk.backward_face_sums(*args, slab=slab))


def _no_sync(fn):
    """fn() with every synchronizing CUDA call raising."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("normal,testing_flag", [("fn", 1), ("vn", 0)])
def test_backward_chunk_fused_makes_no_synchronizing_call(cuda, normal,
                                                          testing_flag):
    """One chunk's fused backward, with the CSR built and the tap weights
    cached, makes no host <-> device copy or synchronization."""
    mesh, cfg, lnormal, spt, rays, diff = _k2_chunk(cuda, normal,
                                                    testing_flag, 350)
    csr = bk.vertex_csr(mesh.f, mesh.f_valid, mesh.v.shape[0])

    def chunk(grad):
        return bk.backward_chunk_fused(rays, mesh, lnormal, diff, 0, cfg,
                                       spt, csr=csr, grad=grad)
    want = chunk(chunk(None).clone())
    first = _no_sync(lambda: chunk(None))
    got = _no_sync(lambda: chunk(first.clone()))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_fused_chunk_body_makes_no_synchronizing_call(cuda):
    """A whole chunk of inverse_render (sampling, K1, smoothing, the
    difference, K2, the epilogue), with the key on the card and the face
    hierarchy and CSR built, makes no synchronizing call."""
    from nlos_surface_optimization_torch.render import api

    v, f = _bumpy()
    mesh = pt.make_mesh(v, f, device=cuda)
    cfg = pt.RenderConfig(num_samples=400, num_bins=300,
                          distance_resolution=5e-3)
    lighting, lnormal = (torch.from_numpy(x).to(cuda)
                         for x in pt.make_confocal_scan(4))
    data = torch.rand((16, 300), generator=torch.Generator().manual_seed(1)
                      ).to(cuda) * 1e-3
    w = torch.ones_like(data)
    spt = cfg.samples_per_face(f.shape[0])
    hier = fk.face_hierarchy(mesh.v, mesh.f, mesh.f_valid)
    csr = bk.vertex_csr(mesh.f, mesh.f_valid, mesh.v.shape[0])
    key = pt.key(3).to(cuda)

    def chunk():
        return api._fused_chunk_body(mesh, lighting, lnormal, 0, key, data,
                                     w, cfg, spt, hier, csr, None)
    t_want, g_want = chunk()
    t, g = _no_sync(chunk)
    torch.cuda.synchronize()
    assert torch.equal(t, t_want) and torch.equal(g, g_want)


@pytest.mark.parametrize("source_chunk", [0, 3])
def test_inverse_render_card_matches_cpu(cuda, source_chunk):
    v, f = _bumpy()
    lighting, lnormal = pt.make_confocal_scan(4)
    cfg = pt.RenderConfig(num_samples=400, num_bins=300,
                          distance_resolution=5e-3, source_chunk=source_chunk)
    data = (np.random.RandomState(1).rand(16, 300) * 1e-3).astype(np.float32)
    w = np.ones((16, 300), np.float32)
    out = []
    for dev in (cuda, "cpu"):
        t, g, _ = pt.inverse_render(pt.make_mesh(v, f, device=dev), data, w,
                                    lighting, lnormal, cfg, pt.key(3))
        out.append((t.cpu(), g.cpu()))
    (t, g), (t_c, g_c) = out
    torch.testing.assert_close(t, t_c, rtol=2e-5, atol=1e-8)
    torch.testing.assert_close(g, g_c, rtol=2e-4, atol=1e-7)


def test_uniforms_on_the_card_equal_the_cpu(cuda):
    from nlos_surface_optimization_torch.geometry import sampling

    k = pt.key(7)
    S, T = sampling.uniforms_for(k, 5, 37, 7, source_offset=4095, device=cuda)
    S_c, T_c = sampling.uniforms_for(k, 5, 37, 7, source_offset=4095,
                                     device="cpu")
    assert torch.equal(S.cpu(), S_c) and torch.equal(T.cpu(), T_c)


def _mixed_rays(v, f, n, seed=0):
    """test_pallas.py's rays: random wall origins (a block mixes origins)
    toward random targets above the surface."""
    rng = np.random.RandomState(seed)
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = rng.uniform(-0.25, 0.25, n)
    o[:, 1] = rng.uniform(-0.25, 0.25, n)
    tgt = np.stack([rng.uniform(-0.25, 0.25, n), rng.uniform(-0.25, 0.25, n),
                    rng.uniform(0.4, 0.6, n)], 1).astype(np.float32)
    d = tgt - o
    t = np.linalg.norm(d, axis=1)
    fid = rng.randint(0, f.shape[0], n).astype(np.int32)
    return o, (d / t[:, None]).astype(np.float32), t.astype(np.float32), fid


@pytest.mark.parametrize("cap", [fk.LIST_CAP, 1])   # 1: a pass per group
@pytest.mark.parametrize("scene", ["bumpy", "graze", "big"])
def test_segment_occluded_kernel_matches_plain(cuda, cap, scene):
    """K3 on mixed-origin rays, on grazing rays ordered by source, and on a
    height field above 65,536 faces; one launch per call."""
    if scene == "big":
        v, f = _bumpy(200)                                # 79,202 faces
        rays = _mixed_rays(v, f, 3000)
    else:
        v, f = _bumpy()
        rays = (_mixed_rays(v, f, 700) if scene == "bumpy"
                else _graze(v, f, 3, 2, 10)[:4])
    mesh = pt.make_mesh(v, f, device=cuda)
    args = tuple(torch.from_numpy(x).to(cuda) for x in rays) + (
        mesh.v, mesh.f, mesh.f_valid)
    hier = fk.face_hierarchy(*args[4:])
    before = ok.segment_occluded.launches
    occ, _ = ok.kernel_call(*args[:4], hier, 1e-4, 1e-6, cap=cap)
    occ2 = ok.segment_occluded(*args)
    occ_p = fk.occluded_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(occ, occ_p) and torch.equal(occ, occ2)
    assert occ.any() and (~occ).any()
    assert ok.segment_occluded.launches - before == 2
    if scene == "big":
        assert f.shape[0] > 65536


def test_segment_occluded_refuses_bad_inputs(cuda):
    v, f = _bumpy()
    mesh = pt.make_mesh(v, f, device=cuda)
    o, d, t, fid = (torch.from_numpy(x).to(cuda)
                    for x in _mixed_rays(v, f, 64))
    with pytest.raises(ValueError):
        ok.segment_occluded(o, d, t, fid.long(), mesh.v, mesh.f, mesh.f_valid)
    with pytest.raises(ValueError):
        ok.segment_occluded(o, d, t.cpu(), fid, mesh.v, mesh.f, mesh.f_valid)


@pytest.mark.parametrize("backend", ["auto", "fused", "pallas"])
def test_trace_chunk_reaches_k3_on_the_card(cuda, backend):
    v, f = _bumpy()
    cfg = pt.RenderConfig(num_samples=400, num_bins=300,
                          distance_resolution=5e-3, occl_backend=backend)
    lighting, lnormal = (torch.from_numpy(x) for x in pt.make_confocal_scan(4))
    spt = cfg.samples_per_face(f.shape[0])
    before = ok.segment_occluded.launches
    rays = core.trace_chunk(pt.make_mesh(v, f, device=cuda),
                            lighting.to(cuda), lnormal.to(cuda), pt.key(3),
                            cfg, spt)
    rays_c = core.trace_chunk(pt.make_mesh(v, f, device="cpu"), lighting,
                              lnormal, pt.key(3), cfg, spt)
    assert ok.segment_occluded.launches > before
    assert torch.equal(rays.valid.cpu(), rays_c.valid)


@pytest.mark.parametrize("source_chunk", [0, 3])
def test_render_intensity_card_matches_cpu(cuda, source_chunk):
    from nlos_surface_optimization_torch.geometry import topology

    v, f = _bumpy()
    lighting, lnormal = pt.make_confocal_scan(4)
    cfg = pt.RenderConfig(num_samples=400, num_bins=300,
                          distance_resolution=5e-3, source_chunk=source_chunk)
    got, want = (pt.render_intensity(pt.make_mesh(v, f, device=dev),
                                     lighting, lnormal, cfg, pt.key(3)).cpu()
                 for dev in (cuda, "cpu"))
    torch.testing.assert_close(got, want, rtol=2e-5, atol=0.0)
    aff = topology.face_affinity(f)
    assert np.array_equal(topology.remove_triangles(f, aff, got.numpy()),
                          topology.remove_triangles(f, aff, want.numpy()))


@pytest.mark.parametrize("normal,testing_flag", [("fn", 1), ("vn", 0)])
def test_occluded_splat_kernel_matches_plain_on_a_ggx_chunk(cuda, normal,
                                                            testing_flag):
    """K1 on a GGX chunk (the BRDF-weighted contribution, alpha 0.2):
    equal masks, histogram within its tolerance, two launches equal."""
    v, f = _bumpy(12)
    mesh = pt.make_mesh(v, f, device=cuda)
    if normal == "vn":
        mesh = mesh._replace(vn=pt.vertex_normals(mesh.v, mesh.f,
                                                  mesh.f_valid))
    cfg = pt.RenderConfig(num_samples=4000, num_bins=300,
                          distance_resolution=5e-3, brdf="ggx",
                          normal=normal, testing_flag=testing_flag)
    lighting, lnormal = (torch.from_numpy(x).to(cuda)
                         for x in pt.make_confocal_scan(5))
    spt = cfg.samples_per_face(f.shape[0])
    _, args, kwargs = core.splat_inputs(
        mesh, lighting, lnormal, pt.key(3).to(cuda), cfg, spt,
        cfg.bin_refine_resolution, alpha=torch.tensor(0.2, device=cuda))
    _, lam, _ = core.splat_inputs(
        mesh, lighting, lnormal, pt.key(3).to(cuda), cfg.replace(
            brdf="lambertian"), spt, cfg.bin_refine_resolution)
    assert not torch.equal(args[4], lam[4])        # the BRDF is applied
    before = fk.occluded_splat.launches
    occ, hist = fk.occluded_splat(*args, **kwargs)
    occ2, hist2 = fk.occluded_splat(*args, **kwargs)
    occ_p, hist_p = fk.occluded_splat_plain(*args, **kwargs)
    torch.cuda.synchronize()
    assert fk.occluded_splat.launches - before == 2
    assert torch.equal(occ, occ_p) and torch.equal(occ, occ2)
    assert torch.equal(hist, hist2) and float(hist_p.max()) > 0
    torch.testing.assert_close(hist, hist_p, rtol=2e-6,
                               atol=1e-7 * float(hist_p.abs().max()))


def test_inverse_render_jitter_card_matches_cpu(cuda):
    """inverse_render_jitter through K3 on the card against the CPU (plain
    occlusion) at the CPU tests' tolerances; one K3 launch a chunk."""
    v, f = _bumpy()
    lighting, lnormal = pt.make_confocal_scan(6)
    cfg = pt.RenderConfig(num_samples=500, num_bins=500,
                          distance_resolution=5e-3, source_chunk=10)
    w = np.random.RandomState(3).rand(31)
    w /= w.sum()
    jg = np.gradient(w)
    rng = np.random.RandomState(4)
    data = (rng.rand(36, 500) * 1e-3).astype(np.float32)
    weight = (0.5 + rng.rand(36, 500)).astype(np.float32)
    before = ok.segment_occluded.launches
    t, g, _ = pt.inverse_render_jitter(pt.make_mesh(v, f, device=cuda), data,
                                       weight, lighting, lnormal, cfg,
                                       pt.key(13), w, jg, 25)
    assert ok.segment_occluded.launches - before == 4
    t_c, g_c, _ = pt.inverse_render_jitter(pt.make_mesh(v, f, device="cpu"),
                                           data, weight, lighting, lnormal,
                                           cfg, pt.key(13), w, jg, 25)
    torch.testing.assert_close(t.cpu(), t_c, rtol=2e-5, atol=1e-8)
    scale = float(g_c.abs().max())
    assert scale > 0
    torch.testing.assert_close(g.cpu(), g_c, rtol=2e-4, atol=2e-5 * scale)


def test_jitter_convolve_ignores_global_tf32(cuda):
    """With cuDNN's TF32 switched on globally, jitter_convolve on the card
    still equals the CPU's f32 result within f32 rounding of a 901-term
    sum (rtol 1e-5 / atol 1e-6*max; TF32 would be off by ~1e-3), and
    leaves the global switch as it found it."""
    from nlos_surface_optimization_torch.render.kernels import jitter_convolve

    rng = np.random.RandomState(5)
    hist = torch.from_numpy(rng.rand(64, 1200).astype(np.float32))
    w = rng.rand(901)
    w /= w.sum()
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = jitter_convolve(hist.to(cuda), w, 21).cpu()
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    want = jitter_convolve(hist, w, 21)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))


def test_nearest_hit_card_matches_cpu(cuda):
    """nearest_hit on the card against the CPU: +z rays from a grid over
    the bumpy field (some miss) and from its vertices (equal t on the
    faces around a vertex: the lowest id wins on both), the faces in two
    tiles of 7 and one of 512."""
    from nlos_surface_optimization_torch.geometry.intersect import (
        nearest_hit,
    )

    v, f = _bumpy(9)
    xs = np.linspace(-0.3, 0.3, 20)
    gx, gy = np.meshgrid(xs, xs)
    o = np.concatenate([np.stack([gx.ravel(), gy.ravel(), 0 * gx.ravel()],
                                 1), v * np.float32([1, 1, 0])])
    o = torch.from_numpy(o.astype(np.float32))
    d = torch.zeros_like(o)
    d[:, 2] = 1.0
    for tile in (7, 512):
        out = {}
        for where in (cuda, "cpu"):
            m = pt.make_mesh(v, f, device=where)
            out[str(where)] = [x.cpu() for x in nearest_hit(
                o.to(where), d.to(where), m.v, m.f, m.f_valid, tile=tile)]
        got, want = out[str(cuda)], out["cpu"]
        assert torch.equal(got[0], want[0])
        assert (want[0] >= 0).sum() > v.shape[0] and (want[0] < 0).any()
        for a, b in zip(got[1:], want[1:]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_spad_chunk_invariance_on_card(cuda):
    """The SPAD model on the card: one key a point, so source_chunk 5 and
    64 give the same counts, pileup off and on; a point alone from its own
    key gives its row."""
    from nlos_surface_optimization_torch.geometry import sampling
    from nlos_surface_optimization_torch.noise import (
        SpadParams,
        spad_model,
        spad_noisy_transients,
    )

    rng = np.random.RandomState(2)
    ideal = rng.rand(40, 600) * (np.arange(600) > 200)
    jt = np.linspace(-84e-12, 650e-12, 901)
    jc = np.exp(-0.5 * (jt / 25e-12) ** 2)
    key = sampling.key(7)
    for pileup in (False, True):
        params = SpadParams(num_photons=500, pileup=pileup, mu_noise=100.0)
        a, b = (spad_noisy_transients(key, ideal, jt, jc, params,
                                      source_chunk=c, device=cuda)
                for c in (5, 64))
        assert a.is_cuda and torch.equal(a, b) and float(a.sum()) > 0
        raw = spad_noisy_transients(key, ideal, jt, jc, params,
                                    rescale=False, device=cuda)
        one = spad_model(sampling.split(key, 40)[11], ideal[11], jt, jc,
                         params, device=cuda)
        assert torch.equal(one, raw[11])
