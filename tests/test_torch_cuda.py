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


@pytest.mark.parametrize("ka_max", [fk.KA_MAX, 1])   # 1: full-scan blocks
@pytest.mark.parametrize("num_bins", [384, 12000])
def test_occluded_splat_kernel_matches_plain(cuda, monkeypatch, ka_max,
                                             num_bins):
    monkeypatch.setattr(fk, "KA_MAX", ka_max)
    v, f = _bumpy()
    mesh = pt.make_mesh(v, f, device=cuda)
    args = tuple(torch.from_numpy(x).to(cuda)
                 for x in _graze(v, f, 3, 2, num_bins))
    args += (mesh.v, mesh.f, mesh.f_valid, 3, num_bins)
    occ, hist = fk.occluded_splat(*args)
    occ2, hist2 = fk.occluded_splat(*args)
    occ_p, hist_p = fk.occluded_splat_plain(*args)
    torch.cuda.synchronize()
    assert occ.any() and torch.equal(occ, occ_p)
    assert torch.equal(occ, occ2) and torch.equal(hist, hist2)
    torch.testing.assert_close(hist, hist_p, rtol=2e-6,
                               atol=1e-7 * float(hist_p.abs().max()))
    assert fk.occluded_splat.launches >= 2


@pytest.mark.parametrize("num_samples", [60, 500, 20000])  # spt 2, 10, 400
@pytest.mark.parametrize("normal,testing_flag", [
    ("fn", 1), ("vn", 0), ("vn", 1)])
def test_backward_face_sums_kernel_matches_plain(cuda, normal, testing_flag,
                                                 num_samples):
    v, f = _bumpy()
    mesh = pt.make_mesh(v, f, device=cuda)
    if normal == "vn":
        mesh = mesh._replace(vn=pt.vertex_normals(mesh.v, mesh.f,
                                                  mesh.f_valid))
    cfg = pt.RenderConfig(num_samples=num_samples, num_bins=300,
                          distance_resolution=5e-3, normal=normal,
                          testing_flag=testing_flag)
    lighting, lnormal = (torch.from_numpy(x).to(cuda)
                         for x in pt.make_confocal_scan(5))  # 25 > 1 slab
    spt = cfg.samples_per_face(f.shape[0])
    rays = core.trace_chunk(mesh, lighting, lnormal, pt.key(11), cfg, spt)
    diff = torch.from_numpy((np.random.RandomState(0).randn(25, 300) * 1e-3)
                            .astype(np.float32)).to(cuda)
    args = bk.face_sum_inputs(rays, lnormal, diff, 0, cfg, spt)
    sums = bk.backward_face_sums(*args)
    sums2 = bk.backward_face_sums(*args)
    sums_p = bk.backward_face_sums_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(sums, sums2)
    g = bk.vertex_gradient(sums, mesh)
    g_ref = core.backward_chunk(rays, mesh, lnormal, diff, 0, cfg, spt)
    scale = float(g_ref.abs().max())
    assert scale > 0
    torch.testing.assert_close(g, g_ref, rtol=2e-4, atol=2e-5 * scale)
    torch.testing.assert_close(sums, sums_p, rtol=2e-4,
                               atol=2e-5 * float(sums_p.abs().max()))


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


@pytest.mark.parametrize("ka_max", [ok.KA_MAX, 1])   # 1: full-scan blocks
@pytest.mark.parametrize("scene", ["bumpy", "graze", "big"])
def test_segment_occluded_kernel_matches_plain(cuda, monkeypatch, ka_max,
                                               scene):
    """K3 on mixed-origin rays, on grazing rays ordered by source, and on a
    height field above 65,536 faces (several ray groups)."""
    monkeypatch.setattr(ok, "KA_MAX", ka_max)
    if scene == "big":
        n = 200                                      # 79,202 faces
        v, f = _bumpy(n)
        rays = _mixed_rays(v, f, 3000)
        monkeypatch.setattr(ok, "GROUP_PAIRS", 1 << 16)   # 6 blocks a group
    else:
        v, f = _bumpy()
        rays = (_mixed_rays(v, f, 700) if scene == "bumpy"
                else _graze(v, f, 3, 2, 10)[:4])
    mesh = pt.make_mesh(v, f, device=cuda)
    args = tuple(torch.from_numpy(x).to(cuda) for x in rays) + (
        mesh.v, mesh.f, mesh.f_valid)
    before = ok.segment_occluded.launches
    occ = ok.segment_occluded(*args)
    occ2 = ok.segment_occluded(*args)
    occ_p = fk.occluded_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(occ, occ_p) and torch.equal(occ, occ2)
    assert occ.any() and (~occ).any()
    groups = len(ok.ray_groups(args[0].shape[0], -(-f.shape[0] // fk.GF)))
    assert ok.segment_occluded.launches - before == 2 * groups
    if scene == "big":
        assert f.shape[0] > 65536 and groups > 1


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
