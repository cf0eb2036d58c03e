"""The PyTorch port's kernels K1 (fused occlusion + splat) and K2 (fused
backward face sums and their vertex epilogue) against the JAX package's
Pallas kernels, and K2's plain pieces against the eager tap tables and
face -> vertex scatter.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
kernels run in interpret mode.  tests/test_torch_cuda.py holds the CUDA
kernels against the plain versions on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nlos_surface_optimization_tpu as nst
from nlos_surface_optimization_tpu.geometry import mesh as jmesh
from nlos_surface_optimization_tpu.geometry.intersect import segment_occluded
from nlos_surface_optimization_tpu.render import bwd_kernels as jbwd
from nlos_surface_optimization_tpu.render import core as jcore
from nlos_surface_optimization_tpu.render.fused_kernels import (
    occluded_splat_pallas,
)

import nlos_surface_optimization_torch as pt
from nlos_surface_optimization_torch import convert
from nlos_surface_optimization_torch.geometry.mesh import scatter_faces
from nlos_surface_optimization_torch.render import bwd_kernels, core
from nlos_surface_optimization_torch.render import fused_kernels as fk

torch.set_num_threads(1)

KEY_SEED = 11


def _t(x):
    return torch.from_numpy(np.array(x))


def _splat_scene(bumpy_mesh, seed, Lc, spt, num_bins, zero_frac=0.0):
    """Rays of test_pallas.py's fused-kernel cases: sources far off-axis so
    rays graze the bumps (real occlusion), ordered (source, face, sample)."""
    v, f = bumpy_mesh
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
    contrib[rng.rand(R) < zero_frac] = 0.0
    bins = rng.randint(0, num_bins, R).astype(np.int32)
    return v, f, o, d, t, fi, contrib, bins


@pytest.mark.parametrize("seed,Lc,spt,num_bins,zero_frac", [
    (1, 3, 2, 384, 0.0),      # test_pallas.py: fused kernel vs reference
    (7, 2, 2, 4096, 0.1),     # test_pallas.py: windowed + residual splat
])
def test_occluded_splat_plain_matches_pallas(bumpy_mesh, seed, Lc, spt,
                                             num_bins, zero_frac):
    v, f, o, d, t, fi, contrib, bins = _splat_scene(
        bumpy_mesh, seed, Lc, spt, num_bins, zero_frac)
    f_valid = np.ones(f.shape[0], bool)
    occ_j, hist_j = occluded_splat_pallas(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), jnp.asarray(fi),
        jnp.asarray(contrib), jnp.asarray(bins), jnp.asarray(v),
        jnp.asarray(f), jnp.asarray(f_valid), Lc, num_bins, interpret=True)
    occ_p, hist_p = fk.occluded_splat(
        _t(o), _t(d), _t(t), _t(fi), _t(contrib), _t(bins), _t(v),
        _t(f).long(), _t(f_valid), Lc, num_bins)
    occ_j = np.asarray(occ_j)
    np.testing.assert_array_equal(occ_p.numpy(), occ_j)
    assert occ_j.any() and (~occ_j).any()
    np.testing.assert_allclose(hist_p.numpy(), np.asarray(hist_j),
                               rtol=2e-6, atol=1e-7)


def test_occluded_plain_matches_divide_based_reference(bumpy_mesh):
    """The sign-safe predicate agrees with the divide-based segment
    occlusion on these rays (no ray sits on a rounding boundary)."""
    v, f, o, d, t, fi, _, _ = _splat_scene(bumpy_mesh, 1, 3, 2, 8)
    f_valid = np.ones(f.shape[0], bool)
    want = np.asarray(segment_occluded(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), jnp.asarray(fi),
        jnp.asarray(v), jnp.asarray(f), jnp.asarray(f_valid)))
    got = fk.occluded_plain(_t(o), _t(d), _t(t), _t(fi), _t(v), _t(f).long(),
                            _t(f_valid), ray_tile=100, face_tile=16)
    np.testing.assert_array_equal(got.numpy(), want)


def _grid_scene(seed, Lc, spt):
    """Grazing rays (as _splat_scene) over a Morton-ordered 242-face height
    field: four 64-face supergroups, the last one partly padding."""
    from nlos_surface_optimization_torch.geometry.accel import (
        morton_order_faces,
    )

    n = 12
    rng = np.random.RandomState(2)
    xs = np.linspace(-0.25, 0.25, n)
    gx, gy = np.meshgrid(xs, xs)
    z = 0.5 + 0.08 * np.sin(6 * gx) * np.cos(5 * gy) + 0.02 * rng.randn(n, n)
    v = np.stack([gx.ravel(), gy.ravel(), z.ravel()], 1).astype(np.float32)
    f = np.array([q for i in range(n - 1) for j in range(n - 1)
                  for q in ([i * n + j, i * n + j + n, i * n + j + 1],
                            [i * n + j + n, i * n + j + n + 1,
                             i * n + j + 1])], np.int32)
    f = morton_order_faces(v, f).astype(np.int32)
    return _splat_scene((v, f), seed, Lc, spt, 8)


@pytest.mark.parametrize("seed,valid_frac", [(1, 1.0), (4, 0.6)])
def test_broad_phase_lists_cover_every_blocker(seed, valid_frac):
    """Every 8-face group holding a face that blocks one of a block's rays
    is on that block's candidate list; K1's plan (the lists tested in
    passes of a small capacity) gives the plain occlusion mask."""
    v, f, o, d, t, fi, _, _ = _grid_scene(seed, 3, 2)
    F = f.shape[0]
    Lc = 3
    fv = np.random.RandomState(seed).rand(F) < valid_frac
    t[np.random.RandomState(seed + 1).rand(t.shape[0]) < 0.2] = 0.0  # dead
    args = [_t(x) for x in (o, d, t, fi, v, f, fv)]
    args[5] = args[5].long()
    hier = fk.face_hierarchy(*args[4:])
    counts, lists, nbs = fk.broad_phase(*args[:3], Lc, hier)
    blocked = fk.sign_safe_blocked(
        args[0], args[1], args[2] * (1.0 - 1e-4), args[3],
        fk.face_soup(*args[4:], -(-F // fk.GF))[:F],
        torch.arange(F, dtype=torch.int32), 1e-6)             # [R, F]
    rs = t.shape[0] // Lc
    assert blocked.any() and F % 64
    group_of = torch.empty(F, dtype=torch.int64)
    group_of[hier.faces[:F].long()] = torch.arange(F) // fk.GF
    emu = torch.zeros(t.shape[0], dtype=torch.bool)
    cap = 2
    for b in range(Lc * nbs):
        l, j = divmod(b, nbs)
        rows = slice(l * rs + j * fk.RB, l * rs + min((j + 1) * fk.RB, rs))
        need = set(group_of[blocked[rows].any(0)].tolist())
        cnt = int(counts[b])
        have = lists[b, :cnt]
        assert need <= set(have.tolist()), (b, sorted(need - set(have.tolist())))
        assert (lists[b, cnt:] == -1).all()
        for p0 in range(0, cnt, cap):
            emu[rows] |= fk.narrow_plain(
                args[0][rows], args[1][rows], args[2][rows] * (1.0 - 1e-4),
                args[3][rows], hier, have[p0:p0 + cap].long(), 1e-6)
    assert torch.equal(emu, fk.occluded_plain(*args))
    assert torch.equal(emu, blocked.any(1))


def _traced_rays(bumpy_mesh, num_samples, normal, testing_flag):
    v, f = bumpy_mesh
    mesh = jmesh.make_mesh(v, f)
    if normal == "vn":
        mesh = mesh._replace(vn=jmesh.vertex_normals(mesh.v, mesh.f,
                                                     mesh.f_valid))
    cfg = nst.RenderConfig(num_samples=num_samples, num_bins=300,
                           distance_resolution=5e-3, normal=normal,
                           testing_flag=testing_flag)
    lighting, lnormal = nst.make_confocal_scan(4)
    spt = cfg.samples_per_face(int(mesh.f.shape[0]))
    rays = jcore.trace_chunk(mesh, jnp.asarray(lighting), jnp.asarray(lnormal),
                             jax.random.key(KEY_SEED), cfg, spt)
    return mesh, cfg, lnormal, spt, rays


def _port_inputs(mesh, cfg, rays, device="cpu"):
    prays = core.RayBatch(*(_t(x).to(device) for x in rays))
    pmesh = convert.mesh_from_numpy(*(np.asarray(x) for x in mesh),
                                    device=device)
    pcfg = convert.config_from_fields(
        {k: getattr(cfg, k) for k in cfg.__dataclass_fields__})
    return prays, pmesh, pcfg


@pytest.mark.parametrize("num_samples", [60, 160, 500])   # spt 2, 4, 10
@pytest.mark.parametrize("normal,testing_flag", [
    ("fn", 1), ("vn", 0), ("vn", 1)])
def test_backward_fused_plain_matches_jax(bumpy_mesh, normal, testing_flag,
                                          num_samples):
    """K2's plain version (through backward_chunk_fused: the tap reduction
    from the difference rows, face normals in 'fn' mode, the CSR
    epilogue) and the eager backward_chunk against JAX's backward_chunk
    on a random difference, and against JAX's Pallas kernel on the
    constant difference that test_bwd_kernel.py uses for its spt variants
    (on a random difference at spt = 10 the interpreted Pallas kernel
    itself strays from JAX's backward_chunk by up to 0.5% of max|g|).
    Given a running gradient, the chunk's gradient is added to it."""
    mesh, cfg, lnormal, spt, rays = _traced_rays(bumpy_mesh, num_samples,
                                                 normal, testing_flag)
    prays, pmesh, pcfg = _port_inputs(mesh, cfg, rays)
    diff_r = (np.random.RandomState(0).randn(16, cfg.num_bins) * 1e-3
              ).astype(np.float32)
    diff_c = np.full((16, cfg.num_bins), 1e-3, np.float32)
    jn = jnp.asarray(lnormal)
    g_ref = np.asarray(jcore.backward_chunk(rays, mesh, jn,
                                            jnp.asarray(diff_r), 0, cfg, spt))
    g_pal = np.asarray(jbwd.backward_chunk_fused(
        rays, mesh, jn, jnp.asarray(diff_c), 0, cfg, spt, interpret=True))

    def port(fn, diff, **kw):
        return fn(prays, pmesh, _t(lnormal), _t(diff), 0, pcfg, spt, **kw)

    fused = port(bwd_kernels.backward_chunk_fused, diff_r)
    checks = [(fused.numpy(), g_ref),
              (port(core.backward_chunk, diff_r).numpy(), g_ref),
              (port(bwd_kernels.backward_chunk_fused, diff_c).numpy(), g_pal)]
    for got, want in checks:
        scale = np.abs(want).max()
        assert scale > 0 and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5 * scale)
    g0 = torch.from_numpy(np.random.RandomState(1).randn(
        *fused.shape).astype(np.float32))
    csr = bwd_kernels.vertex_csr(pmesh.f, pmesh.f_valid, pmesh.v.shape[0])
    summed = port(bwd_kernels.backward_chunk_fused, diff_r, csr=csr, grad=g0)
    assert torch.equal(summed, g0 + fused)


def _tap_scene(refine, sigma_bin):
    """Half path lengths h [Lc, 3, n] whose fine bins cover q < 0, q = 0,
    q = Bf, q > Bf, the first and last bins whose taps leave [0, B), and
    both sides of fine-bin edges; a random difference [Lc, B]."""
    cfg = pt.RenderConfig(num_samples=60, num_bins=40,
                          distance_resolution=5e-3, sigma_bin=sigma_bin,
                          bin_refine_resolution=refine)
    Bf = cfg.num_bins * refine
    fine = cfg.distance_resolution / refine
    rng = np.random.RandomState(refine * 10 + sigma_bin)
    q = np.concatenate([np.arange(-3, 2 * refine * sigma_bin + 3),
                        np.arange(Bf - 2 * refine * sigma_bin - 3, Bf + 4),
                        rng.randint(0, Bf + 1, 40)])
    edge = ((cfg.bin_lower + q * fine) / 2.0).astype(np.float32)
    inner = ((cfg.bin_lower + (q + rng.uniform(0.05, 0.95, q.size)) * fine)
             / 2.0).astype(np.float32)
    h = np.concatenate([edge, np.nextafter(edge, np.float32(-1)),
                        np.nextafter(edge, np.float32(1)), inner])
    Lc = 3
    h = np.stack([rng.permutation(h) for _ in range(Lc)])[:, None, :]
    h = np.repeat(h, 3, axis=1)                              # [Lc, 3, n]
    diff = rng.randn(Lc, cfg.num_bins).astype(np.float32)
    return cfg, torch.from_numpy(h), torch.from_numpy(diff)


@pytest.mark.parametrize("refine", [1, 10])
@pytest.mark.parametrize("sigma_bin", [1, 2])
def test_tap_sums_plain_equal_the_tap_tables_bit_for_bit(refine, sigma_bin):
    """The in-kernel tap reduction's plain version (A, Bw from the
    difference rows) equals the tap-table lookups of core._tap_reductions
    bit for bit, outside the bin range and on fine-bin edges included."""
    cfg, h, diff = _tap_scene(refine, sigma_bin)
    z = torch.zeros(h.shape + (3,))
    rays = core.RayBatch(dirs=z, h=h, normal=z, albedo=h, bary=z,
                         valid=h > 0, area=h[0, :, 0], face_n=z[0, :, 0])
    want_a, want_b = core._tap_reductions(rays, diff, 0, cfg)
    *_, p = bwd_kernels.face_sum_inputs(rays, diff[:, :3], diff, 0, cfg, 1)
    got_a, got_b = bwd_kernels.tap_sums_plain(
        h, diff, bwd_kernels.tap_weights(cfg, "cpu"), p)
    Bf = cfg.num_bins * refine
    q = core.fine_bins(h, cfg.bin_lower, cfg.distance_resolution / refine)
    for where in (q < 0, q == 0, q == Bf, q > Bf):
        assert bool(where.any())
    assert bool((want_a[(q >= 0) & (q <= Bf)] != 0).all())
    assert torch.equal(got_a, want_a) and torch.equal(got_b, want_b)
    assert torch.equal(got_a.view(torch.int32), want_a.view(torch.int32))
    assert torch.equal(got_b.view(torch.int32), want_b.view(torch.int32))


def _padded_bumpy(bumpy_mesh, normal="fn"):
    """bumpy_mesh bucketed (pad_mesh): 50 faces padded to 256, all padding
    faces (0, 0, 0) on vertex 0."""
    v, f = bumpy_mesh
    mesh = pt.pad_mesh(v, f, device="cpu")
    if normal == "vn":
        mesh = mesh._replace(vn=pt.vertex_normals(mesh.v, mesh.f,
                                                  mesh.f_valid))
    assert mesh.f.shape[0] > 2 * f.shape[0]
    assert bool((mesh.f[f.shape[0]:] == 0).all())
    return mesh


def test_vertex_csr_sums_equal_scatter_faces_bit_for_bit(bumpy_mesh):
    """The CSR walk (padding faces left out) gives scatter_faces' sums bit
    for bit where the padding faces carry zeros, as the backward gives
    them; vertex 0's heavy segment included."""
    mesh = _padded_bumpy(bumpy_mesh)
    F, V = mesh.f.shape[0], mesh.v.shape[0]
    csr = bwd_kernels.vertex_csr(mesh.f, mesh.f_valid, V)
    assert int(csr.offsets[-1]) == 3 * int(mesh.f_valid.sum())
    per_face = torch.from_numpy(np.random.RandomState(0).randn(
        F, 3, 3).astype(np.float32))
    per_face[~mesh.f_valid] = 0.0
    want = scatter_faces(per_face, mesh.f, V)
    assert torch.equal(bwd_kernels.segment_sum_csr(
        per_face.reshape(-1, 3), csr), want)
    assert float(want[0].abs().max()) > 0


@pytest.mark.parametrize("normal,testing_flag", [("fn", 1), ("vn", 0)])
def test_epilogue_plain_equals_vertex_gradient_bit_for_bit(
        bumpy_mesh, normal, testing_flag):
    """On a real chunk of the padded mesh, the epilogue's plain version
    (slabs added in order, the CSR walk) equals vertex_gradient (scatter
    over every face) bit for bit."""
    mesh = _padded_bumpy(bumpy_mesh, normal)
    cfg = pt.RenderConfig(num_samples=160, num_bins=300,
                          distance_resolution=5e-3, normal=normal,
                          testing_flag=testing_flag)
    lighting, lnormal = (torch.from_numpy(x)
                         for x in pt.make_confocal_scan(3))
    spt = cfg.samples_per_face(int(mesh.f_valid.sum()))
    rays = core.trace_chunk(mesh, lighting, lnormal, pt.key(KEY_SEED), cfg,
                            spt)
    diff = torch.from_numpy((np.random.RandomState(2).randn(9, 300) * 1e-3)
                            .astype(np.float32))
    args = bwd_kernels.face_sum_inputs(rays, lnormal, diff, 0, cfg, spt)
    sums = bwd_kernels.backward_face_sums_plain(*args)
    assert bool((sums[~mesh.f_valid] == 0).all())
    partial = torch.stack([sums * 0.25, sums * 0.5, sums * 0.25])
    csr = bwd_kernels.vertex_csr(mesh.f, mesh.f_valid, mesh.v.shape[0])
    got = bwd_kernels.vertex_epilogue(partial, mesh, csr)
    want = bwd_kernels.vertex_gradient(bwd_kernels.slab_sum(partial), mesh)
    assert float(want.abs().max()) > 0 and torch.equal(got, want)


def test_backward_chunk_fused_builds_no_tap_tables(bumpy_mesh, monkeypatch):
    """The fused backward reduces the taps from the difference rows: it
    never builds core._tap_tables."""
    mesh, cfg, lnormal, spt, rays = _traced_rays(bumpy_mesh, 160, "vn", 0)
    prays, pmesh, pcfg = _port_inputs(mesh, cfg, rays)
    diff = _t((np.random.RandomState(0).randn(16, cfg.num_bins) * 1e-3)
              .astype(np.float32))
    want = core.backward_chunk(prays, pmesh, _t(lnormal), diff, 0, pcfg, spt)

    def refuse(*a, **kw):
        raise AssertionError("the fused backward built the tap tables")

    monkeypatch.setattr(core, "_tap_tables", refuse)
    got = bwd_kernels.backward_chunk_fused(prays, pmesh, _t(lnormal), diff, 0,
                                           pcfg, spt)
    with pytest.raises(AssertionError):
        core.backward_chunk(prays, pmesh, _t(lnormal), diff, 0, pcfg, spt)
    torch.testing.assert_close(got, want, rtol=2e-4,
                               atol=2e-5 * float(want.abs().max()))


@pytest.mark.parametrize("Lc,F,spt", [
    (64, 3042, 7), (64, 23762, 1), (32, 23762, 1), (9, 1922, 105),
    (25, 50, 400)])
def test_face_sums_slab_fills_the_card(Lc, F, spt):
    """The slab gives at least BLOCKS_PER_SM blocks a SM on 132 SMs where
    the chunk has that many (face tiles x sources), and never an empty
    slab."""
    slab = bwd_kernels.face_sums_slab(Lc, F, spt, 132)
    tiles = -(-F // (bwd_kernels.NT // spt if spt < bwd_kernels.NT else 1))
    nslab = -(-Lc // slab)
    assert 1 <= slab <= Lc and (nslab - 1) * slab < Lc
    assert tiles * nslab >= min(bwd_kernels.BLOCKS_PER_SM * 132, tiles * Lc)


@pytest.mark.parametrize("normal,testing_flag", [("fn", 1), ("vn", 0)])
def test_forward_and_intensity_chunks_match_jax(bumpy_mesh, normal,
                                                testing_flag):
    mesh, cfg, lnormal, spt, rays = _traced_rays(bumpy_mesh, 160, normal,
                                                 testing_flag)
    prays, _, pcfg = _port_inputs(mesh, cfg, rays)
    jn = jnp.asarray(lnormal)
    for refine in (1, 10):
        want = np.asarray(jcore.forward_chunk(rays, jn, cfg, spt, refine))
        got = core.forward_chunk(prays, _t(lnormal), pcfg, spt, refine)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=1e-9)
    want = np.asarray(jcore.intensity_chunk(rays, jn, cfg, spt))
    got = core.intensity_chunk(prays, _t(lnormal), pcfg, spt)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=1e-9)
    assert want.max() > 0


def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors."""
    x = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError):
        fk.occluded_splat(x, x, x[:, 0], x[:, 0].int(), x[:, 0],
                          x[:, 0].int(), x, x.long(), x[:, 0].bool(), 1, 8)
    h = torch.zeros(1, 1, 4, device="meta")
    p = bwd_kernels.FaceSumScalars(4, False, False, 0.0, 1e-3, 8, 1, 2, 1.0)
    with pytest.raises(ValueError):
        bwd_kernels.backward_face_sums(
            h[..., None].expand(-1, -1, -1, 3), h, h, h > 0,
            h[..., None].expand(-1, -1, -1, 3), h[0, :, :3], h[0, 0, :1],
            h[0, :, :3], h[0, :, :], h[None, :, 0, :3], p)
    with pytest.raises(ValueError):
        mesh = pt.make_mesh(np.zeros((3, 3), np.float32),
                            np.array([[0, 1, 2]]), device="meta")
        bwd_kernels.vertex_epilogue(
            torch.zeros(1, 1, 12, device="meta"), mesh,
            bwd_kernels.VertexCSR(torch.zeros(4, dtype=torch.int32,
                                              device="meta"),
                                  torch.zeros(3, dtype=torch.int32,
                                              device="meta")))
