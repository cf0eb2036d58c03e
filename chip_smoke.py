#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--profile DIR]

Phases, each printing one JSON line with the card's name and power limit:

  build    compile every kernel in nlos_surface_optimization_torch/csrc with
           nvcc (sm_90a), one process per source, all started together
  k1       the fused occlusion + splat kernel against its plain PyTorch
           version: a small grazing scene; one flagship source chunk
           (3,042 faces, 64 sources, 1.36 M rays); the loop's largest
           chunk ("large": a 23,762-face height field, 64 sources, 1.5 M
           rays); the GT render's shapes ("gt": 12,000 fine bins, 9
           sources).  Equal masks, histogram within rtol 2e-6 / atol
           1e-7*max, two launches bit-identical, the kernel's per-block
           candidate counts equal to the plain broad phase's
  k2       the fused backward face-sum kernel (tap reduction from the
           difference rows in the kernel) and its face -> vertex epilogue
           kernel against their plain versions on the flagship chunk
           ('fn' and 'vn') and the K1 "large" rays ('vn'): rtol 2e-4 /
           atol 2e-5*max, two launches bit-identical; the times of the
           kernel, the epilogue and the whole per-chunk backward
  sync     one flagship chunk of inverse_render under
           torch.cuda.set_sync_debug_mode: its backward makes no
           synchronizing call; the whole chunk's are counted
  k3       the standalone visibility kernel against its plain version:
           grazing rays on a small scene, one render_intensity chunk at
           the loop's culling shapes (the flagship height field, 64
           sources, 1.36 M rays), the loop's largest chunk ("large") and
           rays against a 79,202-face height field; equal masks and
           candidate counts, two launches bit-identical
  uniforms the threefry draws of one chunk on the card equal the CPU's
  small    inverse_render on the card against the CPU on a small scene
  intensity render_intensity on the card against the CPU on a small scene:
           equal cull masks, intensities within rtol 2e-5
  slice    the flagship iteration at full width: bench.py's 3,042-face
           height field, a 64x64 confocal scan, 20,000 samples per source,
           1,200 bins; a ground-truth render, then 3 descent steps from the
           flat plane (inverse_render, normal smoothing, auto smooth
           weight, Adam_Modified with the border learning-rate scale).
           Every kernel launch of this phase is counted.
  loop     the system's entry point at full width:
           run_experiment("armadillo", max_iters=16) with the scene's own
           settings (64x64 scan, 20,000 samples, 1,200 bins; the synthetic
           height field stands in for the mesh asset), through every
           remesh the phase machine starts (at least one: the plateaus, or
           the forced one at iteration 15); every kernel launch is counted
           and held to the chunks the renders ran
  resume   run_experiment(..., resume=True) from that run's iteration-12
           checkpoint to 16: the histories, faces and vertices equal the
           uninterrupted run's exactly

Each K1 and K3 case prints the wrapper's time as a render calls it (the
face hierarchy given), the kernel's (K1: occlusion and reduce apart), the
hierarchy's build (prep_ms, once per render), the plain version's, the
mean candidate groups per block, and a bound that does not depend on the
broad phase (``occlusion_bound``).  Then one JSON line of per-kernel
numbers (launches from the loop phase), the nvidia-smi line, and the
closing {"ok": true, ...} line.  Any failed
check raises; nothing falls back to the CPU.  With --profile, one more
flagship descent step and one descent step at the "large" shapes (23,762
faces, 'vn', the loop's chunk) run under torch.profiler: their kernel
tables go to DIR/profile*.txt, and a JSON line each gives the device-busy
share and the top device ops.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# fp32 operations of one sign-safe Möller–Trumbore test (K1), of one ray
# of K2 without its taps (albw, the fine bin, the gradient terms, the 12
# products and register sums; GN_OPS more with the shading-normal term;
# the taps add 4*G) and of one (face, slot) entry of K2's epilogue
# (edge, cross product, adds; 6 more a slab), counted from the kernels'
# sources.
K1_OPS_PER_TEST = 48
K2_OPS_PER_RAY = 94
K2_GN_OPS_PER_RAY = 23
K2_EPI_OPS_PER_ENTRY = 18

FLAGSHIP = dict(num_samples=20000, num_bins=1200, distance_resolution=1.2e-3,
                sigma_bin=1, bin_refine_resolution=10, source_chunk=64)
SCAN = 64
STEPS = 3
# the K1/K3 "large" case: an n x n height field (23,762 faces at n = 110,
# the loop's largest meshes); the K1 "gt" case: GT samples and sources
LARGE_N = 110
GT_SAMPLES = 200_000
GT_SOURCES = 9
# the loop phase: run_experiment's scene and iterations; None = the scene's
# own scan, samples and GT samples
SCENE = "armadillo"
LOOP_ITERS = 16
RESUME_FROM = 12
LOOP_SIZES = dict(scan_resolution=None, sample_num=None, gt_sample_num=None)
CARD = ""
SLEEP_CYCLES = 40_000_000   # device_ms's head start, ~20 ms at 1.98 GHz


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields, "card": CARD}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def timed_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card (CUDA events), after one warm
    call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card alone, for fn that only
    launches work: the stream is held busy (torch.cuda._sleep, ~20 ms)
    while the host enqueues the reps, so the host's time between launches
    does not count (timed_ms counts it where it exceeds the kernel's)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def height_field(n, extent, z0, noise, seed):
    """(v [n*n,3] f32, f [2(n-1)^2,3] int32, flat plane v): the bumpy
    height field of the repo's tests and bench.py."""
    xs = np.linspace(-extent, extent, n)
    gx, gy = np.meshgrid(xs, xs)
    rng = np.random.RandomState(seed)
    z = z0 + 0.08 * np.sin(6 * gx) * np.cos(5 * gy) + noise * rng.randn(n, n)
    v = np.stack([gx.ravel(), gy.ravel(), z.ravel()], 1).astype(np.float32)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            faces.append([a, a + n, a + 1])
            faces.append([a + n, a + n + 1, a + 1])
    plane = v.copy()
    plane[:, 2] = z0
    return v, np.array(faces, np.int32), plane


def small_scene():
    return height_field(6, 0.25, 0.5, 0.02, 0)


def flagship_scene():
    from nlos_surface_optimization_torch.geometry.accel import (
        morton_order_faces,
    )

    v, f, plane = height_field(40, 0.35, 0.6, 0.01, 0)
    return v, morton_order_faces(v, f), plane


def graze_rays(v, f, Lc, spt, num_bins, seed):
    """Rays from sources far off-axis that graze the bumps (real
    occlusion), ordered (source, face, sample), as in test_pallas.py."""
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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ------------------------------------------------------------------ K1


def block_rays(R, Lc, nbs=None):
    """[blocks, 128] ray index of each kernel block (-1 past a source's or
    the rays' end): K1's blocks of one source each (Lc sources, nbs blocks
    a source), or with Lc None K3's consecutive blocks."""
    if Lc is None:
        idx = torch.arange(-(-R // 128) * 128)
        return torch.where(idx < R, idx, -1).reshape(-1, 128)
    rs = R // Lc
    j = torch.arange(nbs * 128)
    idx = torch.arange(Lc)[:, None] * rs + j[None, :]
    return torch.where(j[None, :] < rs, idx, -1).reshape(-1, 128)


def crossing_tests(o, d, t_cut, fid, free, v, f, f_valid, hier, lists,
                   rows):
    """For each ray of ``free``: the valid faces other than its own whose
    box (widened by 1e-5) its segment o -> o + d*t_cut crosses, looked for
    among the groups of its block's list (a superset: a block's list holds
    every group its rays' segments can reach; ``hier`` maps its groups to
    mesh faces).  Tiled on the card."""
    from nlos_surface_optimization_torch.render import fused_kernels as fk

    dev = o.device
    tri = v[f]                                               # [F, 3, 3]
    fbox = torch.cat([tri.amin(1), tri.amax(1)], 1)
    rows = rows.to(dev)
    end = o + d * t_cut[:, None]
    W = max(lists.shape[1], 1)
    tile = max(1, (1 << 23) // (128 * W))
    total = 0
    for b0 in range(0, rows.shape[0], tile):
        r = rows[b0:b0 + tile]                               # [tb, 128]
        g = lists[b0:b0 + tile].long()                       # [tb, W]
        ray_ok = (r >= 0) & free[r.clamp(min=0)]
        rc = r.clamp(min=0)
        hit = fk._slab_hits(o[rc][:, :, None], end[rc][:, :, None],
                            torch.zeros_like(o[rc])[:, :, None],
                            hier.group_boxes[g.clamp(min=0)][:, None])
        hit &= ray_ok[:, :, None] & (g >= 0)[:, None, :]
        ti, ri, wi = torch.nonzero(hit, as_tuple=True)
        ray = rc[ti, ri]
        face = hier.faces[g[ti, wi][:, None] * fk.GF
                          + torch.arange(fk.GF, device=dev)].long()
        fc = face.clamp(min=0)
        cross = fk._slab_hits(o[ray][:, None], end[ray][:, None],
                              torch.zeros_like(o[ray])[:, None], fbox[fc])
        cross &= (face >= 0) & f_valid[fc] & (face != fid[ray].long()[:, None])
        total += int(cross.sum())
    return total


def occlusion_bound(args, kwargs, occ, hier, lists, rows, out_bytes):
    """(bound_ms, bound_by): a yardstick that does not depend on the broad
    phase under test.  Operations: for each live ray that no face blocks,
    the faces its segment's box test admits (``crossing_tests``); for each
    blocked ray, 1; K1_OPS_PER_TEST fp32 operations a test.  Bytes: the
    inputs read once and the outputs (out_bytes) written once.  Over the
    published H100 peaks."""
    o, d, t_self, fid = args[:4]
    t_cut = t_self * (1.0 - kwargs["t_rel"])
    live = t_cut > kwargs["t_min"]
    tests = crossing_tests(o, d, t_cut, fid, live & ~occ, *args[-3:], hier,
                           lists, rows) + int((live & occ).sum())
    ops_s = tests * K1_OPS_PER_TEST / FP32_OPS_PER_S
    bytes_s = (nbytes(*args) + out_bytes) / HBM_BYTES_PER_S
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


def check_k1(args, kwargs):
    """Kernel twice and plain once on the same inputs -> (occ, hist, err)."""
    from nlos_surface_optimization_torch.render import fused_kernels as fk

    occ, hist = fk.occluded_splat(*args, **kwargs)
    occ2, hist2 = fk.occluded_splat(*args, **kwargs)
    occ_p, hist_p = fk.occluded_splat_plain(*args, **kwargs)
    torch.cuda.synchronize()
    require(torch.equal(occ, occ2) and torch.equal(hist, hist2),
            "K1: two launches differ")
    require(torch.equal(occ, occ_p), "K1: occlusion mask differs from plain "
            f"({int((occ != occ_p).sum())} rays)")
    scale = float(hist_p.abs().max())
    torch.testing.assert_close(hist, hist_p, rtol=2e-6, atol=1e-7 * scale)
    return occ, hist, float((hist - hist_p).abs().max())


def k1_case(name, args, kwargs, reps=10, plain_reps=2):
    """One K1 case: masks, histogram and per-block candidate counts against
    the plain versions, then the times -> record."""
    from nlos_surface_optimization_torch.render import fused_kernels as fk

    occ, _, err = check_k1(args, kwargs)
    o, d, t_self, fid, contrib, bins, v, f, fv, Lc, Bf = args
    hier = fk.face_hierarchy(v, f, fv)
    kargs = args[:6] + (hier, Lc, Bf)
    counts = fk.kernel_call(*kargs, **kwargs)[2]
    want, lists, nbs = fk.broad_phase(o, d, t_self, Lc, hier)
    bad = int((counts != want).sum())
    require(bad == 0, f"K1 {name}: candidate counts differ from the plain "
            f"broad phase in {bad} blocks")
    _, _, blk_bins, blk_vals = fk.occlusion_call(*kargs, **kwargs)
    bound_ms, bound_by = occlusion_bound(
        args[:9], kwargs, occ, hier, lists, block_rays(o.shape[0], Lc, nbs),
        o.shape[0] + Lc * Bf * 4)
    rec = dict(
        case=name, rays=o.shape[0], faces=f.shape[0], sources=Lc, bins=Bf,
        occluded=int(occ.sum()), max_abs_err=err,
        mean_candidate_groups=float(counts.double().mean()),
        ms=timed_ms(lambda: fk.occluded_splat(*args, **kwargs, hier=hier),
                    reps),
        kernel_ms=timed_ms(lambda: fk.kernel_call(*kargs, **kwargs), reps),
        occlusion_ms=timed_ms(lambda: fk.occlusion_call(*kargs, **kwargs),
                              reps),
        reduce_ms=timed_ms(lambda: fk.reduce_call(blk_bins, blk_vals, Lc,
                                                  Bf), reps),
        prep_ms=timed_ms(lambda: fk.face_hierarchy(v, f, fv), reps),
        plain_ms=timed_ms(lambda: fk.occluded_splat_plain(*args, **kwargs),
                          plain_reps),
        bound_ms=bound_ms, bound_by=bound_by)
    emit("k1", **rec)
    return rec, occ


def large_scene():
    """The loop's largest meshes: a Morton-ordered n = 110 height field,
    23,762 faces."""
    from nlos_surface_optimization_torch.geometry.accel import (
        morton_order_faces,
    )

    v, f, _ = height_field(LARGE_N, 0.35, 0.6, 0.01, 0)
    return v, morton_order_faces(v, f)


def loop_chunk(F, spt):
    """The loop's source chunk: 256 halved while the chunk exceeds 2 M rays
    (outer_loop._current_cfg)."""
    chunk = 256
    while chunk > max(1, 2_000_000 // (F * spt)):
        chunk //= 2
    return chunk


def gt_case_inputs(dev):
    """K1 at the ground-truth render's shapes: the loop scene's GT mesh
    (Morton-ordered), GT_SAMPLES samples, GT_SOURCES sources from the
    middle of the scan, refine 10 (12,000 fine bins)."""
    import nlos_surface_optimization_torch as pt
    from nlos_surface_optimization_torch.experiments import run as runner
    from nlos_surface_optimization_torch.experiments.scenes import SCENES
    from nlos_surface_optimization_torch.geometry.accel import (
        morton_order_faces,
    )
    from nlos_surface_optimization_torch.render import core

    v, f = runner._load_gt_mesh(SCENES[SCENE], None)
    f = morton_order_faces(v, f)
    cfg = pt.RenderConfig(**{**FLAGSHIP, "num_samples": GT_SAMPLES})
    spt = cfg.samples_per_face(f.shape[0])
    lighting, lnormal = pt.make_confocal_scan(SCAN)
    mid = lighting.shape[0] // 2
    sl = slice(mid, mid + GT_SOURCES)
    _, args, kwargs = core.splat_inputs(
        pt.make_mesh(v, f, device=dev), torch.from_numpy(lighting[sl]).to(dev),
        torch.from_numpy(lnormal[sl]).to(dev), pt.key(0), cfg, spt,
        cfg.bin_refine_resolution)
    return args, kwargs


def chunk_inputs(dev, v, f, splat):
    """One chunk of the loop's render at the flagship settings on mesh v, f:
    (args, kwargs) of K1 (splat) or K3."""
    import nlos_surface_optimization_torch as pt
    from nlos_surface_optimization_torch.render import core

    cfg = pt.RenderConfig(**FLAGSHIP)
    spt = cfg.samples_per_face(f.shape[0])
    chunk = loop_chunk(f.shape[0], spt)
    lighting, lnormal = pt.make_confocal_scan(SCAN)
    lc = torch.from_numpy(lighting[:chunk]).to(dev)
    nc = torch.from_numpy(lnormal[:chunk]).to(dev)
    mesh = pt.make_mesh(v, f, device=dev)
    if splat:
        _, args, kwargs = core.splat_inputs(mesh, lc, nc, pt.key(0), cfg, spt,
                                            cfg.forward_refine)
    else:
        _, args, kwargs = core.occlusion_inputs(mesh, lc, nc, pt.key(0), cfg,
                                                spt)
    return args, kwargs


def phase_k1(dev, chunk_inputs_):
    """K1 on a small grazing scene, the flagship chunk, the loop's largest
    chunk and the GT render's shapes."""
    from nlos_surface_optimization_torch.geometry.mesh import make_mesh
    from nlos_surface_optimization_torch.render import fused_kernels as fk

    v, f, _ = small_scene()
    rays = graze_rays(v, f, 3, 2, 384, seed=1)
    small = make_mesh(v, f, device=dev)
    args = tuple(torch.from_numpy(x).to(dev) for x in rays) + (
        small.v, small.f, small.f_valid, 3, 384)
    occ_s, _, err_s = check_k1(args, dict(t_rel=1e-4, t_min=1e-6))
    require(bool(occ_s.any()), "K1 small case: no ray is occluded")
    emit("k1", case="small", max_abs_err=err_s, occluded=int(occ_s.sum()))

    main, _ = k1_case("flagship", *chunk_inputs_)
    lv, lf = large_scene()
    k1_case("large", *chunk_inputs(dev, lv, lf, True), reps=5, plain_reps=1)
    gt, _ = k1_case("gt", *gt_case_inputs(dev))
    ranges, slabs = fk.reduce_plan(
        gt["sources"], gt["bins"], -(-gt["rays"] // gt["sources"] // fk.RB),
        torch.cuda.get_device_properties(dev).multi_processor_count)
    require(ranges * slabs > 1, "K1 gt case: one reduce block a source")
    return {k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by")}


# ------------------------------------------------------------------ K2


def k2_case_inputs(dev, v, f, normal, chunk=None):
    """One source chunk of the backward at the flagship settings on mesh
    v, f ('vn': vertex normals, the gn term on, as the loop runs after its
    shading switch): the rays traced through K1 and a random difference
    -> (rays, mesh, lnormal, diff, cfg, spt).  ``chunk``: sources, the
    loop's chunk when None."""
    import nlos_surface_optimization_torch as pt
    from nlos_surface_optimization_torch.render import core

    cfg = pt.RenderConfig(**FLAGSHIP).replace(
        normal=normal, testing_flag=0 if normal == "vn" else 1)
    spt = cfg.samples_per_face(f.shape[0])
    Lc = min(chunk or loop_chunk(f.shape[0], spt), SCAN * SCAN)
    mesh = pt.make_mesh(v, f, device=dev)
    if normal == "vn":
        mesh = mesh._replace(vn=pt.vertex_normals(mesh.v, mesh.f,
                                                  mesh.f_valid))
    lighting, lnormal = pt.make_confocal_scan(SCAN)
    nc = torch.from_numpy(lnormal[:Lc]).to(dev)
    rays, _ = core.trace_forward_fused(
        mesh, torch.from_numpy(lighting[:Lc]).to(dev), nc, pt.key(0), cfg,
        spt, cfg.forward_refine)
    diff = torch.from_numpy((np.random.RandomState(3).randn(
        Lc, cfg.num_bins) * 1e-3).astype(np.float32)).to(dev)
    return rays, mesh, nc, diff, cfg, spt


def k2_bounds(args, partial, mesh, csr):
    """(bound_ms, bound_by) of K2 and of its epilogue, counted from the
    kernels' sources over the published H100 peaks.  K2 bytes: its inputs
    read once (the rays' tensors, face normals or per-ray normals, area,
    the difference rows, the tap weights) and the face sums [F, 12]
    written once; operations: K2_OPS_PER_RAY (+ K2_GN_OPS_PER_RAY) and
    the 4*G tap products and sums of A and Bw per ray.  Epilogue bytes:
    the slab partials, v, f, the CSR and the gradient read and written;
    operations: per (face, slot) entry 6 adds a slab past the first and
    K2_EPI_OPS_PER_ENTRY."""
    *tensors, p = args
    n_rays = tensors[1].numel()
    G = tensors[-1].shape[-1]
    F, V = partial.shape[1], mesh.v.shape[0]
    ops = n_rays * (K2_OPS_PER_RAY + 4 * G
                    + (K2_GN_OPS_PER_RAY if p.use_gn else 0))
    k2 = (ops / FP32_OPS_PER_S,
          (nbytes(*tensors) + F * 12 * 4) / HBM_BYTES_PER_S)
    entries = int(csr.offsets[-1])
    epi = (entries * (K2_EPI_OPS_PER_ENTRY + 6 * (partial.shape[0] - 1))
           / FP32_OPS_PER_S,
           (nbytes(partial, mesh.v, mesh.f, csr.offsets) + entries * 4
            + 2 * V * 12) / HBM_BYTES_PER_S)
    return [(max(o, b) * 1e3, "operations" if o >= b else "bytes")
            for o, b in (k2, epi)]


def k2_case(name, rays, mesh, lnormal, diff, cfg, spt, reps=20):
    """K2 and its epilogue on one chunk: twice bit-identical, against
    their plain versions (rtol 2e-4 / atol 2e-5*max, test_bwd_kernel.py's
    tolerances), then the times of the kernel, the epilogue, the whole
    per-chunk backward (CSR built, adding into a running gradient) and
    the plain versions -> record.  ``ms`` and ``epilogue_ms`` are the
    kernels' device time (``device_ms``), ``wrapper_ms`` and
    ``epilogue_wrapper_ms`` the calls' rate with the host's time, as
    ``chunk_ms``."""
    from nlos_surface_optimization_torch.render import bwd_kernels as bk

    args = bk.face_sum_inputs(rays, lnormal, diff, 0, cfg, spt)
    partial = bk.backward_face_sums(*args)
    partial2 = bk.backward_face_sums(*args)
    sums_p = bk.backward_face_sums_plain(*args)
    csr = bk.vertex_csr(mesh.f, mesh.f_valid, mesh.v.shape[0])
    g = bk.vertex_epilogue(partial, mesh, csr)
    g2 = bk.vertex_epilogue(partial2, mesh, csr)
    sums = bk.slab_sum(partial)
    g_p = bk.vertex_gradient(sums_p, mesh)
    torch.cuda.synchronize()
    require(torch.equal(partial, partial2) and torch.equal(g, g2),
            f"K2 {name}: two launches differ")
    torch.testing.assert_close(sums, sums_p, rtol=2e-4,
                               atol=2e-5 * float(sums_p.abs().max()))
    require(float(g_p.abs().max()) > 0, f"K2 {name}: the gradient is zero")
    torch.testing.assert_close(g, g_p, rtol=2e-4,
                               atol=2e-5 * float(g_p.abs().max()))
    (bound_ms, bound_by), (epi_bound_ms, epi_bound_by) = k2_bounds(
        args, partial, mesh, csr)
    grad = torch.zeros_like(g)
    rec = dict(
        case=name, rays=rays.h.numel(), faces=mesh.f.shape[0],
        sources=rays.h.shape[0], spt=spt, normal=cfg.normal,
        slabs=partial.shape[0], max_abs_err=float((sums - sums_p).abs().max()),
        grad_max_abs_err=float((g - g_p).abs().max()),
        ms=device_ms(lambda: bk.backward_face_sums(*args), reps),
        epilogue_ms=device_ms(lambda: bk.vertex_epilogue(partial, mesh, csr,
                                                         grad), reps),
        wrapper_ms=timed_ms(lambda: bk.backward_face_sums(*args), reps),
        epilogue_wrapper_ms=timed_ms(lambda: bk.vertex_epilogue(
            partial, mesh, csr, grad), reps),
        chunk_ms=timed_ms(lambda: bk.backward_chunk_fused(
            rays, mesh, lnormal, diff, 0, cfg, spt, csr=csr, grad=grad),
            reps),
        plain_ms=timed_ms(lambda: bk.backward_face_sums_plain(*args), 3),
        epilogue_plain_ms=timed_ms(lambda: bk.vertex_gradient(
            bk.slab_sum(partial), mesh), 3),
        bound_ms=bound_ms, bound_by=bound_by, epilogue_bound_ms=epi_bound_ms,
        epilogue_bound_by=epi_bound_by)
    emit("k2", **rec)
    return rec


def phase_k2(dev, v, f):
    """K2 and its epilogue on the flagship chunk ('fn', 64 sources, 1.36 M
    rays; and 'vn') and on the K1 'large' rays ('vn', 23,762 faces, the
    loop's chunk) -> ({K2 record}, {epilogue record}) of the first."""
    main = k2_case("flagship", *k2_case_inputs(dev, v, f, "fn",
                                               FLAGSHIP["source_chunk"]))
    k2_case("flagship_vn", *k2_case_inputs(dev, v, f, "vn",
                                           FLAGSHIP["source_chunk"]))
    lv, lf = large_scene()
    k2_case("large", *k2_case_inputs(dev, lv, lf, "vn"), reps=10)
    k2 = {k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by")}
    epi = dict(max_abs_err=main["grad_max_abs_err"], ms=main["epilogue_ms"],
               plain_ms=main["epilogue_plain_ms"],
               bound_ms=main["epilogue_bound_ms"],
               bound_by=main["epilogue_bound_by"])
    return k2, epi


def phase_sync(dev, v, f):
    """One flagship chunk of inverse_render (key on the card, hierarchy and
    CSR built, warmed once) under torch.cuda.set_sync_debug_mode('warn'):
    the synchronizing calls of its backward (must be none) and of the
    whole chunk."""
    import warnings

    import nlos_surface_optimization_torch as pt
    from nlos_surface_optimization_torch.render import api
    from nlos_surface_optimization_torch.render import bwd_kernels as bk
    from nlos_surface_optimization_torch.render import fused_kernels as fk

    rays, mesh, nc, diff, cfg, spt = k2_case_inputs(
        dev, v, f, "fn", FLAGSHIP["source_chunk"])
    lighting = torch.from_numpy(pt.make_confocal_scan(SCAN)[0][
        :FLAGSHIP["source_chunk"]]).to(dev)
    hier = fk.face_hierarchy(mesh.v, mesh.f, mesh.f_valid)
    csr = bk.vertex_csr(mesh.f, mesh.f_valid, mesh.v.shape[0])
    key = pt.key(0).to(dev)
    w = torch.ones_like(diff)

    def backward():
        return bk.backward_chunk_fused(rays, mesh, nc, diff, 0, cfg, spt,
                                       csr=csr)

    def chunk():
        return api._fused_chunk_body(mesh, lighting, nc, 0, key, diff, w,
                                     cfg, spt, hier, csr, None)

    counts = {}
    for name, fn in (("backward", backward), ("chunk", chunk)):
        fn()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        counts[name] = [str(m.message).splitlines()[0][:120] for m in seen
                        if "called a synchronizing" in str(m.message)]
    emit("sync", backward_syncs=len(counts["backward"]),
         chunk_syncs=len(counts["chunk"]), chunk_calls=counts["chunk"])
    require(not counts["backward"],
            f"the fused backward synchronizes: {counts['backward']}")


# ------------------------------------------------------------------ K3


def surface_rays(v, f, n, seed):
    """n rays in runs of 128, each run from one origin (a random point of
    the wall, or a source far off-axis that grazes the bumps) to random
    points of 64 consecutive faces (a patch: the faces are Morton-ordered)
    -> (o, d, t_self, fid)."""
    rng = np.random.RandomState(seed)
    runs = -(-n // 128)
    start = rng.randint(0, f.shape[0] - 64, runs)
    fid = (start[:, None] + rng.randint(0, 64, (runs, 128))).reshape(-1)[:n]
    u, w = rng.rand(n), rng.rand(n)
    m = u + w > 1
    u[m], w[m] = 1 - u[m], 1 - w[m]
    p = (v[f[fid, 0]] * (1 - u - w)[:, None] + v[f[fid, 1]] * u[:, None]
         + v[f[fid, 2]] * w[:, None])
    wall = np.stack([rng.uniform(-0.35, 0.35, runs),
                     rng.uniform(-0.35, 0.35, runs), np.zeros(runs)], 1)
    side = np.stack([rng.uniform(0.7, 0.9, runs),
                     rng.uniform(-0.25, 0.25, runs), np.full(runs, 0.45)], 1)
    o = np.repeat(np.where((np.arange(runs) % 2 == 0)[:, None], wall, side),
                  128, 0)[:n]
    d = p - o
    t = np.linalg.norm(d, axis=1)
    return (o.astype(np.float32), (d / t[:, None]).astype(np.float32),
            t.astype(np.float32), fid.astype(np.int32))


def check_k3(name, args, kwargs, reps=10, plain_reps=2):
    """Kernel twice and plain once on the same inputs; equal masks; the
    kernel's per-block candidate counts equal the plain broad phase's; the
    times of the wrapper, its kernel, the hierarchy and the plain version
    -> record."""
    from nlos_surface_optimization_torch.render import fused_kernels as fk
    from nlos_surface_optimization_torch.render import occl_kernels as ok

    occ = ok.segment_occluded(*args, **kwargs)
    occ2 = ok.segment_occluded(*args, **kwargs)
    occ_p = fk.occluded_plain(*args, **kwargs)
    torch.cuda.synchronize()
    require(torch.equal(occ, occ2), f"K3 {name}: two launches differ")
    bad = int((occ != occ_p).sum())
    require(bad == 0, f"K3 {name}: mask differs from plain ({bad} rays)")
    o, d, t_self, fid, v, f, fv = args
    hier = fk.face_hierarchy(v, f, fv)
    counts = ok.kernel_call(o, d, t_self, fid, hier, **kwargs)[1]
    want, lists = ok.broad_phase(o, d, t_self, hier)
    nbad = int((counts != want).sum())
    require(nbad == 0, f"K3 {name}: candidate counts differ from the plain "
            f"broad phase in {nbad} blocks")
    bound_ms, bound_by = occlusion_bound(args, kwargs, occ, hier, lists,
                                         block_rays(o.shape[0], None),
                                         o.shape[0])
    rec = dict(
        case=name, rays=o.shape[0], faces=f.shape[0],
        occluded=int(occ.sum()), max_abs_err=bad,
        mean_candidate_groups=float(counts.double().mean()),
        ms=timed_ms(lambda: ok.segment_occluded(*args, **kwargs, hier=hier),
                    reps),
        kernel_ms=timed_ms(lambda: ok.kernel_call(o, d, t_self, fid, hier,
                                                  **kwargs), reps),
        prep_ms=timed_ms(lambda: fk.face_hierarchy(v, f, fv), reps),
        plain_ms=timed_ms(lambda: fk.occluded_plain(*args, **kwargs),
                          plain_reps),
        bound_ms=bound_ms, bound_by=bound_by)
    emit("k3", **rec)
    return rec, occ


def phase_k3(dev, v, f):
    """K3 on grazing rays (small scene), on one render_intensity chunk at
    the loop's culling shapes (flagship mesh v, f), on the loop's largest
    chunk, and on a height field above 65,536 faces."""
    import nlos_surface_optimization_torch as pt
    from nlos_surface_optimization_torch.geometry.accel import (
        morton_order_faces,
    )

    kw = dict(t_rel=1e-4, t_min=1e-6)
    sv, sf, _ = small_scene()
    small = pt.make_mesh(sv, sf, device=dev)
    rays = [torch.from_numpy(x).to(dev)
            for x in graze_rays(sv, sf, 3, 2, 384, seed=1)[:4]]
    _, occ = check_k3("graze", tuple(rays) + small[:3], kw)
    require(bool(occ.any()), "K3 graze case: no ray is occluded")

    main, _ = check_k3("loop_chunk", *chunk_inputs(dev, v, f, False))
    lv, lf = large_scene()
    check_k3("large", *chunk_inputs(dev, lv, lf, False), reps=5,
             plain_reps=1)

    bv, bf, _ = height_field(200, 0.35, 0.6, 0.01, 1)
    bf = morton_order_faces(bv, bf)
    big = pt.make_mesh(bv, bf, device=dev)
    rays = [torch.from_numpy(x).to(dev) for x in surface_rays(bv, bf, 4096, 2)]
    _, occ = check_k3("big_mesh", tuple(rays) + big[:3], kw, plain_reps=1)
    require(bf.shape[0] > 65536 and bool(occ.any()) and bool((~occ).any()),
            "K3 big-mesh case: needs > 65,536 faces and both outcomes")
    return {k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by")}


# ------------------------------------------------------------ checks


def phase_uniforms(dev, F, spt):
    from nlos_surface_optimization_torch.geometry import sampling

    k = sampling.key(0)
    S, T = sampling.uniforms_for(k, 64, F, spt, source_offset=64, device=dev)
    S_c, T_c = sampling.uniforms_for(k, 64, F, spt, source_offset=64,
                                     device="cpu")
    require(torch.equal(S.cpu(), S_c) and torch.equal(T.cpu(), T_c),
            "uniforms on the card differ from the CPU's")
    emit("uniforms", shape=list(S.shape), equal=True)


def phase_small(dev):
    """inverse_render on the card (kernels) against the CPU (plain
    versions) on the tests' small scene, at the tests' tolerances."""
    import nlos_surface_optimization_torch as pt

    v, f, _ = small_scene()
    lighting, lnormal = pt.make_confocal_scan(4)
    cfg = pt.RenderConfig(num_samples=400, num_bins=300,
                          distance_resolution=5e-3, source_chunk=3)
    data = (np.random.RandomState(1).rand(16, 300) * 1e-3).astype(np.float32)
    w = np.ones((16, 300), np.float32)
    out = {}
    for where in (dev, "cpu"):
        mesh = pt.make_mesh(v, f, device=where)
        t, g, _ = pt.inverse_render(mesh, data, w, lighting, lnormal, cfg,
                                    pt.key(3))
        out[str(where)] = (t.cpu(), g.cpu())
    (t, g), (t_c, g_c) = out[str(dev)], out["cpu"]
    torch.testing.assert_close(t, t_c, rtol=2e-5, atol=1e-8)
    torch.testing.assert_close(g, g_c, rtol=2e-4, atol=1e-7)
    emit("small", transient_max_abs_err=float((t - t_c).abs().max()),
         grad_max_abs_err=float((g - g_c).abs().max()))


def phase_intensity(dev):
    """render_intensity on the card (K3) against the CPU (its plain
    version) on the tests' small scene: the cull masks are equal."""
    import nlos_surface_optimization_torch as pt
    from nlos_surface_optimization_torch.geometry import topology
    from nlos_surface_optimization_torch.render import occl_kernels as ok

    v, f, _ = small_scene()
    lighting, lnormal = pt.make_confocal_scan(4)
    cfg = pt.RenderConfig(num_samples=400, num_bins=300,
                          distance_resolution=5e-3, source_chunk=3)
    before = ok.segment_occluded.launches
    got = pt.render_intensity(pt.make_mesh(v, f, device=dev), lighting,
                              lnormal, cfg, pt.key(3)).cpu()
    require(ok.segment_occluded.launches > before,
            "render_intensity on the card did not reach K3")
    want = pt.render_intensity(pt.make_mesh(v, f, device="cpu"), lighting,
                               lnormal, cfg, pt.key(3))
    torch.testing.assert_close(got, want, rtol=2e-5, atol=0.0)
    aff = topology.face_affinity(f)
    keep = topology.remove_triangles(f, aff, got.numpy())
    require(np.array_equal(keep, topology.remove_triangles(f, aff,
                                                           want.numpy())),
            "cull masks differ between the card and the CPU")
    emit("intensity", faces=f.shape[0], max_abs_err=float(
        (got - want).abs().max()), kept=int(keep.sum()))


# ------------------------------------------------------------ the slice


class Descent:
    """The vertex update of InverseRenderingLoop.step for a fixed mesh
    topology: inverse_render, normal smoothing, the auto smooth weight on
    the first step, Adam_Modified with the border learning-rate scale."""

    def __init__(self, plane, f, gt, lighting, lnormal, cfg, key, dev,
                 lr=1e-4 / 3, smooth_ratio=100.0, edge_lr_ratio=0.1):
        import nlos_surface_optimization_torch as pt
        from nlos_surface_optimization_torch.geometry import topology
        from nlos_surface_optimization_torch.optim import adam_modified, loss

        self.pt, self.loss = pt, loss
        self.mesh = pt.make_mesh(plane, f, device=dev)
        self.gt, self.lighting, self.lnormal = gt, lighting, lnormal
        self.cfg, self.key = cfg, key
        self.weight = loss.create_weighting_function(gt, 1.0)
        self.affinity = torch.from_numpy(
            topology.face_affinity(f).astype(np.int64)).to(dev)
        border = topology.border_vertices(f, plane.shape[0])
        self.lr_scale = torch.from_numpy(np.where(
            border == 1, edge_lr_ratio, 1.0).astype(np.float32)).to(dev) * lr
        init, self.update = adam_modified.adam_modified(lr=1.0)
        self.opt = init(self.mesh.v)
        self.smooth_weight, self.smooth_ratio = 1e-3, smooth_ratio
        self.first = True

    def step(self):
        """-> (l2, data l2, gradient before the smoothing term)."""
        m = self.mesh
        if self.cfg.normal == "vn":
            m = m._replace(vn=self.pt.vertex_normals(m.v, m.f, m.f_valid))
        transient, grad, _ = self.pt.inverse_render(
            m, self.gt, self.weight, self.lighting, self.lnormal, self.cfg,
            self.key)
        sval, sgrad = self.pt.normal_smoothing(m.v, m.f, m.f_valid,
                                               self.affinity)
        l2, data_l2 = self.loss.evaluate_loss_with_normal_smoothness(
            self.gt, self.weight, transient, sval, self.smooth_weight)
        if self.first:
            sv = float(sval)
            self.smooth_weight = (float(data_l2) / sv / self.smooth_ratio
                                  if sv > 1e-12 else 0.0)
            self.first = False
        total = grad + self.smooth_weight * sgrad
        updates, self.opt = self.update(total, self.opt,
                                        lr_scale=self.lr_scale)
        self.mesh = m._replace(v=m.v + updates)
        return float(l2), float(data_l2), grad


def phase_slice(dev, v, f, plane, steps, profile_dir=None):
    import nlos_surface_optimization_torch as pt
    from nlos_surface_optimization_torch.render import bwd_kernels as bk
    from nlos_surface_optimization_torch.render import fused_kernels as fk

    cfg = pt.RenderConfig(**FLAGSHIP)
    lighting, lnormal = pt.make_confocal_scan(SCAN)
    lighting = torch.from_numpy(lighting).to(dev)
    lnormal = torch.from_numpy(lnormal).to(dev)
    L, F = lighting.shape[0], f.shape[0]
    spt = cfg.samples_per_face(F)
    chunks = -(-L // cfg.source_chunk)
    key = pt.key(0)

    fk.occluded_splat.launches = 0
    bk.backward_face_sums.launches = 0
    bk.vertex_epilogue.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gt, _ = pt.render_transient(pt.make_mesh(v, f, device=dev), lighting,
                                lnormal, cfg, key)
    torch.cuda.synchronize()
    gt_s = time.perf_counter() - t0
    require(bool(torch.isfinite(gt).all()) and float(gt.max()) > 0,
            "ground-truth transient is not finite and positive")
    emit("slice_gt", seconds=gt_s, shape=list(gt.shape),
         k1_bins=cfg.num_bins * cfg.bin_refine_resolution)

    descent = Descent(plane, f, gt, lighting, lnormal, cfg, key, dev)
    per_step = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        l2, data_l2, grad = descent.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        require(np.isfinite(l2) and bool(torch.isfinite(grad).all()),
                f"step {i}: loss or gradient not finite")
        require(float(grad.abs().max()) > 0, f"step {i}: gradient is zero")
        rate = 2.0 * L * F * spt / dt
        per_step.append(dt)
        emit("slice_step", step=i, l2=l2, data_l2=data_l2, seconds=dt,
             path_samples_per_sec=rate, grad_max=float(grad.abs().max()))
    launches = {"occluded_splat": fk.occluded_splat.launches,
                "backward_face_sums": bk.backward_face_sums.launches,
                "vertex_epilogue": bk.vertex_epilogue.launches}
    want = {"occluded_splat": chunks * (steps + 1),
            "backward_face_sums": chunks * steps,
            "vertex_epilogue": chunks * steps}
    require(launches == want, f"launch counts {launches}, expected {want}")
    emit("slice", scan=f"{SCAN}x{SCAN}", faces=F, spt=spt, chunks=chunks,
         rays_per_pass=L * F * spt, launches=launches,
         step_seconds=per_step, gt_seconds=gt_s)
    if profile_dir:
        profile_step(descent, profile_dir, "flagship")
    return launches


class Recorder:
    """run_experiment's log, each line with its host time, and the loops
    the runner builds (captured around experiments.run's
    _make_or_resume_loop)."""

    def __init__(self):
        from nlos_surface_optimization_torch.experiments import run as runner

        self.lines, self.loops = [], []
        make = runner._make_or_resume_loop

        def capture(*a, **kw):
            self.loops.append(make(*a, **kw))
            return self.loops[-1]

        runner._make_or_resume_loop = capture

    def log(self, msg):
        self.lines.append((time.perf_counter(), msg))

    def at(self, prefix):
        return next(t for t, m in self.lines if m.startswith(prefix))


def gt_chunks(faces, samples, sources, shards):
    """K1 launches of create_gt: the chunk it picks (2 M rays at most, 256
    sources at most), over its shards."""
    spt0 = 1 + (samples - 1) // max(faces, 1)
    chunk = max(1, min(256, 2_000_000 // max(faces * spt0, 1)))
    return sum(-(-len(s) // chunk)
               for s in np.array_split(np.arange(sources), shards))


def phase_loop(dev, workdir, rec):
    import nlos_surface_optimization_torch as pt
    from nlos_surface_optimization_torch.experiments import run as runner
    from nlos_surface_optimization_torch.experiments.scenes import SCENES
    from nlos_surface_optimization_torch.geometry import native
    from nlos_surface_optimization_torch.render import bwd_kernels as bk
    from nlos_surface_optimization_torch.render import fused_kernels as fk
    from nlos_surface_optimization_torch.render import occl_kernels as ok

    spec = SCENES[SCENE]
    fk.occluded_splat.launches = 0
    bk.backward_face_sums.launches = 0
    bk.vertex_epilogue.launches = 0
    ok.segment_occluded.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec.log("start")
    state, hist = runner.run_experiment(SCENE, workdir, max_iters=LOOP_ITERS,
                                        log=rec.log, device=dev, **LOOP_SIZES)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {"occluded_splat": fk.occluded_splat.launches,
                "backward_face_sums": bk.backward_face_sums.launches,
                "vertex_epilogue": bk.vertex_epilogue.launches,
                "segment_occluded": ok.segment_occluded.launches}
    loop = rec.loops[-1]
    steps = [r for r in loop.stats if r["kind"] == "step"]
    remeshes = [r for r in loop.stats if r["kind"] == "remesh"]
    for r in steps:
        emit("loop_step", iteration=r["iteration"], seconds=r["seconds"],
             l2=hist["l2"][r["iteration"]], v2=hist["v2"][r["iteration"]],
             faces=r["faces"], spt=r["spt"], chunks=r["chunks"],
             path_samples_per_sec=2.0 * r["sources"] * r["faces"] * r["spt"]
             / r["seconds"])
    for r in remeshes:
        emit("loop_remesh", **r)
    require(len(hist["l2"]) == LOOP_ITERS and state.t == LOOP_ITERS,
            f"the loop ran {len(hist['l2'])} of {LOOP_ITERS} iterations")
    require(bool(np.isfinite(hist["l2"]).all()
                 and np.isfinite(hist["v2"]).all()), "l2 or v2 not finite")
    require(len(remeshes) >= 1, "no remesh ran")

    gt_v, gt_f = runner._load_gt_mesh(spec, None)
    res = LOOP_SIZES["scan_resolution"] or spec.scan_resolution
    gt = gt_chunks(gt_f.shape[0],
                   LOOP_SIZES["gt_sample_num"]
                   or min(spec.gt_sample_num, 200_000),
                   res * res, 16 if res >= 256 else 8)
    want = {"occluded_splat": gt + sum(r["chunks"] for r in steps),
            "backward_face_sums": sum(r["chunks"] for r in steps),
            "vertex_epilogue": sum(r["chunks"] for r in steps),
            "segment_occluded": sum(r["chunks"] for r in remeshes)}
    require(launches == want, f"launch counts {launches}, expected {want}")
    init = next(m for _, m in rec.lines if m.startswith("init mesh"))
    emit("loop", scene=SCENE, scan=f"{res}x{res}", seconds=total,
         gt_seconds=rec.at("LCT initialization") - rec.at("creating GT"),
         lct_seconds=rec.at("init mesh") - rec.at("LCT initialization"),
         init=init, gt_faces=gt_f.shape[0], gt_chunks=gt,
         iterations=len(steps), remeshes=len(remeshes),
         geomlib_native=native.available(), launches=launches,
         final_faces=int(state.f.shape[0]))
    return launches, state, hist


def phase_resume(dev, workdir, state, hist, rec):
    """run_experiment(..., resume=True) in a copy of the run's directory
    holding its GT shards and the iteration-RESUME_FROM checkpoint."""
    from nlos_surface_optimization_torch.experiments import run as runner
    from nlos_surface_optimization_torch.io.mat import load_checkpoint

    copy = os.path.join(os.path.dirname(workdir), "resume")
    shutil.copytree(os.path.join(workdir, "setup"),
                    os.path.join(copy, "setup"))
    os.makedirs(os.path.join(copy, "progress"))
    name = f"{RESUME_FROM:05d}.mat"
    shutil.copy(os.path.join(workdir, "progress", name),
                os.path.join(copy, "progress", name))
    t0 = time.perf_counter()
    state2, hist2 = runner.run_experiment(
        SCENE, copy, max_iters=LOOP_ITERS, resume=True, log=rec.log,
        device=dev, **LOOP_SIZES)
    seconds = time.perf_counter() - t0
    require(any(m.startswith("resuming from") and m.endswith(name)
                for _, m in rec.lines), "the runner did not resume")
    rel = {}
    for k in ("l2", "l2_original", "v2"):
        a, b = np.asarray(hist[k]), np.asarray(hist2[k])
        require(a.shape == b.shape, f"resume: {k} history length differs")
        rel[k] = float(np.nanmax(np.abs(b - a) / np.abs(a)))
    # what both runs checkpointed at the start of each resumed iteration
    ckpt_diff = {}
    for t in range(RESUME_FROM, LOOP_ITERS):
        da, db = (load_checkpoint(os.path.join(w, "progress", f"{t:05d}.mat"))
                  for w in (workdir, copy))
        ckpt_diff[t] = max(float(np.abs(np.asarray(da[k]) - db[k]).max())
                           for k in ("v", "grad", "transient", "opt_m",
                                     "opt_v"))
    same_f = np.array_equal(state.f, state2.f)
    same_v = np.array_equal(state.v, state2.v)
    emit("resume", start=RESUME_FROM, iterations=LOOP_ITERS - RESUME_FROM,
         seconds=seconds, max_rel_diff=rel,
         checkpoint_max_abs_diff=ckpt_diff, faces_equal=same_f,
         vertices_equal=same_v,
         remeshes=sum(r["kind"] == "remesh" for r in rec.loops[-1].stats))
    for k, r in rel.items():
        require(np.array_equal(hist[k], hist2[k], equal_nan=True),
                f"resume: the {k} history differs (max rel {r:g})")
    require(same_f, "resume: faces differ")
    require(same_v, "resume: vertices differ")


def profile_step(descent, out_dir, name):
    """One more descent step under torch.profiler -> DIR/profile_<name>.txt
    and a JSON line: the step's seconds without the profiler, the device
    time of its kernels, memory copies and fills (from the trace's device
    events), the device-busy share (that time over the unprofiled step)
    and the top device ops by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    descent.step()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        descent.step()
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t0
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=40)
    with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as fh:
        fh.write(table)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_ms = sum(us for us, _ in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    emit("profile", case=name, faces=int(descent.mesh.f.shape[0]),
         chunk=descent.cfg.source_chunk, step_seconds=step_s,
         profiled_step_seconds=profiled_s, device_ms=busy_ms,
         busy_share=busy_ms / 1e3 / step_s,
         top=[{"name": k[:80], "device_ms": us / 1e3, "calls": n}
              for k, (us, n) in top])


def profile_large(dev, out_dir):
    """One descent step at the "large" shapes under the profiler: the
    n = 110 height field (23,762 faces) from its flat plane toward its GT,
    'vn' shading with the gn term (the loop after its shading switch), the
    loop's chunk; one warm step first."""
    import nlos_surface_optimization_torch as pt
    from nlos_surface_optimization_torch.geometry.accel import (
        morton_order_faces,
    )

    v, f, plane = height_field(LARGE_N, 0.35, 0.6, 0.01, 0)
    f = morton_order_faces(v, f)
    spt = pt.RenderConfig(**FLAGSHIP).samples_per_face(f.shape[0])
    cfg = pt.RenderConfig(**FLAGSHIP).replace(
        normal="vn", testing_flag=0, source_chunk=loop_chunk(f.shape[0], spt))
    lighting, lnormal = (torch.from_numpy(x).to(dev)
                         for x in pt.make_confocal_scan(SCAN))
    gt_mesh = pt.make_mesh(v, f, device=dev)
    gt_mesh = gt_mesh._replace(vn=pt.vertex_normals(gt_mesh.v, gt_mesh.f,
                                                    gt_mesh.f_valid))
    gt, _ = pt.render_transient(gt_mesh, lighting, lnormal, cfg, pt.key(0))
    descent = Descent(plane, f, gt, lighting, lnormal, cfg, pt.key(0), dev)
    descent.step()
    profile_step(descent, out_dir, "large")


def run(dev, steps, profile_dir=None):
    """Every phase on device dev -> the per-kernel records."""
    import nlos_surface_optimization_torch as pt
    from nlos_surface_optimization_torch import _cuda
    from nlos_surface_optimization_torch.render import core

    seconds = _cuda.build_all()
    regs = {n: [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "smem" in ln]
            for n, log in _cuda.build_log.items()}
    emit("build", seconds=seconds, ptxas=regs)

    v, f, plane = flagship_scene()
    cfg = pt.RenderConfig(**FLAGSHIP)
    mesh = pt.make_mesh(v, f, device=dev)
    lighting, lnormal = pt.make_confocal_scan(SCAN)
    lc = torch.from_numpy(lighting[:cfg.source_chunk]).to(dev)
    nc = torch.from_numpy(lnormal[:cfg.source_chunk]).to(dev)
    spt = cfg.samples_per_face(f.shape[0])
    _, args, kwargs = core.splat_inputs(
        mesh, lc, nc, pt.key(0), cfg, spt, cfg.forward_refine)
    k1 = phase_k1(dev, (args, kwargs))
    k2, epi = phase_k2(dev, v, f)
    phase_sync(dev, v, f)
    k3 = phase_k3(dev, v, f)
    phase_uniforms(dev, f.shape[0], spt)
    phase_small(dev)
    phase_intensity(dev)
    phase_slice(dev, v, f, plane, steps, profile_dir)
    if profile_dir:
        profile_large(dev, profile_dir)
    rec = Recorder()
    with tempfile.TemporaryDirectory() as tmp:
        workdir = os.path.join(tmp, SCENE)
        launches, state, hist = phase_loop(dev, workdir, rec)
        phase_resume(dev, workdir, state, hist, rec)
    pkg = "nlos_surface_optimization_torch"
    return [
        dict(name="occluded_splat", route="cuda",
             source=f"{pkg}/csrc/occluded_splat.cu",
             replaces="nlos_surface_optimization_tpu/render/"
                      "fused_kernels.py:122",
             launches=launches["occluded_splat"], library_ms=None, **k1),
        dict(name="backward_face_sums", route="cuda",
             source=f"{pkg}/csrc/backward_face_sums.cu",
             replaces="nlos_surface_optimization_tpu/render/"
                      "bwd_kernels.py:59",
             launches=launches["backward_face_sums"], library_ms=None, **k2),
        dict(name="vertex_epilogue", route="cuda",
             source=f"{pkg}/csrc/backward_face_sums.cu",
             replaces="nlos_surface_optimization_tpu/render/"
                      "bwd_kernels.py:300",
             launches=launches["vertex_epilogue"], library_ms=None, **epi),
        dict(name="segment_occluded", route="cuda",
             source=f"{pkg}/csrc/segment_occluded.cu",
             replaces="nlos_surface_optimization_tpu/render/"
                      "pallas_kernels.py:68",
             launches=launches["segment_occluded"], library_ms=None, **k3),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    global CARD
    CARD = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = run(torch.device("cuda"), STEPS, a.profile)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(CARD, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
