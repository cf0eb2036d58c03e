#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--profile DIR]

Phases, each printing one JSON line with the card's name and power limit:

  build    compile every kernel in nlos_surface_optimization_torch/csrc with
           nvcc (sm_90a), one process per source, all started together
  k1       the fused occlusion + splat kernel against its plain PyTorch
           version: a small grazing scene; one flagship source chunk
           (3,042 faces, 64 sources, 1.36 M rays), and the same chunk
           with the GGX BRDF at alpha 0.2 ("flagship_ggx"); the loop's
           largest chunk ("large": a 23,762-face height field, 64
           sources, 1.5 M rays); the GT render's shapes ("gt": 12,000
           fine bins, 9 sources); the material phase's ("material": the
           ggx scene, GGX at 0.2, 256 sources, 5.4 M rays, 1,200 bins;
           checked also at 12,000 bins).  Equal masks, histogram within rtol
           2e-6 / atol 1e-7*max, two launches bit-identical, the kernel's
           per-block candidate counts equal to the plain broad phase's
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
  material_small
           the material and jitter entry points on the card against the
           CPU on the small scene, at the CPU tests' tolerances: GGX
           render_transient and inverse_render ('fn'; 'vn' with the gn
           term), inverse_render_albedo, inverse_render_alpha,
           render_transient_jitter, inverse_render_jitter,
           vertex_gradient_bins, inverse_shading_render, and
           inverse_render with loss_smooth_width 2
  slice    the flagship iteration at full width: bench.py's 3,042-face
           height field, a 64x64 confocal scan, 20,000 samples per source,
           1,200 bins; a ground-truth render, then 3 descent steps from the
           flat plane (inverse_render, normal smoothing, auto smooth
           weight, Adam_Modified with the border learning-rate scale).
           Every kernel launch of this phase is counted.
  ggx_slice the same GT render and 3 descent steps with the GGX BRDF (GT
           at alpha 0.2, steps at the default 0.1): K1 forward, the eager
           GGX backward (no K2 launch); its step seconds beside slice's,
           and one flagship chunk's forward, backward and whole body
           timed apart, GGX beside Lambertian ("ggx_chunk")
  jitter   the measured-jitter path at full width: the flagship height
           field, 64x64 scan, 20,000 samples, 1,200 bins; two kernels from
           the runner's synthetic jitter calibration: "binned" (summed onto
           the 4 ps bins, 184 taps) and "raw901" (one tap a calibration
           sample, a stress case ~5x the calibration's width); for each one
           render_transient_jitter of the GT mesh and one
           inverse_render_jitter from the flat plane, each traced through
           K3 (one launch a chunk)
  material the ggx scene's settings (64x64 scan, 20,000 samples, 1,200
           bins; the runner's synthetic height field): a GT render at
           alpha 0.2, initial_fitting_albedo, 5 optimize_alpha steps from
           0.5, then 3 optimize_shape steps from the GT shape raised by 8
           mm; finite values, falling losses, alpha moving toward 0.2
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
  ggx_loop run_experiment("ggx", max_iters=8) at the scene's own width
           (GT with GGX at alpha 0.2, the loop at 0.1), through at least
           one remesh; K1 launches held to the GT's and the steps' chunks,
           K3's to the remeshes', K2 none
  lct      the LCT init on the card against the CPU at the loop's shapes
           (the armadillo scene's 64x64 x 1,200-bin GT; the stand-in
           capture at 64x64 x 2,048): grids and init mesh bit for bit
  tools    nearest_hit on the card against the CPU (+z rays from a 64x64
           grid and from the vertices of the 23,762-face "large" mesh):
           fid equal, t, u, v within f32; average_z_distance
  noise    the SPAD model at full width (the flagship GT, 64x64 x 1,200
           bins, 20,000 photons a point, the runner's calibration,
           pileup=False): seconds, peak memory, chunk 16 against 256
           exactly, the card against the CPU on 32 rows by distribution;
           then run_experiment("noise", max_iters=4) at the scene's own
           settings ("noise_loop", launches held as in loop) and the final
           mesh's average_z_distance to the GT mesh
  real     the stand-in capture at 64x64 and B = 2,048: K1 at refine 10
           (20,480 fine bins) and K2 on one 64-source chunk of its scan
           (the flagship mesh) against their plain versions;
           run_experiment("s", max_iters=2) at full width ("real_loop")
  same_key tests/data/parity_short.json's case (JAX's run_experiment,
           x64 off) on the card: the first iteration's faces and l2 equal
           JAX's within the CPU test's tolerance; each iteration's
           deviation printed

Each K1 and K3 case prints the wrapper's time as a render calls it (the
face hierarchy given), the kernel's (K1: occlusion and reduce apart), the
hierarchy's build (prep_ms, once per render), the plain version's, the
mean candidate groups per block, and a bound that does not depend on the
broad phase (``occlusion_bound``).  Then one JSON line of per-kernel
numbers (launches from the loop phase; ``launches_by_path`` each path's,
counted from 0 around it), the nvidia-smi line, and the
closing {"ok": true, ...} line.  Any failed
check raises; nothing falls back to the CPU.  With --profile, one more
flagship descent step and one descent step at the "large" shapes (23,762
faces, 'vn', the loop's chunk) run under torch.profiler: their kernel
tables go to DIR/profile*.txt, and a JSON line each gives the device-busy
share and the top device ops.
"""

import argparse
import json
import math
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
GGX_LOOP_ITERS = 8
# the material phase: the ggx scene's GT roughness, the alpha descent's
# start and steps, and the shape steps
ALPHA_STAR = 0.2
ALPHA0 = 0.5
ALPHA_STEPS = 5
SHAPE_STEPS = 3
CARD = ""
# the noise scene's and the real scene's loop iterations, the
# same-key case's tolerance on the first l2 (tests/test_torch_parity.py)
NOISE_ITERS = 4
REAL_ITERS = 2
REAL_SCAN = 64
SAME_KEY_L2_RTOL = 3e-4
ROOT = os.path.dirname(os.path.abspath(__file__))
SLEEP_CYCLES = 40_000_000   # device_ms's head start, ~20 ms at 1.98 GHz
SPEED_OF_LIGHT = 299_792_458.0   # m/s: a jitter of t seconds is c*t of path


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


def material_scene(dev):
    """The ggx scene at its own settings, as phase_material renders it:
    (mesh, lighting, lnormal, cfg with source_chunk 256, spec)."""
    import nlos_surface_optimization_torch as pt
    from nlos_surface_optimization_torch.experiments import run as runner
    from nlos_surface_optimization_torch.experiments.scenes import SCENES
    from nlos_surface_optimization_torch.geometry.accel import (
        morton_order_faces,
    )

    spec = SCENES["ggx"]
    v, f = runner._load_gt_mesh(spec, None)
    f = morton_order_faces(v, f)
    res = spec.scan_resolution
    cfg = pt.RenderConfig(num_samples=spec.sample_num,
                          num_bins=spec.num_bins,
                          distance_resolution=spec.distance_resolution,
                          brdf="ggx", source_chunk=min(256, res * res))
    lighting, lnormal = (torch.from_numpy(x).to(dev) for x in
                         pt.make_confocal_scan(res, lower=spec.scan_lower,
                                               upper=spec.scan_upper))
    return pt.make_mesh(v, f, device=dev), lighting, lnormal, cfg, spec


def material_case_inputs(dev, refine):
    """K1 at the material phase's shapes: the first chunk (256 sources,
    5.4 M rays) of the ggx scene with GGX at ALPHA_STAR, at ``refine``
    (None: the forward refine, 1 at sigma_bin 1, which every render of the
    phase runs: 1,200 bins a source)."""
    import nlos_surface_optimization_torch as pt
    from nlos_surface_optimization_torch.render import core

    mesh, lighting, lnormal, cfg, _ = material_scene(dev)
    Lc = cfg.source_chunk
    spt = cfg.samples_per_face(mesh.f.shape[0])
    _, args, kwargs = core.splat_inputs(
        mesh, lighting[:Lc], lnormal[:Lc], pt.key(11), cfg, spt,
        cfg.forward_refine if refine is None else refine, alpha=ALPHA_STAR)
    return args, kwargs


def phase_k1(dev, chunk_inputs_, ggx_inputs_):
    """K1 on a small grazing scene, the flagship chunk (Lambertian, and
    GGX at alpha 0.2), the loop's largest chunk, the GT render's shapes
    and the material phase's (256 sources; also checked at refine 10,
    12,000 bins a source)."""
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
    k1_case("flagship_ggx", *ggx_inputs_, reps=5, plain_reps=1)
    lv, lf = large_scene()
    k1_case("large", *chunk_inputs(dev, lv, lf, True), reps=5, plain_reps=1)
    gt, _ = k1_case("gt", *gt_case_inputs(dev))
    k1_case("material", *material_case_inputs(dev, None), reps=5,
            plain_reps=1)
    occ_m, _, err_m = check_k1(*material_case_inputs(dev, 10))
    emit("k1", case="material_refine10", max_abs_err=err_m,
         occluded=int(occ_m.sum()))
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


def sync_calls(fn):
    """The synchronizing calls of one fn() (after a warm call), under
    torch.cuda.set_sync_debug_mode('warn')."""
    import warnings

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [str(m.message).splitlines()[0][:120] for m in seen
            if "called a synchronizing" in str(m.message)]


def phase_sync(dev, v, f):
    """One flagship chunk of inverse_render (key on the card, hierarchy and
    CSR built, warmed once) under torch.cuda.set_sync_debug_mode('warn'):
    the synchronizing calls of its backward (must be none) and of the
    whole chunk."""
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

    counts = {name: sync_calls(fn)
              for name, fn in (("backward", backward), ("chunk", chunk))}
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


def kernel_wrappers():
    """The kernels' wrappers by name; each counts its launches."""
    from nlos_surface_optimization_torch.render import bwd_kernels as bk
    from nlos_surface_optimization_torch.render import fused_kernels as fk
    from nlos_surface_optimization_torch.render import occl_kernels as ok

    return {"occluded_splat": fk.occluded_splat,
            "backward_face_sums": bk.backward_face_sums,
            "vertex_epilogue": bk.vertex_epilogue,
            "segment_occluded": ok.segment_occluded}


def reset_launches():
    torch.cuda.synchronize()
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_launches():
    return {k: fn.launches for k, fn in kernel_wrappers().items()}


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


def phase_material_small(dev):
    """The material, jitter, legacy-loss and diagnostic entry points on the
    card against the CPU on the tests' small scene, at the CPU tests'
    tolerances: transients rtol 2e-5 / atol 1e-8, vertex gradients and
    the per-bin diagnostic rtol 2e-4 / atol 2e-5*max, scalar gradients
    rtol 1e-5.  The jitter and diagnostic calls must reach K3."""
    import nlos_surface_optimization_torch as pt
    from nlos_surface_optimization_torch.render import occl_kernels as ok

    v, f, _ = small_scene()
    lighting, lnormal = pt.make_confocal_scan(4)
    lam = pt.RenderConfig(num_samples=400, num_bins=300,
                          distance_resolution=5e-3, source_chunk=3)
    ggx_fn = lam.replace(brdf="ggx")
    ggx_vn = ggx_fn.replace(normal="vn", testing_flag=0)
    rng = np.random.RandomState(1)
    data = (rng.rand(16, 300) * 1e-3).astype(np.float32)
    w = (0.5 + rng.rand(16, 300)).astype(np.float32)
    jw = rng.rand(31)
    jw /= jw.sum()
    jg = np.gradient(jw)
    k = pt.key(3)
    cases = [
        ("ggx_render_fn", "t", False, lambda m: pt.render_transient(
            m, lighting, lnormal, ggx_fn, k, alpha=0.25)[:1]),
        ("ggx_render_vn", "t", True, lambda m: pt.render_transient(
            m, lighting, lnormal, ggx_vn, k, alpha=0.25)[:1]),
        ("ggx_inverse_fn", "tg", False, lambda m: pt.inverse_render(
            m, data, w, lighting, lnormal, ggx_fn, k, alpha=0.25)[:2]),
        ("ggx_inverse_vn", "tg", True, lambda m: pt.inverse_render(
            m, data, w, lighting, lnormal, ggx_vn, k, alpha=0.25)[:2]),
        ("albedo", "ts", False, lambda m: pt.inverse_render_albedo(
            m, data, w, lighting, lnormal, lam, k)),
        ("alpha", "ts", False, lambda m: pt.inverse_render_alpha(
            m, data, w, lighting, lnormal, ggx_fn, k, 0.25)),
        ("jitter_render", "t", False, lambda m: pt.render_transient_jitter(
            m, lighting, lnormal, lam, k, jw, 25)[:1]),
        ("jitter_inverse", "tg", False, lambda m: pt.inverse_render_jitter(
            m, data, w, lighting, lnormal, lam, k, jw, jg, 25)[:2]),
        ("vertex_gradient_bins", "g", False, lambda m: (
            pt.vertex_gradient_bins(m, lighting, lnormal, lam, k, 14),)),
        ("inverse_shading", "tg", False, lambda m: pt.inverse_shading_render(
            m, data, w, lighting, lnormal, lam.replace(testing_flag=0),
            k)[:2]),
        ("loss_smooth_width", "tg", False, lambda m: pt.inverse_render(
            m, data, w, lighting, lnormal, lam.replace(loss_smooth_width=2),
            k)[:2]),
    ]
    errs = {}
    for name, kinds, vn, fn in cases:
        out = {}
        before = ok.segment_occluded.launches
        for where in (dev, "cpu"):
            m = pt.make_mesh(v, f, device=where)
            if vn:
                m = m._replace(vn=pt.vertex_normals(m.v, m.f, m.f_valid))
            out[str(where)] = [x.cpu() for x in fn(m)]
        if name.startswith(("jitter", "vertex")):
            require(ok.segment_occluded.launches > before,
                    f"material_small {name}: K3 was not launched")
        errs[name] = []
        for kind, got, want in zip(kinds, out[str(dev)], out["cpu"]):
            scale = float(want.abs().max())
            require(bool(torch.isfinite(got).all()) and scale > 0,
                    f"material_small {name}: not finite, or zero")
            tol = {"t": dict(rtol=2e-5, atol=1e-8),
                   "g": dict(rtol=2e-4, atol=2e-5 * scale),
                   "s": dict(rtol=1e-5, atol=0.0)}[kind]
            torch.testing.assert_close(got, want, **tol)
            errs[name].append(float((got - want).abs().max()))
    emit("material_small", max_abs_err=errs)


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

    cfg = pt.RenderConfig(**FLAGSHIP)
    lighting, lnormal = pt.make_confocal_scan(SCAN)
    lighting = torch.from_numpy(lighting).to(dev)
    lnormal = torch.from_numpy(lnormal).to(dev)
    L, F = lighting.shape[0], f.shape[0]
    spt = cfg.samples_per_face(F)
    chunks = -(-L // cfg.source_chunk)
    key = pt.key(0)

    reset_launches()
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
    launches = read_launches()
    want = {"occluded_splat": chunks * (steps + 1),
            "backward_face_sums": chunks * steps,
            "vertex_epilogue": chunks * steps, "segment_occluded": 0}
    require(launches == want, f"launch counts {launches}, expected {want}")
    emit("slice", scan=f"{SCAN}x{SCAN}", faces=F, spt=spt, chunks=chunks,
         rays_per_pass=L * F * spt, launches=launches,
         step_seconds=per_step, gt_seconds=gt_s)
    if profile_dir:
        profile_step(descent, profile_dir, "flagship")
    return launches


def phase_ggx_slice(dev, v, f, plane, steps):
    """The slice's GT render and descent steps with the GGX BRDF (GT at
    ALPHA_STAR, the steps at the default roughness 0.1): K1 forward, the
    eager GGX backward."""
    import nlos_surface_optimization_torch as pt

    cfg = pt.RenderConfig(**FLAGSHIP).replace(brdf="ggx")
    lighting, lnormal = (torch.from_numpy(x).to(dev)
                         for x in pt.make_confocal_scan(SCAN))
    L, F = lighting.shape[0], f.shape[0]
    spt = cfg.samples_per_face(F)
    chunks = -(-L // cfg.source_chunk)
    reset_launches()
    t0 = time.perf_counter()
    gt, _ = pt.render_transient(pt.make_mesh(v, f, device=dev), lighting,
                                lnormal, cfg, pt.key(0), alpha=ALPHA_STAR)
    torch.cuda.synchronize()
    gt_s = time.perf_counter() - t0
    require(bool(torch.isfinite(gt).all()) and float(gt.max()) > 0,
            "GGX ground-truth transient is not finite and positive")
    descent = Descent(plane, f, gt, lighting, lnormal, cfg, pt.key(0), dev)
    per_step = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        l2, data_l2, grad = descent.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        require(np.isfinite(l2) and bool(torch.isfinite(grad).all())
                and float(grad.abs().max()) > 0,
                f"GGX step {i}: loss or gradient not finite, or zero")
        per_step.append(dt)
        emit("ggx_slice_step", step=i, l2=l2, data_l2=data_l2, seconds=dt,
             path_samples_per_sec=2.0 * L * F * spt / dt,
             grad_max=float(grad.abs().max()))
    launches = read_launches()
    want = {"occluded_splat": chunks * (steps + 1), "backward_face_sums": 0,
            "vertex_epilogue": 0, "segment_occluded": 0}
    require(launches == want, f"launch counts {launches}, expected {want}")
    emit("ggx_slice", faces=F, spt=spt, chunks=chunks, launches=launches,
         step_seconds=per_step, gt_seconds=gt_s)
    ggx_chunk_times(dev, v, f)
    return launches


def ggx_chunk_times(dev, v, f):
    """Where a GGX step's extra time goes, on one flagship chunk (64
    sources, 1.36 M rays, 'fn', the default roughness): the forward (trace
    + K1, the GGX weights formed in splat_inputs), the backward (the eager
    GGX backward against the fused Lambertian one, K2 + epilogue) and the
    whole chunk body, GGX beside Lambertian.  ``*_ms`` with the host's
    time (timed_ms), ``backward_device_ms`` on the card alone (device_ms;
    it counts host time too where the call synchronizes, see
    ``ggx_backward_syncs``)."""
    import nlos_surface_optimization_torch as pt
    from nlos_surface_optimization_torch.render import api
    from nlos_surface_optimization_torch.render import bwd_kernels as bk
    from nlos_surface_optimization_torch.render import core
    from nlos_surface_optimization_torch.render import fused_kernels as fk

    rays, mesh, nc, diff, cfg, spt = k2_case_inputs(
        dev, v, f, "fn", FLAGSHIP["source_chunk"])
    cfgs = {"lambertian": cfg, "ggx": cfg.replace(brdf="ggx")}
    lc = torch.from_numpy(pt.make_confocal_scan(SCAN)[0][
        :FLAGSHIP["source_chunk"]]).to(dev)
    hier = fk.face_hierarchy(mesh.v, mesh.f, mesh.f_valid)
    csr = bk.vertex_csr(mesh.f, mesh.f_valid, mesh.v.shape[0])
    key = pt.key(0).to(dev)
    w = torch.ones_like(diff)
    grad = torch.zeros_like(mesh.v)
    backward = {
        "lambertian": lambda: bk.backward_chunk_fused(
            rays, mesh, nc, diff, 0, cfg, spt, csr=csr, grad=grad),
        "ggx": lambda: core.backward_chunk(rays, mesh, nc, diff, 0,
                                           cfgs["ggx"], spt)}
    rec = dict(
        forward_ms={n: timed_ms(lambda c=c: core.trace_forward_fused(
            mesh, lc, nc, key, c, spt, c.forward_refine, hier=hier), 10)
            for n, c in cfgs.items()},
        backward_ms={n: timed_ms(b, 10) for n, b in backward.items()},
        backward_device_ms={n: device_ms(b, 10)
                            for n, b in backward.items()},
        chunk_ms={n: timed_ms(lambda c=c: api._fused_chunk_body(
            mesh, lc, nc, 0, key, diff, w, c, spt, hier, csr, None), 10)
            for n, c in cfgs.items()},
        ggx_backward_syncs=len(sync_calls(backward["ggx"])))
    emit("ggx_chunk", rays=rays.h.numel(), **rec)


def jitter_kernels(workdir, resolution):
    """{name: (weight [K], grad [K], offset)} from the runner's jitter
    calibration (its synthetic 901-sample histogram over [-84 ps, 650 ps]
    where no measured one is found), each normalized with its offset the
    tap of t = 0 and its grad the central differences:
    'binned', the counts summed onto the transient's bins (``resolution``
    of path a tap, c*t: ~184 taps at 1.2 mm), the kernel such a capture
    gives; 'raw901', one tap a calibration sample, ~5x as wide in time as
    the calibration, a stress case for the 900-tap correlations."""
    from nlos_surface_optimization_torch.experiments import run as runner

    t, counts = runner._find_jitter_calibration(workdir)
    tap = np.rint(t * SPEED_OF_LIGHT / resolution).astype(np.int64)
    binned = np.bincount(tap - tap.min(), weights=counts)
    out = {}
    for name, c, off in (("binned", binned, int(-tap.min())),
                         ("raw901", counts, int(np.argmin(np.abs(t))))):
        w = c / c.sum()
        out[name] = (w, np.gradient(w), off)
    return out


def phase_jitter(dev, v, f, plane, workdir):
    """For each jitter kernel: render_transient_jitter of the flagship
    mesh, then inverse_render_jitter from its flat plane against it, at
    full width; K3 once a chunk in each, no other kernel."""
    import nlos_surface_optimization_torch as pt
    from nlos_surface_optimization_torch.optim import loss

    cfg = pt.RenderConfig(**FLAGSHIP)
    lighting, lnormal = (torch.from_numpy(x).to(dev)
                         for x in pt.make_confocal_scan(SCAN))
    L, F = lighting.shape[0], f.shape[0]
    spt = cfg.samples_per_face(F)
    chunks = -(-L // cfg.source_chunk)
    kernels = jitter_kernels(workdir, cfg.distance_resolution)
    reset_launches()
    for name, (jw, jg, off) in kernels.items():
        before = read_launches()["segment_occluded"]
        t0 = time.perf_counter()
        gt, _ = pt.render_transient_jitter(pt.make_mesh(v, f, device=dev),
                                           lighting, lnormal, cfg, pt.key(0),
                                           jw, off)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        fwd_launches = read_launches()["segment_occluded"] - before
        require(bool(torch.isfinite(gt).all()) and float(gt.max()) > 0,
                f"jitter {name}: transient is not finite and positive")
        weight = loss.create_weighting_function(gt, 1.0)
        t0 = time.perf_counter()
        t, g, _ = pt.inverse_render_jitter(pt.make_mesh(plane, f, device=dev),
                                           gt, weight, lighting, lnormal, cfg,
                                           pt.key(0), jw, jg, off)
        torch.cuda.synchronize()
        inv_s = time.perf_counter() - t0
        inv_launches = (read_launches()["segment_occluded"] - before
                        - fwd_launches)
        require(bool(torch.isfinite(t).all())
                and bool(torch.isfinite(g).all())
                and float(g.abs().max()) > 0,
                f"jitter {name}: gradient not finite, or zero")
        require(fwd_launches == chunks and inv_launches == chunks,
                f"jitter {name}: K3 launched {fwd_launches} then "
                f"{inv_launches} times, expected {chunks} each")
        emit("jitter", kernel=name, taps=len(jw), offset=off, faces=F,
             spt=spt, chunks=chunks, forward_seconds=fwd_s,
             forward_path_samples_per_sec=L * F * spt / fwd_s, seconds=inv_s,
             path_samples_per_sec=2.0 * L * F * spt / inv_s,
             data_l2=float(loss.weighted_l2(gt, weight, t)),
             grad_max=float(g.abs().max()))
    launches = read_launches()
    want = {"occluded_splat": 0, "backward_face_sums": 0,
            "vertex_epilogue": 0,
            "segment_occluded": 2 * chunks * len(kernels)}
    require(launches == want, f"launch counts {launches}, expected {want}")
    return launches


def _stamped(lines):
    """A log that keeps (host time, message)."""
    return lambda msg: lines.append((time.perf_counter(), msg))


def _step_seconds(t0, lines):
    times = [t0] + [t for t, _ in lines]
    return [b - a for a, b in zip(times, times[1:])]


def phase_material(dev, workdir):
    """The ggx scene's material pipeline at its own settings: GT at
    ALPHA_STAR, the closed-form albedo, ALPHA_STEPS roughness steps from
    ALPHA0, then SHAPE_STEPS shape steps (at the recovered roughness)
    from the GT shape raised by 8 mm; no plateau stop."""
    import nlos_surface_optimization_torch as pt
    from nlos_surface_optimization_torch.geometry.sampling import fold_in
    from nlos_surface_optimization_torch.optim import loss, material

    mesh, lighting, lnormal, cfg, spec = material_scene(dev)
    res = spec.scan_resolution
    L, F = lighting.shape[0], mesh.f.shape[0]
    spt = cfg.samples_per_face(F)
    chunks = -(-L // cfg.source_chunk)
    key = pt.key(11)
    reset_launches()
    t0 = time.perf_counter()
    gt, _ = pt.render_transient(mesh, lighting, lnormal, cfg, key, refine=1,
                                alpha=ALPHA_STAR)
    torch.cuda.synchronize()
    gt_s = time.perf_counter() - t0
    require(bool(torch.isfinite(gt).all()) and float(gt.max()) > 0,
            "material GT is not finite and positive")
    weight = loss.create_weighting_function(gt, spec.gamma)
    albedo = material.initial_fitting_albedo(mesh, gt.cpu().numpy(),
                                             lighting, lnormal, cfg, key)
    require(np.isfinite(albedo) and albedo > 0, f"albedo fit {albedo}")
    mesh = material._with_albedo(mesh, albedo)

    lines_a = []
    t0 = time.perf_counter()
    alpha, losses_a = material.optimize_alpha(
        mesh, gt, weight, lighting, lnormal, cfg,
        fold_in(key, torch.tensor([100]))[0], ALPHA0, lr=1e-2, T=ALPHA_STEPS,
        loss_epsilon=-np.inf, log=_stamped(lines_a))
    alpha_s = _step_seconds(t0, lines_a)
    traj = [ALPHA0] + [float(m.rsplit(" ", 1)[1]) for _, m in lines_a]

    v0 = mesh.v.clone()
    v0[:, 2] += 0.008
    lines_s = []
    t0 = time.perf_counter()
    shaped, _, l2_final, losses_s = material.optimize_shape(
        mesh._replace(v=v0), gt, weight, lighting, lnormal, cfg,
        fold_in(key, torch.tensor([200]))[0], T=SHAPE_STEPS,
        loss_epsilon=-np.inf, alpha=alpha,
        log=_stamped(lines_s))
    torch.cuda.synchronize()
    shape_s = _step_seconds(t0, [x for x in lines_s if " L2 " in x[1]])
    launches = read_launches()
    rate = [2.0 * L * F * spt / s for s in alpha_s + shape_s]
    emit("material", scene="ggx", scan=f"{res}x{res}", faces=F, spt=spt,
         chunks=chunks, gt_seconds=gt_s, albedo=albedo,
         alpha_trajectory=traj, alpha_losses=losses_a,
         alpha_step_seconds=alpha_s, shape_losses=losses_s,
         shape_step_seconds=shape_s, path_samples_per_sec=rate,
         launches=launches)
    require(len(losses_a) == ALPHA_STEPS and len(losses_s) == SHAPE_STEPS,
            "a descent stopped early")
    require(bool(np.isfinite(losses_a + losses_s).all())
            and np.isfinite(alpha) and np.isfinite(l2_final)
            and bool(torch.isfinite(shaped.v).all()),
            "material: a value is not finite")
    require(losses_a[-1] < losses_a[0], f"alpha losses {losses_a} rise")
    require(abs(alpha - ALPHA_STAR) < abs(ALPHA0 - ALPHA_STAR),
            f"alpha went from {ALPHA0} to {alpha}, away from {ALPHA_STAR}")
    require(losses_s[-1] < losses_s[0], f"shape losses {losses_s} rise")
    want = {"occluded_splat": chunks * (2 + ALPHA_STEPS + SHAPE_STEPS),
            "backward_face_sums": 0, "vertex_epilogue": 0,
            "segment_occluded": 0}
    require(launches == want, f"launch counts {launches}, expected {want}")
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


def phase_loop(dev, workdir, rec, scene=SCENE, iters=LOOP_ITERS,
               name="loop", sizes=None, min_remeshes=1):
    """run_experiment(scene, max_iters=iters) at the scene's own width
    (``sizes`` None) or at ``sizes``; the launches held to the chunks the
    renders ran: the GT's (a real scene's albedo fit render instead), the
    steps' (K2 and its epilogue once a step chunk for a Lambertian scene,
    none for GGX), the remeshes' cull (K3)."""
    from nlos_surface_optimization_torch.experiments import run as runner
    from nlos_surface_optimization_torch.experiments.scenes import SCENES
    from nlos_surface_optimization_torch.geometry import native

    spec = SCENES[scene]
    sizes = LOOP_SIZES if sizes is None else sizes
    reset_launches()
    t0 = time.perf_counter()
    rec.log("start")
    state, hist = runner.run_experiment(scene, workdir, max_iters=iters,
                                        log=rec.log, device=dev, **sizes)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = read_launches()
    loop = rec.loops[-1]
    steps = [r for r in loop.stats if r["kind"] == "step"]
    remeshes = [r for r in loop.stats if r["kind"] == "remesh"]
    for r in steps:
        emit(f"{name}_step", iteration=r["iteration"], seconds=r["seconds"],
             l2=hist["l2"][r["iteration"]], v2=hist["v2"][r["iteration"]],
             faces=r["faces"], spt=r["spt"], chunks=r["chunks"],
             path_samples_per_sec=2.0 * r["sources"] * r["faces"] * r["spt"]
             / r["seconds"])
    for r in remeshes:
        emit(f"{name}_remesh", **r)
    require(len(hist["l2"]) == iters and state.t == iters,
            f"the loop ran {len(hist['l2'])} of {iters} iterations")
    require(bool(np.isfinite(hist["l2"]).all()), "l2 not finite")
    require(spec.kind == "real" or bool(np.isfinite(hist["v2"]).all()),
            "v2 not finite")
    require(len(remeshes) >= min_remeshes,
            f"{len(remeshes)} remeshes ran, expected {min_remeshes} or more")

    res = sizes["scan_resolution"] or spec.scan_resolution
    if spec.kind == "real":
        gt_f = None
        gt = -(-res * res // min(256, res * res))   # the albedo fit render
    else:
        gt_v, gt_f = runner._load_gt_mesh(spec, None)
        gt = gt_chunks(gt_f.shape[0],
                       sizes["gt_sample_num"]
                       or min(spec.gt_sample_num, 200_000),
                       res * res, 16 if res >= 256 else 8)
    k2 = sum(r["chunks"] for r in steps) if spec.brdf == "lambertian" else 0
    want = {"occluded_splat": gt + sum(r["chunks"] for r in steps),
            "backward_face_sums": k2, "vertex_epilogue": k2,
            "segment_occluded": sum(r["chunks"] for r in remeshes)}
    require(launches == want, f"launch counts {launches}, expected {want}")
    init = next(m for _, m in rec.lines if m.startswith("init mesh"))
    first = "loaded capture" if spec.kind == "real" else "creating GT"
    emit(name, scene=scene, scan=f"{res}x{res}", seconds=total,
         gt_seconds=rec.at("LCT initialization") - rec.at(first)
         if spec.kind != "real" else None,
         lct_seconds=rec.at("init mesh") - rec.at("LCT initialization"),
         init=init, gt_faces=None if gt_f is None else gt_f.shape[0],
         gt_chunks=gt, iterations=len(steps), remeshes=len(remeshes),
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


# ------------------------------------- init, tools, noise, real scenes


def standin_capture(path, n=64, bins=2048, res=1.2e-3):
    """A measured capture's layout (exp_s/transient.mat): 'transient'
    [n*n, bins] and 'lighting' [n*n, 3]; a Gaussian pulse at each pixel's
    path length to a plane at z = 0.55, and a direct-bounce spike in the
    600 bins the loader zeroes (tests/test_torch_real.py's stand-in)."""
    import scipy.io

    xs = np.linspace(-0.35, 0.35, n)
    gx, gy = np.meshgrid(xs, xs)
    lighting = np.stack([gx.ravel(), gy.ravel(), np.zeros(n * n)], axis=1)
    h = np.sqrt(gx.ravel() ** 2 + gy.ravel() ** 2 + 0.55 ** 2)
    b = np.arange(bins)
    t = np.exp(-((b[None, :] - 2.0 * h[:, None] / res) / 6.0) ** 2)
    t[:, :600] += 5.0
    scipy.io.savemat(path, {"transient": t, "lighting": lighting})


def lct_case(dev, name, gt, width, res):
    """lct_reconstruct and the init mesh on the card against the CPU:
    the grids and the init mesh bit for bit -> record."""
    from nlos_surface_optimization_torch.recon import lct

    out, secs = {}, {}
    for where in (dev, "cpu"):
        t0 = time.perf_counter()
        r = lct.lct_reconstruct(gt, width=width, bin_resolution_m=res,
                                device=where)
        v0, f0 = lct.init_mesh_from_lct(
            r, threshold=float(r.albedo.max()) * 0.25)
        if where != "cpu":
            torch.cuda.synchronize()
        secs[str(where)] = time.perf_counter() - t0
        out[str(where)] = (r, v0, f0)
    (r, v0, f0), (rc, vc, fc) = out[str(dev)], out["cpu"]
    require(fc.shape[0] > 0, f"LCT {name}: the init mesh has no face")
    grids = {k: bool(torch.equal(getattr(r, k).cpu(), getattr(rc, k)))
             for k in ("x", "y", "depth")}
    same = f0.shape == fc.shape and bool(np.array_equal(f0, fc)
                                         and np.array_equal(v0, vc))
    rec = dict(case=name, scan=int(math.isqrt(gt.shape[0])),
               bins=gt.shape[1], grids_equal=grids, init_mesh_equal=same,
               faces=[f0.shape[0], fc.shape[0]],
               depth_bins_differing=int((r.depth.cpu() != rc.depth).sum()),
               albedo_max_rel_diff=float((r.albedo.cpu() - rc.albedo).abs()
                                         .max() / rc.albedo.max()),
               card_seconds=secs[str(dev)], cpu_seconds=secs["cpu"])
    emit("lct", **rec)
    require(all(grids.values()) and same,
            f"LCT {name}: the card's init mesh differs from the CPU's")


def phase_lct(dev, workdir):
    """The LCT init on the card against the CPU at the loop's shapes: the
    armadillo scene's 64x64 x 1,200-bin GT (rendered on the card at the
    scene's 20,000 samples), and the stand-in capture at 64x64 x 2,048."""
    import nlos_surface_optimization_torch as pt
    from nlos_surface_optimization_torch.experiments import run as runner
    from nlos_surface_optimization_torch.experiments.scenes import SCENES
    from nlos_surface_optimization_torch.io.mat import load_real_capture

    spec = SCENES[SCENE]
    v, f = runner._load_gt_mesh(spec, None)
    lighting, lnormal = pt.make_confocal_scan(LOOP_SIZES["scan_resolution"]
                                              or spec.scan_resolution,
                                              lower=spec.scan_lower,
                                              upper=spec.scan_upper)
    cfg = pt.RenderConfig(num_samples=spec.sample_num,
                          num_bins=spec.num_bins,
                          distance_resolution=spec.distance_resolution)
    gt, _ = pt.render_transient(pt.make_mesh(v, f, device=dev),
                                torch.from_numpy(lighting).to(dev),
                                torch.from_numpy(lnormal).to(dev), cfg,
                                pt.key(0))
    lct_case(dev, SCENE, gt.cpu().numpy(), runner._width(lighting),
             spec.distance_resolution)
    path = os.path.join(workdir, "standin.mat")
    standin_capture(path, REAL_SCAN)
    gt, lighting, _ = load_real_capture(path)
    lct_case(dev, "s", gt, runner._width(lighting),
             SCENES["s"].distance_resolution)


def phase_tools(dev):
    """nearest_hit on the card against the CPU: +z rays from a 64x64 grid
    over the 'large' mesh (23,762 faces; rays past its border miss) and
    from its 12,100 vertices (hits on shared vertices: equal t on several
    faces, the lowest id wins), every ray on the card and every 3rd
    vertex ray on the CPU; fid equal, t, u, v equal within f32; then
    average_z_distance of the flat plane to the mesh, card and CPU."""
    import nlos_surface_optimization_torch as pt
    from nlos_surface_optimization_torch.geometry.intersect import (
        nearest_hit,
    )
    from nlos_surface_optimization_torch.utils.metrics import (
        average_z_distance,
    )

    v, f, plane = height_field(LARGE_N, 0.35, 0.6, 0.01, 0)
    xs = np.linspace(-0.4, 0.4, SCAN)
    gx, gy = np.meshgrid(xs, xs)
    grid = np.stack([gx.ravel(), gy.ravel(), np.zeros(SCAN * SCAN)], 1)
    verts = v.copy()
    verts[:, 2] = 0.0
    meshes = {str(w): pt.make_mesh(v, f, device=w) for w in (dev, "cpu")}
    for name, o, step in (("grid", grid, 1), ("vertices", verts, 3)):
        o = torch.from_numpy(o.astype(np.float32))
        d = torch.zeros_like(o)
        d[:, 2] = 1.0
        m = meshes[str(dev)]
        card = (o.to(dev), d.to(dev), m.v, m.f, m.f_valid)
        t0 = time.perf_counter()
        got = [x.cpu()[::step] for x in nearest_hit(*card)]
        card_s = time.perf_counter() - t0
        m = meshes["cpu"]
        t0 = time.perf_counter()
        want = nearest_hit(o[::step], d[::step], m.v, m.f, m.f_valid)
        cpu_s = time.perf_counter() - t0
        hits = int((want[0] >= 0).sum())
        require(torch.equal(got[0], want[0]), f"tools {name}: fid differs "
                f"({int((got[0] != want[0]).sum())} rays)")
        require(hits > 0, f"tools {name}: no ray hits")
        for a, b in zip(got[1:], want[1:]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
        emit("tools", case=name, rays=o.shape[0], rays_on_cpu=len(want[0]),
             faces=f.shape[0], hits_on_cpu=hits,
             max_abs_err=float(max((a - b).abs().max()
                                   for a, b in zip(got[1:], want[1:]))),
             card_seconds=card_s, cpu_seconds=cpu_s,
             card_ms=timed_ms(lambda: nearest_hit(*card), 3))
    z = {w: float(average_z_distance(torch.from_numpy(plane).to(m.v.device),
                                     m))
         for w, m in meshes.items()}
    require(abs(z[str(dev)] - z["cpu"]) <= 1e-6 * z["cpu"],
            f"average_z_distance differs: {z}")
    emit("tools", case="average_z_distance", value=z)


def same_distribution(got, want, ideal, M):
    """Rescaled SPAD rows (torch, CPU) turned back into counts: per-row
    totals within 5 sd of their Poisson spread, and a two-sample
    chi-square of at most 1.3 a bin for each row and for the rows' sum
    (tests/test_torch_noise.py's checks; a shift of a row's peak by a few
    bins puts its chi-square far above 1.3) -> stats, with each row's
    peak (after a 9-bin box) beside the other's."""
    scale = M / ideal.sum(dim=1, keepdim=True)
    a, b = (got * scale).double(), (want * scale).double()
    ta, tb = a.sum(1), b.sum(1)
    z = float(((ta - tb).abs() / (ta + tb).sqrt()).max())

    def chi2(x, y):
        n = x + y > 0
        return float(((x - y)[n] ** 2 / (x + y)[n]).mean())

    rows = [chi2(x, y) for x, y in zip(a, b)]
    box = torch.ones(1, 1, 9, dtype=torch.float64) / 9
    pa, pb = (torch.nn.functional.conv1d(x[:, None], box, padding=4)
              .argmax(-1).ravel() for x in (a, b))
    off = (pa - pb).abs()
    stats = dict(rows=a.shape[0], total_z_max=z,
                 chi2_per_bin_rows_max=max(rows),
                 chi2_per_bin_sum=chi2(a.sum(0), b.sum(0)),
                 peak_offset_median=float(off.double().median()),
                 peak_offset_max=int(off.max()))
    require(z < 5 and max(rows) < 1.3 and stats["chi2_per_bin_sum"] < 1.3,
            f"noise: the card's counts are not the CPU's in distribution "
            f"{stats}")
    return stats


def phase_noise(dev, v, f, tmp):
    """The SPAD model at full width: the flagship GT (64x64 scan, 1,200
    bins), 20,000 photons a point, the runner's jitter calibration,
    pileup=False; its seconds and peak memory; chunk invariance on the
    card (source_chunk 16 against 256); the card against the CPU on 32
    rows by distribution.  Then run_experiment("noise") at the scene's
    own settings for NOISE_ITERS iterations, and the final mesh's
    average_z_distance to the GT mesh."""
    import nlos_surface_optimization_torch as pt
    from nlos_surface_optimization_torch.experiments import run as runner
    from nlos_surface_optimization_torch.experiments.scenes import SCENES
    from nlos_surface_optimization_torch.geometry import sampling
    from nlos_surface_optimization_torch.noise import (
        SpadParams,
        spad_model,
        spad_noisy_transients,
    )
    from nlos_surface_optimization_torch.utils.metrics import (
        average_z_distance,
    )

    spec = SCENES["noise"]
    cfg = pt.RenderConfig(**FLAGSHIP)
    lighting, lnormal = (torch.from_numpy(x).to(dev)
                         for x in pt.make_confocal_scan(SCAN))
    gt, _ = pt.render_transient(pt.make_mesh(v, f, device=dev), lighting,
                                lnormal, cfg, pt.key(0))
    jt, jc = runner._find_jitter_calibration(tmp)
    params = SpadParams(num_photons=spec.spad_photons,
                        mu_noise=spec.spad_mu_noise, pileup=False)
    key = sampling.fold_in(pt.key(0), torch.tensor([777]))[0]
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    noisy = spad_noisy_transients(key, gt, jt, jc, params, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    t0 = time.perf_counter()
    wide = spad_noisy_transients(key, gt, jt, jc, params, source_chunk=256,
                                 device=dev)
    torch.cuda.synchronize()
    wide_secs = time.perf_counter() - t0
    require(torch.equal(noisy, wide), "noise: source_chunk 16 and 256 "
            f"differ in {int((noisy != wide).sum())} bins")
    require(bool(torch.isfinite(noisy).all()), "noise: not finite")
    L, M = gt.shape[0], params.num_photons
    rows = list(range(0, L, L // 32))
    keys = sampling.split(key, L)
    ideal = gt.cpu()[rows]
    t0 = time.perf_counter()
    cpu = torch.stack([spad_model(keys[i], ideal[j], jt, jc, params,
                                  device="cpu")
                       for j, i in enumerate(rows)])
    cpu_secs = time.perf_counter() - t0
    stats = same_distribution(noisy.cpu()[rows], cpu / M * ideal.sum(
        1, keepdim=True), ideal, M)
    require(read_launches() == {k: 0 for k in kernel_wrappers()},
            "the SPAD model launched a kernel")
    emit("noise", scan=f"{SCAN}x{SCAN}", bins=gt.shape[1], photons=M,
         photon_draws=L * M, seconds=secs, seconds_chunk256=wide_secs,
         peak_memory_bytes=peak, cpu_seconds_32_rows=cpu_secs, **stats)

    rec = Recorder()
    launches, state, hist = phase_loop(dev, os.path.join(tmp, "noise"), rec,
                                       "noise", NOISE_ITERS, "noise_loop",
                                       min_remeshes=0)
    gt_v, gt_f = runner._load_gt_mesh(spec, None)
    z = float(average_z_distance(torch.from_numpy(state.v).to(dev),
                                 pt.make_mesh(gt_v, gt_f, device=dev)))
    require(np.isfinite(z), "noise: average_z_distance not finite")
    emit("noise_loop", average_z_distance=z, l2=list(hist["l2"]),
         spad_seconds=rec.at("LCT initialization")
         - rec.at("injecting SPAD noise"))
    return launches


def phase_real(dev, v, f, tmp):
    """The real-scene path at a capture's width: the stand-in capture at
    64x64 and B = 2,048 (20,480 fine bins at refine 10).  K1 at refine 10
    and K2 (its fine bins at refine 10) on one 64-source chunk of the
    capture's scan, on the flagship mesh v, f (the stand-in's own LCT
    init mesh is a few faces), against their plain versions; then
    run_experiment("s", max_iters=REAL_ITERS) at full width."""
    import nlos_surface_optimization_torch as pt
    from nlos_surface_optimization_torch.experiments.scenes import SCENES
    from nlos_surface_optimization_torch.io.mat import load_real_capture
    from nlos_surface_optimization_torch.render import core

    workdir = os.path.join(tmp, "s")
    os.makedirs(workdir)
    path = os.path.join(workdir, "transient.mat")
    standin_capture(path, REAL_SCAN)
    spec = SCENES["s"]
    gt, lighting, _ = load_real_capture(path)
    cfg = pt.RenderConfig(num_samples=spec.sample_num, num_bins=gt.shape[1],
                          distance_resolution=spec.distance_resolution,
                          source_chunk=FLAGSHIP["source_chunk"])
    Lc = cfg.source_chunk
    lc = torch.from_numpy(lighting[:Lc]).to(dev)
    nc = torch.zeros(Lc, 3, device=dev)
    nc[:, 2] = 1.0
    mesh = pt.make_mesh(v, f, device=dev)
    spt = cfg.samples_per_face(f.shape[0])
    _, args, kwargs = core.splat_inputs(mesh, lc, nc, pt.key(0), cfg, spt,
                                        cfg.bin_refine_resolution)
    require(args[-1] == 10 * gt.shape[1], f"K1 real: {args[-1]} fine bins")
    k1_case("real", args, kwargs, reps=5, plain_reps=1)
    rays, _ = core.trace_forward_fused(mesh, lc, nc, pt.key(0), cfg, spt,
                                       cfg.forward_refine)
    diff = torch.from_numpy((np.random.RandomState(3).randn(
        Lc, cfg.num_bins) * 1e-3).astype(np.float32)).to(dev)
    k2_case("real", rays, mesh, nc, diff, cfg, spt, reps=10)
    return phase_loop(dev, workdir, Recorder(), "s", REAL_ITERS, "real_loop",
                      min_remeshes=0)[0]


def phase_same_key(dev, tmp):
    """tests/data/parity_short.json's case on the card: the port's
    run_experiment with the JAX fixture's key and arguments.  The first
    iteration's face count and l2 must be JAX's (l2 within
    SAME_KEY_L2_RTOL); every iteration's deviation is printed."""
    from nlos_surface_optimization_torch.io.progress import collect_progress

    with open(os.path.join(ROOT, "tests", "data",
                           "parity_short.json")) as fh:
        fix = json.load(fh)
    a = fix["args"]
    sizes = {k: a[k] for k in ("scan_resolution", "sample_num",
                               "gt_sample_num")}
    workdir = os.path.join(tmp, "same_key")
    launches, _, hist = phase_loop(dev, workdir, Recorder(), a["scene"],
                                   a["max_iters"], "same_key", sizes,
                                   min_remeshes=0)
    faces = collect_progress(os.path.join(workdir, "progress"))["num_faces"]
    dev_l2 = [abs(x / y - 1) for x, y in zip(hist["l2"], fix["l2"])]
    dev_v2 = [abs(x / y - 1) for x, y in zip(hist["v2"], fix["v2"])]
    emit("same_key", faces=[int(x) for x in faces], jax_faces=fix["faces"],
         l2_rel_dev=dev_l2, v2_rel_dev=dev_v2,
         faces_equal=bool(np.array_equal(faces, fix["faces"])))
    require(faces[0] == fix["faces"][0] and dev_l2[0] <= SAME_KEY_L2_RTOL,
            f"same_key: iteration 0 has {faces[0]} faces and l2 "
            f"{hist['l2'][0]} against JAX's {fix['faces'][0]} and "
            f"{fix['l2'][0]}")
    return launches


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
    _, ggx_args, ggx_kwargs = core.splat_inputs(
        mesh, lc, nc, pt.key(0), cfg.replace(brdf="ggx"), spt,
        cfg.forward_refine, alpha=ALPHA_STAR)
    k1 = phase_k1(dev, (args, kwargs), (ggx_args, ggx_kwargs))
    k2, epi = phase_k2(dev, v, f)
    phase_sync(dev, v, f)
    k3 = phase_k3(dev, v, f)
    phase_uniforms(dev, f.shape[0], spt)
    phase_small(dev)
    phase_intensity(dev)
    phase_material_small(dev)
    paths = {"slice": phase_slice(dev, v, f, plane, steps, profile_dir)}
    paths["ggx_slice"] = phase_ggx_slice(dev, v, f, plane, steps)
    if profile_dir:
        profile_large(dev, profile_dir)
    with tempfile.TemporaryDirectory() as tmp:
        paths["jitter"] = phase_jitter(dev, v, f, plane, tmp)
        paths["material"] = phase_material(dev, tmp)
        rec = Recorder()
        workdir = os.path.join(tmp, SCENE)
        launches, state, hist = phase_loop(dev, workdir, rec)
        paths["loop"] = launches
        phase_resume(dev, workdir, state, hist, rec)
        paths["ggx_loop"] = phase_loop(dev, os.path.join(tmp, "ggx"),
                                       Recorder(), "ggx", GGX_LOOP_ITERS,
                                       "ggx_loop")[0]
        phase_lct(dev, tmp)
        phase_tools(dev)
        paths["noise"] = phase_noise(dev, v, f, tmp)
        paths["real"] = phase_real(dev, v, f, tmp)
        paths["same_key"] = phase_same_key(dev, tmp)

    def by_path(name):
        return {p: n[name] for p, n in paths.items()}

    pkg = "nlos_surface_optimization_torch"
    return [
        dict(name="occluded_splat", route="cuda",
             source=f"{pkg}/csrc/occluded_splat.cu",
             replaces="nlos_surface_optimization_tpu/render/"
                      "fused_kernels.py:122",
             launches=launches["occluded_splat"],
             launches_by_path=by_path("occluded_splat"), library_ms=None,
             **k1),
        dict(name="backward_face_sums", route="cuda",
             source=f"{pkg}/csrc/backward_face_sums.cu",
             replaces="nlos_surface_optimization_tpu/render/"
                      "bwd_kernels.py:59",
             launches=launches["backward_face_sums"],
             launches_by_path=by_path("backward_face_sums"), library_ms=None,
             **k2),
        dict(name="vertex_epilogue", route="cuda",
             source=f"{pkg}/csrc/backward_face_sums.cu",
             replaces="nlos_surface_optimization_tpu/render/"
                      "bwd_kernels.py:300",
             launches=launches["vertex_epilogue"],
             launches_by_path=by_path("vertex_epilogue"), library_ms=None,
             **epi),
        dict(name="segment_occluded", route="cuda",
             source=f"{pkg}/csrc/segment_occluded.cu",
             replaces="nlos_surface_optimization_tpu/render/"
                      "pallas_kernels.py:68",
             launches=launches["segment_occluded"],
             launches_by_path=by_path("segment_occluded"), library_ms=None,
             **k3),
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
