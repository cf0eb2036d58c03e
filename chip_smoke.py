#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--profile DIR]

Phases, each printing one JSON line with the card's name and power limit:

  build    compile every kernel in nlos_surface_optimization_torch/csrc with
           nvcc (sm_90a), one process per source, all started together
  k1       the fused occlusion + splat kernel against its plain PyTorch
           version, on a small scene and on one flagship source chunk:
           equal masks, histogram within rtol 2e-6 / atol 1e-7*max, two
           launches bit-identical
  k2       the fused backward face-sum kernel against its plain version on
           the same chunk: rtol 2e-4 / atol 2e-5*max|g|, two launches
           bit-identical
  uniforms the threefry draws of one chunk on the card equal the CPU's
  small    inverse_render on the card against the CPU on a small scene
  slice    the flagship iteration at full width: bench.py's 3,042-face
           height field, a 64x64 confocal scan, 20,000 samples per source,
           1,200 bins; a ground-truth render, then 3 descent steps from the
           flat plane (inverse_render, normal smoothing, auto smooth
           weight, Adam_Modified with the border learning-rate scale).
           Every kernel launch of this phase is counted.

Then one JSON line of per-kernel numbers, the nvidia-smi line, and the
closing {"ok": true, ...} line.  Any failed check raises; nothing falls back
to the CPU.  With --profile, one more descent step runs under
torch.profiler and its kernel table goes to DIR/profile.txt.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# fp32 operations of one sign-safe Möller–Trumbore test (K1) and of one
# ray's gradient terms and face sums (K2; GN_OPS more with the shading-
# normal term), counted from the kernels' sources.
K1_OPS_PER_TEST = 48
K2_OPS_PER_RAY = 86
K2_GN_OPS_PER_RAY = 23

FLAGSHIP = dict(num_samples=20000, num_bins=1200, distance_resolution=1.2e-3,
                sigma_bin=1, bin_refine_resolution=10, source_chunk=64)
SCAN = 64
STEPS = 3
CARD = ""


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


def k1_bound(args, kwargs, occ):
    """(bound_ms, bound_by, mean candidate groups per block): the bytes of
    the inputs and outputs against the fp32 operations this run needs —
    every candidate face for each live unoccluded ray (occluded rays
    counted as one test), over the published peaks."""
    from nlos_surface_optimization_torch.render import fused_kernels as fk

    o, d, t_self, fid, contrib, bins, v, f, f_valid, Lc, Bf = args
    counts, _, nbs = fk.broad_phase(o, d, t_self, Lc, v, f, f_valid,
                                    ka_max=fk.KA_MAX)
    ng = -(-f.shape[0] // fk.GF)
    groups = torch.where(counts > fk.KA_MAX, ng, counts).double()
    R = o.shape[0]
    rs = R // Lc
    pad = nbs * fk.RB - rs
    live = t_self * (1.0 - kwargs["t_rel"]) > kwargs["t_min"]
    free = torch.nn.functional.pad((live & ~occ).reshape(Lc, rs), (0, pad))
    hit = torch.nn.functional.pad((live & occ).reshape(Lc, rs), (0, pad))
    per_block_free = free.reshape(Lc * nbs, fk.RB).sum(1).double()
    tests = float((per_block_free * groups * fk.GF).sum()) + float(hit.sum())
    ops_s = tests * K1_OPS_PER_TEST / FP32_OPS_PER_S
    moved = nbytes(o, d, t_self, fid, contrib, bins, v, f, f_valid) + R \
        + Lc * Bf * 4
    bytes_s = moved / HBM_BYTES_PER_S
    bound = max(ops_s, bytes_s) * 1e3
    return bound, "operations" if ops_s >= bytes_s else "bytes", \
        float(groups.mean())


def phase_k1(dev, chunk_inputs):
    from nlos_surface_optimization_torch.geometry.mesh import make_mesh
    from nlos_surface_optimization_torch.render import fused_kernels as fk

    v, f, _ = small_scene()
    rays = graze_rays(v, f, 3, 2, 384, seed=1)
    small = make_mesh(v, f, device=dev)
    args = tuple(torch.from_numpy(x).to(dev) for x in rays) + (
        small.v, small.f, small.f_valid, 3, 384)
    occ_s, _, err_s = check_k1(args, dict(t_rel=1e-4, t_min=1e-6))
    require(bool(occ_s.any()), "K1 small case: no ray is occluded")

    args, kwargs = chunk_inputs
    occ, _, err = check_k1(args, kwargs)
    ms = timed_ms(lambda: fk.occluded_splat(*args, **kwargs), 10)
    plain_ms = timed_ms(lambda: fk.occluded_splat_plain(*args, **kwargs), 2)
    o, d, t_self, fid, contrib, bins, v_, f_, fv, Lc, Bf = args
    broad_ms = timed_ms(lambda: fk.broad_phase(o, d, t_self, Lc, v_, f_, fv,
                                               ka_max=fk.KA_MAX), 10)
    counts, lists, nbs = fk.broad_phase(o, d, t_self, Lc, v_, f_, fv,
                                        ka_max=fk.KA_MAX)
    soup = fk.face_soup(v_, f_, fv, -(-f_.shape[0] // fk.GF))
    kernel_ms = timed_ms(lambda: fk.kernel_call(
        o, d, t_self, fid, contrib, bins, soup, counts, lists, nbs, Lc, Bf,
        **kwargs), 10)
    bound_ms, bound_by, groups = k1_bound(args, kwargs, occ)
    emit("k1", small_max_abs_err=err_s, max_abs_err=err, rays=o.shape[0],
         occluded=int(occ.sum()), mean_candidate_groups=groups, ms=ms,
         kernel_ms=kernel_ms, broad_phase_ms=broad_ms, plain_ms=plain_ms, bound_ms=bound_ms,
         bound_by=bound_by)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by), occ


# ------------------------------------------------------------------ K2


def phase_k2(dev, rays, mesh, lnormal, cfg, spt):
    from nlos_surface_optimization_torch.render import bwd_kernels as bk

    diff = torch.from_numpy((np.random.RandomState(3).randn(
        rays.h.shape[0], cfg.num_bins) * 1e-3).astype(np.float32)).to(dev)
    args = bk.face_sum_inputs(rays, lnormal, diff, 0, cfg, spt)
    sums = bk.backward_face_sums(*args)
    sums2 = bk.backward_face_sums(*args)
    sums_p = bk.backward_face_sums_plain(*args)
    torch.cuda.synchronize()
    require(torch.equal(sums, sums2), "K2: two launches differ")
    g = bk.vertex_gradient(sums, mesh)
    g_p = bk.vertex_gradient(sums_p, mesh)
    torch.testing.assert_close(g, g_p, rtol=2e-4,
                               atol=2e-5 * float(g_p.abs().max()))
    torch.testing.assert_close(sums, sums_p, rtol=2e-4,
                               atol=2e-5 * float(sums_p.abs().max()))
    err = float((sums - sums_p).abs().max())
    ms = timed_ms(lambda: bk.backward_face_sums(*args), 20)
    plain_ms = timed_ms(lambda: bk.backward_face_sums_plain(*args), 3)
    n_rays = rays.h.numel()
    use_gn = args[9]
    ops = n_rays * (K2_OPS_PER_RAY + (K2_GN_OPS_PER_RAY if use_gn else 0))
    moved = nbytes(*args[:8]) + sums.numel() * 4
    ops_s, bytes_s = ops / FP32_OPS_PER_S, moved / HBM_BYTES_PER_S
    bound_ms = max(ops_s, bytes_s) * 1e3
    bound_by = "operations" if ops_s >= bytes_s else "bytes"
    emit("k2", max_abs_err=err, grad_max_abs_err=float((g - g_p).abs().max()),
         rays=n_rays, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
         bound_by=bound_by)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


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
                "backward_face_sums": bk.backward_face_sums.launches}
    want = {"occluded_splat": chunks * (steps + 1),
            "backward_face_sums": chunks * steps}
    require(launches == want, f"launch counts {launches}, expected {want}")
    emit("slice", scan=f"{SCAN}x{SCAN}", faces=F, spt=spt, chunks=chunks,
         rays_per_pass=L * F * spt, launches=launches,
         step_seconds=per_step, gt_seconds=gt_s)
    if profile_dir:
        profile_step(descent, profile_dir)
    return launches


def profile_step(descent, out_dir):
    """One more descent step under torch.profiler -> DIR/profile.txt and a
    JSON line of device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        descent.step()
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=40)
    with open(os.path.join(out_dir, "profile.txt"), "w") as fh:
        fh.write(table)
    rows = sorted(prof.key_averages(),
                  key=lambda e: -getattr(e, "self_device_time_total", 0))
    top = [{"name": e.key[:80],
            "device_ms": getattr(e, "self_device_time_total", 0) / 1e3,
            "calls": e.count} for e in rows[:12]]
    emit("profile", top=top)


def run(dev, steps, profile_dir=None):
    """Every phase on device dev -> the per-kernel records."""
    import nlos_surface_optimization_torch as pt
    from nlos_surface_optimization_torch import _cuda
    from nlos_surface_optimization_torch.render import core

    seconds = _cuda.build_all()
    regs = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln]
            for n, log in _cuda.build_log.items()}
    emit("build", seconds=seconds, ptxas=regs)

    v, f, plane = flagship_scene()
    cfg = pt.RenderConfig(**FLAGSHIP)
    mesh = pt.make_mesh(v, f, device=dev)
    lighting, lnormal = pt.make_confocal_scan(SCAN)
    lc = torch.from_numpy(lighting[:cfg.source_chunk]).to(dev)
    nc = torch.from_numpy(lnormal[:cfg.source_chunk]).to(dev)
    spt = cfg.samples_per_face(f.shape[0])
    rays_pre, args, kwargs = core.splat_inputs(
        mesh, lc, nc, pt.key(0), cfg, spt, cfg.forward_refine)
    k1, occ = phase_k1(dev, (args, kwargs))
    rays = rays_pre._replace(valid=rays_pre.valid & ~occ.reshape(
        rays_pre.h.shape))
    k2 = phase_k2(dev, rays, mesh, nc, cfg, spt)
    phase_uniforms(dev, f.shape[0], spt)
    phase_small(dev)
    launches = phase_slice(dev, v, f, plane, steps, profile_dir)
    return [
        dict(name="occluded_splat", route="cuda",
             source="nlos_surface_optimization_torch/csrc/occluded_splat.cu",
             replaces="nlos_surface_optimization_tpu/render/"
                      "fused_kernels.py:122",
             launches=launches["occluded_splat"], library_ms=None, **k1),
        dict(name="backward_face_sums", route="cuda",
             source="nlos_surface_optimization_torch/csrc/"
                    "backward_face_sums.cu",
             replaces="nlos_surface_optimization_tpu/render/"
                      "bwd_kernels.py:59",
             launches=launches["backward_face_sums"], library_ms=None, **k2),
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
