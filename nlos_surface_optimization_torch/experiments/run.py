"""End-to-end experiment runner:

  1. load or create the GT transients (synthetic scenes), or load a
     measured capture (real scenes)
  2. LCT reconstruction -> init mesh
  3. the plateau-driven outer loop

    python -m nlos_surface_optimization_torch.experiments.run armadillo \\
        --workdir DIR --res 16 --iters 20

runs on CUDA (``--device cpu`` for the plain PyTorch versions of the
kernels).  The ``ggx`` scene renders its GT at the scene's roughness
(0.2) and optimizes the shape with the loop's default roughness 0.1, as
the JAX package does.  Scenes with SPAD noise raise NotImplementedError
until that module is ported.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np
import scipy.io

from ..config import RenderConfig, make_confocal_scan
from ..geometry.mesh import make_mesh
from ..geometry.sampling import key as make_key
from ..io.mat import load_real_capture, load_transient_shards
from ..io.obj import read_obj
from ..optim.outer_loop import InverseRenderingLoop, LoopConfig
from ..recon.lct import init_mesh_from_lct, lct_reconstruct
from ..render.api import render_transient
from .create_gt import create_gt
from .scenes import SCENES, SceneSpec, mesh_dir


def _check_ported(spec: SceneSpec) -> None:
    if spec.spad_noise:
        raise NotImplementedError(
            f"scene {spec.name!r} needs the SPAD noise model (noise/spad.py), "
            "not ported yet (ROADMAP queue 1, item 11)")


def _load_gt_mesh(spec: SceneSpec, meshes: Optional[str]):
    d = meshes or mesh_dir()
    if spec.mesh_file and d:
        p = os.path.join(d, spec.mesh_file)
        if os.path.exists(p):
            return read_obj(p)
    # synthetic fallback: a height field stands in for the missing asset
    n = 32
    xs = np.linspace(spec.scan_lower[0], spec.scan_upper[0], n)
    gx, gy = np.meshgrid(xs, xs)
    z = 0.5 + 0.06 * np.sin(6 * gx) * np.cos(5 * gy)
    v = np.stack([gx.ravel(), gy.ravel(), z.ravel()], 1).astype(np.float32)
    f = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            f.append([a, a + n, a + 1])
            f.append([a + n, a + n + 1, a + 1])
    return v, np.array(f, np.int32)


def _find_capture(spec: SceneSpec, workdir: str,
                  transient_path: Optional[str]) -> str:
    """A real scene's measured transient.mat: the explicit path, then the
    workdir, then $NLOS_DATA_DIR/<scene>/ (and the reference's layouts)."""
    fname = spec.transient_file or "transient.mat"
    cands = [transient_path, os.path.join(workdir, fname)]
    data_dir = os.environ.get("NLOS_DATA_DIR")
    if data_dir:
        cands.append(os.path.join(data_dir, spec.name, fname))
        cands.append(os.path.join(data_dir, "exp_" + spec.name, fname))
        cands.append(os.path.join(
            data_dir, "transient_rendering_cython", "exp_" + spec.name,
            fname))
    for p in cands:
        if p and os.path.exists(p):
            return p
    raise FileNotFoundError(
        f"no measured transient for scene '{spec.name}'; looked at "
        f"{[c for c in cands if c]} (set NLOS_DATA_DIR or pass "
        f"transient_path)")


def _find_jitter_calibration(workdir: str):
    """(jitters_s, counts) of the SPAD's temporal jitter: the measured
    jitter.mat (t_1 seconds, counts_1) in the workdir or
    $NLOS_DATA_DIR/noise/, else a synthetic histogram of the measured
    one's envelope: 901 samples over [-84 ps, 650 ps], a 25 ps Gaussian
    core and a 150 ps diffusion tail, ~3.57e6 counts in all."""
    cands = [os.path.join(workdir, "jitter.mat")]
    data_dir = os.environ.get("NLOS_DATA_DIR")
    if data_dir:
        cands.append(os.path.join(data_dir, "noise", "jitter.mat"))
    for p in cands:
        if os.path.exists(p):
            m = scipy.io.loadmat(p)
            return (np.asarray(m["t_1"]).ravel(),
                    np.asarray(m["counts_1"]).ravel())
    t = np.linspace(-84e-12, 650e-12, 901)
    core = np.exp(-0.5 * (t / 25e-12) ** 2)
    tail = 0.02 * np.exp(-np.maximum(t, 0.0) / 150e-12)
    counts = core + tail
    counts *= 3.57e6 / counts.sum()
    return t, counts


def _width(lighting) -> float:
    return float((lighting[:, 0].max() - lighting[:, 0].min()) / 2)


def run_real_experiment(spec: SceneSpec, workdir: str,
                        max_iters: Optional[int],
                        scan_resolution: Optional[int],
                        sample_num: Optional[int],
                        transient_path: Optional[str],
                        key, log, resume: bool = False, device="cuda"):
    """Measured-capture pipeline: load transient.mat, LCT-init from the
    data (or the capture's own thresholded init mesh), fit the closed-form
    global albedo, optimize with no GT mesh (no v2).

    scan_resolution (dividing the capture's N) downsamples the scan."""
    path = _find_capture(spec, workdir, transient_path)
    n_full = spec.scan_resolution
    down = 1
    if scan_resolution and scan_resolution < n_full:
        assert n_full % scan_resolution == 0, (
            f"scan_resolution {scan_resolution} must divide {n_full}")
        down = n_full // scan_resolution
    gt, lighting, res = load_real_capture(path, downsample=down)
    log(f"loaded capture {path}: {res}x{res} scan, B={gt.shape[1]}")

    if lighting is None:
        lighting, lnormal = make_confocal_scan(
            res, lower=spec.scan_lower, upper=spec.scan_upper)
    else:
        lnormal = np.tile(np.array([0.0, 0.0, 1.0], np.float32),
                          (lighting.shape[0], 1))

    cfg = RenderConfig(num_samples=sample_num or spec.sample_num,
                       num_bins=gt.shape[1],
                       distance_resolution=spec.distance_resolution,
                       brdf=spec.brdf, source_chunk=min(256, res * res))

    init_obj = os.path.join(os.path.dirname(path),
                            f"cnlos_{spec.name}_threshold.obj")
    if os.path.exists(init_obj):
        log(f"init mesh from {init_obj}")
        v0, f0 = read_obj(init_obj)
    else:
        log("LCT initialization from measured data")
        lct = lct_reconstruct(gt, width=_width(lighting),
                              bin_resolution_m=spec.distance_resolution,
                              device=device)
        thr = float(lct.albedo.max()) * 0.25
        v0, f0 = init_mesh_from_lct(lct, threshold=thr)
    log(f"init mesh: V={v0.shape[0]} F={f0.shape[0]}")

    # Radiometric alignment: a capture is in photon counts, the renderer
    # in form-factor units.  Fit the closed-form global albedo
    # sum(gt*T)/sum(T^2) to the init render and fold it into the data.
    cfg_fit = cfg.replace(num_samples=max(2000, cfg.num_samples // 10))
    t_init, _ = render_transient(make_mesh(v0, f0, device=device), lighting,
                                 lnormal, cfg_fit, key)
    t_init = t_init.cpu().numpy().astype(np.float64)
    denom = float((t_init * t_init).sum())
    albedo_star = float((gt * t_init).sum()) / max(denom, 1e-30)
    if albedo_star > 0:
        log(f"closed-form albedo fit: {albedo_star:.4g} "
            "(folded into data scale)")
        gt = gt / albedo_star

    loop_cfg = _loop_config(spec, res, workdir)
    loop = _make_or_resume_loop(gt, lighting, lnormal, cfg, loop_cfg,
                                v0, f0, key, None, log, resume, device)
    return loop.run(max_iters=max_iters)


def _loop_config(spec: SceneSpec, res: int, workdir: str) -> LoopConfig:
    """Per-scene outer-loop config (lr0 is per scene)."""
    kw = {}
    if spec.lr0 is not None:
        kw["lr0"] = spec.lr0
    return LoopConfig(smooth_ratio=spec.smooth_ratio,
                      loss_epsilon=spec.loss_epsilon,
                      edge_lr_ratio=spec.edge_lr_ratio, gamma=spec.gamma,
                      scan_resolution=res,
                      checkpoint_dir=os.path.join(workdir, "progress"), **kw)


def run_experiment(scene: str, workdir: str,
                   max_iters: Optional[int] = None,
                   scan_resolution: Optional[int] = None,
                   sample_num: Optional[int] = None,
                   gt_sample_num: Optional[int] = None,
                   meshes: Optional[str] = None,
                   transient_path: Optional[str] = None,
                   resume: bool = False,
                   key=None, log=print, device="cuda"):
    """Run one scene end to end on ``device``; returns (state, history)."""
    spec = SCENES[scene]
    _check_ported(spec)
    key = make_key(0) if key is None else key
    res = scan_resolution or spec.scan_resolution
    os.makedirs(workdir, exist_ok=True)

    if spec.kind == "real":
        return run_real_experiment(spec, workdir, max_iters,
                                   scan_resolution, sample_num,
                                   transient_path, key, log, resume=resume,
                                   device=device)

    gt_v, gt_f = _load_gt_mesh(spec, meshes)
    gt_mesh = make_mesh(gt_v, gt_f, device=device)

    shard_glob = os.path.join(workdir, "setup",
                              f"{spec.name}_transient_{res}_*.mat")
    files = sorted(glob.glob(shard_glob),
                   key=lambda p: int(p.rsplit("_", 1)[1].split(".")[0]))
    if files:
        gt = load_transient_shards(files)
        if gt.shape[0] != res * res:  # partial shards from a crashed run
            log(f"discarding incomplete GT ({gt.shape[0]}/{res * res} rows)")
            files = []
    if not files:
        log(f"creating GT transients for {scene} at {res}x{res}")
        files = create_gt(
            spec, gt_v, gt_f, os.path.join(workdir, "setup"),
            num_shards=16 if res >= 256 else 8, resolution=res,
            sample_num=gt_sample_num or min(spec.gt_sample_num, 200_000),
            key=key, device=device)
        gt = load_transient_shards(files)

    cfg = RenderConfig(num_samples=sample_num or spec.sample_num,
                       num_bins=spec.num_bins,
                       distance_resolution=spec.distance_resolution,
                       brdf=spec.brdf, source_chunk=min(256, res * res))
    lighting, lnormal = make_confocal_scan(res, lower=spec.scan_lower,
                                           upper=spec.scan_upper)

    log("LCT initialization")
    lct = lct_reconstruct(gt, width=_width(lighting),
                          bin_resolution_m=spec.distance_resolution,
                          device=device)
    thr = float(lct.albedo.max()) * 0.25
    v0, f0 = init_mesh_from_lct(lct, threshold=thr)
    log(f"init mesh: V={v0.shape[0]} F={f0.shape[0]}")

    loop_cfg = _loop_config(spec, res, workdir)
    loop = _make_or_resume_loop(gt, lighting, lnormal, cfg, loop_cfg, v0, f0,
                                key, gt_mesh, log, resume, device)
    return loop.run(max_iters=max_iters)


def _make_or_resume_loop(gt, lighting, lnormal, cfg, loop_cfg, v0, f0, key,
                         gt_mesh, log, resume: bool, device="cuda"):
    """A fresh loop, or, when ``resume`` and progress checkpoints exist, a
    loop restored from the latest one."""
    if resume and loop_cfg.checkpoint_dir:
        ckpts = sorted(glob.glob(
            os.path.join(loop_cfg.checkpoint_dir, "[0-9]*.mat")))
        if ckpts:
            log(f"resuming from {ckpts[-1]}")
            return InverseRenderingLoop.from_checkpoint(
                ckpts[-1], gt, lighting, lnormal, cfg, loop_cfg,
                gt_mesh=gt_mesh, log=log, device=device)
    return InverseRenderingLoop(gt, lighting, lnormal, cfg, loop_cfg, v0, f0,
                                key, gt_mesh=gt_mesh, log=log, device=device)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="NLOS surface optimization")
    ap.add_argument("scene", choices=sorted(SCENES))
    ap.add_argument("--workdir", default="./runs")
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--res", type=int, default=None)
    ap.add_argument("--samples", type=int, default=None)
    ap.add_argument("--meshes", default=None,
                    help="directory with GT *_centered.obj assets")
    ap.add_argument("--transient", default=None,
                    help="measured transient.mat (real scenes)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest progress checkpoint")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run_experiment(args.scene, os.path.join(args.workdir, args.scene),
                   max_iters=args.iters, scan_resolution=args.res,
                   sample_num=args.samples, meshes=args.meshes,
                   transient_path=args.transient, resume=args.resume,
                   device=args.device)


if __name__ == "__main__":
    main()
