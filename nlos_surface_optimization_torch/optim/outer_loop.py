"""The inverse-rendering outer loop: plateau-driven phase machine with
remeshing, auto-tuned smoothness weight and coarse-to-fine schedules.

The JAX package's optim/outer_loop.py on the PyTorch renderer, with the
same split: the host holds ``v``, ``f``, ``old_v`` and the phase machine
as numpy; the device holds the render mesh, transients, gradients and the
Adam moments.

  per iteration: inverse render -> averaged vertex gradient; normal-
    smoothness value + gradient; auto smooth weight = original_l2 / sval /
    ratio and the lr rescale (original_l2/l2_first)*lr0*0.99^(t/15) after a
    phase switch; Adam_Modified with border vertices at lr*edge_lr_ratio
  plateau (run_count > 2, relative improvement < eps): toggle shading
    mode, or coarse-to-fine (remesh resolution x1.5, samples x1.5, eps/2)
  remesh: integrate old->new vertices (El Topo role), El Topo-role and
    isotropic remeshing to 0.5/resolution, cull faces that render_intensity
    (the standalone visibility kernel K3) finds invisible, drop unreferenced
    vertices, Morton-order the faces, fresh optimizer; forced every
    ``forced_remesh_every`` iterations; stop at the face budget
  checkpoint every iteration: the start-of-iteration snapshot, so that
    ``from_checkpoint`` re-executes that iteration exactly
"""

from __future__ import annotations

import collections
import dataclasses
import os
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..config import RenderConfig
from ..geometry.accel import morton_order_faces
from ..geometry.mesh import bucket_size, make_mesh, vertex_normals
from ..geometry.remesh import el_topo_remesh, integrate_vertices, isotropic_remesh
from ..geometry.sampling import fold_in, key_from_data
from ..geometry.topology import (
    border_vertices,
    face_affinity,
    remove_triangles,
    remove_unreferenced,
)
from ..io.mat import load_checkpoint, save_checkpoint
from ..render.api import inverse_render, render_intensity
from ..render.regularizers import normal_smoothing
from ..utils.metrics import compute_v2
from .adam_modified import AdamModifiedState, adam_modified
from .loss import create_weighting_function, evaluate_loss_with_normal_smoothness


@dataclasses.dataclass
class LoopConfig:
    lr0: float = 1e-4 / 3
    T: int = 500                     # max iterations
    smooth_ratio: float = 100.0      # auto-lambda divisor
    loss_epsilon: float = 1e-4       # plateau threshold
    edge_lr_ratio: float = 0.1       # border lr multiplier
    gamma: float = 1.0               # weighting exponent
    face_budget: int = 250_000       # stop when a remesh would start above
    forced_remesh_every: int = 15
    scan_resolution: int = 64        # drives the target edge 0.5/res
    checkpoint_dir: Optional[str] = None
    remesh_iterations: int = 3
    # v2 against the GT mesh every v2_every iterations and a checkpoint
    # every checkpoint_every iterations (1 and 1: the reference's cadence).
    # async_io writes checkpoints on one worker thread, in order, each file
    # atomic (.tmp + rename): at most two writes wait while one is in
    # flight, so a hard kill loses at most the last three checkpoints
    # (resume then restarts up to three iterations early).  If the worker
    # dies, it marks itself broken and every later write, the waiting ones
    # first, runs synchronously on the loop's thread.
    v2_every: int = 1
    checkpoint_every: int = 1
    async_io: bool = True
    # Common random numbers across iterations (the reference reuses one
    # sample pattern for the whole run); False re-samples every iteration
    # with the key folded with the iteration index.
    frozen_sampling: bool = True
    # pad (V, F) to geometric buckets (geometry.mesh.bucket_size); padded
    # faces are invalid and contribute exactly zero
    pad_shapes: bool = True


@dataclasses.dataclass
class LoopState:
    v: np.ndarray
    f: np.ndarray
    old_v: np.ndarray
    t: int = 0
    run_count: int = 0
    remesh_flag: bool = False
    weight_flag: bool = True
    testing_flag: int = 1
    smooth_weight: float = 1e-3
    lr: float = 1e-4 / 3
    loss_epsilon: float = 1e-4
    scan_resolution: float = 64.0
    sample_num: float = 20000.0
    smooth_ratio: float = 100.0
    l2_first: Optional[float] = None


class CheckpointWriter:
    """save_checkpoint on one FIFO worker thread: at most ``depth`` writes
    wait while one is in flight.  A write stays in the FIFO until it is on
    disk, so a worker that dies (a BaseException included) loses nothing:
    it marks the writer broken, and the loop's thread then writes what is
    left, and every later checkpoint, synchronously."""

    def __init__(self, log: Callable[[str], None], depth: int = 2):
        self.log = log
        self.depth = depth
        self.broken = False
        self._fifo = collections.deque()
        self._busy = False
        self._cv = threading.Condition()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        try:
            while True:
                with self._cv:
                    while not self._fifo:
                        self._cv.wait()
                    path, kw = self._fifo[0]
                    self._busy = True
                    self._cv.notify_all()    # one fewer write waiting
                try:
                    save_checkpoint(path, **kw)
                except Exception as e:  # never kill the run over IO
                    self.log(f"checkpoint write failed: {e!r}")
                with self._cv:
                    self._fifo.popleft()
                    self._busy = False
                    self._cv.notify_all()
        except BaseException as e:
            with self._cv:
                self.broken = True
                self._cv.notify_all()
            self.log(f"checkpoint writer stopped ({e!r}); writing "
                     "synchronously from now on")

    def _take_all(self):
        with self._cv:
            items = list(self._fifo)
            self._fifo.clear()
        return items

    def put(self, path: str, kw: dict):
        with self._cv:
            while (not self.broken
                   and len(self._fifo) - self._busy >= self.depth):
                self._cv.wait()
            if not self.broken:
                self._fifo.append((path, kw))
                self._cv.notify_all()
                return
        for p, k in self._take_all() + [(path, kw)]:
            save_checkpoint(p, **k)

    def flush(self):
        """Block until every queued write is on disk."""
        with self._cv:
            while self._fifo and not self.broken:
                self._cv.wait()
        for p, k in self._take_all():
            save_checkpoint(p, **k)


class InverseRenderingLoop:
    """Drives the vertex-position optimization of one scene on ``device``.

    ``stats`` collects one record per rendered iteration (``kind`` "step":
    seconds, faces, sources) and per remesh (``kind`` "remesh": seconds in
    geomlib, in render_intensity and in the rest; faces before and after
    culling), each with the render's spt, source chunks and rays per
    chunk."""

    def __init__(self, gt_transient, lighting, lighting_normal,
                 render_cfg: RenderConfig, loop_cfg: LoopConfig,
                 init_v: np.ndarray, init_f: np.ndarray, key: torch.Tensor,
                 gt_mesh=None, inverse_render_fn: Optional[Callable] = None,
                 log: Callable[[str], None] = print, device="cuda",
                 _resume: Optional[dict] = None):
        self.device = torch.device(device)

        # every array row-major: loadmat gives column-major ones, and the
        # rounding of a reduction on the card follows the layout
        def dev(x):
            return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
                self.device)

        self.gt = dev(gt_transient)
        self.lighting = dev(lighting)
        self.lnormal = dev(lighting_normal)
        self.rcfg = render_cfg
        self.cfg = loop_cfg
        self.key = key
        self.gt_mesh = gt_mesh
        self.log = log
        self.stats = []
        self._writer: Optional[CheckpointWriter] = None

        def _default_inverse(mesh, data, w, cfg, k):
            return inverse_render(mesh, data, w, self.lighting, self.lnormal,
                                  cfg, k)

        self._inverse = inverse_render_fn or _default_inverse

        if _resume is None:
            v, f = isotropic_remesh(init_v, init_f,
                                    0.5 / loop_cfg.scan_resolution,
                                    iterations=loop_cfg.remesh_iterations)
            f = morton_order_faces(v, f)
            self.state = LoopState(
                v=v, f=f, old_v=v.copy(), lr=loop_cfg.lr0,
                loss_epsilon=loop_cfg.loss_epsilon,
                scan_resolution=float(loop_cfg.scan_resolution),
                sample_num=float(render_cfg.num_samples),
                smooth_ratio=loop_cfg.smooth_ratio)
            self._rebuild_topology()
            self.weight = create_weighting_function(self.gt, loop_cfg.gamma)
            self._new_optimizer()
            self.history = {"l2": [], "l2_original": [], "v2": []}
        else:
            self._restore(_resume)

    def _restore(self, d: dict):
        """Rebuild the loop from a checkpoint dict (the start-of-iteration
        snapshot written by step()); the next step() re-executes the
        checkpointed iteration exactly."""
        def sc(name, cast=float):
            return cast(np.asarray(d[name]).ravel()[0])

        def rows(name, dtype=np.float32):
            return np.ascontiguousarray(np.asarray(d[name], dtype)
                                        .reshape(-1, 3))

        l2_first = sc("ls_l2_first")
        self.state = LoopState(
            v=rows("v"), f=rows("f", np.int32), old_v=rows("ls_old_v"),
            t=sc("iteration", int),
            run_count=sc("ls_run_count", int),
            remesh_flag=False,  # snapshots are taken on render iterations
            weight_flag=bool(sc("ls_weight_flag", int)),
            testing_flag=sc("ls_testing_flag", int),
            smooth_weight=sc("ls_smooth_weight"),
            lr=sc("ls_lr"),
            loss_epsilon=sc("ls_loss_epsilon"),
            scan_resolution=sc("ls_scan_resolution"),
            sample_num=sc("ls_sample_num"),
            smooth_ratio=sc("ls_smooth_ratio"),
            l2_first=None if np.isnan(l2_first) else l2_first,
        )
        self._rebuild_topology()
        self.weight = create_weighting_function(self.gt, self.cfg.gamma)

        self.opt_state = AdamModifiedState(
            step=sc("opt_step", int),
            m=torch.from_numpy(rows("opt_m")).to(self.device),
            v=torch.from_numpy(rows("opt_v")).to(self.device))
        self._opt_update = adam_modified(lr=1.0)[1]
        self.history = {
            k: list(np.asarray(d.get("hist_" + k, np.empty(0)),
                               np.float64).ravel())
            for k in ("l2", "l2_original", "v2")
        }

    @classmethod
    def from_checkpoint(cls, path: str, gt_transient, lighting,
                        lighting_normal, render_cfg: RenderConfig,
                        loop_cfg: LoopConfig, gt_mesh=None,
                        inverse_render_fn: Optional[Callable] = None,
                        log: Callable[[str], None] = print, device="cuda"
                        ) -> "InverseRenderingLoop":
        """Resume a killed run from a progress/%05d.mat checkpoint, written
        by this loop or by the JAX package's: the returned loop's next
        step() reproduces the checkpointed iteration (same key, phase
        machine and optimizer moments)."""
        d = load_checkpoint(path)
        return cls(gt_transient, lighting, lighting_normal, render_cfg,
                   loop_cfg, None, None, key_from_data(d["rng_key"]),
                   gt_mesh=gt_mesh, inverse_render_fn=inverse_render_fn,
                   log=log, device=device, _resume=d)

    # ---------------------------------------------------------------- setup

    def _rebuild_topology(self):
        s = self.state
        self.affinity = face_affinity(s.f)
        self.border = border_vertices(s.f, s.v.shape[0])
        self.lr_scale = np.where(self.border == 1, self.cfg.edge_lr_ratio,
                                 1.0).astype(np.float64)

    def _new_optimizer(self):
        init, self._opt_update = adam_modified(lr=1.0)  # lr folded below
        self.opt_state = init(torch.from_numpy(self.state.v).to(self.device))

    def _chunking(self, cfg: RenderConfig, faces: int, padded_faces: int):
        """spt, source chunks and rays per chunk of a render of the current
        mesh (the renderer's own arithmetic, render/api.py)."""
        L = self.lighting.shape[0]
        Lc = min(cfg.source_chunk or L, L)
        spt = cfg.samples_per_face(int(faces))
        return dict(spt=spt, chunks=-(-L // Lc),
                    chunk_rays=Lc * int(padded_faces) * spt)

    def _current_cfg(self) -> RenderConfig:
        s = self.state
        # cap the per-chunk ray count (Lc*F*spt) near 2M so that the ray
        # tensors of a chunk stay bounded as remeshes grow F
        F = max(int(s.f.shape[0]), 1)
        spt = 1 + (int(s.sample_num) - 1) // F
        cap = max(1, 2_000_000 // (F * spt))
        chunk = self.rcfg.source_chunk or self.lighting.shape[0]
        while chunk > cap:
            chunk //= 2
        return self.rcfg.replace(
            num_samples=int(s.sample_num),
            source_chunk=max(chunk, 1),
            normal="vn" if s.testing_flag == 0 else self.rcfg.normal,
            testing_flag=s.testing_flag,
        )

    # --------------------------------------------------------------- remesh

    def _remesh(self) -> bool:
        """Returns False when the face budget stops the run."""
        s = self.state
        if s.f.shape[0] > self.cfg.face_budget:
            return False
        self.log("remesh")
        t0 = time.perf_counter()
        s.v = integrate_vertices(s.old_v, s.f, s.v).astype(np.float32)
        target = 0.5 / s.scan_resolution
        # El Topo role first (merge approaching sheets, volume-capped ops),
        # then isotropic remeshing, the reference's order
        s.v, s.f, n_merges = el_topo_remesh(s.v, s.f, target, iterations=1)
        if n_merges:
            self.log(f"topology: {n_merges} sheet merge(s)")
        s.v, s.f = isotropic_remesh(s.v, s.f, target,
                                    iterations=self.cfg.remesh_iterations)
        t1 = time.perf_counter()
        # cull invisible triangles
        F0 = s.f.shape[0]
        mesh, cfgc = self._make_mesh(), self._current_cfg()
        inten = render_intensity(mesh, self.lighting, self.lnormal, cfgc,
                                 self.key)[:F0].cpu().numpy()
        t2 = time.perf_counter()
        keep = remove_triangles(s.f, face_affinity(s.f), inten)
        s.f = s.f[keep]
        s.v, s.f = remove_unreferenced(s.v, s.f)
        s.f = morton_order_faces(s.v, s.f)
        s.old_v = s.v.copy()
        self._rebuild_topology()
        self.weight = create_weighting_function(self.gt, self.cfg.gamma)
        self._new_optimizer()
        s.remesh_flag = False
        s.run_count = 0
        self.stats.append(dict(
            kind="remesh", iteration=s.t, geomlib_seconds=t1 - t0,
            intensity_seconds=t2 - t1,
            rest_seconds=time.perf_counter() - t2, faces_before=F0,
            faces_after=int(s.f.shape[0]), padded_faces=mesh.f.shape[0],
            **self._chunking(cfgc, F0, mesh.f.shape[0])))
        return True

    # ----------------------------------------------------------------- step

    def step(self) -> bool:
        """One outer iteration; returns False when the loop should stop."""
        s = self.state
        if s.remesh_flag and not self._remesh():
            return False

        # start-of-iteration snapshot for the resume checkpoint (the flag,
        # weight and lr updates below precede the checkpoint write)
        snap = {
            "old_v": s.old_v,
            "run_count": s.run_count,
            "weight_flag": int(s.weight_flag),
            "testing_flag": int(s.testing_flag),
            "smooth_weight": s.smooth_weight,
            "lr": s.lr,
            "loss_epsilon": s.loss_epsilon,
            "scan_resolution": s.scan_resolution,
            "sample_num": s.sample_num,
            "smooth_ratio": s.smooth_ratio,
            "l2_first": np.nan if s.l2_first is None else s.l2_first,
        }
        hist_snap = {k: list(vv) for k, vv in self.history.items()}

        tic = time.perf_counter()
        V = s.v.shape[0]
        cfgc = self._current_cfg()
        mesh = self._make_mesh(
            vn=self._vertex_normals() if cfgc.normal == "vn" else None)
        k = (self.key if self.cfg.frozen_sampling
             else fold_in(self.key, torch.tensor([s.t]))[0])
        transient, grad, _ = self._inverse(mesh, self.gt, self.weight, cfgc,
                                           k)
        grad = grad[:V]

        aff = self.affinity
        if mesh.f.shape[0] != aff.shape[0]:  # pad_shapes: -1 = no neighbour
            aff = np.pad(aff, ((0, mesh.f.shape[0] - aff.shape[0]), (0, 0)),
                         constant_values=-1)
        sval, sgrad = normal_smoothing(mesh.v, mesh.f, mesh.f_valid, aff)
        sval = float(sval)
        sgrad = sgrad[:V]

        l2, original_l2 = evaluate_loss_with_normal_smoothness(
            self.gt, self.weight, transient, sval, s.smooth_weight)
        l2 = float(l2)
        original_l2 = float(original_l2)

        if s.weight_flag:
            # a (near-)perfectly smooth surface needs no regularization:
            # dividing by sval ~ 0 would overflow the weight
            if sval > 1e-12:
                s.smooth_weight = original_l2 / sval / s.smooth_ratio
            else:
                s.smooth_weight = 0.0
            s.weight_flag = False
            self.log(f"new smooth weight {s.smooth_weight:f}")
            if s.t > 0 and s.l2_first:
                s.lr = (original_l2 / s.l2_first) * self.cfg.lr0 * (
                    0.99 ** (s.t / 15))
                self.log(f"new lr {s.lr:f}")
        if s.l2_first is None:
            s.l2_first = original_l2

        grad = grad + s.smooth_weight * sgrad

        v2 = np.nan
        if (self.gt_mesh is not None
                and s.t % max(self.cfg.v2_every, 1) == 0):
            v2 = float(compute_v2(torch.from_numpy(s.v), self.gt_mesh))
        seconds = time.perf_counter() - tic
        self.log(f"{s.t:05d} update time: {seconds:.3f} "
                 f"L2 loss: {l2:.8f} old_l2: {original_l2:.8f} v2: {v2:.8f}")
        self.stats.append(dict(
            kind="step", iteration=s.t, seconds=seconds,
            faces=int(s.f.shape[0]), sources=int(self.lighting.shape[0]),
            **self._chunking(cfgc, s.f.shape[0], mesh.f.shape[0])))
        h = self.history
        h["l2"].append(l2)
        h["l2_original"].append(original_l2)
        h["v2"].append(v2)

        if (self.cfg.checkpoint_dir
                and s.t % max(self.cfg.checkpoint_every, 1) == 0):
            os.makedirs(self.cfg.checkpoint_dir, exist_ok=True)
            self._write_checkpoint(
                os.path.join(self.cfg.checkpoint_dir, f"{s.t:05d}.mat"),
                dict(
                    v=s.v, f=s.f, iteration=s.t,
                    rng_key=self.key.cpu().numpy().astype(np.uint32),
                    opt_m=self.opt_state.m.cpu().numpy(),
                    opt_v=self.opt_state.v.cpu().numpy(),
                    opt_step=int(self.opt_state.step),
                    loop_state=snap, history=hist_snap,
                    extra={"transient": transient.cpu().numpy(),
                           "l2": l2,
                           "l2_original": original_l2,
                           "grad": grad.cpu().numpy(),
                           "smoothing_grad": sgrad.cpu().numpy(),
                           "sample_num": s.sample_num},
                ))

        s.run_count += 1
        s.t += 1

        # plateau machine
        if s.run_count > 2 and len(h["l2"]) >= 2:
            rel_o = (h["l2_original"][-2] - original_l2) / h["l2_original"][-2]
            rel = (h["l2"][-2] - l2) / h["l2"][-2]
            if rel_o < s.loss_epsilon or rel < s.loss_epsilon:
                if s.testing_flag == 1:
                    s.testing_flag = 0
                    s.smooth_ratio = 10 + s.t / 100
                    self.log("shading based")
                else:
                    s.testing_flag = 1
                    s.scan_resolution *= 1.5
                    s.sample_num *= 1.5
                    s.loss_epsilon /= 2
                    s.smooth_ratio = self.cfg.smooth_ratio + s.t / 10
                    self.log(f"remesh {s.scan_resolution:.0f}")
                s.remesh_flag = True
                s.weight_flag = True
                return True

        # Adam_Modified step with the per-vertex (border) lr scale
        updates, self.opt_state = self._opt_update(
            grad, self.opt_state, lr_scale=self.lr_scale * s.lr)
        s.v = (s.v + updates.cpu().numpy()).astype(np.float32)

        if s.run_count == self.cfg.forced_remesh_every:
            s.remesh_flag = True
        return True

    # ------------------------------------------------------------- async IO

    def _write_checkpoint(self, path: str, kw: dict):
        """save_checkpoint, on the writer thread when cfg.async_io."""
        if not self.cfg.async_io:
            save_checkpoint(path, **kw)
            return
        if self._writer is None:
            self._writer = CheckpointWriter(self.log)
        self._writer.put(path, kw)

    def flush_io(self):
        """Block until queued checkpoint writes are on disk."""
        if self._writer is not None:
            self._writer.flush()

    def _make_mesh(self, vn=None):
        """Mesh for rendering, shape-bucketed when cfg.pad_shapes."""
        s = self.state
        if not self.cfg.pad_shapes:
            return make_mesh(s.v, s.f, vn=vn, device=self.device)
        return make_mesh(s.v, s.f, vn=vn, pad_v=bucket_size(s.v.shape[0]),
                         pad_f=bucket_size(s.f.shape[0]), device=self.device)

    def _vertex_normals(self):
        s = self.state
        m = make_mesh(s.v, s.f, device=self.device)
        return vertex_normals(m.v, m.f, m.f_valid).cpu().numpy()

    def run(self, max_iters: Optional[int] = None):
        n = max_iters if max_iters is not None else self.cfg.T
        try:
            while self.state.t < n:
                if not self.step():
                    break
        finally:
            self.flush_io()
        return self.state, self.history
