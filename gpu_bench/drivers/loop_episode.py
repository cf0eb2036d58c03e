"""Traffic kind ``loop_episode``: episodes of the outer loop
(``InverseRenderingLoop.step``) from the LCT init of a GT made as the
experiment runner makes it.  Each episode restarts from the state the
loop's constructor built in set-up, so its isotropic remesh of the init
is paid once, and the work of a window does not grow with speed.

Traffic keys: ``surface`` (n, z0, amplitude: the runner's stand-in
height field), ``gt_shards`` (create_gt's shards), ``lct_threshold``
(of the LCT albedo's peak, for the init mesh), ``steps_per_episode``,
``warm_steps`` (at most; the warm-up ends with the first remesh),
``trace_steps``, ``check`` (the sample sizes).

The timed path renders through ``api.inverse_render`` (``ENTRY``, which
the fault tests replace); ``tiny`` is the cell at a size a CPU test
holds, and ``FAULTS`` the faults that its tests plant.
"""

from __future__ import annotations

import copy
import shutil
import tempfile
import time

import numpy as np
import torch

import nlos_surface_optimization_torch as pt
from nlos_surface_optimization_torch.experiments.create_gt import create_gt
from nlos_surface_optimization_torch.experiments.scenes import SceneSpec
from nlos_surface_optimization_torch.io import mat as matio
from nlos_surface_optimization_torch.optim import outer_loop
from nlos_surface_optimization_torch.recon import lct
from nlos_surface_optimization_torch.render import api

from gpu_bench.harness import scene
from gpu_bench.harness.recorder import Recorder, render_shape, shading, sync

ENTRY = (api, "inverse_render")
FAULTS = ("unchanged", "half_batch", "altered_answer")
TEST_SECONDS = 8.0   # a CPU test's window: it holds a remesh


def tiny(config: dict, traffic: dict):
    """(config, traffic) at a size a CPU test holds: an 8x8 scan, 2,000
    samples, an 8x8 stand-in surface, 8 rows, vertices and faces
    checked.  Every third step plateaus, so the warm-up (as the cell's
    does) and a short window remesh and cull, however slow the host."""
    c = dict(config, scan_resolution=8, sample_num=2000, gt_sample_num=4000,
             source_chunk=8, loss_epsilon=1.0)
    t = dict(traffic, surface=dict(traffic["surface"], n=8), warm_steps=4,
             check={"rows": 8, "vertices": 8, "faces": 8})
    return c, t


def fallback_surface(s: dict, lower, upper):
    """The experiment runner's stand-in for an absent GT mesh: an n x n
    height field z0 + amplitude*sin(6x)cos(5y) over the scan."""
    xs = np.linspace(lower[0], upper[0], s["n"])
    gx, gy = np.meshgrid(xs, xs)
    z = s["z0"] + s["amplitude"] * np.sin(6 * gx) * np.cos(5 * gy)
    v = np.stack([gx.ravel(), gy.ravel(), z.ravel()], 1).astype(np.float32)
    return v, scene.grid_faces(s["n"])


class Probes:
    """Every place where the benchmark reaches past the loop's public
    API, installed and removed together:

    - ``outer_loop.adam_modified`` wrapped: keeps each update the loop's
      optimizer returns (the applied v + u cannot give u back to f32
      precision), for the check;
    - ``outer_loop.render_intensity`` wrapped: times the cull and keeps
      its intensities, for the check and ``cull_ms``'s span;
    - ``loop._remesh`` wrapped: the remesh's host span, which names the
      trace's idle gaps;
    - ``restart``: puts the constructor's state back and calls the
      loop's ``_rebuild_topology``, so that an episode restarts without
      the constructor's remesh.

    The loop's public ``inverse_render_fn`` hook holds the render span.
    """

    def __init__(self, driver):
        self.d = driver
        self._adam = self._intensity = None
        self.update = None

    def install(self):
        self._adam = outer_loop.adam_modified
        self._intensity = outer_loop.render_intensity
        outer_loop.adam_modified = self._adam_probe
        outer_loop.render_intensity = self._cull

    def attach(self, loop):
        real = loop._remesh

        def remesh():
            t0 = time.perf_counter()
            try:
                return real()
            finally:
                self.d.rec.span("remesh", t0, time.perf_counter())
        loop._remesh = remesh

    def remove(self):
        if self._adam is not None:
            outer_loop.adam_modified = self._adam
            outer_loop.render_intensity = self._intensity
            self._adam = self._intensity = None

    @staticmethod
    def restart(loop, state0, opt0):
        loop.state = copy.deepcopy(state0)
        loop.opt_state = opt0
        loop.history = {"l2": [], "l2_original": [], "v2": []}
        loop._rebuild_topology()

    def _adam_probe(self, lr, *args, **kw):
        init, update = self._adam(lr, *args, **kw)

        def probed(grads, state, lr_scale=None):
            out = update(grads, state, lr_scale=lr_scale)
            self.update = out[0]
            return out
        return init, probed

    def _cull(self, mesh, lighting, lnormal, cfg, key):
        d = self.d
        rec, s = d.rec, d.loop.state
        t0 = time.perf_counter()
        if rec.shapes:
            rec.renders.append(render_shape(
                "intensity", mesh, cfg, lighting.shape[0], s.f.shape[0]))
        out = self._intensity(mesh, lighting, lnormal, cfg, key)
        if rec.sync:
            sync(d.devices)
        rec.span("cull", t0, time.perf_counter())
        d.last_cull = dict(mesh=mesh, Fv=s.f.shape[0], V=s.v.shape[0],
                           cfg=cfg, intensity=out)
        return out


class Driver:
    """Episodes of ``steps_per_episode`` outer-loop steps on the first of
    the cell's ``devices``."""

    def __init__(self, config: dict, traffic: dict, seed: int, devices):
        self.c, self.tr, self.seed = config, traffic, int(seed)
        self.devices = [torch.device(d) for d in devices]
        self.dev = self.devices[0]
        self.last = self.last_cull = None
        self.rec = Recorder()
        self.probes = Probes(self)
        self.loop = None

    def setup(self):
        c, t, dev = self.c, self.tr, self.dev
        clock = [("start", time.perf_counter())]
        res = int(c["scan_resolution"])
        lower, upper = tuple(c["scan_lower"]), tuple(c["scan_upper"])
        spec = SceneSpec(
            c["scene"], scan_lower=lower, scan_upper=upper,
            scan_resolution=res, num_bins=int(c["num_bins"]),
            distance_resolution=float(c["distance_resolution"]),
            sample_num=int(c["sample_num"]),
            gt_sample_num=int(c["gt_sample_num"]), gamma=float(c["gamma"]),
            smooth_ratio=float(c["smooth_ratio"]),
            edge_lr_ratio=float(c["edge_lr_ratio"]),
            loss_epsilon=float(c["loss_epsilon"]), lr0=float(c["lr0"]),
            brdf=c["brdf"])
        gt_v, gt_f = fallback_surface(t["surface"], lower, upper)
        self.key = scene.key(self.seed)
        # the GT's shard files go to a directory of this run's own, under
        # TMPDIR, and are gone once read
        work = tempfile.mkdtemp(prefix="gpu_bench_gt_")
        try:
            files = create_gt(
                spec, gt_v, gt_f, work, num_shards=int(t["gt_shards"]),
                resolution=res, sample_num=int(c["gt_sample_num"]),
                key=self.key, device=dev)
            gt = matio.load_transient_shards(files)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        clock.append(("gt", time.perf_counter()))
        lit, ln = scene.confocal_scan(res, lower, upper)
        self.scan = (lit, ln)
        self.cfg = pt.RenderConfig(
            num_samples=int(c["sample_num"]), num_bins=int(c["num_bins"]),
            distance_resolution=float(c["distance_resolution"]),
            brdf=c["brdf"], source_chunk=min(int(c["source_chunk"]),
                                             res * res))
        width = float((lit[:, 0].max() - lit[:, 0].min()) / 2)
        rec = lct.lct_reconstruct(gt, width=width,
                                  bin_resolution_m=spec.distance_resolution,
                                  device=dev)
        v0, f0 = lct.init_mesh_from_lct(
            rec, threshold=float(rec.albedo.max()) * float(t["lct_threshold"]))
        clock.append(("lct", time.perf_counter()))
        loop_cfg = outer_loop.LoopConfig(
            lr0=spec.lr0, smooth_ratio=spec.smooth_ratio,
            loss_epsilon=spec.loss_epsilon, edge_lr_ratio=spec.edge_lr_ratio,
            gamma=spec.gamma, scan_resolution=res, checkpoint_dir=None)
        self.probes.install()
        self.loop = outer_loop.InverseRenderingLoop(
            gt, lit, ln, self.cfg, loop_cfg, v0, f0, self.key,
            gt_mesh=pt.make_mesh(gt_v, gt_f, device=dev),
            inverse_render_fn=self._render, log=lambda msg: None,
            device=dev)
        self.probes.attach(self.loop)
        self.gt = self.loop.gt
        self.gt_inputs = dict(
            v=gt_v, f=gt_f, morton=True,
            spt=1 + (int(c["gt_sample_num"]) - 1) // gt_f.shape[0],
            keyidx=("shards", int(t["gt_shards"])), brdf=c["brdf"],
            alpha=c.get("gt_alpha"))
        self.state0 = copy.deepcopy(self.loop.state)
        self.opt0 = self.loop.opt_state
        self.k = 0
        clock.append(("loop", time.perf_counter()))
        # warm-up ends with the first remesh and cull: from there on every
        # kind of call the window makes has run once
        warm = Recorder()
        for _ in range(int(t["warm_steps"])):
            self.step(warm)
            if warm.iterations[-1]["kind"] == "remesh":
                break
        self._restart()
        clock.append((f"warm({len(warm.iterations)} steps)",
                      time.perf_counter()))
        self.setup_phases = [(n, b - a) for (_, a), (n, b)
                             in zip(clock, clock[1:])]

    def _restart(self):
        Probes.restart(self.loop, self.state0, self.opt0)
        self.k = 0

    def _render(self, mesh, data, w, cfg, k):
        rec, s = self.rec, self.loop.state
        t0 = time.perf_counter()
        if rec.shapes:
            rec.renders.append(render_shape(
                "inverse", mesh, cfg, data.shape[0], s.f.shape[0]))
        tr, g, pl = api.inverse_render(mesh, data, w, self.loop.lighting,
                                       self.loop.lnormal, cfg, k)
        if rec.sync:
            sync(self.devices)
        rec.span("inverse_render", t0, time.perf_counter())
        self._pending = dict(
            mesh=mesh, V=s.v.shape[0], Fv=s.f.shape[0], cfg=cfg,
            v_obj=s.v, opt=self.loop.opt_state, sw_before=s.smooth_weight,
            weight_flag=s.weight_flag, lr_before=s.lr, l2_first=s.l2_first,
            t=s.t, smooth_ratio=s.smooth_ratio, T=tr, g=g)
        return tr, g, pl

    def step(self, rec: Recorder):
        if self.k == int(self.tr["steps_per_episode"]):
            self._restart()
        self.rec, lp = rec, self.loop
        n_stats, n_spans = len(lp.stats), len(rec.spans)
        self._pending = None
        t0 = time.perf_counter()
        going = lp.step()
        t1 = time.perf_counter()
        spans = rec.spans[n_spans:]
        rec.span("step", t0, t1)
        self.k += 1
        new = lp.stats[n_stats:]
        del lp.stats[:]
        steps = [s for s in new if s["kind"] == "step"]
        remesh = [s for s in new if s["kind"] == "remesh"]
        paths = sum(2.0 * s["sources"] * s["faces"] * s["spt"] for s in steps)
        l2 = lp.history["l2"][-1] if steps else float("nan")
        rec.iterations.append(dict(
            seconds=t1 - t0, paths=paths, ok=bool(np.isfinite(l2)),
            kind="remesh" if remesh else "step",
            render_s=sum(b - a for n, a, b in spans if n == "inverse_render"),
            remesh_s=sum(r["geomlib_seconds"] + r["intensity_seconds"]
                         + r["rest_seconds"] for r in remesh),
            remeshes=remesh))
        p = self._pending
        if p is not None and lp.state.v is not p["v_obj"]:
            self.last = dict(p, update=self.probes.update[:p["V"]],
                             l2=lp.history["l2"][-1],
                             data_l2=lp.history["l2_original"][-1],
                             v2=lp.history["v2"][-1])
        if not going:
            self.k = int(self.tr["steps_per_episode"])

    def begin_segment(self):
        """A traced segment starts an episode, so that it holds the
        episode's first remesh and cull."""
        self._restart()

    def release(self):
        self.probes.remove()
        self.loop = None

    def check_inputs(self) -> dict:
        c, p = self.c, self.last
        lit, ln = self.scan
        m, V, Fv = p["mesh"], p["V"], p["Fv"]
        cfg = p["cfg"]
        out = dict(
            optics=dict(shading(cfg), alpha=c.get("alpha")),
            step=dict(
                v=m.v[:V].cpu().numpy(), f=m.f[:Fv].cpu().numpy(),
                spt=cfg.samples_per_face(Fv), lighting=lit, lnormal=ln,
                key=self.key.numpy(), gt=self.gt, T=p["T"],
                g=p["g"][:V], opt=p["opt"], sw_before=p["sw_before"],
                weight_flag=p["weight_flag"], lr=p["lr_before"],
                l2_first=p["l2_first"], t=p["t"],
                smooth_ratio=p["smooth_ratio"], lr0=float(c["lr0"]),
                edge_lr_ratio=float(c["edge_lr_ratio"]),
                gamma=float(c["gamma"]), update=p["update"],
                l2=p["l2"], data_l2=p["data_l2"]),
            gt=self.gt_inputs, cull=None,
            v2=(dict(value=p["v2"], gt_v=self.gt_inputs["v"],
                     gt_f=self.gt_inputs["f"])
                if np.isfinite(p["v2"]) else None))
        q = self.last_cull
        if q is not None:
            qm, Fq = q["mesh"], q["Fv"]
            out["cull"] = dict(v=qm.v[:q["V"]].cpu().numpy(),
                               f=qm.f[:Fq].cpu().numpy(),
                               spt=q["cfg"].samples_per_face(Fq),
                               intensity=q["intensity"][:Fq])
        return out
