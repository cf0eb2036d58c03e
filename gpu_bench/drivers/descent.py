"""Traffic kind ``descent``: a closed loop of fixed-topology descent
iterations from the flat plane toward the GT transient of a height
field: inverse render, normal smoothing, the loss, the auto smooth
weight, Adam_Modified (as the outer loop steps between remeshes).

Traffic keys: ``surface`` (n, extent, z0, amplitude, noise: the height
field), ``chunk_ray_cap`` (rays a source chunk may hold), ``warm_steps``,
``trace_steps``, ``check`` (the sample sizes), and optionally ``normal``
('fn' or 'vn') and ``testing_flag`` (0 adds the normal-derivative term
in 'vn' shading), the shading the descent renders with.

The timed path renders through ``api.inverse_render`` (``ENTRY``, which
the fault tests replace); ``tiny`` is the cell at a size a CPU test
holds, and ``FAULTS`` the faults that its tests plant.
"""

from __future__ import annotations

import time

import numpy as np
import torch

import nlos_surface_optimization_torch as pt
from nlos_surface_optimization_torch.geometry import topology
from nlos_surface_optimization_torch.geometry.mesh import vertex_normals
from nlos_surface_optimization_torch.optim import adam_modified as adam
from nlos_surface_optimization_torch.optim import loss as lossmod
from nlos_surface_optimization_torch.render import api
from nlos_surface_optimization_torch.render import regularizers

from gpu_bench.harness import scene
from gpu_bench.harness.recorder import Recorder, render_shape, shading, sync

ENTRY = (api, "inverse_render")
FAULTS = ("unchanged", "half_batch", "altered_answer")
TEST_SECONDS = 2.0   # a CPU test's window


def tiny(config: dict, traffic: dict):
    """(config, traffic) at a size a CPU test holds: a 6x6 scan, 2,000
    samples, a 10x10 height field, one warm-up step, 8 rows and
    vertices checked."""
    c = dict(config, scan_resolution=6, sample_num=2000, gt_sample_num=4000,
             source_chunk=8)
    t = dict(traffic, surface=dict(traffic["surface"], n=10), warm_steps=1,
             check={"rows": 8, "vertices": 8, "faces": 0})
    return c, t


def render_config(c: dict, t: dict, faces: int, samples: int, cap: int):
    """The deployment's render settings at ``samples``, the source chunk
    halved while a chunk holds more than ``cap`` rays, the traffic's
    shading."""
    chunk = scene.source_chunk(int(c["source_chunk"]), faces, samples, cap)
    return pt.RenderConfig(
        num_samples=int(samples), num_bins=int(c["num_bins"]),
        distance_resolution=float(c["distance_resolution"]),
        sigma_bin=int(c["sigma_bin"]),
        bin_refine_resolution=int(c["bin_refine_resolution"]),
        source_chunk=chunk, brdf=c["brdf"],
        normal=t.get("normal", "fn"),
        testing_flag=int(t.get("testing_flag", 1)))


def gt_chunk(c: dict, faces: int, samples: int, cap: int) -> int:
    """The GT render's chunk: the sources whose rays stay under ``cap``."""
    spt = 1 + (samples - 1) // max(faces, 1)
    return max(1, min(int(c["source_chunk"]), cap // max(faces * spt, 1)))


class Driver:
    """Fixed-topology descent on the first of the cell's ``devices``."""

    def __init__(self, config: dict, traffic: dict, seed: int, devices):
        self.c, self.tr, self.seed = config, traffic, int(seed)
        self.devices = [torch.device(d) for d in devices]
        self.dev = self.devices[0]
        self.last = None

    def render_gt(self, gt_mesh, cfg_gt):
        """The GT transient, unsmoothed (refine 1)."""
        gt, _ = api.render_transient(gt_mesh, self.lighting, self.lnormal,
                                     cfg_gt, self.key, refine=1,
                                     alpha=self.c.get("gt_alpha"))
        return gt

    def inverse(self, m):
        """(transient, vertex gradient) of the mesh ``m``."""
        tr, g, _ = api.inverse_render(m, self.gt, self.weight, self.lighting,
                                      self.lnormal, self.cfg, self.key,
                                      alpha=self.c.get("alpha"))
        return tr, g

    def render_shapes(self, m):
        """The sizes the kernels of one ``inverse`` call see."""
        return [render_shape("inverse", m, self.cfg, self.lighting.shape[0],
                             m.f.shape[0])]

    def setup(self):
        c, t, dev = self.c, self.tr, self.dev
        t0 = time.perf_counter()
        s = t["surface"]
        v_gt, f, plane = scene.height_field(
            s["n"], s["extent"], s["z0"], s["amplitude"], s["noise"],
            self.seed)
        lit, ln = scene.confocal_scan(c["scan_resolution"], c["scan_lower"],
                                      c["scan_upper"])
        F, cap = f.shape[0], int(t["chunk_ray_cap"])
        self.cfg = render_config(c, t, F, c["sample_num"], cap)
        # the GT renders with face normals, as create_gt does
        cfg_gt = self.cfg.replace(
            num_samples=int(c["gt_sample_num"]), normal="fn", testing_flag=1,
            source_chunk=gt_chunk(c, F, c["gt_sample_num"], cap))
        self.key = scene.key(self.seed)
        self.lighting = torch.from_numpy(lit).to(dev)
        self.lnormal = torch.from_numpy(ln).to(dev)
        gt_mesh = pt.make_mesh(v_gt, f, device=dev)
        self.gt = self.render_gt(gt_mesh, cfg_gt).contiguous()
        t1 = time.perf_counter()
        self.weight = lossmod.create_weighting_function(self.gt,
                                                        float(c["gamma"]))
        self.gt_inputs = dict(v=v_gt, f=f, spt=cfg_gt.samples_per_face(F),
                              keyidx="global", brdf=c["brdf"],
                              alpha=c.get("gt_alpha"))
        self.scan = (lit, ln)
        self.f = f
        self.mesh = pt.make_mesh(plane, f, device=dev)
        self.affinity = torch.from_numpy(
            topology.face_affinity(f).astype(np.int64)).to(dev)
        border = topology.border_vertices(f, plane.shape[0])
        self.lr = float(c["lr0"])
        self.lr_scale = torch.from_numpy(np.where(
            border == 1, float(c["edge_lr_ratio"]), 1.0).astype(
                np.float32)).to(dev) * self.lr
        init, self._update = adam.adam_modified(lr=1.0)
        self.opt = init(self.mesh.v)
        self.sw, self.first, self.t = 1e-3, True, 0
        self.paths = 2.0 * lit.shape[0] * F * self.cfg.samples_per_face(F)
        warm = Recorder()
        for _ in range(int(t["warm_steps"])):
            self.step(warm)
        sync(self.devices)
        self.setup_phases = [("gt", t1 - t0),
                             ("warm", time.perf_counter() - t1)]

    def step(self, rec: Recorder):
        t0 = time.perf_counter()
        m = self.mesh
        if self.cfg.normal == "vn":
            m = m._replace(vn=vertex_normals(m.v, m.f, m.f_valid))
        before = dict(v=m.v, opt=self.opt, sw_before=self.sw,
                      weight_flag=self.first, lr=self.lr, t=self.t,
                      l2_first=None)
        if rec.shapes:
            rec.renders.extend(self.render_shapes(m))
        tr, g = self.inverse(m)
        if rec.sync:
            sync(self.devices)
        t_r = time.perf_counter()
        rec.span("inverse_render", t0, t_r)
        sval, sgrad = regularizers.normal_smoothing(m.v, m.f, m.f_valid,
                                                    self.affinity)
        l2, data_l2 = lossmod.evaluate_loss_with_normal_smoothness(
            self.gt, self.weight, tr, sval, self.sw)
        if self.first:
            sv = float(sval)
            self.sw = (float(data_l2) / sv / float(self.c["smooth_ratio"])
                       if sv > 1e-12 else 0.0)
            self.first = False
        upd, self.opt = self._update(g + self.sw * sgrad, self.opt,
                                     lr_scale=self.lr_scale)
        self.mesh = self.mesh._replace(v=m.v + upd)
        l2f, dl2f = float(l2), float(data_l2)
        t1 = time.perf_counter()
        rec.span("update", t_r, t1)
        self.t += 1
        self.last = dict(before, T=tr, g=g, update=upd, l2=l2f, data_l2=dl2f)
        rec.iterations.append(dict(seconds=t1 - t0, paths=self.paths,
                                   ok=bool(np.isfinite(l2f)), kind="step",
                                   render_s=t_r - t0, remesh_s=0.0))

    def begin_segment(self):
        """Nothing to do before a traced segment: every step is alike."""

    def release(self):
        """Drop the program's state but what the check reads."""
        self.mesh = self.opt = self.affinity = None

    def check_inputs(self) -> dict:
        c, last = self.c, self.last
        lit, ln = self.scan
        return dict(
            optics=dict(shading(self.cfg), alpha=c.get("alpha")),
            step=dict(last, v=last["v"].cpu().numpy(), f=self.f,
                      spt=self.cfg.samples_per_face(self.f.shape[0]),
                      lighting=lit, lnormal=ln, key=self.key.numpy(),
                      gt=self.gt, smooth_ratio=float(c["smooth_ratio"]),
                      lr0=float(c["lr0"]), edge_lr_ratio=float(
                          c["edge_lr_ratio"]), gamma=float(c["gamma"])),
            gt=self.gt_inputs, cull=None, v2=None)
