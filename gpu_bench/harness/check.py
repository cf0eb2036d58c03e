"""Whether what the timed path produced is correct: its outputs at a
sample drawn from the seed, against the reference in float64.

The check follows the program one step from the program's own state
(the last updating step of the window).  The reference re-renders the
sampled transient rows of that step's mesh and the sampled GT rows from
the benchmark's own inputs.  It cannot re-render every row, so it
consumes these program-made inputs, each judged on its own where it is
consumed:

  the step's transient, every row   -> the loss and the gradient's
                                       difference rows (rows_gap)
  the GT transient, every row       -> the weights, the loss, the
                                       difference rows (gt_rows_gap)
  the step's data gradient          -> every vertex's update (grad_gap)
  the state before the step         -> the mesh, Adam's moments and
                                       step, the smooth weight, the lr
                                       and the loop's flags
  the last cull's mesh              -> the cull's intensities

Numbers compared (each a worst case over the sample):

  rows_gap     sum_b |T - T_ref| / max(sum_b |T_ref|, median row mass)
  gt_rows_gap  the same for the GT rows the set-up rendered
  grad_gap     |g - g_ref| / max(|g_ref|, median |g_ref|), per vertex
  loss_gap     |l2 - l2_ref| / |l2_ref|
  update_gap   max |u - u_ref| / max |u_ref|, over every vertex whose
               reference gradient (data + smoothing) is at least a
               thousandth of the median vertex's: Adam scales each
               vertex's step to about the learning rate whatever its
               gradient, so where the gradient is nought to rounding
               its direction is rounding's
  update_median_gap  the median over the same vertices of
               |u - u_ref| / |u_ref|: steady from seed to seed, where the
               worst case above is set by the few vertices of smallest
               gradient; a learning rate or smooth weight 1% off moves it
               to about 1e-2
  cull_gap     |I - I_ref| / max(I_ref, mean I_ref), per face
  v2_gap       |v2 - v2_ref| / v2_ref: the loop's mean distance of the
               step's vertices to the GT mesh

``control`` puts the reference computed in bfloat16 in the program's
place at the same sample (the readings script uses it).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from gpu_bench.reference import geometry as rgeo
from gpu_bench.reference import optim as ropt
from gpu_bench.reference import render as rr


def strata(n: int, k: int, rng) -> np.ndarray:
    """One index drawn from each of min(k, n) equal strata of range(n)."""
    k = min(k, n)
    edges = np.linspace(0, n, k + 1).astype(np.int64)
    return np.array([rng.randint(a, b) for a, b in zip(edges[:-1],
                                                       edges[1:])])


def optics(cfgd: dict, opt: dict) -> rr.Optics:
    alpha = opt.get("alpha")
    return rr.Optics(
        num_bins=int(cfgd["num_bins"]), res=float(cfgd["distance_resolution"]),
        lo=0.0, refine=int(cfgd["bin_refine_resolution"]),
        sigma_bin=int(cfgd["sigma_bin"]), normal=opt["normal"],
        gn=bool(opt["gn"]), brdf=opt["brdf"],
        alpha=float(np.float32(0.1 if alpha is None else alpha)))


def _gt_keyidx(spec, rows: np.ndarray, L: int) -> np.ndarray:
    if spec["keyidx"] == "global":
        return rows
    shards = np.array_split(np.arange(L), spec["keyidx"][1])
    start = np.empty(L, np.int64)
    for s in shards:
        start[s] = s[0]
    return rows - start[rows]


def _row_gap(cand, ref):
    mass = ref.abs().sum(1)
    floor = mass.median()
    return float(((cand - ref).abs().sum(1) / torch.clamp(
        torch.maximum(mass, floor), min=1e-300)).max())


def _vec_gap(cand, ref):
    n = ref.norm(dim=1)
    return float(((cand - ref).norm(dim=1) / torch.clamp(
        torch.maximum(n, n.median()), min=1e-300)).max())


class Reference:
    """The reference's answers at a sample of one check's inputs."""

    def __init__(self, inputs: dict, cfgd: dict, sample: dict, seed: int,
                 device, dtype=torch.float64):
        self.x, self.cfgd, self.dtype = inputs, cfgd, dtype
        self.dev = torch.device(device)
        st = inputs["step"]
        rng = np.random.RandomState(int(seed) % (1 << 32))
        L, V = st["lighting"].shape[0], st["v"].shape[0]
        self.rows = strata(L, int(sample["rows"]), rng)
        self.verts = strata(V, int(sample["vertices"]), rng)
        cull = inputs.get("cull")
        self.faces = (strata(cull["f"].shape[0], int(sample["faces"]), rng)
                      if cull is not None else None)
        self.opt = optics(cfgd, inputs["optics"])

    def _scene(self, v, f):
        st = self.x["step"]
        return rr.Scene(v, f, st["lighting"], st["lnormal"], st["key"],
                        self.dtype, self.dev)

    def rows_of(self):
        st = self.x["step"]
        sc = self._scene(st["v"], st["f"])
        return rr.transient_rows(sc, self.opt, self.rows, self.rows,
                                 st["spt"])

    def gt_rows(self):
        g = self.x["gt"]
        f = (rgeo.morton_order_faces(g["v"], g["f"]) if g.get("morton")
             else g["f"])
        opt = rr.Optics(**{**self.opt.__dict__, "normal": "fn", "gn": False,
                           "brdf": g["brdf"],
                           "alpha": float(np.float32(g["alpha"] or 0.1))})
        sc = self._scene(g["v"], f)
        L = self.x["step"]["lighting"].shape[0]
        return rr.transient_rows(sc, opt, self.rows,
                                 _gt_keyidx(g, self.rows, L), g["spt"])

    def gradient(self, diff):
        st = self.x["step"]
        sc = self._scene(st["v"], st["f"])
        return rr.vertex_gradient(sc, self.opt, self.verts, diff, st["spt"])

    def descent(self, g_data):
        """(l2, update [V, 3], gradient [V, 3]) of the step from the
        program's transient
        and data gradient: the loss with the smooth weight in effect, the
        auto smooth weight and learning rate where the step sets them,
        Adam_Modified from the optimizer state before the step."""
        st, dt, dev = self.x["step"], self.dtype, self.dev
        v = torch.as_tensor(np.asarray(st["v"], np.float64)).to(dev, dt)
        f = torch.as_tensor(np.asarray(st["f"], np.int64)).to(dev)
        gt = st["gt"].to(dev, dt)
        w = ropt.weighting(gt, st["gamma"])
        dl2 = ropt.data_l2(gt, w, st["T"].to(dev, dt))
        sval, sgrad = ropt.normal_smoothing(v, f, rgeo.face_affinity(st["f"]))
        l2 = dl2 + st["sw_before"] * sval
        sw, lr = st["sw_before"], st["lr"]
        if st["weight_flag"]:
            sw = float(dl2 / sval / st["smooth_ratio"]) if float(
                sval) > 1e-12 else 0.0
            if st["t"] > 0 and st["l2_first"]:
                lr = float(dl2 / st["l2_first"]) * st["lr0"] * (
                    0.99 ** (st["t"] / 15))
        border = rgeo.border_vertices(st["f"], v.shape[0])
        scale = torch.as_tensor(np.where(border, st["edge_lr_ratio"], 1.0)
                                * lr).to(dev, dt)
        o = st["opt"]
        grad = g_data.to(dev, dt) + sw * sgrad
        u, _, _ = ropt.adam_modified(grad, o.m.to(dev, dt), o.v.to(dev, dt),
                                     int(o.step), scale)
        return l2, u, grad

    def v2(self):
        """The mean distance of the step's vertices to the GT mesh."""
        g = self.x["v2"]
        dt, dev = self.dtype, self.dev
        pts = torch.as_tensor(np.asarray(self.x["step"]["v"], np.float64))
        v = torch.as_tensor(np.asarray(g["gt_v"], np.float64))
        f = torch.as_tensor(np.asarray(g["gt_f"], np.int64)).to(dev)
        return rgeo.point_mesh_distance(pts.to(dev, dt), v.to(dev, dt),
                                        f).mean()

    def intensity(self):
        c = self.x["cull"]
        sc = self._scene(c["v"], c["f"])
        return rr.face_intensity(sc, self.opt, self.faces, c["spt"])


def program_answers(x: dict, ref: Reference, device) -> dict:
    st = x["step"]
    out = dict(rows=st["T"][ref.rows], gt_rows=st["gt"][ref.rows],
               grad=st["g"][ref.verts], l2=st["l2"], update=st["update"])
    if x.get("cull") is not None:
        out["cull"] = x["cull"]["intensity"][ref.faces]
    if x.get("v2") is not None:
        out["v2"] = x["v2"]["value"]
    return {k: torch.as_tensor(a).to(device, torch.float64)
            for k, a in out.items()}


def _diff(st, dev, dt):
    gt = st["gt"].to(dev, dt)
    return ropt.weighting(gt, st["gamma"]) * (gt - st["T"].to(dev, dt))


def moving(grad, floor: float = 1e-3):
    """The vertices whose gradient is at least ``floor`` of the median
    vertex's."""
    n = grad.norm(dim=1)
    return n >= floor * n.median()


def _update_gap(a, b, keep):
    if not bool(keep.any()):   # no finite gradient to keep: fails
        return float("nan")
    return float((a - b).norm(dim=1)[keep].max() / b.norm(dim=1).max())


def _update_median_gap(a, b, keep):
    if not bool(keep.any()):
        return float("nan")
    n = b.norm(dim=1)
    return float(((a - b).norm(dim=1) / torch.clamp(n, min=1e-300))[
        keep].median())


def numbers(x: dict, cfgd: dict, sample: dict, seed: int, device,
            control: bool = False) -> dict:
    """{name: (program's number, control's number or None)}."""
    dev = torch.device(device)
    st = x["step"]
    ref = Reference(x, cfgd, sample, seed, dev)
    t0 = time.perf_counter()
    want = dict(rows=ref.rows_of())
    t1 = time.perf_counter()
    want["gt_rows"] = ref.gt_rows()
    t2 = time.perf_counter()
    want["grad"] = ref.gradient(_diff(st, dev, torch.float64))
    t3 = time.perf_counter()
    want["l2"], want["update"], grad = ref.descent(st["g"])
    keep = moving(grad)
    if x.get("cull") is not None:
        want["cull"] = ref.intensity()
    if x.get("v2") is not None:
        want["v2"] = ref.v2()
    print(f"reference seconds: rows {t1 - t0:.2f} gt rows {t2 - t1:.2f} "
          f"gradient {t3 - t2:.2f} rest {time.perf_counter() - t3:.2f}; "
          f"update: {int((~keep).sum())} of {keep.numel()} vertices "
          f"under a thousandth of the median gradient",
          file=sys.stderr, flush=True)
    cands = [program_answers(x, ref, dev)]
    if control:
        low = Reference(x, cfgd, sample, seed, dev, torch.bfloat16)
        c = dict(rows=low.rows_of(), gt_rows=low.gt_rows(),
                 grad=low.gradient(_diff(st, dev, torch.bfloat16)))
        c["l2"], c["update"], _ = low.descent(st["g"])
        if x.get("cull") is not None:
            c["cull"] = low.intensity()
        if x.get("v2") is not None:
            c["v2"] = low.v2()
        cands.append({k: torch.as_tensor(a).to(dev, torch.float64)
                      for k, a in c.items()})
    out = {}
    for name, key, fn in (
            ("rows_gap", "rows", _row_gap), ("gt_rows_gap", "gt_rows",
                                             _row_gap),
            ("grad_gap", "grad", _vec_gap),
            ("loss_gap", "l2", lambda a, b: float((a - b).abs()
                                                  / b.abs())),
            ("update_gap", "update", lambda a, b: _update_gap(a, b, keep)),
            ("update_median_gap", "update",
             lambda a, b: _update_median_gap(a, b, keep)),
            ("cull_gap", "cull", lambda a, b: float(
                ((a - b).abs() / torch.clamp(torch.maximum(
                    b.abs(), b.abs().mean()), min=1e-300)).max())),
            ("v2_gap", "v2", lambda a, b: float((a - b).abs() / b))):
        if key not in want:
            continue
        ref_v = want[key].to(torch.float64)
        vals = [fn(c[key], ref_v) for c in cands]
        out[name] = (vals[0], vals[1] if control else None)
    return out


def verdict(values: dict, limits: dict):
    """(correct, [(name, value, limit)]): every number within its limit;
    a number that is not finite, has no limit, or was not computed where
    the cell has a limit for it, fails."""
    rows, ok = [], True
    for name in limits:
        if name not in values:
            rows.append((name, float("nan"), limits[name]))
            ok = False
    for name, value in values.items():
        limit = limits.get(name)
        good = (limit is not None and np.isfinite(value)
                and value <= limit)
        ok &= bool(good)
        rows.append((name, value, limit))
    return ok, rows
