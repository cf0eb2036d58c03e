"""Two-process torch.distributed runs of the port's sharding (gloo on the
CPU; parallel/multihost.py): each process joins a group at a localhost
address and renders 2 local CPU shards of a 4-shard source mesh.

  - the transient equals the port's single-process 4-shard render bit for
    bit on every rank, the gradient within f32 order, and both agree with
    JAX's 4-device sharded_inverse_render (test_torch_sharding.py's
    tolerances, JAX at XLA's optimization level 0);
  - create_gt(dmesh=...) with a directory per rank (no shared
    filesystem): the coordinator's list of missing shards reaches every
    rank, so a shard already on the coordinator's disk is rendered by no
    rank, and only the coordinator writes.

The workers import only the port.  Each run has a time limit; a worker
that times out or exits nonzero fails the test."""

import json
import os
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import scipy.io
import torch

import nlos_surface_optimization_tpu as nst
from nlos_surface_optimization_tpu.geometry import mesh as jmesh
from nlos_surface_optimization_tpu.parallel import shard as jshard

import nlos_surface_optimization_torch as pt
from nlos_surface_optimization_torch.experiments import create_gt
from nlos_surface_optimization_torch.parallel import (
    make_source_mesh,
    sharded_inverse_render,
    sharded_render_transient,
)

from test_torch_sharding import SELF_ATOL, jax_o0  # noqa: F401

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIME_LIMIT = 120   # seconds for a whole two-process run
KEY = 3

COMMON = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
import nlos_surface_optimization_torch as pt
from nlos_surface_optimization_torch.parallel import multihost
rank = int(os.environ["RANK_IDX"])
multihost.initialize(os.environ["COORD"], 2, rank, backend="gloo")
dmesh = multihost.global_source_mesh(["cpu", "cpu"])
inp = np.load(os.environ["INPUTS"])
"""

RENDER = COMMON + r"""
from nlos_surface_optimization_torch.parallel import (
    sharded_inverse_render, sharded_render_transient)
mesh = pt.make_mesh(inp["v"], inp["f"], device="cpu")
cfg = pt.RenderConfig(num_samples=900, num_bins=180,
                      distance_resolution=7e-3)
lighting, lnormal = pt.make_confocal_scan(4)
t, g = sharded_inverse_render(mesh, inp["data"], inp["weight"], lighting,
                              lnormal, cfg, pt.key(3), dmesh)
raw = sharded_render_transient(mesh, lighting, lnormal, cfg, pt.key(3),
                               dmesh, refine=1)
np.savez(os.path.join(os.environ["OUT"], f"rank{rank}.npz"), t=t.numpy(),
         g=g.numpy(), raw=raw.numpy(),
         summary=json.dumps(multihost.scaling_summary(dmesh)),
         coordinator=multihost.is_coordinator())
dist.destroy_process_group()
"""

GT = COMMON + r"""
import sys
from nlos_surface_optimization_torch.experiments import SceneSpec, create_gt
cg = sys.modules["nlos_surface_optimization_torch.experiments.create_gt"]
renders = []
render = cg.sharded_render_transient


def counted(mesh, lighting, *a, **kw):
    renders.append(len(lighting))
    return render(mesh, lighting, *a, **kw)


cg.sharded_render_transient = counted
spec = SceneSpec("tiny", num_bins=240, distance_resolution=5e-3,
                 gt_sample_num=2000, gt_scan_resolution=8)
out_dir = os.path.join(os.environ["OUT"], f"rank{rank}")
files = create_gt(spec, inp["v"], inp["f"], out_dir, num_shards=4,
                  key=pt.key(5), dmesh=dmesh)
with open(os.path.join(os.environ["OUT"], f"rank{rank}.json"), "w") as fh:
    json.dump({"renders": renders,
               "files": [os.path.basename(p) for p in files],
               "on_disk": sorted(os.listdir(out_dir))
               if os.path.isdir(out_dir) else None}, fh)
dist.destroy_process_group()
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_two(script, inputs, out):
    """Run ``script`` in two processes (ranks 0 and 1) within TIME_LIMIT."""
    env = dict(os.environ, COORD=f"127.0.0.1:{_free_port()}",
               INPUTS=str(inputs), OUT=str(out),
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    procs = [subprocess.Popen([sys.executable, "-c", script],
                              env=dict(env, RANK_IDX=str(r)), cwd=ROOT,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(2)]
    deadline = time.monotonic() + TIME_LIMIT
    logs = []
    try:
        for p in procs:
            left = max(1.0, deadline - time.monotonic())
            logs.append(p.communicate(timeout=left)[0].decode(
                errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        pytest.fail(f"the two workers took more than {TIME_LIMIT} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"


def test_two_processes_match_one(tmp_path, bumpy_mesh, jax_o0):
    v, f = bumpy_mesh
    cfg = pt.RenderConfig(num_samples=900, num_bins=180,
                          distance_resolution=7e-3)
    lighting, lnormal = pt.make_confocal_scan(4)
    mesh = pt.make_mesh(v, f, device="cpu")
    t0, _ = pt.render_transient(mesh, lighting, lnormal, cfg, pt.key(KEY),
                                refine=1)
    rng = np.random.RandomState(0)
    data = (t0.numpy() * (1 + 0.2 * rng.rand(*t0.shape))).astype(np.float32)
    weight = (0.5 + rng.rand(*data.shape)).astype(np.float32)
    np.savez(tmp_path / "in.npz", v=v, f=f, data=data, weight=weight)
    _run_two(RENDER, tmp_path / "in.npz", tmp_path)
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]

    one = make_source_mesh(["cpu"] * 4)
    t1, g1 = sharded_inverse_render(mesh, data, weight, lighting, lnormal,
                                    cfg, pt.key(KEY), one)
    raw1 = sharded_render_transient(mesh, lighting, lnormal, cfg,
                                    pt.key(KEY), one, refine=1)
    t_j, g_j = jax_o0.sharded_inverse_render(
        jmesh.make_mesh(v, f), data, weight, lighting, lnormal,
        nst.RenderConfig(num_samples=900, num_bins=180,
                         distance_resolution=7e-3),
        jax.random.key(KEY), jshard.make_source_mesh(jax.devices()[:4]))
    scale = float(g1.abs().max())
    for r, out in enumerate(got):
        np.testing.assert_array_equal(out["t"], t1.numpy())
        np.testing.assert_array_equal(out["raw"], raw1.numpy())
        np.testing.assert_array_equal(out["raw"], t0.numpy())
        np.testing.assert_allclose(out["g"], g1.numpy(), rtol=0,
                                   atol=SELF_ATOL * scale)
        np.testing.assert_allclose(out["t"], np.asarray(t_j), rtol=2e-5,
                                   atol=1e-8)
        np.testing.assert_allclose(out["g"], np.asarray(g_j), rtol=2e-4,
                                   atol=1e-7)
        assert json.loads(str(out["summary"])) == {
            "processes": 2, "process_index": r, "global_devices": 4,
            "local_devices": 2, "axis": "sources"}
        assert bool(out["coordinator"]) == (r == 0)
    np.testing.assert_array_equal(got[0]["g"], got[1]["g"])


def _tiny_gt_mesh(n=8):
    """tests/test_sharded_gt.py's GT mesh."""
    xs = np.linspace(-0.25, 0.25, n)
    gx, gy = np.meshgrid(xs, xs)
    z = 0.5 + 0.05 * np.sin(5 * gx)
    v = np.stack([gx.ravel(), gy.ravel(), z.ravel()], 1).astype(np.float32)
    f = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            f += [[a, a + n, a + 1], [a + n, a + n + 1, a + 1]]
    return v, np.array(f, np.int32)


def test_create_gt_two_processes(tmp_path):
    """Shard 2 already on the coordinator's disk (a marker file): no rank
    renders it, rank 1 writes nothing, and the coordinator's other shards
    equal the single-process create_gt's."""
    from nlos_surface_optimization_torch.experiments import SceneSpec

    v, f = _tiny_gt_mesh()
    spec = SceneSpec("tiny", num_bins=240, distance_resolution=5e-3,
                     gt_sample_num=2000, gt_scan_resolution=8)
    os.makedirs(tmp_path / "rank0")
    marker = tmp_path / "rank0" / "tiny_transient_8_2.mat"
    scipy.io.savemat(marker, {"gt_transient": np.zeros((1, 1))})
    np.savez(tmp_path / "in.npz", v=v, f=f)
    _run_two(GT, tmp_path / "in.npz", tmp_path)
    reports = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(2)]

    names = [f"tiny_transient_8_{i}.mat" for i in range(4)]
    for rep in reports:
        assert rep["renders"] == [16, 16, 16]   # shards 0, 1 and 3
        assert rep["files"] == names
    assert reports[0]["on_disk"] == names
    assert reports[1]["on_disk"] is None
    assert scipy.io.loadmat(marker)["gt_transient"].shape == (1, 1)

    want = create_gt(spec, v, f, str(tmp_path / "one"), num_shards=4,
                     key=pt.key(5), device="cpu")
    for i in (0, 1, 3):
        a = scipy.io.loadmat(tmp_path / "rank0" / names[i])
        b = scipy.io.loadmat(want[i])
        for k in ("gt_transient", "gt_v", "gt_f", "lighting", "bin_width"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
