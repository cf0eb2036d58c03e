"""The check catches a broken timed path.  Each test skips the harness's
look for a card and drives the rest of a run on the CPU, at a size a
test can hold, with the program broken underneath, and sees ``correct``
come out false: a step that returns its state unchanged, half of the
sources left out (the mean taken over the rest), an answer altered where
it is produced.  (No cell runs on more than one card, so none can leave
out an exchange between cards.)  The sound run of each cell comes out
true under the same limits."""

import copy
import json
import os
import sys
import time
import types

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

from gpu_bench.harness import main, spec  # noqa: E402
from nlos_surface_optimization_torch.optim import adam_modified as adam  # noqa: E402
from nlos_surface_optimization_torch.optim import outer_loop  # noqa: E402
from nlos_surface_optimization_torch.render import api  # noqa: E402

SEED = 2 ** 31 + 77
REAL_ADAM = adam.adam_modified


def _cell(workload):
    return spec.resolve(workload)


def tiny(workload):
    """The cell at a size a CPU test holds: a 6x6 (loop: 8x8) scan, 2,000
    samples, a 10x10 height field; the cell's own limits."""
    cell = _cell(workload)
    c, t = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    c.update(scan_resolution=6, sample_num=2000, gt_sample_num=4000,
             source_chunk=8)
    if t["kind"] == "descent":
        t["surface"]["n"] = 10
        t.update(warm_steps=1, check={"rows": 8, "vertices": 8, "faces": 0})
    else:
        # every third step plateaus, so the warm-up (as the cell's does)
        # and a short window remesh and cull, however slow the host
        c.update(scan_resolution=8, loss_epsilon=1.0)
        t["surface"]["n"] = 8
        t.update(warm_steps=4, check={"rows": 8, "vertices": 8, "faces": 8})
    cell.config, cell.traffic = c, t
    return cell


def run_tiny(workload, capsys, seconds=2.0):
    cell = tiny(workload)
    args = types.SimpleNamespace(workload=workload, seed=SEED,
                                 seconds=seconds, trace=0)
    torch.manual_seed(0)
    rc = main._run(args, cell, torch.device("cpu"), time.perf_counter())
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def unchanged(monkeypatch):
    def broken(lr, *a, **kw):
        init, update = REAL_ADAM(lr, *a, **kw)

        def no_step(grads, state, lr_scale=None):
            _, new = update(grads, state, lr_scale=lr_scale)
            return torch.zeros_like(grads), new
        return init, no_step
    monkeypatch.setattr(adam, "adam_modified", broken)
    monkeypatch.setattr(outer_loop, "adam_modified", broken)


def half_batch(monkeypatch):
    """The first half of the sources rendered, the gradient their mean."""
    real = api.inverse_render

    def half(mesh, data, weight, lighting, lnormal, cfg, key, alpha=None):
        h = lighting.shape[0] // 2
        t, g, p = real(mesh, data[:h], weight[:h], lighting[:h],
                       lnormal[:h], cfg, key, alpha)
        return torch.cat([t, torch.zeros_like(t)])[:lighting.shape[0]], g, p
    monkeypatch.setattr(api, "inverse_render", half)


def altered_answer(monkeypatch):
    """Each chunk's transient rows one bin late, as an off-by-one in the
    binning would leave them."""
    real = api.smooth_and_coarsen

    def altered(fine, *a, **kw):
        return torch.roll(real(fine, *a, **kw), 1, dims=1)
    monkeypatch.setattr(api, "smooth_and_coarsen", altered)


def altered_v2(monkeypatch):
    """The loop's distance to the GT mesh read 2% long."""
    real = outer_loop.compute_v2
    monkeypatch.setattr(outer_loop, "compute_v2",
                        lambda v, gt_mesh: real(v, gt_mesh) * 1.02)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered_answer": altered_answer}
with open(os.path.join(ROOT, "BENCHMARK.json")) as _fh:
    CELLS = [w["name"] for w in json.load(_fh)["workloads"]]


def _seconds(workload):
    return 8.0 if "loop" in workload else 2.0


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload, capsys):
    out = run_tiny(workload, capsys, _seconds(workload))
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_broken_path_is_not_correct(workload, fault, monkeypatch, capsys):
    FAULTS[fault](monkeypatch)
    out = run_tiny(workload, capsys, _seconds(workload))
    assert not out["correct"], out["compared"]


def test_altered_v2_is_not_correct(monkeypatch, capsys):
    altered_v2(monkeypatch)
    out = run_tiny("lambertian64-loop-episode", capsys, 8.0)
    assert not out["correct"], out["compared"]
    assert out["compared"]["v2_gap"]["value"] > 0.01


def test_descent_takes_its_shading_from_the_traffic(capsys):
    """A descent mix that asks for vertex-normal shading with the
    normal-derivative term renders so, and the check follows it."""
    from gpu_bench.harness import check
    from gpu_bench.harness.recorder import Recorder

    cell = tiny("lambertian64-descent-23k")
    cell.traffic.update(normal="vn", testing_flag=0)
    d = spec.driver(cell.config, cell.traffic, SEED, "cpu")
    d.setup()
    d.step(Recorder())
    x = d.check_inputs()
    assert x["optics"]["normal"] == "vn" and x["optics"]["gn"]
    assert d.cfg.normal == "vn" and d.cfg.testing_flag == 0
    nums = check.numbers(x, cell.config, cell.traffic["check"], SEED, "cpu")
    ok, rows = check.verdict({k: v[0] for k, v in nums.items()},
                             cell.limits)
    assert ok, rows


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limits(workload):
    """The control, the reference in bfloat16 in the program's place,
    fails the cell's limits on three seeds."""
    from gpu_bench import readings
    from gpu_bench.harness import check

    cell = tiny(workload)
    for seed in (11, 2 ** 31 + 3, 909):
        nums = readings.read_seed(cell, seed, 1, "cpu")["numbers"]
        control = {k: v[1] for k, v in nums.items()}
        program = {k: v[0] for k, v in nums.items() if k in cell.limits}
        assert not check.verdict(control, cell.limits)[0], control
        assert all(program[k] <= cell.limits[k] for k in program), program
