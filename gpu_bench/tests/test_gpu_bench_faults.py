"""The check catches a broken timed path.  Each test skips the harness's
look for a card and drives the rest of a run on the CPU, at the size its
traffic kind states (``tiny`` in gpu_bench/drivers/<kind>.py), with the
program broken underneath, and sees ``correct`` come out false: a step
that returns its state unchanged, half of the sources left out (the mean
taken over the rest) at the kind's own entry point, an answer altered
where it is produced, and on a sharded kind the exchange between shards
left out.  The sound run of each cell comes out true under the same
limits.

Besides the cells of BENCHMARK.json, the tests run one cell built in
memory: the Lambertian descent's configuration and limits under the
``descent_sharded`` kind on 4 cards, one shard a card (``['cpu'] * 4``
here, ``[cuda:0] * 4`` in the card test)."""

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
from nlos_surface_optimization_torch.parallel import shard  # noqa: E402
from nlos_surface_optimization_torch.render import api  # noqa: E402

SEED = 2 ** 31 + 77
REAL_ADAM = adam.adam_modified
SHARDED = "lambertian64-descent-23k.sharded4"


def _cell(workload):
    """A cell of BENCHMARK.json, or SHARDED: the Lambertian descent's
    configuration, traffic and limits under the sharded kind on 4 cards,
    one shard a card."""
    if workload != SHARDED:
        return spec.resolve(workload)
    cell = spec.resolve("lambertian64-descent-23k")
    cell.name, cell.chips = SHARDED, 4
    cell.traffic = dict(cell.traffic, kind="descent_sharded")
    return cell


def tiny(workload):
    """The cell at the size its kind states for a CPU test; the cell's own
    limits."""
    cell = _cell(workload)
    cell.config, cell.traffic = spec.kind(cell.traffic).tiny(
        copy.deepcopy(cell.config), copy.deepcopy(cell.traffic))
    return cell


def run_tiny(workload, capsys):
    cell = tiny(workload)
    args = types.SimpleNamespace(workload=workload, seed=SEED,
                                 seconds=spec.kind(cell.traffic).TEST_SECONDS,
                                 trace=0)
    torch.manual_seed(0)
    rc = main._run(args, cell, main.cell_devices(cell.chips, "cpu"),
                   time.perf_counter())
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def unchanged(monkeypatch, kind):
    def broken(lr, *a, **kw):
        init, update = REAL_ADAM(lr, *a, **kw)

        def no_step(grads, state, lr_scale=None):
            _, new = update(grads, state, lr_scale=lr_scale)
            return torch.zeros_like(grads), new
        return init, no_step
    monkeypatch.setattr(adam, "adam_modified", broken)
    monkeypatch.setattr(outer_loop, "adam_modified", broken)


def half_batch(monkeypatch, kind):
    """The first half of the sources rendered at the kind's entry point,
    the gradient their mean."""
    module, name = kind.ENTRY
    real = getattr(module, name)

    def half(mesh, data, weight, lighting, lnormal, *rest, **kw):
        h = lighting.shape[0] // 2
        t, *out = real(mesh, data[:h], weight[:h], lighting[:h],
                       lnormal[:h], *rest, **kw)
        return (torch.cat([t, torch.zeros_like(t)])[:lighting.shape[0]],
                *out)
    monkeypatch.setattr(module, name, half)


def altered_answer(monkeypatch, kind):
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


def exchange_left_out(monkeypatch, kind):
    """The last shard's partial gradient and transient rows left out of
    the exchange between shards (its rows read as zeros)."""
    reduce, gather = shard._reduce, shard._gather_rows
    monkeypatch.setattr(shard, "_reduce",
                        lambda parts, dmesh: reduce(parts[:-1], dmesh))
    monkeypatch.setattr(shard, "_gather_rows", lambda parts, dmesh, L: gather(
        parts[:-1] + [torch.zeros_like(parts[-1])], dmesh, L))


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered_answer": altered_answer,
          "exchange_left_out": exchange_left_out}
with open(os.path.join(ROOT, "BENCHMARK.json")) as _fh:
    CELLS = [w["name"] for w in json.load(_fh)["workloads"]] + [SHARDED]
CASES = [(w, f) for w in CELLS
         for f in sorted(spec.kind(_cell(w).traffic).FAULTS)]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload, capsys):
    out = run_tiny(workload, capsys)
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("workload,fault", CASES)
def test_broken_path_is_not_correct(workload, fault, monkeypatch, capsys):
    FAULTS[fault](monkeypatch, spec.kind(_cell(workload).traffic))
    out = run_tiny(workload, capsys)
    assert not out["correct"], out["compared"]


def test_a_state_gone_to_nan_is_not_correct(monkeypatch, capsys):
    """A step whose gradient comes back NaN (as launches on the wrong card
    left it over two real cards) leaves every vertex out of the update
    gaps: the run still prints its result, not correct."""
    module, name = spec.kind(_cell(SHARDED).traffic).ENTRY
    real = getattr(module, name)

    def nan(*a, **kw):
        t, g = real(*a, **kw)
        return t, torch.full_like(g, float("nan"))
    monkeypatch.setattr(module, name, nan)
    out = run_tiny(SHARDED, capsys)
    assert not out["correct"]
    assert out["compared"]["update_gap"]["value"] != \
        out["compared"]["update_gap"]["value"]   # NaN


def test_altered_v2_is_not_correct(monkeypatch, capsys):
    altered_v2(monkeypatch)
    out = run_tiny("lambertian64-loop-episode", capsys)
    assert not out["correct"], out["compared"]
    assert out["compared"]["v2_gap"]["value"] > 0.01


def test_descent_takes_its_shading_from_the_traffic(capsys):
    """A descent mix that asks for vertex-normal shading with the
    normal-derivative term renders so, and the check follows it."""
    from gpu_bench.harness import check
    from gpu_bench.harness.recorder import Recorder

    cell = tiny("lambertian64-descent-23k")
    cell.traffic.update(normal="vn", testing_flag=0)
    d = spec.driver(cell.config, cell.traffic, SEED, ["cpu"])
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
        nums = readings.read_seed(
            cell, seed, 1, main.cell_devices(cell.chips, "cpu"))["numbers"]
        control = {k: v[1] for k, v in nums.items()}
        program = {k: v[0] for k, v in nums.items() if k in cell.limits}
        assert not check.verdict(control, cell.limits)[0], control
        assert all(program[k] <= cell.limits[k] for k in program), program


@pytest.mark.gpu
def test_sharded_cell_on_virtual_shards_of_one_card(capsys):
    """The four-shard cell on [cuda:0] * 4 at a reduced size (a 32x32
    scan, a 40x40 height field), traced: correct, and the trace read on
    its one card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = _cell(SHARDED)
    cell.config = dict(cell.config, scan_resolution=32)
    cell.traffic = dict(cell.traffic, surface=dict(cell.traffic["surface"],
                                                   n=40))
    args = types.SimpleNamespace(workload=SHARDED, seed=SEED, seconds=3.0,
                                 trace=1)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    rc = main._run(args, cell, [dev] * 4, time.perf_counter())
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"], out["compared"]
    assert len(out["device"]["busy_s_per_card"]) == 1
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert out["metrics"]["launches_per_iter"]["value"] > 0
