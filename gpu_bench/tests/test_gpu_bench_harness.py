"""CPU tests of the benchmark harness: the cells resolve to their files,
names and units keep to the allowed characters, the traffic builders,
the trace arithmetic on one card and on two, the reference against the
float64 oracle copy, and the result line's shape.  Card-only tests are
marked ``gpu`` and skip here."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from gpu_bench.harness import roofline, scene, spec, trace  # noqa: E402
from gpu_bench.reference import render as rr  # noqa: E402
from gpu_bench.reference import sampler  # noqa: E402

import oracle_copy  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _cells():
    return [w["name"] for w in _bench()["workloads"]]


@pytest.mark.parametrize("workload", _cells())
def test_cell_resolves_to_its_files(workload):
    cell = spec.resolve(workload)
    assert os.path.exists(os.path.join(BENCH, "drivers",
                                       cell.traffic["kind"] + ".py"))
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]))
    assert cell.limits, "every cell has limits for its compared numbers"
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


def test_names_units_and_files():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in b[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert entry["name"] not in seen
            seen.add(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for c in b["configs"]:
        assert c["file"].startswith("gpu_bench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        for key in c["reduced"]:
            assert NAME.match(key)
        with open(os.path.join(ROOT, c["file"])) as fh:
            assert json.load(fh)["reduced"] == c["reduced"]
    for w in b["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        assert set(m["workloads"]) <= cells
        for w in m["workloads"]:
            # a cell that lists a per-layer metric reports what it moves
            assert m["moves"] in {e["name"] for e in spec.resolve(w).end_to_end}
        assert "\n" not in m["layer"] and "\t" not in m["layer"]
    for e in b["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    assert len(json.dumps(b)) < 64 * 1024
    for root, _, files in os.walk(BENCH):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), BENCH)
            if "__pycache__" not in rel:
                assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_descent_inputs_from_the_seed():
    v, f, plane = scene.height_field(10, 0.35, 0.6, 0.08, 0.01, 2 ** 31 + 9)
    v2, f2, _ = scene.height_field(10, 0.35, 0.6, 0.08, 0.01, 2 ** 31 + 9)
    v3, f3, _ = scene.height_field(10, 0.35, 0.6, 0.08, 0.01, 5)
    assert np.array_equal(v, v2) and np.array_equal(f, f2)
    assert not np.array_equal(v, v3)
    for faces in (f, f3):
        assert sorted(map(tuple, faces)) == sorted(
            map(tuple, scene.grid_faces(10)))
    assert np.all(plane[:, 2] == np.float32(0.6))
    lit, ln = scene.confocal_scan(4, (-0.25, -0.25), (0.25, 0.25))
    assert lit.shape == (16, 3) and np.all(ln[:, 2] == 1)
    assert scene.source_chunk(256, 23762, 20000, 2_000_000) == 64
    assert scene.source_chunk(256, 1922, 20000, 2_000_000) == 64


def test_loop_inputs_are_the_runner_fallback():
    from gpu_bench.drivers import loop_episode

    v, f = loop_episode.fallback_surface({"n": 8, "z0": 0.5, "amplitude": 0.06},
                                    (-0.25, -0.25), (0.25, 0.25))
    assert v.shape == (64, 3) and f.shape == (98, 3)
    assert abs(float(v[:, 2].mean()) - 0.5) < 0.06


def test_key_matches_the_port_key():
    import nlos_surface_optimization_torch as pt

    for seed in (0, 7, 2 ** 31 + 11, 2 ** 40 + 3):
        assert torch.equal(sampler.key(seed), pt.key(seed))


def _events():
    E = trace.Event
    return [E("(anonymous namespace)::occl_kernel(float const*, int)",
              0.10, 0.30),
            E("splat_reduce_kernel", 0.30, 0.35),
            E("Memcpy HtoD (Pageable -> Device)", 0.34, 0.40),
            E("face_sums_kernel(float const*)", 0.50, 0.60),
            E("vertex_epilogue_kernel", 0.60, 0.62),
            E("segment_occluded_kernel(float const*)", 0.80, 0.90)]


def test_busy_idle_and_launch_arithmetic():
    ev = _events()
    assert trace.busy_seconds(ev, 0.0, 1.0) == pytest.approx(0.52)
    assert trace.launches(ev) == 5
    assert trace.kernel_seconds(ev, ("occl_kernel", "splat_reduce_kernel",
                                     "splat_sum_kernel")) == \
        pytest.approx(0.25)
    assert trace.kernel_seconds(ev, ("segment_occluded_kernel",)) == \
        pytest.approx(0.10)
    spans = [("step", 0.0, 1.0), ("inverse_render", 0.05, 0.7)]
    b = trace.breakdown(ev, 0.0, 1.0, spans, [0])
    gaps = dict(b["idle_gaps"])
    assert gaps["inverse_render"] == pytest.approx(0.10 + 0.10)
    assert gaps["step"] == pytest.approx(0.18 + 0.10)
    assert b["device_ops"][0][0].startswith("(anonymous namespace)::occl")
    assert not trace.kernel_of("segment_occluded_kernel(float)",
                               ("occl_kernel",))
    from gpu_bench.metrics import device_idle_pct

    class Ctx:
        events, trace_t0, trace_t1, cards = ev, 0.0, 1.0, [0]
    assert device_idle_pct.read(Ctx) == pytest.approx(48.0)


def _two_cards():
    """Card 0 runs _events(); card 1 runs two kernels, [0.2, 0.5] and
    [0.7, 0.8], both inside card 0's idle or busy time."""
    E = trace.Event
    return _events() + [E("occl_kernel(float const*)", 0.2, 0.5, 1),
                        E("segment_occluded_kernel(float)", 0.7, 0.8, 1)]


def test_one_card_reads_as_the_union_did(monkeypatch):
    """On one card the per-card reads give the numbers that the one
    timeline gave: busy_s, the idle share, the breakdown, the peak."""
    from gpu_bench.harness import main
    from gpu_bench.metrics import device_idle_pct

    ev = _events()
    assert trace.busy_per_card(ev, 0.0, 1.0, [0]) == [
        trace.busy_seconds(ev, 0.0, 1.0)]
    assert trace.mean_busy_seconds(trace.busy_per_card(ev, 0.0, 1.0, [0])) \
        == trace.busy_seconds(ev, 0.0, 1.0) == pytest.approx(0.52)

    class Ctx:
        events, trace_t0, trace_t1, cards = ev, 0.0, 1.0, [0]
    assert device_idle_pct.read(Ctx) == 100.0 * (
        1.0 - trace.busy_seconds(ev, 0.0, 1.0) / 1.0)
    spans = [("step", 0.0, 1.0), ("inverse_render", 0.05, 0.7)]
    # the gaps the one timeline gave (test_busy_idle_and_launch_arithmetic)
    assert dict(trace.breakdown(ev, 0.0, 1.0, spans, [0])["idle_gaps"]) == \
        pytest.approx({"inverse_render": 0.20, "step": 0.28})
    peaks = {0: 10, 1: 30}
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda d: peaks[d.index])
    assert main.memory_peak([torch.device("cuda", 0)]) == 10
    assert main.memory_peak(main.cell_devices(2)) == 30
    assert main.memory_peak([torch.device("cuda", 0)] * 4) == 10
    assert main.memory_peak(main.cell_devices(4, "cpu")) == 0


def test_two_cards_are_read_card_by_card():
    """Busy time per card and its mean, the idle share as the mean per
    card, the breakdown's gaps summed over the cards, and a card with no
    event idle throughout."""
    from gpu_bench.metrics import device_idle_pct, launches_per_iter

    ev = _two_cards()
    assert trace.busy_per_card(ev, 0.0, 1.0, [0, 1]) == pytest.approx(
        [0.52, 0.40])
    assert trace.mean_busy_seconds(trace.busy_per_card(
        ev, 0.0, 1.0, [0, 1])) == pytest.approx(0.46)
    # one timeline over both cards would read 0.72 busy: "some card busy"
    assert trace.busy_seconds(ev, 0.0, 1.0) == pytest.approx(0.72)
    assert trace.busy_per_card(ev, 0.0, 1.0, [0, 1, 2])[2] == 0.0

    class Ctx:
        events, trace_t0, trace_t1, cards = ev, 0.0, 1.0, [0, 1]
        trace_iterations = 2
    assert device_idle_pct.read(Ctx) == pytest.approx(54.0)
    assert launches_per_iter.read(Ctx) == pytest.approx(7 / 2)
    spans = [("step", 0.0, 1.0), ("inverse_render", 0.05, 0.7)]
    b = trace.breakdown(ev, 0.0, 1.0, spans, [0, 1])
    gaps = dict(b["idle_gaps"])
    # card 0: inverse_render 0.20, step 0.28; card 1: [0, 0.2] and
    # [0.5, 0.7] under inverse_render, [0.8, 1.0] under step (each gap
    # named by the span at its midpoint)
    assert gaps["inverse_render"] == pytest.approx(0.20 + 0.40)
    assert gaps["step"] == pytest.approx(0.28 + 0.20)
    assert sum(gaps.values()) == pytest.approx(2.0 - 0.92)
    ops = dict(b["device_ops"])
    assert ops["occl_kernel(float const*)"] == pytest.approx(0.3)
    assert trace.kernel_seconds(ev, ("occl_kernel",)) == pytest.approx(0.5)


def test_each_card_is_mapped_from_its_own_marker():
    """Two cards whose device clocks differ: each card's events land on
    the host clock from that card's first marker; a card of the cell
    with no marker, or an event on a card outside the cell, raises."""
    spin = trace.SPIN + "(long)"
    raw = [(spin, 5_000.0, 6_000.0, 0), ("k0", 7_000.0, 8_000.0, 0),
           (spin, 900_000.0, 901_000.0, 1), ("k1", 900_500.0, 902_500.0, 1),
           (spin, 950_000.0, 951_000.0, 1)]
    ev = trace.on_host_clock(raw, {0: 10.0, 1: 10.25})
    assert [e.name for e in ev] == ["k0", "k1"]
    k0, k1 = ev
    assert (k0.device, k1.device) == (0, 1)
    assert (k0.start, k0.end) == pytest.approx((10.002, 10.003))
    assert (k1.start, k1.end) == pytest.approx((10.2505, 10.2525))
    with pytest.raises(RuntimeError, match="no marker"):
        trace.on_host_clock(raw, {0: 10.0, 1: 10.25, 2: 10.5})
    with pytest.raises(RuntimeError, match="outside"):
        trace.on_host_clock(raw, {0: 10.0})


def test_roofline_arithmetic_on_a_hand_made_trace():
    from gpu_bench.metrics import k1_roofline, k2_roofline, k3_roofline

    r = dict(kind="inverse", L=128, Lc=64, F=100, Fv=100, V=60,
             spt=2, B=50, refine_fwd=1, refine=10, sigma_bin=1, vn=False,
             gn=False, fused_bwd=True, sms=132)
    c = dict(r, kind="intensity")

    class Ctx:
        events, renders = _events(), [r, c]
    R = 64 * 100 * 2
    want = 2 * (41 * R + 12 * 60 + 25 * 100 + 4 * 64 * 50) / 3.35e12
    assert k1_roofline.read(Ctx) == pytest.approx(100 * want / 0.25)
    want3 = 2 * (33 * R + 12 * 60 + 25 * 100) / 3.35e12
    assert k3_roofline.read(Ctx) == pytest.approx(100 * want3 / 0.10)
    k2 = k2_roofline.read(Ctx)
    assert 0 < k2 < 100
    assert k2_roofline.read(type("C", (), {"events": _events(), "renders": [
        dict(r, fused_bwd=False)]})) is None
    assert k3_roofline.read(type("C", (), {"events": _events()[:5],
                                           "renders": [c]})) is None
    assert roofline.bound_seconds(67e12, 0) == pytest.approx(1.0)


def _tiny_scene(seed=3):
    v, f, _ = scene.height_field(8, 0.35, 0.6, 0.08, 0.01, seed)
    lit, ln = scene.confocal_scan(3, (-0.25, -0.25), (0.25, 0.25))
    return v, f, lit, ln


def test_reference_rows_match_the_f64_oracle():
    v, f, lit, ln = _tiny_scene()
    key = sampler.key(99)
    opt = rr.Optics(num_bins=1200, res=1.2e-3, lo=0.0, refine=10,
                    sigma_bin=1)
    spt = 3
    sc = rr.Scene(v, f, lit, ln, key.numpy(), torch.float64, "cpu")
    L, F = lit.shape[0], f.shape[0]
    src = torch.arange(L).repeat_interleave(F * spt)
    j = torch.arange(F * spt).repeat(L)
    S, T = sampler.uniforms(key, src, j // spt, j % spt, spt)
    sq = torch.sqrt(T.double())
    bary = torch.stack([1 - sq, (1 - S.double()) * sq, S.double() * sq],
                       -1).reshape(L, F, spt, 3).numpy()
    want = oracle_copy.forward_transient(
        v.astype(np.float64), f, lit.astype(np.float64),
        ln.astype(np.float64), bary, 0.0, 1.2e-3, 1200)
    rows = list(range(L))
    got = rr.transient_rows(sc, opt, rows, rows, spt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9,
                               atol=1e-12 * np.abs(want).max())
    diff = np.random.RandomState(0).randn(L, 1200) * 1e-3
    gw = oracle_copy.vertex_gradient(
        v.astype(np.float64), f, lit.astype(np.float64),
        ln.astype(np.float64), bary, diff, 0.0, 1.2e-3, 1200, 10, 1)
    verts = [0, 9, 30, 63]
    gg = rr.vertex_gradient(sc, opt, verts, torch.from_numpy(diff),
                            spt).numpy()
    np.testing.assert_allclose(gg, gw[verts], rtol=1e-7,
                               atol=1e-9 * np.abs(gw).max())


def test_result_line_shape():
    """The last line of a run, as the harness prints it, parses and has
    the keys the driver reads; ``compared`` comes last."""
    from gpu_bench.harness import main

    line = main.result_line(
        True, 3, 0, {"setup_s": {"value": 1.5, "unit": "s"}},
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
         "memory_peak_bytes": 10}, None, [("rows_gap", 1e-7, 1e-3)])
    d = json.loads(line)
    assert list(d) == ["correct", "attempted", "failed", "metrics",
                       "device", "compared"]
    assert d["compared"]["rows_gap"] == {"value": 1e-7, "limit": 1e-3}


def test_no_card_no_result():
    """Without a CUDA device the command exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         _cells()[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_benchmark_alone_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files (no program), the command fails and prints no result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "gpu_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "gpu_bench/run.py", "--workload", _cells()[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert out.returncode != 0
    assert "correct" not in out.stdout


@pytest.mark.gpu
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "lambertian64-descent-23k", "--seed", "5", "--seconds", "2",
         "--trace", "0"], capture_output=True, text=True, timeout=360,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
