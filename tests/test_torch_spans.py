"""The port's program spans (utils/timers.span): what a render and a loop
remesh record under torch.profiler, that nothing is recorded and nothing
changes without it, the buffer's bound and the Chrome trace.

This file imports nothing of JAX.  The case marked ``gpu`` runs on the
card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_spans.py
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import nlos_surface_optimization_torch as pt
from nlos_surface_optimization_torch.optim.outer_loop import (
    InverseRenderingLoop,
    LoopConfig,
)
from nlos_surface_optimization_torch.utils import timers

KEY = pt.key(5)
CHUNK_SPANS = ("render.sample", "render.smooth", "render.backward")


def _grid(n, zfn, extent=0.25):
    xs = np.linspace(-extent, extent, n)
    gx, gy = np.meshgrid(xs, xs)
    v = np.stack([gx.ravel(), gy.ravel(), zfn(gx, gy).ravel()],
                 1).astype(np.float32)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            faces += [[a, a + n, a + 1], [a + n, a + n + 1, a + 1]]
    return v, np.array(faces, np.int32)


def _bumpy(n=6):
    return _grid(n, lambda x, y: 0.5 + 0.08 * np.sin(6 * x) * np.cos(5 * y))


def _scene(device, brdf="lambertian", occl="auto", chunk=4, pad_f=None):
    """(mesh, data, weight, lighting, lnormal, cfg): 16 sources in chunks
    of ``chunk``, the data a render of another surface."""
    v, f = _bumpy()
    cfg = pt.RenderConfig(num_samples=200, num_bins=160,
                          distance_resolution=8e-3, source_chunk=chunk,
                          brdf=brdf, occl_backend=occl)
    lighting, lnormal = pt.make_confocal_scan(4)
    gt = pt.make_mesh(v + np.float32([0, 0, 0.01]), f, device=device)
    data, _ = pt.render_transient(gt, lighting, lnormal, cfg, KEY)
    mesh = pt.make_mesh(v, f, device=device, pad_f=pad_f)
    weight = torch.ones_like(data)
    return mesh, data, weight, lighting, lnormal, cfg


def _inverse(scene):
    mesh, data, weight, lighting, lnormal, cfg = scene
    return pt.inverse_render(mesh, data, weight, lighting, lnormal, cfg, KEY)


@pytest.fixture(autouse=True)
def _empty_buffer():
    timers.clear_spans()
    yield
    timers.clear_spans()


def test_nothing_is_recorded_without_a_profiler():
    scene = _scene("cpu")
    timers.clear_spans()
    _inverse(scene)
    assert timers.spans() == [] and timers.dropped_spans() == 0


def _inside(outer, s):
    return outer.t0 <= s.t0 <= s.t1 <= outer.t1


@pytest.mark.parametrize("brdf,occl,visibility", [
    ("lambertian", "auto", "render.k1"),
    ("ggx", "auto", "render.k1"),
    ("lambertian", "jnp", "render.k3"),
])
def test_inverse_render_records_its_chunk_spans(brdf, occl, visibility):
    """One render.call; render.prepare once; nc spans of each chunk step,
    inside it and in the chunk loop's order."""
    scene = _scene("cpu", brdf, occl, pad_f=56)
    timers.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        _inverse(scene)
    got = timers.spans()
    assert got[0].name == "render.call"
    call, nc = got[0], 4
    names = [s.name for s in got]
    assert names.count("render.call") == 1
    assert names.count("render.prepare") == 1
    for name in CHUNK_SPANS + (visibility,):
        assert names.count(name) == nc, name
    assert len(got) == 2 + 4 * nc
    assert all(_inside(call, s) for s in got)
    # per chunk: sample, visibility, smooth, backward, in that order, each
    # closed before the next opens
    chunk = [s for s in got if s.name in CHUNK_SPANS + (visibility,)]
    assert [s.name for s in chunk] == ["render.sample", visibility,
                                       "render.smooth",
                                       "render.backward"] * nc
    assert all(a.t1 <= b.t0 for a, b in zip(chunk, chunk[1:]))


def test_spans_change_no_output():
    """Transient and gradient bit-identical with the profiler on and off."""
    scene = _scene("cpu")
    t0, g0, _ = _inverse(scene)
    with profile(activities=[ProfilerActivity.CPU]):
        t1, g1, _ = _inverse(scene)
    assert len(timers.spans()) > 0
    assert torch.equal(t0, t1) and torch.equal(g0, g1)


def test_render_transient_and_intensity_record_a_call():
    mesh, data, weight, lighting, lnormal, cfg = _scene("cpu")
    timers.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        pt.render_transient(mesh, lighting, lnormal, cfg, KEY)
        pt.render_intensity(mesh, lighting, lnormal, cfg, KEY)
    got = timers.spans()
    calls = [s for s in got if s.name == "render.call"]
    assert len(calls) == 2
    kids = [[s.name for s in got if s is not c and _inside(c, s)]
            for c in calls]
    assert kids[0] == (["render.prepare"] + ["render.sample", "render.k1"] * 4
                       + ["render.smooth"])
    assert kids[1] == ["render.prepare"] + ["render.sample", "render.k3"] * 4


def test_remesh_stats_are_its_spans():
    """A loop remesh's stats seconds equal its spans' durations; its three
    parts lie inside loop.remesh, the cull's render inside remesh.cull."""
    v_gt, f_gt = _grid(6, lambda x, y: 0.5 + 0.04 * np.sin(6 * x))
    cfg = pt.RenderConfig(num_samples=800, num_bins=160,
                          distance_resolution=8e-3)
    lighting, lnormal = pt.make_confocal_scan(4)
    gt, _ = pt.render_transient(pt.make_mesh(v_gt, f_gt, device="cpu"),
                                lighting, lnormal, cfg, KEY, refine=1)
    v0, f0 = _grid(6, lambda x, y: np.full_like(x, 0.5))
    loop = InverseRenderingLoop(
        gt.numpy(), lighting, lnormal, cfg,
        LoopConfig(lr0=2e-3, T=4, scan_resolution=4), v0, f0, KEY,
        log=lambda s: None, device="cpu")
    loop.step()
    loop.state.remesh_flag = True
    timers.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        loop.step()
    got = timers.spans()
    by = {s.name: s for s in got if not s.name.startswith("render.")}
    assert set(by) == {"loop.remesh", "remesh.geomlib", "remesh.cull",
                       "remesh.rest"}
    for name in ("remesh.geomlib", "remesh.cull", "remesh.rest"):
        assert _inside(by["loop.remesh"], by[name])
    rec = [r for r in loop.stats if r["kind"] == "remesh"][-1]
    for key, name in (("geomlib_seconds", "remesh.geomlib"),
                      ("intensity_seconds", "remesh.cull"),
                      ("rest_seconds", "remesh.rest")):
        assert rec[key] == by[name].t1 - by[name].t0, key
    assert not {"faces_before", "padded_faces", "chunk_rays"} & set(rec)
    cull = [s for s in got if s.name == "render.call"
            and _inside(by["remesh.cull"], s)]
    assert len(cull) == 1


def test_buffer_bound_drops_and_counts(monkeypatch):
    monkeypatch.setattr(timers, "MAX_SPANS", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        with timers.span("outer"):
            for i in range(4):
                with timers.span(f"inner{i}"):
                    pass
    got = timers.spans()
    assert [s.name for s in got] == ["outer", "inner0", "inner1"]
    assert timers.dropped_spans() == 2
    timers.clear_spans()
    assert timers.spans() == [] and timers.dropped_spans() == 0


def test_timed_span_times_without_a_profiler():
    with timers.timed_span("remesh.geomlib") as t:
        sum(range(1000))
    assert t.seconds >= 0 and timers.spans() == []


def test_span_names_appear_in_the_chrome_trace(tmp_path):
    with timers.trace(str(tmp_path)):
        with timers.span("render.sample"):
            torch.ones(64).cumsum(0)
    with open(os.path.join(tmp_path, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "render.sample" for e in events)
    assert [s.name for s in timers.spans()] == ["render.sample"]


@pytest.mark.gpu
def test_spans_under_a_cuda_only_session_on_the_card():
    """As the benchmark's traced segment records: CUDA activity only.  The
    spans record, and the chunk spans of a render.call lie inside it and
    take no more host time than it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    scene = _scene(torch.device("cuda"))
    _inverse(scene)
    torch.cuda.synchronize()
    timers.clear_spans()
    with profile(activities=[ProfilerActivity.CUDA]):
        _inverse(scene)
    got = timers.spans()
    call = [s for s in got if s.name == "render.call"]
    assert len(call) == 1 and len(got) == 2 + 4 * 4
    assert all(_inside(call[0], s) for s in got)
    kids = sum(s.t1 - s.t0 for s in got if s is not call[0])
    assert kids <= call[0].t1 - call[0].t0
