"""CPU tests of the program-span readers (harness/program_spans.py and the
metrics that read it) on synthetic traces: idle split over nested spans,
idle outside every span, a gap across a span's edge, agreement with
``trace.breakdown``'s labels where no gap crosses an edge, and no reading
from a program that records no spans."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(BENCH))

from gpu_bench.harness import program_spans, trace  # noqa: E402
from gpu_bench.metrics import (  # noqa: E402
    backward_idle_ms,
    backward_ms,
    sample_idle_ms,
    sample_ms,
    smooth_ms,
)
from nlos_surface_optimization_torch.utils import timers  # noqa: E402


def _ev(*pairs):
    return [trace.Event("k", a, b) for a, b in pairs]


# a render call [0, 10] with one chunk: sample [1, 3], k1 [3, 4],
# smooth [4, 5], backward [6, 9]; the device busy in five intervals
SPANS = [("render.call", 0.0, 10.0), ("render.sample", 1.0, 3.0),
         ("render.k1", 3.0, 4.0), ("render.smooth", 4.0, 5.0),
         ("render.backward", 6.0, 9.0)]
EVENTS = _ev((0.0, 0.5), (1.5, 2.5), (3.5, 4.5), (7.0, 8.0), (9.5, 10.0))


def test_innermost_pieces_cover_each_instant_once():
    got = program_spans.innermost_pieces(SPANS)
    assert got == [(0.0, 1.0, "render.call"), (1.0, 3.0, "render.sample"),
                   (3.0, 4.0, "render.k1"), (4.0, 5.0, "render.smooth"),
                   (5.0, 6.0, "render.call"), (6.0, 9.0, "render.backward"),
                   (9.0, 10.0, "render.call")]


def test_idle_is_split_over_nested_spans():
    idle = program_spans.idle_by_span(EVENTS, 0.0, 10.0, SPANS)
    want = {"render.call": 0.5 + 1.0 + 0.5,   # [0.5,1] [5,6] [9,9.5]
            "render.sample": 0.5 + 0.5,       # [1,1.5] [2.5,3]
            "render.k1": 0.5,                 # [3,3.5]
            "render.smooth": 0.5,             # [4.5,5]
            "render.backward": 1.0 + 1.0,     # [6,7] [8,9]
            None: 0.0}
    assert idle.keys() == want.keys()
    for k, v in want.items():
        assert idle[k] == pytest.approx(v), k
    busy = trace.busy_seconds(EVENTS, 0.0, 10.0)
    assert sum(idle.values()) == pytest.approx(10.0 - busy)


def test_idle_outside_every_span_and_across_an_edge():
    spans = [("render.call", 1.0, 5.0), ("render.sample", 2.0, 3.0)]
    # idle [0, 1.5] crosses the call's start; [2.5, 4] crosses the
    # sample's end; [5.5, 7] lies after every span
    ev = _ev((1.5, 2.5), (4.0, 5.5))
    idle = program_spans.idle_by_span(ev, 0.0, 7.0, spans)
    assert idle[None] == pytest.approx(1.0 + 1.5)
    assert idle["render.call"] == pytest.approx(0.5 + 1.0)
    assert idle["render.sample"] == pytest.approx(0.5)


def test_sweep_agrees_with_the_breakdown_labels():
    """Where every gap lies inside one innermost span, the sweep and
    trace.breakdown (a gap named by the span at its midpoint) agree."""
    spans = [("step", 0.0, 20.0), ("inverse_render", 0.5, 15.0),
             ("render.sample", 1.0, 4.0), ("render.backward", 6.0, 9.0),
             ("update", 15.0, 19.0)]
    ev = _ev((0.0, 1.2), (1.5, 4.1), (4.2, 6.1), (6.3, 8.8), (9.0, 15.2),
             (15.5, 18.0), (18.5, 20.0))
    idle = program_spans.idle_by_span(ev, 0.0, 20.0, spans)
    gaps = dict(trace.breakdown(ev, 0.0, 20.0, spans)["idle_gaps"])
    assert {k: v for k, v in idle.items() if v > 0} == pytest.approx(gaps)


class _Ctx:
    trace_t0, trace_t1, trace_iterations = 0.0, 10.0, 2

    def __init__(self, events=EVENTS):
        self.events = events


def test_readers_on_the_program_spans(monkeypatch):
    got = [timers.Span(n, a, b) for n, a, b in SPANS]
    # a span outside the segment is left out
    got.append(timers.Span("render.sample", 11.0, 12.0))
    monkeypatch.setattr(timers, "spans", lambda: got)
    ctx = _Ctx()
    assert sample_ms.read(ctx) == pytest.approx(1e3 * 2.0 / 2)
    assert smooth_ms.read(ctx) == pytest.approx(1e3 * 1.0 / 2)
    assert backward_ms.read(ctx) == pytest.approx(1e3 * 3.0 / 2)
    assert sample_idle_ms.read(ctx) == pytest.approx(1e3 * 1.0 / 2)
    assert backward_idle_ms.read(ctx) == pytest.approx(1e3 * 2.0 / 2)
    assert sample_ms.read(_Ctx(events=None)) is None


def test_no_reading_without_program_spans(monkeypatch):
    """A program older than its spans, or one that recorded none in the
    segment: every reader gives None and none raises."""
    monkeypatch.setattr(timers, "spans", lambda: [])
    readers = (sample_ms, sample_idle_ms, smooth_ms, backward_ms,
               backward_idle_ms)
    assert all(m.read(_Ctx()) is None for m in readers)
    monkeypatch.delattr(timers, "spans")
    assert all(m.read(_Ctx()) is None for m in readers)
