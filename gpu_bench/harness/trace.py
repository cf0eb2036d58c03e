"""The traced segment: torch.profiler (device activity only) around a
few iterations, reduced to device intervals on the host's clock.

A spin kernel launched on each of the cell's cards right after a host
timestamp marks the start: device time t of card c maps to host time
mark_c + (t - spin start on c).  Each interval keeps its card.  From the
intervals: each card's busy seconds (the union of its kernel, copy and
fill intervals), kernel seconds and launches by name over all cards, and
the idle gaps of each card, each named by the innermost host span that
holds its midpoint and summed over the cards.
"""

from __future__ import annotations

import re
import time
from collections import defaultdict
from typing import List, NamedTuple, Optional

import torch

from .recorder import sync

SPIN = "spin_kernel"
TOP = 10
_CALLED = re.compile(r"([A-Za-z_][A-Za-z0-9_]*)\s*\(")


class Event(NamedTuple):
    name: str
    start: float   # host seconds
    end: float
    device: int = 0   # the card's index


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def kernel_of(name: str, kernels) -> bool:
    """The event runs one of ``kernels``: a function of that name, matched
    whole, before its argument list ("ns::(anonymous namespace)::k(...)")."""
    called = _CALLED.findall(name) or [name.strip()]
    return any(tok in kernels for tok in called)


def _device_events(prof) -> List[tuple]:
    """(name, start us, end us, card index) of every device activity, read
    from the profiler's raw results (building its Python event tree would
    take about a millisecond an event)."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            s = e.start_ns() * 1e-3
            out.append((e.name(), s, s + e.duration_ns() * 1e-3,
                        e.device_index()))
    return out


def on_host_clock(raw, marks: dict) -> List[Event]:
    """The raw (name, start us, end us, card) intervals but the markers, on
    the host clock: each card's from its own first marker, launched at
    host time ``marks[card]``."""
    base = {}
    for n, s, _, d in raw:
        if SPIN in n:
            base[d] = min(s, base.get(d, s))
    missing = sorted(set(marks) - set(base))
    if missing:
        raise RuntimeError(f"the trace holds no marker kernel on card(s) "
                           f"{missing}")
    out = []
    for n, s, e, d in raw:
        if SPIN in n:
            continue
        if d not in marks:
            raise RuntimeError(f"a device event on card {d}, outside the "
                               f"cell's cards {sorted(marks)}")
        out.append(Event(n, marks[d] + (s - base[d]) * 1e-6,
                         marks[d] + (e - base[d]) * 1e-6, d))
    return sorted(out)


class Segment:
    """Profile the cell's distinct cards (CUDA devices) while the block
    runs; ``events`` then holds their device intervals on the host clock,
    ``t0``/``t1`` the segment."""

    def __init__(self, devices):
        self.devices = list(devices)
        self.events: List[Event] = []

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        sync(self.devices)
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._marks = {}
        for d in self.devices:
            with torch.cuda.device(d):
                self._marks[d.index] = time.perf_counter()
                torch.cuda._sleep(1000)
        sync(self.devices)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        sync(self.devices)
        self.t1 = time.perf_counter()
        self._prof.__exit__(*exc)
        raw = _device_events(self._prof)
        self._prof = None
        self.events = on_host_clock(raw, self._marks)
        return False


def intervals_union(events, t0, t1):
    """Merged busy intervals of events, clipped to [t0, t1]."""
    out = []
    for e in sorted(events, key=lambda e: e.start):
        s, x = max(e.start, t0), min(e.end, t1)
        if x <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], x)
        else:
            out.append([s, x])
    return out


def busy_seconds(events, t0, t1) -> float:
    return sum(b - a for a, b in intervals_union(events, t0, t1))


def on_card(events, card: int):
    return [e for e in events if e.device == card]


def busy_per_card(events, t0, t1, cards) -> List[float]:
    """Each card's busy seconds in [t0, t1]; a card with no event reads 0."""
    return [busy_seconds(on_card(events, c), t0, t1) for c in cards]


def mean_busy_seconds(busy_per_card) -> float:
    """The mean over the cell's cards of each card's busy seconds."""
    return sum(busy_per_card) / len(busy_per_card)


def kernel_seconds(events, kernels) -> float:
    """The device seconds of ``kernels``, summed over every card."""
    return sum(e.end - e.start for e in events if kernel_of(e.name, kernels))


def launches(events) -> int:
    return sum(1 for e in events if is_kernel(e.name))


def _label(t, spans) -> str:
    best: Optional[tuple] = None
    for name, a, b in spans:
        if a <= t <= b and (best is None or b - a < best[2] - best[1]):
            best = (name, a, b)
    return best[0] if best else "between_iterations"


def breakdown(events, t0, t1, spans, cards) -> dict:
    """The device ops that took most time over all cards, and each card's
    idle time by what the host was doing, summed over ``cards``; each at
    most TOP entries, seconds as measured."""
    by_op = defaultdict(float)
    for e in events:
        by_op[e.name[:160]] += e.end - e.start
    idle = defaultdict(float)
    for c in cards:
        prev = t0
        for a, b in intervals_union(on_card(events, c), t0, t1) + [[t1, t1]]:
            if a > prev:
                idle[_label((a + prev) / 2, spans)] += a - prev
            prev = max(prev, b)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}
