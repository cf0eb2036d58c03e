"""The traced segment: torch.profiler (device activity only) around a
few iterations, reduced to device intervals on the host's clock.

A spin kernel launched right after a host timestamp marks the start:
device time t maps to host time mark + (t - spin start).  From the
intervals: the busy seconds (the union of kernel, copy and fill
intervals), kernel seconds and launches by name, and the idle gaps,
each named by the innermost host span that holds its midpoint.
"""

from __future__ import annotations

import re
import time
from collections import defaultdict
from typing import List, NamedTuple, Optional

import torch

SPIN = "spin_kernel"
TOP = 10
_CALLED = re.compile(r"([A-Za-z_][A-Za-z0-9_]*)\s*\(")


class Event(NamedTuple):
    name: str
    start: float   # host seconds
    end: float


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def kernel_of(name: str, kernels) -> bool:
    """The event runs one of ``kernels``: a function of that name, matched
    whole, before its argument list ("ns::(anonymous namespace)::k(...)")."""
    called = _CALLED.findall(name) or [name.strip()]
    return any(tok in kernels for tok in called)


def _device_events(prof) -> List[tuple]:
    """(name, start us, end us) of every device activity, read from the
    profiler's raw results (building its Python event tree would take
    about a millisecond an event)."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            s = e.start_ns() * 1e-3
            out.append((e.name(), s, s + e.duration_ns() * 1e-3))
    return out


class Segment:
    """Profile the device while the block runs; ``events`` then holds its
    device intervals on the host clock, ``t0``/``t1`` the segment."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.events: List[Event] = []

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._mark = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize(self.device)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        self._prof.__exit__(*exc)
        raw = _device_events(self._prof)
        self._prof = None
        spin = [s for n, s, _ in raw if SPIN in n]
        if not spin:
            raise RuntimeError("the trace holds no marker kernel")
        base = min(spin)
        self.events = sorted(
            Event(n, self._mark + (s - base) * 1e-6,
                  self._mark + (e - base) * 1e-6)
            for n, s, e in raw if SPIN not in n)
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


def kernel_seconds(events, kernels) -> float:
    return sum(e.end - e.start for e in events if kernel_of(e.name, kernels))


def launches(events) -> int:
    return sum(1 for e in events if is_kernel(e.name))


def _label(t, spans) -> str:
    best: Optional[tuple] = None
    for name, a, b in spans:
        if a <= t <= b and (best is None or b - a < best[2] - best[1]):
            best = (name, a, b)
    return best[0] if best else "between_iterations"


def breakdown(events, t0, t1, spans) -> dict:
    """The device ops that took most time, and the idle time by what the
    host was doing, each at most TOP entries, seconds as measured."""
    by_op = defaultdict(float)
    for e in events:
        by_op[e.name[:160]] += e.end - e.start
    idle = defaultdict(float)
    prev = t0
    for a, b in intervals_union(events, t0, t1) + [[t1, t1]]:
        if a > prev:
            idle[_label((a + prev) / 2, spans)] += a - prev
        prev = max(prev, b)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}
