"""Lightweight phase timing and program spans.

``PhaseTimer`` sums the host seconds of named phases; with ``block=True``
a phase first waits for the CUDA device to finish the work queued in it.
``trace`` records a torch.profiler trace of the CPU and, where there is
one, the CUDA device, written as a Chrome trace.

``span(name)`` marks a named interval of the program.  It records only
while a torch.profiler session records (``trace`` here, or any other
profiler session, CUDA-only ones included); otherwise it returns at once.
A recorded span keeps its name and its host start and end on the
``time.perf_counter`` clock (spans nest as the one thread that opens them
nests them), and enters ``record_function(name)``, so that the
profiler's trace shows the spans over the device's work.  A span never
synchronizes, reads a device value or reorders work.

``timed_span`` is ``span`` for a caller that needs the interval's seconds
whether or not a session records (the outer loop's ``stats``): it always
reads the clock, and the span it records has those same two readings.

Recorded spans stay in one bounded buffer of the process (``MAX_SPANS``;
the spans past it are dropped and counted).  ``spans()`` returns the
closed ones; ``clear_spans()`` empties the buffer.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

MAX_SPANS = 1 << 16


class PhaseTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block: bool = False):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block and torch.cuda.is_available():
                # the queued kernels end before the clock is read
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> str:
        rows = [
            f"{k}: {self.totals[k]:.3f}s / {self.counts[k]}x"
            for k in sorted(self.totals)
        ]
        return "; ".join(rows)


@contextlib.contextmanager
def trace(dirname: str):
    """torch.profiler trace of the block -> DIRNAME/trace.json (Chrome
    trace format: chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(dirname, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(dirname, "trace.json"))


@dataclasses.dataclass
class Span:
    """One recorded span: its name and its host start and end (``t1`` is
    None while it is open)."""

    name: str
    t0: float
    t1: Optional[float] = None


class _Buffer:
    """The process's recorded spans and the count dropped past
    MAX_SPANS."""

    def __init__(self):
        self.spans: List[Span] = []
        self.dropped = 0


_BUFFER = _Buffer()


class _Interval:
    """The context manager of one span: records it when ``record`` is set
    and the buffer has room; always reads the clock (``t0``, ``t1``,
    ``seconds``).  The clock is read first on entry and last on exit, so
    that a span's own recording cost falls inside it, not in its
    parent's self time."""

    __slots__ = ("name", "record", "t0", "t1", "_span", "_rf")

    def __init__(self, name, record):
        self.name, self.record = name, record
        self.t0 = self.t1 = self._span = None

    def __enter__(self):
        self.t0 = time.perf_counter()
        if self.record:
            self._open()
        return self

    def __exit__(self, *exc):
        s = self._span
        if s is not None:
            self._rf.__exit__(*exc)
        self.t1 = time.perf_counter()
        if s is not None:
            s.t1 = self.t1
        return False

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def _open(self):
        buf = _BUFFER
        if len(buf.spans) >= MAX_SPANS:
            buf.dropped += 1
            return
        self._rf = torch.autograd.profiler.record_function(self.name)
        self._rf.__enter__()
        self._span = Span(self.name, self.t0)
        buf.spans.append(self._span)


_OFF = contextlib.nullcontext()


def span(name: str):
    """A span of the program named ``name``.  Records only while a
    torch.profiler session records; otherwise a no-op context."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Interval(name, True)


def timed_span(name: str) -> _Interval:
    """``span`` that also times the block whether or not it records: the
    context's ``seconds`` is the recorded span's t1 - t0."""
    return _Interval(name, torch.autograd._profiler_enabled())


def spans() -> List[Span]:
    """The closed spans, in the order they opened."""
    return [s for s in _BUFFER.spans if s.t1 is not None]


def dropped_spans() -> int:
    """Spans not recorded since the last ``clear_spans``: the buffer was
    full."""
    return _BUFFER.dropped


def clear_spans() -> None:
    """Empty the buffer (spans still open are left out of it)."""
    _BUFFER.spans = []
    _BUFFER.dropped = 0
