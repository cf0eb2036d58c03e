"""Lightweight phase timing.

``PhaseTimer`` sums the host seconds of named phases; with ``block=True``
a phase first waits for the CUDA device to finish the work queued in it.
``trace`` records a torch.profiler trace of the CPU and, where there is
one, the CUDA device, written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


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
