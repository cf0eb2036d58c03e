"""One run of one cell: set-up, the timed window, (with --trace 1) the
spans and a traced segment, the check, and the result line.

A cell on more than one card runs as one process over all its cards: the
driver gets them as its ``devices``, and the harness synchronizes, traces
and reads the memory of each."""

from __future__ import annotations

import gc
import json
import sys
import time

import torch

from . import check, spec, trace
from .recorder import Recorder, cards, sync

FORBIDDEN = ("jax", "jaxlib", "flax", "nlos_surface_optimization_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that this benchmark must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Context:
    """What a metric reader reads: the window's iterations and spans, the
    loop's remeshes, the traced segment, the cell's settings and the
    indices of its cards."""

    def __init__(self, cell, setup_s, cards):
        self.cell, self.setup_s, self.cards = cell, setup_s, cards
        self.window_s = 0.0
        self.iterations, self.spans = [], []
        self.events, self.renders, self.trace_spans = None, [], []
        self.trace_t0 = self.trace_t1 = 0.0
        self.trace_iterations = 0


def cell_devices(chips: int, kind: str = "cuda"):
    """The cell's cards: cuda:0 ... cuda:chips-1, or in a CPU test
    ['cpu'] * chips."""
    if kind == "cpu":
        return [torch.device("cpu")] * chips
    return [torch.device(kind, i) for i in range(chips)]


def memory_peak(devices) -> int:
    """The largest peak of allocated memory over the cell's cards."""
    return max((torch.cuda.max_memory_allocated(d) for d in cards(devices)),
               default=0)


def _device_info(dev, count, peak):
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"platform": "gpu" if dev.type == "cuda" else "cpu",
            "kind": kind, "count": count, "memory_peak_bytes": int(peak)}


def run_window(driver, seconds, rec):
    """Iterations until ``seconds`` have passed -> window seconds."""
    start = time.perf_counter()
    while True:
        driver.step(rec)
        if time.perf_counter() - start >= seconds:
            return time.perf_counter() - start


def run(args, t_start: float) -> int:
    cell = spec.resolve(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        say(f"{cell.name} needs {cell.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    devices = cell_devices(cell.chips)
    torch.cuda.set_device(devices[0])
    return _run(args, cell, devices, t_start)


def _run(args, cell, devices, t_start) -> int:
    dev, gpus = torch.device(devices[0]), cards(devices)
    driver = spec.driver(cell.config, cell.traffic, args.seed, devices)
    driver.setup()
    sync(devices)
    # what set-up built stays: the collector's full passes in the window
    # then scan only what the window makes
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    say("set-up seconds: " + " ".join(
        f"{n} {s:.2f}" for n, s in getattr(driver, "setup_phases", ())))
    ctx = Context(cell, setup_s, [d.index for d in gpus])
    rec = Recorder(sync=bool(args.trace))
    ctx.window_s = run_window(driver, args.seconds, rec)
    ctx.iterations, ctx.spans = rec.iterations, rec.spans
    peak = memory_peak(devices)
    busy = None
    if args.trace:
        seg_rec = Recorder(shapes=True)
        driver.begin_segment()
        with trace.Segment(gpus) as seg:
            for _ in range(int(cell.traffic["trace_steps"])):
                driver.step(seg_rec)
        ctx.events, ctx.renders = seg.events, seg_rec.renders
        ctx.trace_spans = seg_rec.spans
        ctx.trace_t0, ctx.trace_t1 = seg.t0, seg.t1
        ctx.trace_iterations = len(seg_rec.iterations)
        busy = trace.busy_per_card(seg.events, seg.t0, seg.t1, ctx.cards)
    inputs = driver.check_inputs()
    driver.release()
    del driver
    gc.unfreeze()
    gc.collect()
    if gpus:
        torch.cuda.empty_cache()
    values = {k: v[0] for k, v in check.numbers(
        inputs, cell.config, cell.traffic["check"], args.seed, dev).items()}
    correct, rows = check.verdict(values, cell.limits)
    attempted = len(ctx.iterations)
    failed = sum(1 for it in ctx.iterations if not it["ok"])
    metric_defs = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for m in metric_defs:
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    found = forbidden_modules()
    if found:
        say(f"forbidden modules loaded: {found}")
        return 3
    device = _device_info(dev, cell.chips, peak)
    brk = None
    if args.trace:
        device["busy_s"] = trace.mean_busy_seconds(busy)
        device["busy_s_per_card"] = busy
        device["window_s"] = ctx.trace_t1 - ctx.trace_t0
        brk = trace.breakdown(ctx.events, ctx.trace_t0, ctx.trace_t1,
                              ctx.trace_spans, ctx.cards)
    line = result_line(correct and failed == 0, attempted, failed, metrics,
                       device, brk, rows)
    for n, v, lim in rows:
        say(f"compared {n} {v!r} limit {lim!r}")
    print(line, flush=True)
    return 0


def result_line(correct, attempted, failed, metrics, device, brk,
                rows) -> str:
    """The run's last line: the driver's keys, then ``compared``, each
    number checked with its limit."""
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device}
    if brk is not None:
        result["breakdown"] = brk
    result["compared"] = {n: {"value": v, "limit": lim}
                          for n, v, lim in rows}
    return json.dumps(result)
