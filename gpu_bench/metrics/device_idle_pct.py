"""The share of the traced segment in which no kernel, copy or fill ran
on the device, in %."""

from gpu_bench.harness import trace


def read(ctx):
    if ctx.events is None:
        return None
    window = ctx.trace_t1 - ctx.trace_t0
    busy = trace.busy_seconds(ctx.events, ctx.trace_t0, ctx.trace_t1)
    return 100.0 * (1.0 - busy / window)
