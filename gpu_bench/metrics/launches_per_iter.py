"""Device kernel launches per iteration in the traced segment, counted
from the trace's kernel events on every card (copies and fills left
out)."""

from gpu_bench.harness import trace


def read(ctx):
    if not ctx.events or not ctx.trace_iterations:
        return None
    return trace.launches(ctx.events) / ctx.trace_iterations
