"""The share of the traced segment in which no kernel, copy or fill ran
on a card, in %: the mean over the cell's cards of each card's idle
share."""

from gpu_bench.harness import trace


def read(ctx):
    if ctx.events is None:
        return None
    window = ctx.trace_t1 - ctx.trace_t0
    busy = trace.mean_busy_seconds(trace.busy_per_card(
        ctx.events, ctx.trace_t0, ctx.trace_t1, ctx.cards))
    return 100.0 * (1.0 - busy / window)
