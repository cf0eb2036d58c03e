"""The 95th percentile (inclusive interpolation) of the wall time of
every iteration completed in the window, a remesh included, in ms."""

import statistics


def read(ctx):
    ms = [it["seconds"] * 1e3 for it in ctx.iterations]
    if len(ms) < 2:
        return ms[0] if ms else None
    return statistics.quantiles(ms, n=20, method="inclusive")[-1]
