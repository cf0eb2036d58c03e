"""The host time of each chunk's Gaussian smoothing and coarsening and its
weighted difference (the program's ``render.smooth`` spans) per traced
iteration, in ms: the stage's wall time as the host paces it."""

from gpu_bench.harness import program_spans


def read(ctx):
    return program_spans.host_ms_per_iteration(ctx, "render.smooth")
