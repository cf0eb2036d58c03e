"""The device's idle time while the host is in the sampler and ray setup
(innermost program span ``render.sample``) per traced iteration, in ms:
a part of ``sample_ms``."""

from gpu_bench.harness import program_spans


def read(ctx):
    return program_spans.idle_ms_per_iteration(ctx, "render.sample")
