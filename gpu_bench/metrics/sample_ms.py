"""The host time of the chunk loop's sampler and ray setup (the program's
``render.sample`` spans: the threefry draws, the rays, the skip mask and
the contribution with its BRDF) per traced iteration, in ms: the stage's
wall time as the host paces it, its device idle (``sample_idle_ms``)
included."""

from gpu_bench.harness import program_spans


def read(ctx):
    return program_spans.host_ms_per_iteration(ctx, "render.sample")
