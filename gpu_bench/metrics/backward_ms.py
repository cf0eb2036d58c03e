"""The host time of each chunk's backward (the program's
``render.backward`` spans: K2 and its epilogue with their wrapper, or the
eager GGX backward) per traced iteration, in ms: the stage's wall time as
the host paces it, its device idle (``backward_idle_ms``) included."""

from gpu_bench.harness import program_spans


def read(ctx):
    return program_spans.host_ms_per_iteration(ctx, "render.backward")
