"""The device's idle time while the host is in a chunk's backward
(innermost program span ``render.backward``) per traced iteration, in
ms."""

from gpu_bench.harness import program_spans


def read(ctx):
    return program_spans.idle_ms_per_iteration(ctx, "render.backward")
