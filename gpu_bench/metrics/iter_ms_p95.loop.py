"""``iter_ms_p95`` in the loop episodes, read per layer: the tail is a
few of the window's remeshes, whose host time spreads it by more than
the widest bound allows, so the cell holds its throughput end to end and
keeps its tail here, under the same arithmetic."""

from gpu_bench.metrics.iter_ms_p95 import read  # noqa: F401
