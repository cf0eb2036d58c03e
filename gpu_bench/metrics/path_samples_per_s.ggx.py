"""``path_samples_per_s`` in the GGX descent, read per layer: the
host-paced eager GGX backward spreads it by more than the widest bound
allows, so the cell holds its tail end to end and keeps its throughput
here, under the same arithmetic."""

from gpu_bench.metrics.path_samples_per_s import read  # noqa: F401
