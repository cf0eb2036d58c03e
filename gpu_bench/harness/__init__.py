"""The benchmark harness: cells from BENCHMARK.json resolved to their
files by name, the timed window, the trace reduction, the check of the
outputs against the reference and the result line.  The traffic
generators are in ``gpu_bench/drivers``."""
