"""``inverse_ms`` in the GGX descent, where it moves ``iter_ms_p95``: that
cell's throughput follows the host's speed too widely to be held end to
end, so its per-layer metrics answer to its tail."""

from gpu_bench.metrics.inverse_ms import read  # noqa: F401
