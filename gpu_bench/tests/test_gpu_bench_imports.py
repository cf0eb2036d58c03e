"""Nothing the benchmark loads brings in JAX or the JAX package, and the
reference loads nothing of the program under test.  Each check runs in a
fresh interpreter, and compares whole top-level module names."""

import json
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

PROBE = """
import importlib, json, sys
sys.path.insert(0, {root!r})
for name in {modules!r}:
    importlib.import_module(name)
from gpu_bench.harness import spec
for metric in {metrics!r}:
    spec.reader(metric)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_after(modules, metrics=()):
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=ROOT, modules=modules,
                                            metrics=list(metrics))],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _bench_modules():
    names = ["gpu_bench.harness.main", "gpu_bench.harness.check",
             "gpu_bench.readings"]
    names += [f"gpu_bench.drivers.{f[:-3]}"
              for f in sorted(os.listdir(os.path.join(BENCH, "drivers")))
              if f.endswith(".py") and f != "__init__.py"]
    return names


def _bench_metrics():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        b = json.load(fh)
    return [m["name"] for m in b["end_to_end"] + b["per_layer"]]


def test_harness_metrics_and_reference_load_no_jax():
    loaded = _top_level_after(_bench_modules(), _bench_metrics())
    assert "nlos_surface_optimization_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax",
                         "nlos_surface_optimization_tpu"}


def test_reference_loads_nothing_of_the_program():
    loaded = _top_level_after([
        "gpu_bench.reference.render", "gpu_bench.reference.optim",
        "gpu_bench.reference.sampler", "gpu_bench.reference.geometry"])
    assert not loaded & {"jax", "jaxlib", "flax",
                         "nlos_surface_optimization_tpu",
                         "nlos_surface_optimization_torch"}


def test_every_traffic_file_names_a_driver():
    """Each traffic mix is data whose ``kind`` names a driver module."""
    import importlib

    for name in os.listdir(os.path.join(BENCH, "traffic")):
        with open(os.path.join(BENCH, "traffic", name)) as fh:
            kind = json.load(fh)["kind"]
        mod = importlib.import_module(f"gpu_bench.drivers.{kind}")
        assert callable(mod.Driver)
