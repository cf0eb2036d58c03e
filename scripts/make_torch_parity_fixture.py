"""Write the same-key loop curves of the JAX package, the fixture that
tests/test_torch_parity.py holds the PyTorch port to.

    python scripts/make_torch_parity_fixture.py [short|long ...]

Each case runs the JAX package's ``run_experiment("armadillo", ...)`` on
the CPU with x64 off, as its runner runs, at a reduced scale: the
synthetic height field (no mesh asset), GT shards, LCT init, the outer
loop with its remeshes.  The GT shards are written first by the JAX
package's ``create_gt`` with the arguments the runner gives it, under
``jax.disable_jit()``, and the runner then loads them: jitted, XLA's
fused CPU code rounds the ray lengths differently from JAX's own
op-by-op arithmetic (which the port equals), which moves a few GT samples
across a bin edge, and the plateau test (a relative change of 1e-4) can
then remesh at another iteration.  It writes tests/data/parity_<case>.json:
the arguments, the key, the jax version, and per iteration l2,
l2_original, v2 and the face count (from the iteration's checkpoint,
through ``collect_progress``).  Everything is made here; nothing is
downloaded.  "short" takes ~3.5 min on the CPU, "long" ~9 min.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the fixture's arguments; the port's test runs each case with the same ones
CASES = {
    "short": dict(scene="armadillo", max_iters=8, scan_resolution=8,
                  sample_num=4000, gt_sample_num=4000, seed=0),
    "long": dict(scene="armadillo", max_iters=30, scan_resolution=16,
                 sample_num=4000, gt_sample_num=4000, seed=0),
}


def make(case: str) -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    from nlos_surface_optimization_tpu.experiments.create_gt import create_gt
    from nlos_surface_optimization_tpu.experiments.run import (
        SCENES,
        _load_gt_mesh,
        run_experiment,
    )
    from nlos_surface_optimization_tpu.io.progress import collect_progress

    args = CASES[case]
    spec = SCENES[args["scene"]]
    key = jax.random.key(args["seed"])
    res = args["scan_resolution"]
    with tempfile.TemporaryDirectory() as tmp:
        meshes = os.path.join(tmp, "no_meshes")
        os.makedirs(meshes)
        work = os.path.join(tmp, "run")
        t0 = time.perf_counter()
        with jax.disable_jit():
            create_gt(spec, *_load_gt_mesh(spec, meshes),
                      os.path.join(work, "setup"),
                      num_shards=16 if res >= 256 else 8, resolution=res,
                      sample_num=args["gt_sample_num"], key=key)
        _, hist = run_experiment(
            args["scene"], work, max_iters=args["max_iters"],
            scan_resolution=args["scan_resolution"],
            sample_num=args["sample_num"],
            gt_sample_num=args["gt_sample_num"], meshes=meshes,
            key=key, log=lambda m: None)
        seconds = time.perf_counter() - t0
        prog = collect_progress(os.path.join(work, "progress"))
    return {
        "args": args,
        "jax_version": jax.__version__,
        "x64": False,
        "gt": "create_gt under jax.disable_jit()",
        "cpu_seconds": seconds,
        "iteration": [int(x) for x in prog["iteration"]],
        "faces": [int(x) for x in prog["num_faces"]],
        "l2": [float(x) for x in hist["l2"]],
        "l2_original": [float(x) for x in hist["l2_original"]],
        "v2": [float(x) for x in hist["v2"]],
    }


def main(argv=None) -> int:
    cases = (argv if argv is not None else sys.argv[1:]) or ["short"]
    out_dir = os.path.join(ROOT, "tests", "data")
    os.makedirs(out_dir, exist_ok=True)
    for case in cases:
        rec = make(case)
        path = os.path.join(out_dir, f"parity_{case}.json")
        with open(path, "w") as fh:
            json.dump(rec, fh, indent=1)
        print(f"{path}: {len(rec['l2'])} iterations, faces "
              f"{rec['faces']}, {rec['cpu_seconds']:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
