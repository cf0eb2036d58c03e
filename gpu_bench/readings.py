"""Readings that set the limits of a cell's compared numbers: for each
seed, the cell's set-up and a few iterations of its timed path, then the
check, with the program's numbers and the control's (the reference in
bfloat16 in the program's place) side by side.  Not run by the
benchmark's runs.

    python3 gpu_bench/readings.py --workload <cell> --seeds 1,2,3 \\
        [--steps 2] [--out FILE]

Each seed prints one JSON line {"seed", "steps", "numbers": {name:
[program, control]}, "update": {...}, "seconds"}; ``update`` describes
the vertex where the program's update lies farthest from the
reference's, with every vertex counted.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def update_worst(x, cell, seed, device) -> dict:
    """Where the program's update lies farthest from the reference's,
    over every vertex: the gap there, its reference gradient over the
    median vertex's, the two updates' lengths and angle, and whether the
    vertex lies on the border."""
    import numpy as np
    import torch

    from gpu_bench.harness import check
    from gpu_bench.reference import geometry as rgeo

    ref = check.Reference(x, cell.config, cell.traffic["check"], seed,
                          device)
    _, u_ref, grad = ref.descent(x["step"]["g"])
    u = torch.as_tensor(x["step"]["update"]).to(u_ref.device, torch.float64)
    e = (u - u_ref).norm(dim=1) / u_ref.norm(dim=1).max()
    w = int(e.argmax())
    gn = grad.norm(dim=1)
    border = rgeo.border_vertices(x["step"]["f"], u.shape[0])
    cos = float((u[w] * u_ref[w]).sum() / torch.clamp(
        u[w].norm() * u_ref[w].norm(), min=1e-300))
    return dict(gap_all=float(e.max()), grad_over_median=float(
        gn[w] / gn.median()), len_program=float(u[w].norm()),
        len_reference=float(u_ref[w].norm()), cos=cos,
        border=bool(border[w]), adam_step=int(x["step"]["opt"].step),
        weight_flag=bool(x["step"]["weight_flag"]),
        excluded=int((~check.moving(grad)).sum()), vertices=int(
            u.shape[0]), gap_kept=float(e[check.moving(grad)].max()),
        gaps_over_1e3=int((e > 1e-3).sum()), nan=bool(np.isnan(
            float(e.max()))))


def read_seed(cell, seed, steps, devices):
    """The program's and the control's numbers on one seed, the cell run
    on ``devices`` (the harness's ``cell_devices``); the check on the
    first."""
    import torch

    from gpu_bench.harness import check, spec
    from gpu_bench.harness.recorder import Recorder

    t0 = time.perf_counter()
    device = torch.device(devices[0])
    d = spec.driver(cell.config, cell.traffic, seed, devices)
    d.setup()
    rec = Recorder()
    n = 0
    while n < steps or (cell.traffic["kind"] == "loop_episode"
                        and "cull_gap" in cell.limits
                        and d.last_cull is None and n < 16):
        d.step(rec)
        n += 1
    x = d.check_inputs()
    d.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    nums = check.numbers(x, cell.config, cell.traffic["check"], seed, device,
                         control=True)
    return {"seed": seed, "steps": n, "numbers": nums,
            "update": update_worst(x, cell, seed, device),
            "seconds": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the cell's cards (cuda:0 ... cuda:chips-1) or, "
                    "rehearsing, ['cpu'] * chips")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from gpu_bench.harness import main as harness
    from gpu_bench.harness import spec

    cell = spec.resolve(args.workload)
    devices = harness.cell_devices(cell.chips, args.device)
    for s in args.seeds.split(","):
        line = json.dumps(read_seed(cell, int(s), args.steps, devices))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
