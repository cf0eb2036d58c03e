"""The benchmark's command, run from the root of a checkout:

    python3 gpu_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

prints one JSON line (the last of standard output): ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with --trace 1 its per-layer ones), ``device`` and, traced, the
``breakdown``; then ``compared``, each number checked with its limit
(also the last lines of standard error).  Exits non-zero, printing no
result, without the CUDA devices the cell asks for.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from gpu_bench.harness import main as harness

    return harness.run(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
