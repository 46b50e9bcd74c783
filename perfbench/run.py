"""Run one cell of the benchmark once and print its result line.

  python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

from the root of a checkout (``BENCHMARK.json`` names the cells).  Needs
the CUDA devices the cell asks for; exits non-zero without printing a
result otherwise.  See ``perfbench/README.md``.
"""

import time

T0 = time.perf_counter()  # set-up starts with the process

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from perfbench import harness

    return harness.main(args, T0, time.perf_counter, root)


if __name__ == "__main__":
    sys.exit(main())
