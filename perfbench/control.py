"""The control of a cell's output check: the plain reference computed one
precision below the configuration's (TF32 in matmuls and convolutions for
float32) put in the program's place, at the cell's own sizes, judged by
the same comparison.  Its numbers are the upper readings the limits in
``perfbench/limits/<cell>.json`` are set below; a sound program's runs
give the lower ones.  The benchmark's runs never run it.

  python3 -m perfbench.control --workload <cell> --seeds 1 2 3

prints one JSON line per seed: the numbers and whether the limits passed
them (the control has to fail at least one).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from perfbench import harness


def control(bench, name, root, here, seed, device):
    cell, config, traffic, limits = harness.resolve(bench, name, root, here)
    spec = harness.Spec(cell, config, traffic, limits, seed, device, False,
                        harness.scratch_dir(), here)
    drv = harness.driver_class(traffic)(spec)
    if hasattr(drv, "prepare"):
        drv.prepare()
    return drv.control()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    root = os.path.dirname(harness.HERE)
    bench = harness.load_json(os.path.join(root, "BENCHMARK.json"))
    import torch

    if not torch.cuda.is_available():
        print("perfbench.control: needs a CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        checks = control(bench, args.workload, root, harness.HERE, seed,
                         "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "failed": not all(c.ok for c in checks),
                          "checks": {c.name: c.value for c in checks}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
