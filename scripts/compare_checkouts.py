#!/usr/bin/env python3
"""Serve and train through two checkouts of the port in turns on one card.

    python3 scripts/compare_checkouts.py BASE_DIR [CHANGE_DIR] [--order ABBA]
        [--probe | --kernels]

Runs ``chip_smoke.py``'s serving phase (4 full-width MiT-b3 requests and a
torch.profiler split of one forward) and training phase (``Trainer.fit``
and bf16 steps, with their profiles) of checkout A (BASE_DIR) and
checkout B (CHANGE_DIR, default: this checkout) in the order given, each
run a fresh process in its checkout's own directory that builds that
checkout's kernels from its own sources.  Every output line is prefixed
with the run's label (A1, B1, B2, A2), so the two can be compared within
one call on one card.  ``--probe`` runs instead, per checkout, 12 fp32
and 12 bf16 train steps (full-width MiT-b3, batch 3) timed on the host
twice (until the step returns, and until the card is done), and 50 calls
of K1's training wrapper at training stage 0 timed on the host alone:
where the two checkouts' step times differ, this says whether the host or
the card holds it.  ``--kernels`` runs instead, per checkout, both K1
wrappers and K2 at the four stage shapes (serving scan batch 3, training
scan batch 9; fp32 and bf16; K2 on the chunk states of that checkout's own
K1-training) on the same inputs, timed by the same code for both, this
checkout's ``chip_smoke.device_ms`` (CUDA-graph replay) and
``chip_smoke.cuda_ms`` (one eager call), and prints the sums over a
forward's or a step's 8 launches.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = """
import torch
import chip_smoke as c
from vivim_tpu_torch.kernels import _build
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
print(f"build: {_build.build_all():.1f} s", flush=True)
c.phase_serve()
c.phase_train()
"""
PROBE = """
import statistics, time
import torch
import chip_smoke as c
from vivim_tpu_torch.cli.common import build_model
from vivim_tpu_torch.kernels import _build
from vivim_tpu_torch.kernels import selective_scan as ss
from vivim_tpu_torch.train import loop
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
_build.build_all()
model, _ = build_model(c.model_args("b3"), device="cuda", seed=0)
batch = {k: torch.from_numpy(v).cuda() for k, v in
         c.make_requests(1, 5, 256, 3, seed=1, batch=3)[0].items()}
state = loop.create_train_state(model, 1e-4, 1e-2, 24, seed=1)
for dtype in (torch.float32, torch.bfloat16):
    step = loop.make_train_step(model, "recall_focused", 3,
                                compute_dtype=dtype)
    host, wall = [], []
    for _ in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host.append((t1 - t0) * 1e3)
        wall.append((time.perf_counter() - t0) * 1e3)
    med = lambda xs: statistics.median(xs[2:])
    print(f"probe {c.dtype_name(dtype)} step ms: host until return "
          f"{med(host):.2f} median, until the card is done {med(wall):.2f} "
          "median (steps 3-12); all: "
          + ", ".join(f"{h:.1f}/{w:.1f}" for h, w in zip(host, wall)),
          flush=True)
gen = torch.Generator(device="cuda").manual_seed(0)
a = c.scan_inputs(c.TRAIN_SCAN_BATCH, *c.STAGES[0], torch.float32, gen)
call = lambda: ss.selective_scan_fwd_states_cuda(*a[:6], a[7], True)
call()
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(50):
    call()
t1 = time.perf_counter()
torch.cuda.synchronize()
print(f"probe K1-train wrapper: {(t1 - t0) * 1e6 / 50:.1f} us of host time "
      f"per call", flush=True)
"""
KERNELS = """
import importlib.util
import torch
from vivim_tpu_torch.kernels import _build
from vivim_tpu_torch.kernels import selective_scan as ss
spec = importlib.util.spec_from_file_location("timing", SMOKE)
t = importlib.util.module_from_spec(spec)
spec.loader.exec_module(t)
_build.build_all()
gen = torch.Generator(device="cuda").manual_seed(0)


def k2(a, L, d, dtype):
    # K2 on this checkout's own K1-training chunk states
    dout = torch.randn(t.TRAIN_SCAN_BATCH, L, d, generator=gen,
                       device="cuda").to(dtype)
    cs = ss.selective_scan_fwd_states_cuda(*a[:6], a[7], True)[1]
    return lambda: ss.selective_scan_bwd_cuda(*a[:6], a[7], cs, dout, None,
                                              True)


for label, batch, make in (
        ("K1 per serving forward", t.SCAN_BATCH,
         lambda a, *_: lambda: ss.selective_scan_fwd_cuda(*a, True)),
        ("K1-train per train step", t.TRAIN_SCAN_BATCH,
         lambda a, *_: lambda: ss.selective_scan_fwd_states_cuda(
             *a[:6], a[7], True)),
        ("K2 per train step", t.TRAIN_SCAN_BATCH, k2)):
    for dtype in (torch.float32, torch.bfloat16):
        dev, eager = [], []
        for L, d in t.STAGES:
            a = t.scan_inputs(batch, L, d, dtype, gen)
            run = make(a, L, d, dtype)
            run()
            eager.append(t.cuda_ms(run, 10))
            dev.append(t.device_ms(run))
            del a, run
        k = t.LAYERS_PER_STAGE
        print(f"kernels {label} {t.dtype_name(dtype)}: device ms (graph "
              f"replay) {k * sum(dev):.4f}, one eager call {k * sum(eager):.4f}"
              "; per stage device / eager: " + ", ".join(
                  f"{x:.4f} / {y:.4f}" for x, y in zip(dev, eager)),
              flush=True)
"""


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("base")
    parser.add_argument("change", nargs="?", default=ROOT)
    parser.add_argument("--order", default="ABBA")
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--probe", action="store_true")
    mode.add_argument("--kernels", action="store_true")
    args = parser.parse_args()
    code = RUN
    if args.probe:
        code = PROBE
    elif args.kernels:
        code = f"SMOKE = {os.path.join(ROOT, 'chip_smoke.py')!r}\n" + KERNELS
    dirs = {"A": os.path.abspath(args.base), "B": os.path.abspath(args.change)}
    seen = {}
    failed = []
    for key in args.order:
        seen[key] = seen.get(key, 0) + 1
        label = f"{key}{seen[key]}"
        proc = subprocess.run([sys.executable, "-c", code], cwd=dirs[key],
                              capture_output=True, text=True)
        for line in (proc.stdout + proc.stderr).splitlines():
            print(f"[{label}] {line}", flush=True)
        if proc.returncode != 0:
            failed.append(label)
    if failed:
        sys.exit(f"compare_checkouts: runs {failed} failed")


if __name__ == "__main__":
    main()
