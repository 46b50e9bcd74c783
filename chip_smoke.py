#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vivim_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. build every CUDA kernel of the port from ``vivim_tpu_torch/kernels/csrc``
   with nvcc (sm_90a) and print the build seconds;
2. print the card's name and power limit (nvidia-smi);
3. hold the selective-scan kernel (K1) against its plain PyTorch version
   at the four Vivim-b3 stage shapes, fp32 and bf16, plus a ragged case
   with a per-batch initial state; print error, kernel / plain / bound ms;
4. serve: full-width MiT-b3 Vivim (3 classes, random weights from a seed)
   answers 4 requests of one (1, 5, 256, 256, 3) clip through the port's
   ``run_inference``; K1 must launch 8 times per forward, the confusion
   matrix must count every pixel, and one forward's logits must agree
   with the same model on the plain scan; a torch.profiler window then
   splits one forward's device time by kernel group;
5. print the kernels line, the card line and, last, the device line.

Without CUDA it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

# the JAX package whose TPU kernels the port replaces: named, never imported
JAX_PACKAGE = "vivim_tpu_torch".removesuffix("_torch")
N = 16                      # d_state
STAGES = (                  # (L = T*H*W, d_inner) of MiT-b3 Vivim at 5x256^2
    (20480, 128), (5120, 256), (1280, 640), (320, 1024))
LAYERS_PER_STAGE = 2        # MambaLayers per stage: K1 launches per shape
SCAN_BATCH = 3              # three scan directions x batch 1
TOL = {torch.float32: (6e-4, 2e-3), torch.bfloat16: (3e-2, 5e-2)}
# H100 SXM data sheet: HBM3 bytes/s and fp32 (non-tensor-core) FLOP/s
CARDS = {"H100 PCIe": (2.0e12, 51e12), "H200": (4.8e12, 67e12),
         "H100": (3.35e12, 67e12)}


def card_peaks(name):
    for key, peaks in CARDS.items():
        if key in name:
            return peaks
    raise RuntimeError(f"no peak figures for card {name!r}")


def scan_work(batch, L, d, elem):
    """Bytes the scan must move and operations it must do."""
    nbytes = (batch * L * (4 * d + 2 * N) * elem       # u, delta, z, y, B, C
              + batch * d * (2 * N + 2) * 4)            # A, last, D, bias
    ops = batch * L * d * (7 * N + 8)
    return nbytes, ops


def cuda_ms(fn, repeats):
    """Median ms of ``repeats`` calls, each timed with CUDA events."""
    times = []
    for _ in range(repeats):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def scan_inputs(batch, L, d, dtype, gen, strided=True):
    """Main-path-like inputs: B/C are column slices of one x_proj output and
    z is the second half of in_proj's output, as mamba_inner_grouped
    passes them."""
    dev = "cuda"
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
    u = rnd(batch, L, d).to(dtype)
    delta = (0.5 * rnd(batch, L, d)).to(dtype)
    rank = max(d // 32, 1)
    x_dbl = rnd(batch, L, rank + 2 * N).to(dtype)
    B, C = x_dbl[..., rank:rank + N], x_dbl[..., rank + N:]
    xz = rnd(batch, L, 2 * d).to(dtype)
    z = xz[..., d:]
    A = -(0.5 + torch.rand(batch, d, N, generator=gen, device=dev))
    D = rnd(batch, d)
    bias = 0.1 * rnd(batch, d)
    if not strided:
        B, C, z = B.contiguous(), C.contiguous(), z.contiguous()
    return u, delta, A, B, C, D, z, bias


def phase_kernels(peaks):
    from vivim_tpu_torch.kernels import refs
    from vivim_tpu_torch.kernels import selective_scan as ss

    bw, fp32 = peaks
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for si, (L, d) in enumerate(STAGES):
        for dtype in (torch.float32, torch.bfloat16):
            args = scan_inputs(SCAN_BATCH, L, d, dtype, gen)
            run = lambda: ss.selective_scan_fwd_cuda(
                *args[:5], D=args[5], z=args[6], delta_bias=args[7],
                delta_softplus=True)
            got, _ = run()
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            want = refs.selective_scan_ref(
                *args[:5], D=args[5], z=args[6], delta_bias=args[7],
                delta_softplus=True)
            t1.record()
            t1.synchronize()
            plain_ms = t0.elapsed_time(t1)
            err = (got.float() - want.float()).abs().max().item()
            rtol, atol = TOL[dtype]
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=rtol, atol=atol)
            run()
            ms = cuda_ms(run, 10 if L > 10000 else 30)
            nbytes, ops = scan_work(SCAN_BATCH, L, d, got.element_size())
            t_bytes, t_ops = nbytes / bw * 1e3, ops / fp32 * 1e3
            row = dict(stage=si, L=L, d=d, dtype=str(dtype).split(".")[-1],
                       max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       mbytes=nbytes / 1e6)
            rows.append(row)
            print(f"K1 stage {si} {row['dtype']:8s} L={L:5d} d={d:4d}: "
                  f"max_abs_err={err:.3e} ms={ms:.4f} "
                  f"plain_ms={plain_ms:.1f} bound_ms={row['bound_ms']:.4f} "
                  f"({row['bound_by']}, {nbytes / 1e6:.1f} MB)", flush=True)
    # ragged L and d, per-batch parameters, initial state and last state
    L, d = 333, 160
    u, delta, A, B, C, D, z, bias = scan_inputs(
        SCAN_BATCH, L, d, torch.float32, gen, strided=False)
    h0 = torch.randn(SCAN_BATCH, d, N, generator=gen, device="cuda")
    got, got_last = ss.selective_scan(
        u, delta, A, B, C, D, z, bias, delta_softplus=True,
        return_last_state=True, initial_state=h0)
    want, want_last = refs.selective_scan_ref(
        u, delta, A, B, C, D, z, bias, delta_softplus=True,
        return_last_state=True, initial_state=h0)
    torch.cuda.synchronize()
    rtol, atol = TOL[torch.float32]
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    torch.testing.assert_close(got_last, want_last, rtol=rtol, atol=atol)
    err = max((got - want).abs().max().item(),
              (got_last - want_last).abs().max().item())
    rows.append(dict(stage="ragged", L=L, d=d, dtype="float32",
                     max_abs_err=err))
    print(f"K1 ragged  float32  L={L} d={d} h0+last: max_abs_err={err:.3e}",
          flush=True)
    return rows


class Requests:
    """The requests of phase 4 as an iterable loader of batch dicts."""

    def __init__(self, batches):
        self.batches = batches
        self.batch_size = batches[0]["clip"].shape[0]

    def __iter__(self):
        return iter(self.batches)


def make_requests(n, clip_len, size, num_classes, seed=0):
    """(1, T, S, S, 3) normalized clips and one-hot (1, T, S, S, C) masks
    of random discs, made by numpy from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    batches = []
    for _ in range(n):
        clip = rng.standard_normal((1, clip_len, size, size, 3), np.float32)
        labels = np.zeros((clip_len, size, size), np.int64)
        for t in range(clip_len):
            for c in range(1, num_classes):
                cy, cx = rng.integers(size // 8, size - size // 8, 2)
                r = rng.integers(size // 16, size // 4)
                labels[t][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = c
        masks = np.eye(num_classes, dtype=np.float32)[labels][None]
        batches.append({"clip": clip, "masks": masks})
    return batches


def phase_serve():
    import argparse
    import dataclasses
    import tempfile

    from vivim_tpu_torch.cli.common import build_model
    from vivim_tpu_torch.cli.infer import run_inference
    from vivim_tpu_torch.kernels import selective_scan as ss
    from vivim_tpu_torch.nn.vivim import Vivim

    n_req, clip_len, size, nc = 4, 5, 256, 3
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        args = argparse.Namespace(
            segformer="b3", num_classes=nc, with_edge=False,
            clip_length=clip_len, image_size=size, output_dir=out_dir,
            save_vis=False, vis_count=0)
        model, cfg = build_model(args, device="cuda", seed=0)
        n_params = sum(p.numel() for p in model.parameters())
        batches = make_requests(n_req, clip_len, size, nc)
        print(f"serve: MiT-b3 Vivim, {n_params / 1e6:.2f} M parameters, "
              f"depths {tuple(cfg.depths)}, built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        torch.cuda.reset_peak_memory_stats()
        ss.LAUNCHES = 0
        results, cm, perf = run_inference(args, model, Requests(batches),
                                          device="cuda")
        launches = ss.LAUNCHES
    per_fwd = sum(cfg.depths)
    if launches != per_fwd * n_req:
        raise AssertionError(f"K1 launched {launches} times for {n_req} "
                             f"forwards, expected {per_fwd * n_req}")
    if int(cm.sum()) != n_req * clip_len * size * size:
        raise AssertionError(f"confusion matrix counts {int(cm.sum())} "
                             "pixels")
    print(f"serve: {n_req} requests of (1, {clip_len}, {size}, {size}, 3): "
          f"K1 launches {launches} ({launches // n_req} per forward), "
          f"fps {perf['fps']:.2f}, per-batch ms "
          f"{perf['avg_batch_time'] * 1e3:.3f} avg, "
          f"{perf['min_batch_time'] * 1e3:.3f} min, "
          f"{perf['max_batch_time'] * 1e3:.3f} max, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"dice mean {results['dice']['mean']:.4f}", flush=True)

    clip0 = torch.from_numpy(batches[0]["clip"]).cuda()
    ref_model = Vivim(dataclasses.replace(cfg, scan_implementation="ref"))
    ref_model.load_state_dict(model.state_dict())
    ref_model = ref_model.cuda().eval()
    with torch.inference_mode():
        got = model(clip0)
        t1 = time.perf_counter()
        want = ref_model(clip0)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t1
    if tuple(got.shape) != (1, clip_len, size, size, nc):
        raise AssertionError(f"logits shape {tuple(got.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("non-finite logits")
    err = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
    print(f"serve: logits vs plain-scan model: max_abs_err={err:.3e} "
          f"(atol 1e-3), |logits| max {want.abs().max().item():.3f}; plain "
          f"forward {ref_s:.1f} s", flush=True)
    phase_profile(model, clip0)
    return launches, perf


def phase_profile(model, clip, n_fwd=3):
    """Device time of ``n_fwd`` forwards by kernel group (torch.profiler),
    and the device's busy share of the window's wall time."""
    from torch.profiler import ProfilerActivity, profile

    # first match wins: cuDNN's conv kernels carry "gemm" in their names
    groups = {"selective_scan_fwd (K1)": ("selective_scan_fwd",),
              "conv": ("conv", "fprop", "winograd"),
              "layout (cudnn nhwc<->nchw)": ("nhwctonchw", "nchwtonhwc"),
              "matmul": ("gemm", "cutlass", "cublas")}
    with torch.inference_mode():
        model(clip)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_fwd):
                model(clip)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n_fwd
    kernels = [(e.name, e.time_range.elapsed_us() / 1e3 / n_fwd)
               for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("profile: no device events recorded", flush=True)
        return
    busy_ms = sum(ms for _, ms in kernels)
    by_group, by_name = {}, {}
    for name, ms in kernels:
        low = name.lower()
        g = next((g for g, keys in groups.items()
                  if any(k in low for k in keys)), "other")
        by_group[g] = by_group.get(g, 0.0) + ms
        by_name[name] = by_name.get(name, 0.0) + ms
    print(f"profile: per forward {wall_ms:.3f} ms wall, {busy_ms:.3f} ms "
          f"device busy ({100 * busy_ms / wall_ms:.1f} %), "
          f"{len(kernels) // n_fwd} kernels", flush=True)
    for g, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"profile: group {g:26s} {ms:9.3f} ms "
              f"({100 * ms / busy_ms:.1f} % of busy)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"profile: kernel {ms:9.3f} ms {name[:90]}")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script runs only on a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vivim_tpu_torch.kernels import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("tf32: cudnn.allow_tf32=False cuda.matmul.allow_tf32=False")

    secs = _build.build_all()
    print(f"build: {secs:.1f} s for {len(_build.SOURCES)} CUDA source(s)")
    for name, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    peaks = card_peaks(kind)

    rows = phase_kernels(peaks)
    launches, _ = phase_serve()

    fp32 = [r for r in rows if r["dtype"] == "float32" and "ms" in r]
    kernels = {"kernels": [{
        "name": "selective_scan_fwd",
        "route": "cuda",
        "source": "vivim_tpu_torch/kernels/csrc/selective_scan_fwd.cu",
        "replaces": f"{JAX_PACKAGE}/kernels/selective_scan.py:174",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows
                           if r["dtype"] == "float32"),
        "per": f"forward: {LAYERS_PER_STAGE} launches at each stage shape, "
               "fp32, each timed alone",
        "ms": sum(LAYERS_PER_STAGE * r["ms"] for r in fp32),
        "plain_ms": sum(LAYERS_PER_STAGE * r["plain_ms"] for r in fp32),
        "bound_ms": sum(LAYERS_PER_STAGE * r["bound_ms"] for r in fp32),
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in fp32)
                     else "operations"),
        "library_ms": None,
        "ok": True,
        "shapes": rows,
    }]}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
