#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vivim_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. build every CUDA kernel of the port from ``vivim_tpu_torch/kernels/csrc``
   with nvcc (sm_90a), one nvcc per source started together, and print the
   build seconds and the ptxas register report;
2. print the card's name and power limit (nvidia-smi), and the exp (MUFU)
   rate the bounds use: 16 per clock per SM x SMs x the max SM clock;
3. hold the chunk-parallel selective-scan forward (K1, inference variant)
   against its plain PyTorch version at the four Vivim-b3 stage shapes of
   a serving forward, fp32 and bf16, printing each shape's parallel chunk
   Lc and grid, and at stage 0 in fp32 with dt near 1e-3; then ragged
   cases that cross the chunk edges (d = 160, L in {1, 17, Lc - 1, Lc + 1,
   333} at the picked Lc and at Lc = 64, an initial state, per-batch
   A / D / bias), with dt near 0.05 (so the carried state counts) in fp32
   and bf16 and near 1e-3 (softplus small) in fp32, output and last state;
3b. hold K1's training variant and the segment-parallel selective-scan
   backward (K2) against their plain versions at the four stage shapes of
   a training step (scan batch 9), fp32 and bf16, K2 on the chunk-start
   states K1 saved, printing each shape's K2 segment Ls, grid and us per
   pass (local, carry, main, sum); the same ragged chunk-edge cases for
   K1-training (output, chunk states, last state) and K2 on its states;
   segment-edge cases for K2 (d = 160, L in {1, 17, 333, 1000} at a forced
   Ls of 16 and 64, per-batch A / D / bias, h0, a non-zero dlast, dt near
   0.05 in fp32 and bf16 and near 1e-3 in fp32) on K1-training's states;
   and a ragged case (L = 333, d = 160) with an initial state, a non-zero
   last-state cotangent and shared A / D / bias, through the autograd
   Function against autograd through the sequential plain scan; print
   error, kernel / plain / bound ms and the bound's binding term (bytes,
   fp32 operations or exps);
4. serve: full-width MiT-b3 Vivim (3 classes, random weights from a seed)
   answers 4 requests of one (1, 5, 256, 256, 3) clip through the port's
   ``run_inference``; K1 must launch 8 times per forward and nothing else,
   the confusion matrix must count every pixel, and one forward's logits
   must agree with the same model on the plain scan; a torch.profiler
   window then splits one forward's device time by kernel group;
5. train: the same model, ``recall_focused``, batch 3: ``Trainer.fit`` for
   one epoch of 4 fp32 steps and a validation pass of 2 batches, then 3
   steps of ``make_train_step`` in bf16; every train step must launch
   K1-training 8 times and K2 8 times, every validation forward the
   inference K1 8 times; loss and grad norm finite; the checkpoint written
   must restore; step ms, clips/s, peak memory and a torch.profiler split
   of one fp32 and one bf16 step by kernel group;
5b. one fp32 step at full width, batch 1, dropouts 0, through the kernels
   and through the plain scan: loss within 1e-5 relative, every
   parameter's gradient within rtol 1e-3 / atol 2e-3;
6. train CLI: write a synthetic tree of 512 x 512 PNGs (4 cases of
   ``CLI_FRAMES`` annotated frames, smooth frames with noise and blob
   masks) in the raw fold layout ``fold_{0,1}/{train,val}/<case>/<n>_x/``,
   each fold's validation set one case; run ``cli.train_folds.main`` (fp32,
   batch 3, clip 5, 256 px, medium augmentation, 4 loader threads, 2
   folds, one epoch each), gather fold 0's training cases with
   ``gather_multiclass_frames(copy=True)`` and run ``cli.train_final.main``
   on them in bf16; the native host ops must be built, every step must
   launch K1-training and K2 8 times and every validation forward the
   inference K1 8 times, losses and grad norms finite, the checkpoints and
   ``metrics.jsonl`` (with val/dice) where the JAX package's CLIs put
   them; print the step ms, the loader's wait per batch and its share of
   the step, clips/s, peak memory, and the bf16 step beside the fp32 one;
7. binary and edge training, the reference's binary-pretrain then
   multiclass fine-tune recipe: write a raw tree of ``BIN_CASES`` cases x
   ``BIN_FRAMES`` 512 px PNG frames, its 2 folds, fold 0's training cases
   gathered, and a polyp tree (``POLYP_VIDEOS`` x ``POLYP_FRAMES``,
   ``Train/<video>/{Frame,GT}``); run (a) ``cli.train_binary.main
   -with_edge true`` on the gathered tree, (b) ``cli.train_polyp.main``,
   (c) ``cli.train_folds.main -with_edge true -pretrain`` (a)'s best
   checkpoint, fp32, batch 3, clip 5, 256 px, one epoch each.  The script
   wraps ``train.binary``'s step and eval-step factories and
   ``BinaryValidator`` (and phase 6's recording Trainer for (c)) to time
   them; every step must launch K1-training and K2 8 times and every
   validation forward the inference K1 8 times, losses finite, the
   checkpoints and ``metrics.jsonl`` where the JAX CLIs put them (with
   val/dice, and for (a) and (b) the S / E / MAE / weighted-F measures),
   and after each fold's ``-pretrain`` every tensor it took equal to the
   checkpoint's, the whole equal-shape overlap taken and ``out.*`` (1 vs 3
   channels) at its init; print the step ms, clips/s, peak memory, the
   validation forward ms and ``BinaryValidator``'s host ms per batch;
8. LM serving: write a snapshot directory with the ``config.json`` of
   state-spaces/mamba-130m (24 layers, d_model 768, vocab 50277 padded to
   50280, RMSNorm, fp32 residual) and a ``pytorch_model.bin`` of the
   port's seeded random init in the reference key layout; (a) load it
   through ``cli.lm_eval_harness.load_lm(hf_dir=...)`` on the card; (b) run
   ``cli.bench_generation.main --hf_dir`` at its defaults (prompt 128, 128
   new tokens, batch 1, top-k 1; ``LM_REPEATS`` timed calls) in float32,
   bfloat16 and int8, printing each JSON line; (c) K1 must launch 24 times
   per generate (the prefill), 0 times in the decode steps, and 24 times per
   fp32 and int8 ``MambaEvalCore`` scoring forward; (d) hold K1 against its
   plain version at (1, 128, 1536) and (1, 37, 1536), fp32 and bf16, output
   and last state, with device ms and bound; (e) the prefill's last logits
   and 32 teacher-forced scores (teacher: the plain-scan model's greedy
   tokens) within 1e-3 of the same model on the plain scan; (f) prefill
   ms, decode ms per token (CUDA events), kernels per token and the
   device's busy share of a decode step (torch.profiler), peak memory;
9. remat, a trainer checkpoint into the infer CLI, and the host tools:
   (a) MiT-b3 Vivim built by the training CLIs' ``build_model`` at each
   ``-remat`` level (none, pre_scan, blocks; dropouts and drop-path on at
   the CLIs' defaults, tanh GELU, fp32), ``REMAT_STEPS`` ``make_train_step``
   steps of batch 3 from one state and generator seed: the first step's
   loss within 1e-5 relative, every gradient within rtol 1e-3 / atol 2e-3
   and the generator's state equal to ``none``'s; K1-training 8 / 8 / 16
   and K2 8 / 8 / 8 launches per step (``blocks`` reruns K1-training in the
   recompute); median step ms and peak memory per level; then ``none`` and
   ``blocks`` at batch ``REMAT_BIG_BATCH``, where ``blocks`` must peak
   lower; (b) ``cli.infer.main`` on phase 6's fold-0 checkpoint directory
   (best before last) over fold 0's raw validation case with ``--gathered
   false`` and ``-cv_group``: ``metrics.json`` holds the run's confusion
   matrix, 8 inference K1 launches per forward, fps and per-batch ms; (c)
   ``cli.bench_loader.main --per_stage`` over phase 6's gathered tree
   (4 threads, one epoch after the warm-up), beside phase 6's loader rate,
   and a ``Trainer.fit`` with ``profile_dir``, which must write one trace
   holding the selective-scan kernels;
10. parallel, two ranks on this card over gloo (spawned processes; which
   collectives gloo runs on CUDA tensors, probed by value, and the bytes
   gathered, printed): (a) from one seeded state at full MiT-b3 width
   (256 px, clip 5, fp32, dropouts 0), one step of each mode on a global
   batch of 4 --
   ``dp2`` (``-n_devices 2``), ``zero2`` (and ZeRO) and ``seq2``
   (``-seq_shards 2``, the batch whole on both ranks) -- held against the
   one-device step of the same state in this process: loss within 1e-5
   relative, every parameter within rtol 1e-3 / atol 2e-3, ``zero2``
   within 2e-4 of ``dp2`` with at most half of its params + moments per
   rank beside the replicated leaves, ``seq2``'s sharded eval logits of
   the seeded state within 1e-3, and the two ranks' parameters and BatchNorm statistics
   equal after the step; K1-training 8, K1-inference 0 and K2 8 per step
   and rank
   (8 inference K1 per sharded forward), asserted; per rank the step ms
   (2 ranks over gloo on one card, not a multi-card figure), peak memory
   and the bytes gathered; (b) ``cli.train_folds.main`` in the two ranks on
   phase 6's tree, fold 0 cut to ``PAR_CLI_CLIPS`` clips per video, with
   ``-n_devices 2 -zero true`` and with ``-seq_shards 2`` (no validation);
   then
   ``cli.infer.main`` on each run's checkpoints on this card;
11. the LM's tensor-parallel and pipeline paths at mamba-130m width
   (phase 8's config and seeded snapshot, fp32): (a) K1-training and K2
   against their plain versions at (2, 128, 1536) and (2, 128, 768), fp32
   and bf16, device ms and bound; ``MambaLM``'s next-token loss at batch 2
   x 128 through the kernels against the same model on the plain scan
   (loss within 1e-5 relative, every gradient within rtol 1e-3 / atol
   2e-3 and each leaf's largest error within ``GRAD_REL`` of its largest
   |grad|, which every leaf halved must fail; 24 K1-training and 24 K2);
   (b) gloo's ``send`` / ``recv`` and ``batch_isend_irecv`` of this
   card's tensors probed by value, each in its own pair of processes; (c)
   two ranks on this card over gloo: tp2 (``lm_tp_forward`` from each
   rank's split: logits within 1e-3, each gradient slice within the
   one-device check's bounds of one device's, the replicated leaves'
   gradients equal on both ranks; ``tp_generate``'s 16 greedy tokens
   equal to one device's; ``bench_generation --tp_shards 2`` in fp32 and
   bf16, int8 refused) and pp2 (``lm_pp_forward`` at 2 microbatches from
   each rank's stage, checked as tp2), and both eval cores' scores of 4
   pairs within 1e-3 of one device's; per rank and mode the launches of
   every run (both gradient runs, all the scoring forwards), all_reduces
   and hops with their bytes, parameters held (a TP eval core: its split
   alone), peak memory and the second call's ms (2 ranks over gloo on one
   card, not a multi-card figure);
12. the MoE-Mamba LM, SegFormer's own model and the int8 check: (a) the
   MoE LM at mamba-130m width and depth (``MOE_CONFIG``: 24 layers,
   d_model 768, vocab 50280, RMSNorm, an MoE block of 8 experts, d_ff 3072,
   after every mixer; about 1.03 B parameters) seeded on the card, fp32,
   tokens (2, 128): a scoring forward (24 K1) with logits within 1e-3, aux
   within 1e-5 relative and every routing decision bit-equal to the same
   model on the plain scan (the smallest top-1 minus top-2 gate printed;
   the gaps of any differing token printed before the phase fails), then
   a gradient step of next-token CE + 1e-2 aux (24 K1-training, 24 K2):
   loss within 1e-5 relative, every gradient within rtol 1e-3 / atol 2e-3
   and ``GRAD_REL`` of its leaf's largest |grad|, which every leaf halved
   must fail; forward and forward + backward ms, peak, profiles; (b) ep2:
   two ranks on this card over gloo, each building the same seeded weights,
   computing the one-device forward and gradients, then keeping its 4 of 8
   experts per block and running ``lm_ep_forward`` + backward twice: logits,
   aux and every gradient under (a)'s bounds, the replicated leaves'
   gradients bit-equal on both ranks, 24 K1-training and 24 K2 per run, 24
   all_gathers of the (8, 40, 768) expert outputs forward and 24
   all_reduces backward, ms and peak per rank; (c) SegFormer-b3 with 150
   labels on one 512 px image: logits within 1e-3 of the CPU's, ms, peak;
   (d) ``cli.int8_eval.main`` at its defaults (d_model 256, 4 layers, 400
   AdamW steps of 32 x 64 tokens, 64 held-out pairs): 4 K1-training and 4 K2
   per step, the trained NLL below ln 32, fp32 / bf16 / int8 NLLs finite,
   their deltas and seconds printed;
13. print the kernels line, the card line and, last, the device line.

Each phase prints its seconds.  Without CUDA the script exits non-zero
before printing any result.  ``--kernels-only`` stops after phase 3b (a
quick check of the kernels on the card).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import torch

# the JAX package whose TPU kernels the port replaces: named, never imported
JAX_PACKAGE = "vivim_tpu_torch".removesuffix("_torch")
N = 16                      # d_state
STAGES = (                  # (L = T*H*W, d_inner) of MiT-b3 Vivim at 5x256^2
    (20480, 128), (5120, 256), (1280, 640), (320, 1024))
LAYERS_PER_STAGE = 2        # MambaLayers per stage: launches per shape
SCAN_BATCH = 3              # three scan directions x batch 1 (serving)
TRAIN_BATCH = 3             # clips per training step (bench.py's batch)
TRAIN_SCAN_BATCH = 3 * TRAIN_BATCH
TOL = {torch.float32: (6e-4, 2e-3), torch.bfloat16: (3e-2, 5e-2)}
GRAD_TOL = {torch.float32: (1e-3, 2e-3), torch.bfloat16: (3e-2, 5e-2)}
# H100 SXM data sheet: HBM3 bytes/s and fp32 (non-tensor-core) FLOP/s
CARDS = {"H100 PCIe": (2.0e12, 51e12), "H200": (4.8e12, 67e12),
         "H100": (3.35e12, 67e12)}
MUFU_PER_CLOCK_PER_SM = 16  # ex2 results; compute capability 9.0
GRADS = ("ddelta", "du", "dB", "dC", "dA", "dD", "dbias", "dh0")
TIMING = ("ms: device time per call (CUDA-graph replay), call_ms: one eager "
          "call with its launch (CUDA events); earlier versions of this "
          "script reported the eager call as ms")
RAGGED_D = 160
# delta shifts of the chunk-edge cases: dt near 0.05, so the state carried
# across a chunk edge is not decayed to nothing, and dt near 1e-3 (the floor
# of the dt init), where softplus must stay accurate while small
EDGE_CASES = ((torch.float32, -3.0), (torch.bfloat16, -3.0),
              (torch.float32, -7.0))
# K2's segment-edge cases: lengths at a forced segment length Ls
SEGMENT_EDGES = tuple((L, ls) for L in (1, 17, 333, 1000) for ls in (16, 64))
# phase 6: cases of the synthetic PNG tree, annotated frames per case (24
# clips of 5: a fold trains on 3 cases, 72 clips, 24 steps of batch 3, so
# an epoch runs past what the loader can decode ahead, 10 batches, by the
# 10 that the wait summary needs) and the source frame size
CLI_CASES = 4
CLI_FRAMES = 120
CLI_SOURCE = 512
# phase 7: raw cases of annotated frames (2 folds, each training on 2
# cases; the binary run on fold 0's 2), and the polyp tree's videos x frames
BIN_CASES = 3
BIN_FRAMES = 30
POLYP_VIDEOS = 2
POLYP_FRAMES = 12
# phase 8: the config.json of state-spaces/mamba-130m, the generation
# bench's defaults (prompt 128, 128 new tokens, batch 1, top-k 1), a ragged
# prompt for K1, and the tokens of the end-to-end check against the plain
# scan and of the decode timing
LM_CONFIG = {"d_model": 768, "n_layer": 24, "vocab_size": 50277,
             "ssm_cfg": {}, "rms_norm": True, "residual_in_fp32": True,
             "fused_add_norm": True, "pad_vocab_size_multiple": 8}
LM_PROMPT = 128
LM_GEN = 128
# bench_generation's timed repeats after its warm-up call: 1, not its
# default 3, to keep the script near 400 s (3 took phase 8 to 64 s)
LM_REPEATS = 1
LM_RAGGED = 37
LM_DTYPES = ("float32", "bfloat16", "int8")
LM_E2E_GEN = 32
LM_DECODE_STEPS = 16
# phase 9: make_train_step steps per remat level at the training batch (the
# first checked against none's, the median over the rest), and at the
# larger batch where the memory remat saves shows
REMAT_STEPS = 4
REMAT_BIG_BATCH = 12
REMAT_BIG_STEPS = 3
# phase 10: the global batch of each mode's step, the clips per video of
# the two train_folds runs (3 steps of fold 0), the runs' flags (the seq
# run skips its validation, for time: (a) holds the sharded forward), the
# gloo timeout of the ranks and their wall limit (s)
PAR_BATCH = 4
PAR_CLI_CLIPS = 4
PAR_CLI_RUNS = {"zero2": ["-n_devices", "2", "-zero", "true"],
                "seq2": ["-seq_shards", "2", "-val_freq", "2"]}
PAR_GROUP_TIMEOUT_S = 60
PAR_WALL_S = 300
# phase 11: the LM's model-parallel paths at mamba-130m width: the batch,
# prompt and microbatches of the gradient checks, the new tokens of
# tp_generate and of the TP bench lines, the scored (context,
# continuation) pairs, the wall limit of the ranks (s) and of a p2p probe;
# 16 new tokens, not 32, since phase 12 took the script past 600 s
LMP_BATCH = 2
LMP_PROMPT = 128
LMP_MICRO = 2
LMP_GEN = 16
LMP_PAIRS = 4
LMP_WALL_S = 420
P2P_WALL_S = 60
# a gradient leaf's largest error over its largest |grad| (phases 11, 12)
GRAD_REL = 1e-3
LMP_LABEL = "2 ranks over gloo on one card, not a multi-card figure"
# phase 12: the MoE-Mamba LM (moe-mamba130m-e8: state-spaces/mamba-130m's
# widths and RMSNorm, MoEMambaLMConfig's own MoE defaults), its batch and
# tokens, the wall limit of its two expert-parallel ranks (s); SegFormer's
# image size and labels (ADE20k's 150)
MOE_CONFIG = dict(vocab_size=50277, d_model=768, n_layer=24, d_state=16,
                  rms_norm=True, moe_every=1, n_experts=8, d_ff=None,
                  capacity_factor=1.25, top_k=1, aux_loss_weight=1e-2)
MOE_BATCH = 2
MOE_PROMPT = 128
MOE_WALL_S = 300
SEG_SIZE = 512
SEG_LABELS = 150


def nvidia_smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(
            ).splitlines()[0]


def card_peaks(name):
    """(HBM bytes/s, fp32 FLOP/s, exps/s); the exp (MUFU) rate from this
    card's SM count and max SM clock."""
    for key, (bw, flops) in CARDS.items():
        if key in name:
            break
    else:
        raise RuntimeError(f"no peak figures for card {name!r}")
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mufu = MUFU_PER_CLOCK_PER_SM * sms * mhz * 1e6
    print(f"peaks: {bw / 1e12:.2f} TB/s, {flops / 1e12:.0f} TFLOP/s fp32, "
          f"{mufu / 1e12:.3f} T exp/s = {MUFU_PER_CLOCK_PER_SM} x {sms} SMs "
          f"x {mhz:.0f} MHz max SM clock", flush=True)
    return bw, flops, mufu


def bound(work, peaks):
    """(bound ms, bound_by "bytes" or "operations", binding term "bytes",
    "fp32" or "exp") of work = (bytes, fp32 operations, exps): the largest
    of bytes over the memory rate, operations over the fp32 rate and exps
    over the exp unit's rate."""
    terms = {"bytes": work[0] / peaks[0], "fp32": work[1] / peaks[1],
             "exp": work[2] / peaks[2]}
    term = max(terms, key=terms.get)
    return (terms[term] * 1e3, "bytes" if term == "bytes" else "operations",
            term)


def scan_work(batch, L, d, elem):
    """(bytes, fp32 operations, exps) of K1's inference variant: it reads u,
    delta, z, B, C and writes y; per state and step one exp and about six
    other operations, per channel and step about eight."""
    nbytes = (batch * L * (4 * d + 2 * N) * elem       # u, delta, z, y, B, C
              + batch * d * (2 * N + 2) * 4)            # A, last, D, bias
    return nbytes, batch * L * d * (6 * N + 8), batch * L * d * N


def train_fwd_work(batch, L, d, elem, chunk):
    """K1, training variant: reads u, delta, B, C, writes y and the chunk
    states, and the last state; no z."""
    nbytes = (batch * L * (3 * d + 2 * N) * elem
              + batch * -(-L // chunk) * d * N * 4
              + batch * d * (2 * N + 2) * 4)
    return nbytes, batch * L * d * (6 * N + 4), batch * L * d * N


def bwd_work(batch, L, d, elem, chunk):
    """K2, as the training step calls it (no dlast): reads u, delta, dy, B,
    C and the chunk states, writes ddelta, du, dB, dC and the per-batch
    parameter grads.  One exp per state and step: the recompute's h_t and
    the adjoint's g_{t-1} use the same exp(dt_t A); about 19 other
    operations per state and step and 20 per channel and step."""
    nbytes = (batch * L * (5 * d + 4 * N) * elem
              + batch * -(-L // chunk) * d * N * 4
              + batch * d * (2 * N + 2 + 4) * 4)      # A, D, bias; grads
    return nbytes, batch * L * d * (19 * N + 20), batch * L * d * N


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


def device_ms(fn, calls=10, repeats=5):
    """Device ms per call of ``fn``: ``calls`` calls captured back to back
    in one CUDA graph, the graph replayed and timed with CUDA events
    (median of ``repeats``).  The host's time to prepare and launch each
    call does not count, so this is the kernels' own time (with the gaps
    between them)."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    ms = cuda_ms(graph.replay, repeats) / calls
    del graph
    return ms


def kernel_split(fn, calls=3):
    """Device us per launch of each CUDA kernel of ``fn`` (torch.profiler
    over ``calls`` calls), keyed by a short name: K1's passes "local",
    "carry" and "out", K2's "local", "carry", "main", "sum" (dB / dC) and
    "sum_params".  Each is the mean over the events recorded for its key,
    since the profiler may record fewer launches than were made."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, count = {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name
        if "selective_scan_fwd_carry" in name:
            key = "carry"
        elif "selective_scan_fwd_chunk" in name:
            key = ("local" if re.search(r"chunk_kernel<[^,]+, 0,", name)
                   else "out")
        elif "selective_scan_bwd_local" in name:
            key = "local"
        elif "selective_scan_bwd_carry" in name:
            key = "carry"
        elif "selective_scan_bwd_kernel" in name:
            key = "main"
        elif "selective_scan_bwd_sum_params" in name:
            key = "sum_params"
        elif "sum_partials" in name:
            key = "sum"
        else:
            key = name.split("(")[0][-40:]
        total[key] = total.get(key, 0.0) + e.time_range.elapsed_us()
        count[key] = count.get(key, 0) + 1
    return {k: total[k] / count[k] for k in total}


def split_text(split):
    return (", ".join(f"{k} {v:.1f} us" for k, v in split.items())
            or "no device events recorded")


def once_ms(fn):
    """(fn(), ms) of one call timed with CUDA events."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    e1.synchronize()
    return out, e0.elapsed_time(e1)


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


def dtype_name(dtype):
    return str(dtype).split(".")[-1]


def sm_count():
    return torch.cuda.get_device_properties(0).multi_processor_count


def picked_chunk(batch, L, d):
    """(Lc, grid) K1's wrapper picks for a shape on this card."""
    from vivim_tpu_torch.kernels import selective_scan as ss

    threads = ss.fwd_threads()
    lc = ss.fwd_l_chunk(batch, L, d, sm_count(), threads)
    return lc, ss.fwd_grid(batch, L, d, lc, threads)


def picked_segment(batch, L, d):
    """(Ls, grid) K2's wrapper picks for a shape on this card."""
    from vivim_tpu_torch.kernels import selective_scan as ss

    channels = ss.bwd_channels()
    ls = ss.bwd_l_seg(batch, L, d, sm_count(), channels)
    return ls, ss.bwd_grid(batch, L, d, ls, channels)


def grid_text(lc, grid, what="Lc"):
    return (f"{what}={lc} grid={grid[0]}x{grid[1]}x{grid[2]} "
            f"({grid[0] * grid[1] * grid[2]} blocks)")


def chunk_edge_cases(batch):
    """(L, forced Lc or None) at d = RAGGED_D that cross K1's chunk edges:
    L in {1, 17, Lc - 1, Lc + 1, 333} at the Lc the wrapper picks for
    L = 333 and at a forced Lc = 64."""
    cases = []
    for forced in (None, 64):
        lc = forced or picked_chunk(batch, 333, RAGGED_D)[0]
        for L in (1, 17, lc - 1, lc + 1, 333):
            if (L, forced) not in cases:
                cases.append((L, forced))
    return cases


def scaled_err(got, want):
    """Largest error over the largest magnitude, of all the pairs."""
    return max((g.float() - w.float()).abs().max().item()
               / max(w.float().abs().max().item(), 1e-30)
               for g, w in zip(got, want))


def phase_kernels(peaks):
    """K1 (inference variant) against its plain version at the serving
    stage shapes (and at stage 0 with dt near 1e-3), the chunk-edge cases
    and a ragged call through the dispatch."""
    from vivim_tpu_torch.kernels import refs
    from vivim_tpu_torch.kernels import selective_scan as ss

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for si, (L, d) in enumerate(STAGES):
        lc, grid = picked_chunk(SCAN_BATCH, L, d)
        for dtype in (torch.float32, torch.bfloat16):
            args = scan_inputs(SCAN_BATCH, L, d, dtype, gen)
            run = lambda: ss.selective_scan_fwd_cuda(
                *args[:5], D=args[5], z=args[6], delta_bias=args[7],
                delta_softplus=True)
            got, _ = run()
            torch.cuda.synchronize()
            want, plain_ms = once_ms(lambda: refs.selective_scan_ref(
                *args[:5], D=args[5], z=args[6], delta_bias=args[7],
                delta_softplus=True))
            err = (got.float() - want.float()).abs().max().item()
            rtol, atol = TOL[dtype]
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=rtol, atol=atol)
            run()
            call_ms = cuda_ms(run, 10 if L > 10000 else 30)
            ms = device_ms(run)
            split = kernel_split(run)
            work = scan_work(SCAN_BATCH, L, d, got.element_size())
            bound_ms, bound_by, term = bound(work, peaks)
            row = dict(stage=si, L=L, d=d, dtype=dtype_name(dtype),
                       l_chunk=lc, grid=grid, max_abs_err=err, ms=ms,
                       call_ms=call_ms, split_us=split, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       bound_term=term, mbytes=work[0] / 1e6)
            rows.append(row)
            print(f"K1 stage {si} {row['dtype']:8s} L={L:5d} d={d:4d} "
                  f"{grid_text(lc, grid)}: max_abs_err={err:.3e} "
                  f"ms={ms:.4f} (one call with its launch {call_ms:.4f}; "
                  f"{split_text(split)}) plain_ms={plain_ms:.1f} "
                  f"bound_ms={bound_ms:.4f} ({term}; {work[0] / 1e6:.1f} "
                  f"MB, {work[2] / 1e6:.0f} M exps)", flush=True)
            del args, got, want
    # stage 0 with dt near 1e-3: softplus small, states built over
    # thousands of steps
    L, d = STAGES[0]
    lc, grid = picked_chunk(SCAN_BATCH, L, d)
    u, delta, A, B, C, D, z, bias = scan_inputs(SCAN_BATCH, L, d,
                                                torch.float32, gen)
    got = ss.selective_scan_fwd_cuda(u, delta - 7.0, A, B, C, D, z, bias,
                                     True)
    want = refs.selective_scan_ref(u, delta - 7.0, A, B, C, D, z, bias, True,
                                   True)
    torch.cuda.synchronize()
    for what, g, w in zip(("y", "last"), got, want):
        torch.testing.assert_close(g, w, rtol=TOL[torch.float32][0],
                                   atol=TOL[torch.float32][1],
                                   msg=f"K1 stage 0 small dt {what}")
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    rows.append(dict(stage="0, dt near 1e-3", L=L, d=d, dtype="float32",
                     l_chunk=lc, max_abs_err=err))
    print(f"K1 stage 0 float32  L={L} d={d} {grid_text(lc, grid)}, dt near "
          f"1e-3: y, last max_abs_err={err:.3e}, scaled "
          f"{scaled_err(got, want):.3e}", flush=True)
    del u, delta, B, C, z, got, want
    # chunk edges: ragged L and d, per-batch parameters, strided B/C/z,
    # an initial state; output and last state
    for L, forced in chunk_edge_cases(SCAN_BATCH):
        lc = forced or picked_chunk(SCAN_BATCH, L, RAGGED_D)[0]
        for dtype, shift in EDGE_CASES:
            u, delta, A, B, C, D, z, bias = scan_inputs(
                SCAN_BATCH, L, RAGGED_D, dtype, gen)
            delta = delta + shift
            h0 = torch.randn(SCAN_BATCH, RAGGED_D, N, generator=gen,
                             device="cuda")
            y, _, last = ss._fwd_launch(u, delta, A, B, C, D, z, bias, True,
                                        h0, False, forced)
            got = (y, last)
            want = refs.selective_scan_ref(u, delta, A, B, C, D, z, bias,
                                           True, True, h0)
            torch.cuda.synchronize()
            rtol, atol = TOL[dtype]
            for what, g, w in zip(("y", "last"), got, want):
                torch.testing.assert_close(
                    g.float(), w.float(), rtol=rtol, atol=atol,
                    msg=f"K1 chunk edge L={L} Lc={lc} shift {shift} {what}")
            err = max((g.float() - w.float()).abs().max().item()
                      for g, w in zip(got, want))
            rows.append(dict(stage="chunk edge", L=L, d=RAGGED_D,
                             dtype=dtype_name(dtype), l_chunk=lc,
                             delta_shift=shift, max_abs_err=err))
            print(f"K1 chunk edge {dtype_name(dtype):8s} L={L:3d} "
                  f"d={RAGGED_D} Lc={lc:3d} h0, delta {shift:+.0f}: y, last "
                  f"max_abs_err={err:.3e}, scaled {scaled_err(got, want):.3e}",
                  flush=True)
    # ragged L and d through the dispatch, initial state and last state
    L, d = 333, RAGGED_D
    u, delta, A, B, C, D, z, bias = scan_inputs(
        SCAN_BATCH, L, d, torch.float32, gen, strided=False)
    h0 = torch.randn(SCAN_BATCH, d, N, generator=gen, device="cuda")
    with torch.no_grad():
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


def check_train_pair(u, delta, A, B, C, D, bias, h0, dout, dlast, dtype,
                     l_chunk, what, l_seg=None):
    """K1-training against its plain version (output, chunk states, last
    state), then K2 on the chunk states K1 saved against its plain version
    on the same states; returns (K1 error, K2 error, K1's chunk states,
    the two plain versions' ms).  ``l_chunk`` forces K1's parallel chunk
    and ``l_seg`` K2's segment (None: the ones the wrappers pick)."""
    from vivim_tpu_torch.kernels import refs
    from vivim_tpu_torch.kernels import selective_scan as ss

    got = ss._fwd_launch(u, delta, A, B, C, D, None, bias, True, h0, True,
                         l_chunk)
    torch.cuda.synchronize()
    want, fwd_plain = once_ms(lambda: refs.selective_scan_fwd_states_ref(
        u, delta, A, B, C, D, bias, True, h0, chunk=ss.CHUNK))
    rtol, atol = TOL[dtype]
    for name, g, w in zip(("y", "chunk states", "last"), got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                   atol=atol, msg=f"K1-train {what} {name}")
    fwd_err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
    cs = got[1]
    got_b = ss._bwd_launch(u, delta, A, B, C, D, bias, cs, dout, dlast, True,
                           l_seg)
    torch.cuda.synchronize()
    want_b, bwd_plain = once_ms(lambda: refs.selective_scan_bwd_ref(
        u, delta, A, B, C, D, bias, cs, dout, dlast, True, chunk=ss.CHUNK))
    rtol, atol = GRAD_TOL[dtype]
    for name, g, w in zip(GRADS, got_b, want_b):
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                   atol=atol, msg=f"K2 {what} {name}")
    bwd_err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got_b, want_b))
    return fwd_err, bwd_err, cs, fwd_plain, bwd_plain


def train_kernel_rows(peaks, shapes, b, gen, label, reps=20):
    """K1-training and K2 at (b, L, d) for each (tag, L, d) of ``shapes``,
    fp32 and bf16, each against its plain version (K2 on the chunk states
    K1 saved): (K1-training rows, K2 rows) with error, device ms, one
    eager call's ms, plain ms, bound, Lc / Ls, grid and us per pass.
    ``reps``: CUDA-event repeats of the eager call, or a function of L."""
    from vivim_tpu_torch.kernels import selective_scan as ss

    fwd_rows, bwd_rows = [], []
    for tag, L, d in shapes:
        lc, grid = picked_chunk(b, L, d)
        ls, bgrid = picked_segment(b, L, d)
        for dtype in (torch.float32, torch.bfloat16):
            u, delta, A, B, C, D, _, bias = scan_inputs(b, L, d, dtype, gen)
            dout = torch.randn(b, L, d, generator=gen, device="cuda").to(
                dtype)
            fwd_err, bwd_err, cs, fwd_plain, bwd_plain = check_train_pair(
                u, delta, A, B, C, D, bias, None, dout, None, dtype, None,
                f"{label} {tag} {dtype_name(dtype)}")
            fwd = lambda: ss.selective_scan_fwd_states_cuda(
                u, delta, A, B, C, D, bias, True)
            bwd = lambda: ss.selective_scan_bwd_cuda(
                u, delta, A, B, C, D, bias, cs, dout, None, True)
            n_reps = reps(L) if callable(reps) else reps
            elem = u.element_size()
            for rows, kind, err, run, plain, work, extra, text in (
                    (fwd_rows, "K1-train", fwd_err, fwd, fwd_plain,
                     train_fwd_work(b, L, d, elem, ss.CHUNK),
                     dict(l_chunk=lc, grid=grid, split_us=kernel_split(fwd)),
                     grid_text(lc, grid)),
                    (bwd_rows, "K2", bwd_err, bwd, bwd_plain,
                     bwd_work(b, L, d, elem, ss.CHUNK),
                     dict(l_seg=ls, grid=bgrid, split_us=kernel_split(bwd)),
                     grid_text(ls, bgrid, "Ls"))):
                call_ms, ms = cuda_ms(run, n_reps), device_ms(run, calls=5)
                bound_ms, bound_by, term = bound(work, peaks)
                rows.append(dict(stage=tag, L=L, d=d, dtype=dtype_name(dtype),
                                 max_abs_err=err, ms=ms, call_ms=call_ms,
                                 plain_ms=plain, bound_ms=bound_ms,
                                 bound_by=bound_by, bound_term=term,
                                 mbytes=work[0] / 1e6, **extra))
                print(f"{kind:8s} {label} {tag} {dtype_name(dtype):8s} "
                      f"b={b} L={L:5d} d={d:4d} {text}: max_abs_err="
                      f"{err:.3e} ms={ms:.4f} (one call with its launch "
                      f"{call_ms:.4f}; {split_text(extra['split_us'])}) "
                      f"plain_ms={plain:.1f} bound_ms={bound_ms:.4f} "
                      f"({term}; {work[0] / 1e6:.1f} MB, "
                      f"{work[2] / 1e6:.0f} M exps)", flush=True)
            del u, delta, B, C, dout, cs
    return fwd_rows, bwd_rows


def phase_train_kernels(peaks):
    """K1's training variant and K2 at the training step's stage shapes,
    each against its plain version on the same inputs (K2 on the chunk
    states K1 saved), the chunk-edge cases, and a ragged case through the
    autograd Function."""
    from vivim_tpu_torch.kernels import selective_scan as ss

    gen = torch.Generator(device="cuda").manual_seed(1)
    b = TRAIN_SCAN_BATCH
    fwd_rows, bwd_rows = train_kernel_rows(
        peaks, [(si, L, d) for si, (L, d) in enumerate(STAGES)], b, gen,
        "stage", reps=lambda L: 5 if L > 10000 else 20)
    # chunk edges: ragged L and d, per-batch parameters, an initial state,
    # a non-zero dlast; K1-training, then K2 on its chunk states
    for L, forced in chunk_edge_cases(b):
        lc = forced or picked_chunk(b, L, RAGGED_D)[0]
        for dtype, shift in EDGE_CASES:
            u, delta, A, B, C, D, _, bias = scan_inputs(b, L, RAGGED_D,
                                                        dtype, gen)
            delta = delta + shift
            h0 = torch.randn(b, RAGGED_D, N, generator=gen, device="cuda")
            dout = torch.randn(b, L, RAGGED_D, generator=gen,
                               device="cuda").to(dtype)
            dlast = torch.randn(b, RAGGED_D, N, generator=gen, device="cuda")
            fwd_err, bwd_err = check_train_pair(
                u, delta, A, B, C, D, bias, h0, dout, dlast, dtype, forced,
                f"chunk edge L={L} Lc={lc} delta {shift:+.0f} "
                f"{dtype_name(dtype)}")[:2]
            for rows, err in ((fwd_rows, fwd_err), (bwd_rows, bwd_err)):
                rows.append(dict(stage="chunk edge", L=L, d=RAGGED_D,
                                 dtype=dtype_name(dtype), l_chunk=lc,
                                 delta_shift=shift, max_abs_err=err))
            print(f"K1-train+K2 chunk edge {dtype_name(dtype):8s} b={b} "
                  f"L={L:3d} d={RAGGED_D} Lc={lc:3d} h0, dlast, delta "
                  f"{shift:+.0f}: K1 max_abs_err={fwd_err:.3e}, K2 on its "
                  f"states {bwd_err:.3e}", flush=True)
    # segment edges: K2 with its segment forced, on K1-training's states;
    # ragged L and d, per-batch parameters, an initial state, a non-zero
    # dlast
    for L, forced in SEGMENT_EDGES:
        for dtype, shift in EDGE_CASES:
            u, delta, A, B, C, D, _, bias = scan_inputs(b, L, RAGGED_D,
                                                        dtype, gen)
            delta = delta + shift
            h0 = torch.randn(b, RAGGED_D, N, generator=gen, device="cuda")
            dout = torch.randn(b, L, RAGGED_D, generator=gen,
                               device="cuda").to(dtype)
            dlast = torch.randn(b, RAGGED_D, N, generator=gen, device="cuda")
            bwd_err = check_train_pair(
                u, delta, A, B, C, D, bias, h0, dout, dlast, dtype, None,
                f"segment edge L={L} Ls={forced} delta {shift:+.0f} "
                f"{dtype_name(dtype)}", l_seg=forced)[1]
            bwd_rows.append(dict(stage="segment edge", L=L, d=RAGGED_D,
                                 dtype=dtype_name(dtype), l_seg=forced,
                                 delta_shift=shift, max_abs_err=bwd_err))
            print(f"K2 segment edge {dtype_name(dtype):8s} b={b} L={L:4d} "
                  f"d={RAGGED_D} Ls={forced:2d} h0, dlast, delta "
                  f"{shift:+.0f}: max_abs_err={bwd_err:.3e}", flush=True)
    # ragged: L = 333, d = 160 (ten K2 blocks), shared A / D / bias (the
    # batch-sum path), an initial state and a non-zero dlast; the whole
    # Function against autograd through the sequential plain scan
    L, d = 333, 160
    u, delta, A, B, C, D, z, bias = scan_inputs(b, L, d, torch.float32, gen,
                                                strided=False)
    leaves0 = dict(u=u, delta=delta, A=A[0], B=B, C=C, D=D[0], z=z,
                   delta_bias=bias[0],
                   initial_state=torch.randn(b, d, N, generator=gen,
                                             device="cuda"))
    dout = torch.randn(b, L, d, generator=gen, device="cuda")
    dlast = torch.randn(b, d, N, generator=gen, device="cuda")
    outs = []
    for impl in (None, "ref"):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in leaves0.items()}
        kw = dict(leaves)
        c0 = (ss.TRAIN_LAUNCHES, ss.BWD_LAUNCHES)
        y, last = ss.selective_scan(
            kw.pop("u"), kw.pop("delta"), kw.pop("A"), kw.pop("B"),
            kw.pop("C"), delta_softplus=True, return_last_state=True,
            implementation=impl, **kw)
        torch.autograd.backward((y, last), (dout, dlast))
        launched = (ss.TRAIN_LAUNCHES - c0[0], ss.BWD_LAUNCHES - c0[1])
        if launched != ((1, 1) if impl is None else (0, 0)):
            raise AssertionError(f"ragged call ({impl}) launched "
                                 f"K1-training / K2 {launched} times")
        outs.append(dict(y=y.detach(), last=last.detach(),
                         **{f"d{k}": v.grad for k, v in leaves.items()}))
    torch.cuda.synchronize()
    err = 0.0
    for k, g in outs[0].items():
        rtol, atol = (TOL if k in ("y", "last") else GRAD_TOL)[torch.float32]
        torch.testing.assert_close(g, outs[1][k], rtol=rtol, atol=atol,
                                   msg=f"ragged {k}")
        err = max(err, (g - outs[1][k]).abs().max().item())
    print(f"K1-train+K2 ragged float32 b={b} L={L} d={d}, shared A/D/bias, "
          f"h0, dlast: y, last and 9 grads vs autograd through the plain "
          f"scan: max_abs_err={err:.3e}", flush=True)
    return fwd_rows, bwd_rows, err


class Requests:
    """In-memory batches of numpy dicts as an iterable loader."""

    def __init__(self, batches):
        self.batches = batches
        self.batch_size = batches[0]["clip"].shape[0]

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def make_requests(n, clip_len, size, num_classes, seed=0, batch=1):
    """(batch, T, S, S, 3) normalized clips and one-hot (batch, T, S, S, C)
    masks of random discs, made by numpy from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    batches = []
    for _ in range(n):
        clip = rng.standard_normal((batch, clip_len, size, size, 3),
                                   np.float32)
        labels = np.zeros((batch, clip_len, size, size), np.int64)
        for b in range(batch):
            for t in range(clip_len):
                for c in range(1, num_classes):
                    cy, cx = rng.integers(size // 8, size - size // 8, 2)
                    r = rng.integers(size // 16, size // 4)
                    labels[b, t][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = c
        masks = np.eye(num_classes, dtype=np.float32)[labels]
        batches.append({"clip": clip, "masks": masks})
    return batches


def counts():
    from vivim_tpu_torch.kernels import selective_scan as ss

    return {"K1 inference": ss.LAUNCHES, "K1 training": ss.TRAIN_LAUNCHES,
            "K2": ss.BWD_LAUNCHES}


def reset_counts():
    from vivim_tpu_torch.kernels import selective_scan as ss

    ss.LAUNCHES = ss.TRAIN_LAUNCHES = ss.BWD_LAUNCHES = 0


def model_args(segformer, nc=3):
    return argparse.Namespace(segformer=segformer, num_classes=nc,
                              with_edge=False)


def phase_serve(segformer="b3", size=256, clip_len=5, n_req=4):
    from vivim_tpu_torch.cli.common import build_model
    from vivim_tpu_torch.cli.infer import run_inference
    from vivim_tpu_torch.nn.vivim import Vivim

    nc = 3
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        args = argparse.Namespace(
            **vars(model_args(segformer, nc)), clip_length=clip_len,
            image_size=size, output_dir=out_dir, save_vis=False,
            vis_count=0)
        model, cfg = build_model(args, device="cuda", seed=0)
        n_params = sum(p.numel() for p in model.parameters())
        batches = make_requests(n_req, clip_len, size, nc)
        print(f"serve: MiT-{segformer} Vivim, {n_params / 1e6:.2f} M "
              f"parameters, depths {tuple(cfg.depths)}, built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        results, cm, perf = run_inference(args, model, Requests(batches),
                                          device="cuda")
        launched = counts()
    per_fwd = sum(cfg.depths)
    if launched != {"K1 inference": per_fwd * n_req, "K1 training": 0,
                    "K2": 0}:
        raise AssertionError(f"serving {n_req} forwards launched "
                             f"{launched}; expected {per_fwd} inference K1 "
                             "launches per forward and nothing else")
    if int(cm.sum()) != n_req * clip_len * size * size:
        raise AssertionError(f"confusion matrix counts {int(cm.sum())} "
                             "pixels")
    print(f"serve: {n_req} requests of (1, {clip_len}, {size}, {size}, 3): "
          f"launches {launched} ({per_fwd} K1 per forward), "
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

    def forward():
        with torch.inference_mode():
            model(clip0)

    phase_profile("serve forward", forward)
    return launched, perf


# first match wins: cuDNN's conv kernels carry "gemm" in their names
PROFILE_GROUPS = {
    "selective_scan_bwd (K2)": ("selective_scan_bwd", "sum_partials"),
    "selective_scan_fwd (K1)": ("selective_scan_fwd",),
    "conv": ("conv", "fprop", "dgrad", "wgrad", "winograd"),
    "layout (cudnn nhwc<->nchw)": ("nhwctonchw", "nchwtonhwc"),
    "matmul": ("gemm", "cutlass", "cublas"),
}


def phase_profile(label, run, n_runs=3):
    """Device time of ``n_runs`` calls of ``run`` by kernel group
    (torch.profiler), and the device's busy share of the window's wall
    time.  Returns {wall_ms, busy_ms, busy_share, kernels} per call, or
    None when the profiler recorded no device event."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_runs):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_runs
    kernels = [(e.name, e.time_range.elapsed_us() / 1e3 / n_runs)
               for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"profile {label}: no device events recorded", flush=True)
        return None
    busy_ms = sum(ms for _, ms in kernels)
    by_group, by_name = {}, {}
    for name, ms in kernels:
        low = name.lower()
        g = next((g for g, keys in PROFILE_GROUPS.items()
                  if any(k in low for k in keys)), "other")
        by_group[g] = by_group.get(g, 0.0) + ms
        by_name[name] = by_name.get(name, 0.0) + ms
    print(f"profile {label}: per call {wall_ms:.3f} ms wall, {busy_ms:.3f} "
          f"ms device busy ({100 * busy_ms / wall_ms:.1f} %), "
          f"{len(kernels) // n_runs} kernels", flush=True)
    for g, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"profile {label}: group {g:26s} {ms:9.3f} ms "
              f"({100 * ms / busy_ms:.1f} % of busy)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"profile {label}: kernel {ms:9.3f} ms {name[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms,
            "kernels": len(kernels) // n_runs}


def _recorded(fn, log, dev):
    """``fn`` that appends (ms, launches, result) of each call to
    ``log``; CUDA-event time on the card, host time on the CPU."""
    from vivim_tpu_torch.cli.infer import _timed

    def run(*args):
        c0 = counts()
        out, secs = _timed(dev, lambda: fn(*args))
        log.append((secs * 1e3, {k: v - c0[k] for k, v in counts().items()},
                    out))
        return out

    return run


def _check_launches(log, want, what):
    for i, (_, launched, _) in enumerate(log):
        if launched != want:
            raise AssertionError(f"{what} {i} launched {launched}, "
                                 f"expected {want}")


def _step_summary(label, log, batch):
    ms = [m for m, _, _ in log[1:]] or [log[0][0]]
    med = statistics.median(ms)
    print(f"train {label}: {len(log)} steps of batch {batch}, step ms "
          f"{log[0][0]:.1f} first, {min(ms):.3f} min, {med:.3f} median "
          f"over the rest; {batch / med * 1e3:.3f} clips/s; losses "
          + ", ".join(f"{float(o[1]['loss']):.4f}" for _, _, o in log)
          + ("; grad norms " + ", ".join(
              f"{float(o[1]['grad_norm']):.4f}" for _, _, o in log)
             if "grad_norm" in log[0][2][1] else ""),  # the binary step's
          flush=True)
    return {"steps": len(log), "first_ms": log[0][0], "min_ms": min(ms),
            "median_ms": med, "clips_per_s": batch / med * 1e3}


def phase_train(dev="cuda", segformer="b3", size=256, clip_len=5,
                batch=TRAIN_BATCH, n_steps=4, n_val=2, n_bf16=3):
    """Trainer.fit (fp32) with a validation pass, then bf16 steps."""
    from vivim_tpu_torch.cli.common import build_model
    from vivim_tpu_torch.train import loop
    from vivim_tpu_torch.train.logging import MetricLogger
    from vivim_tpu_torch.train.trainer import Trainer, TrainerConfig

    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    model, cfg = build_model(model_args(segformer), device=dev, seed=0)
    per_pass = sum(cfg.depths)
    train = make_requests(n_steps, clip_len, size, 3, seed=1, batch=batch)
    val = make_requests(n_val, clip_len, size, 3, seed=2, batch=batch)
    steps, evals = [], []
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(
            model, TrainerConfig(epochs=1, log_every=1, seed=0,
                                 device=str(dev)),
            Requests(train), Requests(val), os.path.join(tmp, "ckpt"),
            MetricLogger(os.path.join(tmp, "logs")))
        trainer.train_step = _recorded(trainer.train_step, steps, dev)
        trainer.eval_step = _recorded(trainer.eval_step, evals, dev)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        trainer.fit()
        fit_s = time.perf_counter() - t0
        launched = counts()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        if on_card:
            _check_launches(steps, {"K1 inference": 0,
                                    "K1 training": per_pass,
                                    "K2": per_pass}, "train step")
            _check_launches(evals, {"K1 inference": per_pass,
                                    "K1 training": 0, "K2": 0},
                            "validation forward")
        if len(steps) != n_steps or len(evals) != n_val:
            raise AssertionError(f"{len(steps)} steps, {len(evals)} "
                                 "validation batches")
        for _, _, (_, m) in steps:
            for k in ("loss", "grad_norm"):
                if not math.isfinite(float(m[k])):
                    raise AssertionError(f"train {k} {float(m[k])}")
        last = trainer.ckpt.last_path()
        if last is None or not last.endswith(f"last_{n_steps}.pt"):
            raise AssertionError(f"no last checkpoint: {last}")
        saved = {k: v.clone() for k, v in model.state_dict().items()}
        trainer.state.step = -1
        trainer.ckpt.restore(trainer.state, last)
        if trainer.state.step != n_steps or any(
                not torch.equal(v, saved[k])
                for k, v in model.state_dict().items()):
            raise AssertionError("the checkpoint did not restore the state")
    fp32 = _step_summary("fp32 (Trainer.fit)", steps, batch)
    print(f"train fp32: fit {fit_s:.1f} s for {n_steps} steps + {n_val} "
          f"validation batches; launches {launched}; validation forward ms "
          + ", ".join(f"{m:.3f}" for m, _, _ in evals)
          + f"; peak memory {peak / 2**30:.2f} GiB; checkpoint "
          f"{os.path.basename(last)} restored", flush=True)

    state = loop.create_train_state(model, 1e-4, 1e-2, n_bf16, seed=1)
    step = loop.make_train_step(model, "recall_focused", 3,
                                compute_dtype=torch.bfloat16)
    bf16_log = []
    run = _recorded(step, bf16_log, dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    for i in range(n_bf16):
        b_ = {k: torch.from_numpy(v).to(dev)
              for k, v in train[i % n_steps].items()}
        run(state, b_)
    peak_bf16 = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        _check_launches(bf16_log, {"K1 inference": 0,
                                   "K1 training": per_pass,
                                   "K2": per_pass}, "bf16 train step")
    for _, _, (_, m) in bf16_log:
        for k in ("loss", "grad_norm"):
            if not math.isfinite(float(m[k])):
                raise AssertionError(f"bf16 train {k} {float(m[k])}")
    bf16 = _step_summary("bf16 (make_train_step)", bf16_log, batch)
    print(f"train bf16: peak memory {peak_bf16 / 2**30:.2f} GiB", flush=True)

    if on_card:
        fp32_step = loop.make_train_step(model, "recall_focused", 3)
        b0 = {k: torch.from_numpy(v).to(dev) for k, v in train[0].items()}
        phase_profile("train step fp32",
                      lambda: fp32_step(trainer.state, b0), n_runs=2)
        phase_profile("train step bf16", lambda: step(state, b0), n_runs=2)
    return launched, dict(fp32=fp32, bf16=bf16, peak_gib=peak / 2**30,
                          peak_bf16_gib=peak_bf16 / 2**30)


def phase_train_vs_plain(dev="cuda", segformer="b3", size=256, clip_len=5):
    """One fp32 step (forward, loss, backward) of the same weights through
    the kernels and through the plain scan, every dropout at 0."""
    from vivim_tpu_torch.cli.common import build_model
    from vivim_tpu_torch.nn.layers import init_weights, use_generator
    from vivim_tpu_torch.nn.vivim import Vivim
    from vivim_tpu_torch.train import loop
    from vivim_tpu_torch.train.losses import LOSSES

    dev = torch.device(dev)
    _, cfg = build_model(model_args(segformer), device="cpu", seed=0)
    cfg = dataclasses.replace(
        cfg, drop_path_rate=0.0, dropout_rate=0.0,
        segformer=dataclasses.replace(cfg.segformer, drop_path_rate=0.0,
                                      classifier_dropout=0.0))
    batch = make_requests(1, clip_len, size, 3, seed=3)[0]
    clip = torch.from_numpy(batch["clip"]).to(dev)
    masks = torch.from_numpy(batch["masks"]).to(dev)
    results = []
    for impl in (None, "ref"):  # impl None: the kernels
        model = init_weights(Vivim(dataclasses.replace(
            cfg, scan_implementation=impl)), torch.Generator().manual_seed(0))
        model = use_generator(model.to(dev).train(),
                              torch.Generator(dev).manual_seed(0))
        t0 = time.perf_counter()
        logits, targets = loop.flatten_frames(model(clip), masks)
        loss = LOSSES["recall_focused"](logits, targets, 3)
        loss.backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        results.append((loss.item(), {n: p.grad for n, p in
                                      model.named_parameters()
                                      if p.grad is not None}, secs))
        del model, logits, loss
    (loss_k, grads_k, secs_k), (loss_r, grads_r, secs_r) = results
    if not math.isfinite(loss_k) or abs(loss_k - loss_r) > 1e-5 * abs(loss_r):
        raise AssertionError(f"loss {loss_k} vs plain scan {loss_r}")
    if set(grads_k) != set(grads_r):
        raise AssertionError("the two steps give gradients to different "
                             "parameters")
    worst, x_proj = 0.0, []
    for name, g in grads_k.items():
        torch.testing.assert_close(g, grads_r[name], rtol=1e-3, atol=2e-3,
                                   msg=name)
        err = (g - grads_r[name]).abs().max().item()
        worst = max(worst, err)
        if ".x_proj" in name:
            x_proj.append((err, grads_r[name].abs().max().item()))
    if len(x_proj) != 3 * sum(cfg.depths):
        raise AssertionError(f"{len(x_proj)} x_proj gradients compared")
    # their scale can sit far below atol: hold them to rtol 1e-3 of their
    # largest element as well (the gradients F1 corrupts in Pallas)
    for err, scale in x_proj:
        if err > 1e-3 * scale:
            raise AssertionError(f"x_proj gradient error {err:.3e} above "
                                 f"1e-3 of its scale {scale:.3e}")
    print(f"train vs plain: fp32 step, batch 1, dropouts 0: loss "
          f"{loss_k:.7f} vs {loss_r:.7f} (rel "
          f"{abs(loss_k - loss_r) / abs(loss_r):.2e}); {len(grads_k)} "
          f"parameter gradients within rtol 1e-3 / atol 2e-3, max abs err "
          f"{worst:.3e}; the {len(x_proj)} x_proj / x_proj_b / x_proj_s "
          f"gradients: max abs err {max(e for e, _ in x_proj):.3e} at "
          f"|grad| max {max(m for _, m in x_proj):.3e}; kernel step "
          f"{secs_k:.2f} s, plain-scan step {secs_r:.1f} s", flush=True)
    return worst


def write_png_tree(root, n_cases=CLI_CASES, n_frames=CLI_FRAMES,
                   size=CLI_SOURCE, seed=0, threads=8):
    """Raw annotated tree ``root/case_<c>/<n>_x/{frame, background, solid,
    non-solid}.png`` from ``seed``: smooth colour gradients with noise and
    moving blob masks; solid masks on 3 frames in 4, non-solid on 2 in 3
    (the others absent, as in annotated data).  Frames are written on
    ``threads`` threads, each from its own generator, so the tree does not
    depend on their order."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    yy, xx = np.mgrid[:size, :size] / size
    cases = []
    for c in range(n_cases):
        rng = np.random.default_rng((seed, c))
        cases.append((rng.uniform(0.5, 2.0, (3, 2)),
                      rng.uniform(0, 2 * np.pi, 3),
                      rng.uniform(0.3, 0.7), rng.uniform(0.3, 0.7)))

    def frame(c, n):
        freq, phase, cy, cx = cases[c]
        r = 0.12
        rng = np.random.default_rng((seed, c, n))
        d = os.path.join(root, f"case_{c}", f"{n}_x")
        os.makedirs(d)
        img = np.stack([128 + 70 * np.sin(2 * np.pi * (
            freq[k, 0] * xx + freq[k, 1] * yy) + phase[k] + 0.1 * n)
            for k in range(3)], -1)
        img += rng.normal(0.0, 12.0, img.shape)
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            os.path.join(d, "frame.png"), compress_level=1)
        y0, x0 = cy + 0.005 * (n % 30), cx - 0.004 * (n % 30)
        dist = (yy - y0) ** 2 + (xx - x0) ** 2
        solid = (dist < r * r) & (n % 4 != 3)
        nonsolid = (dist >= r * r) & (dist < (1.6 * r) ** 2) & (n % 3 != 0)
        for name, m, present in (
                ("background.png", ~(solid | nonsolid), True),
                ("solid.png", solid, n % 4 != 3),
                ("non-solid.png", nonsolid, n % 3 != 0)):
            if present:
                Image.fromarray(m.astype(np.uint8) * 255).save(
                    os.path.join(d, name), compress_level=1)

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(lambda cn: frame(*cn),
                      [(c, n) for c in range(n_cases)
                       for n in range(n_frames)]))


def write_fold_tree(raw, root, n_folds=2):
    """``root/fold_<f>/{train,val}/<case>/``: fold f validates on case f
    and trains on the others (the layout make_folds writes), its files
    hard links to ``raw``'s."""
    import shutil

    cases = sorted(os.listdir(raw))
    for f in range(n_folds):
        for c in cases:
            split = "val" if c == cases[f] else "train"
            shutil.copytree(os.path.join(raw, c),
                            os.path.join(root, f"fold_{f}", split, c),
                            copy_function=os.link)


class WaitTimed:
    """A loader whose iteration records, for each batch, the host clock
    when the Trainer asks for it and when it gets it (s), and the clock of
    the last request (the one that ends the epoch).  ``skip`` is the number
    of batches the loader can have decoded before the Trainer took its
    second batch: prefetch + 1 submitted at the start and prefetch + 1 more
    as the queue fills."""

    def __init__(self, loader, log):
        self.loader, self.log = loader, log
        log["skip"] = 2 * (loader.prefetch + 1)

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                self.log["end"] = t0
                return
            self.log["batches"].append((t0, time.perf_counter()))
            yield batch


def recording_trainer(runs, dev):
    """A Trainer class that records each run's steps, validation forwards
    (ms, launches, result), loader waits and peak memory (GiB, over its
    ``fit``) into a new dict of ``runs``."""
    from vivim_tpu_torch.train.trainer import Trainer

    class RecordingTrainer(Trainer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.run = dict(steps=[], evals=[], waits=dict(batches=[]),
                            peak_gib=0.0)
            runs.append(self.run)
            self.train_step = _recorded(self.train_step, self.run["steps"],
                                        dev)
            self.eval_step = _recorded(self.eval_step, self.run["evals"], dev)
            self.train_loader = WaitTimed(self.train_loader,
                                          self.run["waits"])

        def fit(self, *args, **kw):
            on_card = self.device.type == "cuda"
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            try:
                return super().fit(*args, **kw)
            finally:
                if on_card:
                    self.run["peak_gib"] = (torch.cuda.max_memory_allocated()
                                            / 2**30)
                # keep each step's metrics, drop the train state it
                # returned: the next run's peak must not hold this model
                self.run["steps"][:] = [(ms, n, (None, m)) for ms, n, (_, m)
                                        in self.run["steps"]]

    return RecordingTrainer


def _loader_waits(waits):
    """The loader's waits (ms) from the clocks ``WaitTimed`` recorded: the
    first batch's, and over the steady window (the batches from
    ``waits["skip"]`` on, whose decode could not start before the first
    step ended) the median and maximum per batch and their sum over the
    wall time of the same steps, from the first request of the window to
    the request that ended the epoch."""
    got = [(t1 - t0) * 1e3 for t0, t1 in waits["batches"]]
    skip = waits["skip"]
    if len(got) < skip + 10:
        raise AssertionError(f"{len(got)} batches leave fewer than 10 past "
                             f"the {skip} the loader can decode ahead")
    window = got[skip:]
    wall = (waits["end"] - waits["batches"][skip][0]) * 1e3
    return dict(wait_first_ms=got[0], wait_window_batches=len(window),
                wait_median_ms=statistics.median(window),
                wait_max_ms=max(window), wait_sum_ms=sum(window),
                window_wall_ms=wall, wait_share=sum(window) / wall)


def _cli_summary(label, run, log_path, batch, clip_len):
    """Print and return one CLI run's step times, loader waits and
    end-to-end clips/s (the Trainer's logged train/frames_per_sec)."""
    with open(log_path) as f:
        records = [json.loads(line) for line in f]
    if not any("val/dice" in r for r in records):
        raise AssertionError(f"{log_path} holds no val/dice")
    fps = [r["train/frames_per_sec"] for r in records
           if "train/frames_per_sec" in r]
    steps = _step_summary(label, run["steps"], batch)
    out = dict(steps, **_loader_waits(run["waits"]),
               end_to_end_clips_per_s=fps[-1] / clip_len,
               eval_ms=[m for m, _, _ in run["evals"]],
               peak_gib=run["peak_gib"])
    ev = out["eval_ms"]
    print(f"train_cli {label}: loader wait {out['wait_first_ms']:.1f} ms "
          f"for the first batch; over batches {run['waits']['skip']} to "
          f"{len(run['steps']) - 1} ({out['wait_window_batches']} batches): "
          f"{out['wait_median_ms']:.3f} ms median, {out['wait_max_ms']:.3f} "
          f"max, {out['wait_sum_ms']:.3f} ms in all over "
          f"{out['window_wall_ms']:.1f} ms of wall time "
          f"({100 * out['wait_share']:.3f} %); epoch end to end "
          f"{out['end_to_end_clips_per_s']:.3f} clips/s (train/frames_per_"
          f"sec / {clip_len}); {len(ev)} validation forwards, ms "
          f"{ev[0]:.3f} first, {statistics.median(ev[1:] or ev):.3f} median "
          f"over the rest; peak memory {run['peak_gib']:.2f} GiB", flush=True)
    return out


def time_loader(argv, root, threads, n_batches=None):
    """clips/s of the training loader that ``argv`` builds over ``root``,
    alone (no training): ``threads`` decode threads (0: in this thread),
    over the first ``n_batches`` batches or the whole epoch."""
    from vivim_tpu_torch.cli.args import build_train_parser
    from vivim_tpu_torch.cli.common import build_loaders

    train_dl, _ = build_loaders(build_train_parser().parse_args(argv), root)
    train_dl.num_workers = threads
    clips, t0 = 0, time.perf_counter()
    for batch in train_dl:
        clips += len(batch["paths"])
        if clips == (n_batches or len(train_dl)) * train_dl.batch_size:
            break
    return clips, clips / (time.perf_counter() - t0)


def phase_train_cli(dev="cuda", segformer="b3", size=256, clip_len=5,
                    batch=TRAIN_BATCH, source=CLI_SOURCE, fp32_ref_ms=None,
                    workdir=None):
    """train_folds (fp32, 2 folds) and train_final (bf16) from a PNG tree,
    through the port's CLI entry points.  With ``workdir`` the trees and
    runs stay there for phase 9: ``raw/`` (the raw tree), ``folds/``,
    ``gathered/`` (fold 0's training cases) and ``runs/smoke/fold_<f>/``,
    ``runs/smoke/final/``."""
    from vivim_tpu_torch import native
    from vivim_tpu_torch.cli import train_final, train_folds
    from vivim_tpu_torch.data.gather import gather_multiclass_frames

    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    if native.get_lib() is None:
        raise AssertionError("the native host ops did not build")
    per_pass = LAYERS_PER_STAGE * len(STAGES)
    n_steps = (CLI_CASES - 1) * (CLI_FRAMES // clip_len) // batch
    common = ["-segformer", segformer, "-image_size", str(size),
              "-clip_length", str(clip_len), "-train_bs", str(batch),
              "-val_bs", str(batch), "-epochs", "1", "-val_freq", "1",
              "-augment_intensity", "medium", "-num_workers", "4",
              "-device", str(dev), "-exp_name", "smoke"]
    runs = []
    with (contextlib.nullcontext(workdir) if workdir
          else tempfile.TemporaryDirectory()) as tmp:
        t0 = time.perf_counter()
        raw, folds = os.path.join(tmp, "raw"), os.path.join(tmp, "folds")
        write_png_tree(raw, size=source)
        write_fold_tree(raw, folds)
        print(f"train_cli: wrote {CLI_CASES} cases x {CLI_FRAMES} annotated "
              f"{source} x {source} PNG frames and 2 folds in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        save = os.path.join(tmp, "runs")
        original = train_folds.Trainer, train_final.Trainer
        train_folds.Trainer = train_final.Trainer = recording_trainer(
            runs, dev)
        try:
            reset_counts()
            train_folds.main(["-data_path", folds, "-num_folds", "2",
                              "-save_path", save] + common)
            gathered = os.path.join(tmp, "gathered")
            gather_multiclass_frames(os.path.join(folds, "fold_0", "train"),
                                     gathered, copy=True)
            train_final.main(["-data_path", gathered, "-bf16", "true",
                              "-save_path", save] + common)
            launched = counts()
        finally:
            train_folds.Trainer, train_final.Trainer = original
        # the loader alone over fold 0's training clips: the CLIs' 4
        # threads over the whole epoch, and one thread's host ms per frame
        clips, loader_rate = time_loader(
            common + ["-data_path", gathered], gathered, 4)
        clips1, rate1 = time_loader(
            common + ["-data_path", gathered], gathered, 0, n_batches=4)
        loader = dict(clips=clips, clips_per_s=loader_rate,
                      host_ms_per_frame=1e3 / (rate1 * clip_len))
        print(f"train_cli: loader alone (no training), 4 threads: {clips} "
              f"clips in one epoch at {loader_rate:.3f} clips/s; in one "
              f"thread {clips1} clips at {rate1:.3f} clips/s, "
              f"{loader['host_ms_per_frame']:.1f} host ms per {source} px "
              "frame", flush=True)
        run_dirs = [os.path.join(save, "smoke", f"fold_{f}")
                    for f in range(2)] + [os.path.join(save, "smoke",
                                                       "final")]
        if len(runs) != 3:
            raise AssertionError(f"{len(runs)} Trainer runs, expected 3")
        out = {}
        for i, (run, run_dir) in enumerate(zip(runs, run_dirs)):
            label = ("final bf16" if i == 2 else f"fold {i} fp32")
            if len(run["steps"]) != n_steps:
                raise AssertionError(f"{label}: {len(run['steps'])} steps, "
                                     f"expected {n_steps}")
            if on_card:
                _check_launches(run["steps"], {
                    "K1 inference": 0, "K1 training": per_pass,
                    "K2": per_pass}, f"{label} train step")
                _check_launches(run["evals"], {
                    "K1 inference": per_pass, "K1 training": 0, "K2": 0},
                    f"{label} validation forward")
            for _, _, (_, m) in run["steps"]:
                for k in ("loss", "grad_norm"):
                    if not math.isfinite(float(m[k])):
                        raise AssertionError(f"{label} {k} {float(m[k])}")
            ckpts = sorted(os.listdir(os.path.join(run_dir, "ckpt")))
            if ckpts != [f"best_{n_steps}.pt", f"last_{n_steps}.pt",
                         "manager.json"]:
                raise AssertionError(f"{label} checkpoints {ckpts}")
            out[label] = _cli_summary(
                label, run, os.path.join(run_dir, "metrics.jsonl"), batch,
                clip_len)
    fp32_med = statistics.median(
        [out[f"fold {f} fp32"]["median_ms"] for f in range(2)])
    bf16_med = out["final bf16"]["median_ms"]
    print(f"train_cli: launches {launched} ({per_pass} K1-training and "
          f"{per_pass} K2 per step, {per_pass} inference K1 per validation "
          f"forward); bf16 step median {bf16_med:.3f} ms (train_final) "
          f"beside fp32 {fp32_med:.3f} ms (train_folds, median of the two "
          "folds' medians)" + (f" and {fp32_ref_ms:.3f} ms (phase 5 "
                               "Trainer.fit)" if fp32_ref_ms else "")
          + f": bf16 / fp32 {bf16_med / fp32_med:.3f}", flush=True)
    fp32_rate = batch / fp32_med * 1e3
    print(f"train_cli: loader alone {loader_rate:.3f} clips/s against "
          f"{fp32_rate:.3f} clips/s of the fp32 fold steps: "
          f"{loader_rate / fp32_rate:.3f} times", flush=True)
    return launched, dict(out, bf16_over_fp32=bf16_med / fp32_med,
                          loader=dict(loader, over_fp32_steps=loader_rate
                                      / fp32_rate))


def write_polyp_tree(raw, root, n_videos=POLYP_VIDEOS,
                     n_frames=POLYP_FRAMES):
    """``root/Train/case_<c>/{Frame,GT}/<n>.png`` from the first
    ``n_videos`` cases and ``n_frames`` frames of the raw tree ``raw``: the
    frame as it is (a hard link) and the GT as the inverted background mask
    (foreground = solid | non-solid)."""
    from PIL import Image, ImageOps

    for c in range(n_videos):
        vid = os.path.join(root, "Train", f"case_{c}")
        for sub in ("Frame", "GT"):
            os.makedirs(os.path.join(vid, sub))
        for n in range(n_frames):
            src = os.path.join(raw, f"case_{c}", f"{n}_x")
            os.link(os.path.join(src, "frame.png"),
                    os.path.join(vid, "Frame", f"{n}.png"))
            ImageOps.invert(Image.open(os.path.join(
                src, "background.png")).convert("L")).save(
                os.path.join(vid, "GT", f"{n}.png"), compress_level=1)


def _metrics_summary(label, run, log_path, batch, keys):
    """Print and return one binary / polyp / fold run's step ms, clips/s,
    validation forward ms, the validator's host ms per batch and peak
    memory; the run's ``metrics.jsonl`` must carry ``keys``."""
    with open(log_path) as f:
        records = [json.loads(line) for line in f]
    logged = {k for r in records for k in r}
    if not set(keys) <= logged:
        raise AssertionError(f"{log_path} lacks {sorted(set(keys) - logged)}")
    out = dict(_step_summary(label, run["steps"], batch),
               eval_ms=[m for m, _, _ in run["evals"]],
               validator_ms=run.get("validator_ms", []),
               peak_gib=run["peak_gib"])
    ev, va = out["eval_ms"], out["validator_ms"]
    print(f"binary {label}: {len(ev)} validation forwards, ms "
          f"{ev[0]:.3f} first, {statistics.median(ev[1:] or ev):.3f} median "
          "over the rest"
          + (f"; BinaryValidator host ms per batch of {batch} center frames "
             f"{statistics.median(va):.3f} median, {min(va):.3f} min"
             if va else "")
          + f"; peak memory {run['peak_gib']:.2f} GiB", flush=True)
    return out


def phase_binary(dev="cuda", segformer="b3", size=256, clip_len=5,
                 batch=TRAIN_BATCH, source=CLI_SOURCE):
    """The binary and edge recipe through the port's CLIs: (a)
    ``train_binary -with_edge true`` on a gathered tree, (b)
    ``train_polyp``, (c) ``train_folds -with_edge true -pretrain`` (a)'s
    best checkpoint, fp32, one epoch each."""
    from vivim_tpu_torch.cli import train_binary, train_folds, train_polyp
    from vivim_tpu_torch.data.gather import gather_multiclass_frames
    from vivim_tpu_torch.train import binary
    from vivim_tpu_torch.train.checkpoints import load_params

    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    per_pass = LAYERS_PER_STAGE * len(STAGES)
    clips_per_case = BIN_FRAMES // clip_len
    want_steps = {"binary edge": 2 * clips_per_case // batch,
                  "polyp": POLYP_VIDEOS * POLYP_FRAMES // batch}
    common = ["-segformer", segformer, "-image_size", str(size),
              "-clip_length", str(clip_len), "-train_bs", str(batch),
              "-val_bs", str(batch), "-epochs", "1", "-val_freq", "1",
              "-augment_intensity", "medium", "-num_workers", "4",
              "-device", str(dev), "-exp_name", "smoke"]
    runs, fold_runs, took = {}, [], []
    live = []  # the binary CLI run being recorded: live[-1]

    def record(label):
        runs[label] = dict(steps=[], evals=[], validator_ms=[], peak_gib=0.0)
        live.append(runs[label])
        if on_card:
            torch.cuda.reset_peak_memory_stats()

    def finish():
        run = live[-1]
        if on_card:
            run["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        # keep each step's metrics, drop the train state it returned: the
        # next run's peak must not hold this model
        run["steps"][:] = [(ms, n, (None, m))
                           for ms, n, (_, m) in run["steps"]]
        run["evals"][:] = [(ms, n, None) for ms, n, _ in run["evals"]]

    make_train, make_eval = (binary.make_binary_train_step,
                             binary.make_binary_eval_step)
    validator_cls, load_pretrained = (binary.BinaryValidator,
                                      train_folds.maybe_load_pretrained)
    fold_trainer = train_folds.Trainer

    class TimedValidator(validator_cls):
        def update(self, *args):
            t0 = time.perf_counter()
            super().update(*args)
            live[-1]["validator_ms"].append(
                (time.perf_counter() - t0) * 1e3)

    def checked_pretrain(args, model):
        """-pretrain, then: the tensors it took equal the checkpoint's and
        are every one of equal key and shape; ``out.*`` kept its init."""
        before = {k: v.clone() for k, v in model.state_dict().items()}
        keys = load_pretrained(args, model)
        ckpt = load_params(args.pretrain)
        after = model.state_dict()
        overlap = sorted(k for k in ckpt if k in before
                         and ckpt[k].shape == before[k].shape)
        if keys != overlap:
            raise AssertionError(f"-pretrain took {len(keys)} tensors, the "
                                 f"overlap is {len(overlap)}")
        for k in keys:
            if not torch.equal(after[k].cpu(), ckpt[k]):
                raise AssertionError(f"-pretrain: {k} differs from the "
                                     "checkpoint's")
        for k in ("out.weight", "out.bias"):
            if k in keys or not torch.equal(after[k], before[k]):
                raise AssertionError(f"-pretrain changed {k}")
        if "edgeocr_cls_head.weight" not in keys:
            raise AssertionError("-pretrain did not take the edge head")
        took.append((len(keys), len(after)))
        return keys

    binary.make_binary_train_step = lambda *a, **k: _recorded(
        make_train(*a, **k), live[-1]["steps"], dev)
    binary.make_binary_eval_step = lambda *a, **k: _recorded(
        make_eval(*a, **k), live[-1]["evals"], dev)
    binary.BinaryValidator = TimedValidator
    train_folds.maybe_load_pretrained = checked_pretrain
    train_folds.Trainer = recording_trainer(fold_runs, dev)
    with tempfile.TemporaryDirectory() as tmp:
        try:
            t0 = time.perf_counter()
            raw, folds = os.path.join(tmp, "raw"), os.path.join(tmp, "folds")
            write_png_tree(raw, n_cases=BIN_CASES, n_frames=BIN_FRAMES,
                           size=source)
            write_fold_tree(raw, folds)
            gathered = os.path.join(tmp, "gathered")
            gather_multiclass_frames(os.path.join(folds, "fold_0", "train"),
                                     gathered, copy=True)
            polyp = os.path.join(tmp, "polyp")
            write_polyp_tree(raw, polyp)
            print(f"binary: wrote {BIN_CASES} cases x {BIN_FRAMES} annotated "
                  f"{source} x {source} PNG frames, 2 folds, the gathered "
                  f"tree of fold 0's 2 training cases and a polyp tree of "
                  f"{POLYP_VIDEOS} videos x {POLYP_FRAMES} frames in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            save = os.path.join(tmp, "runs")
            reset_counts()
            record("binary edge")
            train_binary.main(["-data_path", gathered, "-with_edge", "true",
                               "-save_path", save] + common)
            finish()
            record("polyp")
            train_polyp.main(["-data_path", polyp, "-save_path", save]
                             + common)
            finish()
            ckpt_dir = os.path.join(save, "smoke", "binary", "ckpt")
            best = [f for f in os.listdir(ckpt_dir) if f.startswith("best_")]
            train_folds.main(["-data_path", folds, "-num_folds", "2",
                              "-with_edge", "true", "-pretrain",
                              os.path.join(ckpt_dir, best[0]),
                              "-save_path", save] + common)
            launched = counts()
        finally:
            binary.make_binary_train_step = make_train
            binary.make_binary_eval_step = make_eval
            binary.BinaryValidator = validator_cls
            train_folds.maybe_load_pretrained = load_pretrained
            train_folds.Trainer = fold_trainer
        if len(took) != 2:
            raise AssertionError(f"-pretrain checked {len(took)} times")
        run_dirs = {"binary edge": "binary", "polyp": "polyp"}
        for i, run in enumerate(fold_runs):
            runs[f"fold {i} edge+pretrain"] = run
            run_dirs[f"fold {i} edge+pretrain"] = f"fold_{i}"
            want_steps[f"fold {i} edge+pretrain"] = (2 * clips_per_case
                                                     // batch)
        if sorted(runs) != sorted(want_steps):
            raise AssertionError(f"runs {sorted(runs)}")
        binary_keys = ("val/dice", "val/Smeasure", "val/Emeasure", "val/MAE",
                       "val/wFmeasure")
        out = {}
        for label, run in runs.items():
            n = want_steps[label]
            if len(run["steps"]) != n:
                raise AssertionError(f"{label}: {len(run['steps'])} steps, "
                                     f"expected {n}")
            if on_card:
                _check_launches(run["steps"], {
                    "K1 inference": 0, "K1 training": per_pass,
                    "K2": per_pass}, f"{label} train step")
                _check_launches(run["evals"], {
                    "K1 inference": per_pass, "K1 training": 0, "K2": 0},
                    f"{label} validation forward")
            for _, _, (_, m) in run["steps"]:
                for k, v in m.items():
                    if not math.isfinite(float(v)):
                        raise AssertionError(f"{label} {k} {float(v)}")
            run_dir = os.path.join(save, "smoke", run_dirs[label])
            ckpts = sorted(os.listdir(os.path.join(run_dir, "ckpt")))
            if ckpts != [f"best_{n}.pt", f"last_{n}.pt", "manager.json"]:
                raise AssertionError(f"{label} checkpoints {ckpts}")
            out[label] = _metrics_summary(
                label, run, os.path.join(run_dir, "metrics.jsonl"), batch,
                binary_keys if label in ("binary edge", "polyp")
                else ("val/dice",))
    print(f"binary: launches {launched} ({per_pass} K1-training and "
          f"{per_pass} K2 per step, {per_pass} inference K1 per validation "
          f"forward); -pretrain took {took[0][0]} of {took[0][1]} tensors "
          "per fold, each equal to the binary checkpoint's, out.* at its "
          "init", flush=True)
    return launched, dict(out, pretrain_took=took[0][0])


class CharTokenizer:
    """ids of characters (mod the vocabulary), for the eval core's string
    requests; eos 0."""

    eos_token_id = 0

    def __init__(self, vocab):
        self.vocab = vocab

    def encode(self, s):
        return [1 + ord(c) % (self.vocab - 1) for c in s]

    def decode(self, ids):
        return "".join(chr(32 + i % 95) for i in ids)


def write_lm_snapshot(root, config, seed=0):
    """``config.json`` and a ``pytorch_model.bin`` of the port's seeded
    random init in the reference key layout; returns the parameter
    count."""
    from vivim_tpu_torch.nn import lm
    from vivim_tpu_torch.nn.layers import init_weights

    model = init_weights(lm.MambaLM(lm.config_from_mamba_json(config)),
                         torch.Generator().manual_seed(seed))
    torch.save(model.state_dict(), os.path.join(root, "pytorch_model.bin"))
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(config, f)
    return sum(p.numel() for p in model.parameters())


def lm_scan_rows(peaks, d_inner):
    """K1 (inference variant, z and last state) against its plain version
    at the LM prefill's shapes: batch 1, the bench's prompt and a ragged
    one, fp32 and bf16, output and last state."""
    from vivim_tpu_torch.kernels import refs
    from vivim_tpu_torch.kernels import selective_scan as ss

    gen = torch.Generator(device="cuda").manual_seed(8)
    rows = []
    for L in (LM_PROMPT, LM_RAGGED):
        lc, grid = picked_chunk(1, L, d_inner)
        for dtype in (torch.float32, torch.bfloat16):
            args = scan_inputs(1, L, d_inner, dtype, gen)
            run = lambda: ss.selective_scan_fwd_cuda(
                *args[:5], D=args[5], z=args[6], delta_bias=args[7],
                delta_softplus=True)
            got = run()
            torch.cuda.synchronize()
            want, plain_ms = once_ms(lambda: refs.selective_scan_ref(
                *args[:5], D=args[5], z=args[6], delta_bias=args[7],
                delta_softplus=True, return_last_state=True))
            rtol, atol = TOL[dtype]
            for what, g, w in zip(("y", "last"), got, want):
                torch.testing.assert_close(
                    g.float(), w.float(), rtol=rtol, atol=atol,
                    msg=f"K1 LM shape L={L} {dtype_name(dtype)} {what}")
            err = max((g.float() - w.float()).abs().max().item()
                      for g, w in zip(got, want))
            call_ms = cuda_ms(run, 30)
            ms = device_ms(run)
            work = scan_work(1, L, d_inner, got[0].element_size())
            bound_ms, bound_by, term = bound(work, peaks)
            rows.append(dict(stage=f"lm L={L}", L=L, d=d_inner,
                             dtype=dtype_name(dtype), l_chunk=lc, grid=grid,
                             max_abs_err=err, ms=ms, call_ms=call_ms,
                             plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, bound_term=term,
                             mbytes=work[0] / 1e6))
            print(f"K1 LM prefill {dtype_name(dtype):8s} (1, {L:3d}, "
                  f"{d_inner}) {grid_text(lc, grid)}: y, last "
                  f"max_abs_err={err:.3e} device_ms={ms:.4f} (one call "
                  f"with its launch {call_ms:.4f}) plain_ms={plain_ms:.1f} "
                  f"bound_ms={bound_ms:.5f} ({term}; {work[0] / 1e6:.2f} MB,"
                  f" {work[2] / 1e6:.2f} M exps)", flush=True)
    return rows


def phase_lm(peaks=None, dev="cuda", config=LM_CONFIG, prompt=LM_PROMPT,
             gen_len=LM_GEN, repeats=LM_REPEATS):
    """The Mamba LM's serving path (phase 8): load a mamba-130m snapshot of
    seeded random weights through ``load_lm``, run ``bench_generation``'s
    CLI in fp32, bf16 and int8, count K1 per generate, per decode token and
    per scoring forward, hold K1 at the LM shapes and the whole LM against
    the plain scan, and time prefill and decode.  ``dev="cpu"`` rehearses
    the host side at a small ``config`` (no kernel, no timing)."""
    from vivim_tpu_torch.cli import bench_generation
    from vivim_tpu_torch.cli.lm_eval_harness import MambaEvalCore, load_lm
    from vivim_tpu_torch.kernels import selective_scan as ss
    from vivim_tpu_torch.nn import lm, streaming
    from vivim_tpu_torch.nn.quant import quantize_lm_params

    on_card = torch.device(dev).type == "cuda"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as snap:
        n_params = write_lm_snapshot(snap, config)
        # (a) load through the entry point, on the card
        model, params = load_lm(None, 0, 0, 0, hf_dir=snap, device=dev)
        cfg = model.cfg
        want_cfg = lm.config_from_mamba_json(config)
        if cfg != want_cfg or model.backbone.layers[0].norm.rms is not True:
            raise AssertionError(f"loaded config {cfg}, want {want_cfg}")
        d_inner = cfg.expand * cfg.d_model
        print(f"lm: mamba-130m config ({cfg.n_layer} layers, d_model "
              f"{cfg.d_model}, d_inner {d_inner}, vocab {cfg.vocab_size} -> "
              f"{cfg.padded_vocab}, RMSNorm, fp32 residual), "
              f"{n_params / 1e6:.2f} M parameters of seeded random weights, "
              f"snapshot written and loaded in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        # (b) the CLI at its defaults, each dtype; the main path's count
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        bench = {}
        reset_counts()
        for dtype in LM_DTYPES:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                bench_generation.main([
                    "--hf_dir", snap, "--dtype", dtype, "--device", dev,
                    "--promptlen", str(prompt), "--genlen", str(gen_len),
                    "--repeats", str(repeats)])
            line = buf.getvalue().strip().splitlines()[-1]
            bench[dtype] = json.loads(line)
            print(f"lm bench_generation --dtype {dtype}: {line}", flush=True)
        launched = counts()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
    per_gen = cfg.n_layer
    want = {"K1 inference": len(LM_DTYPES) * (repeats + 1) * per_gen,
            "K1 training": 0, "K2": 0}
    if on_card and launched != want:
        raise AssertionError(f"bench_generation launched {launched}, "
                             f"expected {want}")
    for dtype, r in bench.items():
        if r["gen_len"] != gen_len or r["prompt_len"] != prompt \
                or not r["tokens_per_sec"] > 0:
            raise AssertionError(f"bench line {dtype}: {r}")
    print(f"lm: bench launches {launched} ({per_gen} K1 per generate), "
          f"peak memory {peak / 2**30:.2f} GiB", flush=True)

    # (c) K1 per generate, per decode token and per scoring forward
    dev_ = next(model.parameters()).device
    g = torch.Generator(device=dev_).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (1, prompt), generator=g,
                         device=dev_)
    q8 = quantize_lm_params(params, activation_dtype=torch.bfloat16)
    step_launches = []

    def counting_step(mp, x, cs, ssm):
        c0 = ss.LAUNCHES
        out = streaming.mamba_step(mp, x, cs, ssm)
        step_launches.append(ss.LAUNCHES - c0)
        return out

    reset_counts()
    lm.generate(model, params, toks, 16, top_k=1, mixer_step=counting_step,
                generator=torch.Generator(device=dev_).manual_seed(1))
    per = {"generate": counts()["K1 inference"]}
    if len(step_launches) != 16 * cfg.n_layer or any(step_launches):
        raise AssertionError(f"decode steps launched {sum(step_launches)} "
                             f"K1 over {len(step_launches)} mixer steps")
    text = "".join(chr(97 + i % 26) for i in range(prompt))
    for name, p in (("score fp32", params), ("score int8", q8)):
        core = MambaEvalCore(model, p, CharTokenizer(cfg.vocab_size))
        reset_counts()
        ll, _ = core.loglikelihood_pair(text[:prompt - 28], text[-28:])
        per[name] = counts()["K1 inference"]
        if not math.isfinite(ll):
            raise AssertionError(f"{name}: loglikelihood {ll}")
    if on_card and any(v != per_gen for v in per.values()):
        raise AssertionError(f"K1 launches {per}; expected {per_gen} per "
                             "generate and per scoring forward")
    print(f"lm: K1 launches per generate / fp32 / int8 scoring forward "
          f"{per}, 0 in {len(step_launches)} decode mixer steps", flush=True)

    # (d) K1 against its plain version at the LM shapes
    rows = lm_scan_rows(peaks, d_inner) if on_card else []

    # (e) end to end against the same model on the plain scan (fp32)
    ref_model = lm.MambaLM(cfg, scan_implementation="ref")
    ref_model.load_state_dict(model.state_dict())
    ref_model = ref_model.to(dev_).eval()
    ref_params = lm.lm_params(ref_model)
    with torch.no_grad():
        got = lm.prefill(lm.split_params(model, params), toks)[0]
        want_l = lm.prefill(lm.split_params(ref_model, ref_params), toks)[0]
    logit_err = (got - want_l).abs().max().item()
    torch.testing.assert_close(got, want_l, rtol=0, atol=1e-3)
    plain_toks, plain_scores = lm.generate(
        ref_model, ref_params, toks, LM_E2E_GEN, temperature=0.0,
        output_scores=True)
    tf_toks, tf_scores = lm.generate(
        model, params, toks, LM_E2E_GEN, temperature=0.0,
        teacher_outputs=plain_toks, output_scores=True)
    if not torch.equal(tf_toks, plain_toks):
        raise AssertionError("teacher-forced tokens differ from the teacher")
    score_err = (tf_scores - plain_scores).abs().max().item()
    torch.testing.assert_close(tf_scores, plain_scores, rtol=0, atol=1e-3)
    agree = (tf_scores.argmax(-1) == plain_toks[:, prompt:]).float().mean()
    print(f"lm: prefill last logits vs the plain scan max_abs_err="
          f"{logit_err:.3e} (atol 1e-3; |logits| max "
          f"{want_l.abs().max().item():.3f}); {LM_E2E_GEN} teacher-forced "
          f"tokens: scores max_abs_err={score_err:.3e} (atol 1e-3), argmax "
          f"equal to the plain run's greedy token at "
          f"{100 * agree.item():.1f} %", flush=True)
    del ref_model, ref_params

    # (f) prefill ms, decode ms per token, kernels per token, busy share
    timing = {}
    variants = {"float32": params,
                "bfloat16": {k: v.to(torch.bfloat16) for k, v in
                             params.items()},
                "int8": q8}
    for dtype, p in variants.items():
        parts = lm.split_params(model, p)
        with torch.no_grad():
            _, cs, ssm = lm.prefill(parts, toks)
            tok = toks[:, -1]

            def step():
                lm.decode_step(parts, tok, cs, ssm)

            if on_card:
                prefill_ms = cuda_ms(lambda: lm.prefill(parts, toks), 5)
                decode_ms = cuda_ms(
                    lambda: [step() for _ in range(LM_DECODE_STEPS)],
                    3) / LM_DECODE_STEPS
                prof = phase_profile(f"lm decode step {dtype}", step,
                                     n_runs=5)
            else:
                step()
                prefill_ms = decode_ms = prof = None
        timing[dtype] = dict(prefill_ms=prefill_ms,
                             decode_ms_per_token=decode_ms, profile=prof)
        if on_card:
            print(f"lm {dtype}: prefill {prefill_ms:.3f} ms (1, {prompt}); "
                  f"decode {decode_ms:.3f} ms per token ("
                  f"{1e3 / decode_ms:.1f} tokens/s, CUDA events over "
                  f"{LM_DECODE_STEPS} steps); "
                  + (f"{prof['kernels']} kernels per token, device busy "
                     f"{100 * prof['busy_share']:.1f} % of a step"
                     if prof else "no profile"), flush=True)
    print(f"lm: phase {time.perf_counter() - t0:.1f} s", flush=True)
    return launched, dict(bench=bench, per_call_launches=per,
                          prefill_logits_err=logit_err,
                          teacher_scores_err=score_err, timing=timing,
                          peak_gib=peak / 2**30, scan_rows=rows)


def remat_run(level, batches, dev, segformer="b3", check=None):
    """``make_train_step`` steps of the CLI-built model at ``-remat level``
    (random weights from seed 0, the training CLIs' defaults: dropouts on,
    tanh GELU; fp32) from one state and generator seed over ``batches``.
    ``check(loss, grads, generator state)`` sees the first step.  Returns
    the step log (ms, launches, (None, metrics)) and the peak GiB."""
    from vivim_tpu_torch.cli.args import build_train_parser
    from vivim_tpu_torch.cli.common import build_model
    from vivim_tpu_torch.train import loop

    args = build_train_parser().parse_args(
        ["-segformer", segformer, "-remat", level])
    model, _ = build_model(args, device=dev, seed=0)
    state = loop.create_train_state(model, 1e-4, 1e-2, len(batches), seed=1)
    log = []
    run = _recorded(loop.make_train_step(model, "recall_focused", 3), log,
                    dev)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    for i, b in enumerate(batches):
        _, m = run(state, {k: torch.from_numpy(v).to(dev)
                           for k, v in b.items()})
        if i == 0 and check is not None:
            check(float(m["loss"]), {n: p.grad for n, p in
                                     model.named_parameters()
                                     if p.grad is not None},
                  state.generator.get_state())
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
    for _, _, (_, m) in log:
        for k in ("loss", "grad_norm"):
            if not math.isfinite(float(m[k])):
                raise AssertionError(f"remat {level} {k} {float(m[k])}")
    return [(ms, n, (None, m)) for ms, n, (_, m) in log], peak


def phase_remat(dev="cuda", segformer="b3", size=256, clip_len=5,
                batch=TRAIN_BATCH, n_steps=REMAT_STEPS,
                big_batch=REMAT_BIG_BATCH, n_big=REMAT_BIG_STEPS):
    """(a) of phase 9: one step at each remat level from one state and
    generator seed, held against ``none``'s; the launches per step; median
    step ms and peak memory per level; then ``none`` and ``blocks`` at
    ``big_batch``."""
    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    per_pass = LAYERS_PER_STAGE * len(STAGES)
    batches = make_requests(n_steps, clip_len, size, 3, seed=4, batch=batch)
    ref = {}

    def check(level):
        def run(loss, grads, gen):
            if level == "none":  # the reference, kept on the host
                ref.update(loss=loss, gen=gen,
                           grads={n: g.cpu() for n, g in grads.items()})
                return
            if abs(loss - ref["loss"]) > 1e-5 * abs(ref["loss"]):
                raise AssertionError(f"remat {level}: loss {loss} vs "
                                     f"{ref['loss']} without remat")
            if not torch.equal(gen, ref["gen"]):
                raise AssertionError(f"remat {level}: the generator's state "
                                     "after the step differs from none's")
            if set(grads) != set(ref["grads"]):
                raise AssertionError(f"remat {level}: other parameters got "
                                     "gradients")
            worst = 0.0
            for n, g in grads.items():
                g = g.cpu()
                torch.testing.assert_close(g, ref["grads"][n], rtol=1e-3,
                                           atol=2e-3, msg=f"{level} {n}")
                worst = max(worst, (g - ref["grads"][n]).abs().max().item())
            out[level]["grad_max_abs_err"] = worst
            print(f"remat {level}: loss {loss:.7f} vs {ref['loss']:.7f} "
                  f"(none), generator state equal, {len(grads)} gradients "
                  f"within rtol 1e-3 / atol 2e-3 of none's, max abs err "
                  f"{worst:.3e}", flush=True)
        return run

    out = {}
    for level in ("none", "pre_scan", "blocks"):
        out[level] = {}
        log, peak = remat_run(level, batches, dev, segformer, check(level))
        if on_card:
            _check_launches(log, {"K1 inference": 0,
                                  "K1 training": per_pass * (
                                      2 if level == "blocks" else 1),
                                  "K2": per_pass}, f"remat {level} step")
        out[level].update(_step_summary(f"remat {level}", log, batch),
                          peak_gib=peak, launches=log[0][1])
        print(f"remat {level}: batch {batch}, launches per step "
              f"{log[0][1]}, peak memory {peak:.2f} GiB", flush=True)
    big = make_requests(n_big, clip_len, size, 3, seed=5, batch=big_batch)
    for level in ("none", "blocks"):
        log, peak = remat_run(level, big, dev, segformer)
        out[f"{level} batch {big_batch}"] = dict(
            _step_summary(f"remat {level} batch {big_batch}", log,
                          big_batch), peak_gib=peak)
        print(f"remat {level}: batch {big_batch}, peak memory {peak:.2f} "
              "GiB", flush=True)
    saved = (out[f"none batch {big_batch}"]["peak_gib"]
             - out[f"blocks batch {big_batch}"]["peak_gib"])
    if on_card and saved <= 0:
        raise AssertionError(f"remat blocks at batch {big_batch} peaks no "
                             f"lower than none: {saved:.2f} GiB saved")
    for b in (batch, big_batch):
        none = out["none" if b == batch else f"none batch {b}"]
        blocks = out["blocks" if b == batch else f"blocks batch {b}"]
        print(f"remat: batch {b}: blocks / none step ms "
              f"{blocks['median_ms'] / none['median_ms']:.3f}, peak "
              f"{blocks['peak_gib']:.2f} / {none['peak_gib']:.2f} GiB",
              flush=True)
    return out


def phase_infer_ckpt(workdir, dev="cuda", segformer="b3", size=256,
                     clip_len=5, run=os.path.join("runs", "smoke", "fold_0"),
                     out="infer"):
    """(b) of phase 9: ``cli.infer.main`` on phase 6's fold-0 checkpoint
    directory (or on the run ``run`` under ``workdir``) over fold 0's raw
    validation tree (``--gathered false``), writing to ``out``."""
    from vivim_tpu_torch.cli import infer

    dev = torch.device(dev)
    ckpt = os.path.join(workdir, run, "ckpt")
    out_dir = os.path.join(workdir, out)
    returned = []
    run_inference = infer.run_inference

    def recording(*a, **kw):
        returned.append(run_inference(*a, **kw))
        return returned[-1]

    infer.run_inference = recording
    try:
        reset_counts()
        infer.main(["--ckpt", ckpt, "--data_dir",
                    os.path.join(workdir, "folds", "fold_0", "val"),
                    "--gathered", "false", "-cv_group", "smoke",
                    "--segformer", segformer, "--image_size", str(size),
                    "--clip_length", str(clip_len), "--output_dir", out_dir,
                    "--device", str(dev)])
        launched = counts()
    finally:
        infer.run_inference = run_inference
    with open(os.path.join(out_dir, "metrics.json")) as f:
        summary = json.load(f)
    (_, cm, _), = returned
    perf = summary["performance"]
    n_batches = perf["total_frames"] // clip_len
    if summary["confusion_matrix"] != cm.tolist():
        raise AssertionError("metrics.json's confusion matrix is not the "
                             "run's")
    if int(cm.sum()) != perf["total_frames"] * size * size:
        raise AssertionError(f"the confusion matrix counts {int(cm.sum())} "
                             "pixels")
    per_pass = LAYERS_PER_STAGE * len(STAGES)
    if dev.type == "cuda" and launched != {
            "K1 inference": per_pass * n_batches, "K1 training": 0, "K2": 0}:
        raise AssertionError(f"{n_batches} forwards launched {launched}")
    print(f"infer from {os.path.relpath(ckpt, workdir)} (picked "
          f"{os.path.basename(infer.checkpoint_file(ckpt))}), --gathered "
          f"false on fold 0's validation case: {n_batches} batches of 1, "
          f"launches {launched}, fps {perf['fps']:.2f}, per-batch ms "
          f"{perf['avg_batch_time'] * 1e3:.3f} avg, "
          f"{perf['min_batch_time'] * 1e3:.3f} min, "
          f"{perf['max_batch_time'] * 1e3:.3f} max; metrics.json holds the "
          f"run's confusion matrix ({int(cm.sum())} pixels), dice mean "
          f"{summary['metrics']['dice']['mean']:.4f}", flush=True)
    return launched, dict(perf, batches=n_batches)


def phase_tools(workdir, dev="cuda", segformer="b3", size=256, clip_len=5,
                batch=TRAIN_BATCH, loader_ref=None):
    """(c) of phase 9: ``cli.bench_loader.main --per_stage`` over phase 6's
    gathered tree, and a Trainer run with ``profile_dir``."""
    import glob

    from vivim_tpu_torch.cli import bench_loader
    from vivim_tpu_torch.cli.common import build_model
    from vivim_tpu_torch.train.logging import MetricLogger
    from vivim_tpu_torch.train.trainer import Trainer, TrainerConfig

    dev = torch.device(dev)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench_loader.main(["--data_root", os.path.join(workdir, "gathered"),
                           "--image_size", str(size), "--clip_length",
                           str(clip_len), "--batch_size", str(batch),
                           "--num_workers", "4", "--epochs", "1",
                           "--per_stage"])
    line = buf.getvalue().strip().splitlines()[-1]
    loader = json.loads(line)
    print(f"bench_loader: {line}", flush=True)
    print(f"bench_loader: {loader['value'] / clip_len:.3f} clips/s on 4 "
          "threads" + (f" beside phase 6's loader alone, {loader_ref:.3f} "
                       "clips/s" if loader_ref else ""), flush=True)

    model, _ = build_model(model_args(segformer), device=dev, seed=0)
    prof_dir = os.path.join(workdir, "profile")
    reset_counts()
    Trainer(model, TrainerConfig(epochs=1, seed=0, device=str(dev),
                                 profile_dir=prof_dir, profile_steps=1),
            Requests(make_requests(3, clip_len, size, 3, seed=6,
                                   batch=batch)),
            [], os.path.join(workdir, "profile_ckpt"),
            MetricLogger(os.path.join(workdir, "profile_logs"))).fit()
    launched = counts()
    traces = glob.glob(os.path.join(prof_dir, "*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"profile_dir holds {traces}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    scans = sum("selective_scan" in e.get("name", "") for e in events
                if e.get("cat") == "kernel")
    if dev.type == "cuda" and not scans:
        raise AssertionError("the trace holds no selective-scan kernel")
    print(f"profile: Trainer.fit with profile_dir wrote "
          f"{os.path.basename(traces[0])}, "
          f"{os.path.getsize(traces[0]) / 2**20:.1f} MiB, {len(events)} "
          f"events, {scans} selective-scan kernel events (step 1)",
          flush=True)
    return launched, dict(loader=loader, trace_events=len(events),
                          trace_scan_kernels=scans)


def _par_model(segformer, dev, mesh=None, base=None):
    """The CLI-built Vivim (seed 0) with every dropout and drop-path at 0,
    or a copy of ``base`` (config and weights), its scans sharded over
    ``mesh``'s seq axis when it has one."""
    from vivim_tpu_torch.cli.common import build_model
    from vivim_tpu_torch.nn.vivim import Vivim

    if base is None:
        base, cfg = build_model(model_args(segformer), device="cpu", seed=0)
        cfg = dataclasses.replace(
            cfg, drop_path_rate=0.0, dropout_rate=0.0,
            segformer=dataclasses.replace(cfg.segformer, drop_path_rate=0.0,
                                          classifier_dropout=0.0))
    else:
        cfg = base.cfg
    if mesh is not None and mesh.size("seq") > 1:
        cfg = dataclasses.replace(cfg, seq_axis="seq", mesh=mesh)
    model = Vivim(cfg)
    model.load_state_dict(base.state_dict())
    return model.to(dev)


def _par_step_inputs(size, clip_len, batch):
    b = make_requests(1, clip_len, size, 3, seed=11, batch=batch)[0]
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _par_rank(rank, world, port, out_dir, spec):
    """One rank of phase 10 (a spawned process): (a) one step per mode
    (dp2, zero2, seq2) from the seeded state (seq2 first runs its sharded
    eval forward of that state), then one more; (b) ``train_folds.main`` with
    ``-n_devices 2 -zero true``, then with ``-seq_shards 2``.  Writes
    ``rank<r>.json`` (and rank 0 the states after the first step), or
    ``rank<r>.err`` with its traceback."""
    try:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                          MASTER_PORT=str(port))
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        # the host's cores shared between the ranks and this script
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // (world + 1)))
        from vivim_tpu_torch.cli import train_folds
        from vivim_tpu_torch.parallel import comm, fsdp
        from vivim_tpu_torch.parallel import mesh as mesh_lib

        from vivim_tpu_torch.train import loop

        if spec.get("min_shard_elems"):  # the CPU rehearsal's tiny leaves
            fsdp.MIN_SHARD_ELEMS = spec["min_shard_elems"]
        mesh_lib.init_distributed("gloo", PAR_GROUP_TIMEOUT_S)
        dev = torch.device(spec["dev"])
        on_card = dev.type == "cuda"
        if on_card:
            torch.cuda.set_device(dev)
        sync = torch.cuda.synchronize if on_card else (lambda: None)
        seg, size, clip_len = spec["segformer"], spec["size"], spec["clip_len"]
        batch = _par_step_inputs(size, clip_len, PAR_BATCH)
        init = _par_model(seg, "cpu")
        res = {"backend": torch.distributed.get_backend(), "modes": {},
               "probe": _probe_collectives(dev, world)}
        for mode in ("dp2", "zero2", "seq2"):
            mesh = mesh_lib.make_mesh(world, "seq" if mode == "seq2"
                                      else "data")
            model = _par_model(seg, dev, mesh, init)
            state = loop.create_train_state(model, 1e-4, 1e-2, 2,
                                            seed=mesh.fold_seed(1))
            dp_bytes = fsdp.state_bytes_per_device(state)
            if mode == "zero2":
                _, specs = fsdp.shard_state_fsdp(state, mesh)
            step = loop.make_train_step(model, "recall_focused", 3,
                                        mesh=mesh)
            local = {k: v.to(dev) for k, v in
                     mesh_lib.shard_batch(batch, mesh).items()}
            out = {"clips": int(local["clip"].shape[0]), "ms": [],
                   "launches": [], "gathered": []}
            if mode == "seq2":  # the sharded forward of the seeded state
                model.eval()
                reset_counts()
                with torch.no_grad():
                    logits = model(batch["clip"][:1].to(dev))
                out["eval_launches"] = counts()
                if rank == 0:
                    torch.save(logits.cpu(), os.path.join(out_dir,
                                                          "seq2_logits.pt"))
                del logits
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            for i in range(2):
                reset_counts()
                comm.reset_counters()
                sync()
                t0 = time.perf_counter()
                state, m = step(state, local)
                sync()
                out["ms"].append((time.perf_counter() - t0) * 1e3)
                out["launches"].append(counts())
                out["gathered"].append(list(comm.GATHERED))
                if i == 0:
                    out.update(loss=float(m["loss"]),
                               grad_norm=float(m["grad_norm"]))
                    whole = (state.zero.full() if state.zero is not None
                             else contextlib.nullcontext())
                    with whole:
                        if rank == 0:
                            torch.save({k: v.cpu() for k, v in
                                        model.state_dict().items()},
                                       os.path.join(out_dir, f"{mode}.pt"))
                        # each tensor's sum: do the replicas agree?
                        out["sums"] = [float(v.double().sum()) for v in
                                       model.state_dict().values()
                                       if v.is_floating_point()]
            out["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                               if on_card else 0.0)
            out["state_bytes"] = fsdp.state_bytes_per_device(state)
            out["dp_state_bytes"] = dp_bytes
            if mode == "zero2":
                params = dict(model.named_parameters())
                out["replicated_bytes"] = sum(
                    3 * 4 * state.opt.params[i].numel()
                    for i, n in enumerate(state.opt.names)
                    if specs[n] is None)
                out["sharded_leaves"] = len(state.zero.leaves)
                out["at_rest_elems"] = sum(p.numel()
                                           for p in params.values())
            res["modes"][mode] = out
            del model, state, step, local
            if on_card:
                torch.cuda.empty_cache()
        res["cli"] = {}
        for name, flags in PAR_CLI_RUNS.items():
            reset_counts()
            comm.reset_counters()
            t0 = time.perf_counter()
            train_folds.main(spec["cli_argv"] + ["-exp_name", name] + flags)
            res["cli"][name] = dict(secs=time.perf_counter() - t0,
                                    launches=counts(),
                                    gathered=list(comm.GATHERED))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    except BaseException:
        import traceback

        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _probe_collectives(dev, world):
    """Which collectives the group's backend runs on ``dev``'s tensors,
    each checked by value: {name: "ok", "wrong values" or the error}."""
    import torch.distributed as dist

    x = torch.full((4,), float(dist.get_rank() + 1), device=dev)
    total = float(world * (world + 1) // 2)
    ranks = [float(i + 1) for i in range(world)]

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return bool((y == total).all())

    def broadcast():
        y = x.clone()
        dist.broadcast(y, 0)
        return bool((y == 1.0).all())

    def all_gather_into_tensor():
        y = torch.empty(4 * world, device=dev)
        dist.all_gather_into_tensor(y, x)
        return y.view(world, 4)[:, 0].tolist() == ranks

    def reduce_scatter_tensor():
        y = torch.empty(4 // world, device=dev)
        dist.reduce_scatter_tensor(y, x)
        return bool((y == total).all())

    out = {}
    for run in (all_reduce, broadcast, all_gather_into_tensor,
                reduce_scatter_tensor):
        try:
            out[run.__name__] = "ok" if run() else "wrong values"
        except RuntimeError as e:
            out[run.__name__] = str(e).splitlines()[0][:160]
        dist.barrier()
    return out


def _spawn_ranks(fn, world, out_dir, spec, wall_s):
    """``fn(rank, world, port, out_dir, spec)`` in ``world`` spawned
    processes; fails as soon as one fails (the others are killed) with its
    traceback, and kills them all at ``wall_s``."""
    import multiprocessing
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=fn, args=(r, world, port, out_dir, spec))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.perf_counter() - t0 > wall_s:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(10)
    errs = [open(os.path.join(out_dir, f"rank{r}.err")).read()
            for r in range(world)
            if os.path.exists(os.path.join(out_dir, f"rank{r}.err"))]
    if errs or any(p.exitcode != 0 for p in procs):
        raise AssertionError(
            f"the ranks ended with exit codes "
            f"{[p.exitcode for p in procs]} after "
            f"{time.perf_counter() - t0:.1f} s\n" + "\n".join(errs))
    return time.perf_counter() - t0


def phase_parallel(workdir, dev="cuda", segformer="b3", size=256,
                   clip_len=5, min_shard_elems=None):
    """Phase 10: the multi-rank training path with two ranks on one card
    over gloo.  (a) one step of each mode against the one-device step of
    the same seeded state on the whole batch; (b) ``train_folds.main`` in
    the two ranks on phase 6's tree, with ``-n_devices 2 -zero true`` and
    with ``-seq_shards 2``, and ``cli.infer.main`` on each run's
    checkpoints in this process.  ``min_shard_elems`` lowers ZeRO's
    threshold (a CPU rehearsal's tiny model).  Returns (launches,
    summary)."""
    from vivim_tpu_torch.train import loop

    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    per_pass = LAYERS_PER_STAGE * len(STAGES)
    t_phase = time.perf_counter()
    # the reference: one device, the whole batch, the same seeded state
    batch = _par_step_inputs(size, clip_len, PAR_BATCH)
    model = _par_model(segformer, dev).eval()
    with torch.no_grad():
        ref_logits = model(batch["clip"][:1].to(dev)).cpu()
    state = loop.create_train_state(model, 1e-4, 1e-2, 2, seed=1)
    _, m = loop.make_train_step(model, "recall_focused", 3)(
        state, {k: v.to(dev) for k, v in batch.items()})
    ref = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
               sd={k: v.cpu() for k, v in model.state_dict().items()})
    del model, state
    if on_card:
        torch.cuda.empty_cache()
    out_dir = os.path.join(workdir, "parallel")
    os.makedirs(out_dir)
    cli_argv = ["-data_path", os.path.join(workdir, "folds"),
                "-num_folds", "1", "-segformer",
                segformer, "-image_size", str(size), "-clip_length",
                str(clip_len), "-train_bs", str(PAR_BATCH), "-val_bs",
                str(PAR_BATCH), "-epochs", "1", "-val_freq", "1",
                "-max_numerosity", str(PAR_CLI_CLIPS), "-num_workers", "2",
                "-device", f"{dev.type}:0" if on_card else "cpu",
                "-dist_backend", "gloo", "-save_path",
                os.path.join(workdir, "par_runs")]
    spec = dict(dev="cuda:0" if on_card else "cpu", segformer=segformer,
                size=size, clip_len=clip_len, cli_argv=cli_argv,
                min_shard_elems=min_shard_elems)
    print(f"parallel: 2 ranks over gloo, both on {spec['dev']}"
          + (" (one card shared; gloo, a host library, moves CUDA tensors "
             "through host memory)" if on_card else ""), flush=True)
    secs = _spawn_ranks(_par_rank, 2, out_dir, spec, PAR_WALL_S)
    ranks = [json.load(open(os.path.join(out_dir, f"rank{r}.json")))
             for r in range(2)]
    summary = {"backend": ranks[0]["backend"], "ranks": 2,
               "device": spec["dev"], "spawn_s": secs, "modes": {},
               "probe": ranks[0]["probe"]}
    print(f"parallel: {ranks[0]['backend']} on {spec['dev']} tensors, "
          f"checked by value: {ranks[0]['probe']}", flush=True)
    launched = {"K1 inference": 0, "K1 training": 0, "K2": 0}
    label = "2 ranks over gloo on one card, not a multi-card figure"
    for mode in ("dp2", "zero2", "seq2"):
        sd = torch.load(os.path.join(out_dir, f"{mode}.pt"),
                        weights_only=True)
        per = [r["modes"][mode] for r in ranks]
        for r, o in enumerate(per):
            if abs(o["loss"] - ref["loss"]) > 1e-5 * abs(ref["loss"]):
                raise AssertionError(f"{mode} rank {r}: loss {o['loss']} "
                                     f"vs one device {ref['loss']}")
            want = {"K1 inference": 0, "K1 training": per_pass,
                    "K2": per_pass}
            if on_card and any(l != want for l in o["launches"]):
                raise AssertionError(f"{mode} rank {r} launched "
                                     f"{o['launches']}, expected {want}")
            for c in o["launches"]:
                for k in launched:
                    launched[k] += c[k]
        drift = max(abs(a - b) for a, b in zip(per[0]["sums"],
                                               per[1]["sums"]))
        if drift:
            raise AssertionError(f"{mode}: the ranks' parameters differ "
                                 f"after the step (sums {drift:.3e} apart)")
        worst = 0.0
        for k, v in ref["sd"].items():
            if v.is_floating_point():
                torch.testing.assert_close(sd[k], v, rtol=1e-3, atol=2e-3,
                                           msg=f"{mode} {k}")
                worst = max(worst, (sd[k] - v).abs().max().item())
        summary["modes"][mode] = dict(
            loss=per[0]["loss"], grad_norm=per[0]["grad_norm"],
            ref_loss=ref["loss"], param_max_abs_err=worst,
            step_ms=[o["ms"] for o in per], peak_gib=[o["peak_gib"]
                                                     for o in per],
            launches_per_step=per[0]["launches"][0],
            replica_sum_max_diff=drift,
            gathered_per_step=[o["gathered"][1] for o in per],
            state_bytes=[o["state_bytes"] for o in per],
            clips_per_rank=per[0]["clips"], timing=label)
        print(f"parallel {mode}: loss {per[0]['loss']:.7f} vs "
              f"{ref['loss']:.7f} (one device, batch {PAR_BATCH}); every "
              f"parameter after the step within rtol 1e-3 / atol 2e-3, max "
              f"abs err {worst:.3e}; launches per step and rank "
              f"{per[0]['launches'][0]}; the two ranks' parameter sums "
              f"{drift:.3e} apart", flush=True)
        for r, o in enumerate(per):
            print(f"parallel {mode} rank {r}: {o['clips']} clips, step ms "
                  f"{o['ms'][0]:.1f} first, {o['ms'][1]:.1f} second "
                  f"({label}); peak {o['peak_gib']:.2f} GiB; params + "
                  f"moments {o['state_bytes'] / 2**20:.1f} MiB; all_gathers "
                  f"per step {o['gathered'][1][0]}, "
                  f"{o['gathered'][1][1] / 2**20:.1f} MiB sent", flush=True)
        if mode == "dp2":
            dp_sd = sd
        if mode == "zero2":
            for k, v in dp_sd.items():
                if v.is_floating_point():
                    torch.testing.assert_close(sd[k], v, rtol=2e-4,
                                               atol=2e-4, msg=f"zero2 {k}")
            for r, o in enumerate(per):
                cap = (0.5 * (o["dp_state_bytes"] - o["replicated_bytes"])
                       + o["replicated_bytes"])
                if o["sharded_leaves"] < 1 or o["state_bytes"] > cap:
                    raise AssertionError(
                        f"zero2 rank {r}: {o['state_bytes']} bytes of "
                        f"params + moments, cap {cap}")
            zdiff = max((sd[k] - v).abs().max().item()
                        for k, v in dp_sd.items() if v.is_floating_point())
            summary["modes"]["zero2"].update(
                max_abs_diff_from_dp2=zdiff,
                sharded_leaves=per[0]["sharded_leaves"],
                model_elems_at_rest=per[0]["at_rest_elems"])
            print(f"parallel zero2: within {zdiff:.3e} of dp2; "
                  f"{per[0]['sharded_leaves']} leaves sharded; params + "
                  f"moments per rank {per[0]['state_bytes'] / 2**20:.1f} "
                  f"MiB vs {per[0]['dp_state_bytes'] / 2**20:.1f} MiB "
                  f"under dp2 ({per[0]['replicated_bytes'] / 2**20:.2f} "
                  f"MiB replicated); between steps the model's own "
                  f"parameters hold {per[0]['at_rest_elems']} elements "
                  "(the slices live in the optimizer)", flush=True)
        if mode == "seq2":
            logits = torch.load(os.path.join(out_dir, "seq2_logits.pt"),
                                weights_only=True)
            err = (logits - ref_logits).abs().max().item()
            if not err <= 1e-3:
                raise AssertionError(f"seq2 logits {err:.3e} from one "
                                     "device's")
            for r, o in enumerate(per):
                want = {"K1 inference": per_pass, "K1 training": 0, "K2": 0}
                if on_card and o["eval_launches"] != want:
                    raise AssertionError(f"seq2 rank {r} forward launched "
                                         f"{o['eval_launches']}")
                for k in launched:
                    launched[k] += o["eval_launches"][k]
            summary["modes"]["seq2"]["logits_max_abs_err"] = err
            print(f"parallel seq2: eval logits of the seeded state within "
                  f"{err:.3e} of one device's; launches per forward and rank "
                  f"{per[0]['eval_launches']}", flush=True)
    summary["cli"] = {}
    for name in PAR_CLI_RUNS:
        runs = [r["cli"][name] for r in ranks]
        for r, c in enumerate(runs):
            n = c["launches"]
            if on_card and (n["K1 training"] != n["K2"]
                            or n["K1 training"] % per_pass
                            or n["K1 inference"] % per_pass
                            or not n["K1 training"]):
                raise AssertionError(f"cli {name} rank {r} launched {n}")
            for k in launched:
                launched[k] += n[k]
        run = os.path.join("par_runs", name, "fold_0")
        recs = [json.loads(x) for x in open(os.path.join(
            workdir, run, "metrics.jsonl"))]
        validated = "-val_freq" not in PAR_CLI_RUNS[name]
        if sum("config" in x for x in recs) != 1 or validated != any(
                "val/dice" in x for x in recs):
            raise AssertionError(f"cli {name}: metrics.jsonl holds "
                                 f"{len(recs)} records")
        inf_launched, perf = phase_infer_ckpt(workdir, dev, segformer, size,
                                              clip_len, run=run,
                                              out=f"infer_{name}")
        for k in launched:
            launched[k] += inf_launched[k]
        summary["cli"][name] = dict(
            secs=[c["secs"] for c in runs], launches=[c["launches"]
                                                     for c in runs],
            gathered=[c["gathered"] for c in runs], infer_fps=perf["fps"])
        print(f"parallel cli {name}: train_folds in 2 ranks "
              f"{runs[0]['secs']:.1f} s, launches per rank "
              f"{[c['launches'] for c in runs]}; cli.infer read its "
              "checkpoint on one card", flush=True)
    summary["secs"] = time.perf_counter() - t_phase
    print(f"parallel: phase {summary['secs']:.1f} s, of which the ranks "
          f"{secs:.1f} s", flush=True)
    return launched, summary


def _p2p_rank(rank, world, port, out_dir, spec):
    """One rank of a point-to-point probe (``_probe_p2p``): ``spec["op"]``
    between the two ranks on ``spec["dev"]``'s tensors, checked by value;
    writes ``rank<r>.json``."""
    import datetime

    import torch.distributed as dist

    res = {}
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=20))
        dev = torch.device(spec["dev"])
        x = torch.full((1024,), float(rank + 1), device=dev)
        y = torch.zeros(1024, device=dev)
        if spec["op"] == "send/recv":
            if rank == 0:
                dist.send(x, 1)
            else:
                dist.recv(y, 0)
            ok = rank == 0 or bool((y == 1.0).all())
        else:
            works = dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, x, 1 - rank),
                 dist.P2POp(dist.irecv, y, 1 - rank)])
            for w in works:
                w.wait()
            ok = bool((y == float(2 - rank)).all())
        res["result"] = "ok" if ok else "wrong values"
    except RuntimeError as e:
        res["result"] = str(e).splitlines()[0][:160]
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
        if dist.is_initialized():
            dist.destroy_process_group()


def _probe_p2p(dev, workdir):
    """Whether gloo's point-to-point calls (``send`` / ``recv`` and
    ``batch_isend_irecv``) move ``dev``'s tensors between two ranks, each
    op in its own pair of processes, both pairs at once: either call of
    CUDA tensors may abort its process, so this cannot run in
    ``_probe_collectives``'s working ranks.  {op: "ok",
    "wrong values", the error, or the exit codes of a pair that died}."""
    import multiprocessing
    import socket

    ctx = multiprocessing.get_context("spawn")
    pairs = {}
    for op in ("send/recv", "batch_isend_irecv"):
        out_dir = os.path.join(workdir, f"p2p_{op.replace('/', '_')}")
        os.makedirs(out_dir)
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        procs = [ctx.Process(target=_p2p_rank, args=(
            r, 2, port, out_dir, {"dev": str(dev), "op": op}))
            for r in range(2)]
        for p in procs:
            p.start()
        pairs[op] = (out_dir, procs)
    t0 = time.perf_counter()
    found = {}
    for op, (out_dir, procs) in pairs.items():
        for p in procs:
            p.join(max(1.0, P2P_WALL_S - (time.perf_counter() - t0)))
            if p.is_alive():
                p.kill()
                p.join(10)
        results = []
        for r in range(2):
            path = os.path.join(out_dir, f"rank{r}.json")
            results.append(json.load(open(path)).get("result")
                           if os.path.exists(path) else None)
        codes = [p.exitcode for p in procs]
        if results == ["ok", "ok"]:
            found[op] = "ok"
        else:
            found[op] = (f"exit codes {codes}; " + "; ".join(
                f"rank {r}: {x}" for r, x in enumerate(results)))
    return found


def next_token_loss(logits, toks):
    """Mean cross-entropy of each position's next token."""
    logp = torch.log_softmax(logits[:, :-1].float(), -1)
    return -logp.gather(-1, toks[:, 1:, None]).mean()


def lmp_pairs(n, seed=12):
    """``n`` seeded (context, continuation) string pairs of lowercase
    letters: contexts of 20 to 100 characters, continuations of 3 to 12."""
    import random

    rng = random.Random(seed)
    text = lambda k: "".join(rng.choice("abcdefghijklmnopqrstuvwxyz ")
                             for _ in range(k))
    return [(text(rng.randint(20, 100)), text(rng.randint(3, 12)))
            for _ in range(n)]


def _lmp_tensors(spec, dev):
    """The seeded tokens of phase 11: (batch, prompt) for the gradient
    checks, its first row for decode."""
    g = torch.Generator().manual_seed(21)
    toks = torch.randint(0, spec["vocab"], (spec["batch"], spec["prompt"]),
                         generator=g)
    return toks.to(dev)


def _max_err(got, want):
    return (got.detach().float() - want.to(got.device).float()).abs().max(
        ).item()


def _leaf_err(g, want):
    """(largest abs error, that over the leaf's largest |want|)."""
    err = _max_err(g, want)
    scale = want.abs().max().item()
    return err, (err / scale if scale > 0 else (0.0 if err == 0 else
                                                math.inf))


def _check_grads(grads, ref, what):
    """Every gradient within rtol 1e-3 / atol 2e-3 of ``ref``'s tensor of
    the same name, and each leaf's largest error within ``GRAD_REL`` of
    its largest |ref|: most of the LM's gradients are below 2e-3, where
    the absolute bound alone would pass a gradient scaled by k or 1/k.
    {max_abs_err, max_rel_err (over the leaves), least_scale (the
    smallest leaf's largest |ref|)}."""
    out = dict(max_abs_err=0.0, max_rel_err=0.0, least_scale=math.inf)
    for k, g in grads.items():
        want = ref[k].to(g.device)
        torch.testing.assert_close(g, want, rtol=1e-3, atol=2e-3,
                                   msg=f"{what} {k}")
        err, rel = _leaf_err(g, want)
        if not rel <= GRAD_REL:
            raise AssertionError(
                f"{what} {k}: max abs err {err:.3e} is {rel:.3e} of the "
                f"leaf's largest |grad|, above {GRAD_REL}")
        out.update(max_abs_err=max(out["max_abs_err"], err),
                   max_rel_err=max(out["max_rel_err"], rel),
                   least_scale=min(out["least_scale"],
                                   want.abs().max().item()))
    return out


def _grad_text(e):
    return (f"max abs err {e['max_abs_err']:.3e}, at most "
            f"{e['max_rel_err']:.3e} of a leaf's largest |grad| (limit "
            f"{GRAD_REL}; the smallest leaf's largest |grad| "
            f"{e['least_scale']:.3e})")


def _replicas_equal(tensors, group):
    """Whether every rank of ``group`` holds the same bits in each tensor
    (rank 0's broadcast and compared)."""
    from vivim_tpu_torch.parallel import comm

    same = True
    for t in tensors:
        mine = t.detach().contiguous()
        theirs = comm.broadcast_(mine.clone(), 0, group)
        same = same and torch.equal(mine, theirs)
    return same


def _lmp_grad_run(forward, params, toks, sync):
    """Two forward + backward runs of the next-token loss from leaves
    cloned off ``params``: (logits, grads, each run's launches of its
    forward and backward, the first run's launches of its forward, the
    comm counters of its forward and of its backward, ms of the second
    run)."""
    from vivim_tpu_torch.parallel import comm

    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    out = {"launches_runs": []}
    for i in range(2):
        for p in leaves.values():
            p.grad = None
        reset_counts()
        comm.reset_counters()
        sync()
        t0 = time.perf_counter()
        logits = forward(leaves)
        fwd_counts = counts()
        fwd_comm = dict(reduced=list(comm.REDUCED), hopped=list(comm.HOPPED))
        comm.reset_counters()
        next_token_loss(logits, toks).backward()
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        out["launches_runs"].append(counts())
        if i == 0:
            out.update(logits=logits.detach(), launches_fwd=fwd_counts,
                       comm_fwd=fwd_comm,
                       comm_bwd=dict(reduced=list(comm.REDUCED),
                                     hopped=list(comm.HOPPED)))
        else:
            out["ms"] = ms
    out["grads"] = {k: p.grad for k, p in leaves.items()
                    if p.grad is not None}
    out["held"] = sum(p.numel() for p in leaves.values())
    return out


def _lmp_rank(rank, world, port, out_dir, spec):
    """One rank of phase 11 (a spawned process): tp2 (the forward and
    gradients from this rank's split, ``tp_generate``, the bench CLI in
    fp32 and bf16, int8 refused, the eval core), then pp2 (the forward and
    gradients from this rank's stage, the eval core), each held against
    the parent's one-device reference in ``spec["ref"]``.  Writes
    ``rank<r>.json``, or ``rank<r>.err`` with its traceback."""
    try:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                          MASTER_PORT=str(port))
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // (world + 1)))
        from vivim_tpu_torch.cli import bench_generation
        from vivim_tpu_torch.cli.lm_eval_harness import MambaEvalCore, load_lm
        from vivim_tpu_torch.parallel import comm
        from vivim_tpu_torch.parallel import mesh as mesh_lib
        from vivim_tpu_torch.parallel import pipeline as pp
        from vivim_tpu_torch.parallel import tensor_parallel as tp

        mesh_lib.init_distributed("gloo", PAR_GROUP_TIMEOUT_S)
        dev = torch.device(spec["dev"])
        on_card = dev.type == "cuda"
        if on_card:
            torch.cuda.set_device(dev)
        sync = torch.cuda.synchronize if on_card else (lambda: None)
        ref = torch.load(spec["ref"], mmap=True, weights_only=True)
        model, params = load_lm(None, 0, 0, 0, hf_dir=spec["snap"],
                                device=dev)
        cfg = model.cfg
        toks = _lmp_tensors(spec, dev)
        tok = CharTokenizer(cfg.vocab_size)
        res = {"modes": {}}

        def peak():
            return torch.cuda.max_memory_allocated() / 2**30 if on_card \
                else 0.0

        def score(core):
            """(each pair's score, the launches of all of them)."""
            reset_counts()
            out = [core.loglikelihood_pair(ctx, cont)
                   for ctx, cont in spec["pairs"]]
            return out, counts()

        # tp2: this rank's split of every mixer, on a "model" axis
        mesh = mesh_lib.make_mesh(world, axis="model")
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        local = tp.split_tp_params(params, mesh)
        run = _lmp_grad_run(lambda p: tp.lm_tp_forward(cfg, p, toks, mesh),
                            local, toks, sync)
        want = tp.split_tp_params(ref["grads"], mesh)
        tp2 = dict(
            logits_err=_max_err(run["logits"], ref["logits"]),
            grad_err=_check_grads(run["grads"], want, "tp2"),
            replicated_equal=_replicas_equal(
                [g for k, g in run["grads"].items()
                 if ".mixer." not in k or k.endswith("out_proj.bias")],
                mesh.group("model")),
            **{k: run[k] for k in ("launches_runs", "launches_fwd",
                                   "comm_fwd", "comm_bwd", "ms", "held")})
        # the prefill alone (no new token), then the whole decode: their
        # difference over the new tokens is each token's all_reduces
        reset_counts()
        comm.reset_counters()
        tp.tp_generate(model, local, toks[:1], 0, mesh)
        tp2.update(prefill_launches=counts(),
                   prefill_reduced=list(comm.REDUCED))
        reset_counts()
        comm.reset_counters()
        sync()
        t0 = time.perf_counter()
        out = tp.tp_generate(model, local, toks[:1], spec["gen"], mesh,
                             top_k=1, generator=torch.Generator(
                                 device=dev).manual_seed(1))
        sync()
        tp2.update(generate_ms=(time.perf_counter() - t0) * 1e3,
                   generate_launches=counts(),
                   generate_reduced=list(comm.REDUCED),
                   tokens_equal=torch.equal(out.cpu(), ref["tokens"]))
        tp2["peak_gib"] = peak()
        del local, run, want
        bench = {}
        for dtype in ("float32", "bfloat16"):
            buf = io.StringIO()
            reset_counts()
            with contextlib.redirect_stdout(buf):
                bench_generation.main([
                    "--hf_dir", spec["snap"], "--tp_shards", str(world),
                    "--dist_backend", "gloo", "--device", spec["dev"],
                    "--dtype", dtype, "--genlen", str(spec["gen"]),
                    "--repeats", "1"])
            bench[dtype] = dict(lines=buf.getvalue().strip().splitlines(),
                                launches=counts())
        try:
            bench_generation.main(["--tp_shards", str(world), "--dtype",
                                   "int8", "--device", spec["dev"]])
            bench["int8"] = "ran"
        except SystemExit as e:
            bench["int8"] = str(e)
        tp2["bench"] = bench
        core = MambaEvalCore(model, params, tok, tp_shards=world)
        tp2["core_held"] = sum(v.numel() for v in core.params.values())
        tp2["scores"], tp2["score_launches"] = score(core)
        del core
        res["modes"]["tp2"] = tp2

        # pp2: this rank's stage of the layers beside the embedding and
        # norm_f, on a "pipe" axis
        mesh = mesh_lib.make_mesh(world, axis="pipe")
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        lps = cfg.n_layer // world
        mine = range(mesh.index("pipe") * lps, (mesh.index("pipe") + 1) * lps)
        local = {k: v for k, v in params.items()
                 if not k.startswith("backbone.layers.")
                 or int(k.split(".")[2]) in mine}
        run = _lmp_grad_run(
            lambda p: pp.lm_pp_forward(cfg, p, toks, mesh,
                                       n_micro=spec["n_micro"]),
            local, toks, sync)
        pp2 = dict(
            logits_err=_max_err(run["logits"], ref["logits"]),
            grad_err=_check_grads(run["grads"], ref["grads"], "pp2"),
            replicated_equal=_replicas_equal(
                [g for k, g in run["grads"].items()
                 if not k.startswith("backbone.layers.")],
                mesh.group("pipe")),
            held_layers=[min(mine), max(mine)],
            **{k: run[k] for k in ("launches_runs", "launches_fwd",
                                   "comm_fwd", "comm_bwd", "ms", "held")})
        pp2["peak_gib"] = peak()
        del local, run
        pp2["scores"], pp2["score_launches"] = score(
            MambaEvalCore(model, params, tok, pp_stages=world))
        res["modes"]["pp2"] = pp2
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    except BaseException:
        import traceback

        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def phase_lm_parallel(peaks=None, dev="cuda", config=LM_CONFIG,
                      batch=LMP_BATCH, prompt=LMP_PROMPT, gen_len=LMP_GEN,
                      n_micro=LMP_MICRO):
    """Phase 11: the LM's tensor-parallel and pipeline paths at mamba-130m
    width.  (a) In this process: K1-training and K2 at the LM's shapes
    (whole and half of d_inner) against their plain versions; the
    one-device ``MambaLM`` gradients of a next-token loss through the
    kernels against the same model on the plain scan; the one-device
    logits, gradients, greedy tokens and eval-core scores the ranks are
    held against.  (b) gloo's point-to-point calls probed on this device's
    tensors.  (c) Two ranks on this device over gloo (``_lmp_rank``).
    ``dev="cpu"`` rehearses the host side at a small ``config``.  Returns
    (launches, summary)."""
    from vivim_tpu_torch.cli.lm_eval_harness import MambaEvalCore, load_lm
    from vivim_tpu_torch.nn import lm

    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_phase = time.perf_counter()
    summary = {"timing": LMP_LABEL}
    launched = {"K1 inference": 0, "K1 training": 0, "K2": 0}

    def add(c):
        for k in launched:
            launched[k] += c[k]

    if on_card:  # (a) the kernels at the LM's shapes
        d_inner = 2 * config["d_model"]
        gen = torch.Generator(device="cuda").manual_seed(5)
        summary["fwd_rows"], summary["bwd_rows"] = train_kernel_rows(
            peaks, [(f"lm d={d}", prompt, d) for d in (d_inner,
                                                       d_inner // 2)],
            batch, gen, "LM")
    with tempfile.TemporaryDirectory() as work:
        snap = os.path.join(work, "snap")
        os.makedirs(snap)
        write_lm_snapshot(snap, config)
        model, params = load_lm(None, 0, 0, 0, hf_dir=snap, device=dev)
        cfg = model.cfg
        spec = dict(dev=f"{dev.type}:0" if on_card else "cpu", snap=snap,
                    ref=os.path.join(work, "ref.pt"), vocab=cfg.vocab_size,
                    batch=batch, prompt=prompt, gen=gen_len, n_micro=n_micro,
                    pairs=lmp_pairs(LMP_PAIRS))
        toks = _lmp_tensors(spec, dev)
        # (a) one device, through the kernels and through the plain scan
        ref_model = lm.MambaLM(cfg, scan_implementation="ref")
        ref_model.load_state_dict(model.state_dict())
        ref_model = ref_model.to(dev)
        runs = {}
        for name, m in (("kernels", model), ("plain", ref_model)):
            reset_counts()
            logits = m(toks)
            loss = next_token_loss(logits, toks)
            loss.backward()
            sync()
            runs[name] = dict(
                logits=logits.detach(), loss=loss.item(), launches=counts(),
                grads={k: p.grad for k, p in m.named_parameters()})
        got, want = runs["kernels"], runs["plain"]
        add(got["launches"])
        per = cfg.n_layer
        if on_card and got["launches"] != {"K1 inference": 0,
                                           "K1 training": per, "K2": per}:
            raise AssertionError(f"one-device LM step launched "
                                 f"{got['launches']}")
        if abs(got["loss"] - want["loss"]) > 1e-5 * abs(want["loss"]):
            raise AssertionError(f"LM loss {got['loss']} through the kernels"
                                 f", {want['loss']} on the plain scan")
        one_err = _check_grads(got["grads"], want["grads"], "one-device LM")
        # the check must fail a gradient scaled by 1/k (k = 2), the fault
        # of a missing or wrong adjoint, on every leaf
        passed = [k for k, g in got["grads"].items()
                  if _leaf_err(0.5 * g, want["grads"][k])[1] <= GRAD_REL]
        if passed:
            raise AssertionError(f"the gradient check passes halved "
                                 f"gradients of {passed}")
        summary["one_device"] = dict(
            loss=got["loss"], plain_loss=want["loss"], grad_err=one_err,
            logits_err=_max_err(got["logits"], want["logits"]),
            launches=got["launches"])
        print(f"lm parallel: one device, batch {batch} x {prompt}, "
              f"next-token loss {got['loss']:.7f} through K1-training + K2 "
              f"vs {want['loss']:.7f} on the plain scan; every gradient "
              f"within rtol 1e-3 / atol 2e-3, {_grad_text(one_err)}; "
              f"every leaf halved fails the check; launches "
              f"{got['launches']}", flush=True)
        del ref_model, runs, want
        model.zero_grad(set_to_none=True)
        # the reference of the ranks: the kernels' run, greedy tokens and
        # scores on one device
        reset_counts()
        ref_tokens = lm.generate(
            model, params, toks[:1], gen_len, top_k=1,
            generator=torch.Generator(device=dev).manual_seed(1))
        core = MambaEvalCore(model, params, CharTokenizer(cfg.vocab_size))
        ref_scores = [core.loglikelihood_pair(c, x) for c, x in spec["pairs"]]
        add(counts())
        torch.save({"logits": got["logits"].cpu(), "tokens": ref_tokens.cpu(),
                    "grads": {k: g.cpu() for k, g in got["grads"].items()}},
                   spec["ref"])
        del model, params, got, core
        if on_card:
            torch.cuda.empty_cache()
        # (b) gloo's point-to-point calls on this device's tensors
        summary["p2p_probe"] = _probe_p2p(dev, work)
        print(f"lm parallel: gloo point-to-point on {spec['dev']} tensors, "
              f"checked by value: {summary['p2p_probe']}", flush=True)
        # (c) the ranks
        out_dir = os.path.join(work, "ranks")
        os.makedirs(out_dir)
        secs = _spawn_ranks(_lmp_rank, 2, out_dir, spec, LMP_WALL_S)
        ranks = [json.load(open(os.path.join(out_dir, f"rank{r}.json")))
                 for r in range(2)]
    summary["spawn_s"] = secs
    lps = cfg.n_layer // 2
    want_launches = {
        "tp2": {"K1 inference": 0, "K1 training": per, "K2": per},
        "pp2": {"K1 inference": 0,
                "K1 training": lps * (n_micro + 1),
                "K2": lps * (n_micro + 1)}}
    for mode in ("tp2", "pp2"):
        per_rank = [r["modes"][mode] for r in ranks]
        for r, o in enumerate(per_rank):
            if not o["logits_err"] <= 1e-3:
                raise AssertionError(f"{mode} rank {r}: logits "
                                     f"{o['logits_err']:.3e} from one "
                                     "device's")
            if not o["replicated_equal"]:
                raise AssertionError(f"{mode} rank {r}: the replicated "
                                     "leaves' gradients differ between ranks")
            for run in o["launches_runs"]:
                if on_card and run != want_launches[mode]:
                    raise AssertionError(f"{mode} rank {r} launched {run} "
                                         "in a forward + backward, "
                                         f"expected {want_launches[mode]}")
            # every scoring forward: n_micro 1, so a pipeline stage runs
            # its layers at each of its k ticks
            want_score = (lps * 2 if mode == "pp2" else per) * len(
                o["scores"])
            if on_card and o["score_launches"] != {
                    "K1 inference": want_score, "K1 training": 0, "K2": 0}:
                raise AssertionError(f"{mode} rank {r}: {len(o['scores'])} "
                                     "scoring forwards launched "
                                     f"{o['score_launches']}, expected "
                                     f"{want_score} K1 inference")
            if mode == "tp2" and o["core_held"] != o["held"]:
                raise AssertionError(f"tp2 rank {r}: the eval core holds "
                                     f"{o['core_held']} parameters, its "
                                     f"split {o['held']}")
            for (ll, greedy), (ll1, greedy1) in zip(o["scores"], ref_scores):
                if abs(ll - ll1) > 1e-3 or greedy != greedy1:
                    raise AssertionError(
                        f"{mode} rank {r}: score {ll} ({greedy}) vs one "
                        f"device's {ll1} ({greedy1})")
            for run in o["launches_runs"]:
                add(run)
            add(o["score_launches"])
            print(f"lm parallel {mode} rank {r}: logits within "
                  f"{o['logits_err']:.3e} of one device's, gradients "
                  f"{_grad_text(o['grad_err'])}; launches per "
                  f"forward {o['launches_fwd']}, per forward + backward "
                  f"{o['launches_runs'][0]} (both runs alike); all_reduces "
                  "per forward "
                  f"{o['comm_fwd']['reduced'][0]} "
                  f"({o['comm_fwd']['reduced'][1] / 2**20:.2f} MiB), per "
                  f"backward {o['comm_bwd']['reduced'][0]} "
                  f"({o['comm_bwd']['reduced'][1] / 2**20:.2f} MiB); hops "
                  f"per forward {o['comm_fwd']['hopped'][0]} "
                  f"({o['comm_fwd']['hopped'][1] / 2**10:.0f} KiB), per "
                  f"backward {o['comm_bwd']['hopped'][0]}; parameters held "
                  f"{o['held'] / 1e6:.2f} M; peak {o['peak_gib']:.2f} GiB; "
                  f"forward + backward {o['ms']:.1f} ms, second call "
                  f"({LMP_LABEL}); {len(o['scores'])} eval-core scores "
                  f"within 1e-3 of one device's, greedy flags equal, "
                  f"{o['score_launches']['K1 inference']} K1 in the "
                  f"{len(o['scores'])} scoring forwards"
                  + (f"; the eval core holds {o['core_held'] / 1e6:.2f} M "
                     "parameters, its split" if mode == "tp2" else ""),
                  flush=True)
        summary[mode] = [{k: v for k, v in o.items() if k != "bench"}
                         for o in per_rank]
    tp2 = [r["modes"]["tp2"] for r in ranks]
    for r, o in enumerate(tp2):
        n_tok, tok_bytes = ((g - p) / gen_len for g, p in zip(
            o["generate_reduced"], o["prefill_reduced"]))
        if not o["tokens_equal"]:
            raise AssertionError(f"tp_generate rank {r}: tokens differ from "
                                 "one device's generate")
        if on_card and o["generate_launches"]["K1 inference"] != per:
            raise AssertionError(f"tp_generate rank {r} launched "
                                 f"{o['generate_launches']}")
        if n_tok != 2 * per or o["prefill_reduced"][0] != 2 * per:
            raise AssertionError(
                f"tp_generate rank {r}: {o['prefill_reduced'][0]} "
                f"all_reduces in the prefill and {n_tok} per decode token, "
                f"expected {2 * per} each")
        if on_card and o["prefill_launches"]["K1 inference"] != per:
            raise AssertionError(f"tp_generate prefill rank {r} launched "
                                 f"{o['prefill_launches']}")
        add(o["generate_launches"])
        add(o["prefill_launches"])
        for dtype in ("float32", "bfloat16"):
            b = o["bench"][dtype]
            add(b["launches"])
            if on_card and b["launches"]["K1 inference"] != 2 * per:
                raise AssertionError(f"bench --tp_shards {dtype} rank {r} "
                                     f"launched {b['launches']}")
        if "single-device decode only" not in o["bench"]["int8"]:
            raise AssertionError(f"bench --dtype int8 --tp_shards rank {r}: "
                                 f"{o['bench']['int8']}")
        print(f"lm parallel tp_generate rank {r}: {gen_len} tokens at top-k "
              f"1 from a (1, {prompt}) prompt equal to one device's "
              f"generate; {o['generate_launches']['K1 inference']} K1 per "
              f"generate; all_reduces: {o['prefill_reduced'][0]} in the "
              f"prefill ({o['prefill_reduced'][1] / 2**20:.2f} MiB), "
              f"{n_tok:.0f} per decode token ({tok_bytes / 2**10:.1f} KiB); "
              f"{o['generate_ms']:.1f} ms ({LMP_LABEL})", flush=True)
    lines = {}
    for dtype in ("float32", "bfloat16"):
        if tp2[1]["bench"][dtype]["lines"]:
            raise AssertionError(f"bench {dtype}: rank 1 printed")
        line = tp2[0]["bench"][dtype]["lines"][-1]
        lines[dtype] = json.loads(line)
        print(f"lm parallel bench_generation --tp_shards 2 --dtype {dtype} "
              f"(rank 0; {LMP_LABEL}): {line}", flush=True)
    print(f"lm parallel: bench_generation --dtype int8 --tp_shards 2 stops: "
          f"{tp2[0]['bench']['int8']}", flush=True)
    summary["bench"] = lines
    summary["secs"] = time.perf_counter() - t_phase
    print(f"lm parallel: phase {summary['secs']:.1f} s, of which the ranks "
          f"{secs:.1f} s", flush=True)
    return launched, summary


def _moe_tokens(cfg, dev, batch=MOE_BATCH, prompt=MOE_PROMPT):
    g = torch.Generator().manual_seed(31)
    return torch.randint(0, cfg.vocab_size, (batch, prompt),
                         generator=g).to(dev)


def moe_loss(cfg, logits, aux, toks):
    """The MoE LM's training loss: next-token CE + aux_loss_weight x aux."""
    return next_token_loss(logits, toks) + cfg.aux_loss_weight * aux


@contextlib.contextmanager
def recorded_routing(log):
    """Append (dispatch, top-1 minus top-2 gate per token) of every
    ``moe_dispatch`` call in the block to ``log`` (``moe_ffn`` calls it
    through its module)."""
    from vivim_tpu_torch.nn import moe

    real = moe.moe_dispatch

    def dispatch(probs, capacity, top_k=1):
        out = real(probs, capacity, top_k)
        top2 = probs.detach().topk(2, dim=-1).values
        log.append((out[0].detach().clone(), top2[:, 0] - top2[:, 1]))
        return out

    moe.moe_dispatch = dispatch
    try:
        yield log
    finally:
        moe.moe_dispatch = real


def _moe_grad_run(cfg, forward, params, toks):
    """(loss, logits, aux, {name: grad}, launches) of one forward +
    backward of the MoE loss from leaves cloned off ``params``."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    reset_counts()
    logits, aux = forward(leaves)
    loss = moe_loss(cfg, logits, aux, toks)
    loss.backward()
    return (loss.item(), logits.detach(), aux.item(),
            {k: p.grad for k, p in leaves.items()}, counts())


def phase_moe_lm(dev="cuda", config=None, batch=MOE_BATCH,
                 prompt=MOE_PROMPT):
    """Phase 12a: the MoE-Mamba LM at mamba-130m width and depth on one
    device, seeded there (``nn.moe.init_moe_lm``).  A scoring forward and a
    gradient step of the MoE loss through the kernels, each against the
    same weights on the plain scan: logits, aux and loss, every routing
    decision bit-equal, every gradient (and every leaf halved must fail
    the bound); launches, ms, peak, profile.  ``dev="cpu"`` rehearses the
    host side at a small ``config``.  Returns (launches, summary)."""
    from vivim_tpu_torch.nn import moe

    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    cfg = moe.MoEMambaLMConfig(**(config or MOE_CONFIG))
    model = moe.init_moe_lm(cfg, seed=0, device=dev).eval()
    n_params = sum(p.numel() for p in model.parameters())
    n_experts = sum(p.numel() for k, p in model.named_parameters()
                    if k.split(".")[-1] in ("wi", "wo"))
    toks = _moe_tokens(cfg, dev, batch, prompt)
    n_moe = sum(cfg.has_moe(i) for i in range(cfg.n_layer))
    per = cfg.n_layer
    print(f"moe lm: {cfg.n_layer} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab_size} -> {cfg.padded_vocab}, RMSNorm, {n_moe} MoE "
          f"blocks of {cfg.n_experts} experts (d_ff "
          f"{cfg.d_ff or 4 * cfg.d_model}, capacity factor "
          f"{cfg.capacity_factor}, top-{cfg.top_k}); {n_params / 1e6:.2f} M "
          f"parameters ({n_experts / 1e6:.2f} M in experts, "
          f"{4 * n_params / 2**30:.2f} GiB fp32), seeded on {dev} in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    launched = {"K1 inference": 0, "K1 training": 0, "K2": 0}

    def add(c):
        for k in launched:
            launched[k] += c[k]

    # the scoring forward, through the kernels and on the plain scan
    runs = {}
    for name, impl in (("kernels", None), ("plain", "ref")):
        model.scan_implementation = impl
        with recorded_routing([]) as routes, torch.no_grad():
            reset_counts()
            logits, aux = model(toks)
            c = counts()
        runs[name] = dict(logits=logits, aux=aux.item(), routes=routes,
                          launches=c)
    got, want = runs["kernels"], runs["plain"]
    add(got["launches"])
    if on_card and got["launches"] != {"K1 inference": per,
                                       "K1 training": 0, "K2": 0}:
        raise AssertionError(f"MoE LM forward launched {got['launches']}")
    logits_err = _max_err(got["logits"], want["logits"])
    if not logits_err <= 1e-3:
        raise AssertionError(f"MoE LM logits {logits_err:.3e} from the "
                             "plain scan's")
    if abs(got["aux"] - want["aux"]) > 1e-5 * abs(want["aux"]):
        raise AssertionError(f"MoE LM aux {got['aux']} through the kernels, "
                             f"{want['aux']} on the plain scan")
    gaps = torch.cat([g for _, g in got["routes"]])
    differ = []
    for i, ((d, g), (d0, _)) in enumerate(zip(got["routes"],
                                              want["routes"])):
        if not torch.equal(d, d0):
            rows = (d != d0).flatten(1).any(1).nonzero().flatten()
            differ.append((i, [(int(t), g[t].item()) for t in rows[:8]]))
    if len(got["routes"]) != n_moe or len(want["routes"]) != n_moe or differ:
        raise AssertionError(
            f"MoE routing differs from the plain scan's in "
            f"{len(differ)} of {n_moe} blocks; (block, [(token, top-1 minus "
            f"top-2 gate)]): {differ}; the smallest gap over all "
            f"{gaps.numel()} decisions {gaps.min().item():.3e}")
    kept = sum(int(d.sum().item()) for d, _ in got["routes"])
    routing = dict(decisions=gaps.numel(), min_gap=gaps.min().item(),
                   kept=kept, dropped=gaps.numel() - kept)
    print(f"moe lm: forward of ({batch}, {prompt}) tokens: logits within "
          f"{logits_err:.3e} and aux {got['aux']:.7f} within "
          f"{abs(got['aux'] - want['aux']):.2e} of the plain scan's; every "
          f"one of the {routing['decisions']} routing decisions bit-equal, "
          f"the smallest top-1 minus top-2 gate {routing['min_gap']:.3e}; "
          f"{routing['dropped']} tokens over capacity; launches "
          f"{got['launches']}", flush=True)
    del runs, got, want

    # the gradient step, through the kernels and on the plain scan
    params = dict(model.named_parameters())
    fwd = lambda p: moe.moe_lm_forward(cfg, p, toks, model.scan_implementation)
    model.scan_implementation = None
    loss, _, _, grads, c = _moe_grad_run(cfg, fwd, params, toks)
    add(c)
    if on_card and c != {"K1 inference": 0, "K1 training": per, "K2": per}:
        raise AssertionError(f"MoE LM gradient step launched {c}")
    model.scan_implementation = "ref"
    loss0, _, _, grads0, _ = _moe_grad_run(cfg, fwd, params, toks)
    model.scan_implementation = None
    if abs(loss - loss0) > 1e-5 * abs(loss0):
        raise AssertionError(f"MoE LM loss {loss} through the kernels, "
                             f"{loss0} on the plain scan")
    grad_err = _check_grads(grads, grads0, "MoE LM")
    passed = [k for k, g in grads.items()
              if _leaf_err(0.5 * g, grads0[k])[1] <= GRAD_REL]
    if passed:
        raise AssertionError(f"the gradient check passes halved gradients "
                             f"of {passed}")
    print(f"moe lm: gradient step, next-token loss + "
          f"{cfg.aux_loss_weight} x aux {loss:.7f} through K1-training + K2 "
          f"vs {loss0:.7f} on the plain scan; every gradient within rtol "
          f"1e-3 / atol 2e-3, {_grad_text(grad_err)}; every leaf halved "
          f"fails the check; launches {c}", flush=True)
    del grads, grads0
    summary = dict(params_m=n_params / 1e6, expert_params_m=n_experts / 1e6,
                   logits_err=logits_err, routing=routing, loss=loss,
                   plain_loss=loss0, grad_err=grad_err)
    if on_card:
        def forward():
            with torch.no_grad():
                model(toks)

        def step():
            for p in params.values():
                p.grad = None
            logits, aux = model(toks)
            moe_loss(cfg, logits, aux, toks).backward()

        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        summary.update(fwd_ms=cuda_ms(forward, 5), step_ms=cuda_ms(step, 3))
        add(counts())
        summary["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        reset_counts()
        summary["profile_fwd"] = phase_profile("moe lm forward", forward)
        summary["profile_step"] = phase_profile("moe lm step", step)
        add(counts())
        print(f"moe lm: forward {summary['fwd_ms']:.3f} ms, forward + "
              f"backward {summary['step_ms']:.3f} ms (CUDA events, median); "
              f"peak {summary['peak_gib']:.2f} GiB", flush=True)
    summary["secs"] = time.perf_counter() - t_phase
    return launched, summary


def _ep_rank(rank, world, port, out_dir, spec):
    """One rank of phase 12b (a spawned process): the seeded MoE LM, its
    one-device forward and gradients (the reference), then this rank's
    expert split alone through ``lm_ep_forward`` twice (the second timed).
    Writes ``rank<r>.json`` and the gradients' errors, or ``rank<r>.err``
    with its traceback."""
    try:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                          MASTER_PORT=str(port))
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // (world + 1)))
        from vivim_tpu_torch.nn import moe
        from vivim_tpu_torch.parallel import comm, expert
        from vivim_tpu_torch.parallel import mesh as mesh_lib

        mesh_lib.init_distributed("gloo", PAR_GROUP_TIMEOUT_S)
        dev = torch.device(spec["dev"])
        on_card = dev.type == "cuda"
        if on_card:
            torch.cuda.set_device(dev)
        sync = torch.cuda.synchronize if on_card else (lambda: None)
        cfg = moe.MoEMambaLMConfig(**spec["config"])
        mesh = mesh_lib.make_mesh(world, axis="expert")
        toks = _moe_tokens(cfg, dev, spec["batch"], spec["prompt"])
        model = moe.init_moe_lm(cfg, seed=0, device=dev)
        full = {k: v.detach() for k, v in model.named_parameters()}
        # the one-device reference, then only this rank's share of it
        _, logits0, aux0, grads0, _ = _moe_grad_run(
            cfg, lambda p: moe.moe_lm_forward(cfg, p, toks), full, toks)
        grads0 = expert.split_ep_params(grads0, mesh)
        local = expert.split_ep_params(full, mesh)
        held_equal = all(
            torch.equal(v, full[k].narrow(0, mesh.index("expert")
                                          * v.shape[0], v.shape[0]))
            for k, v in local.items() if v.shape != full[k].shape)
        del model, full
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        res = {"held": sum(v.numel() for v in local.values()),
               "held_equal": held_equal, "runs": []}
        for _ in range(2):
            leaves = logits = None  # the last run's copies and gradients
            leaves = {k: v.clone().requires_grad_(True)
                      for k, v in local.items()}
            comm.reset_counters()
            reset_counts()
            sync()
            t0 = time.perf_counter()
            logits, aux = expert.lm_ep_forward(cfg, leaves, toks, mesh)
            fwd_comm = dict(gathered=list(comm.GATHERED),
                            reduced=list(comm.REDUCED))
            comm.reset_counters()
            moe_loss(cfg, logits, aux, toks).backward()
            sync()
            res["runs"].append(dict(
                ms=(time.perf_counter() - t0) * 1e3, launches=counts(),
                comm_fwd=fwd_comm,
                comm_bwd=dict(gathered=list(comm.GATHERED),
                              reduced=list(comm.REDUCED))))
        grads = {k: p.grad for k, p in leaves.items()}
        res.update(
            logits_err=_max_err(logits, logits0),
            aux=aux.item(), aux0=aux0,
            grad_err=_check_grads(grads, grads0, f"ep2 rank {rank}"),
            replicated_equal=_replicas_equal(
                [g for k, g in grads.items()
                 if k.split(".")[-1] not in ("wi", "wo")], comm.world()),
            peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                      if on_card else 0.0))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    except BaseException:
        import traceback

        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def phase_moe_ep(dev="cuda", config=None, batch=MOE_BATCH,
                 prompt=MOE_PROMPT):
    """Phase 12b: ep2, two ranks on this device over gloo, each holding 4
    of 8 experts per block, held against its own one-device forward and
    gradients of the same seeded weights (``_ep_rank``).  Returns
    (launches, summary)."""
    t_phase = time.perf_counter()
    cfg_kw = config or MOE_CONFIG
    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    world = 2
    spec = dict(dev=f"{dev.type}:0" if on_card else "cpu", config=cfg_kw,
                batch=batch, prompt=prompt)
    with tempfile.TemporaryDirectory() as out_dir:
        secs = _spawn_ranks(_ep_rank, world, out_dir, spec, MOE_WALL_S)
        ranks = [json.load(open(os.path.join(out_dir, f"rank{r}.json")))
                 for r in range(world)]
    from vivim_tpu_torch.nn import moe

    cfg = moe.MoEMambaLMConfig(**cfg_kw)
    n_moe = sum(cfg.has_moe(i) for i in range(cfg.n_layer))
    per = cfg.n_layer
    cap = moe.moe_capacity(batch * prompt, cfg.n_experts, cfg.capacity_factor)
    block = cfg.n_experts * cap * cfg.d_model * 4  # (E, C, M) fp32 bytes
    launched = {"K1 inference": 0, "K1 training": 0, "K2": 0}
    for r, o in enumerate(ranks):
        if not o["logits_err"] <= 1e-3:
            raise AssertionError(f"ep2 rank {r}: logits {o['logits_err']:.3e}"
                                 " from its one-device forward")
        if abs(o["aux"] - o["aux0"]) > 1e-5 * abs(o["aux0"]):
            raise AssertionError(f"ep2 rank {r}: aux {o['aux']}, one device "
                                 f"{o['aux0']}")
        if not (o["replicated_equal"] and o["held_equal"]):
            raise AssertionError(f"ep2 rank {r}: replicated gradients equal "
                                 f"{o['replicated_equal']}, held experts its "
                                 f"split {o['held_equal']}")
        for run in o["runs"]:
            if on_card and run["launches"] != {
                    "K1 inference": 0, "K1 training": per, "K2": per}:
                raise AssertionError(f"ep2 rank {r} launched "
                                     f"{run['launches']}")
            want = dict(fwd_gathered=[n_moe, n_moe * block // world],
                        fwd_reduced=[0, 0], bwd_gathered=[0, 0],
                        bwd_reduced=[n_moe, n_moe * block])
            seen = dict(fwd_gathered=run["comm_fwd"]["gathered"],
                        fwd_reduced=run["comm_fwd"]["reduced"],
                        bwd_gathered=run["comm_bwd"]["gathered"],
                        bwd_reduced=run["comm_bwd"]["reduced"])
            if seen != want:
                raise AssertionError(f"ep2 rank {r}: collectives {seen}, "
                                     f"expected {want}")
            for k in launched:
                launched[k] += run["launches"][k]
        print(f"moe ep2 rank {r}: logits within {o['logits_err']:.3e} and "
              f"aux within {abs(o['aux'] - o['aux0']):.2e} of its one-device "
              f"run, gradients {_grad_text(o['grad_err'])}; replicated "
              f"leaves' gradients bit-equal on both ranks; holds "
              f"{o['held'] / 1e6:.2f} M parameters (its "
              f"{cfg.n_experts // world} of {cfg.n_experts} experts per "
              f"block, equal to its split); per forward + backward "
              f"{o['runs'][0]['launches']} (both runs alike); {n_moe} "
              f"all_gathers forward, each of an ({cfg.n_experts}, {cap}, "
              f"{cfg.d_model}) fp32 block, {block / 2**20:.3f} MiB "
              f"({block / world / 2**20:.3f} MiB sent per rank), {n_moe} "
              f"all_reduces backward ({block / 2**20:.3f} MiB each); forward +"
              f" backward {o['runs'][1]['ms']:.1f} ms, second call "
              f"({LMP_LABEL}); peak {o['peak_gib']:.2f} GiB", flush=True)
    summary = dict(timing=LMP_LABEL, spawn_s=secs, block_mib=block / 2**20,
                   ranks=ranks, secs=time.perf_counter() - t_phase)
    return launched, summary


def phase_segformer(dev="cuda", size=SEG_SIZE, labels=SEG_LABELS,
                    segformer="b3"):
    """Phase 12c: ``SegformerForSemanticSegmentation`` (MiT-b3, the ADE
    head's 150 labels; seeded weights) on one ``size`` px image: eval
    logits on ``dev`` within 1e-3 of the same weights on the CPU; ms and
    peak.  No scan kernel on this path."""
    from vivim_tpu_torch.nn import segformer as sf
    from vivim_tpu_torch.nn.layers import init_weights

    t_phase = time.perf_counter()
    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    base = sf.mit_b3() if segformer == "b3" else sf.mit_tiny_test()
    cfg = dataclasses.replace(base, num_labels=labels)
    model = init_weights(sf.SegformerForSemanticSegmentation(cfg),
                         torch.Generator().manual_seed(0)).eval()
    x = torch.randn(1, size, size, 3, generator=torch.Generator()
                    .manual_seed(2))
    with torch.no_grad():
        want = model(x)
        model = model.to(dev)
        xd = x.to(dev)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        got = model(xd)
    err = _max_err(got, want)
    if got.shape != (1, size // 4, size // 4, labels) or not err <= 1e-3:
        raise AssertionError(f"SegFormer logits {tuple(got.shape)}, "
                             f"{err:.3e} from the CPU's")
    summary = dict(logits_err=err, shape=list(got.shape),
                   params_m=sum(p.numel() for p in model.parameters()) / 1e6)
    if on_card:
        def forward():
            with torch.no_grad():
                model(xd)

        summary["ms"] = cuda_ms(forward, 5)
        summary["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"segformer: {segformer} ({summary['params_m']:.2f} M parameters, "
          f"{labels} labels) on one {size} px image: logits "
          f"{tuple(got.shape)} within {err:.3e} of the CPU's"
          + (f"; {summary['ms']:.3f} ms per forward (CUDA events, median of "
             f"5), peak {summary['peak_gib']:.2f} GiB" if on_card else ""),
          flush=True)
    summary["secs"] = time.perf_counter() - t_phase
    return summary


def phase_int8_eval(dev="cuda"):
    """Phase 12d: ``cli.int8_eval.main`` at its defaults on ``dev`` (the
    ``INT8_EVAL_*`` environment may shrink it): every training step must
    launch K1-training and K2 once per layer, the trained NLL end below the
    uniform ln 32, every variant's NLL be finite.  Returns (launches,
    the result)."""
    from vivim_tpu_torch.cli import int8_eval

    t_phase = time.perf_counter()
    on_card = torch.device(dev).type == "cuda"
    steps = []
    real = int8_eval.make_optimizer

    def make_optimizer(model, n):
        opt = real(model, n)
        step = opt.step

        def counted():
            c = counts()
            steps.append((c["K1 training"], c["K2"]))
            return step()

        opt.step = counted
        return opt

    _, n_layer, n_steps, n_eval = int8_eval.env_config()
    int8_eval.make_optimizer = make_optimizer
    try:
        with tempfile.TemporaryDirectory() as tmp:
            reset_counts()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                res = int8_eval.main(["--device", str(dev), "--out",
                                      os.path.join(tmp, "int8_eval.json")])
            launched = counts()
    finally:
        int8_eval.make_optimizer = real
    per_step = {(b[0] - a[0], b[1] - a[1])
                for a, b in zip([(0, 0)] + steps[:-1], steps)}
    if len(steps) != n_steps or (on_card and per_step != {(n_layer,
                                                            n_layer)}):
        raise AssertionError(f"int8 check: {len(steps)} steps launched "
                             f"{per_step} (K1-training, K2) each")
    if on_card and launched["K1 inference"] != 3 * n_eval * n_layer:
        raise AssertionError(f"int8 check: scoring launched {launched}")
    nlls = {k: v["nll_per_token"] for k, v in res["results"].items()}
    if not (res["final_train_nll"] < res["uniform_nll"]
            and all(math.isfinite(v) for v in nlls.values())):
        raise AssertionError(f"int8 check: trained to "
                             f"{res['final_train_nll']} (uniform "
                             f"{res['uniform_nll']}), NLLs {nlls}")
    print(f"int8 check: {res['config']}; train NLL {res['train_nll_curve']}"
          f" -> {res['final_train_nll']:.4f} (uniform "
          f"{res['uniform_nll']:.4f}); NLL per token fp32 "
          f"{nlls['float32']:.5f}, bf16 {nlls['bfloat16']:.5f}, int8 "
          f"{nlls['int8']:.5f}; deltas vs fp32 bf16 "
          f"{res['nll_delta_bf16_vs_fp32']:+.5f}, int8 "
          f"{res['nll_delta_int8_vs_fp32']:+.5f}; {res['seconds']:.1f} s "
          f"({res['train_seconds']:.1f} s training); launches {launched}, "
          f"(K1-training, K2) per step {sorted(per_step)} over "
          f"{len(steps)} steps; {res['card']}", flush=True)
    print(json.dumps(res), flush=True)
    res["launches"] = launched
    res["secs"] = time.perf_counter() - t_phase
    return launched, res


def lm_step_rows(rows):
    """The rows of one-device LM training's shape: (LMP_BATCH, LMP_PROMPT,
    d_inner)."""
    return [r for r in rows if r["d"] == 2 * LM_CONFIG["d_model"]]


def lm_step_text():
    return (f"LM training step: one launch per layer at ({LMP_BATCH}, "
            f"{LMP_PROMPT}, {2 * LM_CONFIG['d_model']}), "
            f"{LM_CONFIG['n_layer']} per step on one device (a tensor-"
            f"parallel rank's are at d {LM_CONFIG['d_model']}, in shapes), "
            f"fp32, {TIMING}")


def _kernel_entry(name, source, replaces, launches, rows, per,
                  weight=LAYERS_PER_STAGE, timed=None, **extra):
    """The kernels line's entry: times summed over the fp32 rows of
    ``timed`` (default: every timed row), ``weight`` launches each."""
    fp32 = [r for r in (rows if timed is None else timed)
            if r["dtype"] == "float32" and "ms" in r]
    by_term = {}  # bound ms by binding term, over the shapes
    for r in fp32:
        by_term[r["bound_term"]] = (by_term.get(r["bound_term"], 0.0)
                                    + weight * r["bound_ms"])
    term = max(by_term, key=by_term.get)
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in rows
                        if r["dtype"] == "float32"),
        per=per,
        ms=sum(weight * r["ms"] for r in fp32),
        call_ms=sum(weight * r["call_ms"] for r in fp32),
        plain_ms=sum(weight * r["plain_ms"] for r in fp32),
        bound_ms=sum(weight * r["bound_ms"] for r in fp32),
        bound_by="bytes" if term == "bytes" else "operations",
        bound_term=term, library_ms=None, ok=True, shapes=rows, **extra)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after phase 3b")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script runs only on a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vivim_tpu_torch.kernels import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("tf32: cudnn.allow_tf32=False cuda.matmul.allow_tf32=False")
    t_start = time.perf_counter()

    def done(phase, t0):
        print(f"phase {phase}: {time.perf_counter() - t0:.1f} s", flush=True)
        return time.perf_counter()

    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"build: {secs:.1f} s for {len(_build.SOURCES)} CUDA sources")
    for name, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas {name}: {line.strip()}")
    t0 = done("1 build", t0)

    card = nvidia_smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    peaks = card_peaks(kind)

    rows = phase_kernels(peaks)
    t0 = done("3 K1 inference", t0)
    fwd_rows, bwd_rows, ragged_err = phase_train_kernels(peaks)
    t0 = done("3b K1 training + K2", t0)
    if args.kernels_only:
        print(f"total: {time.perf_counter() - t_start:.1f} s; "
              "--kernels-only: stopped after phase 3b", flush=True)
        return
    serve_launched, _ = phase_serve()
    t0 = done("4 serve", t0)
    train_launched, train_perf = phase_train()
    t0 = done("5 train", t0)
    phase_train_vs_plain()
    t0 = done("5b train vs plain scan", t0)
    # phase 6's trees and runs stay here for phase 9
    work = tempfile.TemporaryDirectory()
    cli_launched, cli_perf = phase_train_cli(
        fp32_ref_ms=train_perf["fp32"]["median_ms"], workdir=work.name)
    t0 = done("6 train CLI", t0)
    binary_launched, binary_perf = phase_binary()
    t0 = done("7 binary and edge training", t0)
    lm_launched, lm_perf = phase_lm(peaks)
    t0 = done("8 LM serving", t0)
    with work:
        reset_counts()
        remat_perf = phase_remat()
        remat_launched = counts()
        t0 = done("9a remat", t0)
        infer_launched, infer_perf = phase_infer_ckpt(work.name)
        t0 = done("9b infer from a trainer checkpoint", t0)
        tools_launched, tools_perf = phase_tools(
            work.name, loader_ref=cli_perf["loader"]["clips_per_s"])
        t0 = done("9c host tools", t0)
        par_launched, par_perf = phase_parallel(work.name)
        t0 = done("10 parallel (2 ranks over gloo on one card)", t0)
    lmp_launched, lmp_perf = phase_lm_parallel(peaks)
    t0 = done("11 LM tensor parallel and pipeline (2 ranks over gloo on one "
              "card)", t0)
    moe_launched, moe_perf = phase_moe_lm()
    torch.cuda.empty_cache()
    t0 = done("12a MoE LM", t0)
    ep_launched, ep_perf = phase_moe_ep()
    t0 = done("12b MoE LM expert parallel (2 ranks over gloo on one card)",
              t0)
    seg_perf = phase_segformer()
    torch.cuda.empty_cache()
    t0 = done("12c SegFormer-b3", t0)
    int8_launched, int8_perf = phase_int8_eval()
    t0 = done("12d int8 check", t0)

    paths = {"serve": serve_launched, "train": train_launched,
             "train_cli": cli_launched, "binary_edge": binary_launched,
             "lm": lm_launched, "remat": remat_launched,
             "infer_ckpt": infer_launched, "profile": tools_launched,
             "parallel": par_launched, "lm_parallel": lmp_launched,
             "moe_lm": moe_launched, "moe_ep": ep_launched,
             "int8_eval": int8_launched}
    total = {k: sum(p[k] for p in paths.values())
             for k in ("K1 inference", "K1 training", "K2")}
    k1 = _kernel_entry(
        "selective_scan_fwd",
        "vivim_tpu_torch/kernels/csrc/selective_scan_fwd.cu",
        f"{JAX_PACKAGE}/kernels/selective_scan.py:174",
        total["K1 inference"] + total["K1 training"], rows,
        f"serving forward: {LAYERS_PER_STAGE} inference launches at each "
        f"stage shape (scan batch 3), fp32, {TIMING}",
        launches_by_path=paths,
        lm_prefill=_kernel_entry(
            "selective_scan_fwd (LM prefill)",
            "vivim_tpu_torch/kernels/csrc/selective_scan_fwd.cu",
            f"{JAX_PACKAGE}/kernels/selective_scan.py:174",
            lm_launched["K1 inference"], lm_perf["scan_rows"],
            f"LM prefill: one inference launch per layer at (1, "
            f"{LM_PROMPT}, {2 * LM_CONFIG['d_model']}), "
            f"{LM_CONFIG['n_layer']} per generate, fp32, {TIMING}",
            weight=LM_CONFIG["n_layer"],
            timed=[r for r in lm_perf["scan_rows"] if r["L"] == LM_PROMPT]),
        training_variant=_kernel_entry(
            "selective_scan_fwd (training variant)",
            "vivim_tpu_torch/kernels/csrc/selective_scan_fwd.cu",
            f"{JAX_PACKAGE}/kernels/selective_scan.py:174",
            total["K1 training"], fwd_rows,
            f"train step: {LAYERS_PER_STAGE} launches at each stage shape "
            f"(scan batch {TRAIN_SCAN_BATCH}), fp32, {TIMING}"),
        lm_training=_kernel_entry(
            "selective_scan_fwd (training variant, LM)",
            "vivim_tpu_torch/kernels/csrc/selective_scan_fwd.cu",
            f"{JAX_PACKAGE}/kernels/selective_scan.py:174",
            lmp_launched["K1 training"], lmp_perf["fwd_rows"],
            lm_step_text(), weight=LM_CONFIG["n_layer"],
            timed=lm_step_rows(lmp_perf["fwd_rows"])))
    k2 = _kernel_entry(
        "selective_scan_bwd",
        "vivim_tpu_torch/kernels/csrc/selective_scan_bwd.cu",
        f"{JAX_PACKAGE}/kernels/selective_scan.py:227",
        total["K2"], bwd_rows,
        f"train step: {LAYERS_PER_STAGE} launches at each stage shape "
        f"(scan batch {TRAIN_SCAN_BATCH}), fp32, {TIMING}",
        ragged_max_abs_err=ragged_err, launches_by_path=paths,
        lm=_kernel_entry(
            "selective_scan_bwd (LM)",
            "vivim_tpu_torch/kernels/csrc/selective_scan_bwd.cu",
            f"{JAX_PACKAGE}/kernels/selective_scan.py:227",
            lmp_launched["K2"], lmp_perf["bwd_rows"], lm_step_text(),
            weight=LM_CONFIG["n_layer"],
            timed=lm_step_rows(lmp_perf["bwd_rows"])))
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    lm_summary = {k: v for k, v in lm_perf.items() if k != "scan_rows"}
    lmp_summary = {k: v for k, v in lmp_perf.items()
                   if k not in ("fwd_rows", "bwd_rows")}
    print(json.dumps({"kernels": [k1, k2], "train": train_perf,
                      "train_cli": cli_perf, "binary_edge": binary_perf,
                      "lm": lm_summary, "remat": remat_perf,
                      "infer_ckpt": infer_perf, "tools": tools_perf,
                      "parallel": par_perf, "lm_parallel": lmp_summary,
                      "moe_lm": moe_perf, "moe_ep": ep_perf,
                      "segformer": seg_perf, "int8_eval": int8_perf}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
