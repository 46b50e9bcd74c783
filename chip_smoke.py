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
   and at Granite 4.0-H-Small's prefill (8, 4096, 8192) at d_state 128 in
   bf16 with no z, as ``streaming.mamba2_prefill`` passes it (x, B and C
   column views of the conv's output, each head's dt, A, D and dt bias
   over its 64 channels), timed, its output and last state held on
   head-aligned channel slices;
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
3c. hold the 3-D depthwise conv kernels (``kernels/dwconv3d.py``: one
   forward launch, a backward pair) against float64 ``F.conv3d`` at the
   Mix-FFN shapes of a serving forward (batch 1) and of a training step
   (batch 3), y and dx within 1e-5 and the weight and bias grads within
   1e-4 of their scale, then at ragged shapes with forced tiles; print
   each shape's tiles (float4 or scalar lanes, block lanes, block rows),
   replay ms, one eager call's ms, the kernels' us, the plain
   versions' ms, cuDNN's ms on the route the port took before the kernels
   (``F.conv3d`` with autograd), and the bytes bound;
3d. hold the decode step's kernels (``kernels/mamba_step.py``:
   ``conv_step`` and ``ssm_step``, which step the conv window and the ssm
   state in place) against their plain versions over 4 steps at
   mamba-130m's layer (1, 1536) with d_state 16, 64 and 256 in fp32 and at
   Jamba's (8, 8192, 16) in bf16, x, z, B and C as strided views, and at
   Granite 4.0-H-Small's Mamba-2 layer in bf16 as ``streaming.mamba2_step``
   passes it: ``conv_step`` over the (8, 8448) xBC window, ``ssm_step``
   per head (128 heads of 64, one group, d_state 128) on column views of
   one in_proj output and of the conv's output; print each kernel's replay
   us, one eager call's us, the plain version's us and the bytes bound;
3e. hold the prefill MoE's combine kernel (``kernels/moe_combine.py``)
   against its plain version, bit for bit, and against a second call of
   itself, at Granite 4.0-H-Small's prefill (32,768 tokens, top-10 of 72,
   M 4096, a shared expert, bf16) and at Jamba's (top-2 of 16, none); print
   its replay ms, one call's ms with its checks, the plain version's ms,
   the parent form's ms (an fp32 gate product of every row, ``index_add_``
   into a zeroed fp32 sum, the shared row added in fp32, a cast) and the
   bytes bound;
4. serve: full-width MiT-b3 Vivim (3 classes, random weights from a seed)
   answers 4 requests of one (1, 5, 256, 256, 3) clip through the port's
   ``run_inference``, whose forward, argmax and confusion counts are one
   CUDA graph, captured once and replayed per request: one capture, 4
   replays, K1 and the conv forward counted 8 times per forward that runs
   (2 warm-ups and 4 replays) and nothing else, the confusion matrix
   counting every pixel and equal to the same requests' eagerly in this
   call (fps and
   per-batch ms of both, their peak memory, and the memory one captured
   shape keeps, printed); the replayed logits within 1e-5 of the eager
   module's and 1e-3 of the same model on the plain scan; torch.profiler
   windows then split one eager forward's and one replay's device time by
   kernel group, with busy as the union and as the sum of kernel
   intervals and their overlap by kernel pair, and a replay must run the
   eager forward's K1 kernels; the forward graph's roots, forks and joins
   from its DOT dump (cudaGraphDebugDotPrint);
5. train: the same model, ``recall_focused``, batch 3: ``Trainer.fit`` for
   one epoch of 4 fp32 steps (the third captures the step and replays it,
   the fourth replays it) and a validation pass of 2 batches, then 3
   steps of ``make_train_step`` in bf16; every train step must launch
   K1-training 8 times and K2 8 times, every validation forward the
   inference K1 8 times; loss and grad norm finite; the checkpoint written
   must restore; step ms, clips/s, peak memory and a torch.profiler split
   of one replayed fp32 and one replayed bf16 step by kernel group;
5b. one fp32 step at full width, batch 1, dropouts 0, through the kernels
   and through the plain scan: loss within 1e-5 relative, every
   parameter's gradient within rtol 1e-3 / atol 2e-3;
5c. the replayed train step (``REPLAY_STEPS`` steps of batch 3: 2 eager,
   the capture, replays) against eager steps from the same start (one
   model copied, one generator seed), in fp32, in bf16 with
   ``grad_accum=3`` and in fp32 with the edge loss: launches per step
   equal, every step's metrics read after the last step, the generator's
   state equal, and loss, Jaccard, grad norm, parameters, buffers and
   both moments within 1e-6 (a leaf against the larger of its norm and
   the median leaf's), with a second eager fp32 run for the card's own
   floor; then ``Trainer.fit`` both ways over 2 epochs of 4 steps, and
   epoch 2 again after restoring epoch 1's checkpoint in place and in a
   new Trainer: every epoch's ``train/loss`` mean and every final state
   within 1e-6 of the eager run's; step ms and peak memory both ways;
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
   fp32 and int8 ``MambaEvalCore`` scoring forward (a ``generate`` decodes
   through the model's decode graph: one capture per bench run, a replay
   per token); (d) hold K1 against its
   plain version at (1, 128, 1536) and (1, 37, 1536), fp32 and bf16, output
   and last state, with device ms and bound; (e) the prefill's last logits
   and 32 teacher-forced scores (teacher: the plain-scan model's greedy
   tokens) within 1e-3 of the same model on the plain scan; (f) prefill
   ms, decode ms per token (CUDA events), kernels per token and the
   device's busy share of a decode step (torch.profiler), peak memory, for
   the decode graph's replay and the eager step, each launching the
   decode step's two kernels once a layer (``mamba_step.LAUNCHES``: 2 x 24
   a token in every dtype, in (b) and (c) too); (g) ``generate`` at the
   bench's defaults through the decode graph and through the eager loop
   (the mixer hook) in each dtype, tokens/s of both and their tokens
   equal, and in fp32 at top-k 0, temperature 1 from one seed;
8b. Jamba (``JAMBA_CONFIG``: AI21-Jamba2-Mini's config.json, its first 8
   layers, one period) in bf16 at full width: (a) K1 against its plain
   version at the prefill's shape (8, 4096, 8192) in bf16, B and C at unit
   RMS as the dt / B / C norms leave them, output and last state, with
   device and plain ms and bound; (b) ``load_jamba`` of the config's
   directory (seeded init, 13.3 B parameters on the card), a ``generate``
   that captures the decode graph, then 3 requests of (8, 4096) prompts
   and 16 new tokens with the counts zeroed just before them: 7 K1 a
   prefill, none in the 48 replays, no capture, no conv, the decode step's
   two kernels 2 x 7 a replay, the MoE combine 4 a prefill (one a MoE
   layer) and none in the replays; (c) the replayed
   hybrid step (Mamba step, GQA step against the K/V cache, dropless MoE
   step) within 1e-2 of the eager loop's scores, teacher-forced; (d) the
   decode graph's K/V position after a request, and its keys and values at
   the served positions within 0.05 (median, relative) of a prefill's over
   the served sequence; (e) prefill ms, decode ms per step, experts read
   per step, peak memory;
8c. Granite 4.0-H-Small (the benchmark's configuration file: the first 10
   layers, published widths) in bf16 from the seeded init: a ``generate``
   that captures the decode graph, then 2 requests of (8, 4096) prompts
   and 16 new tokens with the counts zeroed just before them: 9 K1 and 10
   MoE combines a prefill, neither in the 32 replays, no capture; one
   prefill's logits with the combine kernel against the same prefill with
   the parent's combine (``index_add_`` in fp32), and each prefill's ms;
   peak memory of the requests;
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
   matrix, one capture and a replay per batch (8 inference K1 counted
   per forward that runs: 2 warm-ups and every replay), fps and per-batch
   ms; (c)
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
13. d_state from 1 to 256 (the kernels take what the Pallas kernels take,
   up to mamba_ssm's own limit): (a) K1 (both variants) and K2 at the LM's
   shape (2, 128, 1536) at every d_state of ``DSTATE_NS`` (each family of
   the kernels and the masked widths 12 and 24) in fp32, in bf16 at 8, 64
   and 256, and at a long ragged (1, 2053, 256) at 4, 64 and 256, with an
   initial state and a non-zero last-state cotangent, each against its
   plain version (largest scaled error printed), the fp32 LM-shape cases
   timed (device ms, eager ms, bound); (b) the mamba-130m-width LM with
   ``ssm_cfg.d_state`` 8 and 64 from a seeded snapshot through ``load_lm``
   at (2, 128): the prefill's logits within 1e-3, ``generate``'s 16 greedy
   tokens equal to the plain scan's (24 K1 per call, 0 per decode token),
   two eval-core scores within 1e-3 (24 K1 each), a gradient step of
   next-token CE (24 K1-training, 24 K2) with phase 11's bounds, prefill,
   decode and step ms; the MoE LM at d_state 64, one (2, 128) scoring
   forward (24 K1): logits within 1e-3, every routing decision bit-equal;
   (c) constant (dim, dstate) B or C, alone, together and beside a grouped
   one, on the card (the sequential plain scan, as the JAX package routes
   it; no launch): output, last state and 9 gradients against the CPU's;
   d_state 257 refused;
14. print the kernels line (every K1 / K2 row by d_state under
   ``by_dstate``; the conv's forward and backward), the card line and,
   last, the device line.

Wherever Vivim runs (phases 4 to 10) the launch checks also count the
3-D conv's wrapper calls (``counts``): a conv forward beside each K1 of a
MambaLayer, with ``blocks`` remat's recompute, and a conv backward beside
each K2; the LM phases must call it not at all.

Each phase prints its seconds.  Without CUDA the script exits non-zero
before printing any result.  ``--kernels-only`` stops after phase 3d (a
quick check of the kernels on the card); ``--jamba-only`` runs phase 8b
alone after the build, ``--dstate-only`` phase 13, ``--train-replay-only``
phase 5c, ``--moe-combine-only`` phases 3e, 8b and 8c, ``--falcon-only``
phase 8d.
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
DW_FRAMES = 5               # the Mix-FFN 3-D convs' (T, H = W, C) at 5x256^2
DW_STAGES = ((64, 256), (32, 512), (16, 1280), (8, 2048))
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
# phase 3d: the decode step's kernels at mamba-130m's layer (batch 1,
# d_inner 1536) at three d_state and at Jamba's (batch 8, d_inner 8192)
STEP_SHAPES = ((1, 1536, 16, torch.float32), (1, 1536, 64, torch.float32),
               (1, 1536, 256, torch.float32), (8, 8192, 16, torch.bfloat16))
# phases 3 and 3d: Granite 4.0-H-Small's Mamba-2 layer (batch, heads,
# head_dim, d_state, groups), bf16, its prefill's prompt, and the channels
# of K1's output held against the plain scan (whole heads: the plain scan
# holds (batch, L, channels, d_state) fp32 twice)
GRANITE_MAMBA2 = (8, 128, 64, 128, 1)
GRANITE_PROMPT = 4096
GRANITE_HELD = (slice(0, 192), slice(4032, 4160), slice(8000, 8192))
# phase 9: make_train_step steps per remat level at the training batch (the
# first checked against none's, the median over the rest), and at the
# larger batch where the memory remat saves shows
REMAT_STEPS = 4
REPLAY_STEPS = 6            # phase 5c: train steps each way
REMAT_BIG_BATCH = 12
REMAT_BIG_STEPS = 3
# phase 10: the global batch of each mode's step, the clips per video of
# the train_folds runs (3 steps of fold 0), the runs' ranks and flags (the
# seq runs skip their validation, for time: (a) holds the sharded
# forward), the gloo timeout of the ranks and their wall limit (s)
PAR_BATCH = 4
PAR_CLI_CLIPS = 4
PAR_CLI_RUNS = {"zero2": (2, ["-n_devices", "2", "-zero", "true"]),
                "seq2": (2, ["-seq_shards", "2", "-val_freq", "2"]),
                "dp2_seq2": (4, ["-n_devices", "2", "-seq_shards", "2",
                                 "-val_freq", "2"])}
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
# phase 13: d_state other than 16.  (a) the kernels at every N family and
# masked width at the LM's shape (batch 2, prompt 128, d_inner 1536) in
# fp32, in bf16 at three N, and at a long ragged shape that takes several
# chunks and segments; (b) the mamba-130m-width LM at two d_state and the
# MoE LM at one, and the greedy tokens of generate; (c) constant B/C
DSTATE_NS = (1, 2, 4, 8, 12, 16, 24, 32, 64, 128, 256)
DSTATE_BF16 = (8, 64, 256)
DSTATE_SHAPE = (2, 128, 1536)
DSTATE_LONG = (1, 2053, 256)
DSTATE_LONG_NS = (4, 64, 256)
DSTATE_LM = (8, 64)
DSTATE_MOE = 64
DSTATE_GEN = 16
# phase 8b: Jamba as the benchmark's Jamba cell serves it: AI21-Jamba2-Mini's
# config.json as published, cut to its first 8 layers (one period: 7 Mamba
# mixers with dt / B / C norms, GQA attention at layer 4, 16 experts top-2
# at the odd layers), bf16, seeded weights; the cell's batch and prompt,
# fewer new tokens, and the requests whose launches are counted
JAMBA_CONFIG = {
    "attn_layer_offset": 4, "attn_layer_period": 8,
    "expert_layer_offset": 1, "expert_layer_period": 2,
    "hidden_act": "silu", "hidden_size": 4096, "intermediate_size": 14336,
    "mamba_conv_bias": True, "mamba_d_conv": 4, "mamba_d_state": 16,
    "mamba_dt_rank": 256, "mamba_expand": 2, "mamba_proj_bias": False,
    "max_position_embeddings": 262144, "model_type": "jamba",
    "num_attention_heads": 32, "num_experts": 16, "num_experts_per_tok": 2,
    "num_hidden_layers": 32, "num_key_value_heads": 8, "rms_norm_eps": 1e-06,
    "sliding_window": None, "tie_word_embeddings": False,
    "vocab_size": 65536}
JAMBA_LAYERS = 8
JAMBA_BATCH = 8
JAMBA_PROMPT = 4096
JAMBA_GEN = 16
JAMBA_REQUESTS = 3
# phase 3e: the MoE combine at the Granite and Jamba cells' prefill, 8 x 4096
# tokens of width 4096 in bf16: (label, top-k, experts, shared expert),
# and its calls a prefill (one a MoE layer)
COMBINE_SHAPES = (("Granite", 10, 72, True, 10), ("Jamba", 2, 16, False, 4))
COMBINE_TOKENS = 8 * 4096
COMBINE_WIDTH = 4096
# phase 8c: Granite as the benchmark's Granite cell runs it (its
# configuration file), the cell's batch and prompt, fewer new tokens
GRANITE_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "perfbench", "configs",
                              "granite-4.0-h-small-10l.json")
GRANITE_GEN = 16
GRANITE_REQUESTS = 2
# phase 8d: Falcon-H1-34B's Mamba-2 layer (batch, heads, head_dim, d_state,
# groups), bf16, the channels of K1's output held against the plain scan
# (whole heads inside one group: (batch, L, channels, d_state) fp32 twice),
# and its configuration file, cut to FALCON_LAYERS layers for the decode
# graph's check over FALCON_GEN tokens of FALCON_PROMPT-token prompts
FALCON_MAMBA2 = (8, 32, 128, 256, 2)
FALCON_HELD = (slice(0, 128), slice(2048, 2176), slice(3968, 4096))
FALCON_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "perfbench", "configs",
                             "falcon-h1-34b-18l.json")
FALCON_LAYERS = 2
FALCON_PROMPT = 512
FALCON_GEN = 16


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


def scan_work(batch, L, d, n, elem):
    """(bytes, fp32 operations, exps) of K1's inference variant at d_state
    ``n``: it reads u, delta, z, B, C and writes y; per state and step one
    exp and about six other operations, per channel and step about
    eight."""
    nbytes = (batch * L * (4 * d + 2 * n) * elem       # u, delta, z, y, B, C
              + batch * d * (2 * n + 2) * 4)            # A, last, D, bias
    return nbytes, batch * L * d * (6 * n + 8), batch * L * d * n


def train_fwd_work(batch, L, d, n, elem, chunk):
    """K1, training variant: reads u, delta, B, C, writes y and the chunk
    states, and the last state; no z."""
    nbytes = (batch * L * (3 * d + 2 * n) * elem
              + batch * -(-L // chunk) * d * n * 4
              + batch * d * (2 * n + 2) * 4)
    return nbytes, batch * L * d * (6 * n + 4), batch * L * d * n


def bwd_work(batch, L, d, n, elem, chunk):
    """K2, as the training step calls it (no dlast): reads u, delta, dy, B,
    C and the chunk states, writes ddelta, du, dB, dC and the per-batch
    parameter grads.  One exp per state and step: the recompute's h_t and
    the adjoint's g_{t-1} use the same exp(dt_t A); about 19 other
    operations per state and step and 20 per channel and step."""
    nbytes = (batch * L * (5 * d + 4 * n) * elem
              + batch * -(-L // chunk) * d * n * 4
              + batch * d * (2 * n + 2 + 4) * 4)      # A, D, bias; grads
    return nbytes, batch * L * d * (19 * n + 20), batch * L * d * n


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


def kernel_split(fn, calls=3, tries=5):
    """Device us per launch of each CUDA kernel of ``fn`` (torch.profiler
    over ``calls`` calls), keyed by a short name: K1's passes "local",
    "carry" and "out", K2's "local", "carry", "main", "sum" (dB / dC) and
    "sum_params", the conv's "dwconv3d_fwd", "dwconv3d_bwd" and
    "dwconv3d_bwd_sum".  Each is the mean over the events recorded for its
    key, since the profiler may record fewer launches than were made.  It
    may also record none of a session's kernels, more often after many
    sessions in one process (PERF.md): such a session is run again, up to
    ``tries`` sessions in all."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
    total, count = {}, {}
    for e in events:
        name = e.name
        if "selective_scan_fwd_carry" in name:
            key = "carry"
        elif "selective_scan_fwd_chunk" in name:
            # the pass is the template argument after the dtype (and the
            # d_state family)
            key = ("local" if re.search(
                r"chunk_kernel<[^,<]+, (?:[^<>]*Family<[^>]*>, )?0,", name)
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
        elif "dwconv3d" in name:
            key = next(k for k in ("dwconv3d_bwd_sum", "dwconv3d_bwd",
                                   "dwconv3d_fwd") if k in name)
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


def scan_inputs(batch, L, d, dtype, gen, strided=True, n=N):
    """Main-path-like inputs at d_state ``n``: B/C are column slices of one
    x_proj output and z is the second half of in_proj's output, as
    mamba_inner_grouped passes them."""
    dev = "cuda"
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
    u = rnd(batch, L, d).to(dtype)
    delta = (0.5 * rnd(batch, L, d)).to(dtype)
    rank = max(d // 32, 1)
    x_dbl = rnd(batch, L, rank + 2 * n).to(dtype)
    B, C = x_dbl[..., rank:rank + n], x_dbl[..., rank + n:]
    xz = rnd(batch, L, 2 * d).to(dtype)
    z = xz[..., d:]
    A = -(0.5 + torch.rand(batch, d, n, generator=gen, device=dev))
    D = rnd(batch, d)
    bias = 0.1 * rnd(batch, d)
    if not strided:
        B, C, z = B.contiguous(), C.contiguous(), z.contiguous()
    return u, delta, A, B, C, D, z, bias


def dtype_name(dtype):
    return str(dtype).split(".")[-1]


def sm_count():
    return torch.cuda.get_device_properties(0).multi_processor_count


def picked_chunk(batch, L, d, n=N):
    """(Lc, grid) K1's wrapper picks for a shape on this card."""
    from vivim_tpu_torch.kernels import selective_scan as ss

    channels = ss.fwd_channels(n)
    lc = ss.fwd_l_chunk(batch, L, d, sm_count(), channels)
    return lc, ss.fwd_grid(batch, L, d, lc, channels)


def picked_segment(batch, L, d, n=N):
    """(Ls, grid) K2's wrapper picks for a shape on this card."""
    from vivim_tpu_torch.kernels import selective_scan as ss

    channels = ss.bwd_channels(n)
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
            work = scan_work(SCAN_BATCH, L, d, N, got.element_size())
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
    rows.append(granite_scan_row(peaks, gen))
    return rows


def granite_scan_inputs(gen):
    """K1's operands as ``streaming.mamba2_prefill`` passes them at
    Granite's Mamba-2 layer, bf16: x, B and C column views of the conv's
    output; dt per head repeated over its channels; A, D and the dt bias
    fp32 per channel, each head's repeated (A = U[1, 16], the dt bias the
    inverse softplus of a dt log-uniform in [1e-3, 0.1], as the cell draws
    them)."""
    batch, heads, head_dim, n, groups = GRANITE_MAMBA2
    d = heads * head_dim
    dev = "cuda"
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
    rand = lambda *s: torch.rand(*s, generator=gen, device=dev)
    xbc = rnd(batch, GRANITE_PROMPT, d + 2 * groups * n).to(torch.bfloat16)
    dt = (0.5 * rnd(batch, GRANITE_PROMPT, heads)).to(torch.bfloat16)
    per_channel = lambda t: t.float().repeat_interleave(head_dim)
    A = -per_channel(1 + 15 * rand(heads))[:, None].expand(-1, n).contiguous()
    step = torch.exp(math.log(1e-3) + math.log(100) * rand(heads))
    bias = per_channel(step + torch.log(-torch.expm1(-step)))
    B, C = xbc[..., d:d + groups * n], xbc[..., d + groups * n:]
    if groups > 1:
        B, C = (t.unflatten(-1, (groups, n)) for t in (B, C))
    return (xbc[..., :d], dt.repeat_interleave(head_dim, -1), A, B, C,
            per_channel(1 + 0.1 * rnd(heads)), bias)


def granite_scan_row(peaks, gen):
    """K1 at Granite's prefill, no z: timed whole, its output and last
    state held against the plain scan on the channels ``GRANITE_HELD``
    (channels scan apart; B and C are shared)."""
    from vivim_tpu_torch.kernels import refs
    from vivim_tpu_torch.kernels import selective_scan as ss

    batch, heads, head_dim, n, _ = GRANITE_MAMBA2
    L, d = GRANITE_PROMPT, heads * head_dim
    u, delta, A, B, C, D, bias = granite_scan_inputs(gen)
    run = lambda: ss.selective_scan_fwd_cuda(u, delta, A, B, C, D=D, z=None,
                                             delta_bias=bias,
                                             delta_softplus=True)
    got = run()
    torch.cuda.synchronize()
    rtol, atol = TOL[torch.bfloat16]
    err = 0.0
    for c in GRANITE_HELD:
        want = refs.selective_scan_ref(u[..., c], delta[..., c], A[c], B, C,
                                       D=D[c], delta_bias=bias[c],
                                       delta_softplus=True,
                                       return_last_state=True)
        for what, g, w in zip(("y", "last"), (got[0][..., c], got[1][:, c]),
                              want):
            torch.testing.assert_close(
                g.float(), w.float(), rtol=rtol, atol=atol,
                msg=f"K1 Granite prefill channels {c.start}:{c.stop} {what}")
            err = max(err, (g.float() - w.float()).abs().max().item())
        del want
    lc, grid = picked_chunk(batch, L, d, n)
    call_ms = cuda_ms(run, 5)
    ms = device_ms(run, calls=3, repeats=3)
    nbytes, ops, exps = scan_work(batch, L, d, n, 2)
    work = (nbytes - batch * L * d * 2, ops, exps)     # no z to read
    bound_ms, bound_by, term = bound(work, peaks)
    print(f"K1 Granite prefill bfloat16 b={batch} L={L} d={d} N={n} heads "
          f"of {head_dim}, no z {grid_text(lc, grid)}: y, last max_abs_err="
          f"{err:.3e} on {sum(c.stop - c.start for c in GRANITE_HELD)} "
          f"channels; ms={ms:.3f} (one call with its launch {call_ms:.3f}) "
          f"bound_ms={bound_ms:.3f} ({term}; {work[0] / 1e6:.1f} MB, "
          f"{work[2] / 1e9:.2f} G exps; {bound_ms / ms * 100:.1f} % of it)",
          flush=True)
    del u, delta, B, C, got
    return dict(stage="Granite prefill", L=L, d=d, n=n, dtype="bfloat16",
                l_chunk=lc, grid=grid, max_abs_err=err, ms=ms,
                call_ms=call_ms, bound_ms=bound_ms, bound_by=bound_by,
                bound_term=term, mbytes=work[0] / 1e6)


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
    return (fwd_err, bwd_err, cs, fwd_plain, bwd_plain,
            scaled_err(got, want), scaled_err(got_b, want_b))


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
                f"{label} {tag} {dtype_name(dtype)}")[:5]
            fwd = lambda: ss.selective_scan_fwd_states_cuda(
                u, delta, A, B, C, D, bias, True)
            bwd = lambda: ss.selective_scan_bwd_cuda(
                u, delta, A, B, C, D, bias, cs, dout, None, True)
            n_reps = reps(L) if callable(reps) else reps
            elem = u.element_size()
            for rows, kind, err, run, plain, work, extra, text in (
                    (fwd_rows, "K1-train", fwd_err, fwd, fwd_plain,
                     train_fwd_work(b, L, d, N, elem, ss.CHUNK),
                     dict(l_chunk=lc, grid=grid, split_us=kernel_split(fwd)),
                     grid_text(lc, grid)),
                    (bwd_rows, "K2", bwd_err, bwd, bwd_plain,
                     bwd_work(b, L, d, N, elem, ss.CHUNK),
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


def dwconv_work(batch, T, H, W, C, backward):
    """(bytes, fp32 operations, exps) of the 3-D depthwise conv: the
    forward reads x and writes y, 54 operations per element (27 FMAs); the
    backward reads x and dy and writes dx, 109 per element (27 FMAs for
    dx, 27 for the weight grad, one add for the bias grad); both read the
    weight and bias, the backward writes their grads."""
    n = batch * T * H * W * C
    params = C * 28 * 4
    if backward:
        return 12 * n + 2 * params, 109 * n, 0
    return 8 * n + params, 54 * n, 0


def phase_dwconv(peaks):
    """The 3-D depthwise conv kernels (``kernels/dwconv3d.py``) at the
    Mix-FFN shapes of a serving forward (batch 1) and a training step
    (batch 3), forward and backward, against float64 ``F.conv3d``; timed
    as K1 and K2 are, beside the plain versions (``refs.dwconv3d_ref``,
    which is cuDNN's ``F.conv3d``, and ``refs.dwconv3d_bwd_ref``) and
    cuDNN's route as the port ran it before the kernels (``F.conv3d`` with
    autograd through it: ``library_ms``); then the ragged shapes of the CPU
    tests with forced tiles."""
    from vivim_tpu_torch.kernels import dwconv3d as dk
    from vivim_tpu_torch.kernels import refs

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []

    def inputs(batch, T, H, W, C):
        f = lambda *s: torch.randn(*s, generator=gen, device="cuda")
        return (f(batch, T * H * W, C), f(C, 1, 3, 3, 3) / 27 ** 0.5,
                0.1 * f(C), f(batch, T * H * W, C))

    def float64(x, w, b, dy, T, H, W):
        x, w, b = (t.double().requires_grad_() for t in (x, w, b))
        y = refs.dwconv3d_ref(x, w, b, T, H, W)
        return (y.detach(),) + torch.autograd.grad(y, (x, w, b), dy.double())

    for batch in (1, TRAIN_BATCH):
        for si, (S, C) in enumerate(DW_STAGES):
            T, H, W = DW_FRAMES, S, S
            x, w, b, dy = inputs(batch, T, H, W, C)
            want = float64(x, w, b, dy, T, H, W)
            fwd = lambda: dk.dwconv3d_fwd_cuda(x, w, b, T, H, W)
            bwd = lambda: dk.dwconv3d_bwd_cuda(x, dy, w, T, H, W)
            got = (fwd(),) + bwd()
            torch.cuda.synchronize()
            errs = [scaled_err((g,), (v,)) for g, v in zip(got, want)]
            # y and dx: 27 FMAs; the weight and bias grads: fp32 sums over
            # every position (see tests/test_torch_cuda.py)
            for name, e, tol in zip(("y", "dx", "dweight", "dbias"), errs,
                                    (1e-5, 1e-5, 1e-4, 1e-4)):
                if e > tol:
                    raise AssertionError(f"dwconv3d batch {batch} stage {si}"
                                         f" {name}: scaled error {e:.3e}")

            def library_bwd():
                xr = x.detach().requires_grad_()
                wr = w.detach().requires_grad_()
                br = b.detach().requires_grad_()
                y = refs.dwconv3d_ref(xr, wr, br, T, H, W)
                return torch.autograd.grad(y, (xr, wr, br), dy)

            vec = dk.vec_width(C, x)
            tiles = {"forward": dk.fwd_tiling(batch, T, H, C, vec),
                     "backward": dk.bwd_tiling(batch, T, H, C, sm_count())}
            for which, run, plain, library, err in (
                    ("forward", fwd,
                     lambda: refs.dwconv3d_ref(x, w, b, T, H, W),
                     lambda: refs.dwconv3d_ref(x, w, b, T, H, W), errs[0]),
                    ("backward", bwd,
                     lambda: refs.dwconv3d_bwd_ref(x, dy, w, T, H, W),
                     library_bwd, max(errs[1:]))):
                run()
                call_ms = cuda_ms(run, 20)
                ms = device_ms(run)
                split = kernel_split(run)
                plain()
                plain_ms = cuda_ms(plain, 5)
                library()
                library_ms = cuda_ms(library, 5)
                work = dwconv_work(batch, T, H, W, C, which == "backward")
                bound_ms, bound_by, term = bound(work, peaks)
                lanes, grid_y = tiles[which]
                row = dict(stage=si, batch=batch, T=T, H=H, W=W, C=C,
                           which=which, dtype="float32", max_abs_err=err,
                           ms=ms, call_ms=call_ms, split_us=split,
                           plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           bound_term=term, mbytes=work[0] / 1e6,
                           vec=vec if which == "forward" else 1,
                           lanes=lanes, rows=grid_y)
                rows.append(row)
                print(f"dwconv3d {which:8s} batch {batch} stage {si} "
                      f"T={T} H=W={S} C={C} vec={row['vec']} lanes={lanes} "
                      f"rows={grid_y}: scaled err {err:.3e} "
                      f"ms={ms:.4f} (one call with its launch "
                      f"{call_ms:.4f}; {split_text(split)}) plain_ms="
                      f"{plain_ms:.3f} cudnn_ms={library_ms:.3f} bound_ms="
                      f"{bound_ms:.4f} ({term}; {work[0] / 1e6:.1f} MB; "
                      f"{bound_ms / ms * 100:.1f} % of it)", flush=True)
            del x, w, b, dy, want, got
    # ragged shapes with the wrapper's tiles and forced block rows (tiles
    # ending mid-frame, crossing frames), scalar lanes forced too
    worst = 0.0
    for case in ((1, 1, 1, 1, 1), (3, 1, 2, 5, 3), (1, 2, 7, 1, 16),
                 (3, 5, 5, 2, 130), (1, 7, 1, 7, 3), (3, 2, 2, 2, 1),
                 (1, 5, 7, 5, 130), (3, 7, 5, 7, 16)):
        batch, T, H, W, C = case
        x, w, b, dy = inputs(*case)
        want = float64(x, w, b, dy, T, H, W)
        for grid_y, vec in ((None, None), (2, None), (3, 1)):
            got = ((dk._fwd_launch(x, w, b, T, H, W, grid_y, vec),)
                   + dk._bwd_launch(x, dy, w, T, H, W, True, grid_y))
            torch.cuda.synchronize()
            for name, g, v, tol in zip(("y", "dx", "dweight", "dbias"), got,
                                       want, (1e-5, 1e-5, 1e-4, 1e-4)):
                e = scaled_err((g,), (v,))
                worst = max(worst, e)
                if e > tol:
                    raise AssertionError(f"dwconv3d ragged {case} rows "
                                         f"{grid_y} {name}: scaled error "
                                         f"{e:.3e}")
    rows.append(dict(stage="ragged", dtype="float32", max_abs_err=worst))
    print(f"dwconv3d ragged: 8 shapes x 3 tilings, y, dx, dweight, dbias "
          f"against float64: largest scaled error {worst:.3e}", flush=True)
    return rows


def step_work(batch, d, n, width, elem, which, heads=None, groups=1):
    """(bytes, fp32 operations, exps) of one decode step kernel.
    ``conv_step`` reads and writes the window (W per channel and row),
    reads x, the weight and bias and writes the output; ``ssm_step`` reads
    and writes the fp32 state, reads x, z, each head's dt, A_log, D and dt
    bias, each group's B and C, and writes the output: each byte once.
    Exps: silu's; per head and state A's and the decay's, per head
    softplus's, per channel silu's.  ``heads``: d (Mamba-1) by default."""
    if which == "conv_step":
        return ((batch * d * (2 * width + 2) + d * (width + 1)) * elem,
                batch * d * (2 * width + 4), batch * d)
    heads = heads or d
    return (batch * d * n * 8 + (batch * (3 * d + heads + 2 * groups * n)
                                 + heads * (n + 2)) * elem,
            batch * d * (6 * n + 10), batch * (heads * (2 * n + 1) + d))


def step_inputs(batch, d, n, dtype, gen, width=4, dt_rank=8):
    """The decode step's operands as ``streaming.mamba_step`` passes them:
    x and z the halves of an in_proj output, the conv weight viewed from
    (d, 1, W), B and C column views of an x_proj output."""
    f = lambda *s, scale=1.0: scale * torch.randn(*s, generator=gen,
                                                  device="cuda")
    xz = f(batch, 2 * d).to(dtype)
    x_dbl = f(batch, dt_rank + 2 * n).to(dtype)
    A_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device="cuda")).repeat(d, 1)
    conv = dict(x=xz[:, :d], conv_state=f(batch, width, d).to(dtype),
                weight=f(d, 1, width, scale=0.5).to(dtype)[:, 0, :].t(),
                bias=f(d, scale=0.1).to(dtype))
    ssm = dict(ssm_state=f(batch, d, n), x=f(batch, d).to(dtype),
               dt=f(batch, d, scale=0.5).to(dtype), A_log=A_log.to(dtype),
               B=x_dbl[:, dt_rank:dt_rank + n], C=x_dbl[:, dt_rank + n:],
               D=f(d).to(dtype), z=xz[:, d:], dt_bias=f(d, scale=0.3).to(
                   dtype))
    return conv, ssm


def mamba2_step_inputs(batch, heads, head_dim, n, groups, dtype, gen,
                       width=4):
    """The decode step's operands as ``streaming.mamba2_step`` passes them:
    z, the xBC channels and each head's dt column views of one in_proj
    output, the conv weight viewed from (conv_dim, 1, W); x, B and C column
    views of the conv's output; A_log, D and the dt bias per head, A_log
    (heads, N) a broadcast view."""
    f = lambda *s, scale=1.0: scale * torch.randn(*s, generator=gen,
                                                  device="cuda")
    d = heads * head_dim
    cd = d + 2 * groups * n
    zxbcdt = f(batch, d + cd + heads).to(dtype)
    xbc = f(batch, cd).to(dtype)      # the conv's output
    a_log = torch.log(1 + 15 * torch.rand(heads, generator=gen,
                                          device="cuda"))
    conv = dict(x=zxbcdt[:, d:d + cd], conv_state=f(batch, width, cd).to(
                    dtype),
                weight=f(cd, 1, width, scale=0.5).to(dtype)[:, 0, :].t(),
                bias=f(cd, scale=0.1).to(dtype))
    ssm = dict(ssm_state=f(batch, d, n), x=xbc[:, :d],
               dt=zxbcdt[:, d + cd:], A_log=a_log.to(dtype)[:, None].expand(
                   heads, n),
               B=xbc[:, d:d + groups * n], C=xbc[:, d + groups * n:],
               D=f(heads).to(dtype), z=zxbcdt[:, :d],
               dt_bias=f(heads, scale=0.3).to(dtype), head_dim=head_dim,
               n_groups=groups)
    return conv, ssm


def step_cases(gen):
    """(batch, d_inner, d_state, dtype, label, heads, groups, conv
    operands, ssm operands) of each shape phase 3d holds, drawn in turn."""
    for batch, d, n, dtype in STEP_SHAPES:
        yield (batch, d, n, dtype, "", d, 1,
               *step_inputs(batch, d, n, dtype, gen))
    batch, heads, head_dim, n, groups = GRANITE_MAMBA2
    yield (batch, heads * head_dim, n, torch.bfloat16,
           f" Granite, heads of {head_dim}", heads, groups,
           *mamba2_step_inputs(batch, heads, head_dim, n, groups,
                               torch.bfloat16, gen))


def phase_step_kernels(peaks):
    """Phase 3d: the decode step's kernels against their plain versions
    (``kernels/mamba_step.py``) over 4 steps on copies of the states, then
    timed: replay us (10 calls in a CUDA graph), one eager call's us, the
    plain version's us, the bytes bound."""
    from vivim_tpu_torch.kernels import mamba_step as mk

    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = []
    for batch, d, n, dtype, label, heads, groups, conv, ssm in step_cases(
            gen):
        plain_conv = dict(conv, conv_state=conv["conv_state"].clone())
        plain_ssm = dict(ssm, ssm_state=ssm["ssm_state"].clone())
        rtol, atol = TOL[dtype]
        errs = {"conv_step": 0.0, "ssm_step": 0.0}
        for _ in range(4):
            got = mk.conv_step(**conv), mk.ssm_step(**ssm)
            want = (mk.plain_conv_step(**plain_conv),
                    mk.plain_ssm_step(**plain_ssm))
            torch.cuda.synchronize()
            for which, g, w in zip(errs, got, want):
                torch.testing.assert_close(
                    g.float(), w.float(), rtol=rtol, atol=atol,
                    msg=f"{which} ({batch}, {d}, {n}) {dtype_name(dtype)}"
                        f"{label}")
                errs[which] = max(errs[which],
                                  (g.float() - w.float()).abs().max().item())
            if not torch.equal(conv["conv_state"], plain_conv["conv_state"]):
                raise AssertionError(f"conv_step ({batch}, {d}){label} "
                                     "window")
            torch.testing.assert_close(
                ssm["ssm_state"], plain_ssm["ssm_state"],
                rtol=TOL[torch.float32][0], atol=TOL[torch.float32][1],
                msg=f"ssm_step ({batch}, {d}, {n}){label} state")
            errs["ssm_step"] = max(errs["ssm_step"], (
                ssm["ssm_state"] - plain_ssm["ssm_state"]).abs().max().item())
        torch.cuda.synchronize()
        for which, run, plain in (
                ("conv_step", lambda: mk.conv_step(**conv),
                 lambda: mk.plain_conv_step(**plain_conv)),
                ("ssm_step", lambda: mk.ssm_step(**ssm),
                 lambda: mk.plain_ssm_step(**plain_ssm))):
            call_ms = cuda_ms(run, 20)
            ms = device_ms(run)
            plain()
            plain_ms = cuda_ms(plain, 20)
            lanes = (mk.ssm_lanes(batch, d, n)[0] if which == "ssm_step"
                     else None)
            dim = conv["x"].shape[1] if which == "conv_step" else d
            work = step_work(batch, dim, n, conv["conv_state"].shape[1],
                             torch.finfo(dtype).bits // 8, which, heads,
                             groups)
            bound_ms, bound_by, term = bound(work, peaks)
            rows.append(dict(stage="decode step" + label, which=which,
                             batch=batch, d=dim, n=n, heads=heads,
                             dtype=dtype_name(dtype),
                             max_abs_err=errs[which], ms=ms, call_ms=call_ms,
                             plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, bound_term=term,
                             mbytes=work[0] / 1e6,
                             lanes=lanes))
            print(f"{which:9s} ({batch}, {dim}, N {n:3d}) "
                  f"{dtype_name(dtype):8s}{label}"
                  f"{'' if lanes is None else f' lanes {lanes}'}"
                  f": max_abs_err={errs[which]:.3e} replay_us="
                  f"{1e3 * ms:.2f} (one eager call {1e3 * call_ms:.2f}) "
                  f"plain_us={1e3 * plain_ms:.2f} bound_us="
                  f"{1e3 * bound_ms:.3f} ({term}; {work[0] / 1e3:.1f} KB; "
                  f"{bound_ms / ms * 100:.1f} % of it)", flush=True)
        del conv, ssm, plain_conv, plain_ssm
    torch.cuda.synchronize()
    return rows


class Requests:
    """In-memory batches of numpy dicts as an iterable loader."""

    def __init__(self, batches):
        self.batches = batches
        self.batch_size = batches[0]["clip"].shape[0]

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def combine_work(tokens, k, m, shared, elem):
    """(bytes, fp32 operations, exps) of one MoE combine: the k sorted rows
    of every token and its shared row read once, its row written once, its
    k positions and gates read; a product and a sum a choice and value,
    and a sum for the shared row."""
    return ((tokens * m * (k + 1 + shared) * elem + tokens * k * 8),
            tokens * m * (2 * k + shared), 0)


def combine_inputs(tokens, k, experts, m, shared, gen):
    """The combine's operands as ``dropless_moe`` makes them, bf16: a top k
    of random router logits a token, sorted by expert (stable), ``pos`` the
    inverse of the sort, renormalised gates, random expert outputs in
    sorted order and the shared expert's output."""
    dev = "cuda"
    top, chosen = torch.topk(torch.randn(tokens, experts, generator=gen,
                                         device=dev), k, dim=-1)
    order = torch.argsort(chosen.reshape(-1), stable=True)
    pos = torch.empty(tokens * k, dtype=torch.int32, device=dev)
    pos[order] = torch.arange(tokens * k, dtype=torch.int32, device=dev)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).to(
        torch.bfloat16)
    return (rnd(tokens * k, m), pos.view(tokens, k), torch.softmax(top, -1),
            rnd(tokens, m) if shared else None)


def parent_combine(ys, pos, gates, shared=None):
    """The combine as ``dropless_moe`` took it before its kernel: an fp32
    gate product of every sorted row, ``index_add_`` into a zeroed fp32
    sum, the shared row added in fp32, one cast (the yardstick of phases 3e
    and 8c)."""
    tokens, k = pos.shape
    order = torch.empty(tokens * k, dtype=torch.long, device=pos.device)
    order[pos.reshape(-1).long()] = torch.arange(tokens * k,
                                                 device=pos.device)
    out = torch.zeros((tokens, ys.shape[1]), dtype=torch.float32,
                      device=ys.device)
    out.index_add_(0, order // k, ys.float() * gates.reshape(-1)[order, None])
    if shared is not None:
        out += shared.float()
    return out.to(ys.dtype)


def phase_combine(peaks):
    """Phase 3e: the prefill MoE's combine kernel at ``COMBINE_SHAPES``,
    bit-equal to its plain version and to a second call, beside the parent
    form; device ms (CUDA-graph replay of the launch alone), one call's ms
    with its checks (the host read of pos's range), plain and parent ms,
    the bytes bound."""
    from vivim_tpu_torch.kernels import moe_combine as mc

    gen = torch.Generator(device="cuda").manual_seed(26)
    rows = []
    T, m = COMBINE_TOKENS, COMBINE_WIDTH
    for label, k, experts, shared, per_prefill in COMBINE_SHAPES:
        ops = combine_inputs(T, k, experts, m, shared, gen)
        c0 = mc.LAUNCHES
        got = mc.moe_combine(*ops)
        again = mc.moe_combine(*ops)
        want = mc.plain_moe_combine(*ops)
        torch.cuda.synchronize()
        if mc.LAUNCHES != c0 + 2:
            raise AssertionError(f"MoE combine {label}: {mc.LAUNCHES - c0} "
                                 "launches in 2 calls")
        if not torch.equal(got, want):
            err = (got.float() - want.float()).abs().max().item()
            raise AssertionError(f"MoE combine {label}: {err:.3e} from the "
                                 "plain version (bit-equal expected)")
        if not torch.equal(got, again):
            raise AssertionError(f"MoE combine {label}: two calls differ")
        del want, again
        parent = parent_combine(*ops)
        parent_err = (parent.float() - got.float()).abs().max().item()
        scale = got.float().abs().max().item()
        del parent
        plain_ms = cuda_ms(lambda: mc.plain_moe_combine(*ops), 3)
        parent_ms = cuda_ms(lambda: parent_combine(*ops), 3)
        call_ms = cuda_ms(lambda: mc.moe_combine(*ops), 5)
        out = torch.empty_like(got)
        ms = device_ms(lambda: mc._launch(*ops, out), calls=5, repeats=5)
        if not torch.equal(out, got):
            raise AssertionError(f"MoE combine {label}: the replayed "
                                 "launch's output differs")
        work = combine_work(T, k, m, shared, 2)
        bound_ms, bound_by, term = bound(work, peaks)
        print(f"MoE combine {label} bfloat16 T={T} k={k} of {experts} M={m} "
              f"shared={shared}: bit-equal to the plain version and to a "
              f"second call; the parent form within {parent_err:.3e} (|out| "
              f"max {scale:.3f}); device_ms={ms:.4f} (one call with its "
              f"checks {call_ms:.4f}) bound_ms={bound_ms:.4f} ({term}; "
              f"{work[0] / 1e9:.3f} GB; {bound_ms / ms * 100:.1f} % of it) "
              f"plain_ms={plain_ms:.2f} parent_ms={parent_ms:.2f}; per "
              f"prefill ({per_prefill} calls): device {per_prefill * ms:.2f} "
              f"ms, parent {per_prefill * parent_ms:.1f} ms", flush=True)
        rows.append(dict(stage=f"{label} prefill", tokens=T, k=k,
                         experts=experts, m=m, shared=shared,
                         dtype="bfloat16", ms=ms, call_ms=call_ms,
                         plain_ms=plain_ms, parent_ms=parent_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         gbytes=work[0] / 1e9, parent_err=parent_err,
                         calls_per_prefill=per_prefill))
        del ops, got, out
        torch.cuda.empty_cache()
    return rows


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


def launches(k1=0, k1_train=0, k2=0, conv=0, conv_bwd=0):
    """A ``counts()`` dict: K1's inference and training launches, K2's,
    and the 3-D conv's forward and backward wrapper calls."""
    return {"K1 inference": k1, "K1 training": k1_train, "K2": k2,
            "dwconv3d forward": conv, "dwconv3d backward": conv_bwd}


def vivim_forward(n):
    """The launches of Vivim forwards over ``n`` MambaLayers in all: an
    inference K1 and a conv forward each."""
    return launches(k1=n, conv=n)


def vivim_step(per_pass):
    """The launches of a Vivim train step over ``per_pass`` MambaLayers:
    a training K1, a K2 and a conv forward and backward each."""
    return launches(k1_train=per_pass, k2=per_pass, conv=per_pass,
                    conv_bwd=per_pass)


def counts():
    """The kernels' launches since ``reset_counts``, as ``launches``."""
    from vivim_tpu_torch.kernels import dwconv3d as dk
    from vivim_tpu_torch.kernels import selective_scan as ss

    return launches(ss.LAUNCHES, ss.TRAIN_LAUNCHES, ss.BWD_LAUNCHES,
                    dk.LAUNCHES, dk.BWD_LAUNCHES)


def reset_counts():
    from vivim_tpu_torch.kernels import dwconv3d as dk
    from vivim_tpu_torch.kernels import mamba_step as mk
    from vivim_tpu_torch.kernels import moe_combine as mc
    from vivim_tpu_torch.kernels import selective_scan as ss
    from vivim_tpu_torch.utils import cuda_graphs

    ss.LAUNCHES = ss.TRAIN_LAUNCHES = ss.BWD_LAUNCHES = 0
    dk.LAUNCHES = dk.BWD_LAUNCHES = 0
    mk.LAUNCHES = 0
    mc.LAUNCHES = 0
    cuda_graphs.CAPTURES = cuda_graphs.REPLAYS = 0


def step_launches():
    """The decode step's kernel launches (``conv_step`` and ``ssm_step``,
    2 a Mamba mixer a token) since ``reset_counts``."""
    from vivim_tpu_torch.kernels import mamba_step as mk

    return mk.LAUNCHES


def combine_launches():
    """The prefill MoE's combine launches (one a MoE layer a prefill) since
    ``reset_counts``."""
    from vivim_tpu_torch.kernels import moe_combine as mc

    return mc.LAUNCHES


def graph_counts():
    """CUDA-graph captures and replays since ``reset_counts``."""
    from vivim_tpu_torch.utils import cuda_graphs

    return {"captures": cuda_graphs.CAPTURES,
            "replays": cuda_graphs.REPLAYS}


def graph_launches(per_call, captures, replays):
    """Launches that run for ``captures`` captures and ``replays`` replays
    of a call that launches ``per_call``: each capture's warm-up calls and
    every replay (the capture itself runs nothing)."""
    from vivim_tpu_torch.utils import cuda_graphs

    return per_call * (cuda_graphs.WARMUP_CALLS * captures + replays)


def timed_perf(times, frames_per_batch):
    """fps and per-batch ms (avg / min / max) by ``run_inference``'s rule:
    the first batch excluded as warm-up."""
    t = times[1:] or times
    return {"fps": frames_per_batch * len(t) / sum(t),
            "avg_ms": 1e3 * sum(t) / len(t), "min_ms": 1e3 * min(t),
            "max_ms": 1e3 * max(t)}


def model_args(segformer, nc=3):
    return argparse.Namespace(segformer=segformer, num_classes=nc,
                              with_edge=False)


def phase_serve(segformer="b3", size=256, clip_len=5, n_req=4, dot=None):
    """Phase 4: the requests through ``run_inference`` (the forward, argmax
    and confusion counts replayed as one CUDA graph), then through the same
    forward eagerly in this call; the memory one captured shape keeps; the
    replayed logits against the eager module's and the plain scan's;
    profiles of a replay and an eager forward; the forward graph's shape
    (``graph_topology``, its DOT file kept at ``dot`` if given)."""
    from vivim_tpu_torch.cli.common import build_model
    from vivim_tpu_torch.cli.infer import _timed, run_inference, serving_forward
    from vivim_tpu_torch.nn.vivim import Vivim
    from vivim_tpu_torch.utils.cuda_graphs import GraphedCall

    nc = 3
    dev = torch.device("cuda")
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
        launched, graphs = counts(), graph_counts()
        graph_peak = torch.cuda.max_memory_allocated()
    per_fwd = sum(cfg.depths)
    if graphs != {"captures": 1, "replays": n_req} or launched != (
            vivim_forward(graph_launches(per_fwd, 1, n_req))):
        raise AssertionError(
            f"serving {n_req} requests of one shape: {graphs}, launched "
            f"{launched}; expected 1 capture and {n_req} replays, "
            f"{per_fwd} inference K1 and {per_fwd} conv forwards per "
            "warm-up forward and per replay, and nothing else")
    if int(cm.sum()) != n_req * clip_len * size * size:
        raise AssertionError(f"confusion matrix counts {int(cm.sum())} "
                             "pixels")

    # the same requests through the same forward, eagerly
    eager_fwd = serving_forward(model, nc)
    eager_cm = torch.zeros(nc, nc, dtype=torch.long, device=dev)
    times = []
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        for b in batches:
            clip = torch.from_numpy(b["clip"]).to(dev)
            masks = torch.from_numpy(b["masks"]).to(dev)
            (_, _, cm_b), secs = _timed(dev, lambda: eager_fwd(clip, masks))
            times.append(secs)
            eager_cm += cm_b
    eager_peak = torch.cuda.max_memory_allocated()
    eager = timed_perf(times, clip_len)
    if not (eager_cm.cpu().numpy() == cm).all():
        raise AssertionError(f"replayed confusion matrix {cm.tolist()}, "
                             f"eager {eager_cm.tolist()}")
    # what one captured shape keeps on the card while its GraphedCall
    # lives (the pool's segments and the static buffers), as a serving
    # process holds it; run_inference's graphs went with its return
    with torch.inference_mode():
        served = GraphedCall(serving_forward(model, nc), model)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = (torch.cuda.memory_reserved(), torch.cuda.memory_allocated())
        served(clip, masks)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        kept = (torch.cuda.memory_reserved() - base[0],
                torch.cuda.memory_allocated() - base[1])
        del served
    print(f"serve: {n_req} requests of (1, {clip_len}, {size}, {size}, 3): "
          f"launches {launched} ({per_fwd} K1 and conv per forward: "
          f"{graphs['captures']} capture after "
          f"{launched['K1 inference'] // per_fwd - graphs['replays']} "
          f"warm-up forwards, then {graphs['replays']} replays); graph: fps "
          f"{perf['fps']:.2f}, per-batch ms "
          f"{perf['avg_batch_time'] * 1e3:.3f} avg, "
          f"{perf['min_batch_time'] * 1e3:.3f} min, "
          f"{perf['max_batch_time'] * 1e3:.3f} max; eager in this call: fps "
          f"{eager['fps']:.2f}, per-batch ms {eager['avg_ms']:.3f} avg, "
          f"{eager['min_ms']:.3f} min, {eager['max_ms']:.3f} max; confusion "
          f"matrix equal to eager's; peak memory graph "
          f"{graph_peak / 2**30:.2f} GiB (its eager warm-ups' peak), eager "
          f"{eager_peak / 2**30:.2f} GiB; one captured shape keeps "
          f"{kept[0] / 2**20:.1f} MiB reserved, {kept[1] / 2**20:.1f} MiB "
          f"allocated, while its GraphedCall lives; dice mean "
          f"{results['dice']['mean']:.4f}", flush=True)

    clip0 = torch.from_numpy(batches[0]["clip"]).cuda()
    ref_model = Vivim(dataclasses.replace(cfg, scan_implementation="ref"))
    ref_model.load_state_dict(model.state_dict())
    ref_model = ref_model.cuda().eval()
    with torch.inference_mode():
        replay = GraphedCall(model, model)
        got = replay(clip0).clone()
        eager_logits = model(clip0)
        t1 = time.perf_counter()
        want = ref_model(clip0)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t1
    del ref_model
    if tuple(got.shape) != (1, clip_len, size, size, nc):
        raise AssertionError(f"logits shape {tuple(got.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("non-finite logits")
    eager_err = (got - eager_logits).abs().max().item()
    torch.testing.assert_close(got, eager_logits, rtol=0, atol=1e-5)
    err = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
    print(f"serve: replayed logits vs the eager module's max_abs_err="
          f"{eager_err:.3e} (atol 1e-5), vs the plain-scan model's "
          f"max_abs_err={err:.3e} (atol 1e-3), |logits| max "
          f"{want.abs().max().item():.3f}; plain forward {ref_s:.1f} s",
          flush=True)

    def forward():
        with torch.inference_mode():
            model(clip0)

    def replayed():
        with torch.inference_mode():
            replay(clip0)

    prof = phase_profile("serve forward", forward)
    prof_graph = phase_profile("serve forward (graph replay)", replayed)
    if prof_graph is None or prof is None or (
            prof_graph["k1_kernels"] != prof["k1_kernels"]
            or not prof["k1_kernels"]):
        raise AssertionError(
            "a replay's K1 kernels in the profile: "
            f"{prof_graph and prof_graph['k1_kernels']}, an eager forward's "
            f"{prof and prof['k1_kernels']}")
    busy = lambda p: (f"{p['kernels']} kernels, {p['wall_ms']:.3f} ms "
                      f"wall, busy {p['busy_ms']:.3f} ms union "
                      f"({100 * p['busy_share']:.1f} %) and "
                      f"{p['kernel_ms']:.3f} ms summed "
                      f"({100 * p['summed_share']:.1f} %)")
    print(f"serve: one replay runs {prof_graph['k1_kernels']} K1 kernels "
          f"({per_fwd} K1 calls), as one eager forward does; per call: "
          f"replay {busy(prof_graph)}; eager {busy(prof)}", flush=True)
    with torch.inference_mode():
        topo = graph_topology(model, clip0, dump=dot)
    print(f"serve: the forward's CUDA graph: {topo}", flush=True)
    return launched, dict(perf, graphs=graphs, eager=eager,
                          graph_peak_gib=graph_peak / 2**30,
                          eager_peak_gib=eager_peak / 2**30,
                          graph_kept_mib=kept[0] / 2**20,
                          graph_kept_allocated_mib=kept[1] / 2**20,
                          graph_topology=topo,
                          eager_logits_err=eager_err, plain_logits_err=err,
                          profile=prof, graph_profile=prof_graph)


# first match wins: cuDNN's conv kernels carry "gemm" in their names
PROFILE_GROUPS = {
    "dwconv3d (3-D depthwise)": ("dwconv3d",),
    "selective_scan_bwd (K2)": ("selective_scan_bwd", "sum_partials"),
    "selective_scan_fwd (K1)": ("selective_scan_fwd",),
    "conv (cuDNN, 2-D)": ("conv", "fprop", "dgrad", "wgrad", "winograd"),
    "layout (cudnn nhwc<->nchw)": ("nhwctonchw", "nchwtonhwc"),
    "matmul": ("gemm", "cutlass", "cublas"),
}


def phase_profile(label, run, n_runs=3):
    """Device time of ``n_runs`` calls of ``run`` by kernel group
    (torch.profiler), and the device's busy share of the window's wall
    time.  Busy is the union of the kernels' intervals; their summed time
    exceeds it where kernels overlap, and the overlap is printed by pair
    of kernels (the earlier one, the one that starts inside it) and by
    whether the two ran on one stream.  Returns {wall_ms, busy_ms (union),
    kernel_ms (summed), busy_share (union), summed_share, streams,
    overlap_ms, kernels, k1_kernels (K1's CUDA kernels)} per call, or None
    when the profiler recorded no device event."""
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
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [(e.name, e.time_range.elapsed_us() / 1e3 / n_runs)
               for e in events]
    if not kernels:
        print(f"profile {label}: no device events recorded", flush=True)
        return None
    kernel_ms = sum(ms for _, ms in kernels)
    spans = sorted((e.time_range.start, e.time_range.end, e.name,
                    getattr(e, "device_resource_id", None)) for e in events)
    busy_us, reach, holder, pairs = 0.0, None, None, {}
    for start, end, name, stream in spans:
        if reach is None or start >= reach:
            busy_us += end - start
            reach, holder = end, (name, stream)
            continue
        key = (holder[0], name, holder[1] == stream)
        pairs[key] = pairs.get(key, 0.0) + min(end, reach) - start
        if end > reach:
            busy_us += end - reach
            reach, holder = end, (name, stream)
    busy_ms = busy_us / 1e3 / n_runs
    overlap_ms = sum(pairs.values()) / 1e3 / n_runs
    streams = len({sp[3] for sp in spans})
    k1 = sum("selective_scan_fwd" in name for name, _ in kernels)
    by_group, by_name = {}, {}
    for name, ms in kernels:
        low = name.lower()
        g = next((g for g, keys in PROFILE_GROUPS.items()
                  if any(k in low for k in keys)), "other")
        by_group[g] = by_group.get(g, 0.0) + ms
        by_name[name] = by_name.get(name, 0.0) + ms
    print(f"profile {label}: per call {wall_ms:.3f} ms wall; device busy "
          f"(union of kernel intervals) {busy_ms:.3f} ms, "
          f"{100 * busy_ms / wall_ms:.1f} %; kernels' summed time "
          f"{kernel_ms:.3f} ms, {100 * kernel_ms / wall_ms:.1f} %; "
          f"{len(kernels) // n_runs} kernels on {streams} stream(s); "
          f"{overlap_ms:.3f} ms of start-inside-another overlap", flush=True)
    for g, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"profile {label}: group {g:26s} {ms:9.3f} ms "
              f"({100 * ms / kernel_ms:.1f} % of the summed time)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"profile {label}: kernel {ms:9.3f} ms {name[:90]}")
    for (a, b, same), us in sorted(pairs.items(), key=lambda kv: -kv[1])[:4]:
        print(f"profile {label}: overlap {us / 1e3 / n_runs:9.3f} ms, "
              f"{'one stream' if same else 'two streams'}: {b[:60]} "
              f"starts inside {a[:60]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "kernel_ms": kernel_ms,
            "busy_share": busy_ms / wall_ms,
            "summed_share": kernel_ms / wall_ms, "streams": streams,
            "overlap_ms": overlap_ms,
            "kernels": len(kernels) // n_runs, "k1_kernels": k1 // n_runs}


def graph_topology(fn, *inputs, dump=None):
    """The shape of the CUDA graph that ``cuda_graphs.capture`` makes of
    ``fn(*inputs)``, from its DOT dump (cudaGraphDebugDotPrint): nodes by type,
    edges, roots, forks by width and joins (a captured single stream
    gives a chain: 1 root, no fork, no join), the kernels at the forks and
    the most frequent kernels.  ``dump`` keeps the DOT file there."""
    from vivim_tpu_torch.utils import cuda_graphs

    static = tuple(x.clone() for x in inputs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(cuda_graphs.WARMUP_CALLS):
            fn(*static)
    torch.cuda.current_stream().wait_stream(side)
    try:   # newer PyTorch keeps the cudaGraph_t only when asked
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:
        graph = torch.cuda.CUDAGraph()
        graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        fn(*static)
    with tempfile.TemporaryDirectory() as tmp:
        path = dump or os.path.join(tmp, "graph.dot")
        graph.debug_dump(path)
        with open(path) as f:
            dot = f.read()
    del graph
    edges = re.findall(r'^"([^"]+)"\s*->\s*"([^"]+)"', dot, re.M)
    blocks = dict(re.findall(r'^"([^"]+)"\s*\[(.*?)\];?\s*$', dot,
                             re.M | re.S))

    def tally(names):
        out = {}
        for n in names:
            out[n] = out.get(n, 0) + 1
        return dict(sorted(out.items(), key=lambda kv: -kv[1])[:3])

    def kernel(node):   # the mangled name before <<<grid, block, smem>>>
        m = re.search(r"\| (\S+?)\\<\\<\\<", blocks.get(node, ""))
        return m.group(1)[:48] if m else "?"

    outs, ins = {}, {}
    for a, b in edges:
        outs[a] = outs.get(a, 0) + 1
        ins[b] = ins.get(b, 0) + 1
    forks = [n for n, k in outs.items() if k > 1]
    kinds = tally(next((w for w in ("KERNEL", "MEMCPY", "MEMSET", "HOST",
                                    "EVENT", "EMPTY", "MEM_ALLOC", "GRAPH")
                        if w in body[:80].upper()), "other")
                  for body in blocks.values())
    return {"nodes": len(blocks), "by_type": kinds, "edges": len(edges),
            "roots": sum(n not in ins for n in blocks),
            "forks_by_width": tally(outs[n] for n in forks),
            "joins": sum(k > 1 for k in ins.values()),
            "fork_kernels": tally(kernel(n) for n in forks),
            "top_kernels": tally(kernel(n) for n in blocks)}


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
    from vivim_tpu_torch.utils import cuda_graphs

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
            _check_launches(steps, vivim_step(per_pass), "train step")
            _check_launches(evals, vivim_forward(per_pass),
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
        _check_launches(bf16_log, vivim_step(per_pass), "bf16 train step")
    for _, _, (_, m) in bf16_log:
        for k in ("loss", "grad_norm"):
            if not math.isfinite(float(m[k])):
                raise AssertionError(f"bf16 train {k} {float(m[k])}")
    bf16 = _step_summary("bf16 (make_train_step)", bf16_log, batch)
    print(f"train bf16: peak memory {peak_bf16 / 2**30:.2f} GiB", flush=True)

    if on_card:
        # profiled: replays (a new step's first calls run eagerly, and
        # phase_profile's unprofiled call captures)
        fp32_step = loop.make_train_step(model, "recall_focused", 3)
        b0 = {k: torch.from_numpy(v).to(dev) for k, v in train[0].items()}
        for _ in range(cuda_graphs.WARMUP_CALLS):
            fp32_step(trainer.state, b0)
        phase_profile("train step fp32 (replayed)",
                      lambda: fp32_step(trainer.state, b0), n_runs=2)
        phase_profile("train step bf16 (replayed)", lambda: step(state, b0),
                      n_runs=2)
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


def eager_train_step(*args, **kw):
    """``loop.make_train_step`` with its replay rule off: every step runs
    eagerly, the reference phase 5c holds the replayed steps against."""
    from unittest import mock

    from vivim_tpu_torch.train import loop

    with mock.patch.object(loop, "replayable", lambda *a: False):
        return loop.make_train_step(*args, **kw)


def train_snapshot(state):
    """The train state on the host: the model's parameters and buffers,
    both moments (fp32) under the optimizer's names, the counts and the
    generator's state."""
    host = lambda xs: [x.detach().float().cpu() if x.is_floating_point()
                       else x.detach().cpu() for x in xs]
    sd = state.model.state_dict()
    names = state.opt.names
    return {"model": dict(zip(sd, host(sd.values()))),
            "mu": dict(zip(names, host(state.opt.mu))),
            "nu": dict(zip(names, host(state.opt.nu))),
            "count": state.opt.count, "step": state.step,
            "generator": state.generator.get_state()}


def leaf_gap(got, want):
    """(the largest ||a - b|| over max(||b||, the median leaf's ||b||) of
    the tensors of two {name: tensor} dicts, that leaf): a leaf whose
    gradient is rounding noise, as a bias a train-mode BatchNorm cancels,
    is judged at the median leaf's scale; integer tensors must be
    equal."""
    norms = {k: b.double().norm().item() for k, b in want.items()
             if b.is_floating_point()}
    med = statistics.median(norms.values())
    worst = (0.0, None)
    for k, b in want.items():
        a = got[k]
        if k not in norms:
            if not torch.equal(a, b):
                raise AssertionError(f"integer tensor {k} differs")
            continue
        gap = (a.double() - b.double()).norm().item() / max(norms[k], med,
                                                            1e-30)
        worst = max(worst, (gap, k), key=lambda g: g[0])
    return worst


def state_gaps(got, want, what):
    """{part: (its largest leaf gap, that leaf)} of two
    ``train_snapshot``s, whose counts and generator states must be
    equal."""
    if (got["count"], got["step"]) != (want["count"], want["step"]):
        raise AssertionError(f"{what}: counts {got['count']}, {got['step']} "
                             f"vs {want['count']}, {want['step']}")
    if not torch.equal(got["generator"], want["generator"]):
        raise AssertionError(f"{what}: the generator's state differs")
    return {"params": leaf_gap(got["model"], want["model"]),
            "mu": leaf_gap(got["mu"], want["mu"]),
            "nu": leaf_gap(got["nu"], want["nu"])}


def _metric_gaps(got, want):
    """{metric: (the largest relative gap over the steps, that step)}."""
    return {k: max(((abs(g[k] - w[k]) / max(abs(w[k]), 1e-30), i)
                    for i, (g, w) in enumerate(zip(got, want))),
                   key=lambda x: x[0]) for k in want[0]}


def run_gaps(got, want, what):
    """Every gap of run ``got`` to run ``want`` (``_train_run``'s)."""
    return {**_metric_gaps(got["metrics"], want["metrics"]),
            **state_gaps(got["snap"], want["snap"], what)}


def check_against_floor(what, gaps, floor, tol=1e-6, factor=10):
    """Each gap of the replayed run to the eager one at most the larger of
    ``tol`` and ``factor`` times the same gap between two eager runs (the
    card's own run-to-run floor, from atomics-based kernels); returns the
    text of both."""
    over = {k: (g, floor[k][0]) for k, (g, _) in gaps.items()
            if g > max(tol, factor * floor[k][0])}
    if over:
        raise AssertionError(f"{what}: (replayed, eager vs eager) gaps "
                             f"{over} above max({tol:g}, {factor} x the "
                             "eager floor)")
    fmt = lambda d: ", ".join(f"{k} {g:.2e} ({w})" for k, (g, w) in d.items())
    return f"replayed vs eager: {fmt(gaps)}; eager vs eager: {fmt(floor)}"


def _train_run(step, state, batches, dev):
    """``step`` over ``batches`` from ``state``: the launches of each step,
    each step's metrics read after the last step, the state's snapshot,
    replays, captures, ms of each step to a synchronize and peak GiB."""
    from vivim_tpu_torch.train import loop

    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    replayed = loop.REPLAYED_STEPS
    log, kept, ms = [], [], []
    for b in batches:
        c0 = counts()
        t0 = time.perf_counter()
        state, m = step(state, b)
        if on_card:
            torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        log.append({k: v - c0[k] for k, v in counts().items()})
        kept.append(m)
    metrics = [{k: float(v) for k, v in m.items()} for m in kept]
    return dict(launches=log, metrics=metrics, snap=train_snapshot(state),
                replayed=loop.REPLAYED_STEPS - replayed,
                captures=graph_counts()["captures"], ms=ms,
                peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                          if on_card else 0.0))


def atomics_probe(dev, frames=TRAIN_BATCH * 5, size=256, hidden=768):
    """{op: whether its backward gives bitwise equal results twice}, each
    op's backward run twice on the same inputs and cotangent at the fp32
    b3 step's shapes: the bilinear resizes of channels-last maps (the
    decoder's scales to 64 px, the logits to the input's 256 px), whose
    CUDA backward sums with atomics, and the first patch embedding's cuDNN
    convolution."""
    import torch.nn.functional as F

    g = torch.Generator(dev).manual_seed(0)

    def resize(out_px):
        return lambda x: F.interpolate(x.permute(0, 3, 1, 2), size=(out_px,
                                       out_px), mode="bilinear",
                                       align_corners=False)

    def twice(fn, *shapes):
        xs = [torch.randn(sh, device=dev, generator=g, requires_grad=True)
              for sh in shapes]
        dy = torch.randn(fn(*xs).shape, device=dev, generator=g)
        a, b = (torch.autograd.grad(fn(*xs), xs, dy) for _ in range(2))
        return all(torch.equal(x, y) for x, y in zip(a, b))

    return {
        "upsample_bilinear2d backward, logits 64 -> 256 px": twice(
            resize(size), (frames, size // 4, size // 4, 3)),
        "upsample_bilinear2d backward, decoder 8 -> 64 px": twice(
            resize(size // 4), (frames, size // 32, size // 32, hidden)),
        "cuDNN conv2d backward, patch embedding 7x7 stride 4": twice(
            lambda x, w: F.conv2d(x, w, stride=4, padding=3),
            (frames, 3, size, size), (64, 3, 7, 7)),
    }


def phase_train_replay(dev="cuda", segformer="b3", size=256, clip_len=5,
                       batch=TRAIN_BATCH, n_steps=REPLAY_STEPS):
    """Phase 5c: the replayed train step against eager steps from the same
    start (a deep copy of one model, one generator seed), in fp32, in bf16
    with ``grad_accum=3`` and with the edge loss, beside a second eager run
    (the floor the card's atomics-based kernels set); then ``Trainer.fit``
    the same ways over two epochs, and resumes mid-run."""
    import copy

    import numpy as np

    from vivim_tpu_torch.cli.common import build_model
    from vivim_tpu_torch.train import loop
    from vivim_tpu_torch.train.edge_loss import make_multiclass_edge_criterion
    from vivim_tpu_torch.utils import cuda_graphs

    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    per_pass = LAYERS_PER_STAGE * len(STAGES)
    data = make_requests(n_steps, clip_len, size, 3, seed=7, batch=batch)
    rng = np.random.default_rng(8)
    out = {}
    cases = (("fp32", {}, False),
             ("bf16 grad_accum 3", dict(compute_dtype=torch.bfloat16,
                                        grad_accum=3), False),
             ("fp32 edge loss",
              dict(edge_loss_fn=make_multiclass_edge_criterion()), True))
    for label, kw, with_edge in cases:
        args = argparse.Namespace(segformer=segformer, num_classes=3,
                                  with_edge=with_edge)
        base, _ = build_model(args, device=dev, seed=0)
        batches = []
        for d in data:
            b = {k: torch.from_numpy(v).to(dev) for k, v in d.items()}
            if with_edge:
                b["edges"] = torch.from_numpy(
                    (rng.random(d["masks"].shape[:-1] + (1,)) < 0.2)
                    .astype(np.float32)).to(dev)
            batches.append(b)
        runs = {}
        for way in ("replayed", "eager", "eager again"):
            model = copy.deepcopy(base)
            state = loop.create_train_state(model, 1e-4, 1e-2, n_steps,
                                            seed=1)
            make = (loop.make_train_step if way == "replayed"
                    else eager_train_step)
            step = make(model, "recall_focused", 3, **kw)
            runs[way] = _train_run(step, state, batches, dev)
            del model, state, step
            torch.cuda.empty_cache()
        rep, eag = runs["replayed"], runs["eager"]
        want = vivim_step(per_pass * kw.get("grad_accum", 1))
        for way, r in runs.items():
            for i, n in enumerate(r["launches"]):
                if on_card and n != want:
                    raise AssertionError(f"{label} {way} step {i} launched "
                                         f"{n}, expected {want}")
        replays = (n_steps - cuda_graphs.WARMUP_CALLS, 1) if on_card else (
            0, 0)   # the CPU's steps run eagerly
        if (rep["replayed"], rep["captures"]) != replays or eag["replayed"]:
            raise AssertionError(
                f"{label}: {rep['replayed']} replayed steps and "
                f"{rep['captures']} captures; eager replayed "
                f"{eag['replayed']}")
        gaps = run_gaps(rep, eag, label)
        floor = run_gaps(runs["eager again"], eag, f"{label} eager again")
        text = check_against_floor(label, gaps, floor)
        ops = ""
        if label == "fp32":
            probe = atomics_probe(dev, frames=batch * clip_len, size=size,
                                  hidden=base.cfg.hidden_size)
            out["bitwise_equal_backward"] = probe
            ops = f"; backward bitwise equal twice: {probe}"
        med = lambda r: statistics.median(r["ms"][cuda_graphs.WARMUP_CALLS:])
        w = cuda_graphs.WARMUP_CALLS
        print(f"train replay {label}: {n_steps} steps of batch {batch} "
              f"each way, {rep['replayed']} replayed after {w} eager; "
              f"launches per step {rep['launches'][-1]} each way; generator "
              f"states equal; largest relative gaps (a leaf against "
              f"max(its norm, the median leaf's); metrics: (gap, step)): "
              f"{text}{ops}; step ms to a synchronize, median of the last "
              f"{n_steps - w}: replayed {med(rep):.1f} (the capture's step "
              f"{rep['ms'][w]:.0f}), eager {med(eag):.1f}; peak memory "
              f"replayed {rep['peak_gib']:.2f} GiB, eager "
              f"{eag['peak_gib']:.2f} GiB", flush=True)
        out[label] = dict(
            gaps={k: v[0] for k, v in gaps.items()},
            floor={k: v[0] for k, v in floor.items()},
            replayed_ms=med(rep), eager_ms=med(eag),
            peak_gib=rep["peak_gib"], eager_peak_gib=eag["peak_gib"])
        del base, batches
        torch.cuda.empty_cache()
    out["trainer"] = _trainer_replay(dev, segformer, size, clip_len, batch)
    return out


def _trainer_replay(dev, segformer, size, clip_len, batch):
    """Phase 5c's Trainer part: ``fit`` over two epochs of 4 steps, replayed
    and eagerly twice, then epoch 2 again from epoch 1's checkpoint,
    restored in place (the replayed Trainer keeps its graph) and in a new
    Trainer: every epoch's ``train/loss`` mean and every final state held
    against the eager run's, as phase 5c's steps are."""
    import copy
    import shutil
    from unittest import mock

    from vivim_tpu_torch.cli.common import build_model
    from vivim_tpu_torch.train import loop
    from vivim_tpu_torch.train.logging import MetricLogger
    from vivim_tpu_torch.train.trainer import Trainer, TrainerConfig

    class Recording(Trainer):
        def train_epoch(self):
            em = super().train_epoch()
            self.epoch_losses.append(em["train/loss"])
            return em

    base, _ = build_model(model_args(segformer), device=dev, seed=0)
    loader = Requests(make_requests(4, clip_len, size, 3, seed=9,
                                    batch=batch))

    def trainer(way, tmp):
        rule = (contextlib.nullcontext() if way.startswith("replayed") else
                mock.patch.object(loop, "replayable", lambda *a: False))
        with rule:
            t = Recording(copy.deepcopy(base),
                          TrainerConfig(epochs=2, log_every=1, seed=0,
                                        device=str(dev)),
                          loader, [], os.path.join(tmp, way, "ckpt"),
                          MetricLogger(os.path.join(tmp, way, "logs")))
        t.epoch_losses = []
        return t

    def snap_run(t):
        return {"metrics": [{"train/loss": x} for x in t.epoch_losses],
                "snap": train_snapshot(t.state)}

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for way in ("replayed", "eager", "eager again"):
            t = trainer(way, tmp)
            t.cfg.epochs = 1
            t.fit()
            mid = os.path.join(tmp, f"{way}_mid.pt")
            shutil.copy(t.ckpt.last_path(), mid)
            t.cfg.epochs = 2
            t.fit()
            res[way] = snap_run(t)
            if way == "replayed":
                t.resume(mid)
                t.fit()
                res["replayed, resumed in place"] = snap_run(t)
            del t
            torch.cuda.empty_cache()
        t = trainer("replayed in a new Trainer", tmp)
        t.fit(resume_path=os.path.join(tmp, "replayed_mid.pt"))
        res["replayed, resumed in a new Trainer"] = snap_run(t)
        del t
        torch.cuda.empty_cache()
    losses = {k: [m["train/loss"] for m in r["metrics"]]
              for k, r in res.items()}
    if [len(v) for v in losses.values()] != [2, 3, 2, 2, 1]:
        raise AssertionError(f"epochs run: {losses}")
    # each run's (epoch 1, its last epoch 2) against the eager run's
    first = res["replayed"]["metrics"][0]
    for what in ("replayed, resumed in place",
                 "replayed, resumed in a new Trainer"):
        res[what]["metrics"] = [first, res[what]["metrics"][-1]]
    eag = res["eager"]
    floor = run_gaps(res["eager again"], eag, "Trainer eager again")
    text = {what: check_against_floor(
                f"Trainer {what}", run_gaps(res[what], eag, what), floor)
            for what in ("replayed", "replayed, resumed in place",
                         "replayed, resumed in a new Trainer")}
    print("train replay Trainer.fit: 2 epochs of 4 steps each way, then "
          "epoch 2 again from epoch 1's checkpoint in place and in a new "
          f"Trainer; epoch train/loss means {losses}; "
          + "; ".join(f"{k}: {v}" for k, v in text.items()), flush=True)
    return text


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
                _check_launches(run["steps"], vivim_step(per_pass),
                                f"{label} train step")
                _check_launches(run["evals"], vivim_forward(per_pass),
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
                _check_launches(run["steps"], vivim_step(per_pass),
                                f"{label} train step")
                _check_launches(run["evals"], vivim_forward(per_pass),
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
            work = scan_work(1, L, d_inner, N, got[0].element_size())
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
        launched, graphs = counts(), graph_counts()
        stepped = step_launches()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
    per_gen = cfg.n_layer
    want = launches(k1=len(LM_DTYPES) * (repeats + 1) * per_gen)
    if on_card and launched != want:
        raise AssertionError(f"bench_generation launched {launched}, "
                             f"expected {want}")
    # the decode step's two kernels once a layer in each graph's warm-up
    # calls and replays
    want_steps = graph_launches(2 * cfg.n_layer, len(LM_DTYPES),
                                len(LM_DTYPES) * (repeats + 1) * gen_len)
    if on_card and stepped != want_steps:
        raise AssertionError(f"bench_generation launched the decode step's "
                             f"kernels {stepped} times, expected "
                             f"{want_steps}")
    # a model per CLI run, so a decode graph each; a replay per token
    want_graphs = {"captures": len(LM_DTYPES) if on_card else 0,
                   "replays": len(LM_DTYPES) * (repeats + 1) * gen_len
                   if on_card else 0}
    if graphs != want_graphs:
        raise AssertionError(f"bench_generation: {graphs}, expected "
                             f"{want_graphs}")
    for dtype, r in bench.items():
        if r["gen_len"] != gen_len or r["prompt_len"] != prompt \
                or not r["tokens_per_sec"] > 0:
            raise AssertionError(f"bench line {dtype}: {r}")
    print(f"lm: bench launches {launched} ({per_gen} K1 per generate), "
          f"decode step kernels {stepped} (2 x {cfg.n_layer} a token), "
          f"decode graphs {graphs}, peak memory {peak / 2**30:.2f} GiB",
          flush=True)

    # (c) K1 per generate, per decode token and per scoring forward
    dev_ = next(model.parameters()).device
    g = torch.Generator(device=dev_).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (1, prompt), generator=g,
                         device=dev_)
    q8 = quantize_lm_params(params, activation_dtype=torch.bfloat16)

    def counting_step(mp, x, cs, ssm):
        c0, k0 = ss.LAUNCHES, step_launches()
        out = streaming.mamba_step(mp, x, cs, ssm)
        mixer_launches.append((ss.LAUNCHES - c0, step_launches() - k0))
        return out

    mixer_launches = []
    reset_counts()
    lm.generate(model, params, toks, 16, top_k=1, mixer_step=counting_step,
                generator=torch.Generator(device=dev_).manual_seed(1))
    per = {"generate": counts()["K1 inference"]}
    if len(mixer_launches) != 16 * cfg.n_layer or any(
            k1 or k != (2 if on_card else 0) for k1, k in mixer_launches):
        raise AssertionError(f"decode steps launched (K1, step kernels) "
                             f"{set(mixer_launches)} in "
                             f"{len(mixer_launches)} mixer steps")
    # through the decode graph: K1 in the prefill alone, a replay per token
    lm.generate(model, params, toks, 16, top_k=1,
                generator=torch.Generator(device=dev_).manual_seed(1))
    reset_counts()
    lm.generate(model, params, toks, 16, top_k=1,
                generator=torch.Generator(device=dev_).manual_seed(1))
    per["graph generate"] = counts()["K1 inference"]
    graphs = graph_counts()
    if on_card and (graphs != {"captures": 0, "replays": 16}
                    or step_launches() != 16 * 2 * cfg.n_layer):
        raise AssertionError(f"16 graph decode steps: {graphs}, "
                             f"{step_launches()} step kernel launches")
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
    print(f"lm: K1 launches per eager / graph generate / fp32 / int8 "
          f"scoring forward {per}: 0 in {len(mixer_launches)} eager decode "
          f"mixer steps and in {graphs['replays']} decode graph replays; "
          f"the decode step's kernels 2 a mixer step in both", flush=True)

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
            _, states = lm.prefill(parts, toks)
            tok = toks[:, -1]

            def step():
                lm.decode_step(parts, tok, states)

            replay = lm.decode_graph(model, parts, p, states).start(states)
            k0 = step_launches()
            replay(tok)
            k1 = step_launches()
            step()
            k2 = step_launches()
            if on_card and (k1 - k0, k2 - k1) != (2 * cfg.n_layer,) * 2:
                raise AssertionError(
                    f"lm {dtype}: a replay and an eager step launched the "
                    f"decode step's kernels {k1 - k0} and {k2 - k1} times, "
                    f"expected {2 * cfg.n_layer}")
            if on_card:
                prefill_ms = cuda_ms(lambda: lm.prefill(parts, toks), 5)
                decode_ms = cuda_ms(
                    lambda: [step() for _ in range(LM_DECODE_STEPS)],
                    3) / LM_DECODE_STEPS
                graph_ms = cuda_ms(
                    lambda: [replay(tok) for _ in range(LM_DECODE_STEPS)],
                    3) / LM_DECODE_STEPS
                prof = phase_profile(f"lm decode step {dtype}", step,
                                     n_runs=5)
                gprof = phase_profile(f"lm decode step {dtype} (graph "
                                      "replay)", lambda: replay(tok),
                                      n_runs=5)
            else:
                prefill_ms = decode_ms = graph_ms = prof = gprof = None
        timing[dtype] = dict(prefill_ms=prefill_ms,
                             decode_ms_per_token=decode_ms,
                             graph_decode_ms_per_token=graph_ms,
                             profile=prof, graph_profile=gprof)
        if on_card:
            busy = lambda pr: (f"{pr['kernels']} kernels per token, device "
                               f"busy {100 * pr['busy_share']:.1f} % of a "
                               "step" if pr else "no profile")
            print(f"lm {dtype}: prefill {prefill_ms:.3f} ms (1, {prompt}); "
                  f"decode ms per token (CUDA events over {LM_DECODE_STEPS} "
                  f"steps): graph {graph_ms:.3f} ({1e3 / graph_ms:.1f} "
                  f"tokens/s; {busy(gprof)}), eager {decode_ms:.3f} ("
                  f"{1e3 / decode_ms:.1f} tokens/s; {busy(prof)})",
                  flush=True)

    # (g) generate through the decode graph against the eager loop (the
    # mixer hook), bench_generation's defaults, in this call
    ones = torch.ones(1, prompt, dtype=torch.long, device=dev_)

    def run(p, eager, seed=1, **kw):
        kw = dict(dict(temperature=1.0, top_k=1), **kw)
        if eager:
            kw["mixer_step"] = streaming.mamba_step
        if on_card:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = lm.generate(model, p, ones, gen_len, generator=torch.Generator(
            device=dev_).manual_seed(seed), **kw)
        if on_card:
            torch.cuda.synchronize()
        return out, gen_len / (time.perf_counter() - t1)

    for dtype, p in variants.items():
        run(p, False)                       # the capture, untimed
        g_out, g_tps = run(p, False)
        e_out, e_tps = run(p, True)
        if not torch.equal(g_out, e_out):
            raise AssertionError(f"{dtype}: graph decode's tokens differ "
                                 "from the eager loop's at top-k 1")
        timing[dtype].update(graph_tokens_per_s=g_tps if on_card else None,
                             eager_tokens_per_s=e_tps if on_card else None)
        if on_card:
            print(f"lm {dtype}: generate (1, {prompt}) + {gen_len} tokens at "
                  f"top-k 1: graph {g_tps:.2f} tokens/s, eager loop "
                  f"{e_tps:.2f} tokens/s in this call; tokens equal",
                  flush=True)
    sampled = [run(params, eager, seed=5, top_k=0)[0]
               for eager in (False, True)]
    if not torch.equal(*sampled):
        raise AssertionError("fp32 graph decode's tokens differ from the "
                             "eager loop's at top-k 0, temperature 1")
    print(f"lm float32: {gen_len} tokens drawn at top-k 0, temperature 1 "
          "from one seed: graph decode's equal the eager loop's", flush=True)
    print(f"lm: phase {time.perf_counter() - t0:.1f} s", flush=True)
    return launched, dict(bench=bench, per_call_launches=per,
                          step_kernel_launches=stepped,
                          prefill_logits_err=logit_err,
                          teacher_scores_err=score_err, timing=timing,
                          peak_gib=peak / 2**30, scan_rows=rows)


def jamba_scan_row(peaks):
    """K1 (inference variant, z and last state) against its plain version
    at Jamba's prefill shape, (JAMBA_BATCH, JAMBA_PROMPT, d_inner 8192) in
    bf16, with B and C at unit RMS over d_state as Jamba's ``b_layernorm``
    / ``c_layernorm`` (weights 1) leave them, and A, D and the dt bias
    shared over the batch, as the model passes them."""
    from vivim_tpu_torch.kernels import refs
    from vivim_tpu_torch.kernels import selective_scan as ss

    b, L = JAMBA_BATCH, JAMBA_PROMPT
    d = JAMBA_CONFIG["mamba_expand"] * JAMBA_CONFIG["hidden_size"]
    dtype = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(20)
    u, delta, A, B, C, D, z, bias = scan_inputs(b, L, d, dtype, gen)
    unit = lambda t: (t.float() * torch.rsqrt(
        t.float().pow(2).mean(-1, keepdim=True) + 1e-6)).to(dtype)
    B, C, A, D, bias = unit(B), unit(C), A[0], D[0], bias[0]
    lc, grid = picked_chunk(b, L, d)
    run = lambda: ss.selective_scan_fwd_cuda(
        u, delta, A, B, C, D=D, z=z, delta_bias=bias, delta_softplus=True)
    got = run()
    torch.cuda.synchronize()
    want, plain_ms = once_ms(lambda: refs.selective_scan_ref(
        u, delta, A, B, C, D=D, z=z, delta_bias=bias, delta_softplus=True,
        return_last_state=True))
    rtol, atol = TOL[dtype]
    for what, g, w in zip(("y", "last"), got, want):
        torch.testing.assert_close(
            g.float(), w.float(), rtol=rtol, atol=atol,
            msg=f"K1 Jamba prefill shape ({b}, {L}, {d}) bf16 {what}")
    err = max((g.float() - w.float()).abs().max().item()
              for g, w in zip(got, want))
    scale = max(w.float().abs().max().item() for w in want)
    del want
    torch.cuda.empty_cache()
    call_ms = cuda_ms(run, 5)
    ms = device_ms(run, calls=3, repeats=3)
    work = scan_work(b, L, d, N, got[0].element_size())
    bound_ms, bound_by, term = bound(work, peaks)
    del got, u, delta, B, C, z
    torch.cuda.empty_cache()
    layers = sum(not (i % JAMBA_CONFIG["attn_layer_period"]
                      == JAMBA_CONFIG["attn_layer_offset"])
                 for i in range(JAMBA_LAYERS))
    row = dict(stage=f"jamba L={L}", batch=b, L=L, d=d, dtype="bfloat16",
               l_chunk=lc, grid=grid, max_abs_err=err, max_abs=scale,
               ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, bound_term=term, mbytes=work[0] / 1e6,
               calls_per_prefill=layers)
    print(f"K1 Jamba prefill bfloat16 ({b}, {L}, {d}) "
          f"{grid_text(lc, grid)}: y, last max_abs_err={err:.3e} (rtol "
          f"{rtol}, atol {atol}; |y|, |last| max {scale:.3f}) "
          f"device_ms={ms:.4f} (one call with its launch {call_ms:.4f}) "
          f"plain_ms={plain_ms:.1f} bound_ms={bound_ms:.5f} ({term}; "
          f"{work[0] / 1e6:.2f} MB, {work[2] / 1e6:.2f} M exps); per "
          f"prefill ({layers} calls): device {layers * ms:.3f} ms, plain "
          f"{layers * plain_ms:.1f} ms", flush=True)
    return row


def phase_jamba(peaks):
    """Phase 8b: Jamba on the LM's serving path at full width.  (a) K1
    against its plain version at the prefill's shape (``jamba_scan_row``);
    (b) ``load_jamba`` of a directory holding the published config.json,
    cut to ``JAMBA_LAYERS`` layers, in bf16 from the seeded init; one
    ``generate`` (the decode graph's capture), then, with the counts
    zeroed just before them, ``JAMBA_REQUESTS`` requests of (JAMBA_BATCH,
    JAMBA_PROMPT) prompts and JAMBA_GEN new tokens: K1 launched once per
    Mamba layer in each prefill and never in the replayed decode, no
    capture, one replay per new token, no conv; (c) the replayed hybrid
    decode step (the Mamba step, the GQA step against the K/V cache, the
    dropless MoE step) against the eager loop of ``decode_step``, teacher-
    forced on the replayed run's tokens; (d) the decode graph's K/V cache
    after a request: its position, and the keys and values at the served
    positions against a prefill's over the served sequence; (e) prefill ms
    and decode ms per step (CUDA events) and the distinct experts a step
    read."""
    import functools

    from vivim_tpu_torch.nn import jamba, lm, moe, streaming

    t0 = time.perf_counter()
    row = jamba_scan_row(peaks)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as snap:
        with open(os.path.join(snap, "config.json"), "w") as f:
            json.dump(JAMBA_CONFIG, f)
        model, params = jamba.load_jamba(snap, "cuda", torch.bfloat16, seed=0,
                                         num_hidden_layers=JAMBA_LAYERS)
    cfg = model.cfg
    n_mamba = sum(not cfg.is_attention(i) for i in range(JAMBA_LAYERS))
    n_moe = len(cfg.moe_layers())
    g = torch.Generator(device="cuda").manual_seed(21)
    prompts = [torch.randint(0, cfg.vocab_size, (JAMBA_BATCH, JAMBA_PROMPT),
                             generator=g, device="cuda")
               for _ in range(JAMBA_REQUESTS + 1)]
    run = lambda toks, **kw: lm.generate(model, params, toks, JAMBA_GEN,
                                         top_k=1, output_scores=True, **kw)
    reset_counts()
    run(prompts[-1])                    # the capture
    warm, warm_graphs = counts(), graph_counts()
    if (warm != launches(k1=n_mamba) or warm_graphs["captures"] != 1
            or step_launches() != graph_launches(2 * n_mamba, 1, JAMBA_GEN)
            or combine_launches() != n_moe):
        raise AssertionError(f"Jamba's first generate: {warm}, "
                             f"{warm_graphs}, {step_launches()} step kernel "
                             f"launches, {combine_launches()} MoE combines")
    read0 = int(moe.experts_read("cuda"))
    reset_counts()
    outs = [run(p) for p in prompts[:JAMBA_REQUESTS]]
    torch.cuda.synchronize()
    got, graphs, stepped = counts(), graph_counts(), step_launches()
    combined = combine_launches()
    want = launches(k1=n_mamba * JAMBA_REQUESTS)
    want_graphs = {"captures": 0, "replays": JAMBA_GEN * JAMBA_REQUESTS}
    want_steps = 2 * n_mamba * JAMBA_GEN * JAMBA_REQUESTS
    if (got != want or graphs != want_graphs or stepped != want_steps
            or combined != n_moe * JAMBA_REQUESTS):
        raise AssertionError(f"{JAMBA_REQUESTS} Jamba generates launched "
                             f"{got}, {graphs}, {stepped} step kernels, "
                             f"{combined} MoE combines; expected {want}, "
                             f"{want_graphs}, {want_steps}, "
                             f"{n_moe * JAMBA_REQUESTS}")
    per_step = ((int(moe.experts_read("cuda")) - read0)
                / (JAMBA_GEN * JAMBA_REQUESTS) / len(cfg.moe_layers()))
    print(f"jamba: {JAMBA_REQUESTS} generates of ({JAMBA_BATCH}, "
          f"{JAMBA_PROMPT}) + {JAMBA_GEN}: K1 {got['K1 inference']} ("
          f"{n_mamba} a prefill, none in {graphs['replays']} decode "
          f"replays), no capture, no conv, the decode step's kernels "
          f"{stepped} (2 x {n_mamba} a replay), the MoE combine {combined} "
          f"({n_moe} a prefill, none in the replays); {per_step:.2f} distinct "
          f"experts "
          f"of {cfg.num_experts} a step in each MoE layer", flush=True)
    # (c) the replayed step against the eager loop, teacher-forced
    toks, scores = outs[0]
    eager = functools.partial(streaming.mamba_step, norm_eps=cfg.rms_norm_eps)
    e_toks, e_scores = run(prompts[0], teacher_outputs=toks,
                           mixer_step=eager)
    if not torch.equal(e_toks, toks):
        raise AssertionError("Jamba's teacher-forced eager tokens differ "
                             "from the teacher")
    step_err = (scores - e_scores).abs().max().item()
    agree = (e_scores.argmax(-1) == toks[:, JAMBA_PROMPT:]).float().mean()
    if not step_err <= 1e-2:
        raise AssertionError(f"Jamba's replayed decode scores "
                             f"{step_err:.3e} from the eager loop's")
    print(f"jamba: replayed decode vs the eager loop, teacher-forced: "
          f"scores max_abs_err={step_err:.3e} (atol 1e-2; |scores| max "
          f"{scores.abs().max().item():.3f}); the eager argmax equal to the "
          f"replayed token at {100 * agree.item():.1f} %", flush=True)
    # (d) the decode graph's K/V cache after the last replayed request: its
    # position advanced once a step, and the keys and values it wrote at
    # the served positions those of a prefill over the served sequence
    dg = model._decoding_cache
    a = next(i for i in range(JAMBA_LAYERS) if cfg.is_attention(i))
    cache, pos = dg.states[a]
    parts = lm.split_params(model, params)
    full = outs[-1][0]
    with torch.no_grad():
        _, states = lm.prefill(parts, full, max_len=full.shape[1])
    if int(pos) != full.shape[1] or int(states[a][1]) != int(pos):
        raise AssertionError(f"Jamba's K/V position {int(pos)} after "
                             f"{JAMBA_GEN} steps from {JAMBA_PROMPT}")
    got_kv = cache[:, :, :, JAMBA_PROMPT:].float()
    want_kv = states[a][0][:, :, :, JAMBA_PROMPT:].float()
    rel = (got_kv - want_kv).norm(dim=-1) / want_kv.norm(dim=-1)
    kv_median, kv_max = rel.median().item(), rel.max().item()
    if not kv_median <= 0.05:
        raise AssertionError(f"Jamba's decoded keys and values lie "
                             f"{kv_median:.3e} (median, relative) from the "
                             "prefill's")
    print(f"jamba: K/V position {int(pos)} after {JAMBA_GEN} replayed "
          f"steps; the {JAMBA_GEN} decoded positions' keys and values "
          f"within {kv_median:.3e} (median) and {kv_max:.3e} (max) relative "
          f"of a prefill over the served sequence (median bound 0.05)",
          flush=True)
    del outs, toks, scores, e_toks, e_scores, states, full
    del got_kv, want_kv
    # (e) prefill and decode ms
    with torch.no_grad():
        prefill_ms = cuda_ms(lambda: lm.prefill(
            parts, prompts[0], max_len=JAMBA_PROMPT + JAMBA_GEN), 3)
    generate_ms = cuda_ms(lambda: run(prompts[1]), 3)
    decode_ms = (generate_ms - prefill_ms) / JAMBA_GEN
    peak = torch.cuda.max_memory_allocated()
    print(f"jamba: prefill {prefill_ms:.1f} ms, generate {generate_ms:.1f} "
          f"ms, so {decode_ms:.3f} ms a decode step with its draw; peak "
          f"memory {peak / 2**30:.2f} GiB", flush=True)
    del model, params, parts, prompts
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"jamba: phase {secs:.1f} s", flush=True)
    return got, dict(scan_row=row, launches=got, graphs=graphs,
                     step_kernel_launches=stepped, combine_launches=combined,
                     experts_per_step=per_step, decode_err=step_err,
                     kv_rel_median=kv_median, kv_rel_max=kv_max,
                     prefill_ms=prefill_ms, decode_ms=decode_ms,
                     peak_gib=peak / 2**30, secs=secs)


def phase_granite():
    """Phase 8c: Granite on the LM's serving path at the cell's widths.
    ``load_granite`` of a directory holding the benchmark's configuration
    file (10 layers, 9 Mamba-2 and 1 attention, each with its MoE block),
    bf16 from the seeded init; one ``generate`` (the decode graph's
    capture), then, with the counts zeroed just before them,
    ``GRANITE_REQUESTS`` requests of (8, 4096) prompts and ``GRANITE_GEN``
    new tokens: K1 once a Mamba-2 layer and the MoE combine once a layer in
    each prefill, neither in the replayed decode, no capture, one replay a
    new token; their peak memory; then one prefill with the combine kernel,
    with its plain version and with the parent's form: the last logits of
    the plain version's bit-equal to the kernel's, the parent's within its
    roundings, and each prefill's ms."""
    from vivim_tpu_torch.kernels import moe_combine as mc
    from vivim_tpu_torch.nn import granite, lm, moe

    t0 = time.perf_counter()
    with open(GRANITE_CONFIG) as f:
        config = json.load(f)
    with tempfile.TemporaryDirectory() as snap:
        with open(os.path.join(snap, "config.json"), "w") as f:
            json.dump(config, f)
        model, params = granite.load_granite(snap, "cuda", torch.bfloat16,
                                             seed=0)
    cfg = model.cfg
    n_layers = cfg.num_hidden_layers
    n_mamba = sum(kind == "mamba" for kind in cfg.layer_types)
    batch = GRANITE_MAMBA2[0]
    g = torch.Generator(device="cuda").manual_seed(27)
    prompts = [torch.randint(0, cfg.vocab_size, (batch, GRANITE_PROMPT),
                             generator=g, device="cuda")
               for _ in range(GRANITE_REQUESTS + 1)]
    run = lambda toks: lm.generate(model, params, toks, GRANITE_GEN,
                                   top_k=1)
    reset_counts()
    run(prompts[-1])                    # the capture
    warm, warm_graphs, warm_combined = (counts(), graph_counts(),
                                        combine_launches())
    if (warm != launches(k1=n_mamba) or warm_graphs["captures"] != 1
            or warm_combined != n_layers):
        raise AssertionError(f"Granite's first generate: {warm}, "
                             f"{warm_graphs}, {warm_combined} MoE combines")
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    for p in prompts[:GRANITE_REQUESTS]:
        run(p)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    got, graphs, combined = counts(), graph_counts(), combine_launches()
    want = launches(k1=n_mamba * GRANITE_REQUESTS)
    want_graphs = {"captures": 0,
                   "replays": GRANITE_GEN * GRANITE_REQUESTS}
    if (got != want or graphs != want_graphs
            or combined != n_layers * GRANITE_REQUESTS):
        raise AssertionError(f"{GRANITE_REQUESTS} Granite generates "
                             f"launched {got}, {graphs}, {combined} MoE "
                             f"combines; expected {want}, {want_graphs}, "
                             f"{n_layers * GRANITE_REQUESTS}")
    print(f"granite: {GRANITE_REQUESTS} generates of ({batch}, "
          f"{GRANITE_PROMPT}) + {GRANITE_GEN}: K1 {got['K1 inference']} "
          f"({n_mamba} a prefill), the MoE combine {combined} ({n_layers} a "
          f"prefill), none in {graphs['replays']} decode replays, no "
          f"capture; peak memory {peak / 1e9:.2f} GB", flush=True)
    # one prefill with the kernel, its plain version and the parent form
    parts = lm.split_params(model, params)
    prefill = lambda: lm.prefill(parts, prompts[0],
                                 max_len=GRANITE_PROMPT + GRANITE_GEN)[0]
    logits, ms = {}, {}
    try:
        for name, combine in (("kernel", mc.moe_combine),
                              ("plain", mc.plain_moe_combine),
                              ("parent", parent_combine)):
            moe.moe_combine = combine
            with torch.no_grad():
                logits[name] = prefill().float()
                ms[name] = cuda_ms(prefill, 3)
    finally:
        moe.moe_combine = mc.moe_combine
    parent_err = (logits["parent"] - logits["kernel"]).abs().max().item()
    print(f"granite: prefill ms with the combine kernel {ms['kernel']:.1f}, "
          f"with its plain version {ms['plain']:.1f}, with the parent form "
          f"{ms['parent']:.1f}; last logits: the plain version's "
          + ("bit-equal to" if torch.equal(logits["plain"], logits["kernel"])
             else "DIFFERENT from")
          + f" the kernel's, the parent form's within {parent_err:.3e} "
          f"(|logits| max {logits['kernel'].abs().max().item():.3f})",
          flush=True)
    if not torch.equal(logits["plain"], logits["kernel"]):
        raise AssertionError("Granite's prefill logits with the plain "
                             "combine differ from the kernel's")
    del model, params, parts, prompts, logits
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"granite: phase {secs:.1f} s", flush=True)
    return got, dict(launches=got, graphs=graphs, combine_launches=combined,
                     peak_gb=peak / 1e9, prefill_ms=ms,
                     parent_logit_err=parent_err, secs=secs)


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


def phase_falcon():
    """Phase 8d: Falcon-H1's shapes on the card, correctness only.  K1 at
    its prefill (8, 4096, 4096 channels, N 256, 2 groups) bf16 without z,
    as ``mamba2_prefill`` passes it, its output and last state held against
    the plain scan on the channels ``FALCON_HELD``; ``conv_step`` and the
    per-head ``ssm_step`` at (8, 4096, N 256, heads of 128, 2 groups) bf16
    against their plain versions over 4 steps; and the decode graph of
    ``load_falcon_h1`` (the benchmark's configuration cut to
    ``FALCON_LAYERS`` parallel layers, bf16, seeded) against the eager loop
    of ``decode_step`` on the prefill's states, teacher-forced on the same
    tokens."""
    from vivim_tpu_torch.kernels import mamba_step as mk
    from vivim_tpu_torch.kernels import refs
    from vivim_tpu_torch.kernels import selective_scan as ss
    from vivim_tpu_torch.nn import falcon_h1, lm
    from vivim_tpu_torch.utils import cuda_graphs

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(34)
    batch, heads, head_dim, n, groups = FALCON_MAMBA2
    d = heads * head_dim
    rtol, atol = TOL[torch.bfloat16]
    # (a) K1 at the prefill, grouped B and C as the mixer passes them
    rnd = lambda *sh: torch.randn(*sh, generator=gen, device="cuda")
    rand = lambda *sh: torch.rand(*sh, generator=gen, device="cuda")
    xbc = rnd(batch, GRANITE_PROMPT, d + 2 * groups * n).to(torch.bfloat16)
    dt = (0.5 * rnd(batch, GRANITE_PROMPT, heads)).to(torch.bfloat16)
    per_channel = lambda t: t.float().repeat_interleave(head_dim)
    A = -per_channel(1 + 15 * rand(heads))[:, None].expand(-1, n).contiguous()
    step = torch.exp(math.log(1e-3) + math.log(100) * rand(heads))
    bias = per_channel(step + torch.log(-torch.expm1(-step)))
    D = per_channel(1 + 0.1 * rnd(heads))
    u, delta = xbc[..., :d], dt.repeat_interleave(head_dim, -1)
    B = xbc[..., d:d + groups * n].unflatten(-1, (groups, n))
    C = xbc[..., d + groups * n:].unflatten(-1, (groups, n))
    y, last = ss.selective_scan(u, delta, A, B, C, D=D, delta_bias=bias,
                                delta_softplus=True, return_last_state=True)
    torch.cuda.synchronize()
    scan_err = 0.0
    for c in FALCON_HELD:
        g = c.start // (d // groups)
        want = refs.selective_scan_ref(u[..., c], delta[..., c], A[c],
                                       B[:, :, g], C[:, :, g], D=D[c],
                                       delta_bias=bias[c],
                                       delta_softplus=True,
                                       return_last_state=True)
        for what, got, w in zip(("y", "last"), (y[..., c], last[:, c]),
                                want):
            torch.testing.assert_close(
                got.float(), w.float(), rtol=rtol, atol=atol,
                msg=f"K1 Falcon prefill channels {c.start}:{c.stop} {what}")
            scan_err = max(scan_err,
                           (got.float() - w.float()).abs().max().item())
        del want
    del xbc, dt, u, delta, B, C, y, last
    print(f"falcon: K1 at ({batch}, {GRANITE_PROMPT}, {d}, N {n}), "
          f"{groups} groups, heads of {head_dim}, bf16, no z: y, last "
          f"max_abs_err={scan_err:.3e} on "
          f"{sum(c.stop - c.start for c in FALCON_HELD)} channels of both "
          f"groups (rtol {rtol}, atol {atol})", flush=True)
    # (b) the decode step's kernels at the mixer's shape
    conv, ssm = mamba2_step_inputs(batch, heads, head_dim, n, groups,
                                   torch.bfloat16, gen)
    plain_conv = dict(conv, conv_state=conv["conv_state"].clone())
    plain_ssm = dict(ssm, ssm_state=ssm["ssm_state"].clone())
    step_err = {"conv_step": 0.0, "ssm_step": 0.0}
    for _ in range(4):
        got = mk.conv_step(**conv), mk.ssm_step(**ssm)
        want = (mk.plain_conv_step(**plain_conv),
                mk.plain_ssm_step(**plain_ssm))
        torch.cuda.synchronize()
        for which, g, w in zip(step_err, got, want):
            torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                       atol=atol, msg=f"{which} Falcon")
            step_err[which] = max(step_err[which],
                                  (g.float() - w.float()).abs().max().item())
        torch.testing.assert_close(ssm["ssm_state"], plain_ssm["ssm_state"],
                                   rtol=6e-4, atol=2e-3,
                                   msg="ssm_step Falcon state")
    print(f"falcon: conv_step ({batch}, {d + 2 * groups * n}) and ssm_step "
          f"({batch}, {d}, N {n}, heads of {head_dim}, {groups} groups) "
          f"bf16 over 4 steps: max_abs_err {step_err['conv_step']:.3e} / "
          f"{step_err['ssm_step']:.3e}; the fp32 states within 6e-4 / 2e-3",
          flush=True)
    del conv, ssm, plain_conv, plain_ssm
    # (c) the parallel layers' decode graph against the eager loop
    with open(FALCON_CONFIG) as f:
        config = dict(json.load(f), num_hidden_layers=FALCON_LAYERS)
    with tempfile.TemporaryDirectory() as snap:
        with open(os.path.join(snap, "config.json"), "w") as f:
            json.dump(config, f)
        model, params = falcon_h1.load_falcon_h1(snap, "cuda",
                                                 torch.bfloat16, seed=0)
    vocab = model.cfg.vocab_size
    prompt = torch.randint(0, vocab, (batch, FALCON_PROMPT), generator=gen,
                           device="cuda")
    teacher = torch.randint(0, vocab, (batch, FALCON_GEN), generator=gen,
                            device="cuda")
    parts = lm.split_params(model, params)
    with torch.no_grad():
        _, states = lm.prefill(parts, prompt,
                               max_len=FALCON_PROMPT + FALCON_GEN)
        eager = [tuple(t.clone() for t in s) for s in states]
        replay = lm.decode_graph(model, parts, params, states).start(states)
        r0, k0 = cuda_graphs.REPLAYS, mk.LAUNCHES
        err = scale = 0.0
        for t in range(FALCON_GEN):
            got = replay(teacher[:, t]).float()
            want, eager = lm.decode_step(parts, teacher[:, t], eager)
            err = max(err, (got - want.float()).abs().max().item())
            scale = max(scale, want.float().abs().max().item())
        replays, launched = cuda_graphs.REPLAYS - r0, mk.LAUNCHES - k0
    positions = [int(s[3]) for s in model._decoding_cache.states]
    if not err <= 1e-2 or positions != [FALCON_PROMPT + FALCON_GEN] * \
            FALCON_LAYERS or replays != FALCON_GEN or launched != \
            2 * 2 * FALCON_LAYERS * FALCON_GEN:
        raise AssertionError(
            f"Falcon's decode graph: logits {err:.3e} from the eager "
            f"loop's, positions {positions}, {replays} replays, {launched} "
            "step kernels")
    print(f"falcon: {FALCON_LAYERS} parallel layers at published widths, "
          f"({batch}, {FALCON_PROMPT}) prompts: {FALCON_GEN} replayed steps "
          f"within {err:.3e} of the eager loop's logits (atol 1e-2; |logits| "
          f"max {scale:.2f}), positions {positions}, {launched} step kernel "
          f"launches (2 a mixer a step, replayed and eager); phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del model, params, parts, states, eager
    torch.cuda.empty_cache()
    return dict(scan_err=scan_err, step_err=step_err, decode_err=err)


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
            # blocks recomputes every MambaLayer's forward, conv included
            twice = 2 if level == "blocks" else 1
            _check_launches(log, launches(
                k1_train=twice * per_pass, k2=per_pass,
                conv=twice * per_pass, conv_bwd=per_pass),
                f"remat {level} step")
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
        launched, graphs = counts(), graph_counts()
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
    # batches of 1 clip: one capture, a replay per batch
    if dev.type == "cuda" and (
            graphs != {"captures": 1, "replays": n_batches}
            or launched != vivim_forward(graph_launches(per_pass, 1,
                                                        n_batches))):
        raise AssertionError(f"{n_batches} forwards: {graphs}, launched "
                             f"{launched}")
    print(f"infer from {os.path.relpath(ckpt, workdir)} (picked "
          f"{os.path.basename(infer.checkpoint_file(ckpt))}), --gathered "
          f"false on fold 0's validation case: {n_batches} batches of 1, "
          f"{graphs}, launches {launched}, fps {perf['fps']:.2f}, per-batch ms "
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
    or a copy of ``base`` (config and weights), its Mamba layers sharded
    over ``mesh``'s seq axis when it has one."""
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


def _par_init(rank, world, port, spec):
    """A phase 10 rank's process group, card and threads; returns the
    device."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # the host's cores shared between the ranks and this script
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // (world + 1)))
    from vivim_tpu_torch.parallel import fsdp
    from vivim_tpu_torch.parallel import mesh as mesh_lib

    if spec.get("min_shard_elems"):  # the CPU rehearsal's tiny leaves
        fsdp.MIN_SHARD_ELEMS = spec["min_shard_elems"]
    mesh_lib.init_distributed("gloo", PAR_GROUP_TIMEOUT_S)
    dev = torch.device(spec["dev"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def _seq_counters():
    """{exchange: [calls, bytes sent]} of ``comm.SEQ``, a copy, and the
    conv halos' ``comm.HOPPED`` (the one ``ppermute`` of a Vivim step)."""
    from vivim_tpu_torch.parallel import comm

    return dict({k: list(v) for k, v in comm.SEQ.items()},
                halo=list(comm.HOPPED))


def _par_cli(spec, name):
    """``train_folds.main`` of the run ``name`` (``PAR_CLI_RUNS``) on this
    rank: its seconds, launches, all_gathers and sequence exchanges."""
    from vivim_tpu_torch.cli import train_folds
    from vivim_tpu_torch.parallel import comm

    reset_counts()
    comm.reset_counters()
    t0 = time.perf_counter()
    train_folds.main(spec["cli_argv"] + ["-exp_name", name]
                     + PAR_CLI_RUNS[name][1])
    return dict(secs=time.perf_counter() - t0, launches=counts(),
                gathered=list(comm.GATHERED), seq=_seq_counters())


def _par_cli_rank(rank, world, port, out_dir, spec):
    """One rank of a phase 10 ``train_folds`` run of its own group
    (``spec["run"]``): writes ``cli<r>.json`` or ``rank<r>.err``."""
    try:
        _par_init(rank, world, port, spec)
        res = _par_cli(spec, spec["run"])
        with open(os.path.join(out_dir, f"cli{rank}.json"), "w") as f:
            json.dump(res, f)
    except BaseException:
        import traceback

        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _par_rank(rank, world, port, out_dir, spec):
    """One rank of phase 10 (a spawned process): (a) one step per mode
    (dp2, zero2, seq2) from the seeded state (seq2 first runs its sharded
    eval forward of that state), then one more; (b) ``train_folds.main`` of
    each 2-rank run of ``PAR_CLI_RUNS``.  Writes ``rank<r>.json`` (and
    rank 0 the states after the first step), or ``rank<r>.err`` with its
    traceback."""
    try:
        from vivim_tpu_torch.nn.mamba import MambaLayer
        from vivim_tpu_torch.parallel import comm, fsdp
        from vivim_tpu_torch.parallel import mesh as mesh_lib

        from vivim_tpu_torch.train import loop

        dev = _par_init(rank, world, port, spec)
        on_card = dev.type == "cuda"
        sync = torch.cuda.synchronize if on_card else (lambda: None)
        seg, size, clip_len = spec["segformer"], spec["size"], spec["clip_len"]
        batch = _par_step_inputs(size, clip_len, PAR_BATCH)
        init = _par_model(seg, "cpu")
        res = {"backend": torch.distributed.get_backend(), "modes": {},
               "probe": _probe_collectives(dev, world)}
        for mode in ("dp2", "zero2", "seq2"):
            mesh = mesh_lib.make_mesh(world, "seq" if mode == "seq2"
                                      else "data")
            base = torch.cuda.memory_allocated() if on_card else 0
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
                   "launches": [], "gathered": [], "seq": []}
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
                out["seq"].append(_seq_counters())
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
            # over what the process held before it built the model
            out["peak_over_base_gib"] = out["peak_gib"] - base / 2**30
            layers = [m for m in model.modules()
                      if isinstance(m, MambaLayer)]
            out["sharded_layers"] = [sum(m.ran_sharded for m in layers),
                                     len(layers)]
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
        res["cli"] = {name: _par_cli(spec, name)
                      for name, (n, _) in PAR_CLI_RUNS.items() if n == world}
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
    the same seeded state on the whole batch (seq2 with its Mamba layers on
    each rank's token shard: its peak per rank must stay below the
    one-device step's); (b) ``train_folds.main`` on phase 6's tree in the
    ranks of each ``PAR_CLI_RUNS`` run (``-n_devices 2 -zero true`` and
    ``-seq_shards 2`` in the two, ``-n_devices 2 -seq_shards 2`` in four),
    and ``cli.infer.main`` on each run's checkpoints in this process.
    ``min_shard_elems`` lowers ZeRO's threshold (a CPU rehearsal's tiny
    model).  Returns (launches, summary)."""
    from vivim_tpu_torch.train import loop

    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    per_pass = LAYERS_PER_STAGE * len(STAGES)
    t_phase = time.perf_counter()
    # the reference: one device, the whole batch, the same seeded state;
    # its peak over what this process held before, as the ranks' seq2 peak
    batch = _par_step_inputs(size, clip_len, PAR_BATCH)
    base = torch.cuda.memory_allocated() if on_card else 0
    model = _par_model(segformer, dev).eval()
    with torch.no_grad():
        ref_logits = model(batch["clip"][:1].to(dev)).cpu()
    state = loop.create_train_state(model, 1e-4, 1e-2, 2, seed=1)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    _, m = loop.make_train_step(model, "recall_focused", 3)(
        state, {k: v.to(dev) for k, v in batch.items()})
    one_peak = ((torch.cuda.max_memory_allocated() - base) / 2**30
                if on_card else 0.0)
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
    cli_ranks = {name: [r["cli"][name] for r in ranks]
                 for name, (n, _) in PAR_CLI_RUNS.items() if n == 2}
    for name, (n, _) in PAR_CLI_RUNS.items():
        if n == 2:
            continue
        run_dir = os.path.join(out_dir, name)
        os.makedirs(run_dir)
        print(f"parallel: {n} ranks over gloo, all on {spec['dev']}: "
              f"train_folds {' '.join(PAR_CLI_RUNS[name][1])}", flush=True)
        secs += _spawn_ranks(_par_cli_rank, n, run_dir, dict(spec, run=name),
                             PAR_WALL_S)
        cli_ranks[name] = [json.load(open(os.path.join(run_dir,
                                                       f"cli{r}.json")))
                           for r in range(n)]
    summary = {"backend": ranks[0]["backend"], "ranks": 2,
               "device": spec["dev"], "spawn_s": secs, "modes": {},
               "probe": ranks[0]["probe"]}
    print(f"parallel: {ranks[0]['backend']} on {spec['dev']} tensors, "
          f"checked by value: {ranks[0]['probe']}", flush=True)
    launched = launches()
    label = "2 ranks over gloo on one card, not a multi-card figure"
    for mode in ("dp2", "zero2", "seq2"):
        sd = torch.load(os.path.join(out_dir, f"{mode}.pt"),
                        weights_only=True)
        per = [r["modes"][mode] for r in ranks]
        for r, o in enumerate(per):
            if abs(o["loss"] - ref["loss"]) > 1e-5 * abs(ref["loss"]):
                raise AssertionError(f"{mode} rank {r}: loss {o['loss']} "
                                     f"vs one device {ref['loss']}")
            want = vivim_step(per_pass)
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
            seq_exchanges_per_step=[o["seq"][1] for o in per],
            peak_over_base_gib=[o["peak_over_base_gib"] for o in per],
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
            for r, o in enumerate(per):
                sharded, total = o["sharded_layers"]
                if on_card and sharded != total:
                    raise AssertionError(
                        f"seq2 rank {r}: {sharded} of {total} MambaLayers "
                        "ran on the token shard")
                if on_card and not o["peak_over_base_gib"] < one_peak:
                    raise AssertionError(
                        f"seq2 rank {r} peaks at "
                        f"{o['peak_over_base_gib']:.2f} GiB, not below the "
                        f"one-device step's {one_peak:.2f} GiB")
                card = nvidia_smi("name,power.limit") if on_card else "cpu"
                print(f"parallel seq2 rank {r}: peak {o['peak_gib']:.2f} GiB "
                      f"({o['peak_over_base_gib']:.2f} GiB over the process's "
                      f"base) vs the one-device step's {one_peak:.2f} GiB at "
                      f"the same {PAR_BATCH} clips; exchanges per step: "
                      + ", ".join(f"{k} {c} calls {b / 2**20:.1f} MiB"
                                  for k, (c, b) in o["seq"][1].items())
                      + f" ({label}; {card})", flush=True)
            summary["modes"]["seq2"].update(
                one_device_peak_gib=one_peak,
                sharded_layers=per[0]["sharded_layers"])
            logits = torch.load(os.path.join(out_dir, "seq2_logits.pt"),
                                weights_only=True)
            err = (logits - ref_logits).abs().max().item()
            if not err <= 1e-3:
                raise AssertionError(f"seq2 logits {err:.3e} from one "
                                     "device's")
            for r, o in enumerate(per):
                if on_card and o["eval_launches"] != vivim_forward(
                        per_pass):
                    raise AssertionError(f"seq2 rank {r} forward launched "
                                         f"{o['eval_launches']}")
                for k in launched:
                    launched[k] += o["eval_launches"][k]
            summary["modes"]["seq2"]["logits_max_abs_err"] = err
            print(f"parallel seq2: eval logits of the seeded state within "
                  f"{err:.3e} of one device's; launches per forward and rank "
                  f"{per[0]['eval_launches']}", flush=True)
    summary["cli"] = {}
    for name, (n_ranks, flags) in PAR_CLI_RUNS.items():
        runs = cli_ranks[name]
        for r, c in enumerate(runs):
            n = c["launches"]
            # a conv forward per K1, a conv backward per K2
            if on_card and (n["K1 training"] != n["K2"]
                            or n["K1 training"] % per_pass
                            or n["K1 inference"] % per_pass
                            or not n["K1 training"]
                            or n["dwconv3d forward"] != n["K1 inference"]
                            + n["K1 training"]
                            or n["dwconv3d backward"] != n["K2"]):
                raise AssertionError(f"cli {name} rank {r} launched {n}")
            # a -seq_shards run exchanges a halo per sharded MambaLayer
            if ("-seq_shards" in flags) != (c["seq"]["halo"][0] > 0):
                raise AssertionError(f"cli {name} rank {r}: sequence "
                                     f"exchanges {c['seq']}")
            for k in launched:
                launched[k] += n[k]
        run = os.path.join("par_runs", name, "fold_0")
        recs = [json.loads(x) for x in open(os.path.join(
            workdir, run, "metrics.jsonl"))]
        validated = "-val_freq" not in flags
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
            gathered=[c["gathered"] for c in runs],
            seq_exchanges=[c["seq"] for c in runs], infer_fps=perf["fps"])
        print(f"parallel cli {name}: train_folds in {n_ranks} ranks "
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
    launched = launches()

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
        if on_card and got["launches"] != launches(k1_train=per, k2=per):
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
        "tp2": launches(k1_train=per, k2=per),
        "pp2": launches(k1_train=lps * (n_micro + 1),
                        k2=lps * (n_micro + 1))}
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
            if on_card and o["score_launches"] != launches(k1=want_score):
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
    launched = launches()

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
    if on_card and got["launches"] != launches(k1=per):
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
    if on_card and c != launches(k1_train=per, k2=per):
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
    launched = launches()
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
            if on_card and run["launches"] != launches(k1_train=per,
                                                        k2=per):
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


def dstate_kernel_rows(peaks):
    """(a) of phase 13: K1 (both variants) and K2 at every d_state of
    ``DSTATE_NS`` at the LM's shape ``DSTATE_SHAPE`` in fp32, at
    ``DSTATE_BF16`` in bf16, and at the long ragged ``DSTATE_LONG`` (several
    chunks and segments) at ``DSTATE_LONG_NS``, each with an initial state
    and a non-zero last-state cotangent against its plain version on the
    card (K2 on the chunk states K1-training saved); the fp32 LM-shape
    cases are timed as the LM calls them (no initial state or dlast).
    Returns {"K1", "K1-train", "K2"}: rows."""
    from vivim_tpu_torch.kernels import refs
    from vivim_tpu_torch.kernels import selective_scan as ss

    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = {"K1": [], "K1-train": [], "K2": []}
    cases = ([(DSTATE_SHAPE, n, torch.float32) for n in DSTATE_NS]
             + [(DSTATE_SHAPE, n, torch.bfloat16) for n in DSTATE_BF16]
             + [(DSTATE_LONG, n, torch.float32) for n in DSTATE_LONG_NS])
    for (b, L, d), n, dtype in cases:
        u, delta, A, B, C, D, z, bias = scan_inputs(b, L, d, dtype, gen, n=n)
        h0 = torch.randn(b, d, n, generator=gen, device="cuda")
        dout = torch.randn(b, L, d, generator=gen, device="cuda").to(dtype)
        dlast = torch.randn(b, d, n, generator=gen, device="cuda")
        what = f"N={n} ({b}, {L}, {d}) {dtype_name(dtype)}"
        got = ss.selective_scan_fwd_cuda(u, delta, A, B, C, D, z, bias, True,
                                         h0)
        torch.cuda.synchronize()
        want, inf_plain = once_ms(lambda: refs.selective_scan_ref(
            u, delta, A, B, C, D, z, bias, True, True, h0))
        rtol, atol = TOL[dtype]
        for name, g, w in zip(("y", "last"), got, want):
            torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                       atol=atol, msg=f"K1 {what} {name}")
        inf_err = max((g.float() - w.float()).abs().max().item()
                      for g, w in zip(got, want))
        inf_scaled = scaled_err(got, want)
        (fwd_err, bwd_err, _, fwd_plain, bwd_plain, fwd_scaled,
         bwd_scaled) = check_train_pair(u, delta, A, B, C, D, bias, h0, dout,
                                        dlast, dtype, None, what)
        lc, grid = picked_chunk(b, L, d, n)
        ls, bgrid = picked_segment(b, L, d, n)
        base = dict(stage=f"N={n}", n=n, batch=b, L=L, d=d,
                    dtype=dtype_name(dtype))
        kinds = {"K1": (inf_err, inf_scaled, inf_plain,
                        dict(l_chunk=lc, grid=grid)),
                 "K1-train": (fwd_err, fwd_scaled, fwd_plain,
                              dict(l_chunk=lc, grid=grid)),
                 "K2": (bwd_err, bwd_scaled, bwd_plain,
                        dict(l_seg=ls, grid=bgrid))}
        text = ""
        if (b, L, d) == DSTATE_SHAPE and dtype == torch.float32:
            # timed as the LM calls them: no initial state, no dlast
            cs = ss.selective_scan_fwd_states_cuda(u, delta, A, B, C, D, bias,
                                                   True)[1]
            elem = u.element_size()
            runs = {
                "K1": (lambda: ss.selective_scan_fwd_cuda(
                    u, delta, A, B, C, D, z, bias, True),
                    scan_work(b, L, d, n, elem)),
                "K1-train": (lambda: ss.selective_scan_fwd_states_cuda(
                    u, delta, A, B, C, D, bias, True),
                    train_fwd_work(b, L, d, n, elem, ss.CHUNK)),
                "K2": (lambda: ss.selective_scan_bwd_cuda(
                    u, delta, A, B, C, D, bias, cs, dout, None, True),
                    bwd_work(b, L, d, n, elem, ss.CHUNK))}
            timed = {}
            for kind, (run, work) in runs.items():
                bound_ms, bound_by, term = bound(work, peaks)
                timed[kind] = dict(ms=device_ms(run, calls=5),
                                   call_ms=cuda_ms(run, 10),
                                   bound_ms=bound_ms, bound_by=bound_by,
                                   bound_term=term, mbytes=work[0] / 1e6)
            text = "; ms (bound, term) " + ", ".join(
                f"{k} {t['ms']:.4f} ({t['bound_ms']:.4f}, "
                f"{t['bound_term']})" for k, t in timed.items())
            del cs
        for kind, (err, scaled, plain, extra) in kinds.items():
            rows[kind].append(dict(base, max_abs_err=err, scaled_err=scaled,
                                   plain_ms=plain, **extra,
                                   **(timed[kind] if text else {})))
        print(f"dstate N={n:3d} {dtype_name(dtype):8s} ({b}, {L:4d}, {d:4d}) "
              f"{grid_text(lc, grid)} Ls={ls}: max_abs_err (scaled) K1 "
              f"{inf_err:.3e} ({inf_scaled:.3e}), K1-train {fwd_err:.3e} "
              f"({fwd_scaled:.3e}), K2 {bwd_err:.3e} ({bwd_scaled:.3e})"
              + text, flush=True)
        del u, delta, A, B, C, D, z, bias, h0, dout, dlast, got, want
    for kind, rs in rows.items():
        print(f"dstate {kind}: largest scaled error over the "
              f"{len(rs)} cases {max(r['scaled_err'] for r in rs):.3e}",
              flush=True)
    return rows


def phase_dstate_lm(d_state, dev="cuda", config=LM_CONFIG, batch=LMP_BATCH,
                    prompt=LMP_PROMPT, gen_len=DSTATE_GEN):
    """(b) of phase 13: the mamba-130m-width LM with ``ssm_cfg.d_state`` =
    ``d_state``, from a seeded snapshot through ``load_lm``, at (batch,
    prompt): the prefill's last logits and ``generate``'s greedy tokens
    (24 K1 per call, 0 per decode token), the eval core's scores of two
    pairs (24 K1 each) and one gradient step of next-token CE (24
    K1-training, 24 K2), each against the same model on the plain scan;
    prefill, decode and step ms.  ``dev="cpu"`` rehearses the host side at
    a small ``config``.  Returns (launches, summary)."""
    from vivim_tpu_torch.cli.lm_eval_harness import MambaEvalCore, load_lm
    from vivim_tpu_torch.kernels import selective_scan as ss
    from vivim_tpu_torch.nn import lm, streaming

    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    launched = launches()

    def add(c):
        for k in launched:
            launched[k] += c[k]

    config = dict(config, ssm_cfg=dict(config.get("ssm_cfg") or {},
                                       d_state=d_state))
    with tempfile.TemporaryDirectory() as snap:
        write_lm_snapshot(snap, config)
        model, params = load_lm(None, 0, 0, 0, hf_dir=snap, device=dev)
    cfg = model.cfg
    if cfg.d_state != d_state:
        raise AssertionError(f"loaded d_state {cfg.d_state}, want {d_state}")
    per = cfg.n_layer
    ref_model = lm.MambaLM(cfg, scan_implementation="ref")
    ref_model.load_state_dict(model.state_dict())
    ref_model = ref_model.to(dev).eval()
    ref_params = lm.lm_params(ref_model)
    toks = _lmp_tensors(dict(vocab=cfg.vocab_size, batch=batch,
                             prompt=prompt), dev)
    tag = f"dstate {d_state} lm"

    # the prefill's last logits
    parts, ref_parts = (lm.split_params(model, params),
                        lm.split_params(ref_model, ref_params))
    with torch.no_grad():
        reset_counts()
        got = lm.prefill(parts, toks)[0]
        c = counts()
        want = lm.prefill(ref_parts, toks)[0]
    add(c)
    prefill_err = _max_err(got, want)
    if on_card and c != launches(k1=per):
        raise AssertionError(f"{tag}: prefill launched {c}")
    if not prefill_err <= 1e-3:
        raise AssertionError(f"{tag}: prefill logits {prefill_err:.3e} "
                             "from the plain scan's")

    # generate: greedy tokens as the plain scan's, no K1 per decode token
    step_launches = []

    def counting_step(mp, x, cs, ssm):
        c0 = ss.LAUNCHES
        out = streaming.mamba_step(mp, x, cs, ssm)
        step_launches.append(ss.LAUNCHES - c0)
        return out

    reset_counts()
    got_toks = lm.generate(
        model, params, toks, gen_len, top_k=1, mixer_step=counting_step,
        generator=torch.Generator(device=dev).manual_seed(1))
    c = counts()
    add(c)
    want_toks, want_scores = lm.generate(
        ref_model, ref_params, toks, gen_len, top_k=1, output_scores=True,
        generator=torch.Generator(device=dev).manual_seed(1))
    top2 = want_scores.float().topk(2, dim=-1).values
    min_gap = (top2[..., 0] - top2[..., 1]).min().item()
    if not torch.equal(got_toks, want_toks):
        diff = (got_toks != want_toks).nonzero().tolist()
        raise AssertionError(f"{tag}: generate's greedy tokens differ from "
                             f"the plain scan's at {diff[:8]} (the plain "
                             f"run's smallest top-1 minus top-2 logit "
                             f"{min_gap:.3e})")
    if on_card and (c["K1 inference"] != per
                    or len(step_launches) != gen_len * per
                    or any(step_launches)):
        raise AssertionError(f"{tag}: generate launched {c}, "
                             f"{sum(step_launches)} K1 in "
                             f"{len(step_launches)} decode mixer steps")

    # the eval core's teacher-forced scores
    core = MambaEvalCore(model, params, CharTokenizer(cfg.vocab_size))
    ref_core = MambaEvalCore(ref_model, ref_params,
                             CharTokenizer(cfg.vocab_size))
    score_err, pairs = 0.0, lmp_pairs(2, seed=13)
    for ctx, cont in pairs:
        reset_counts()
        ll, greedy = core.loglikelihood_pair(ctx, cont)
        c = counts()
        add(c)
        ll0, greedy0 = ref_core.loglikelihood_pair(ctx, cont)
        if on_card and c["K1 inference"] != per:
            raise AssertionError(f"{tag}: scoring forward launched {c}")
        if not abs(ll - ll0) <= 1e-3 or greedy != greedy0:
            raise AssertionError(f"{tag}: score {ll} ({greedy}) through the "
                                 f"kernels, {ll0} ({greedy0}) on the plain "
                                 "scan")
        score_err = max(score_err, abs(ll - ll0))

    # one gradient step of next-token CE
    runs = {}
    for name, m in (("kernels", model), ("plain", ref_model)):
        m.zero_grad(set_to_none=True)
        reset_counts()
        logits = m(toks)
        loss = next_token_loss(logits, toks)
        loss.backward()
        sync()
        runs[name] = dict(logits=logits.detach(), loss=loss.item(),
                          launches=counts(),
                          grads={k: p.grad for k, p in m.named_parameters()})
    got, want = runs["kernels"], runs["plain"]
    add(got["launches"])
    if on_card and got["launches"] != launches(k1_train=per, k2=per):
        raise AssertionError(f"{tag}: gradient step launched "
                             f"{got['launches']}")
    if abs(got["loss"] - want["loss"]) > 1e-5 * abs(want["loss"]):
        raise AssertionError(f"{tag}: loss {got['loss']} through the "
                             f"kernels, {want['loss']} on the plain scan")
    logits_err = _max_err(got["logits"], want["logits"])
    if not logits_err <= 1e-3:
        raise AssertionError(f"{tag}: forward logits {logits_err:.3e} from "
                             "the plain scan's")
    grad_err = _check_grads(got["grads"], want["grads"], tag)
    passed = [k for k, g in got["grads"].items()
              if _leaf_err(0.5 * g, want["grads"][k])[1] <= GRAD_REL]
    if passed:
        raise AssertionError(f"{tag}: the gradient check passes halved "
                             f"gradients of {passed}")
    del runs, got, want, ref_model, ref_params, ref_parts, ref_core
    model.zero_grad(set_to_none=True)
    summary = dict(d_state=d_state, prefill_logits_err=prefill_err,
                   min_top2_gap=min_gap, score_err=score_err,
                   logits_err=logits_err, grad_err=grad_err)
    print(f"{tag}: ({batch}, {prompt}) prefill logits within "
          f"{prefill_err:.3e}, {gen_len} greedy tokens equal to the plain "
          f"scan's (smallest top-1 minus top-2 logit {min_gap:.3e}), 0 K1 "
          f"in {len(step_launches)} decode mixer steps, scores of "
          f"{len(pairs)} pairs within {score_err:.3e}, step logits within "
          f"{logits_err:.3e}, every gradient within rtol 1e-3 / atol 2e-3, "
          f"{_grad_text(grad_err)}; every leaf halved fails the check",
          flush=True)

    if on_card:  # prefill, decode and step ms
        def step():
            model.zero_grad(set_to_none=True)
            next_token_loss(model(toks), toks).backward()

        with torch.no_grad():
            _, states = lm.prefill(parts, toks)
            tok = toks[:, -1]
            reset_counts()
            summary["prefill_ms"] = cuda_ms(lambda: lm.prefill(parts, toks),
                                            5)
            summary["decode_ms_per_token"] = cuda_ms(
                lambda: [lm.decode_step(parts, tok, states)
                         for _ in range(LM_DECODE_STEPS)], 3) / LM_DECODE_STEPS
        summary["step_ms"] = cuda_ms(step, 3)
        add(counts())
        model.zero_grad(set_to_none=True)
        print(f"{tag}: prefill {summary['prefill_ms']:.3f} ms ({batch}, "
              f"{prompt}), decode {summary['decode_ms_per_token']:.3f} ms per "
              f"token ({batch} rows), forward + backward "
              f"{summary['step_ms']:.3f} ms (CUDA events, median)",
              flush=True)
    summary["secs"] = time.perf_counter() - t0
    summary["launches"] = dict(launched)
    return launched, summary


def phase_dstate_moe(d_state=DSTATE_MOE, dev="cuda", config=None,
                     batch=MOE_BATCH, prompt=MOE_PROMPT):
    """(b) of phase 13, the MoE LM: ``MOE_CONFIG`` at ``d_state``, seeded
    on the device, one scoring forward of (batch, prompt) tokens (24 K1)
    against the same weights on the plain scan: logits within 1e-3 and
    every routing decision bit-equal.  Returns (launches, summary)."""
    from vivim_tpu_torch.nn import moe

    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    cfg = moe.MoEMambaLMConfig(**dict(config or MOE_CONFIG, d_state=d_state))
    model = moe.init_moe_lm(cfg, seed=0, device=dev).eval()
    toks = _moe_tokens(cfg, dev, batch, prompt)
    runs = {}
    for name, impl in (("kernels", None), ("plain", "ref")):
        model.scan_implementation = impl
        with recorded_routing([]) as routes, torch.no_grad():
            reset_counts()
            logits, _ = model(toks)
            c = counts()
        runs[name] = dict(logits=logits, routes=routes, launches=c)
    got, want = runs["kernels"], runs["plain"]
    if on_card and got["launches"] != launches(k1=cfg.n_layer):
        raise AssertionError(f"d_state {d_state} MoE LM forward launched "
                             f"{got['launches']}")
    logits_err = _max_err(got["logits"], want["logits"])
    if not logits_err <= 1e-3:
        raise AssertionError(f"d_state {d_state} MoE LM logits "
                             f"{logits_err:.3e} from the plain scan's")
    gaps = torch.cat([g for _, g in got["routes"]])
    differ = [i for i, ((d, _), (d0, _)) in enumerate(
        zip(got["routes"], want["routes"])) if not torch.equal(d, d0)]
    if len(got["routes"]) != len(want["routes"]) or differ:
        raise AssertionError(f"d_state {d_state} MoE LM routing differs from "
                             f"the plain scan's in blocks {differ}; the "
                             f"smallest top-1 minus top-2 gate "
                             f"{gaps.min().item():.3e}")
    summary = dict(d_state=d_state, logits_err=logits_err,
                   decisions=gaps.numel(), min_gap=gaps.min().item(),
                   launches=got["launches"])
    print(f"dstate {d_state} moe lm: forward of ({batch}, {prompt}) tokens, "
          f"logits within {logits_err:.3e} of the plain scan's, every one of "
          f"the {gaps.numel()} routing decisions bit-equal (smallest top-1 "
          f"minus top-2 gate {summary['min_gap']:.3e}); launches "
          f"{got['launches']}", flush=True)
    del runs, got, want, model
    summary["secs"] = time.perf_counter() - t0
    return summary["launches"], summary


def phase_const_bc(dev="cuda", d_state=8):
    """(c) of phase 13: constant (dim, dstate) B or C, alone, together and
    beside a grouped one, through ``selective_scan`` on ``dev`` with every
    leaf requiring a gradient: no kernel launches (the JAX package's
    routing to the sequential plain scan), and the output, last state and
    every gradient within the kernels' tolerances of the same call on the
    CPU; then d_state 257 is refused on ``dev`` by the scan and by the LM's
    config check, and 256 taken.  Returns the largest error."""
    from vivim_tpu_torch.kernels import selective_scan as ss
    from vivim_tpu_torch.nn import lm

    g = torch.Generator().manual_seed(17)
    b, L, d, n = 2, 48, 24, d_state
    r = lambda *s: torch.randn(*s, generator=g)
    base = dict(u=r(b, L, d), delta=0.5 * r(b, L, d),
                A=-(0.5 + torch.rand(d, n, generator=g)), D=r(d), z=r(b, L, d),
                delta_bias=0.1 * r(d), initial_state=r(b, d, n))
    forms = {"constant B": (r(d, n), r(b, L, n)),
             "constant C": (r(b, L, n), r(d, n)),
             "constant B and C": (r(d, n), r(d, n)),
             "constant B, grouped C": (r(d, n), r(b, L, 2, n))}
    dout, dlast = r(b, L, d), r(b, d, n)
    worst = 0.0
    for form, (B, C) in forms.items():
        outs = []
        for where in (dev, "cpu"):
            leaves = {k: v.detach().clone().to(where).requires_grad_(True)
                      for k, v in dict(base, B=B, C=C).items()}
            kw = dict(leaves)
            reset_counts()
            y, last = ss.selective_scan(
                kw.pop("u"), kw.pop("delta"), kw.pop("A"), kw.pop("B"),
                kw.pop("C"), delta_softplus=True, return_last_state=True,
                **kw)
            torch.autograd.backward((y, last), (dout.to(where),
                                                dlast.to(where)))
            if any(counts().values()):
                raise AssertionError(f"{form} on {where} launched {counts()}")
            outs.append(dict(y=y.detach().cpu(), last=last.detach().cpu(),
                             **{f"d{k}": v.grad.cpu()
                                for k, v in leaves.items()}))
        for k, got in outs[0].items():
            rtol, atol = (TOL if k in ("y", "last")
                          else GRAD_TOL)[torch.float32]
            torch.testing.assert_close(got, outs[1][k], rtol=rtol, atol=atol,
                                       msg=f"{form} {k}")
            worst = max(worst, (got - outs[1][k]).abs().max().item())
    print(f"dstate const B/C: {len(forms)} forms ({', '.join(forms)}) on "
          f"{dev}: no kernel launched, output, last state and 9 gradients "
          f"within {worst:.3e} of the CPU's", flush=True)
    if torch.device(dev).type != "cuda":  # the CPU takes any d_state
        return worst
    too_big = torch.zeros(1, 4, 8, device=dev)
    try:
        ss.selective_scan(too_big, too_big, torch.zeros(8, 257, device=dev),
                          torch.zeros(1, 4, 257, device=dev),
                          torch.zeros(1, 4, 257, device=dev))
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError(f"d_state 257 on {dev} was not refused")
    lm.check_kernel_config(lm.MambaLMConfig(50, d_state=256), dev)
    try:
        lm.check_kernel_config(lm.MambaLMConfig(50, d_state=257), dev)
    except ValueError:
        pass
    else:
        raise AssertionError("check_kernel_config took d_state 257")
    print(f"dstate 257 refused on {dev}: {refused}", flush=True)
    return worst


def phase_dstate(peaks):
    """Phase 13: d_state from 1 to 256 on the card: (a) the kernels,
    (b) the LM at d_state 8 and 64 and the MoE LM at 64, (c) constant and
    mixed B/C.  Returns (launches by path, summary)."""
    t0 = time.perf_counter()
    summary = {"rows": dstate_kernel_rows(peaks)}
    secs = {"kernels": time.perf_counter() - t0}
    paths = {}
    for n in DSTATE_LM:
        paths[f"lm_dstate{n}"], summary[f"lm_dstate{n}"] = phase_dstate_lm(n)
        secs[f"lm d_state {n}"] = summary[f"lm_dstate{n}"]["secs"]
        torch.cuda.empty_cache()
    paths[f"moe_dstate{DSTATE_MOE}"], summary[f"moe_dstate{DSTATE_MOE}"] = (
        phase_dstate_moe())
    secs[f"moe lm d_state {DSTATE_MOE}"] = summary[
        f"moe_dstate{DSTATE_MOE}"]["secs"]
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    summary["const_bc_err"] = phase_const_bc()
    secs["constant B/C"] = time.perf_counter() - t1
    summary["secs"] = dict(secs, phase=time.perf_counter() - t0)
    print(f"dstate: phase {summary['secs']['phase']:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()) + ")",
          flush=True)
    return paths, summary


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


def dstate_entries(rows, paths):
    """Phase 13's kernels-line entries: {"K1", "K1-train", "K2"}: {N: entry}
    with N's rows, the launches of the paths at that d_state (the phase 13
    paths at theirs, every other path at ``N``) and the fp32 LM-shape row's
    times, ``n_layer`` launches each."""
    at = {n: launches() for n in DSTATE_NS}
    for name, c in paths.items():
        n = int(name.split("dstate")[1]) if "dstate" in name else N
        for k in c:
            at[n][k] += c[k]
    b, L, d = DSTATE_SHAPE
    source = "vivim_tpu_torch/kernels/csrc/selective_scan_{}.cu"
    kinds = {"K1": ("selective_scan_fwd", "fwd", 174, ("K1 inference",)),
             "K1-train": ("selective_scan_fwd (training variant)", "fwd", 174,
                          ("K1 training",)),
             "K2": ("selective_scan_bwd", "bwd", 227, ("K2",))}
    out = {}
    for kind, (name, src, line, keys) in kinds.items():
        out[kind] = {}
        for n in DSTATE_NS:
            mine = [r for r in rows[kind] if r["n"] == n]
            out[kind][str(n)] = _kernel_entry(
                f"{name} (d_state {n})", source.format(src),
                f"{JAX_PACKAGE}/kernels/selective_scan.py:{line}",
                sum(at[n][k] for k in keys), mine,
                f"LM shape ({b}, {L}, {d}) at d_state {n}: one launch per "
                f"layer, {LM_CONFIG['n_layer']} per LM call, fp32, {TIMING}",
                weight=LM_CONFIG["n_layer"],
                timed=[r for r in mine if (r["batch"], r["L"], r["d"])
                       == DSTATE_SHAPE])
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after phase 3d")
    parser.add_argument("--jamba-only", action="store_true",
                        help="run phase 8b (Jamba) alone after the build")
    parser.add_argument("--dstate-only", action="store_true",
                        help="run phase 13 (d_state 1 to 256) alone after "
                             "the build")
    parser.add_argument("--train-replay-only", action="store_true",
                        help="run phase 5c (the replayed train step) alone "
                             "after the build")
    parser.add_argument("--moe-combine-only", action="store_true",
                        help="run phases 3e, 8b and 8c (the prefill MoE's "
                             "combine) alone after the build")
    parser.add_argument("--falcon-only", action="store_true",
                        help="run phase 8d (Falcon-H1's shapes) alone after "
                             "the build")
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
    if args.jamba_only:
        phase_jamba(peaks)
        print(f"total: {time.perf_counter() - t_start:.1f} s; "
              "--jamba-only: phase 8b alone", flush=True)
        return
    if args.dstate_only:
        phase_dstate(peaks)
        print(f"total: {time.perf_counter() - t_start:.1f} s; "
              "--dstate-only: phase 13 alone", flush=True)
        return
    if args.moe_combine_only:
        phase_combine(peaks)
        t0 = done("3e MoE combine", t0)
        phase_jamba(peaks)
        t0 = done("8b Jamba", t0)
        phase_granite()
        print(f"total: {time.perf_counter() - t_start:.1f} s; "
              "--moe-combine-only: phases 3e, 8b and 8c", flush=True)
        return
    if args.falcon_only:
        phase_falcon()
        print(f"total: {time.perf_counter() - t_start:.1f} s; "
              "--falcon-only: phase 8d alone", flush=True)
        return
    if args.train_replay_only:
        print(json.dumps({"train_replay": phase_train_replay()}))
        print(f"total: {time.perf_counter() - t_start:.1f} s; "
              "--train-replay-only: phase 5c alone", flush=True)
        return

    rows = phase_kernels(peaks)
    t0 = done("3 K1 inference", t0)
    fwd_rows, bwd_rows, ragged_err = phase_train_kernels(peaks)
    t0 = done("3b K1 training + K2", t0)
    dw_rows = phase_dwconv(peaks)
    t0 = done("3c 3-D depthwise conv", t0)
    step_rows = phase_step_kernels(peaks)
    t0 = done("3d decode step kernels", t0)
    combine_rows = phase_combine(peaks)
    t0 = done("3e MoE combine", t0)
    if args.kernels_only:
        print(f"total: {time.perf_counter() - t_start:.1f} s; "
              "--kernels-only: stopped after phase 3d", flush=True)
        return
    serve_launched, serve_perf = phase_serve()
    t0 = done("4 serve", t0)
    train_launched, train_perf = phase_train()
    t0 = done("5 train", t0)
    phase_train_vs_plain()
    t0 = done("5b train vs plain scan", t0)
    replay_perf = phase_train_replay()
    t0 = done("5c replayed train step", t0)
    # phase 6's trees and runs stay here for phase 9
    work = tempfile.TemporaryDirectory()
    cli_launched, cli_perf = phase_train_cli(
        fp32_ref_ms=train_perf["fp32"]["median_ms"], workdir=work.name)
    t0 = done("6 train CLI", t0)
    binary_launched, binary_perf = phase_binary()
    t0 = done("7 binary and edge training", t0)
    lm_launched, lm_perf = phase_lm(peaks)
    t0 = done("8 LM serving", t0)
    jamba_launched, jamba_perf = phase_jamba(peaks)
    t0 = done("8b Jamba", t0)
    granite_launched, granite_perf = phase_granite()
    t0 = done("8c Granite", t0)
    phase_falcon()
    t0 = done("8d Falcon-H1", t0)
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
    dstate_launched, dstate_perf = phase_dstate(peaks)
    t0 = done("13 d_state 1 to 256", t0)

    paths = {"serve": serve_launched, "train": train_launched,
             "train_cli": cli_launched, "binary_edge": binary_launched,
             "lm": lm_launched, "jamba": jamba_launched,
             "granite": granite_launched, "remat": remat_launched,
             "infer_ckpt": infer_launched, "profile": tools_launched,
             "parallel": par_launched, "lm_parallel": lmp_launched,
             "moe_lm": moe_launched, "moe_ep": ep_launched,
             "int8_eval": int8_launched, **dstate_launched}
    total = {k: sum(p[k] for p in paths.values()) for k in launches()}
    by_dstate = dstate_entries(dstate_perf["rows"], paths)
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
        jamba_prefill=dict(
            jamba_perf["scan_row"],
            per=(f"Jamba prefill: "
                 f"{jamba_perf['scan_row']['calls_per_prefill']} inference "
                 f"launches at ({JAMBA_BATCH}, {JAMBA_PROMPT}, 8192), bf16, "
                 f"{TIMING}")),
        by_dstate=by_dstate["K1"],
        training_by_dstate=by_dstate["K1-train"],
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
        by_dstate=by_dstate["K2"],
        lm=_kernel_entry(
            "selective_scan_bwd (LM)",
            "vivim_tpu_torch/kernels/csrc/selective_scan_bwd.cu",
            f"{JAX_PACKAGE}/kernels/selective_scan.py:227",
            lmp_launched["K2"], lmp_perf["bwd_rows"], lm_step_text(),
            weight=LM_CONFIG["n_layer"],
            timed=lm_step_rows(lmp_perf["bwd_rows"])))
    dw_source = "vivim_tpu_torch/kernels/csrc/dwconv3d.cu"
    dw_replaces = (f"none: {JAX_PACKAGE}/nn/layers.py "
                   "unrolled_depthwise_conv is plain XLA")
    dw_timed = lambda which, batch: [r for r in dw_rows
                                     if r.get("which") == which
                                     and r["batch"] == batch]
    dw_per = (f"{LAYERS_PER_STAGE} launches at each Mix-FFN stage shape "
              f"(T {DW_FRAMES}, H = W and C of {DW_STAGES})")
    dw = _kernel_entry(
        "dwconv3d_fwd", dw_source, dw_replaces,
        total["dwconv3d forward"], dw_timed("forward", 1),
        f"serving forward, batch 1: {dw_per}, fp32, {TIMING}",
        launches_by_path=paths,
        library_ms_cudnn=sum(LAYERS_PER_STAGE * r["library_ms"]
                             for r in dw_timed("forward", 1)),
        ragged_max_abs_err=dw_rows[-1]["max_abs_err"],
        training=_kernel_entry(
            "dwconv3d_fwd (training step)", dw_source, dw_replaces,
            total["dwconv3d forward"], dw_timed("forward", TRAIN_BATCH),
            f"train step, batch {TRAIN_BATCH}: {dw_per}, fp32, {TIMING}",
            library_ms_cudnn=sum(LAYERS_PER_STAGE * r["library_ms"]
                                 for r in dw_timed("forward",
                                                   TRAIN_BATCH))))
    dw_bwd = _kernel_entry(
        "dwconv3d_bwd + dwconv3d_bwd_sum", dw_source, dw_replaces,
        total["dwconv3d backward"], dw_timed("backward", TRAIN_BATCH),
        f"train step, batch {TRAIN_BATCH}: {dw_per}, fp32, {TIMING}",
        launches_by_path=paths,
        library_ms_cudnn=sum(LAYERS_PER_STAGE * r["library_ms"]
                             for r in dw_timed("backward", TRAIN_BATCH)))
    step_source = "vivim_tpu_torch/kernels/csrc/mamba_step.cu"
    step_replaces = (f"none: {JAX_PACKAGE}/nn/streaming.py mamba_step is "
                     "plain XLA")
    step_launched = (lm_perf["step_kernel_launches"]
                     + jamba_perf["step_kernel_launches"])
    step_per = (f"a generate request's decode: {LM_GEN} tokens x "
                f"{LM_CONFIG['n_layer']} layers at (1, "
                f"{2 * LM_CONFIG['d_model']}, {N}), fp32, {TIMING}")
    step_entries = [_kernel_entry(
        which, step_source, step_replaces, step_launched,
        [r for r in step_rows if r["which"] == which], step_per,
        weight=LM_GEN * LM_CONFIG["n_layer"],
        timed=[r for r in step_rows if r["which"] == which and r["n"] == N
               and r["batch"] == 1]) for which in ("conv_step", "ssm_step")]
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    lm_summary = {k: v for k, v in lm_perf.items() if k != "scan_rows"}
    lmp_summary = {k: v for k, v in lmp_perf.items()
                   if k not in ("fwd_rows", "bwd_rows")}
    print(json.dumps({"kernels": [k1, k2, dw, dw_bwd, *step_entries],
                      "serve": serve_perf,
                      "train": train_perf, "train_replay": replay_perf,
                      "train_cli": cli_perf, "binary_edge": binary_perf,
                      "lm": lm_summary,
                      "jamba": {k: v for k, v in jamba_perf.items()
                                if k != "scan_row"},
                      "granite": granite_perf,
                      "moe_combine": {
                          "rows": combine_rows,
                          "launches": (jamba_perf["combine_launches"]
                                       + granite_perf["combine_launches"])},
                      "remat": remat_perf,
                      "infer_ckpt": infer_perf, "tools": tools_perf,
                      "parallel": par_perf, "lm_parallel": lmp_summary,
                      "moe_lm": moe_perf, "moe_ep": ep_perf,
                      "segformer": seg_perf, "int8_eval": int8_perf,
                      "dstate": {k: v for k, v in dstate_perf.items()
                                 if k != "rows"}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
