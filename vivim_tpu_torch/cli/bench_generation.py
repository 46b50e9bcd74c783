"""LM generation latency benchmark.

Port of the JAX package's ``cli/bench_generation.py`` (the reference's
benchmarks/benchmark_generation_mamba_simple.py:17-90): times the prompt's
prefill and the token decode of a MambaLM and prints one JSON line with
tokens/s.  It runs a real checkpoint (``--hf_dir`` local snapshot,
``--ckpt``) or random weights from a seed, and a real ``--prompt`` through a
tokenizer, printing the decoded continuation.

Usage (on the card unless ``--device cpu``):
  python -m vivim_tpu_torch.cli.bench_generation --d_model 768 --n_layer 24 \\
      --promptlen 128 --genlen 128
  python -m vivim_tpu_torch.cli.bench_generation --hf_dir /path/snapshot \\
      --prompt "My cat wrote all this CUDA code for a new language model" \\
      --tokenizer EleutherAI/gpt-neox-20b
  torchrun --nproc_per_node 2 -m vivim_tpu_torch.cli.bench_generation \\
      --tp_shards 2                 # a card per rank, NCCL
  torchrun --nproc_per_node 2 -m vivim_tpu_torch.cli.bench_generation \\
      --tp_shards 2 --dist_backend gloo --device cuda:0   # one card shared

``--tp_shards N`` decodes tensor-parallel (``parallel/tensor_parallel.
tp_generate``) over N ranks, one process each; only rank 0 prints.

A ``--hf_dir`` whose ``config.json`` says ``"model_type": "jamba"`` runs
Jamba (``nn/jamba.py::load_jamba``: its weights where the directory holds
them, else a seeded init; ``--n_layer`` cuts it to its first layers) through
the same ``generate``, on one device, in fp32 or bf16:
  python -m vivim_tpu_torch.cli.bench_generation --hf_dir /path/jamba \
      --n_layer 8 --dtype bfloat16 --batch 8 --promptlen 4096 --genlen 128

A ``"model_type": "granitemoehybrid"`` directory runs Granite 4.0-H
(``nn/granite.py::load_granite``) the same way, and a ``"falcon_h1"`` one
Falcon-H1 (``nn/falcon_h1.py::load_falcon_h1``):
  python -m vivim_tpu_torch.cli.bench_generation --hf_dir /path/granite \
      --n_layer 10 --dtype bfloat16 --batch 8 --promptlen 4096 --genlen 128
  python -m vivim_tpu_torch.cli.bench_generation --hf_dir /path/falcon-h1 \
      --n_layer 18 --dtype bfloat16 --batch 8 --promptlen 4096 --genlen 128
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--vocab", type=int, default=50277)
    p.add_argument("--d_model", type=int, default=768)
    p.add_argument("--n_layer", type=int, default=None,
                   help="layers of a seeded Mamba LM (24 when not given), "
                        "or the first layers of a Jamba, Granite or "
                        "Falcon-H1 --hf_dir")
    p.add_argument("--hf_dir", type=str, default=None,
                   help="local HF mamba snapshot dir (config.json + "
                        "pytorch_model.bin); overrides the dim flags")
    p.add_argument("--hf_repo", type=str, default=None,
                   help="HF hub repo id (e.g. state-spaces/mamba-130m); "
                        "downloads the snapshot (needs network)")
    p.add_argument("--ckpt", type=str, default=None,
                   help="torch state-dict checkpoint (HF mamba layout)")
    p.add_argument("--prompt", type=str, default=None,
                   help="text prompt; needs --tokenizer, prints the decoded "
                        "continuation")
    p.add_argument("--tokenizer", type=str, default=None,
                   help="HF tokenizer name/path for --prompt")
    p.add_argument("--promptlen", type=int, default=128)
    p.add_argument("--genlen", type=int, default=128)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--topk", type=int, default=1)
    p.add_argument("--topp", type=float, default=1.0)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--tp_shards", type=int, default=1,
                   help="tensor-parallel decode over a 'model' mesh axis "
                        "of that many ranks under torchrun (sharded "
                        "conv/ssm cache; parallel/tensor_parallel)")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16", "int8"],
                   help="weights and activations of the decode: bfloat16 "
                        "casts every floating tensor; int8 quantizes the "
                        "in / out projections and the tied embedding per "
                        "output channel (nn/quant.py), with per-row int8 "
                        "activations at those products and bf16 elsewhere. "
                        "The SSM state and its recurrence stay fp32 in "
                        "every mode")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda by default, cuda:LOCAL_RANK "
                        "per rank; cuda:<i> puts every rank on card i, "
                        "gloo only; cpu runs the kernels' plain versions)")
    p.add_argument("--dist_backend", type=str, default="nccl",
                   choices=["nccl", "gloo"],
                   help="torch.distributed backend of --tp_shards ranks "
                        "(gloo for the CPU, or for ranks that share one "
                        "card)")
    args = p.parse_args(argv)
    if args.dtype == "int8" and args.tp_shards > 1:
        raise SystemExit("--dtype int8 is single-device decode only "
                         "(the TP island shards plain param trees)")

    from vivim_tpu_torch.cli.common import init_model_parallel
    from vivim_tpu_torch.cli.lm_eval_harness import load_lm
    from vivim_tpu_torch.nn.lm import generate

    hybrid = args.hf_dir is not None and _model_type(args.hf_dir) in (
        "jamba", "granitemoehybrid", "falcon_h1")
    if hybrid and (args.tp_shards > 1 or args.dtype == "int8"
                   or args.ckpt):
        raise SystemExit("a Jamba, Granite or Falcon-H1 --hf_dir runs on one "
                         "device in float32 or bfloat16, from the "
                         "directory's own weights")
    device, mesh = init_model_parallel(
        args.tp_shards, "model", "--tp_shards", args.device,
        args.dist_backend, "bench_generation")
    if hybrid:
        from vivim_tpu_torch.nn import falcon_h1, granite, jamba

        load = {"jamba": jamba.load_jamba,
                "granitemoehybrid": granite.load_granite,
                "falcon_h1": falcon_h1.load_falcon_h1}[
            _model_type(args.hf_dir)]
        cut = {} if args.n_layer is None else {
            "num_hidden_layers": args.n_layer}
        model, params = load(
            args.hf_dir, device, torch.bfloat16 if args.dtype == "bfloat16"
            else torch.float32, **cut)
    else:
        model, params = load_lm(args.ckpt, args.vocab, args.d_model,
                                args.n_layer or 24, hf_dir=args.hf_dir,
                                hf_repo=args.hf_repo, device=device)
    dev = next(model.parameters()).device
    if args.dtype == "bfloat16":
        params = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                  for k, v in params.items()}
    elif args.dtype == "int8":
        from vivim_tpu_torch.nn.quant import quantize_lm_params

        # quantized from the fp32 weights (the scales stay fp32); the other
        # tensors become bf16 in the same walk
        params = quantize_lm_params(params, activation_dtype=torch.bfloat16)

    tokenizer = None
    if args.prompt is not None:
        if args.tokenizer is None:
            raise SystemExit("--prompt needs --tokenizer")
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.tokenizer)
        ids = tokenizer.encode(args.prompt)
        tokens = torch.tensor([ids] * args.batch, dtype=torch.long,
                              device=dev)
    else:
        tokens = torch.ones(args.batch, args.promptlen, dtype=torch.long,
                            device=dev)

    def gen():
        kw = dict(generator=torch.Generator(device=dev).manual_seed(1),
                  temperature=args.temperature, top_k=args.topk,
                  top_p=args.topp)
        if mesh is not None:
            return tp_generate(model, params, tokens, args.genlen, mesh,
                               **kw)
        return generate(model, params, tokens, args.genlen, **kw)

    if mesh is not None:
        from vivim_tpu_torch.parallel.tensor_parallel import (
            split_tp_params,
            tp_generate,
        )

        # this rank's channels, split once and held alone: the whole
        # weights go (tp_generate reads only the model's config)
        params = {k: v.clone() for k, v in
                  split_tp_params(params, mesh).items()}
        model.to("meta")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = gen()  # warm-up: the kernels' build and first launches
    sync()
    t0 = time.perf_counter()
    for _ in range(args.repeats):
        out = gen()
    sync()
    dt = (time.perf_counter() - t0) / args.repeats
    if mesh is not None and not mesh.is_main:
        return out
    print(json.dumps({
        "prompt_len": int(tokens.shape[1]),
        "gen_len": args.genlen,
        "batch": args.batch,
        "total_sec": round(dt, 4),
        "tokens_per_sec": round(args.batch * args.genlen / dt, 2),
        "dtype": args.dtype,
    }))
    if tokenizer is not None:
        print(tokenizer.batch_decode(out.tolist())[0])
    return out


def _model_type(hf_dir):
    with open(os.path.join(hf_dir, "config.json")) as f:
        return json.load(f).get("model_type")


if __name__ == "__main__":
    main()
