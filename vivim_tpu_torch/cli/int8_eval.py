"""Task-level check of int8 weight-only decode.

Port of the JAX package's ``scripts/int8_eval.py``.  A ``MambaLM`` learns
a synthetic task with structure to lose, then scores held-out
continuations through the lm-eval request path in fp32, bf16 and int8, so
that quantization has a task-level cost beside its logit distance:

  1. a corpus from a fixed-seed order-2 Markov chain over a 32-symbol
     alphabet (``make_corpus``, the JAX script's to the token);
  2. ``INT8_EVAL_STEPS`` (400) AdamW steps at 3e-3 with weight decay 1e-2
     on every parameter (``optax.adamw``'s defaults: no clipping, no mask,
     a constant rate) through ``train/loop.py::AdamW``, batch 32 x 64
     tokens; on the card each step runs K1-training and K2 once per layer;
  3. ``INT8_EVAL_N_EVAL`` (64) held-out 48 + 16-token pairs from the
     corpus's unseen tail, scored by ``cli.lm_eval_harness.MambaEvalCore
     .loglikelihood_pair`` with the fp32 parameters, a bf16 copy
     (``train.loop.cast_floating``) and int8 weights with bf16 activations
     (``nn.quant.quantize_lm_params``);
  4. the per-token NLL, perplexity and greedy exact-match of each, and the
     bf16 and int8 NLL deltas against fp32.

``INT8_EVAL_D_MODEL`` (256) and ``INT8_EVAL_N_LAYER`` (4) set the model.
The weights are the port's seeded init (seed 0), not the JAX script's.
Writes the result to ``--out`` (``docs/int8_eval_torch.json`` by default)
and prints it as one JSON line, with the card's name and power limit.

  python -m vivim_tpu_torch.cli.int8_eval [--device cuda] [--out PATH]

Runs on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import time

import numpy as np
import torch

VOCAB = 32
SEQ = 64
BATCH = 32
CONTEXT = 48          # tokens of context per held-out pair; SEQ - CONTEXT
CONTINUATION = 16     # of continuation
LR, WEIGHT_DECAY = 3e-3, 1e-2
LOG_EVERY = 100
DEFAULT_OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "docs", "int8_eval_torch.json")


def env_config():
    """(d_model, n_layer, train steps, held-out pairs) from the
    ``INT8_EVAL_*`` environment variables, the JAX script's defaults."""
    get = lambda k, d: int(os.environ.get(f"INT8_EVAL_{k}", d))
    return get("D_MODEL", 256), get("N_LAYER", 4), get("STEPS", 400), \
        get("N_EVAL", 64)


class ToyTokenizer:
    """One symbol per character over the synthetic alphabet (the eval
    core's encode / decode contract)."""

    eos_token_id = 0
    _chars = [chr(ord("a") + i) for i in range(26)] + list(".,;:!?")

    def encode(self, text):
        return [self._chars.index(c) for c in text]

    def decode(self, ids):
        return "".join(self._chars[i] for i in ids)


def make_corpus(rng: np.random.Generator, n_tokens: int) -> np.ndarray:
    """Order-2 Markov chain with a sparse transition table: each (a, b)
    context allows 3 successors with probabilities 0.6 / 0.3 / 0.1, so a
    trained LM beats the uniform ln(32) = 3.47 NLL by a wide margin."""
    table = rng.integers(0, VOCAB, size=(VOCAB, VOCAB, 3))
    probs = np.array([0.6, 0.3, 0.1])
    out = np.empty(n_tokens, np.int32)
    out[0], out[1] = rng.integers(0, VOCAB, 2)
    choices = rng.choice(3, size=n_tokens, p=probs)
    for i in range(2, n_tokens):
        out[i] = table[out[i - 2], out[i - 1], choices[i]]
    return out


def make_optimizer(model, steps):
    """``optax.adamw(LR, weight_decay=WEIGHT_DECAY)``: decay on every
    parameter, no clipping, a constant rate (a cosine whose floor is its
    start)."""
    from vivim_tpu_torch.train.loop import AdamW

    return AdamW(model, LR, WEIGHT_DECAY, steps, eta_min_ratio=1.0,
                 clip_norm=None, decay_mask="torch")


def next_token_nll(model, toks):
    """Mean NLL of every next token of ``toks`` (B, L + 1)."""
    logits = model(toks[:, :-1])
    logp = torch.log_softmax(logits.float(), -1)
    return -logp.gather(-1, toks[:, 1:, None]).mean()


def heldout_pairs(tail, n_eval):
    """(context, continuation) strings of the corpus's unseen tail."""
    tok = ToyTokenizer()
    pairs = []
    for i in range(n_eval):
        seg = tail[i * (SEQ + 1):(i + 1) * (SEQ + 1)]
        pairs.append((tok.decode(seg[:CONTEXT].tolist()),
                      tok.decode(seg[CONTEXT:SEQ].tolist())))
    return pairs


def card_line(dev) -> str:
    """``nvidia-smi``'s name and power limit of the card ``dev`` runs on,
    or ``cpu``."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", f"--id={dev.index or 0}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda by default; cpu runs the "
                        "kernels' plain versions)")
    p.add_argument("--out", default=DEFAULT_OUT,
                   help="where the JSON result goes")
    args = p.parse_args(argv)

    from vivim_tpu_torch.cli.common import resolve_device
    from vivim_tpu_torch.cli.lm_eval_harness import MambaEvalCore
    from vivim_tpu_torch.nn import lm
    from vivim_tpu_torch.nn.layers import init_weights
    from vivim_tpu_torch.nn.quant import quantize_lm_params
    from vivim_tpu_torch.train.loop import cast_floating

    dev = resolve_device(args.device)
    d_model, n_layer, steps, n_eval = env_config()
    t0 = time.perf_counter()
    corpus = make_corpus(np.random.default_rng(0),
                         steps * BATCH * (SEQ + 1) + 10_000)
    cfg = lm.MambaLMConfig(vocab_size=VOCAB, d_model=d_model,
                           n_layer=n_layer)
    model = init_weights(lm.MambaLM(cfg), torch.Generator().manual_seed(0))
    model = model.to(dev).train()
    opt = make_optimizer(model, steps)
    stride = BATCH * (SEQ + 1)
    train = torch.from_numpy(corpus[:steps * stride].astype(np.int64)).to(
        dev).view(steps, BATCH, SEQ + 1)
    losses = []
    for s in range(steps):
        nll = next_token_nll(model, train[s])
        nll.backward()
        opt.step()
        for q in model.parameters():
            q.grad = None
        nll = nll.detach()
        if s % LOG_EVERY == 0:
            losses.append(float(nll))
    final_train_nll = float(nll)
    train_s = time.perf_counter() - t0

    model.eval()
    pairs = heldout_pairs(corpus[steps * stride:], n_eval)
    params = lm.lm_params(model)
    variants = {
        "float32": params,
        "bfloat16": cast_floating(params, torch.bfloat16),
        "int8": quantize_lm_params(params, activation_dtype=torch.bfloat16),
    }
    results = {}
    for name, vp in variants.items():
        core = MambaEvalCore(model, vp, ToyTokenizer())
        scores = [core.loglikelihood_pair(ctx, cont) for ctx, cont in pairs]
        nll = -float(np.mean([ll for ll, _ in scores])) / CONTINUATION
        results[name] = {
            "nll_per_token": nll, "ppl": math.exp(nll),
            "greedy_exact_match": float(np.mean([g for _, g in scores]))}
    f32 = results["float32"]["nll_per_token"]
    out = {
        "config": f"MambaLM d_model={d_model} n_layer={n_layer} "
                  f"vocab={VOCAB}, trained {steps} steps on an order-2 "
                  f"Markov corpus; {n_eval} held-out {CONTEXT}+"
                  f"{CONTINUATION}-token loglikelihood requests through "
                  "MambaEvalCore (the lm-eval request path)",
        "uniform_nll": math.log(VOCAB),
        "train_nll_curve": losses,
        "final_train_nll": final_train_nll,
        "results": results,
        "nll_delta_bf16_vs_fp32": results["bfloat16"]["nll_per_token"] - f32,
        "nll_delta_int8_vs_fp32": results["int8"]["nll_per_token"] - f32,
        "device": str(dev),
        "card": card_line(dev),
        "train_seconds": train_s,
        "seconds": time.perf_counter() - t0,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
