"""Mamba LM generation: ``nn/lm.py::generate`` as ``bench_generation``
calls it (a fresh generator per call, temperature 1, top-k 1), with
``output_scores``, in a closed loop: each request copies its seeded
prompt ids to the card, prefills them (K1, one launch per layer), decodes
its new tokens through the replayed decode graph and ends with its
tokens on the host.  Set-up loads the weights and runs warm-up requests
(the decode graph's capture) on prompts the window never sends.

The tokens and the per-token logits (``scores``) of a sample of the
window's requests, drawn from the seed, are kept.  The check reads each
prompt with its served tokens through the plain reference in one forward:
the logits that chose each token must lie within the limit of the
reference's, and each served token's reference logit may lie below the
reference's best by no more than the limit (greedy decoding: a token is
the best unless rounding breaks a near tie).
"""

from __future__ import annotations

import torch

from perfbench import harness, programs, traffic, weights, work
from perfbench.reference import mamba_lm as ref_lib
from perfbench.reference.vivim import no_scan

WARMUP = 2


def lm_flops(cfg, batch, length):
    """Matmul FLOPs of the reference forward over (batch, length) tokens,
    counted on the meta device (the scan's work is counted apart)."""
    from torch.utils.flop_counter import FlopCounterMode

    model = ref_lib.build(cfg, "meta")
    model.set_scan(no_scan)
    tokens = torch.zeros((batch, length), dtype=torch.long, device="meta")
    with FlopCounterMode(display=False) as fc:
        model(tokens)
    return fc.get_total_flops()


def reference(spec):
    cfg = spec.config
    model = ref_lib.build(cfg, spec.device)
    model.load_state_dict(weights.make(
        weights.shapes_of(model), traffic.sub_seed(spec.seed, "weights"),
        spec.device))
    return model.eval()


class Cell:
    def __init__(self, spec):
        self.spec = spec
        self.cfg, self.t = spec.config, spec.traffic
        self.dev = spec.device
        self.kept = {}

    def prompt(self, i):
        """Request ``i``'s prompt ids on the host (negative ``i``: a
        warm-up's, never sent in the window)."""
        if i >= 0:
            return self.prompts[i % len(self.prompts)]
        t = self.t
        return traffic.token_ids(self.spec.seed, i, t["batch"],
                                 t["prompt_len"], self.cfg["vocab_size"])

    def setup(self):
        shapes = weights.shapes_of(ref_lib.build(self.cfg, self.dev))
        w = weights.make(shapes, traffic.sub_seed(self.spec.seed, "weights"),
                         self.dev)
        self.model, self.params = programs.lm(self.cfg, w, self.dev)
        self.prepare()
        for k in range(WARMUP):
            self.request(-1 - k)
        if self.dev.startswith("cuda"):
            torch.cuda.synchronize()

    def request(self, i):
        """Request ``i`` (negative: a warm-up's prompt) to its host tokens;
        keeps its tokens and scores when sampled."""
        from vivim_tpu_torch.nn.lm import generate

        t = self.t
        tokens = self.prompt(i).to(self.dev)
        gen = torch.Generator(device=self.dev).manual_seed(
            traffic.sub_seed(self.spec.seed, "draw", i))
        out, scores = generate(self.model, self.params, tokens,
                               t["new_tokens"], generator=gen,
                               temperature=t["temperature"], top_k=t["top_k"],
                               top_p=t["top_p"], output_scores=True)
        host = out.cpu()
        if i in self.sample:
            self.kept[i] = (host, host[:, t["prompt_len"]:], scores)
        return host

    def measure(self, seconds, clock):
        window, profile = harness.closed_loop(
            self.request, seconds, clock, harness.synchronizer(self.dev),
            self.t["profiled_units"] if self.spec.trace else 0,
            self.dev.startswith("cuda"))
        window.amount = window.units * self.t["batch"] * self.t["new_tokens"]
        if profile is not None:
            profile.tokens = profile.units * self.t["batch"] * self.t[
                "new_tokens"]
        return window, profile

    def end_to_end(self, window):
        return {"lm_tokens_per_s": window.rate()}

    def layer_info(self):
        t, cfg = self.t, self.cfg
        n = (cfg.get("ssm_cfg") or {}).get("d_state", 16)
        k1 = work.total([work.scan_work(*s, n, 4) for s in
                         work.lm_scan_shapes(cfg, t["batch"],
                                             t["prompt_len"])])
        # per request: the prompt and every new token through the model
        length = t["prompt_len"] + t["new_tokens"]
        scan = work.total([work.scan_work(*s, n, 4) for s in
                           work.lm_scan_shapes(cfg, t["batch"], length)])
        return {"flops_per_unit": lm_flops(cfg, t["batch"], length)
                + scan[1], "k1_work": k1}

    def release(self):
        self.model = self.params = None

    def compare(self, kept, model):
        """``kept``: {request: (the tokens read, the tokens served after
        the prompt, the logits that chose them)}.  logit_err: the largest
        gap between those logits and the reference's over the same tokens;
        token_gap: the widest gap by which a served token's reference logit
        lies below the best."""
        lim = self.spec.limits
        if not kept:
            return [harness.Check("checked_requests", 0.0, -1.0)]
        p = self.t["prompt_len"]
        err = gap = 0.0
        with torch.no_grad():
            for i, (tokens, served, scores) in sorted(kept.items()):
                logits = model(tokens[:, :-1].to(self.dev))[:, p - 1:]
                err = max(err, float((scores - logits).abs().max()))
                chosen = logits.gather(-1, served.to(self.dev)[..., None])[
                    ..., 0]
                gap = max(gap, float((logits.max(-1).values - chosen).max()))
        return [harness.Check("logit_err", err, lim["logit_err"]),
                harness.Check("token_gap", gap, lim["token_gap"])]

    def check(self):
        return self.compare(self.kept, reference(self.spec))

    def prepare(self):
        """The prompt pool and the sampled requests."""
        t = self.t
        self.prompts = [traffic.token_ids(self.spec.seed, i, t["batch"],
                                          t["prompt_len"],
                                          self.cfg["vocab_size"])
                        for i in range(t["pool"])]
        self.sample = set(traffic.sample(self.spec.seed,
                                         self.t["sample_within"],
                                         self.t["checked"]))

    def control(self):
        """The reference with TF32 in the program's place, read at every
        position of each sampled prompt followed by seeded tokens: its
        logits, and the token it puts first."""
        model = reference(self.spec)
        t, kept = self.t, {}
        with torch.no_grad(), harness.tf32(True):
            for i in self.sample:
                more = traffic.token_ids(self.spec.seed, f"next{i}",
                                         t["batch"], t["new_tokens"],
                                         self.cfg["vocab_size"])
                tokens = torch.cat([self.prompt(i), more], 1).to(self.dev)
                scores = model(tokens[:, :-1])[:, t["prompt_len"] - 1:]
                kept[i] = (tokens, scores.argmax(-1), scores)
        return self.compare(kept, model)
