"""Mamba LM scoring: ``cli/lm_eval_harness.py``'s ``MambaEvalCore``
answering lm_eval's ``loglikelihood_rolling`` requests, in a closed
loop.  A request is one rolling window: the EOT id, then the request's
seeded ids (a stub tokenizer maps each request's text to them), every
position scored from its prefix; it ends with the log-likelihood on the
host.  Set-up loads the weights and answers warm-up requests the window
never sends.

The scoring forward's logits of a sample of the window's requests, drawn
from the seed, are kept (the core drops them after each request).  The
check runs the plain reference over the same ids: every logit within the
limit, and the log-likelihood per scored token within its limit.
"""

from __future__ import annotations

import torch

from perfbench import harness, programs, traffic, weights, work
from perfbench.drivers.lm_generate import lm_flops, reference
from perfbench.reference import mamba_lm as ref_lib

WARMUP = 2
EOT = 0


class Tokenizer:
    """``encode(text) -> ids``: a request's text is its index, its ids
    are the seeded ones."""

    def __init__(self, cell):
        self.cell = cell

    def encode(self, text):
        return self.cell.ids(int(text)).tolist()

    def decode(self, ids):
        return " ".join(map(str, ids))


class Cell:
    def __init__(self, spec):
        self.spec = spec
        self.cfg, self.t = spec.config, spec.traffic
        self.dev = spec.device
        self.kept = {}
        self.lls = {}
        self.index = None

    def ids(self, i):
        """Request ``i``'s ids (negative ``i``: a warm-up's)."""
        if i >= 0:
            return self.pool[i % len(self.pool)]
        return self.draw(i)

    def draw(self, i):
        return traffic.token_ids(self.spec.seed, i, 1, self.t["length"] - 1,
                                 self.cfg["vocab_size"])[0]

    def setup(self):
        from vivim_tpu_torch.cli.lm_eval_harness import MambaEvalCore

        shapes = weights.shapes_of(ref_lib.build(self.cfg, self.dev))
        w = weights.make(shapes, traffic.sub_seed(self.spec.seed, "weights"),
                         self.dev)
        self.model, params = programs.lm(self.cfg, w, self.dev)
        self.core = MambaEvalCore(self.model, params, Tokenizer(self),
                                  eot_token_id=EOT)
        forward = self.core._fwd

        def keeping(toks):
            logits = forward(toks)
            if self.index in self.sample:
                self.kept[self.index] = logits[0]
            return logits

        self.core._fwd = keeping
        self.prepare()
        for k in range(WARMUP):
            self.request(-1 - k)
        if self.dev.startswith("cuda"):
            torch.cuda.synchronize()

    def request(self, i):
        self.index = i
        ll = self.core.loglikelihood_rolling_str(str(i))
        if i in self.sample:
            self.lls[i] = ll
        return ll

    def measure(self, seconds, clock):
        window, profile = harness.closed_loop(
            self.request, seconds, clock, harness.synchronizer(self.dev),
            self.t["profiled_units"] if self.spec.trace else 0,
            self.dev.startswith("cuda"))
        window.amount = window.units * (self.t["length"] - 1)
        return window, profile

    def end_to_end(self, window):
        return {"lm_tokens_per_s": window.rate()}

    def layer_info(self):
        cfg, L = self.cfg, self.t["length"]
        n = (cfg.get("ssm_cfg") or {}).get("d_state", 16)
        k1 = work.total([work.scan_work(*s, n, 4)
                         for s in work.lm_scan_shapes(cfg, 1, L)])
        return {"flops_per_unit": lm_flops(cfg, 1, L) + k1[1], "k1_work": k1}

    def release(self):
        self.model = self.core = None

    def compare(self, kept, lls, model):
        """logit_err: the largest gap between the scoring forward's logits
        and the reference's; ll_err_per_token: the log-likelihood's gap
        over the scored tokens."""
        lim = self.spec.limits
        if not kept:
            return [harness.Check("checked_requests", 0.0, -1.0)]
        err = ll_err = 0.0
        with torch.no_grad():
            for i, prog in sorted(kept.items()):
                ids = self.ids(i).to(self.dev)
                tokens = torch.cat([ids.new_full((1,), EOT), ids])[None]
                logits = model(tokens)[0]
                n = ids.shape[0]
                err = max(err, float((prog[:n] - logits[:n]).abs().max()))
                logp = torch.log_softmax(logits[:n].double(), -1)
                ll = float(logp.gather(-1, ids[:, None]).sum())
                ll_err = max(ll_err, abs(lls[i] - ll) / n)
        return [harness.Check("logit_err", err, lim["logit_err"]),
                harness.Check("ll_err_per_token", ll_err,
                              lim["ll_err_per_token"])]

    def check(self):
        return self.compare(self.kept, self.lls, reference(self.spec))

    def prepare(self):
        """The pool of requests' ids and the sampled requests."""
        self.pool = [self.draw(i) for i in range(self.t["pool"])]
        self.sample = set(traffic.sample(self.spec.seed,
                                         self.t["sample_within"],
                                         self.t["checked"]))

    def control(self):
        """The reference with TF32 scores the sampled requests in the
        program's place."""
        model = reference(self.spec)
        kept, lls = {}, {}
        with torch.no_grad(), harness.tf32(True):
            for i in self.sample:
                ids = self.ids(i).to(self.dev)
                tokens = torch.cat([ids.new_full((1,), EOT), ids])[None]
                logits = model(tokens)[0]
                logp = torch.log_softmax(logits[:-1].float(), -1)
                lls[i] = float(logp.gather(-1, ids[:, None]).sum())
                kept[i] = logits
        return self.compare(kept, lls, model)
