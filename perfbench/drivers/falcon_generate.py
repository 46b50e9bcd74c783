"""Falcon-H1 generation: ``nn/lm.py::generate`` serving the port's
``FalconH1LM`` as ``jamba_generate`` serves Jamba (a fresh generator per
call, temperature 1, top-k 1, ``output_scores``, one closed-loop client):
each request copies its seeded prompt ids to the card, prefills them
eagerly (in every layer K1 for the Mamba-2 mixer and SDPA for the
attention beside it), decodes its new tokens through the replayed decode
graph, which holds each layer's Mamba-2 conv and ssm states beside its K/V
cache and position, and ends with its tokens on the host.  Set-up draws the
weights (``falcon_program.build``) and runs warm-up requests (the decode
graph's capture) on prompts the window never sends.

The check is Jamba's (``jamba_generate.Cell.compare``: ``logit_err``,
``logit_err_row_median``, ``token_gap`` over the sampled requests) against
the plain reference of ``reference/falcon_h1.py``, a layer at a time, its
weights drawn again from the seed; the control is that reference with
every matmul's operands rounded to float8 e4m3.

The traced run also reads, from the same profiler events, the device
seconds of each decode replay (``jamba_generate.replay_seconds``) and of
the kernels launched inside the program's ``lm.ssm`` and ``lm.attn`` spans
(``granite_generate.span_device_seconds``).
"""

from __future__ import annotations

import torch

from perfbench import falcon_program, harness, jamba_program
from perfbench.drivers import granite_generate, jamba_generate
from perfbench.reference import falcon_h1 as ref

SPANS = {"ssm_ms": "lm.ssm", "attn_ms": "lm.attn"}


class Cell(jamba_generate.Cell):
    def setup(self):
        from vivim_tpu_torch.utils import cuda_graphs

        self.model, self.params = falcon_program.build(
            self.cfg, self.spec.seed, self.dev)
        self.prepare()
        for k in range(self.t["warmup"]):
            self.request(-1 - k)
        self.replays_before = cuda_graphs.REPLAYS   # the decode steps since

    def profiled(self, first, sync):
        """The profile of ``profiled_units`` requests after the window; from
        the same profiler events, the device seconds of each decode replay
        and of the kernels launched in each span of ``SPANS``."""
        from torch.profiler import ProfilerActivity, profile, record_function

        from perfbench import trace

        n = self.t["profiled_units"]
        acts = [ProfilerActivity.CPU]
        if self.dev.startswith("cuda"):
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with record_function(trace.WINDOW):
                for k in range(first, first + n):
                    self.request(k)
                sync()
        events = prof.profiler.kineto_results.events()
        cuda = torch.autograd.DeviceType.CUDA
        out = trace.reduce(events, cuda)
        out.units = n
        out.tokens = n * self.t["batch"] * self.t["new_tokens"]
        self.replays = jamba_generate.replay_seconds(events, cuda)
        self.span_seconds = {
            key: granite_generate.span_device_seconds(events, cuda, name)
            for key, name in SPANS.items()}
        return out

    def layer_info(self):
        """Per request: the analytic FLOPs, K1's work and the device ms of
        the ``lm.ssm`` and ``lm.attn`` spans' kernels; per decode step (on
        the card): the bytes it must move and its device ms in the profiled
        requests."""
        t, cfg = self.t, self.cfg
        elem = falcon_program.DTYPES[cfg["dtype"]].itemsize
        info = {"flops_per_unit": falcon_program.request_flops(
                    cfg, t["batch"], t["prompt_len"], t["new_tokens"]),
                "k1_work": falcon_program.k1_work(cfg, t["batch"],
                                                  t["prompt_len"], elem)}
        for key, seconds in getattr(self, "span_seconds", {}).items():
            if seconds:
                info[key] = 1e3 * seconds / t["profiled_units"]
        if not self.dev.startswith("cuda"):
            return info
        from vivim_tpu_torch.utils import cuda_graphs

        info["bf16_peak"] = jamba_program.bf16_peak(
            torch.cuda.get_device_name(0))
        if cuda_graphs.REPLAYS > self.replays_before:
            info["decode_bytes"] = falcon_program.decode_bytes(
                cfg, t["batch"], t["prompt_len"], t["new_tokens"], elem)
        if getattr(self, "replays", None):
            info["decode_ms"] = 1e3 * sum(self.replays) / len(self.replays)
        return info

    def reference(self, rnd=None):
        """``logits_of`` of the plain reference (operands through ``rnd``),
        float32 with TF32 off, its weights drawn again from the seed."""
        weight = falcon_program.reference_weight(self.cfg, self.spec.seed,
                                                 self.dev)

        def logits_of(tokens, positions):
            with harness.tf32(False):
                return ref.forward(self.cfg, weight, tokens, positions, rnd)
        return logits_of
