"""Granite 4.0-H generation: ``nn/lm.py::generate`` serving the port's
``GraniteHybridLM`` as ``jamba_generate`` serves Jamba (a fresh generator per
call, temperature 1, top-k 1, ``output_scores``, one closed-loop client):
each request copies its seeded prompt ids to the card, prefills them
eagerly (K1 for each Mamba-2 layer, SDPA for the attention layer, the
dropless top-k MoE with its shared expert), decodes its new tokens through
the replayed decode graph, which holds the K/V cache beside the Mamba-2
conv and ssm states, and ends with its tokens on the host.  Set-up draws
the weights (``granite_program.build``) and runs warm-up requests (the
decode graph's capture) on prompts the window never sends.

The check is Jamba's (``jamba_generate.Cell.compare``: ``logit_err``,
``logit_err_row_median``, ``token_gap`` over the sampled requests) against
the plain reference of ``reference/granite.py``, a layer at a time, its
weights drawn again from the seed; the control is that reference with
every matmul's operands rounded to float8 e4m3.

The traced run also reads, from the same profiler events, the device
seconds of the kernels launched inside the program's ``lm.ssm`` spans (each
Mamba mixer's recurrence in the prefill: ``span_device_seconds``).
"""

from __future__ import annotations

import bisect

import torch

from perfbench import granite_program, harness, jamba_program, spans
from perfbench.drivers import jamba_generate
from perfbench.reference import granite as ref


class Cell(jamba_generate.Cell):
    def setup(self):
        from vivim_tpu_torch.nn import moe
        from vivim_tpu_torch.utils import cuda_graphs

        self.model, self.params = granite_program.build(
            self.cfg, self.spec.seed, self.dev)
        self.prepare()
        for k in range(self.t["warmup"]):
            self.request(-1 - k)
        # the decode steps and the experts they read from here on
        self.counted = (cuda_graphs.REPLAYS,
                        int(moe.experts_read(self.dev)))

    def profiled(self, first, sync):
        """The profile of ``profiled_units`` requests after the window; from
        the same profiler events, the device seconds of each replay of the
        decode graph (``replay_seconds``) and of the kernels launched in
        ``lm.ssm`` spans (``span_device_seconds``)."""
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
        self.ssm_seconds = span_device_seconds(events, cuda, "lm.ssm")
        return out

    def layer_info(self):
        """Per request: the analytic FLOPs, K1's work and the device ms of
        the ``lm.ssm`` spans' kernels; per decode step (on the card): the
        bytes it must move, with the distinct experts the served steps
        chose, and its device ms in the profiled requests."""
        t, cfg = self.t, self.cfg
        elem = granite_program.DTYPES[cfg["dtype"]].itemsize
        info = {"flops_per_unit": granite_program.request_flops(
                    cfg, t["batch"], t["prompt_len"], t["new_tokens"]),
                "k1_work": granite_program.k1_work(cfg, t["batch"],
                                                   t["prompt_len"], elem)}
        if getattr(self, "ssm_seconds", None):
            info["ssm_ms"] = 1e3 * self.ssm_seconds / t["profiled_units"]
        if not self.dev.startswith("cuda"):
            return info
        from vivim_tpu_torch.nn import moe
        from vivim_tpu_torch.utils import cuda_graphs

        steps = cuda_graphs.REPLAYS - self.counted[0]
        read = int(moe.experts_read(self.dev)) - self.counted[1]
        info["bf16_peak"] = jamba_program.bf16_peak(
            torch.cuda.get_device_name(0))
        if steps:
            info["decode_bytes"] = granite_program.decode_bytes(
                cfg, t["batch"], t["prompt_len"], t["new_tokens"],
                read / steps, elem)
        if getattr(self, "replays", None):
            info["decode_ms"] = 1e3 * sum(self.replays) / len(self.replays)
        return info

    def reference(self, rnd=None):
        """``logits_of`` of the plain reference (operands through ``rnd``),
        float32 with TF32 off, its weights drawn again from the seed."""
        weight = granite_program.reference_weight(self.cfg, self.spec.seed,
                                                  self.dev)

        def logits_of(tokens, positions):
            with harness.tf32(False):
                return ref.forward(self.cfg, weight, tokens, positions, rnd)
        return logits_of


def span_device_seconds(events, cuda_type, name):
    """Summed device seconds of the kernels, copies and sets whose launch
    (a host CUDA launch call) starts inside a host range ``name`` among
    kineto ``events``, matched by the launch's correlation id; None where
    no such range holds a launch."""
    from perfbench import trace

    ranges = sorted((ev.start_ns(), ev.end_ns()) for ev in events
                    if ev.device_type() != cuda_type and ev.name() == name)
    if not ranges:
        return None
    starts = [s for s, _ in ranges]
    launched = set()
    for ev in events:
        if (ev.device_type() != cuda_type
                and ev.name().startswith(spans.LAUNCH_CALLS)):
            i = bisect.bisect_right(starts, ev.start_ns()) - 1
            if i >= 0 and ev.start_ns() < ranges[i][1]:
                launched.add(ev.correlation_id())
    total = sum(ev.end_ns() - ev.start_ns() for ev in events
                if ev.device_type() == cuda_type
                and ev.correlation_id() in launched and trace.device_work(ev))
    return total * 1e-9 if launched else None
