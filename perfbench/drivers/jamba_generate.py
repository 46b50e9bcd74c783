"""Jamba generation: ``nn/lm.py::generate`` serving the port's ``JambaLM``
as ``bench_generation`` calls it (a fresh generator per call, temperature
1, top-k 1), with ``output_scores``, in a closed loop of one client: each
request copies its seeded prompt ids to the card, prefills them eagerly
(K1 for each Mamba layer, SDPA for the attention layer, the dropless MoE
block with its host-read group sizes), decodes its new tokens through the
replayed decode graph, which holds the K/V cache beside the conv and ssm
states, and ends with its tokens on the host.  Set-up draws the weights
(``jamba_program.build``) and runs warm-up requests (the decode graph's
capture) on prompts the window never sends.

The check is ``lm_generate``'s: the tokens and the per-token logits
(``scores``) of a sample of the window's requests, drawn from the seed, are
kept; after the program is released each prompt with its served tokens is
read through the plain reference (``reference/jamba.py``) in one forward,
a layer at a time, its weights drawn again from the seed, with logits at
the served positions only.  ``logit_err``: the largest gap between the
logits that chose the served tokens and the reference's; ``token_gap``:
the widest gap by which a served token's reference logit lies below the
reference's best; ``logit_err_row_median``: the largest, over the rows
(slots) of the sampled requests, of the median over a row's served tokens
of each token's largest logit gap.  Both maxima are set by the few tokens
whose near-tied routing bf16 flips; a row's median is not, and a fault in
one slot of the batch moves its own row's median.  The control is that
reference with every matmul's operands rounded to float8 e4m3, one
precision below the configuration's bf16.
"""

from __future__ import annotations

import torch

from perfbench import harness, jamba_program, traffic
from perfbench.reference import jamba as ref


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
        from vivim_tpu_torch.nn import moe
        from vivim_tpu_torch.utils import cuda_graphs

        self.model, self.params = jamba_program.build(
            self.cfg, self.spec.seed, self.dev)
        self.prepare()
        for k in range(self.t["warmup"]):
            self.request(-1 - k)
        # the decode steps and the experts they read from here on
        self.counted = (cuda_graphs.REPLAYS,
                        int(moe.experts_read(self.dev)))

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
        sync = harness.synchronizer(self.dev)
        window, _ = harness.closed_loop(self.request, seconds, clock, sync)
        window.amount = window.units * self.t["batch"] * self.t["new_tokens"]
        profile = self.profiled(window.units, sync) if self.spec.trace \
            else None
        return window, profile

    def profiled(self, first, sync):
        """The profile of ``profiled_units`` requests after the window, as
        ``harness.closed_loop`` takes it; from the same profiler events, the
        device seconds of each replay of the decode graph
        (``replay_seconds``)."""
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
        self.replays = replay_seconds(events, cuda)
        return out

    def end_to_end(self, window):
        return {"lm_tokens_per_s": window.rate()}

    def layer_info(self):
        """Per request: the analytic FLOPs and K1's work; per decode step
        (on the card): the bytes it must move, with the distinct experts
        the served steps chose, and its device ms in the profiled
        requests."""
        t, cfg = self.t, self.cfg
        elem = jamba_program.DTYPES[cfg["dtype"]].itemsize
        info = {"flops_per_unit": jamba_program.request_flops(
                    cfg, t["batch"], t["prompt_len"], t["new_tokens"]),
                "k1_work": jamba_program.k1_work(cfg, t["batch"],
                                                 t["prompt_len"], elem)}
        if not self.dev.startswith("cuda"):
            return info
        from vivim_tpu_torch.nn import moe
        from vivim_tpu_torch.utils import cuda_graphs

        steps = cuda_graphs.REPLAYS - self.counted[0]
        read = int(moe.experts_read(self.dev)) - self.counted[1]
        info["bf16_peak"] = jamba_program.bf16_peak(
            torch.cuda.get_device_name(0))
        if steps:
            info["decode_bytes"] = jamba_program.decode_bytes(
                cfg, t["batch"], t["prompt_len"], t["new_tokens"],
                read / steps, elem)
        if getattr(self, "replays", None):
            info["decode_ms"] = 1e3 * sum(self.replays) / len(self.replays)
        return info

    def release(self):
        self.model = self.params = None

    def compare(self, kept, logits_of):
        """``kept``: {request: (the tokens read, the tokens served after
        the prompt, the logits that chose them)}; ``logits_of(tokens,
        positions)``: the reference's logits there."""
        lim = self.spec.limits
        if not kept:
            return [harness.Check("checked_requests", 0.0, -1.0)]
        p = self.t["prompt_len"]
        gap, per_token = 0.0, []
        with torch.no_grad():
            for i, (tokens, served, scores) in sorted(kept.items()):
                logits = logits_of(tokens[:, :-1].to(self.dev),
                                   list(range(p - 1, tokens.shape[1] - 1)))
                # (rows, served tokens): each token's largest logit gap
                per_token.append((scores.to(self.dev) - logits).abs()
                                 .amax(-1).cpu())
                chosen = logits.gather(-1, served.to(self.dev)[..., None])[
                    ..., 0]
                gap = max(gap, float((logits.max(-1).values - chosen).max()))
        per_row = torch.cat(per_token).double()
        rows = per_row.quantile(0.5, dim=1)
        q = torch.quantile(per_row.flatten(), torch.tensor(
            [0.5, 0.9, 0.99], dtype=torch.float64)).tolist()
        return [harness.Check("logit_err", float(per_row.max()),
                              lim["logit_err"]),
                harness.Check("logit_err_row_median", float(rows.max()),
                              lim["logit_err_row_median"],
                              "rows' medians %.4g to %.4g over %d rows; "
                              "all tokens' quantiles 0.5 / 0.9 / 0.99: %.4g "
                              "/ %.4g / %.4g over %d tokens"
                              % (float(rows.min()), float(rows.max()),
                                 len(rows), *q, per_row.numel())),
                harness.Check("token_gap", gap, lim["token_gap"])]

    def reference(self, rnd=None):
        """``logits_of`` of the plain reference (operands through ``rnd``),
        float32 with TF32 off, its weights drawn again from the seed."""
        weight = jamba_program.reference_weight(self.cfg, self.spec.seed,
                                                self.dev)

        def logits_of(tokens, positions):
            with harness.tf32(False):
                return ref.forward(self.cfg, weight, tokens, positions, rnd)
        return logits_of

    def check(self):
        return self.compare(self.kept, self.reference())

    def prepare(self):
        """The prompt pool and the sampled requests."""
        t = self.t
        self.prompts = [traffic.token_ids(self.spec.seed, i, t["batch"],
                                          t["prompt_len"],
                                          self.cfg["vocab_size"])
                        for i in range(t["pool"])]
        self.sample = set(traffic.sample(self.spec.seed, t["sample_within"],
                                         t["checked"]))

    def control(self):
        """The reference with float8 e4m3 matmul operands in the program's
        place, read at every position of each sampled prompt followed by
        seeded tokens: its logits, and the token it puts first."""
        t, kept = self.t, {}
        fp8 = self.reference(ref.fp8)
        for i in self.sample:
            more = traffic.token_ids(self.spec.seed, f"next{i}", t["batch"],
                                     t["new_tokens"], self.cfg["vocab_size"])
            tokens = torch.cat([self.prompt(i), more], 1)
            with torch.no_grad():
                scores = fp8(tokens[:, :-1].to(self.dev),
                             list(range(t["prompt_len"] - 1,
                                        tokens.shape[1] - 1)))
            kept[i] = (tokens, scores.argmax(-1).cpu(), scores)
        return self.compare(kept, self.reference())


def replay_seconds(events, cuda_type):
    """Device seconds of each CUDA-graph replay among kineto ``events``:
    from the first start to the last end of the kernels, copies and sets
    whose correlation id is that of a host ``cudaGraphLaunch`` (CUPTI gives
    a graph's device work its launch's id).  In a generation request the
    only graph replayed is the decode step's."""
    from perfbench import trace

    launches = {ev.correlation_id() for ev in events
                if ev.device_type() != cuda_type
                and ev.name().startswith("cudaGraphLaunch")}
    spans = {}
    for ev in events:
        cid = ev.correlation_id()
        if (ev.device_type() == cuda_type and cid in launches
                and trace.device_work(ev)):
            s, e = spans.get(cid, (ev.start_ns(), ev.end_ns()))
            spans[cid] = (min(s, ev.start_ns()), max(e, ev.end_ns()))
    return [(e - s) * 1e-9 for s, e in spans.values()]
