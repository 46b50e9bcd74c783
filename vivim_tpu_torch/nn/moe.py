"""Mixture-of-Experts FFN and the MoE-Mamba language model.

Port of the JAX package's ``nn/moe.py``: the GShard / Switch dense-dispatch
recipe, in which routing is one-hot dispatch and combine tensors and two
batched expert products, so every shape is static.

- ``moe_ffn(params, x, ...)``: top-k token-choice routing with a static
  per-expert capacity ``C = ceil(capacity_factor * T / E)``; a token over
  capacity gets no FFN output (its residual carries it); the kept tokens'
  outputs are gate-weighted; the Switch load-balance loss ``E * sum_e f_e
  P_e`` (Fedus et al. 2021, eq. 4-6) comes beside.
- ``SwitchFFN``: the module holding ``router_kernel`` (M, E), ``wi`` (E, M,
  F) and ``wo`` (E, F, M), under those names.
- ``MoEMambaLM``: the ``MambaLM`` block stack with a pre-norm MoE FFN block
  after every ``moe_every``-th mixer (Pioro et al. 2024); ``tokens (B, L)
  -> (logits (B, L, padded_vocab), aux_loss)``.  Its state_dict keeps the
  JAX names (the reference has no MoE): ``embedding``, ``norm_{i}``,
  ``mixer_{i}`` (a single-direction ``MambaV3``, the reference Mamba names
  inside), ``moe_norm_{i}``, ``moe_{i}`` and ``norm_f``; the head is tied.

- ``dropless_moe`` / ``dropless_moe_step``: the dropless top-k block of
  Mixtral and Jamba (transformers' ``JambaSparseMoeBlock``): a softmax over
  all experts in fp32, the top k probabilities as the gates, not
  renormalised, and every token computed by every expert it chose (no
  capacity, nothing dropped), each expert a SwiGLU MLP.  It is separate
  from the Switch block above and shares none of its dispatch.  The same
  functions run Granite 4.0-H's block (transformers'
  ``GraniteMoeHybridMoE`` and ``shared_mlp``): with ``renormalize`` the
  gates are a softmax over the top k router logits (so they sum to 1); the
  experts may be stacked, ``input_linear.weight`` (E, 2F, M) (gate rows,
  then up rows) and ``output_linear.weight`` (E, M, F); and a shared
  SwiGLU expert (``shared.input_linear.weight``, ``shared.
  output_linear.weight``) runs on every token and adds to the routed sum,
  in fp32.

The router runs in fp32 whatever the activations' dtype (logits, softmax,
the slot counts); slots are integers.  The expert GELU is the tanh
approximation, ``jax.nn.gelu``'s default (``F.gelu`` defaults to erf).
The experts run through ``torch.bmm``; the scan of every mixer is K1 on
the card, K1-training and K2 under autograd (``nn.streaming.
mamba_prefill``).  Expert parallelism is ``parallel/expert.py``.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from vivim_tpu_torch.kernels.moe_combine import moe_combine
from vivim_tpu_torch.nn import lm as lm_lib
from vivim_tpu_torch.nn import streaming
from vivim_tpu_torch.nn.mamba import MambaV3
from vivim_tpu_torch.nn.quant import matmul_t
from vivim_tpu_torch.utils.profiling import span


# the dropless block's device count.  EXPERTS_READ[device] () int64: the
# distinct experts chosen in each decode step, summed over steps and layers;
# a captured step adds to the tensor it was captured with, so each device's
# is made once (``experts_read``) and never replaced.
EXPERTS_READ = {}


def experts_read(device):
    """``device``'s ``EXPERTS_READ`` count, made on first use."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in EXPERTS_READ:
        EXPERTS_READ[dev] = torch.zeros((), dtype=torch.long, device=dev)
    return EXPERTS_READ[dev]


def swiglu(params, x, prefix=""):
    """``down(silu(gate(x)) * up(x))`` of ``{prefix}{gate,up,down}_proj.
    weight`` (transformers' ``JambaMLP``, hidden_act silu)."""
    g = matmul_t(x, params[f"{prefix}gate_proj.weight"])
    u = matmul_t(x, params[f"{prefix}up_proj.weight"])
    return matmul_t(F.silu(g) * u, params[f"{prefix}down_proj.weight"])


def _route(params, xt, top_k):
    """fp32 softmax over every expert, then the top k: (gates (T, k) fp32,
    experts (T, k) int64)."""
    logits = xt.float() @ params["router.weight"].float().t()
    return torch.topk(torch.softmax(logits, -1), top_k, dim=-1)


def _route_renormalised(params, xt, top_k):
    """The top k of the fp32 router logits, then a softmax over those k
    (``GraniteMoeHybridTopKGating``): (gates (T, k) fp32 summing to 1,
    experts (T, k) int64)."""
    logits = xt.float() @ params["router.weight"].float().t()
    top, experts = torch.topk(logits, top_k, dim=-1)
    return torch.softmax(top, -1), experts


def glu(x, w_in, w_out):
    """``w_out`` of silu(first half) * second half of ``w_in`` x: a stacked
    expert's or the shared expert's SwiGLU (``GraniteMoeHybridMLP``)."""
    g, u = matmul_t(x, w_in).chunk(2, -1)
    return matmul_t(F.silu(g) * u, w_out)


def _expert(params, x, e):
    """Expert ``e``'s SwiGLU of x (T, M)."""
    if "input_linear.weight" in params:
        return glu(x, params["input_linear.weight"][e],
                   params["output_linear.weight"][e])
    return swiglu(params, x, f"experts.{e}.")


def _shared(params, x):
    """The shared expert's output of x, or None where there is none."""
    if "shared.input_linear.weight" not in params:
        return None
    return glu(x, params["shared.input_linear.weight"],
               params["shared.output_linear.weight"])


def _add_shared(params, x, out):
    """``out`` (fp32) plus the shared expert of x, where there is one."""
    shared = _shared(params, x)
    if shared is not None:
        out += shared.float()
    return out


def dropless_moe(params, x, top_k: int, renormalize: bool = False):
    """The dropless top-k block over a whole sequence: x (..., M) -> (...,
    M).  ``params``: ``router.weight`` (E, M) and ``experts.{e}.
    {gate,up,down}_proj.weight`` or the stacked experts, and the shared
    expert where there is one.  The tokens are sorted by expert and each
    expert runs once on its own (the group sizes are read on the host, so
    this runs eagerly, in the span ``lm.moe``); the gated outputs, and the
    shared expert's, are summed per token in fp32 by ``kernels.moe_combine``
    (one kernel on the card)."""
    with span("lm.moe"):
        M = x.shape[-1]
        xt = x.reshape(-1, M)
        route = _route_renormalised if renormalize else _route
        gates, experts = route(params, xt, top_k)
        E = params["router.weight"].shape[0]
        flat = experts.reshape(-1)
        counts = torch.bincount(flat, minlength=E)
        order = torch.argsort(flat, stable=True)
        rows = order // top_k                   # the token of each choice
        # the sorted row of each choice: the inverse of the sort
        pos = torch.empty_like(flat, dtype=torch.int32)
        pos[order] = torch.arange(flat.numel(), dtype=torch.int32,
                                  device=x.device)
        xs = xt[rows]
        ys = torch.empty_like(xs)
        start = 0
        for e, n in enumerate(counts.tolist()):
            if n:
                ys[start:start + n] = _expert(params, xs[start:start + n], e)
            start += n
        del xs
        out = moe_combine(ys, pos.view(experts.shape), gates.contiguous(),
                          _shared(params, xt))
        return out.reshape(x.shape)


def dropless_moe_step(params, x, top_k: int, renormalize: bool = False):
    """The same block with static shapes, for a decode step a CUDA graph
    captures: x (B, M) -> (B, M).  Every expert runs on every token and its
    output is weighted by the token's gate for it, 0 where the token did
    not choose it: the same sum as ``dropless_moe``, with no host read.
    Stacked experts run as two batched products over all of them.  The
    step's distinct chosen experts are added to the device's
    ``EXPERTS_READ``."""
    route = _route_renormalised if renormalize else _route
    gates, experts = route(params, x, top_k)
    E = params["router.weight"].shape[0]
    weight = torch.zeros(x.shape[0], E, dtype=torch.float32,
                         device=x.device).scatter_(1, experts, gates)
    chosen = torch.zeros(E, dtype=torch.bool, device=x.device)
    experts_read(x.device).add_(
        chosen.scatter_(0, experts.reshape(-1), True).sum())
    if "input_linear.weight" in params:
        # (E, B, 2F), then (E, B, M): every expert on every row at once
        g, u = torch.matmul(
            x, params["input_linear.weight"].transpose(1, 2)).chunk(2, -1)
        y = torch.matmul(F.silu(g) * u,
                         params["output_linear.weight"].transpose(1, 2))
        out = torch.einsum("ebm,be->bm", y.float(), weight)
    else:
        out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        for e in range(E):
            out.addcmul_(swiglu(params, x, f"experts.{e}."),
                         weight[:, e, None])
    return _add_shared(params, x, out).to(x.dtype)


def moe_capacity(n_tokens: int, n_experts: int,
                 capacity_factor: float) -> int:
    """Static per-expert token capacity (Switch eq. 3)."""
    return max(1, math.ceil(capacity_factor * n_tokens / n_experts))


def moe_dispatch(router_probs, capacity: int, top_k: int = 1):
    """Token-choice top-k routing with per-expert capacity.

    ``router_probs`` (T, E) softmax probabilities.  Returns ``(dispatch,
    combine, aux_loss)``:

    - ``dispatch`` (T, E, C) one-hot: token t occupies slot c of expert e
      (zero where the token was dropped for capacity, or e not chosen);
    - ``combine`` (T, E, C): dispatch weighted by the token's gate for that
      expert, renormalised over the experts that kept it when ``top_k > 1``
      (GShard top-2); the raw Switch gate at ``top_k = 1``;
    - ``aux_loss``: the Switch load-balance loss of round 1's assignment,
      ``E * sum_e f_e P_e``, differentiable through P_e only.

    Slots fill in token order and continue across the k rounds (round 1's
    assignments take their slots before round 2's).
    """
    T, E = router_probs.shape
    dtype, dev = router_probs.dtype, router_probs.device
    masked = router_probs
    fill = torch.zeros(E, dtype=torch.long, device=dev)  # slots taken
    slots = torch.arange(capacity, device=dev)
    dispatch = router_probs.new_zeros(T, E, capacity)
    gates = router_probs.new_zeros(T, E)
    aux_loss = router_probs.new_zeros(())
    for k in range(top_k):
        choice = masked.argmax(-1)                          # (T,)
        oh_i = F.one_hot(choice, E)                         # (T, E) int
        oh = oh_i.to(dtype)
        if k == 0:
            # fraction routed to e (top-1, no gradient) x mean probability
            aux_loss = E * (oh.mean(0) * router_probs.mean(0)).sum()
        # each token's slot in its chosen expert, after the slots that
        # earlier tokens and earlier rounds took
        pos = (torch.cumsum(oh_i, 0) - oh_i + fill[None, :]) * oh_i
        pos_t = pos.sum(-1)                                 # (T,)
        keep_i = (pos_t < capacity).long()
        keep = keep_i.to(dtype)
        slot = (pos_t[:, None] == slots).to(dtype)          # (T, C)
        dispatch = dispatch + (oh * keep[:, None])[:, :, None] \
            * slot[:, None, :]
        gates = gates + oh * keep[:, None] * router_probs
        fill = fill + (oh_i * keep_i[:, None]).sum(0)
        masked = masked * (1.0 - oh)                        # next-best
    if top_k > 1:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return dispatch, dispatch * gates[:, :, None], aux_loss


def expert_ffn(wi, wo, x):
    """Per-expert GELU MLP on stacked weights: (E, C, M) -> (E, C, M).

    ``wi`` (E, M, F), ``wo`` (E, F, M), cast to ``x``'s dtype.  The only
    part of the MoE whose FLOPs and weights scale with E: the expert-
    parallel hook (``parallel/expert.py``) runs it on a rank's experts.
    """
    h = F.gelu(torch.bmm(x, wi.to(x.dtype)), approximate="tanh")
    return torch.bmm(h, wo.to(x.dtype))


def moe_ffn(params, x, *, capacity_factor: float = 1.25, top_k: int = 1,
            expert_apply=None):
    """Functional MoE FFN: x (..., M) -> (y (..., M), aux_loss fp32).

    ``params``: ``{"router_kernel": (M, E), "wi": (E, M, F), "wo": (E, F,
    M)}``.  ``expert_apply(wi, wo, expert_in)`` replaces the stacked
    experts' execution (``expert_ffn`` by default): the hook the expert-
    parallel FFN runs its experts through.  The dispatch and combine
    tensors are cast to ``x``'s dtype before their products.
    """
    expert_apply = expert_apply or expert_ffn
    M = x.shape[-1]
    lead = x.shape[:-1]
    xt = x.reshape(-1, M)
    T = xt.shape[0]
    E = params["router_kernel"].shape[1]
    probs = torch.softmax(xt.float() @ params["router_kernel"].float(), -1)
    dispatch, combine, aux = moe_dispatch(
        probs, moe_capacity(T, E, capacity_factor), top_k=top_k)
    dispatch, combine = dispatch.to(x.dtype), combine.to(x.dtype)
    expert_in = torch.einsum("tec,tm->ecm", dispatch, xt)
    expert_out = expert_apply(params["wi"], params["wo"], expert_in)
    yt = torch.einsum("tec,ecm->tm", combine, expert_out)
    return yt.reshape(*lead, M), aux.float()


class SwitchFFN(nn.Module):
    """MoE FFN block: ``x -> (y, aux_loss)``; parameters as ``moe_ffn``
    names them, each ~ N(0, 0.02) (``init_parameters``)."""

    def __init__(self, d_model: int, n_experts: int, d_ff: int,
                 capacity_factor: float = 1.25, top_k: int = 1):
        super().__init__()
        self.capacity_factor, self.top_k = capacity_factor, top_k
        self.router_kernel = nn.Parameter(torch.empty(d_model, n_experts))
        self.wi = nn.Parameter(torch.empty(n_experts, d_model, d_ff))
        self.wo = nn.Parameter(torch.empty(n_experts, d_ff, d_model))

    @torch.no_grad()
    def init_parameters(self, gen):
        for p in (self.router_kernel, self.wi, self.wo):
            nn.init.normal_(p, std=0.02, generator=gen)

    def forward(self, x):
        return moe_ffn(dict(self.named_parameters()), x,
                       capacity_factor=self.capacity_factor,
                       top_k=self.top_k)


@dataclasses.dataclass(frozen=True)
class MoEMambaLMConfig:
    vocab_size: int
    d_model: int = 768
    n_layer: int = 24
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    pad_vocab_multiple: int = 8
    initializer_range: float = 0.02
    rms_norm: bool = False
    norm_epsilon: float = 1e-5
    # an MoE FFN block after every moe_every-th mixer (1: after each; 0:
    # none, the plain MambaLM stack)
    moe_every: int = 1
    n_experts: int = 8
    d_ff: int | None = None  # 4 * d_model when None
    capacity_factor: float = 1.25
    top_k: int = 1
    aux_loss_weight: float = 1e-2

    @property
    def padded_vocab(self):
        m = self.pad_vocab_multiple
        return ((self.vocab_size + m - 1) // m) * m

    def has_moe(self, i: int) -> bool:
        """Whether an MoE block follows mixer ``i``."""
        return bool(self.moe_every) and (i + 1) % self.moe_every == 0


class MoEMambaLM(nn.Module):
    """MoE-Mamba: ``tokens (B, L) -> (logits (B, L, padded_vocab),
    aux_loss)``, ``aux_loss`` the Switch load-balance losses of every MoE
    block summed (add ``cfg.aux_loss_weight * aux`` to the training
    loss).  The forward is ``moe_lm_forward`` over the module's own
    parameters."""

    def __init__(self, cfg: MoEMambaLMConfig,
                 scan_implementation: str | None = None):
        super().__init__()
        self.cfg = cfg
        self.scan_implementation = scan_implementation
        self.embedding = nn.Parameter(torch.empty(cfg.padded_vocab,
                                                  cfg.d_model))
        norm = functools.partial(lm_lib.Norm, cfg.d_model, cfg.norm_epsilon,
                                 cfg.rms_norm)
        for i in range(cfg.n_layer):
            setattr(self, f"norm_{i}", norm())
            setattr(self, f"mixer_{i}", MambaV3(
                cfg.d_model, d_state=cfg.d_state, d_conv=cfg.d_conv,
                expand=cfg.expand, bimamba_type="none",
                scan_implementation=scan_implementation))
            if cfg.has_moe(i):
                setattr(self, f"moe_norm_{i}", norm())
                setattr(self, f"moe_{i}", SwitchFFN(
                    cfg.d_model, cfg.n_experts, cfg.d_ff or 4 * cfg.d_model,
                    cfg.capacity_factor, cfg.top_k))
        self.norm_f = norm()

    @torch.no_grad()
    def init_parameters(self, gen):
        """The embedding (and so the tied head) ~ N(0, initializer_range);
        ``nn.layers.init_weights`` gives the rest their schemes."""
        nn.init.normal_(self.embedding, std=self.cfg.initializer_range,
                        generator=gen)

    def forward(self, tokens):
        return moe_lm_forward(self.cfg, dict(self.named_parameters()),
                              tokens, self.scan_implementation)


def moe_lm_forward(cfg: MoEMambaLMConfig, params, tokens,
                   implementation=None, moe_fn=None):
    """``MoEMambaLM``'s forward from a flat parameter dict under its names:
    (logits (B, L, padded_vocab), aux_loss fp32).  Each mixer runs through
    ``nn.streaming.mamba_prefill`` (K1; K1-training and K2 under
    autograd), each MoE block through ``moe_fn(block params, x) -> (y,
    aux)`` (``moe_ffn`` at the config's capacity factor and top-k when
    None; the hook the expert-parallel forward uses).  The residual stays
    in the embedding's dtype."""
    lm_lib.check_kernel_config(cfg, tokens.device, implementation)
    moe_fn = moe_fn or functools.partial(
        moe_ffn, capacity_factor=cfg.capacity_factor, top_k=cfg.top_k)
    norm = lm_lib.norm_fn_for(cfg)
    sub = {}  # the dict split once by module: {"mixer_0": {leaf: ...}, ...}
    for name, v in params.items():
        module, _, leaf = name.partition(".")
        sub.setdefault(module, {})[leaf] = v
    emb = params["embedding"]
    h = emb[tokens]
    dtype = h.dtype
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(cfg.n_layer):
        out, _, _ = streaming.mamba_prefill(
            sub[f"mixer_{i}"], norm(sub[f"norm_{i}"], h).to(dtype),
            implementation)
        h = h + out.to(h.dtype)
        if cfg.has_moe(i):
            y, aux = moe_fn(sub[f"moe_{i}"],
                            norm(sub[f"moe_norm_{i}"], h).to(dtype))
            h = h + y.to(h.dtype)
            aux_total = aux_total + aux
    h = norm(sub["norm_f"], h).to(dtype)
    return h @ emb.t(), aux_total


def init_moe_lm(cfg: MoEMambaLMConfig, seed: int = 0, device="cuda",
                scan_implementation: str | None = None) -> MoEMambaLM:
    """A ``MoEMambaLM`` built on ``device`` (the card unless asked for the
    CPU; ``device="cuda"`` without one raises) and seeded there from a
    ``torch.Generator`` of that device: no weight passes through the
    host."""
    from vivim_tpu_torch.cli.common import resolve_device
    from vivim_tpu_torch.nn.layers import init_weights

    dev = resolve_device(device)
    with torch.device(dev):
        model = MoEMambaLM(cfg, scan_implementation)
    return init_weights(model, torch.Generator(dev).manual_seed(seed))
