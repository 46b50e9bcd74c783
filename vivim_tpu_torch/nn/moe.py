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

from vivim_tpu_torch.nn import lm as lm_lib
from vivim_tpu_torch.nn import streaming
from vivim_tpu_torch.nn.mamba import MambaV3


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
