"""Granite 4.0-H: IBM's hybrid LM of Mamba-2 layers, NoPE grouped-query
attention layers and fine-grained mixture-of-experts feed-forwards with a
shared expert, on the LM's serving path.

Port of transformers' ``GraniteMoeHybridForCausalLM``
(models/granitemoehybrid/modeling_granitemoehybrid.py, ``model_type``
``granitemoehybrid``: granite-4.0-h-small and -tiny; -micro's dense layers,
with no routed experts, are refused):

- ``GraniteHybridConfig`` and ``config_from_granite_json``: the keys of its
  ``config.json``; layer i is a Mamba-2 layer or an attention layer as
  ``layer_types[i]`` says.
- ``GraniteHybridLM``: embedding (times ``embedding_multiplier``) -> n x
  [RMSNorm, mixer, residual add of the mixer's output times
  ``residual_multiplier``, RMSNorm, the routed experts plus the shared
  expert, residual add likewise] -> final RMSNorm -> head (tied to the
  embedding unless ``tie_word_embeddings`` is false), the logits over
  ``logits_scaling``.  Attention scores are scaled by
  ``attention_multiplier``, with no positional encoding (``nope``).  Its
  state_dict keys are transformers' (``model.embed_tokens.weight``,
  ``model.layers.{i}.input_layernorm.weight``, ``model.layers.{i}.mamba.
  {in_proj.weight, conv1d.weight, conv1d.bias, dt_bias, A_log, D,
  norm.weight, out_proj.weight}``, ``model.layers.{i}.self_attn.
  {q,k,v,o}_proj.weight``, ``model.layers.{i}.post_attention_layernorm.
  weight``, ``model.layers.{i}.block_sparse_moe.{input_linear.weight (E, 2F,
  M), output_linear.weight (E, M, F), router.layer.weight}``,
  ``model.layers.{i}.shared_mlp.{input_linear,output_linear}.weight``,
  ``model.norm.weight``, ``lm_head.weight``), so a checkpoint's tensors load
  into it strictly (``load_granite``).

The model runs through ``nn/lm.py``'s functions, as Jamba does:
``split_params`` makes each Mamba-2 layer a ``streaming.Mamba2`` (its
per-channel constants built there, once per split) and each feed-forward
the dropless block of ``nn/moe.py`` with renormalised top-k gates, the
stacked experts and the shared expert; ``lm.generate`` runs the eager
prefill (K1 per Mamba-2 layer, SDPA, the MoE) and one replayed
``lm.DecodeGraph`` a token holding the Mamba-2 states beside the K/V cache.
As transformers computes it: the residual stream in the weights' dtype,
each RMSNorm in fp32 and back (times its weight), the Mamba-2 gated norm
in fp32, the attention's and the router's softmax in fp32, the ssm state in
fp32, the logits returned in fp32.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os

import torch
from torch import nn

from vivim_tpu_torch.nn import lm as lm_lib
from vivim_tpu_torch.nn import moe, quant, streaming
from vivim_tpu_torch.nn.jamba import Attention, RMSNorm, read_checkpoint, rms_norm

KINDS = ("mamba", "attention")


@dataclasses.dataclass(frozen=True)
class GraniteHybridConfig:
    vocab_size: int = 100352
    hidden_size: int = 4096
    intermediate_size: int = 768          # a routed expert's width
    shared_intermediate_size: int = 1536
    num_hidden_layers: int = 40
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    layer_types: tuple = ()
    num_local_experts: int = 72
    num_experts_per_tok: int = 10
    mamba_n_heads: int = 128
    mamba_d_head: int = 64
    mamba_n_groups: int = 1
    mamba_d_state: int = 128
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_conv_bias: bool = True
    mamba_proj_bias: bool = False
    attention_multiplier: float = 1.0
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = True
    initializer_range: float = 0.02

    @property
    def d_state(self):   # what lm.check_kernel_config reads
        return self.mamba_d_state

    @property
    def d_inner(self):
        return self.mamba_expand * self.hidden_size

    @property
    def conv_dim(self):
        return self.d_inner + 2 * self.mamba_n_groups * self.mamba_d_state

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def config_from_granite_json(d: dict, **overrides) -> GraniteHybridConfig:
    """``GraniteHybridConfig`` from a ``granitemoehybrid`` ``config.json``
    dict; ``overrides`` cut it (``num_hidden_layers=10``: the first 10
    layers, ``layer_types`` cut with them).  Raises for what the port does
    not run: another activation than silu, rotary positions, attention
    biases, a layer kind other than mamba / attention, Mamba-2 groups that
    split a head, no routed experts."""
    if d.get("hidden_act", "silu") != "silu":
        raise ValueError(f"hidden_act {d['hidden_act']!r}: Granite's MLPs "
                         "are SwiGLU (silu)")
    if d.get("position_embedding_type") not in (None, "nope"):
        raise ValueError(f"position_embedding_type "
                         f"{d['position_embedding_type']!r}: the port's "
                         "attention has no positional encoding")
    if d.get("attention_bias", False):
        raise ValueError("attention biases are not supported")
    if not d.get("num_local_experts"):
        raise ValueError("no routed experts: the port runs Granite's MoE "
                         "layers, not its dense (shared MLP only) ones")
    hidden = d["hidden_size"]
    d_inner = d.get("mamba_expand", 2) * hidden
    heads = d.get("mamba_n_heads", 128)
    head = d.get("mamba_d_head", "auto")
    head = d_inner // heads if head == "auto" else head
    kw = dict(
        vocab_size=d["vocab_size"], hidden_size=hidden,
        intermediate_size=d["intermediate_size"],
        shared_intermediate_size=d["shared_intermediate_size"],
        num_hidden_layers=d["num_hidden_layers"],
        num_attention_heads=d["num_attention_heads"],
        num_key_value_heads=d.get("num_key_value_heads")
        or d["num_attention_heads"],
        layer_types=tuple(d.get("layer_types")
                          or ["mamba"] * d["num_hidden_layers"]),
        num_local_experts=d["num_local_experts"],
        num_experts_per_tok=d.get("num_experts_per_tok", 1),
        mamba_n_heads=heads, mamba_d_head=head,
        mamba_n_groups=d.get("mamba_n_groups", 1),
        mamba_d_state=d.get("mamba_d_state", 256),
        mamba_d_conv=d.get("mamba_d_conv", 4),
        mamba_expand=d.get("mamba_expand", 2),
        mamba_conv_bias=d.get("mamba_conv_bias", True),
        mamba_proj_bias=d.get("mamba_proj_bias", False),
        attention_multiplier=d.get("attention_multiplier", 1.0),
        embedding_multiplier=d.get("embedding_multiplier", 1.0),
        residual_multiplier=d.get("residual_multiplier", 1.0),
        logits_scaling=d.get("logits_scaling", 1.0),
        rms_norm_eps=d.get("rms_norm_eps", 1e-6),
        tie_word_embeddings=d.get("tie_word_embeddings", False),
        initializer_range=d.get("initializer_range", 0.02),
    )
    kw.update(overrides)
    n = kw["num_hidden_layers"]
    if len(kw["layer_types"]) < n:
        raise ValueError(f"layer_types names {len(kw['layer_types'])} "
                         f"layers of {n}")
    kw["layer_types"] = tuple(kw["layer_types"][:n])
    bad = set(kw["layer_types"]) - set(KINDS)
    if bad:
        raise ValueError(f"layer types {sorted(bad)}: the port runs "
                         f"{' and '.join(KINDS)} layers")
    cfg = GraniteHybridConfig(**kw)
    groups = cfg.mamba_n_groups
    if (cfg.mamba_n_heads * cfg.mamba_d_head != cfg.d_inner
            or cfg.d_inner % groups or (cfg.d_inner // groups)
            % cfg.mamba_d_head):
        raise ValueError(f"{cfg.mamba_n_heads} Mamba-2 heads of "
                         f"{cfg.mamba_d_head} in {groups} groups do not "
                         f"tile d_inner {cfg.d_inner} by whole heads")
    return cfg


class MambaMixer(nn.Module):
    """transformers' ``GraniteMoeHybridMambaLayer``'s parameters (the
    forward is ``nn/streaming.py``'s Mamba-2 mixer)."""

    def __init__(self, cfg: GraniteHybridConfig):
        super().__init__()
        d, cd, h = cfg.d_inner, cfg.conv_dim, cfg.mamba_n_heads
        self.in_proj = nn.Linear(cfg.hidden_size, d + cd + h,
                                 bias=cfg.mamba_proj_bias)
        self.conv1d = nn.Conv1d(cd, cd, cfg.mamba_d_conv, groups=cd,
                                padding=cfg.mamba_d_conv - 1,
                                bias=cfg.mamba_conv_bias)
        self.dt_bias = nn.Parameter(torch.ones(h))
        self.A_log = nn.Parameter(torch.zeros(h))
        self.norm = RMSNorm(d, cfg.rms_norm_eps)
        self.D = nn.Parameter(torch.ones(h))
        self.out_proj = nn.Linear(d, cfg.hidden_size,
                                  bias=cfg.mamba_proj_bias)


class ParallelExperts(nn.Module):
    """Stacked expert weights (E, out, in), ``weight``."""

    def __init__(self, n, d_in, d_out):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, d_out, d_in))


class MoE(nn.Module):
    def __init__(self, cfg: GraniteHybridConfig):
        super().__init__()
        m, f, e = cfg.hidden_size, cfg.intermediate_size, cfg.num_local_experts
        self.input_linear = ParallelExperts(e, m, 2 * f)
        self.output_linear = ParallelExperts(e, f, m)
        self.router = nn.Module()
        self.router.layer = nn.Linear(m, e, bias=False)


class SharedMLP(nn.Module):
    def __init__(self, cfg: GraniteHybridConfig):
        super().__init__()
        m, f = cfg.hidden_size, cfg.shared_intermediate_size
        self.input_linear = nn.Linear(m, 2 * f, bias=False)
        self.output_linear = nn.Linear(f, m, bias=False)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: GraniteHybridConfig, i: int):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        if cfg.layer_types[i] == "attention":
            self.self_attn = Attention(cfg)
        else:
            self.mamba = MambaMixer(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps)
        self.block_sparse_moe = MoE(cfg)
        self.shared_mlp = SharedMLP(cfg)


@torch.no_grad()
def init_modules(model, std, gen):
    """Linear, expert and embedding weights ~ N(0, std), biases 0, norms 1;
    the depthwise conv U(+-width^-0.5) (PyTorch's default, as mamba_ssm
    keeps it); each Mamba-2 mixer (a ``MambaMixer``) as mamba_ssm's
    ``Mamba2`` initialises it: A = U[1, 16] (``A_log`` its log), dt
    log-uniform in [1e-3, 0.1] (floored at 1e-4) through the inverse
    softplus into ``dt_bias``, ``D`` = 1."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Embedding, ParallelExperts)):
            nn.init.normal_(m.weight, std=std, generator=gen)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Conv1d):
            bound = m.weight.shape[-1] ** -0.5
            nn.init.uniform_(m.weight, -bound, bound, generator=gen)
            if m.bias is not None:
                nn.init.uniform_(m.bias, -bound, bound, generator=gen)
        elif isinstance(m, RMSNorm):
            m.weight.fill_(1.0)
        elif isinstance(m, MambaMixer):
            h = m.A_log.shape[0]
            u = lambda: torch.rand(h, generator=gen, device=m.A_log.device)
            m.A_log.copy_(torch.log(1 + 15 * u()))
            lo, hi = math.log(1e-3), math.log(0.1)
            dt = torch.exp(lo + (hi - lo) * u()).clamp(min=1e-4)
            m.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
            m.D.fill_(1.0)


class GraniteHybridLM(nn.Module):
    """tokens (B, L) -> logits (B, L, vocab) in fp32."""

    def __init__(self, cfg: GraniteHybridConfig, scan_implementation=None):
        super().__init__()
        self.cfg = cfg
        self.scan_implementation = scan_implementation
        self.model = nn.Module()
        self.model.embed_tokens = nn.Embedding(cfg.vocab_size,
                                               cfg.hidden_size)
        self.model.layers = nn.ModuleList(
            DecoderLayer(cfg, i) for i in range(cfg.num_hidden_layers))
        self.model.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)
        if cfg.tie_word_embeddings:
            self.lm_head.weight = self.model.embed_tokens.weight
        # generate's DecodeGraph
        self._decoding_cache = None

    def init_parameters(self, gen):
        """``init_modules`` at ``initializer_range``."""
        init_modules(self, self.cfg.initializer_range, gen)

    def split_params(self, params) -> lm_lib.LMParts:
        """A flat dict under this model's names as ``lm.LMParts``: what
        ``lm.prefill``, ``lm.decode_step`` and ``lm.generate`` read."""
        cfg, sub = self.cfg, lm_lib.sub_params
        layers = []
        for i, kind in enumerate(cfg.layer_types):
            pre = f"model.layers.{i}."
            if kind == "attention":
                mixer = sub(params, pre + "self_attn.")
            else:
                mixer = streaming.mamba2(
                    sub(params, pre + "mamba."), cfg.mamba_n_groups,
                    cfg.mamba_d_state, cfg.rms_norm_eps)
            ff = {k.replace("router.layer.", "router."): v
                  for k, v in sub(params, pre + "block_sparse_moe.").items()}
            ff.update({"shared." + k: v
                       for k, v in sub(params, pre + "shared_mlp.").items()})
            kw = dict(top_k=cfg.num_experts_per_tok, renormalize=True)
            run = functools.partial(moe.dropless_moe, ff, **kw)
            step = functools.partial(moe.dropless_moe_step, ff, **kw)
            layers.append(lm_lib.Layer(
                mixer, sub(params, pre + "input_layernorm."),
                "attention" if kind == "attention" else "mamba2",
                sub(params, pre + "post_attention_layernorm."), run, step))
        return lm_lib.LMParts(
            emb=params["model.embed_tokens.weight"], layers=layers,
            norm_f=sub(params, "model.norm."),
            apply_norm=functools.partial(rms_norm, eps=cfg.rms_norm_eps),
            dtype=quant.compute_dtype(params), residual_in_fp32=False,
            implementation=self.scan_implementation,
            head=None if cfg.tie_word_embeddings
            else params["lm_head.weight"],
            n_heads=cfg.num_attention_heads,
            n_kv_heads=cfg.num_key_value_heads, logits_dtype=torch.float32,
            embedding_multiplier=cfg.embedding_multiplier,
            residual_multiplier=cfg.residual_multiplier,
            logits_scaling=cfg.logits_scaling,
            attn_scale=cfg.attention_multiplier)

    def forward(self, tokens):
        lm_lib.check_kernel_config(self.cfg, tokens.device,
                                   self.scan_implementation)
        return lm_lib.forward_parts(self.split_params(lm_lib.lm_params(self)),
                                    tokens)


def load_granite(hf_dir, device="cuda", dtype=torch.float32, seed=0,
                 **overrides):
    """(GraniteHybridLM in eval mode on ``device`` in ``dtype``, its
    ``lm.lm_params`` dict) from a local snapshot directory: its
    ``config.json`` (``overrides`` cut it, e.g. ``num_hidden_layers=10``)
    and, where the directory holds them (sharded safetensors and their
    index), its weights, loaded strictly (a tied head from the embedding; a
    layer cut keeps the layers it holds); else the init of
    ``GraniteHybridLM.init_parameters`` from ``seed``.  The model is made on
    the meta device and placed once: no copy of it passes through the
    host."""
    from vivim_tpu_torch.cli.common import resolve_device

    with open(os.path.join(hf_dir, "config.json")) as f:
        cfg = config_from_granite_json(json.load(f), **overrides)
    lm_lib.check_kernel_config(cfg, device)
    dev = resolve_device(device)
    with torch.device("meta"):
        model = GraniteHybridLM(cfg)
    model = model.to(dtype).to_empty(device=dev)
    if cfg.tie_word_embeddings:   # to_empty gives each its own storage
        model.lm_head.weight = model.model.embed_tokens.weight
    sd = read_checkpoint(hf_dir, list(model.state_dict()))
    if sd is None:
        model.init_parameters(torch.Generator(dev).manual_seed(seed))
    else:
        if cfg.tie_word_embeddings:   # a tied head is saved once
            sd.setdefault("lm_head.weight", sd["model.embed_tokens.weight"])
        model.load_state_dict(sd, strict=True)
    return model.eval(), lm_lib.lm_params(model)
