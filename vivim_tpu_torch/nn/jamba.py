"""Jamba: AI21's hybrid LM of Mamba layers, grouped-query attention layers
and dropless mixture-of-experts feed-forwards, on the LM's serving path.

Port of transformers' ``JambaForCausalLM`` (models/jamba/modeling_jamba.py,
the architecture of AI21-Jamba 1.5 / 1.6 / 1.7 and Jamba2):

- ``JambaConfig`` and ``config_from_jamba_json``: the keys of Jamba's
  ``config.json``.  Layer i is attention where ``i % attn_layer_period ==
  attn_layer_offset`` and a Mamba layer otherwise; its feed-forward is the
  MoE block where ``i % expert_layer_period == expert_layer_offset`` and a
  SwiGLU MLP otherwise (transformers' ``layers_block_type`` /
  ``layers_num_experts``).
- ``JambaLM``: embedding -> n x [RMSNorm, mixer, residual, RMSNorm,
  feed-forward, residual] -> final RMSNorm -> head (untied unless
  ``tie_word_embeddings``).  Its state_dict keys are transformers' (``model.
  embed_tokens.weight``, ``model.layers.{i}.input_layernorm.weight``,
  ``model.layers.{i}.mamba.*`` with ``dt_layernorm`` / ``b_layernorm`` /
  ``c_layernorm``, ``model.layers.{i}.self_attn.{q,k,v,o}_proj.weight``,
  ``model.layers.{i}.pre_ff_layernorm.weight``, ``model.layers.{i}.
  feed_forward.{gate,up,down}_proj.weight`` or ``feed_forward.router.
  weight`` and ``feed_forward.experts.{e}.{gate,up,down}_proj.weight``,
  ``model.final_layernorm.weight``, ``lm_head.weight``), so a checkpoint's
  tensors load into it strictly (``load_jamba``).

The model runs through ``nn/lm.py``'s functions: ``JambaLM.split_params``
splits a flat dict (``lm.lm_params``) into ``lm.Layer``s, and
``lm.generate(model, params, tokens, ...)`` serves it as it serves the
Mamba LM: an eager prefill (K1 for each Mamba layer, SDPA for each
attention layer, the dropless MoE block eagerly), then one replayed
``lm.DecodeGraph`` per token holding the Mamba layers' conv and ssm states
beside the attention layers' K/V caches.  As transformers computes it: the
residual stream in the weights' dtype, each RMSNorm in fp32 and back
(times its weight), the attention's and the router's softmax in fp32, the
ssm state in fp32; the logits are returned in fp32.
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
from vivim_tpu_torch.nn import moe, quant


@dataclasses.dataclass(frozen=True)
class JambaConfig:
    vocab_size: int = 65536
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    attn_layer_period: int = 8
    attn_layer_offset: int = 4
    expert_layer_period: int = 2
    expert_layer_offset: int = 1
    num_experts: int = 16
    num_experts_per_tok: int = 2
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 256
    mamba_conv_bias: bool = True
    mamba_proj_bias: bool = False
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = False
    initializer_range: float = 0.02

    @property
    def d_state(self):   # what lm.check_kernel_config reads
        return self.mamba_d_state

    @property
    def d_inner(self):
        return self.mamba_expand * self.hidden_size

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    def is_attention(self, i: int) -> bool:
        return i % self.attn_layer_period == self.attn_layer_offset

    def has_experts(self, i: int) -> bool:
        return (self.num_experts > 1
                and i % self.expert_layer_period == self.expert_layer_offset)

    def moe_layers(self):
        """The indices of the layers whose feed-forward is the MoE block."""
        return [i for i in range(self.num_hidden_layers)
                if self.has_experts(i)]


def config_from_jamba_json(d: dict, **overrides) -> JambaConfig:
    """``JambaConfig`` from a Jamba ``config.json`` dict (transformers'
    ``JambaConfig`` keys); ``overrides`` cut it (``num_hidden_layers=8``:
    the first 8 layers, a pipeline stage).  Raises for what the port does
    not run: another activation than silu, a sliding window."""
    if d.get("hidden_act", "silu") != "silu":
        raise ValueError(f"hidden_act {d['hidden_act']!r}: Jamba's MLPs "
                         "are SwiGLU (silu)")
    if d.get("sliding_window") is not None:
        raise ValueError("a sliding attention window is not supported")
    hidden = d["hidden_size"]
    rank = d.get("mamba_dt_rank", "auto")
    kw = dict(
        vocab_size=d["vocab_size"], hidden_size=hidden,
        intermediate_size=d["intermediate_size"],
        num_hidden_layers=d["num_hidden_layers"],
        num_attention_heads=d["num_attention_heads"],
        num_key_value_heads=d["num_key_value_heads"],
        attn_layer_period=d["attn_layer_period"],
        attn_layer_offset=d["attn_layer_offset"],
        expert_layer_period=d["expert_layer_period"],
        expert_layer_offset=d["expert_layer_offset"],
        num_experts=d["num_experts"],
        num_experts_per_tok=d["num_experts_per_tok"],
        mamba_d_state=d["mamba_d_state"], mamba_d_conv=d["mamba_d_conv"],
        mamba_expand=d["mamba_expand"],
        mamba_dt_rank=math.ceil(hidden / 16) if rank == "auto" else rank,
        mamba_conv_bias=d.get("mamba_conv_bias", True),
        mamba_proj_bias=d.get("mamba_proj_bias", False),
        rms_norm_eps=d.get("rms_norm_eps", 1e-6),
        tie_word_embeddings=d.get("tie_word_embeddings", False),
        initializer_range=d.get("initializer_range", 0.02),
    )
    kw.update(overrides)
    return JambaConfig(**kw)


def rms_norm(np_, h, eps=1e-6):
    """transformers' ``JambaRMSNorm``: in fp32, back in ``h``'s dtype, times
    the weight."""
    f = h.float()
    f = f * torch.rsqrt((f * f).mean(-1, keepdim=True) + eps)
    return np_["weight"] * f.to(h.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim, eps):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, h):
        return rms_norm({"weight": self.weight}, h, self.eps)


class MambaMixer(nn.Module):
    """transformers' ``JambaMambaMixer``'s parameters (the forward is
    ``nn/streaming.py``'s)."""

    def __init__(self, cfg: JambaConfig):
        super().__init__()
        d, n, r = cfg.d_inner, cfg.mamba_d_state, cfg.mamba_dt_rank
        self.in_proj = nn.Linear(cfg.hidden_size, 2 * d,
                                 bias=cfg.mamba_proj_bias)
        self.conv1d = nn.Conv1d(d, d, cfg.mamba_d_conv, groups=d,
                                padding=cfg.mamba_d_conv - 1,
                                bias=cfg.mamba_conv_bias)
        self.x_proj = nn.Linear(d, r + 2 * n, bias=False)
        self.dt_proj = nn.Linear(r, d, bias=True)
        self.A_log = nn.Parameter(torch.empty(d, n))
        self.D = nn.Parameter(torch.empty(d))
        self.out_proj = nn.Linear(d, cfg.hidden_size,
                                  bias=cfg.mamba_proj_bias)
        self.dt_layernorm = RMSNorm(r, cfg.rms_norm_eps)
        self.b_layernorm = RMSNorm(n, cfg.rms_norm_eps)
        self.c_layernorm = RMSNorm(n, cfg.rms_norm_eps)


class Attention(nn.Module):
    def __init__(self, cfg: JambaConfig):
        super().__init__()
        m, kv = cfg.hidden_size, cfg.num_key_value_heads * cfg.head_dim
        self.q_proj = nn.Linear(m, m, bias=False)
        self.k_proj = nn.Linear(m, kv, bias=False)
        self.v_proj = nn.Linear(m, kv, bias=False)
        self.o_proj = nn.Linear(m, m, bias=False)


class MLP(nn.Module):
    def __init__(self, cfg: JambaConfig):
        super().__init__()
        m, f = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Linear(m, f, bias=False)
        self.up_proj = nn.Linear(m, f, bias=False)
        self.down_proj = nn.Linear(f, m, bias=False)


class SparseMoe(nn.Module):
    def __init__(self, cfg: JambaConfig):
        super().__init__()
        self.router = nn.Linear(cfg.hidden_size, cfg.num_experts, bias=False)
        self.experts = nn.ModuleList(MLP(cfg)
                                     for _ in range(cfg.num_experts))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: JambaConfig, i: int):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        if cfg.is_attention(i):
            self.self_attn = Attention(cfg)
        else:
            self.mamba = MambaMixer(cfg)
        self.pre_ff_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.feed_forward = SparseMoe(cfg) if cfg.has_experts(i) else MLP(cfg)


class JambaLM(nn.Module):
    """tokens (B, L) -> logits (B, L, vocab) in fp32."""

    def __init__(self, cfg: JambaConfig, scan_implementation=None):
        super().__init__()
        self.cfg = cfg
        self.scan_implementation = scan_implementation
        self.model = nn.Module()
        self.model.embed_tokens = nn.Embedding(cfg.vocab_size,
                                               cfg.hidden_size)
        self.model.layers = nn.ModuleList(
            DecoderLayer(cfg, i) for i in range(cfg.num_hidden_layers))
        self.model.final_layernorm = RMSNorm(cfg.hidden_size,
                                             cfg.rms_norm_eps)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)
        if cfg.tie_word_embeddings:
            self.lm_head.weight = self.model.embed_tokens.weight
        # generate's DecodeGraph
        self._decoding_cache = None

    @torch.no_grad()
    def init_parameters(self, gen):
        """transformers' ``JambaPreTrainedModel._init_weights``: linear,
        conv and embedding weights ~ N(0, initializer_range), biases 0,
        norms 1, ``A_log`` = log(1..N), ``D`` = 1."""
        std = self.cfg.initializer_range
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d, nn.Embedding)):
                nn.init.normal_(m.weight, std=std, generator=gen)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, RMSNorm):
                m.weight.fill_(1.0)
            elif isinstance(m, MambaMixer):
                n = m.A_log.shape[1]
                m.A_log.copy_(torch.log(torch.arange(
                    1, n + 1, dtype=torch.float32)).expand(m.A_log.shape))
                m.D.fill_(1.0)

    def split_params(self, params) -> lm_lib.LMParts:
        """A flat dict under this model's names as ``lm.LMParts``: what
        ``lm.prefill``, ``lm.decode_step`` and ``lm.generate`` read."""
        cfg, sub = self.cfg, lm_lib.sub_params
        emb = params["model.embed_tokens.weight"]
        top_k = cfg.num_experts_per_tok
        layers = []
        for i in range(cfg.num_hidden_layers):
            pre = f"model.layers.{i}."
            attn = cfg.is_attention(i)
            ff = sub(params, pre + "feed_forward.")
            if cfg.has_experts(i):
                run = functools.partial(moe.dropless_moe, ff, top_k=top_k)
                step = functools.partial(moe.dropless_moe_step, ff,
                                         top_k=top_k)
            else:
                run = step = functools.partial(moe.swiglu, ff)
            layers.append(lm_lib.Layer(
                sub(params, pre + ("self_attn." if attn else "mamba.")),
                sub(params, pre + "input_layernorm."),
                "attention" if attn else "mamba",
                sub(params, pre + "pre_ff_layernorm."), run, step))
        return lm_lib.LMParts(
            emb=emb, layers=layers,
            norm_f=sub(params, "model.final_layernorm."),
            apply_norm=functools.partial(rms_norm, eps=cfg.rms_norm_eps),
            dtype=quant.compute_dtype(params), residual_in_fp32=False,
            implementation=self.scan_implementation,
            head=params.get("lm_head.weight"),
            n_heads=cfg.num_attention_heads,
            n_kv_heads=cfg.num_key_value_heads,
            ssm_norm_eps=cfg.rms_norm_eps, logits_dtype=torch.float32)

    def forward(self, tokens):
        lm_lib.check_kernel_config(self.cfg, tokens.device,
                                   self.scan_implementation)
        return lm_lib.forward_parts(self.split_params(lm_lib.lm_params(self)),
                                    tokens)


# a snapshot's weights as AI21 publishes them: safetensors shards and the
# index that names each tensor's shard
INDEX = "model.safetensors.index.json"


def read_checkpoint(hf_dir, keys):
    """The tensors named ``keys`` of a local snapshot's sharded safetensors
    weights; None where the directory holds no index."""
    path = os.path.join(hf_dir, INDEX)
    if not os.path.exists(path):
        return None
    from safetensors import safe_open

    with open(path) as f:
        where = json.load(f)["weight_map"]
    out = {}
    for file in sorted({where[k] for k in keys if k in where}):
        with safe_open(os.path.join(hf_dir, file), "pt") as f:
            for k in keys:
                if where.get(k) == file:
                    out[k] = f.get_tensor(k)
    return out


def load_jamba(hf_dir, device="cuda", dtype=torch.float32, seed=0,
               **overrides):
    """(JambaLM in eval mode on ``device`` in ``dtype``, its
    ``lm.lm_params`` dict) from a local snapshot directory: its
    ``config.json`` (``overrides`` cut it, e.g. ``num_hidden_layers=8``) and,
    where the directory holds them (sharded safetensors and their index),
    its weights, loaded strictly (a layer
    cut keeps the layers it holds); else the init of
    ``JambaLM.init_parameters`` from ``seed``.  The model is made on the
    meta device and placed once: no copy of it passes through the host."""
    from vivim_tpu_torch.cli.common import resolve_device

    with open(os.path.join(hf_dir, "config.json")) as f:
        cfg = config_from_jamba_json(json.load(f), **overrides)
    lm_lib.check_kernel_config(cfg, device)
    dev = resolve_device(device)
    with torch.device("meta"):
        model = JambaLM(cfg)
    model = model.to(dtype).to_empty(device=dev)
    if cfg.tie_word_embeddings:   # to_empty gives each its own storage
        model.lm_head.weight = model.model.embed_tokens.weight
    sd = read_checkpoint(hf_dir, list(model.state_dict()))
    if sd is None:
        model.init_parameters(torch.Generator(dev).manual_seed(seed))
    else:
        model.load_state_dict(sd, strict=True)
    return model.eval(), lm_lib.lm_params(model)
