"""Falcon-H1: TII's parallel hybrid LM, attention and a Mamba-2 mixer side by
side in every layer, on the LM's serving path.

Port of transformers' ``FalconH1ForCausalLM`` (models/falcon_h1/
modeling_falcon_h1.py, ``model_type`` ``falcon_h1``: Falcon-H1 0.5B to 34B):

- ``FalconH1Config`` and ``config_from_falcon_json``: the keys of its
  ``config.json``.
- ``FalconH1LM``: embedding (times ``embedding_multiplier``) -> n x
  [RMSNorm; the Mamba-2 mixer of the normed x times ``ssm_out_multiplier``
  plus the attention of x times ``attention_in_multiplier``, times
  ``attention_out_multiplier``; one residual add; RMSNorm; the SwiGLU
  ``down(up(x) * silu(gate(x) * m_gate)) * m_down`` (``mlp_multipliers``);
  residual add] -> final RMSNorm -> head (untied unless
  ``tie_word_embeddings``), the logits times ``lm_head_multiplier``.  The
  attention rotates queries and keys (RoPE at ``rope_theta``) after the
  keys take ``key_multiplier``; the Mamba-2 mixer takes its input times
  ``ssm_in_multiplier``, ``in_proj``'s z, x, B, C and dt segments times the
  five ``ssm_multipliers``, and normalises each of its ``mamba_n_groups``
  groups of channels in the gated norm (gate before the norm).  Its
  state_dict keys are transformers' (``model.embed_tokens.weight``,
  ``model.layers.{i}.input_layernorm.weight``, ``model.layers.{i}.mamba.
  {in_proj.weight, conv1d.weight, conv1d.bias, dt_bias, A_log, D,
  norm.weight, out_proj.weight}``, ``model.layers.{i}.self_attn.
  {q,k,v,o}_proj.weight``, ``model.layers.{i}.pre_ff_layernorm.weight``,
  ``model.layers.{i}.feed_forward.{gate,up,down}_proj.weight``,
  ``model.final_layernorm.weight``, ``lm_head.weight``), so a checkpoint's
  tensors load into it strictly (``load_falcon_h1``).

The model runs through ``nn/lm.py``'s functions, as Jamba and Granite do:
``split_params`` makes each layer an ``lm.Parallel`` (its ``streaming.
Mamba2`` built there, once per split) whose decode state is one record of
four tensors (conv window, ssm state, K/V cache, position), and
``lm.generate`` runs the eager prefill (K1 per layer, SDPA) and one replayed
``lm.DecodeGraph`` a token, the RoPE position read on the device.  As
transformers computes it: the residual stream in the weights' dtype, each
RMSNorm in fp32 and back (times its weight), the gated norm in fp32 with
its weight applied before the one rounding, the attention's softmax in
fp32, RoPE's cos and sin in fp32 cast to the activations' dtype, the ssm
state in fp32, the logits returned in fp32.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os

import torch
import torch.nn.functional as F
from torch import nn

from vivim_tpu_torch.nn import attention, quant, streaming
from vivim_tpu_torch.nn import lm as lm_lib
from vivim_tpu_torch.nn.granite import MambaMixer, init_modules
from vivim_tpu_torch.nn.jamba import RMSNorm, read_checkpoint, rms_norm
from vivim_tpu_torch.nn.quant import matmul_t


@dataclasses.dataclass(frozen=True)
class FalconH1Config:
    vocab_size: int = 261120
    hidden_size: int = 5120
    intermediate_size: int = 21504
    num_hidden_layers: int = 72
    num_attention_heads: int = 20
    num_key_value_heads: int = 4
    head_dim: int = 128
    mamba_d_ssm: int = 4096
    mamba_n_heads: int = 32
    mamba_d_head: int = 128
    mamba_n_groups: int = 2
    mamba_d_state: int = 256
    mamba_d_conv: int = 4
    mamba_conv_bias: bool = True
    rope_theta: float = 1e11
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    initializer_range: float = 0.02
    embedding_multiplier: float = 1.0
    lm_head_multiplier: float = 1.0
    key_multiplier: float = 1.0
    attention_in_multiplier: float = 1.0
    attention_out_multiplier: float = 1.0
    ssm_in_multiplier: float = 1.0
    ssm_out_multiplier: float = 1.0
    ssm_multipliers: tuple = (1.0,) * 5   # z, x, B, C, dt of in_proj
    mlp_multipliers: tuple = (1.0, 1.0)   # gate, down

    # what granite.MambaMixer and lm.check_kernel_config read
    mamba_proj_bias = False

    @property
    def d_state(self):
        return self.mamba_d_state

    @property
    def d_inner(self):
        return self.mamba_d_ssm

    @property
    def conv_dim(self):
        return self.d_inner + 2 * self.mamba_n_groups * self.mamba_d_state


def config_from_falcon_json(d: dict, **overrides) -> FalconH1Config:
    """``FalconH1Config`` from a ``falcon_h1`` ``config.json`` dict;
    ``overrides`` cut it (``num_hidden_layers=18``: the first 18 layers).
    Raises for what the port does not run: another activation than silu,
    attention, projector, MLP or Mamba projection biases, ``rope_scaling``,
    ``attn_layer_indices`` that leave a layer without attention, the gated
    norm before the gate or no gated norm, Mamba-2 heads that do not tile
    d_ssm or groups that split a head."""
    if d.get("hidden_act", "silu") != "silu":
        raise ValueError(f"hidden_act {d['hidden_act']!r}: Falcon-H1's MLPs "
                         "are SwiGLU (silu)")
    for key in ("attention_bias", "projectors_bias", "mlp_bias",
                "mamba_proj_bias"):
        if d.get(key, False):
            raise ValueError(f"{key}: the port's Falcon-H1 has no such bias")
    if d.get("rope_scaling") is not None:
        raise ValueError(f"rope_scaling {d['rope_scaling']!r}: the port's "
                         "rotary positions are the default ones")
    n = overrides.get("num_hidden_layers", d["num_hidden_layers"])
    attn = d.get("attn_layer_indices")
    if attn is not None and set(range(n)) - set(attn):
        raise ValueError(f"attn_layer_indices {attn}: every layer of the "
                         "port's Falcon-H1 holds attention beside its mixer")
    if d.get("mamba_norm_before_gate", True):
        raise ValueError("mamba_norm_before_gate: the port's gated norm "
                         "gates first, then normalises")
    if not d.get("mamba_rms_norm", False):
        raise ValueError("mamba_rms_norm false: the port's Mamba-2 mixer "
                         "ends in its gated norm")
    hidden = d["hidden_size"]
    heads_attn = d["num_attention_heads"]
    d_ssm = d.get("mamba_d_ssm") or d.get("mamba_expand", 2) * hidden
    heads = d["mamba_n_heads"]
    head = d.get("mamba_d_head", "auto")
    mult = lambda key, k: tuple(d.get(key) or (1.0,) * k)
    kw = dict(
        vocab_size=d["vocab_size"], hidden_size=hidden,
        intermediate_size=d["intermediate_size"], num_hidden_layers=n,
        num_attention_heads=heads_attn,
        num_key_value_heads=d.get("num_key_value_heads") or heads_attn,
        head_dim=d.get("head_dim") or hidden // heads_attn,
        mamba_d_ssm=d_ssm, mamba_n_heads=heads,
        mamba_d_head=d_ssm // heads if head == "auto" else head,
        mamba_n_groups=d.get("mamba_n_groups", 1),
        mamba_d_state=d.get("mamba_d_state", 256),
        mamba_d_conv=d.get("mamba_d_conv", 4),
        mamba_conv_bias=d.get("mamba_conv_bias", True),
        rope_theta=d.get("rope_theta", 1e5),
        rms_norm_eps=d.get("rms_norm_eps", 1e-5),
        tie_word_embeddings=d.get("tie_word_embeddings", False),
        initializer_range=d.get("initializer_range", 0.02),
        embedding_multiplier=d.get("embedding_multiplier", 1.0),
        lm_head_multiplier=d.get("lm_head_multiplier", 1.0),
        **{k: 1.0 if d.get(k) is None else d[k] for k in (
            "key_multiplier", "attention_in_multiplier",
            "attention_out_multiplier", "ssm_in_multiplier",
            "ssm_out_multiplier")},
        ssm_multipliers=mult("ssm_multipliers", 5),
        mlp_multipliers=mult("mlp_multipliers", 2))
    kw.update(overrides)
    cfg = FalconH1Config(**kw)
    groups = cfg.mamba_n_groups
    if (cfg.mamba_n_heads * cfg.mamba_d_head != cfg.d_inner
            or cfg.d_inner % groups
            or (cfg.d_inner // groups) % cfg.mamba_d_head):
        raise ValueError(f"{cfg.mamba_n_heads} Mamba-2 heads of "
                         f"{cfg.mamba_d_head} in {groups} groups do not "
                         f"tile d_ssm {cfg.d_inner} by whole heads")
    return cfg


class Attention(nn.Module):
    def __init__(self, cfg: FalconH1Config):
        super().__init__()
        m, hd = cfg.hidden_size, cfg.head_dim
        q, kv = cfg.num_attention_heads * hd, cfg.num_key_value_heads * hd
        self.q_proj = nn.Linear(m, q, bias=False)
        self.k_proj = nn.Linear(m, kv, bias=False)
        self.v_proj = nn.Linear(m, kv, bias=False)
        self.o_proj = nn.Linear(q, m, bias=False)


class MLP(nn.Module):
    def __init__(self, cfg: FalconH1Config):
        super().__init__()
        m, f = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Linear(m, f, bias=False)
        self.up_proj = nn.Linear(m, f, bias=False)
        self.down_proj = nn.Linear(f, m, bias=False)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: FalconH1Config):
        super().__init__()
        self.feed_forward = MLP(cfg)
        self.mamba = MambaMixer(cfg)
        self.self_attn = Attention(cfg)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.pre_ff_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)


def mlp(params, gate_multiplier, down_multiplier, x):
    """transformers' ``FalconH1MLP``: ``down(up(x) * silu(gate(x) *
    m_gate)) * m_down``, every product in x's dtype."""
    g = matmul_t(x, params["gate_proj.weight"])
    u = matmul_t(x, params["up_proj.weight"])
    y = matmul_t(u * F.silu(lm_lib.scaled(g, gate_multiplier)),
                 params["down_proj.weight"])
    return lm_lib.scaled(y, down_multiplier)


class FalconH1LM(nn.Module):
    """tokens (B, L) -> logits (B, L, vocab) in fp32."""

    def __init__(self, cfg: FalconH1Config, scan_implementation=None):
        super().__init__()
        self.cfg = cfg
        self.scan_implementation = scan_implementation
        self.model = nn.Module()
        self.model.embed_tokens = nn.Embedding(cfg.vocab_size,
                                               cfg.hidden_size)
        self.model.layers = nn.ModuleList(
            DecoderLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.model.final_layernorm = RMSNorm(cfg.hidden_size,
                                             cfg.rms_norm_eps)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)
        if cfg.tie_word_embeddings:
            self.lm_head.weight = self.model.embed_tokens.weight
        # generate's DecodeGraph
        self._decoding_cache = None

    def init_parameters(self, gen):
        """Granite's ``init_modules`` at ``initializer_range``: linear and
        embedding weights normal, norms 1, the conv uniform, each Mamba-2
        mixer as mamba_ssm's ``Mamba2`` draws it."""
        init_modules(self, self.cfg.initializer_range, gen)

    def split_params(self, params) -> lm_lib.LMParts:
        """A flat dict under this model's names as ``lm.LMParts``: what
        ``lm.prefill``, ``lm.decode_step`` and ``lm.generate`` read."""
        cfg, sub = self.cfg, lm_lib.sub_params
        emb = params["model.embed_tokens.weight"]
        layers = []
        for i in range(cfg.num_hidden_layers):
            pre = f"model.layers.{i}."
            ssm = streaming.mamba2(
                sub(params, pre + "mamba."), cfg.mamba_n_groups,
                cfg.mamba_d_state, cfg.rms_norm_eps,
                in_multiplier=cfg.ssm_in_multiplier,
                zxbcdt_multipliers=cfg.ssm_multipliers,
                norm_groups=cfg.mamba_n_groups, norm_weight_fp32=True)
            mixer = lm_lib.Parallel(
                sub(params, pre + "self_attn."), ssm,
                cfg.attention_in_multiplier, cfg.attention_out_multiplier,
                cfg.ssm_out_multiplier)
            ff = functools.partial(mlp, sub(params, pre + "feed_forward."),
                                   *cfg.mlp_multipliers)
            layers.append(lm_lib.Layer(
                mixer, sub(params, pre + "input_layernorm."), "parallel",
                sub(params, pre + "pre_ff_layernorm."), ff, ff))
        return lm_lib.LMParts(
            emb=emb, layers=layers,
            norm_f=sub(params, "model.final_layernorm."),
            apply_norm=functools.partial(rms_norm, eps=cfg.rms_norm_eps),
            dtype=quant.compute_dtype(params), residual_in_fp32=False,
            implementation=self.scan_implementation,
            head=None if cfg.tie_word_embeddings
            else params["lm_head.weight"],
            n_heads=cfg.num_attention_heads,
            n_kv_heads=cfg.num_key_value_heads, logits_dtype=torch.float32,
            embedding_multiplier=cfg.embedding_multiplier,
            lm_head_multiplier=cfg.lm_head_multiplier,
            rope=attention.make_rope(cfg.rope_theta, cfg.head_dim,
                                     emb.device, cfg.key_multiplier))

    def forward(self, tokens):
        lm_lib.check_kernel_config(self.cfg, tokens.device,
                                   self.scan_implementation)
        return lm_lib.forward_parts(self.split_params(lm_lib.lm_params(self)),
                                    tokens)


def load_falcon_h1(hf_dir, device="cuda", dtype=torch.float32, seed=0,
                   **overrides):
    """(FalconH1LM in eval mode on ``device`` in ``dtype``, its
    ``lm.lm_params`` dict) from a local snapshot directory: its
    ``config.json`` (``overrides`` cut it, e.g. ``num_hidden_layers=18``)
    and, where the directory holds them (sharded safetensors and their
    index), its weights, loaded strictly (a layer cut keeps the layers it
    holds); else the init of ``FalconH1LM.init_parameters`` from ``seed``.
    The model is made on the meta device and placed once: no copy of it
    passes through the host."""
    from vivim_tpu_torch.cli.common import resolve_device

    with open(os.path.join(hf_dir, "config.json")) as f:
        cfg = config_from_falcon_json(json.load(f), **overrides)
    lm_lib.check_kernel_config(cfg, device)
    dev = resolve_device(device)
    with torch.device("meta"):
        model = FalconH1LM(cfg)
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
