"""The plain reference of Falcon-H1 (transformers' ``FalconH1ForCausalLM``),
float32 PyTorch.

embedding x ``embedding_multiplier`` -> n x [RMSNorm to x; the Mamba-2
mixer of x times ``ssm_out_multiplier`` plus the attention of x times
``attention_in_multiplier``, times ``attention_out_multiplier``; one
residual add; RMSNorm; the SwiGLU ``down(up(x) * silu(gate(x) * m_gate)) *
m_down``; residual add] -> final RMSNorm -> head x ``lm_head_multiplier``.
The attention is grouped-query with rotary positions (transformers'
default RoPE at ``rope_theta``, ``rotate_half``), its keys times
``key_multiplier`` before the rotation, scores scaled by head_dim ** -0.5.
The Mamba-2 mixer (``FalconH1Mixer.torch_forward``) takes its input times
``ssm_in_multiplier``, in_proj's z, x, B, C and dt segments times the five
``ssm_multipliers``, runs the depthwise conv and silu over xBC, the
recurrence in its head form, and the gated RMSNorm ``w * rms(y * silu(z))``
over each of its ``mamba_n_groups`` groups of channels before out_proj.
The configuration is the JSON of ``perfbench/configs/`` (the
``config.json`` keys); parameter names are transformers' state-dict keys
(``names``), so the benchmark's weights load into it and into the program
alike.

Departures from modeling_falcon_h1.py, none of which changes the
mathematics:
- the recurrence is Granite's reference ``ssd`` (``reference/granite.py``):
  the head form in float64 over chunks, one exponential a (step, head), one
  batch row at a time (transformers' chunked scan in float32).  It is not
  ``reference/scan.py``'s per-channel scan: that would hold 4.4 G float64
  states a batch row at the cell's (4224, 4096, N 256);
- attention materialises its softmax one batch row at a time, in float32,
  with the causal mask; RoPE's cos and sin stay in float32;
- ``forward`` reads the weights through ``weight(name)``, one layer at a
  time, and computes the logits only at the positions asked for;
- every matmul's operands pass through ``rnd`` (identity by default): the
  control rounds them to float8 e4m3 (``jamba.fp8``).

Imports nothing of the program and no ``transformers``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.granite import ssd
from perfbench.reference.jamba import _same, linear, rms

KEYS = ("q", "k", "v")


def dims(cfg):
    """(hidden, d_ssm, d_state, groups, Mamba-2 heads, their head_dim, conv
    width, attention heads, kv heads, attention head_dim, MLP width,
    vocab)."""
    m = cfg["hidden_size"]
    d = cfg.get("mamba_d_ssm") or cfg["mamba_expand"] * m
    heads = cfg["mamba_n_heads"]
    ha = cfg["num_attention_heads"]
    return (m, d, cfg["mamba_d_state"], cfg["mamba_n_groups"], heads,
            d // heads, cfg["mamba_d_conv"], ha, cfg["num_key_value_heads"],
            cfg.get("head_dim") or m // ha, cfg["intermediate_size"],
            cfg["vocab_size"])


def layer_names(cfg, i):
    """{name: shape} of layer ``i``'s parameters."""
    m, d, n, g, heads, _, w, ha, kv, hd, f, _ = dims(cfg)
    pre = f"model.layers.{i}."
    cd = d + 2 * g * n
    out = {pre + "input_layernorm.weight": (m,)}
    mb = pre + "mamba."
    out[mb + "in_proj.weight"] = (d + cd + heads, m)
    out[mb + "conv1d.weight"] = (cd, 1, w)
    if cfg.get("mamba_conv_bias", True):
        out[mb + "conv1d.bias"] = (cd,)
    for name in ("dt_bias", "A_log", "D"):
        out[mb + name] = (heads,)
    out[mb + "norm.weight"] = (d,)
    out[mb + "out_proj.weight"] = (m, d)
    for p, rows in zip(KEYS, (ha * hd, kv * hd, kv * hd)):
        out[pre + f"self_attn.{p}_proj.weight"] = (rows, m)
    out[pre + "self_attn.o_proj.weight"] = (m, ha * hd)
    out[pre + "pre_ff_layernorm.weight"] = (m,)
    for p in ("gate", "up"):
        out[pre + f"feed_forward.{p}_proj.weight"] = (f, m)
    out[pre + "feed_forward.down_proj.weight"] = (m, f)
    return out


def names(cfg):
    """{name: shape} of every parameter, transformers' keys (a tied head
    is the embedding, named once)."""
    m, *_, v = dims(cfg)
    out = {"model.embed_tokens.weight": (v, m)}
    for i in range(cfg["num_hidden_layers"]):
        out.update(layer_names(cfg, i))
    out["model.final_layernorm.weight"] = (m,)
    if not cfg.get("tie_word_embeddings", False):
        out["lm_head.weight"] = (v, m)
    return out


def mamba2(p, x, cfg, rnd):
    """``FalconH1Mixer.torch_forward`` over a whole sequence (no cache): x
    (B, L, hidden) -> (B, L, hidden)."""
    _, d, n, g, heads, P, w, *_ = dims(cfg)
    b, L, _ = x.shape
    cd = d + 2 * g * n
    sizes = [d, d, g * n, g * n, heads]
    mup = torch.cat([torch.full((k,), float(f), device=x.device)
                     for k, f in zip(sizes, cfg["ssm_multipliers"])])
    zxbcdt = linear(x * cfg["ssm_in_multiplier"], p["in_proj.weight"],
                    rnd) * mup
    z, xbc, dt = zxbcdt.split([d, cd, heads], -1)
    xbc = F.silu(F.conv1d(xbc.transpose(1, 2), p["conv1d.weight"],
                          p.get("conv1d.bias"), padding=w - 1,
                          groups=cd)[..., :L]).transpose(1, 2)
    xs, B, C = xbc.split([d, g * n, g * n], -1)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y = torch.empty(b, L, d, device=x.device)
    for row in range(b):
        y[row] = ssd(xs[row].reshape(L, heads, P), dt[row], A,
                     B[row].reshape(L, g, n), C[row].reshape(L, g, n),
                     p["D"])[0].reshape(L, d).float()
    gated = (y * F.silu(z)).unflatten(-1, (g, d // g))
    normed = rms(gated, p["norm.weight"].reshape(g, d // g),
                 cfg["rms_norm_eps"]).flatten(-2)
    return linear(normed, p["out_proj.weight"], rnd)


def rotate(t, positions, theta):
    """t (B, heads, L, head_dim) rotated at ``positions`` (L,): transformers'
    ``apply_rotary_pos_emb`` with ``rotate_half``, in float32."""
    hd = t.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.int64)
                                .float() / hd))
    freqs = positions.float()[:, None] * inv_freq.to(t.device)[None]
    emb = torch.cat((freqs, freqs), -1)
    half = torch.cat((-t[..., hd // 2:], t[..., :hd // 2]), -1)
    return t * emb.cos() + half * emb.sin()


def attention(p, x, cfg, rnd):
    """``FalconH1Attention`` (eager): x (B, L, hidden) -> (B, L, hidden)."""
    *_, heads, kv, hd, _, _ = dims(cfg)
    b, L, _ = x.shape
    split = lambda t, k: t.reshape(b, L, k, hd).transpose(1, 2)
    q, k, v = (split(linear(x, p[f"self_attn.{n}_proj.weight"], rnd), c)
               for n, c in zip(KEYS, (heads, kv, kv)))
    positions = torch.arange(L, device=x.device)
    q = rotate(q, positions, cfg["rope_theta"])
    k = rotate(k * cfg["key_multiplier"], positions, cfg["rope_theta"])
    k = k.repeat_interleave(heads // kv, 1)     # repeat_kv
    v = v.repeat_interleave(heads // kv, 1)
    future = torch.ones(L, L, dtype=torch.bool, device=x.device).triu(1)
    y = torch.empty_like(q)
    for row in range(b):
        s = rnd(q[row]) @ rnd(k[row]).transpose(-1, -2) * hd ** -0.5
        probs = torch.softmax(s.masked_fill(future, float("-inf")), -1)
        y[row] = rnd(probs) @ rnd(v[row])
    return linear(y.transpose(1, 2).reshape(b, L, heads * hd),
                  p["self_attn.o_proj.weight"], rnd)


def mlp(p, x, cfg, rnd):
    """``FalconH1MLP``: x (B, L, hidden) -> (B, L, hidden)."""
    gate_m, down_m = cfg["mlp_multipliers"]
    g = linear(x, p["feed_forward.gate_proj.weight"], rnd)
    u = linear(x, p["feed_forward.up_proj.weight"], rnd)
    return linear(u * F.silu(g * gate_m), p["feed_forward.down_proj.weight"],
                  rnd) * down_m


def forward(cfg, weight, tokens, positions=None, rnd=None):
    """tokens (B, L) -> float32 logits (B, L, vocab), or at ``positions``
    only (B, len(positions), vocab).  ``weight(name)`` gives each
    parameter as float32 on the tokens' device; a layer's are asked for
    when it runs and dropped after.  ``rnd``: what every matmul operand
    passes through (None: nothing)."""
    rnd = rnd or _same
    eps = cfg["rms_norm_eps"]
    h = weight("model.embed_tokens.weight")[tokens] \
        * cfg["embedding_multiplier"]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"model.layers.{i}."
        p = {k[len(pre):]: weight(k) for k in layer_names(cfg, i)}
        x = rms(h, p["input_layernorm.weight"], eps)
        ssm = mamba2({k[len("mamba."):]: t for k, t in p.items()
                      if k.startswith("mamba.")}, x, cfg, rnd)
        attn = attention(p, x * cfg["attention_in_multiplier"], cfg, rnd)
        h = h + (ssm * cfg["ssm_out_multiplier"]
                 + attn * cfg["attention_out_multiplier"])
        del ssm, attn
        h = h + mlp(p, rms(h, p["pre_ff_layernorm.weight"], eps), cfg, rnd)
        del p, x
    h = rms(h, weight("model.final_layernorm.weight"), eps)
    if positions is not None:
        h = h[:, positions]
    head = ("model.embed_tokens.weight" if cfg.get("tie_word_embeddings")
            else "lm_head.weight")
    return linear(h, weight(head), rnd) * cfg["lm_head_multiplier"]


class FalconH1(nn.Module):
    """The reference as a module holding its parameters under
    transformers' names: tokens (B, L) -> float32 logits (B, L, vocab)."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        for name, shape in names(cfg).items():
            *path, leaf = name.split(".")
            mod = self
            for part in path:
                if not hasattr(mod, part):
                    mod.add_module(part, nn.Module())
                mod = getattr(mod, part)
            mod.register_parameter(leaf, nn.Parameter(torch.empty(shape)))

    def forward(self, tokens, positions=None, rnd=None):
        params = dict(self.named_parameters())
        return forward(self.cfg, lambda k: params[k].float(), tokens,
                       positions, rnd)
