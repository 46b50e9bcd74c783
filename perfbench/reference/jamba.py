"""The plain reference of Jamba (transformers' ``JambaForCausalLM``),
float32 PyTorch.

embedding -> n x [RMSNorm, mixer, residual, RMSNorm, feed-forward,
residual] -> final RMSNorm -> head.  Layer i's mixer is grouped-query
attention where ``i % attn_layer_period == attn_layer_offset`` and a
Mamba-1 mixer otherwise; its feed-forward is the MoE block where ``i %
expert_layer_period == expert_layer_offset`` and a SwiGLU MLP otherwise
(transformers' ``layers_block_type`` / ``layers_num_experts``).  The
configuration is the JSON of ``perfbench/configs/`` (Jamba's
``config.json`` keys); parameter names are transformers' state-dict keys
(``names``), so the benchmark's weights load into it and into the program
alike.

Departures from modeling_jamba.py, none of which changes the mathematics:
- the scan is ``reference/scan.py``'s float64 chunked scan (transformers'
  ``slow_forward`` loops over the steps in float32), run over blocks of
  ``SCAN_CHANNELS`` channels (the channels are independent) to bound its
  memory;
- attention materialises its softmax one batch row at a time (transformers
  at once), in float32, with the causal mask transformers builds when no
  attention mask is given and no positional encoding, as there;
- the MoE block loops over the experts as transformers does (softmax over
  all experts, the top k probabilities as gates, not renormalised), summing
  with ``index_add_``;
- ``forward`` reads the weights through ``weight(name)``, one layer at a
  time (on the chip the benchmark draws each layer's anew from the seed,
  so the whole model in float32 is never held), and computes the logits
  only at the positions asked for;
- every matmul's operands pass through ``rnd`` (identity by default): the
  control rounds them to float8 e4m3 (``fp8``).

Imports nothing of the program and no ``transformers``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference import scan as scan_lib

SCAN_CHANNELS = 2048
E4M3_MAX = 448.0


def dims(cfg):
    """(hidden, d_inner, d_state, dt_rank, conv width, heads, kv heads,
    head_dim, ffn width, experts, vocab)."""
    m = cfg["hidden_size"]
    rank = cfg["mamba_dt_rank"]
    rank = math.ceil(m / 16) if rank == "auto" else rank
    heads = cfg["num_attention_heads"]
    return (m, cfg["mamba_expand"] * m, cfg["mamba_d_state"], rank,
            cfg["mamba_d_conv"], heads, cfg["num_key_value_heads"],
            m // heads, cfg["intermediate_size"], cfg["num_experts"],
            cfg["vocab_size"])


def is_attention(cfg, i):
    return i % cfg["attn_layer_period"] == cfg["attn_layer_offset"]


def has_experts(cfg, i):
    return (cfg["num_experts"] > 1
            and i % cfg["expert_layer_period"] == cfg["expert_layer_offset"])


def layer_names(cfg, i):
    """{name: shape} of layer ``i``'s parameters."""
    m, d, n, r, w, heads, kv, hd, f, e, _ = dims(cfg)
    pre = f"model.layers.{i}."
    out = {pre + "input_layernorm.weight": (m,)}
    if is_attention(cfg, i):
        for p, rows in (("q", heads * hd), ("k", kv * hd), ("v", kv * hd)):
            out[pre + f"self_attn.{p}_proj.weight"] = (rows, m)
        out[pre + "self_attn.o_proj.weight"] = (m, heads * hd)
    else:
        mb = pre + "mamba."
        bias = cfg.get("mamba_proj_bias", False)
        out[mb + "in_proj.weight"] = (2 * d, m)
        if bias:
            out[mb + "in_proj.bias"] = (2 * d,)
        out[mb + "conv1d.weight"] = (d, 1, w)
        if cfg.get("mamba_conv_bias", True):
            out[mb + "conv1d.bias"] = (d,)
        out[mb + "x_proj.weight"] = (r + 2 * n, d)
        out[mb + "dt_proj.weight"] = (d, r)
        out[mb + "dt_proj.bias"] = (d,)
        out[mb + "A_log"] = (d, n)
        out[mb + "D"] = (d,)
        out[mb + "out_proj.weight"] = (m, d)
        if bias:
            out[mb + "out_proj.bias"] = (m,)
        out[mb + "dt_layernorm.weight"] = (r,)
        out[mb + "b_layernorm.weight"] = (n,)
        out[mb + "c_layernorm.weight"] = (n,)
    out[pre + "pre_ff_layernorm.weight"] = (m,)
    ff = pre + "feed_forward."
    experts = ([f"experts.{k}." for k in range(e)] if has_experts(cfg, i)
               else [""])
    if has_experts(cfg, i):
        out[ff + "router.weight"] = (e, m)
    for x in experts:
        out[ff + x + "gate_proj.weight"] = (f, m)
        out[ff + x + "up_proj.weight"] = (f, m)
        out[ff + x + "down_proj.weight"] = (m, f)
    return out


def names(cfg):
    """{name: shape} of every parameter, transformers' keys."""
    m, *_, v = dims(cfg)
    out = {"model.embed_tokens.weight": (v, m)}
    for i in range(cfg["num_hidden_layers"]):
        out.update(layer_names(cfg, i))
    out["model.final_layernorm.weight"] = (m,)
    if not cfg.get("tie_word_embeddings", False):
        out["lm_head.weight"] = (v, m)
    return out


def fp8(t):
    """``t`` rounded to float8 e4m3 under one scale (its largest magnitude
    to e4m3's largest), back in float32: the operand of an fp8 matmul."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _same(t):
    return t


def linear(x, w, rnd=_same, b=None):
    out = rnd(x) @ rnd(w).t()
    return out if b is None else out + b


def rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def swiglu(p, x, prefix, rnd):
    g = linear(x, p[prefix + "gate_proj.weight"], rnd)
    u = linear(x, p[prefix + "up_proj.weight"], rnd)
    return linear(F.silu(g) * u, p[prefix + "down_proj.weight"], rnd)


def mamba(p, x, cfg, rnd, eps):
    """transformers' ``JambaMambaMixer.slow_forward`` over a whole sequence
    (no cache): x (B, L, hidden) -> (B, L, hidden)."""
    _, d, n, r, w, *_ = dims(cfg)
    L = x.shape[1]
    xz = linear(x, p["in_proj.weight"], rnd, p.get("in_proj.bias"))
    xi, z = xz[..., :d], xz[..., d:]
    xc = F.silu(F.conv1d(xi.transpose(1, 2), p["conv1d.weight"],
                         p.get("conv1d.bias"), padding=w - 1,
                         groups=d)[..., :L]).transpose(1, 2)
    x_dbl = linear(xc, p["x_proj.weight"], rnd)
    dt = rms(x_dbl[..., :r], p["dt_layernorm.weight"], eps)
    B = rms(x_dbl[..., r:r + n], p["b_layernorm.weight"], eps)
    C = rms(x_dbl[..., r + n:], p["c_layernorm.weight"], eps)
    delta = linear(dt, p["dt_proj.weight"], rnd)
    A = -torch.exp(p["A_log"])
    y = torch.empty_like(xc)
    for s in range(0, d, SCAN_CHANNELS):
        c = slice(s, s + SCAN_CHANNELS)
        y[..., c] = scan_lib.selective_scan(
            xc[..., c], delta[..., c], A[c], B, C, D=p["D"][c], z=z[..., c],
            delta_bias=p["dt_proj.bias"][c], delta_softplus=True)
    return linear(y, p["out_proj.weight"], rnd, p.get("out_proj.bias"))


def attention(p, x, cfg, rnd):
    """transformers' ``JambaAttention`` (eager) with its causal mask: x
    (B, L, hidden) -> (B, L, hidden)."""
    *_, heads, kv, hd, _, _, _ = dims(cfg)
    b, L, _ = x.shape
    split = lambda t, k: t.reshape(b, L, k, hd).transpose(1, 2)
    q = split(linear(x, p["self_attn.q_proj.weight"], rnd), heads)
    k = split(linear(x, p["self_attn.k_proj.weight"], rnd), kv)
    v = split(linear(x, p["self_attn.v_proj.weight"], rnd), kv)
    k = k.repeat_interleave(heads // kv, 1)     # repeat_kv
    v = v.repeat_interleave(heads // kv, 1)
    future = torch.ones(L, L, dtype=torch.bool, device=x.device).triu(1)
    y = torch.empty_like(q)
    for row in range(b):
        s = rnd(q[row]) @ rnd(k[row]).transpose(-1, -2) / math.sqrt(hd)
        probs = torch.softmax(s.masked_fill(future, float("-inf")), -1)
        y[row] = rnd(probs) @ rnd(v[row])
    return linear(y.transpose(1, 2).reshape(b, L, heads * hd),
                  p["self_attn.o_proj.weight"], rnd)


def moe(p, x, cfg, rnd):
    """transformers' ``JambaSparseMoeBlock``: x (B, L, hidden) -> (B, L,
    hidden)."""
    xt = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(linear(xt, p["feed_forward.router.weight"], rnd),
                          -1)
    gates, chosen = torch.topk(probs, cfg["num_experts_per_tok"], dim=-1)
    out = torch.zeros_like(xt)
    for e in range(cfg["num_experts"]):
        rows, slot = (chosen == e).nonzero(as_tuple=True)
        if rows.numel():
            y = swiglu(p, xt[rows], f"feed_forward.experts.{e}.", rnd)
            out.index_add_(0, rows, y * gates[rows, slot, None])
    return out.reshape(x.shape)


def forward(cfg, weight, tokens, positions=None, rnd=None):
    """tokens (B, L) -> float32 logits (B, L, vocab), or at ``positions``
    only (B, len(positions), vocab).  ``weight(name)`` gives each
    parameter as float32 on the tokens' device; a layer's are asked for
    when it runs and dropped after.  ``rnd``: what every matmul operand
    passes through (None: nothing)."""
    rnd = rnd or _same
    eps = cfg.get("rms_norm_eps", 1e-6)
    h = weight("model.embed_tokens.weight")[tokens]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"model.layers.{i}."
        p = {k[len(pre):]: weight(k) for k in layer_names(cfg, i)}
        x = rms(h, p["input_layernorm.weight"], eps)
        if is_attention(cfg, i):
            h = h + attention(p, x, cfg, rnd)
        else:
            h = h + mamba({k[len("mamba."):]: t for k, t in p.items()
                           if k.startswith("mamba.")}, x, cfg, rnd, eps)
        x = rms(h, p["pre_ff_layernorm.weight"], eps)
        if has_experts(cfg, i):
            h = h + moe(p, x, cfg, rnd)
        else:
            h = h + swiglu(p, x, "feed_forward.", rnd)
        del p, x
    h = rms(h, weight("model.final_layernorm.weight"), eps)
    if positions is not None:
        h = h[:, positions]
    head = ("model.embed_tokens.weight" if cfg.get("tie_word_embeddings")
            else "lm_head.weight")
    return linear(h, weight(head), rnd)


class Jamba(nn.Module):
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


def build(cfg, device):
    with torch.device(device):
        return Jamba(cfg)
