"""The plain reference of Granite 4.0-H (transformers'
``GraniteMoeHybridForCausalLM``), float32 PyTorch.

embedding x ``embedding_multiplier`` -> n x [RMSNorm, mixer, residual add
of its output x ``residual_multiplier``, RMSNorm, the routed experts plus
the shared expert, residual add likewise] -> final RMSNorm -> head (tied to
the embedding) / ``logits_scaling``.  Layer i's mixer is a Mamba-2 mixer or
grouped-query attention with no positional encoding, as ``layer_types[i]``
says; every layer's feed-forward is the top-k MoE of stacked SwiGLU experts
(the top k of the router's logits, a softmax over those k) plus an
always-on shared SwiGLU expert.  The configuration is the JSON of
``perfbench/configs/`` (the ``config.json`` keys); parameter names are
transformers' state-dict keys (``names``), so the benchmark's weights load
into it and into the program alike.

The Mamba-2 recurrence is written in its published head form (mamba_ssm's
``ssd_minimal``, transformers' ``torch_forward``): per head h, with dt_t =
softplus(dt_t + dt_bias) and A = -exp(A_log) scalars of the head, the state
(head_dim, d_state) steps ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T`` and
``y_t = h_t C_t + D x_t``, B and C those of the head's group, one
exponential a (step, head).  ``ssd`` computes it in float64 over chunks of
``CHUNK`` steps: inside a chunk the pairwise decays exp(S_t - S_s), s <= t,
of the running sum S of dt A (each at most 1), between chunks the carried
state; so it holds no per-channel copy of dt or A, and none of its
exponentials can overflow.  Then the gated RMSNorm ``w * rms(y * silu(z))``
over all d_inner channels.

Departures from modeling_granitemoehybrid.py, none of which changes the
mathematics:
- the scan in float64 (transformers' chunked scan in float32), one batch
  row at a time;
- attention materialises its softmax one batch row at a time, in float32,
  with the causal mask and the scale ``attention_multiplier``;
- the MoE gathers each expert's tokens and sums the gated outputs with
  ``index_add_`` (transformers sorts the tokens by expert: the same sum);
- every sum in float32 (transformers sums the experts in the weights'
  dtype);
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

from perfbench.reference.jamba import _same, linear, rms

CHUNK = 256


def dims(cfg):
    """(hidden, d_inner, d_state, groups, Mamba-2 heads, their head_dim,
    conv width, attention heads, kv heads, attention head_dim, expert
    width, shared width, experts, vocab)."""
    m = cfg["hidden_size"]
    d = cfg["mamba_expand"] * m
    heads = cfg["mamba_n_heads"]
    heads_attn = cfg["num_attention_heads"]
    return (m, d, cfg["mamba_d_state"], cfg["mamba_n_groups"], heads,
            d // heads, cfg["mamba_d_conv"], heads_attn,
            cfg["num_key_value_heads"], m // heads_attn,
            cfg["intermediate_size"], cfg["shared_intermediate_size"],
            cfg["num_local_experts"], cfg["vocab_size"])


def layer_types(cfg):
    return cfg["layer_types"][:cfg["num_hidden_layers"]]


def layer_names(cfg, i):
    """{name: shape} of layer ``i``'s parameters."""
    m, d, n, g, heads, _, w, ha, kv, hd, f, fs, e, _ = dims(cfg)
    pre = f"model.layers.{i}."
    out = {pre + "input_layernorm.weight": (m,)}
    if layer_types(cfg)[i] == "attention":
        for p, rows in (("q", ha * hd), ("k", kv * hd), ("v", kv * hd)):
            out[pre + f"self_attn.{p}_proj.weight"] = (rows, m)
        out[pre + "self_attn.o_proj.weight"] = (m, ha * hd)
    else:
        mb = pre + "mamba."
        cd = d + 2 * g * n
        bias = cfg.get("mamba_proj_bias", False)
        out[mb + "in_proj.weight"] = (d + cd + heads, m)
        if bias:
            out[mb + "in_proj.bias"] = (d + cd + heads,)
        out[mb + "conv1d.weight"] = (cd, 1, w)
        if cfg.get("mamba_conv_bias", True):
            out[mb + "conv1d.bias"] = (cd,)
        for name in ("dt_bias", "A_log", "D"):
            out[mb + name] = (heads,)
        out[mb + "norm.weight"] = (d,)
        out[mb + "out_proj.weight"] = (m, d)
        if bias:
            out[mb + "out_proj.bias"] = (m,)
    out[pre + "post_attention_layernorm.weight"] = (m,)
    moe = pre + "block_sparse_moe."
    out[moe + "input_linear.weight"] = (e, 2 * f, m)
    out[moe + "output_linear.weight"] = (e, m, f)
    out[moe + "router.layer.weight"] = (e, m)
    out[pre + "shared_mlp.input_linear.weight"] = (2 * fs, m)
    out[pre + "shared_mlp.output_linear.weight"] = (m, fs)
    return out


def names(cfg):
    """{name: shape} of every parameter, transformers' keys (a tied head
    is the embedding, named once)."""
    m, *_, v = dims(cfg)
    out = {"model.embed_tokens.weight": (v, m)}
    for i in range(cfg["num_hidden_layers"]):
        out.update(layer_names(cfg, i))
    out["model.norm.weight"] = (m,)
    if not cfg.get("tie_word_embeddings", False):
        out["lm_head.weight"] = (v, m)
    return out


def glu(x, w_in, w_out, rnd):
    """``GraniteMoeHybridMLP``: w_out of silu(first half) * second half of
    w_in x."""
    g, u = linear(x, w_in, rnd).chunk(2, -1)
    return linear(F.silu(g) * u, w_out, rnd)


def ssd(x, dt, A, B, C, D, chunk=CHUNK):
    """The Mamba-2 recurrence in head form, float64: x (L, heads, P), dt
    (L, heads) after its softplus, A, D (heads,), B, C (L, groups, N) ->
    (y (L, heads, P), the last state (heads, P, N)); a head's B and C are
    its group's (heads split evenly, in order)."""
    x, dt, A, B, C, D = (t.double() for t in (x, dt, A, B, C, D))
    L, heads, P = x.shape
    rep = heads // B.shape[1]
    h = x.new_zeros(heads, P, B.shape[2])
    ys = []
    for s in range(0, L, chunk):
        xc, dc = x[s:s + chunk], dt[s:s + chunk]
        Bc = B[s:s + chunk].repeat_interleave(rep, 1)   # (K, heads, N)
        Cc = C[s:s + chunk].repeat_interleave(rep, 1)
        S = torch.cumsum(dc * A, 0)                     # (K, heads)
        K = S.shape[0]
        causal = torch.ones(K, K, dtype=torch.bool, device=x.device).tril()
        seg = (S[:, None] - S[None]).masked_fill(~causal[..., None],
                                                 float("-inf"))
        # y_t = sum_{s<=t} (C_t . B_s) exp(S_t - S_s) dt_s x_s, plus the
        # carried state decayed to t, plus D x_t
        w = torch.einsum("thn,shn->tsh", Cc, Bc) * torch.exp(seg) * dc[None]
        y = torch.einsum("tsh,shp->thp", w, xc)
        y = y + torch.einsum("thn,hpn->thp", Cc, h) * torch.exp(S)[..., None]
        ys.append(y + D[:, None] * xc)
        to_end = torch.exp(S[-1] - S) * dc               # (K, heads)
        h = (torch.exp(S[-1])[:, None, None] * h
             + torch.einsum("sh,shp,shn->hpn", to_end, xc, Bc))
    return torch.cat(ys), h


def mamba2(p, x, cfg, rnd, eps):
    """``GraniteMoeHybridMambaLayer.torch_forward`` over a whole sequence (no
    cache): x (B, L, hidden) -> (B, L, hidden)."""
    _, d, n, g, heads, P, w, *_ = dims(cfg)
    b, L, _ = x.shape
    cd = d + 2 * g * n
    zxbcdt = linear(x, p["in_proj.weight"], rnd, p.get("in_proj.bias"))
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
    gated = y * F.silu(z)
    return linear(rms(gated, p["norm.weight"], eps), p["out_proj.weight"],
                  rnd, p.get("out_proj.bias"))


def attention(p, x, cfg, rnd):
    """``GraniteMoeHybridAttention`` (eager), no positions, its scores times
    ``attention_multiplier``: x (B, L, hidden) -> (B, L, hidden)."""
    *_, heads, kv, hd, _, _, _, _ = dims(cfg)
    b, L, _ = x.shape
    scale = cfg["attention_multiplier"]
    split = lambda t, k: t.reshape(b, L, k, hd).transpose(1, 2)
    q = split(linear(x, p["self_attn.q_proj.weight"], rnd), heads)
    k = split(linear(x, p["self_attn.k_proj.weight"], rnd), kv)
    v = split(linear(x, p["self_attn.v_proj.weight"], rnd), kv)
    k = k.repeat_interleave(heads // kv, 1)     # repeat_kv
    v = v.repeat_interleave(heads // kv, 1)
    future = torch.ones(L, L, dtype=torch.bool, device=x.device).triu(1)
    y = torch.empty_like(q)
    for row in range(b):
        s = rnd(q[row]) @ rnd(k[row]).transpose(-1, -2) * scale
        probs = torch.softmax(s.masked_fill(future, float("-inf")), -1)
        y[row] = rnd(probs) @ rnd(v[row])
    return linear(y.transpose(1, 2).reshape(b, L, heads * hd),
                  p["self_attn.o_proj.weight"], rnd)


def moe(p, x, cfg, rnd):
    """``GraniteMoeHybridMoE`` plus ``shared_mlp``: x (B, L, hidden) -> (B,
    L, hidden)."""
    xt = x.reshape(-1, x.shape[-1])
    out = glu(xt, p["shared_mlp.input_linear.weight"],
              p["shared_mlp.output_linear.weight"], rnd)
    pre = "block_sparse_moe."
    logits = linear(xt, p[pre + "router.layer.weight"], rnd)
    top, chosen = torch.topk(logits, cfg["num_experts_per_tok"], dim=-1)
    gates = torch.softmax(top, -1)
    w_in, w_out = p[pre + "input_linear.weight"], p[pre + "output_linear.weight"]
    for e in range(cfg["num_local_experts"]):
        rows, slot = (chosen == e).nonzero(as_tuple=True)
        if rows.numel():
            y = glu(xt[rows], w_in[e], w_out[e], rnd)
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
    res = cfg.get("residual_multiplier", 1.0)
    h = weight("model.embed_tokens.weight")[tokens] \
        * cfg.get("embedding_multiplier", 1.0)
    for i, kind in enumerate(layer_types(cfg)):
        pre = f"model.layers.{i}."
        p = {k[len(pre):]: weight(k) for k in layer_names(cfg, i)}
        x = rms(h, p["input_layernorm.weight"], eps)
        if kind == "attention":
            h = h + res * attention(p, x, cfg, rnd)
        else:
            h = h + res * mamba2({k[len("mamba."):]: t for k, t in p.items()
                                  if k.startswith("mamba.")}, x, cfg, rnd,
                                 eps)
        x = rms(h, p["post_attention_layernorm.weight"], eps)
        h = h + res * moe(p, x, cfg, rnd)
        del p, x
    h = rms(h, weight("model.norm.weight"), eps)
    if positions is not None:
        h = h[:, positions]
    head = ("model.embed_tokens.weight" if cfg.get("tie_word_embeddings")
            else "lm_head.weight")
    return linear(h, weight(head), rnd) / cfg.get("logits_scaling", 1.0)


class Granite(nn.Module):
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
