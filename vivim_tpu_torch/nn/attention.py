"""Grouped-query causal self-attention with a static K/V cache: the
attention layers of a hybrid LM (``nn/jamba.py``, ``nn/granite.py``,
``nn/falcon_h1.py``).

transformers' ``JambaAttention`` (modeling_jamba.py): ``q_proj``,
``k_proj``, ``v_proj``, ``o_proj`` without biases, ``n_kv`` key/value heads
shared by ``n_heads / n_kv`` query heads each, scores scaled by
``head_dim ** -0.5`` (or the model's own ``scale``: Granite's
``attention_multiplier``), a causal mask, the softmax in fp32.  Neither
Jamba's nor Granite 4.0-H's attention has a positional encoding (their
Mamba layers carry the order): they pass no ``rope``.  Falcon-H1's passes a
``Rope``: its keys are multiplied by ``key_multiplier``, then queries and
keys are rotated at their positions as transformers' ``apply_rotary_pos_emb``
does (``rotate_half``: the first half of each head against the second),
with cos and sin computed in fp32 from ``inv_freq`` and cast to the
activations' dtype; the cache holds the rotated keys.

- ``gqa_prefill``: the prompt's causal attention through
  ``F.scaled_dot_product_attention`` (its softmax runs in fp32), writing the
  prompt's keys and values into a new cache of ``max_len`` positions;
- ``gqa_step``: one token against that cache, through the same SDPA call
  with a mask.  The cache is updated in place at a device-side position and
  every position past it is masked, so the step has static shapes and no
  host read: a CUDA graph captures it.

The cache of a layer is one tensor (B, 2, n_kv, max_len, head_dim) (keys
then values) in the activations' dtype, and its position a (1,) int64
tensor: the number of positions filled.  ``KV_BYTES`` counts the bytes of
every cache ``gqa_prefill`` allocates in this process.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from vivim_tpu_torch.nn.quant import matmul_t

KV_BYTES = 0


@dataclasses.dataclass
class Rope:
    """Rotary positions of a model: ``inv_freq`` (head_dim / 2,) fp32, and
    the factor the keys take before their rotation."""

    inv_freq: torch.Tensor
    key_multiplier: float = 1.0


def make_rope(theta, head_dim, device=None, key_multiplier=1.0):
    """``Rope`` of transformers' default rotary embedding:
    inv_freq = 1 / theta ** (2i / head_dim), computed on the host in fp32
    (as transformers computes its buffer) and placed on ``device``."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.int64).float()
    inv_freq = 1.0 / (theta ** (exponent / head_dim))
    return Rope(inv_freq.to(device), key_multiplier)


def _rotate_half(t):
    half = t.shape[-1] // 2
    return torch.cat((-t[..., half:], t[..., :half]), dim=-1)


def _rotate(rp: Rope, positions, q, k):
    """q (..., P, heads, head_dim) and k (..., P, kv, head_dim) rotated at
    ``positions`` (P,) (a device tensor: no host read)."""
    freqs = positions.float()[:, None] * rp.inv_freq[None]
    emb = torch.cat((freqs, freqs), dim=-1)
    cos = emb.cos().to(q.dtype)[:, None]
    sin = emb.sin().to(q.dtype)[:, None]
    return (q * cos + _rotate_half(q) * sin,
            k * cos + _rotate_half(k) * sin)


def _heads(t, n, head_dim):
    """(..., n * head_dim) -> (..., n, head_dim)."""
    return t.reshape(*t.shape[:-1], n, head_dim)


def _qkv(params, x, n_heads, n_kv, rp=None, positions=None):
    """(q, k, v) of x (..., d_model), heads split; with a ``Rope``, k times
    its key multiplier, then q and k rotated at ``positions``."""
    head_dim = params["q_proj.weight"].shape[0] // n_heads
    q = _heads(matmul_t(x, params["q_proj.weight"]), n_heads, head_dim)
    k = _heads(matmul_t(x, params["k_proj.weight"]), n_kv, head_dim)
    v = _heads(matmul_t(x, params["v_proj.weight"]), n_kv, head_dim)
    if rp is not None:
        if rp.key_multiplier != 1.0:
            k = k * rp.key_multiplier
        q, k = _rotate(rp, positions, q, k)
    return q, k, v


def gqa_prefill(params, x, n_heads, n_kv, max_len=None, scale=None,
                rope=None):
    """x (B, L, d_model) -> (out (B, L, d_model), cache (B, 2, n_kv,
    max_len, head_dim) holding the prompt's keys and values at positions
    below L, position (1,) int64 = L).  ``scale``: the scores' (None:
    head_dim ** -0.5); ``rope``: a ``Rope`` (positions 0 to L - 1), or
    None (no positions)."""
    global KV_BYTES
    b, L, _ = x.shape
    q, k, v = _qkv(params, x, n_heads, n_kv, rope, None if rope is None
                   else torch.arange(L, device=x.device))
    max_len = L if max_len is None else max_len
    cache = x.new_zeros(b, 2, n_kv, max_len, k.shape[-1])
    KV_BYTES += cache.numel() * cache.element_size()
    cache[:, 0, :, :L] = k.transpose(1, 2)
    cache[:, 1, :, :L] = v.transpose(1, 2)
    group = n_heads // n_kv
    # (B, heads, L, head_dim); each key/value head serves its group of
    # query heads
    q = q.transpose(1, 2)
    k = k.transpose(1, 2).repeat_interleave(group, 1)
    v = v.transpose(1, 2).repeat_interleave(group, 1)
    y = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                       scale=scale)
    y = y.transpose(1, 2).reshape(b, L, -1)
    pos = torch.full((1,), L, dtype=torch.long, device=x.device)
    return matmul_t(y, params["o_proj.weight"]), cache, pos


def gqa_step(params, x, cache, pos, n_heads, n_kv, scale=None, rope=None):
    """x (B, d_model), one token at position ``pos`` -> (out (B, d_model),
    the cache with its key and value written at ``pos``, pos + 1): both
    stepped in place, so the returned cache and position are the given
    tensors.  With a ``rope`` the token is rotated at ``pos``, read on the
    device."""
    b = x.shape[0]
    if rope is None:
        q, k, v = _qkv(params, x, n_heads, n_kv)
    else:   # one position: (B, 1, heads, head_dim)
        q, k, v = (t[:, 0] for t in _qkv(params, x[:, None], n_heads, n_kv,
                                         rope, pos))
    head_dim = k.shape[-1]
    cache.index_copy_(3, pos, torch.stack([k, v], 1)[:, :, :, None])
    # one position's query heads of a key/value head are that head's
    # queries: (B, n_kv, group, head_dim) against (B, n_kv, max_len,
    # head_dim), every position past ``pos`` masked
    q = q.reshape(b, n_kv, n_heads // n_kv, head_dim)
    seen = (torch.arange(cache.shape[3], device=x.device) <= pos)[None, None,
                                                                   None]
    y = F.scaled_dot_product_attention(q, cache[:, 0], cache[:, 1],
                                       attn_mask=seen, scale=scale)
    return matmul_t(y.reshape(b, -1), params["o_proj.weight"]), cache, \
        pos.add_(1)
