"""Weight int8 quantization for the LM decode path.

Port of the JAX package's ``nn/quant.py``.  Single-token decode reads every
weight once per token, so its traffic is the weights' bytes; int8 weights
halve that against bf16 for the tensors they cover.

Scheme: symmetric per-output-channel weights (scale = amax / 127 over the
input dim) and dynamic symmetric per-row activations at the matmul: an
int8 x int8 -> int32 product, exact, then one rescale by both scales in
fp32.  The weights are never dequantized into a float matmul.

A quantized tensor is a ``{"q": int8, "s": fp32}`` dict (a "QTensor") in
place of the float tensor in a flat parameter dict (``nn.lm.lm_params``),
so the functional forwards (``nn.streaming``, ``nn.lm.forward_functional``,
``nn.lm.generate``) dispatch on it at each matmul.

What ``quantize_lm_params`` quantizes: the mixer in / out projections and
the tied embedding / lm head, most of the LM's weight bytes.  ``x_proj`` /
``dt_proj`` stay in float (they feed dt, B and C of the scan) and A_log, D,
the dt bias, the conv and the norms are left alone.

The int32 product: ``torch._int_mm`` (int8 (m, k) x int8 (k, n) -> int32).
On the card its cuBLASLt route takes only m > 16 rows and k, n multiples of
8, so ``int_mm`` pads the rows with zeros to a multiple of 8 of at least 24
(zero rows add nothing to the rows kept) and drops them after; decode at
batch 1 has m = 1.
"""

from __future__ import annotations

from collections.abc import Mapping

import torch

# the card's int8 product: rows above 16, a multiple of 8 (k and n must be
# multiples of 8 too)
_INT_MM_MIN_ROWS = 24


def is_qtensor(w) -> bool:
    return isinstance(w, Mapping) and set(w.keys()) == {"q", "s"}


def quantize_int8(w: torch.Tensor, axis: int = 0) -> dict:
    """Symmetric per-channel int8 quantization of a float tensor.

    ``axis`` is the kept (per-channel) axis: axis 0 of an ``(out, in)``
    weight used as ``x @ w.T``.  Returns ``{"q": int8 same shape, "s": fp32
    per-channel scales}`` with ``q * s ~= w``; the scales stay fp32 whatever
    ``w``'s dtype.
    """
    wf = w.float()
    reduce = tuple(i for i in range(w.dim()) if i != axis)
    amax = wf.abs().amax(dim=reduce, keepdim=True)
    s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s.reshape(w.shape[axis])}


def _quantize_rows(x: torch.Tensor):
    """Dynamic per-row int8 quantization of activations (last axis):
    (int8 q, fp32 scales (..., 1))."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s


def int_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``a @ b_t.T`` of int8 ``a`` (m, k) and int8 ``b_t``
    (n, k).  On the card the rows are padded with zeros for cuBLASLt and
    dropped after."""
    m = a.shape[0]
    if a.is_cuda:
        rows = max(_INT_MM_MIN_ROWS, -(-m // 8) * 8)
        if rows != m:
            a = torch.cat([a, a.new_zeros(rows - m, a.shape[1])])
        return torch._int_mm(a, b_t.t())[:m]
    return torch._int_mm(a, b_t.t())


def matmul_t(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w.T`` for a plain ``(out, in)`` weight or a QTensor.

    The int8 path quantizes ``x`` per row, takes the exact int32 product
    with the int8 weight and rescales it by both scales in fp32.
    """
    if not is_qtensor(w):
        return x @ w.t().to(x.dtype)
    xq, xs = _quantize_rows(x)
    lead = x.shape[:-1]
    acc = int_mm(xq.reshape(-1, x.shape[-1]), w["q"])
    acc = acc.reshape(lead + (acc.shape[-1],))
    out = acc.float() * xs * w["s"].float()
    return out.to(x.dtype)


def tree_has_qtensor(params) -> bool:
    """True if any value of the (possibly nested) dict is a QTensor: the
    eval core's test for routing scoring through the functional forward."""
    if is_qtensor(params):
        return True
    if isinstance(params, Mapping):
        return any(tree_has_qtensor(v) for v in params.values())
    return False


def compute_dtype(params, default=torch.float32):
    """The activation dtype of a (possibly quantized) parameter dict: the
    dtype of its first floating-point tensor that is not part of a QTensor
    (a QTensor's scales are fp32 storage, not the compute dtype)."""

    def walk(node):
        if is_qtensor(node):
            return None
        if isinstance(node, Mapping):
            for v in node.values():
                r = walk(v)
                if r is not None:
                    return r
            return None
        if torch.is_tensor(node) and node.is_floating_point():
            return node.dtype
        return None

    return walk(params) or default


def embed_lookup(emb, tokens, dtype=None) -> torch.Tensor:
    """Embedding rows of ``tokens``; a QTensor's gathered rows are
    dequantized by their per-row scales (fp32, or ``dtype``)."""
    if not is_qtensor(emb):
        return emb[tokens]
    rows = emb["q"][tokens].float() * emb["s"][tokens][..., None]
    return rows.to(dtype) if dtype is not None else rows


def lm_head(h: torch.Tensor, emb) -> torch.Tensor:
    """The tied lm head ``h @ emb.T``, plain or quantized."""
    return matmul_t(h, emb)


_DEFAULT_TARGETS = ("in_proj.weight", "out_proj.weight", "embedding.weight")


def quantize_lm_params(params, targets=_DEFAULT_TARGETS,
                       activation_dtype=None):
    """An LM parameter dict for int8 decode: every tensor whose name ends
    in one of ``targets`` (its last two parts: ``in_proj.weight`` of
    ``backbone.layers.0.mixer.in_proj.weight``) becomes its QTensor, per
    output channel, from the tensor as given (quantize the fp32 weights,
    not a bf16 copy).
    ``activation_dtype`` (e.g. ``torch.bfloat16``) also casts the other
    fp32 tensors, so one call gives the int8-weights / bf16-activations
    dict."""
    out = {}
    for k, v in params.items():
        if is_qtensor(v):
            out[k] = v
        elif ".".join(k.split(".")[-2:]) in targets:
            out[k] = quantize_int8(v, axis=0)
        elif (activation_dtype is not None and torch.is_tensor(v)
              and v.dtype == torch.float32):
            out[k] = v.to(activation_dtype)
        else:
            out[k] = v
    return out
