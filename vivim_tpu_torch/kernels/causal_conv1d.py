"""Causal depthwise conv1d, time-major.

Port of the JAX package's ``kernels/causal_conv1d.py``.  The JAX package runs this
as plain XLA ops (no Pallas kernel), so here it is plain PyTorch: ``width``
shifted multiply-adds accumulated in fp32.  ``causal_conv1d_update`` is the
streaming LM's one-token step over a carried window of past inputs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def causal_conv1d(x, weight, bias=None, activation=None):
    """Depthwise causal conv.

    x: (batch, L, dim); weight: (width, dim); bias: (dim,) optional;
    activation: None | "silu" | "swish".  Returns (batch, L, dim) in x.dtype.
    """
    if activation not in (None, "silu", "swish"):
        raise NotImplementedError("activation must be None, silu, or swish")
    width, L = weight.shape[0], x.shape[1]
    xp = F.pad(x.float(), (0, 0, width - 1, 0))
    wf = weight.float()
    out = xp[:, 0:L] * wf[0]
    for w in range(1, width):
        out = out + xp[:, w:w + L] * wf[w]
    if bias is not None:
        out = out + bias.float()
    if activation is not None:
        out = F.silu(out)
    return out.to(x.dtype)


def causal_conv1d_cm(x, weight, bias=None, activation=None):
    """Channel-major wrapper with the reference signature: x is
    (batch, dim, seqlen) and weight is (dim, width)."""
    return causal_conv1d(x.transpose(1, 2), weight.t(), bias,
                         activation).transpose(1, 2)


def causal_conv1d_update(x, conv_state, weight, bias=None, activation=None):
    """One streaming step of the conv (a functional state update).

    x: (batch, dim) new token; conv_state: (batch, width, dim) window of
    past inputs; weight: (width, dim); bias: (dim,) optional.  The sum runs
    in fp32 whatever the input dtype.  Returns (out (batch, dim) in
    x.dtype, new_conv_state).
    """
    if activation not in (None, "silu", "swish"):
        raise NotImplementedError("activation must be None, silu, or swish")
    new_state = torch.cat([conv_state[:, 1:], x[:, None]], dim=1)
    out = (new_state.float() * weight.float()).sum(1)
    if bias is not None:
        out = out + bias.float()
    if activation is not None:
        out = F.silu(out)
    return out.to(x.dtype), new_state
