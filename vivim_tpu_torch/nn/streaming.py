"""Streaming (token by token) Mamba recurrence: the LM's decode path.

Port of the JAX package's ``nn/streaming.py`` (the reference's
``Mamba.step`` / ``allocate_inference_cache``, mamba_simple.py:356-414): a
one-token step that advances a carried ``(conv_state, ssm_state)`` in place
(``kernels/mamba_step.py``: two kernels on the card, around the x_proj
product), and a prefill that runs the prompt through the selective-scan
kernel (K1 on the card) and hands its last state to the step.  The JAX
step is functional; here the caller's state tensors are the step's.

Every function takes one forward-direction mixer's parameters as a flat
dict under the reference Mamba's names (``in_proj.weight``,
``conv1d.weight`` (d_inner, 1, width), ``conv1d.bias``, ``x_proj.weight``,
``dt_proj.weight``, ``dt_proj.bias``, ``A_log``, ``D``,
``out_proj.weight``); ``in_proj.weight`` / ``out_proj.weight`` may be int8
QTensors (``nn.quant``).  A Jamba mixer's dict also holds RMSNorm weights of
dt, B and C (``dt_layernorm.weight``, ``b_layernorm.weight``,
``c_layernorm.weight``, transformers' ``JambaMambaMixer``): where it does,
they normalise the three parts of ``x_proj``'s output before ``dt_proj``
and the scan, with ``norm_eps``.  Activations are time-major.

A Mamba-2 mixer (``mamba2_prefill`` / ``mamba2_step``, transformers'
``GraniteMoeHybridMambaLayer`` and ``FalconH1Mixer``) runs on the same two
kernels: ``in_proj`` gives the gate z, the conv's input xBC (x, then B and
C of each group) and one dt a head; the conv runs over xBC; the recurrence
is Mamba-1's with each head's dt, dt_bias, A and D shared by its channels
(K1 reads them repeated over the channels, ``ssm_step`` per head); y then
passes the gated RMSNorm ``w * rms(y * silu(z))`` in fp32 before
``out_proj``, over all d_inner channels (Granite) or over each of
``norm_groups`` groups of them (Falcon-H1: one a group of B and C).
Falcon-H1's µP multipliers act around ``in_proj``: its input times
``in_multiplier``, its output times the vector ``mup`` (one factor for each
of the z, x, B, C and dt segments).  Its parameters, and the constants both
read, are a ``Mamba2`` built once per split of the parameters (``mamba2``).

Each prefill opens the span ``lm.ssm`` around its recurrence: the scan and
the preparation of its arguments, not the projections or the conv.

Given a process ``group``, ``mamba_prefill`` and ``mamba_step`` run one
rank's channel split of a tensor-parallel mixer (``parallel.
tensor_parallel.split_tp_params``: the rank's x and z rows of in_proj, its
d_inner / k slice of every per-channel leaf) and add the split's three
collectives (``parallel/comm.py``): ``copy_to_model`` at the replicated
input, the sum of the partial x_proj product (dt, B and C; summed in the
backward too) and ``reduce_from_model`` of the partial out_proj product,
before the whole out bias.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from vivim_tpu_torch.kernels.causal_conv1d import causal_conv1d
from vivim_tpu_torch.kernels.mamba_step import conv_step, ssm_step
from vivim_tpu_torch.kernels.selective_scan import selective_scan
from vivim_tpu_torch.nn import quant
from vivim_tpu_torch.nn.quant import matmul_t
from vivim_tpu_torch.parallel import comm
from vivim_tpu_torch.utils.profiling import span


def allocate_cache(batch: int, d_model: int, d_state: int = 16,
                   d_conv: int = 4, expand: int = 2, dtype=torch.float32,
                   device=None):
    """(conv_state (B, W, d_inner), ssm_state (B, d_inner, N) fp32) of
    zeros."""
    d_inner = expand * d_model
    return (torch.zeros(batch, d_conv, d_inner, dtype=dtype, device=device),
            torch.zeros(batch, d_inner, d_state, dtype=torch.float32,
                        device=device))


def _split_proj(params, x):
    xz = matmul_t(x, params["in_proj.weight"])
    if "in_proj.bias" in params:
        xz = xz + params["in_proj.bias"]
    d_inner = xz.shape[-1] // 2
    return xz[..., :d_inner], xz[..., d_inner:]


def _x_proj(params, xc, group):
    x_dbl = xc @ params["x_proj.weight"].t().to(xc.dtype)
    return x_dbl if group is None else comm.AllReduceSum.apply(x_dbl, group)


def _dt_b_c(params, x_dbl, dt_rank, n, norm_eps):
    """The scan's (dt before ``dt_proj``, B, C) from ``x_proj``'s output,
    each through its RMSNorm when ``params`` holds one (computed in fp32,
    back in the activations' dtype, times the weight)."""
    parts = (x_dbl[..., :dt_rank], x_dbl[..., dt_rank:dt_rank + n],
             x_dbl[..., dt_rank + n:])
    if "dt_layernorm.weight" not in params:
        return parts
    out = []
    for t, name in zip(parts, ("dt", "b", "c")):
        f = t.float()
        f = f * torch.rsqrt((f * f).mean(-1, keepdim=True) + norm_eps)
        out.append(params[f"{name}_layernorm.weight"].to(t.dtype)
                   * f.to(t.dtype))
    return out


def _out_proj(params, y, group=None):
    out = matmul_t(y, params["out_proj.weight"])
    if group is not None:
        out = comm.reduce_from_model(out, group)
    if "out_proj.bias" in params:
        out = out + params["out_proj.bias"]
    return out


def _ssm_params(params):
    """(conv weight (width, d_inner), dt_rank, d_state)."""
    conv_w = params["conv1d.weight"][:, 0, :].t()
    dt_rank = params["dt_proj.weight"].shape[1]
    return conv_w, dt_rank, params["A_log"].shape[1]


def mamba_step(params, x, conv_state, ssm_state, group=None, norm_eps=1e-6):
    """One decode step (mamba_simple.py:356-401), the states stepped in
    place.

    x: (B, d_model) token activations; conv_state: (B, W, d_inner);
    ssm_state: (B, d_inner, N) fp32.  Writes the next window and state
    into the given tensors (``conv_step`` and ``ssm_step``) and returns
    (out (B, d_model), conv_state, ssm_state): those same tensors.
    """
    if group is not None:
        x = comm.copy_to_model(x, group)
    xw, z = _split_proj(params, x)
    conv_w, dt_rank, n = _ssm_params(params)
    xc = conv_step(xw, conv_state, conv_w, params.get("conv1d.bias"))
    dt, B, C = _dt_b_c(params, _x_proj(params, xc, group), dt_rank, n,
                       norm_eps)
    dt = dt @ params["dt_proj.weight"].t().to(xc.dtype)
    y = ssm_step(ssm_state, xc, dt, params["A_log"], B, C, params["D"], z,
                 params["dt_proj.bias"])
    return _out_proj(params, y, group), conv_state, ssm_state


def mamba_prefill(params, x, implementation=None, group=None,
                  norm_eps=1e-6):
    """The prompt's full forward, emitting the states for ``mamba_step``.

    x: (B, L, d_model).  Returns (out (B, L, d_model), conv_state (the last
    ``width`` pre-conv inputs, left-padded with zeros), ssm_state (fp32, the
    scan's last state)), so that stepping on from them equals the full
    forward over the longer sequence.  The scan is K1 on the card, with z
    gated in the kernel.
    """
    if group is not None:
        x = comm.copy_to_model(x, group)
    xw, z = _split_proj(params, x)
    conv_w, dt_rank, n = _ssm_params(params)
    width = conv_w.shape[0]
    pad = torch.nn.functional.pad(xw, (0, 0, max(width - x.shape[1], 0), 0))
    conv_state = pad[:, -width:].contiguous()
    xc = causal_conv1d(xw, conv_w, params.get("conv1d.bias"), "silu")
    dt, B, C = _dt_b_c(params, _x_proj(params, xc, group), dt_rank, n,
                       norm_eps)
    delta = dt @ params["dt_proj.weight"].t().to(xc.dtype)
    with span("lm.ssm"):
        y, ssm_state = selective_scan(
            xc, delta, -torch.exp(params["A_log"].float()), B, C,
            D=params["D"].float(), z=z,
            delta_bias=params["dt_proj.bias"].float(), delta_softplus=True,
            return_last_state=True, implementation=implementation)
    return _out_proj(params, y, group), conv_state, ssm_state


@dataclasses.dataclass
class Mamba2:
    """A Mamba-2 mixer as its prefill and step read it: ``params`` under
    transformers' names (``in_proj.weight`` (d_inner + conv_dim + heads,
    d_model), ``conv1d.weight`` (conv_dim, 1, W), ``conv1d.bias``,
    ``dt_bias``, ``A_log``, ``D`` (heads,), ``norm.weight`` (d_inner,),
    ``out_proj.weight``; ``in_proj.bias`` / ``out_proj.bias`` where the
    mixer has them), conv_dim = d_inner + 2 n_groups d_state; and the
    constants built from them once: K1's per-channel ``A`` (d_inner,
    d_state) = -exp(A_log), ``D`` and ``dt_bias`` (d_inner,), fp32, each
    head's repeated over its channels; the step's ``A_log_heads`` (heads,
    d_state), a view.  Falcon-H1's: ``in_multiplier``, ``mup`` (in_proj's
    width,) in the weights' dtype or None, the gated norm over
    ``norm_groups`` groups, its weight times the fp32 normed value before
    the one rounding (``norm_weight_fp32``; Granite rounds first)."""

    params: dict
    n_groups: int
    d_state: int
    head_dim: int
    norm_eps: float
    A: torch.Tensor
    D: torch.Tensor
    dt_bias: torch.Tensor
    A_log_heads: torch.Tensor
    in_multiplier: float = 1.0
    mup: torch.Tensor | None = None
    norm_groups: int = 1
    norm_weight_fp32: bool = False

    @property
    def d_inner(self):
        return self.params["norm.weight"].shape[0]


def mamba2(params, n_groups, d_state, norm_eps, in_multiplier=1.0,
           zxbcdt_multipliers=None, norm_groups=1, norm_weight_fp32=False):
    """``Mamba2`` of one mixer's parameter dict: the constants built
    here, once per split of the parameters, so no call copies them.
    ``zxbcdt_multipliers``: Falcon-H1's five factors of in_proj's z, x, B,
    C and dt segments, made one vector in the weights' dtype."""
    heads = params["A_log"].shape[0]
    d = params["norm.weight"].shape[0]
    head_dim = d // heads
    per_channel = lambda t: t.float().repeat_interleave(head_dim).contiguous()
    a_log = params["A_log"]
    mup = None
    if zxbcdt_multipliers is not None:
        gn = n_groups * d_state
        mup = torch.cat([torch.full((n,), float(f)) for n, f in zip(
            (d, d, gn, gn, heads), zxbcdt_multipliers)]).to(
            quant.compute_dtype(params)).to(a_log.device)
    return Mamba2(
        params, n_groups, d_state, head_dim, norm_eps,
        A=(-torch.exp(per_channel(a_log)))[:, None].expand(
            -1, d_state).contiguous(),
        D=per_channel(params["D"]), dt_bias=per_channel(params["dt_bias"]),
        A_log_heads=a_log[:, None].expand(heads, d_state),
        in_multiplier=in_multiplier, mup=mup, norm_groups=norm_groups,
        norm_weight_fp32=norm_weight_fp32)


def _mamba2_split(m: Mamba2, x):
    """(z, xBC, dt) of ``in_proj``'s output: column views."""
    p = m.params
    if m.in_multiplier != 1.0:
        x = x * m.in_multiplier
    zxbcdt = matmul_t(x, p["in_proj.weight"])
    if "in_proj.bias" in p:
        zxbcdt = zxbcdt + p["in_proj.bias"]
    if m.mup is not None:
        zxbcdt = zxbcdt * m.mup
    d, cd = m.d_inner, p["conv1d.weight"].shape[0]
    return zxbcdt[..., :d], zxbcdt[..., d:d + cd], zxbcdt[..., d + cd:]


def gated_norm(m: Mamba2, y, z):
    """transformers' ``GraniteMoeHybridRMSNormGated`` (``norm_groups`` 1)
    and ``FalconH1RMSNormGated`` (gate before the norm): ``w * rms(y *
    silu(z))`` over each of ``norm_groups`` groups of channels, in fp32,
    back in y's dtype."""
    f = y.float()
    if z is not None:
        f = f * F.silu(z.float())
    f = f.unflatten(-1, (m.norm_groups, -1))
    f = (f * torch.rsqrt((f * f).mean(-1, keepdim=True) + m.norm_eps)
         ).flatten(-2)
    if m.norm_weight_fp32:
        return (m.params["norm.weight"] * f).to(y.dtype)
    return m.params["norm.weight"] * f.to(y.dtype)


def _mamba2_out(m: Mamba2, y):
    out = matmul_t(y, m.params["out_proj.weight"])
    if "out_proj.bias" in m.params:
        out = out + m.params["out_proj.bias"]
    return out


def mamba2_prefill(m: Mamba2, x, implementation=None):
    """A Mamba-2 mixer over the prompt, emitting its decode states.

    x: (B, L, d_model).  Returns (out (B, L, d_model), conv_state (B, W,
    conv_dim): the last W pre-conv xBC inputs, left-padded with zeros,
    ssm_state (B, d_inner, d_state) fp32: the scan's last state).  The scan
    is K1 on the card, with each head's dt, dt_bias, A and D over its
    channels and no z: the gate acts in the norm.
    """
    z, xbc, dt = _mamba2_split(m, x)
    conv_w = m.params["conv1d.weight"][:, 0, :].t()
    width = conv_w.shape[0]
    pad = F.pad(xbc, (0, 0, max(width - x.shape[1], 0), 0))
    conv_state = pad[:, -width:].contiguous()
    xbc = causal_conv1d(xbc, conv_w, m.params.get("conv1d.bias"), "silu")
    d, gn = m.d_inner, m.n_groups * m.d_state
    with span("lm.ssm"):
        B, C = xbc[..., d:d + gn], xbc[..., d + gn:]
        if m.n_groups > 1:
            B = B.unflatten(-1, (m.n_groups, m.d_state))
            C = C.unflatten(-1, (m.n_groups, m.d_state))
        y, ssm_state = selective_scan(
            xbc[..., :d], dt.repeat_interleave(m.head_dim, -1), m.A, B, C,
            D=m.D, delta_bias=m.dt_bias, delta_softplus=True,
            return_last_state=True, implementation=implementation)
    return _mamba2_out(m, gated_norm(m, y, z)), conv_state, ssm_state


def mamba2_step(m: Mamba2, x, conv_state, ssm_state):
    """One decode step of a Mamba-2 mixer, its states stepped in place:
    ``conv_step`` over the xBC window, ``ssm_step`` per head (gated by z
    there), the RMSNorm.  x: (B, d_model); returns (out (B, d_model),
    conv_state, ssm_state), the given state tensors."""
    z, xbc, dt = _mamba2_split(m, x)
    conv_w = m.params["conv1d.weight"][:, 0, :].t()
    xbc = conv_step(xbc, conv_state, conv_w, m.params.get("conv1d.bias"))
    d, gn = m.d_inner, m.n_groups * m.d_state
    y = ssm_step(ssm_state, xbc[:, :d], dt, m.A_log_heads,
                 xbc[:, d:d + gn], xbc[:, d + gn:], m.params["D"], z,
                 m.params["dt_bias"], head_dim=m.head_dim,
                 n_groups=m.n_groups)
    return _mamba2_out(m, gated_norm(m, y, None)), conv_state, ssm_state
