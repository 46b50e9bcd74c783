"""Plain PyTorch versions of the kernels: the ground-truth semantics.

Ports of the JAX package's ``kernels/refs.py``.  They run on any device, are
differentiable through autograd, and are what the CPU takes in place of the
CUDA kernels; on the GPU they are what the kernels are held against.

- ``selective_scan_ref``: first-order linear recurrence
  ``h_t = exp(dt*A) * h_{t-1} + dt*B_t*u_t``, ``y_t = C_t . h_t + D*u_t``,
  gated by ``silu(z)``, computed in fp32 and cast back to the input dtype.
  Vectorised over (batch, dim, dstate); a Python loop walks L.
- ``causal_conv1d_ref``: depthwise causal conv of width 2-4, optional SiLU.
- ``mamba_inner_ref``: conv1d -> x_proj -> (dt, B, C) split -> dt_proj ->
  selective scan (z-gated), optionally + out_proj.

Layout is time-major: activations are ``(batch, seqlen, dim)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def selective_scan_ref(
    u,
    delta,
    A,
    B,
    C,
    D=None,
    z=None,
    delta_bias=None,
    delta_softplus=False,
    return_last_state=False,
    initial_state=None,
):
    """Sequential selective-scan reference, time-major layout.

    Args:
      u, delta: (batch, L, dim).
      A: (dim, dstate) shared or (batch, dim, dstate) per batch.
      B, C: (batch, L, dstate); (batch, L, groups, dstate) grouped, where
        group g owns the contiguous channel block g*dim/groups...; or
        (dim, dstate) constant.
      D, delta_bias: (dim,) or (batch, dim), optional.
      z: (batch, L, dim) gate, optional: the output is multiplied by silu(z).
      delta_softplus: apply softplus to delta (+ bias).
      return_last_state: also return the final (batch, dim, dstate) state.
      initial_state: (batch, dim, dstate) starting state (zeros if None).

    Returns out (batch, L, dim) in u.dtype, and the fp32 last state when
    ``return_last_state``.
    """
    dtype_in = u.dtype
    u = u.float()
    delta = delta.float()
    if delta_bias is not None:
        db = delta_bias.float()
        delta = delta + (db[:, None, :] if db.dim() == 2 else db)
    if delta_softplus:
        delta = F.softplus(delta)
    batch, seqlen, dim = u.shape
    dstate = A.shape[-1]
    A = A.float()
    if A.dim() == 2:
        A = A.expand(batch, dim, dstate)
    B = B.float()
    C = C.float()
    if B.dim() == 4:  # grouped: repeat each group over its channel block
        B = B.repeat_interleave(dim // B.shape[2], dim=2)
    if C.dim() == 4:
        C = C.repeat_interleave(dim // C.shape[2], dim=2)

    def per_step(M):
        """(b, L, n) -> (b, L, 1, n); (b, L, d, n) as is; (d, n) -> None."""
        if M.dim() == 3:
            return M[:, :, None, :]
        if M.dim() == 4:
            return M
        return None

    Bs, Cs = per_step(B), per_step(C)
    dA = torch.exp(delta[..., None] * A[:, None])  # (b, L, d, n)
    du = (delta * u)[..., None]                     # (b, L, d, 1)
    dBu = du * (Bs if Bs is not None else B[None, None])
    h = (u.new_zeros(batch, dim, dstate) if initial_state is None
         else initial_state.float())
    ys = []
    for t in range(seqlen):
        h = dA[:, t] * h + dBu[:, t]
        Ct = Cs[:, t] if Cs is not None else C[None]
        ys.append((h * Ct).sum(-1))
    y = torch.stack(ys, dim=1) if ys else u.new_zeros(batch, 0, dim)

    out = y
    if D is not None:
        Df = D.float()
        out = out + u * (Df[:, None, :] if Df.dim() == 2 else Df)
    if z is not None:
        out = out * F.silu(z.float())
    out = out.to(dtype_in)
    return (out, h) if return_last_state else out


def causal_conv1d_ref(x, weight, bias=None, activation=None):
    """Depthwise causal conv reference, time-major.

    x: (batch, L, dim); weight: (width, dim); bias: (dim,) optional;
    activation: None | "silu" | "swish".
    ``y[b, l, d] = sum_w x[b, l - (width-1) + w, d] * weight[w, d]`` with
    zero left-padding, then optional SiLU.
    """
    if activation not in (None, "silu", "swish"):
        raise NotImplementedError("activation must be None, silu, or swish")
    dtype_in = x.dtype
    x = x.to(weight.dtype)
    width, L = weight.shape[0], x.shape[1]
    out = torch.zeros_like(x)
    for w in range(width):
        shift = width - 1 - w
        xs = F.pad(x, (0, 0, shift, 0))[:, :L, :]
        out = out + xs * weight[w]
    if bias is not None:
        out = out + bias
    if activation is not None:
        out = F.silu(out)
    return out.to(dtype_in)


def mamba_inner_ref(
    xz,
    conv1d_weight,
    conv1d_bias,
    x_proj_weight,
    delta_proj_weight,
    A,
    D=None,
    delta_bias=None,
    out_proj_weight=None,
    out_proj_bias=None,
    delta_softplus=True,
    scan_fn=None,
):
    """Fused Mamba-block inner function (time-major).

      x, z = split(xz);  x = silu(causal_conv1d(x));
      dt, B, C = split(x @ x_proj^T);  delta = dt @ delta_proj^T;
      y = selective_scan(x, delta, A, B, C, D, z=z, softplus)
      out = y (@ out_proj^T + bias, if given)

    xz: (batch, L, 2*d_inner); conv1d_weight: (width, d_inner);
    x_proj_weight: (dt_rank + 2*dstate, d_inner); delta_proj_weight:
    (d_inner, dt_rank); A: (d_inner, dstate).
    """
    if scan_fn is None:
        scan_fn = selective_scan_ref
    d_inner = xz.shape[-1] // 2
    delta_rank = delta_proj_weight.shape[1]
    dstate = A.shape[1]
    x, z = xz[..., :d_inner], xz[..., d_inner:]
    x = causal_conv1d_ref(x, conv1d_weight, conv1d_bias, activation="silu")
    x_dbl = torch.einsum("bld,rd->blr", x, x_proj_weight)
    dt = x_dbl[..., :delta_rank]
    B = x_dbl[..., delta_rank : delta_rank + dstate]
    C = x_dbl[..., delta_rank + dstate :]
    delta = torch.einsum("blr,dr->bld", dt, delta_proj_weight)
    y = scan_fn(x, delta, A, B, C, D=D, z=z, delta_bias=delta_bias,
                delta_softplus=delta_softplus)
    if out_proj_weight is not None:
        y = torch.einsum("bld,od->blo", y, out_proj_weight)
        if out_proj_bias is not None:
            y = y + out_proj_bias
    return y
