"""Fused Mamba inner function: conv1d -> projections -> selective scan.

Port of the JAX package's ``kernels/mamba_inner.py`` (``mamba_inner``,
``mamba_inner_grouped``).  The conv and the projection matmuls are plain
PyTorch; the scan is the CUDA kernel on the GPU
(``kernels/selective_scan.py``).  B, C and z reach the kernel as strided
views of the projection outputs, so nothing is copied for them.

``remat=True`` recomputes the pre-scan chain (the causal conv, x_proj and
dt_proj) in the backward instead of keeping its activations
(``torch.utils.checkpoint``; the reference CUDA Function's
checkpoint_lvl=1).  The scan is outside the recomputed region.  The chain
draws no random numbers, so the checkpoint needs no generator.

``mamba_inner_grouped(seq_group=...)`` takes this rank's token shard of
the ``seq`` group's sequence (``nn/mamba.py``): the causal conv runs on the
left neighbour's last ``width - 1`` tokens (``comm.seq_halo``) and the
shard, and the scan is the sequence-sharded body
(``parallel/seq_scan.py``).  The halo is exchanged once, outside the
recomputed region: under ``remat`` it is saved (width - 1 tokens per row),
so the backward's recompute issues no collective.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from vivim_tpu_torch.kernels.causal_conv1d import causal_conv1d
from vivim_tpu_torch.kernels.selective_scan import selective_scan
from vivim_tpu_torch.parallel import comm
from vivim_tpu_torch.parallel.seq_scan import seq_sharded_selective_scan_local


def mamba_inner(
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
    implementation=None,
    remat=False,
    seq_axis=None,
    mesh=None,
):
    """Fused Mamba-block inner function, time-major.

    xz (batch, L, 2*d_inner), conv1d_weight (width, d_inner), x_proj_weight
    (dt_rank + 2*dstate, d_inner), delta_proj_weight (d_inner, dt_rank),
    A (d_inner, dstate).  ``remat=True`` recomputes the pre-scan chain in
    the backward.  ``seq_axis`` + ``mesh`` shard the scan's L over that
    mesh axis (``selective_scan``).  Returns (batch, L, d_inner), or (batch, L, d_model) with
    out_proj.
    """
    x, z, delta, B, C = _remat(remat, _pre_scan, xz, conv1d_weight,
                               conv1d_bias, x_proj_weight, delta_proj_weight,
                               A.shape[1])
    y = selective_scan(x, delta, A, B, C, D=D, z=z, delta_bias=delta_bias,
                       delta_softplus=delta_softplus,
                       implementation=implementation, seq_axis=seq_axis,
                       mesh=mesh)
    if out_proj_weight is not None:
        y = y @ out_proj_weight.t()
        if out_proj_bias is not None:
            y = y + out_proj_bias
    return y


def _remat(remat, fn, *args):
    if not (remat and torch.is_grad_enabled()):
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             preserve_rng_state=False)


def _pre_scan(xz, conv1d_weight, conv1d_bias, x_proj_weight,
              delta_proj_weight, dstate):
    """Conv + projections of one direction: (x, z, delta, B, C)."""
    d_inner = xz.shape[-1] // 2
    delta_rank = delta_proj_weight.shape[1]
    x, z = xz[..., :d_inner], xz[..., d_inner:]
    x = causal_conv1d(x, conv1d_weight, conv1d_bias, activation="silu")
    # projections stay in the activation dtype (fp32 weights would promote
    # the scan's inputs to fp32)
    x_dbl = x @ x_proj_weight.to(x.dtype).t()
    delta = x_dbl[..., :delta_rank] @ delta_proj_weight.to(x.dtype).t()
    B = x_dbl[..., delta_rank:delta_rank + dstate]
    C = x_dbl[..., delta_rank + dstate:]
    return x, z, delta, B, C


def _pre_scan_grouped(xz, conv_w_g, conv_b_g, x_proj_g, dt_proj_g, dstate,
                      halo=None):
    """Grouped conv + projections of the batched tri-directional path.

    xz: (G*nb, L, 2*d_inner), direction-major; weights stacked with a
    leading (G,) axis.  The depthwise conv runs in fp32 over (G, nb, L, d),
    left-padded with zeros, or with ``halo`` (G*nb, width - 1, d_inner),
    the tokens before a sequence shard.
    """
    G = conv_w_g.shape[0]
    GB, L, dd = xz.shape
    d_inner = dd // 2
    nb = GB // G
    delta_rank = dt_proj_g.shape[-1]
    x, z = xz[..., :d_inner], xz[..., d_inner:]
    width = conv_w_g.shape[1]
    if halo is None:
        xp = F.pad(x.reshape(G, nb, L, d_inner).float(),
                   (0, 0, width - 1, 0))
    else:
        xp = torch.cat([halo, x], 1).reshape(G, nb, L + width - 1,
                                             d_inner).float()
    wf = conv_w_g.float()[:, None, :, None, :]          # (G, 1, W, 1, d)
    out = xp[:, :, 0:L] * wf[:, :, 0]
    for w in range(1, width):
        out = out + xp[:, :, w:w + L] * wf[:, :, w]
    if conv_b_g is not None:
        out = out + conv_b_g.float()[:, None, None, :]
    xc = F.silu(out).to(x.dtype)                         # (G, nb, L, d)
    x_dbl = torch.matmul(xc.reshape(G, nb * L, d_inner),
                         x_proj_g.to(x.dtype).transpose(1, 2))
    delta = torch.matmul(x_dbl[..., :delta_rank],
                         dt_proj_g.to(x.dtype).transpose(1, 2))
    x_dbl = x_dbl.reshape(GB, L, -1)
    Bv = x_dbl[..., delta_rank:delta_rank + dstate]
    Cv = x_dbl[..., delta_rank + dstate:]
    return (xc.reshape(GB, L, d_inner), z, delta.reshape(GB, L, d_inner),
            Bv, Cv)


def mamba_inner_grouped(
    xz_grouped,
    conv_w_g,
    conv_b_g,
    x_proj_g,
    dt_proj_g,
    A_log_g,
    D_g,
    delta_bias_g,
    nb: int,
    delta_softplus=True,
    implementation=None,
    remat=False,
    seq_axis=None,
    mesh=None,
    seq_group=None,
):
    """Batched multi-direction Mamba inner: one scan launch for all G
    directions.

    xz_grouped: (G*nb, L, 2*d_inner), direction-major.  Parameter stacks
    carry a leading (G,) axis: conv_w_g (G, width, d), conv_b_g (G, d),
    x_proj_g (G, R, d), dt_proj_g (G, d, rank), A_log_g (G, d, N), D_g and
    delta_bias_g (G, d).  ``remat=True`` recomputes the grouped pre-scan
    chain in the backward; ``seq_axis`` + ``mesh`` shard the scan's L of
    whole inputs (``selective_scan``).  ``seq_group``: xz_grouped is this
    rank's (G*nb, L/S, ·) shard of that process group's sequence (module
    docstring).  Returns (G*nb, L, d_inner), or this rank's shard of it.
    """
    halo = None
    if seq_group is not None:
        if not delta_softplus:
            raise ValueError("the seq-sharded scan requires "
                             "delta_softplus=True")
        halo = comm.seq_halo(xz_grouped[..., :xz_grouped.shape[-1] // 2],
                             conv_w_g.shape[1] - 1, seq_group)
    x, z, delta, Bv, Cv = _remat(
        remat, _pre_scan_grouped, xz_grouped, conv_w_g, conv_b_g, x_proj_g,
        dt_proj_g, A_log_g.shape[-1], halo)
    rep = lambda t: t.float().repeat_interleave(nb, dim=0)  # (G,.)->(G*nb,.)
    if seq_group is not None:
        return seq_sharded_selective_scan_local(
            x, delta, rep(-torch.exp(A_log_g.float())), Bv, Cv, D=rep(D_g),
            z=z, delta_bias=rep(delta_bias_g), group=seq_group,
            implementation=implementation, return_last_state=False)[0]
    return selective_scan(
        x, delta, rep(-torch.exp(A_log_g.float())), Bv, Cv,
        D=rep(D_g), z=z, delta_bias=rep(delta_bias_g),
        delta_softplus=delta_softplus, implementation=implementation,
        seq_axis=seq_axis, mesh=mesh)
