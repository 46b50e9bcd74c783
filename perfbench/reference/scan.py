"""The selective scan of the plain reference, in float64.

``h_t = exp(dt_t A) h_{t-1} + dt_t B_t u_t``, ``y_t = C_t . h_t + D u_t``,
gated by ``silu(z)``, with ``dt = softplus(delta + bias)``: the semantics
of the mamba reference's ``selective_scan_ref``.  A Python loop over the
steps would take minutes at the benchmark's lengths (20480 tokens), so the
steps are cut into chunks of up to ``CHUNK``: inside a chunk the recurrence
is a cumulative sum in log space, ``h_t = sum_s exp(S_t - S_s) x_s`` with ``S``
the running sum of ``dt A``, factored about the chunk's midpoint ``m`` as
``exp(S_t - m) * cumsum(exp(m - S_s) x_s)``; a loop over the chunks
carries the state.  float64 keeps both factors finite (``|S_t - m|`` stays
under 709 while the chunk times ``max |dt A|`` stays under 1400: the chunk
shrinks to keep it so, ``chunk_for``) and the
sum exact to far below float32's rounding, so the reference is the
float32 semantics without float32's error.

Memory: one batch row of a 20480-token stage is 42 M states, 335 MB in
float64; the rows run in blocks of up to ``ROW_ELEMS`` states, and the
autograd Function keeps only its inputs and recomputes a block's graph in
the backward, so a training step's reference holds one block's
intermediates at a time.

Imports nothing but torch: the reference is independent of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CHUNK = 256
# states (L * dim * dstate) per block of batch rows (1.3 GB in float64)
ROW_ELEMS = 160 * 2 ** 20
MAX_RANGE = 1400.0


def _per_row(p, batch, shared_ndim):
    """``p`` in per-row form (batch, ...), float64."""
    p = p.double()
    return p if p.dim() == shared_ndim + 1 else p.expand(
        (batch,) + tuple(p.shape))


def scan_block(u, delta, A, B, C, D, z, delta_bias, delta_softplus,
               initial_state=None):
    """The scan of a block of rows in float64.  u, delta, z: (b, L, d); A:
    (b, d, n); B, C: (b, L, n); D, delta_bias: (b, d) or None; returns (y
    (b, L, d) float64, last state (b, d, n) float64)."""
    b, L, d = u.shape
    n = A.shape[-1]
    dt = delta.double()
    if delta_bias is not None:
        dt = dt + delta_bias[:, None, :]
    if delta_softplus:
        dt = F.softplus(dt)
    uf = u.double()
    K = chunk_for(dt, A)
    nc = max(1, -(-L // K))
    pad = nc * K - L
    padded = lambda x: F.pad(x, [0, 0] * (x.dim() - 2) + [0, pad])
    dtc = padded(dt).reshape(b, nc, K, d)            # padded steps: dt = 0
    a = dtc[..., None] * A[:, None, None]            # (b, nc, K, d, n)
    S = a.cumsum(2)
    lo, hi = S[:, :, -1:], S[:, :, :1]
    m = 0.5 * (lo + hi)
    x = ((dtc * padded(uf).reshape(b, nc, K, d))[..., None]
         * padded(B.double()).reshape(b, nc, K, 1, n))
    hloc = torch.exp(S - m) * torch.cumsum(torch.exp(m - S) * x, 2)
    decay = torch.exp(S[:, :, -1])                   # (b, nc, d, n)
    H = (torch.zeros_like(decay[:, 0]) if initial_state is None
         else initial_state.double())
    starts = []
    for c in range(nc):
        starts.append(H)
        H = decay[:, c] * H + hloc[:, c, -1]
    h = hloc + torch.exp(S) * torch.stack(starts, 1)[:, :, None]
    Cc = padded(C.double()).reshape(b, nc, K, 1, n)
    y = (h * Cc).sum(-1).reshape(b, nc * K, d)[:, :L]
    if D is not None:
        y = y + uf * D[:, None, :]
    if z is not None:
        y = y * F.silu(z.double())
    return y, H


def chunk_for(dt, A):
    """The longest chunk (a power of two up to ``CHUNK``) over which the
    decay's exponent, at most ``K * max |dt A|``, stays within
    ``MAX_RANGE``: the factored sum stays finite in float64 for any
    dt."""
    rate = float((dt.detach().abs().amax() * A.detach().abs().amax()))
    K = CHUNK
    while K > 1 and K * rate > MAX_RANGE:
        K //= 2
    return K


def _blocks(batch, per_row):
    step = max(1, ROW_ELEMS // max(per_row, 1))
    return [slice(i, min(i + step, batch)) for i in range(0, batch, step)]


class _Scan(torch.autograd.Function):
    """The float64 scan over row blocks; the backward recomputes each
    block's graph and differentiates it (inputs: u, delta, A, B, C, D, z,
    delta_bias, all per row; D, z, delta_bias may be None)."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, z, delta_bias, softplus):
        ctx.save_for_backward(u, delta, A, B, C, D, z, delta_bias)
        ctx.softplus = softplus
        out = torch.empty(u.shape, dtype=torch.float64, device=u.device)
        last = torch.empty(A.shape, dtype=torch.float64, device=u.device)
        batch, L, d = u.shape
        for s in _blocks(batch, L * d * A.shape[-1]):
            out[s], last[s] = scan_block(*_rows(s, u, delta, A, B, C, D, z,
                                                delta_bias), softplus)
        ctx.mark_non_differentiable(last)
        return out, last

    @staticmethod
    def backward(ctx, dy, _dlast):
        saved = ctx.saved_tensors
        grads = [None if t is None else torch.zeros_like(t) for t in saved]
        batch, L, d = saved[0].shape
        for s in _blocks(batch, L * d * saved[2].shape[-1]):
            part = [None if t is None else t[s].detach().requires_grad_(
                t.requires_grad) for t in saved]
            with torch.enable_grad():
                y, _ = scan_block(*part, ctx.softplus)
                want = [(i, t) for i, t in enumerate(part)
                        if t is not None and t.requires_grad]
                got = torch.autograd.grad(y, [t for _, t in want], dy[s])
            for (i, _), g in zip(want, got):
                grads[i][s] = g
        return (*grads, None)


def _rows(s, *tensors):
    return [None if t is None else t[s] for t in tensors]


def selective_scan(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                   delta_softplus=False, return_last_state=False):
    """The reference scan, time-major: u, delta, z (batch, L, dim); A
    (dim, dstate) or (batch, dim, dstate); B, C (batch, L, dstate); D,
    delta_bias (dim,) or (batch, dim).  Differentiable; returns y in u's
    dtype (computed in float64), and the float64 last state."""
    batch = u.shape[0]
    A = _per_row(A, batch, 2)
    D = None if D is None else _per_row(D, batch, 1)
    delta_bias = None if delta_bias is None else _per_row(delta_bias, batch,
                                                          1)
    y, last = _Scan.apply(u, delta, A, B, C, D, z, delta_bias,
                          delta_softplus)
    y = y.to(u.dtype)
    return (y, last) if return_last_state else y


def sequential_scan(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                    delta_softplus=False):
    """The same recurrence step by step in float64, for the tests of the
    chunked form."""
    batch, L, d = u.shape
    A = _per_row(A, batch, 2)
    dt = delta.double()
    if delta_bias is not None:
        dt = dt + _per_row(delta_bias, batch, 1)[:, None, :]
    if delta_softplus:
        dt = F.softplus(dt)
    h = torch.zeros(A.shape, dtype=torch.float64, device=u.device)
    ys = []
    for t in range(L):
        h = (torch.exp(dt[:, t, :, None] * A) * h
             + (dt[:, t] * u[:, t].double())[..., None]
             * B[:, t, None, :].double())
        ys.append((h * C[:, t, None, :].double()).sum(-1))
    y = torch.stack(ys, 1)
    if D is not None:
        y = y + u.double() * _per_row(D, batch, 1)[:, None, :]
    if z is not None:
        y = y * F.silu(z.double())
    return y
