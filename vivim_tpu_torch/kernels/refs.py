"""Plain PyTorch versions of the kernels: the ground-truth semantics.

Ports of the JAX package's ``kernels/refs.py``.  They run on any device, are
differentiable through autograd, and are what the CPU takes in place of the
CUDA kernels; on the GPU they are what the kernels are held against.

- ``selective_scan_ref``: first-order linear recurrence
  ``h_t = exp(dt*A) * h_{t-1} + dt*B_t*u_t``, ``y_t = C_t . h_t + D*u_t``,
  gated by ``silu(z)``, computed in fp32 and cast back to the input dtype.
  Vectorised over (batch, dim, dstate); a Python loop walks L.
- ``selective_scan_fwd_states_ref`` / ``selective_scan_bwd_ref``: what the
  training variant of the forward kernel and the backward kernel compute
  (the JAX package's ``_fwd_call(save_cs=True)`` without z and
  ``_bwd_call``): the pre-gate output with the chunk-start states, and the
  eight gradients recomputed chunk by chunk from those states.
- ``selective_scan_chunked_ref``: the forward kernel's chunk-parallel
  passes (local scans from zero, the carry, the re-walk), for the tests.
- ``selective_scan_bwd_segmented_ref``: the backward kernel's
  segment-parallel passes (local reverse walks from zero, the reverse
  carry, the per-segment walk, the sums over segments), for the tests.
- ``selective_scan_ref_cm``: the same scan, channel-major ``(batch, dim,
  L)``, with the reference's signature.
- ``causal_conv1d_ref``: depthwise causal conv of width 2-4, optional SiLU.
- ``causal_conv1d_update_ref`` / ``selective_state_update_ref``: one decode
  step of the conv window and of the SSM state (the streaming LM's step).
- ``mamba_inner_ref``: conv1d -> x_proj -> (dt, B, C) split -> dt_proj ->
  selective scan (z-gated), optionally + out_proj.
- ``dwconv3d_ref`` / ``dwconv3d_bwd_ref``: the 3-D depthwise conv (3x3x3,
  zero padding 1) of channels-last ``(batch, T*H*W, C)`` tokens and its
  three gradients; ``dwconv3d_bwd_tiled_ref``: the backward kernel's
  items, block rows and fixed-order partial sums, for the tests.

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


def selective_scan_ref_cm(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                          delta_softplus=False, return_last_state=False):
    """Channel-major ``(batch, dim, L)`` wrapper of ``selective_scan_ref``
    with the reference signature (selective_scan_interface.py:86-152):
    B / C are (batch, dstate, L), or (dim, dstate) constant."""
    tm = lambda x: x.transpose(1, 2) if x is not None else None
    out = selective_scan_ref(
        tm(u), tm(delta), A, tm(B) if B.dim() == 3 else B,
        tm(C) if C.dim() == 3 else C, D, tm(z), delta_bias, delta_softplus,
        return_last_state)
    if return_last_state:
        y, last = out
        return tm(y), last
    return tm(out)


def _param(p, batch, shared_ndim):
    """fp32 ``p`` broadcast to per-batch form (batch, ...); ``shared_ndim``
    is the rank of its shared form (2 for A, 1 for D / delta_bias)."""
    p = p.float()
    return p if p.dim() == shared_ndim + 1 else p.expand(
        (batch,) + tuple(p.shape))


def _dt(delta, delta_bias, delta_softplus):
    """(pre-softplus delta + bias, dt), fp32 (batch, L, dim)."""
    raw = delta.float()
    if delta_bias is not None:
        raw = raw + _param(delta_bias, delta.shape[0], 1)[:, None, :]
    return raw, (F.softplus(raw) if delta_softplus else raw)


def selective_scan_fwd_states_ref(u, delta, A, B, C, D=None, delta_bias=None,
                                  delta_softplus=False, initial_state=None,
                                  chunk=16):
    """What the training variant of the forward kernel computes (the JAX
    package's ``_fwd_call(..., save_cs=True)`` without z): the pre-gate
    output ``y`` (batch, L, dim) in u's dtype, the fp32 chunk-start states
    (batch, ceil(L / chunk), dim, dstate) — the state before steps 0,
    chunk, 2*chunk, ... — and the fp32 last state (batch, dim, dstate).
    B, C: (batch, L, dstate)."""
    batch, L, dim = u.shape
    _, dt = _dt(delta, delta_bias, delta_softplus)
    A = _param(A, batch, 2)
    uf, Bf, Cf = u.float(), B.float(), C.float()
    h = (u.new_zeros(batch, dim, A.shape[-1], dtype=torch.float32)
         if initial_state is None else initial_state.float())
    states, ys = [], []
    for t in range(L):
        if t % chunk == 0:
            states.append(h)
        h = (torch.exp(dt[:, t, :, None] * A) * h
             + (dt[:, t] * uf[:, t])[..., None] * Bf[:, t, None, :])
        ys.append((h * Cf[:, t, None, :]).sum(-1))
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + uf * _param(D, batch, 1)[:, None, :]
    return y.to(u.dtype), torch.stack(states, dim=1), h


def selective_scan_chunked_ref(u, delta, A, B, C, D=None, z=None,
                               delta_bias=None, delta_softplus=False,
                               initial_state=None, l_chunk=64, chunk=16,
                               save_states=False):
    """The chunk-parallel decomposition the forward kernel runs, in plain
    PyTorch: a model of its three passes for the tests (no code path calls
    it).  L is cut into chunks of ``l_chunk`` steps (a multiple of
    ``chunk``; the last one shorter):

    A. every chunk is scanned from a zero state: its local end state
       ``hloc_k`` and ``S_k``, the sum of its dt;
    B. the carry: ``H_0 = initial_state or 0``,
       ``H_{k+1} = exp(A * S_k) * H_k + hloc_k``, the start of chunk k + 1;
    C. every chunk is re-walked from ``H_k``: the output, the state before
       every ``chunk``-th step, and the last state.

    Returns ``(out, last)``, or with ``save_states`` (no z, the training
    variant) ``(out, chunk_states, last)`` as
    ``selective_scan_fwd_states_ref`` does.  B, C: (batch, L, dstate)."""
    if l_chunk <= 0 or l_chunk % chunk:
        raise ValueError(f"l_chunk {l_chunk} is not a multiple of {chunk}")
    if save_states and z is not None:
        raise ValueError("the training variant takes no z")
    batch, L, dim = u.shape
    _, dt = _dt(delta, delta_bias, delta_softplus)
    A = _param(A, batch, 2)
    uf = u.float()
    nk = max(1, -(-L // l_chunk))
    pad = nk * l_chunk - L

    def chunks(x):  # (b, L, ...) -> (b, nk, l_chunk, ...); padding is masked
        x = F.pad(x.float(), [0, 0] * (x.dim() - 2) + [0, pad])
        return x.reshape((batch, nk, l_chunk) + tuple(x.shape[2:]))

    dtc, uc, Bc, Cc = chunks(dt), chunks(uf), chunks(B), chunks(C)
    valid = (torch.arange(nk * l_chunk, device=u.device) < L).reshape(
        nk, l_chunk)

    def step(h, j):  # step j of every chunk at once; h: (b, nk, d, n)
        a = torch.exp(dtc[:, :, j, :, None] * A[:, None])
        bu = (dtc[:, :, j] * uc[:, :, j])[..., None] * Bc[:, :, j, None, :]
        return torch.where(valid[None, :, j, None, None], a * h + bu, h)

    h = u.new_zeros((batch, nk, dim, A.shape[-1]), dtype=torch.float32)
    for j in range(l_chunk):  # pass A
        h = step(h, j)
    S = (dtc * valid[None, :, :, None]).sum(2)
    H = (torch.zeros_like(h[:, 0]) if initial_state is None
         else initial_state.float())
    starts = []
    for k in range(nk):  # pass B
        starts.append(H)
        H = torch.exp(A * S[:, k, :, None]) * H + h[:, k]
    h = torch.stack(starts, 1)
    ys, states = [], []
    for j in range(l_chunk):  # pass C
        if j % chunk == 0:
            states.append(h)
        h = step(h, j)
        ys.append((h * Cc[:, :, j, None, :]).sum(-1))
    y = torch.stack(ys, 2).reshape(batch, nk * l_chunk, dim)[:, :L]
    if D is not None:
        y = y + uf * _param(D, batch, 1)[:, None, :]
    if z is not None:
        y = y * F.silu(z.float())
    last = h[:, -1]
    if not save_states:
        return y.to(u.dtype), last
    cs = torch.stack(states, 2).reshape(
        batch, nk * (l_chunk // chunk), dim, -1)[:, :-(-L // chunk)]
    return y.to(u.dtype), cs, last


def selective_scan_bwd_ref(u, delta, A, B, C, D, delta_bias, chunk_states,
                           dout, dlast=None, delta_softplus=False, chunk=16):
    """What the backward kernel computes (the JAX package's ``_bwd_call``):
    from the forward's inputs, its chunk-start states, the cotangent
    ``dout`` of the pre-gate output and ``dlast`` of the last state (None =
    0), the eight gradients (ddelta, du, dB, dC) in the activation dtype and
    per batch row in fp32 (dA (batch, dim, dstate), dD, dbias (batch, dim),
    dh0 (batch, dim, dstate)).

    It walks the chunks right to left, recomputes the states inside each
    chunk from its saved start state, and carries the adjoint
    g_t = C_t dy_t + a_{t+1} g_{t+1} backward, as the kernel does.  D and
    delta_bias may be None (zero)."""
    batch, L, dim = u.shape
    raw, dt = _dt(delta, delta_bias, delta_softplus)
    A = _param(A, batch, 2)
    Dk = (torch.zeros(batch, dim, device=u.device) if D is None
          else _param(D, batch, 1))
    uf, Bf, Cf, dy = u.float(), B.float(), C.float(), dout.float()
    g = torch.zeros_like(A) if dlast is None else dlast.float().clone()
    dA = torch.zeros_like(A)
    ddt = torch.empty_like(uf)
    du = torch.empty_like(uf)
    dB = torch.empty_like(Bf)
    dC = torch.empty_like(Cf)
    for k in reversed(range(chunk_states.shape[1])):
        t0, t1 = k * chunk, min(L, (k + 1) * chunk)
        hs = [chunk_states[:, k]]
        for t in range(t0, t1):
            hs.append(torch.exp(dt[:, t, :, None] * A) * hs[-1]
                      + (dt[:, t] * uf[:, t])[..., None] * Bf[:, t, None, :])
        for t in reversed(range(t0, t1)):
            a = torch.exp(dt[:, t, :, None] * A)
            g = g + Cf[:, t, None, :] * dy[:, t, :, None]
            gB = (g * Bf[:, t, None, :]).sum(-1)
            dla = g * hs[t - t0] * a
            du[:, t] = dt[:, t] * gB + Dk * dy[:, t]
            ddt[:, t] = uf[:, t] * gB + (dla * A).sum(-1)
            dB[:, t] = (g * (dt[:, t] * uf[:, t])[..., None]).sum(1)
            dC[:, t] = (hs[t - t0 + 1] * dy[:, t, :, None]).sum(1)
            dA += dla * dt[:, t, :, None]
            g = a * g
    ddelta = ddt * torch.sigmoid(raw) if delta_softplus else ddt
    dD = (dy * uf).sum(1)
    dbias = ddelta.sum(1)
    act = u.dtype
    return (ddelta.to(act), du.to(act), dB.to(act), dC.to(act), dA, dD,
            dbias, g)


def selective_scan_bwd_segmented_ref(u, delta, A, B, C, D, delta_bias,
                                     chunk_states, dout, dlast=None,
                                     delta_softplus=False, l_seg=64,
                                     chunk=16):
    """The segment-parallel decomposition the backward kernel runs, in
    plain PyTorch: a model of its four passes for the tests (no code path
    calls it).  L is cut into segments of ``l_seg`` steps (a multiple of
    ``chunk``, so each starts on a chunk state; the last one shorter), and
    ``GA_k`` is the adjoint carry ``a_{t+1} g_{t+1}`` that enters segment k
    from its right edge:

    A. every segment walks its steps right to left from a zero carry:
       ``gloc_k``, the carry that leaves its left edge, and ``S_k``, the
       sum of its dt (the kernel skips segment 0, whose result is unused);
    B. the carry, right to left: ``GA_last = dlast or 0``,
       ``GA_{k-1} = gloc_k + exp(A * S_k) * GA_k``;
    C. every segment walks its chunks right to left from ``GA_k``,
       recomputing the states from the chunk-start states: the sequence
       grads, and per-segment partials of dA, dD and dbias; dh0 is the
       carry that leaves segment 0;
    D. the parameter partials summed over the segments in segment order.

    Returns what ``selective_scan_bwd_ref`` returns.  dB and dC sum over d
    directly (the kernel's per-block partials are a split of d, not of
    L)."""
    if l_seg <= 0 or l_seg % chunk:
        raise ValueError(f"l_seg {l_seg} is not a multiple of {chunk}")
    batch, L, dim = u.shape
    raw, dt = _dt(delta, delta_bias, delta_softplus)
    A = _param(A, batch, 2)
    Dk = (torch.zeros(batch, dim, device=u.device) if D is None
          else _param(D, batch, 1))
    nk = max(1, -(-L // l_seg))
    pad = nk * l_seg - L

    def segs(x):  # (b, L, ...) -> (b, nk, l_seg, ...); padding has dt = 0
        x = F.pad(x.float(), [0, 0] * (x.dim() - 2) + [0, pad])
        return x.reshape((batch, nk, l_seg) + tuple(x.shape[2:]))

    dtc, uc, Bc, Cc, dyc = segs(dt), segs(u), segs(B), segs(C), segs(dout)
    valid = (torch.arange(nk * l_seg, device=u.device) < L).reshape(
        nk, l_seg)
    Ak = A[:, None]  # (b, 1, d, n)
    decay = lambda j: torch.exp(dtc[:, :, j, :, None] * Ak)
    inject = lambda j: Cc[:, :, j, None, :] * dyc[:, :, j, :, None]

    ga = torch.zeros((batch, nk) + tuple(A.shape[1:]), device=u.device)
    for j in reversed(range(l_seg)):  # pass A (padded steps: a = 1, no C dy)
        ga = decay(j) * (ga + inject(j))
    S = (dtc * valid[None, :, :, None]).sum(2)
    GA = torch.zeros_like(A) if dlast is None else dlast.float()
    seeds = [None] * nk
    for k in reversed(range(nk)):  # pass B
        seeds[k] = GA
        GA = ga[:, k] + torch.exp(A * S[:, k, :, None]) * GA
    g = torch.stack(seeds, 1)

    per = l_seg // chunk  # pass C: chunk states per segment
    cs = F.pad(chunk_states.float(),
               [0, 0, 0, 0, 0, nk * per - chunk_states.shape[1]])
    cs = cs.reshape((batch, nk, per) + tuple(cs.shape[2:]))
    ddt, du = torch.zeros_like(dtc), torch.zeros_like(dtc)
    dB, dC = torch.zeros_like(Bc), torch.zeros_like(Cc)
    dA = torch.zeros_like(g)
    for q in reversed(range(per)):
        j0 = q * chunk
        hs = [cs[:, :, q]]
        for j in range(j0, j0 + chunk):
            hs.append(decay(j) * hs[-1] + (dtc[:, :, j] * uc[:, :, j])[
                ..., None] * Bc[:, :, j, None, :])
        for j in reversed(range(j0, j0 + chunk)):
            a = decay(j)
            g = g + inject(j)
            gB = (g * Bc[:, :, j, None, :]).sum(-1)
            dla = g * hs[j - j0] * a
            du[:, :, j] = dtc[:, :, j] * gB + Dk[:, None] * dyc[:, :, j]
            ddt[:, :, j] = uc[:, :, j] * gB + (dla * Ak).sum(-1)
            dB[:, :, j] = (g * (dtc[:, :, j] * uc[:, :, j])[..., None]).sum(2)
            dC[:, :, j] = (hs[j - j0 + 1] * dyc[:, :, j, :, None]).sum(2)
            dA = dA + dla * dtc[:, :, j, :, None]
            g = a * g
    ddt = ddt * valid[None, :, :, None]
    if delta_softplus:
        ddt = ddt * torch.sigmoid(segs(raw))

    def in_order(part):  # pass D: segment 0, then 1, ...
        total = part[:, 0]
        for k in range(1, nk):
            total = total + part[:, k]
        return total

    dA, dD, dbias = (in_order(p) for p in (dA, (dyc * uc).sum(2),
                                           ddt.sum(2)))
    unseg = lambda x: x.reshape((batch, nk * l_seg) + tuple(x.shape[3:]))[
        :, :L]
    act = u.dtype
    return (unseg(ddt).to(act), unseg(du).to(act), unseg(dB).to(act),
            unseg(dC).to(act), dA, dD, dbias, g[:, 0])


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


def causal_conv1d_update_ref(x, conv_state, weight, bias=None,
                             activation=None):
    """One streaming step of the depthwise causal conv: roll the window,
    append x, dot it with the weight (causal_conv1d_interface.py:83-105).
    The sum runs in the weight's dtype, as ``causal_conv1d_ref`` does.

    x: (batch, dim); conv_state: (batch, width, dim); weight: (width, dim).
    Returns (out (batch, dim) in x.dtype, new_conv_state (batch, width,
    dim)).
    """
    if activation not in (None, "silu", "swish"):
        raise NotImplementedError("activation must be None, silu, or swish")
    conv_state = torch.cat([conv_state[:, 1:], x[:, None]], dim=1)
    out = (conv_state * weight).sum(1)
    if bias is not None:
        out = out + bias
    if activation is not None:
        out = F.silu(out)
    return out.to(x.dtype), conv_state


def selective_state_update_ref(state, x, dt, A, B, C, D=None, z=None,
                               dt_bias=None, dt_softplus=False):
    """One token of the SSM recurrence, in fp32
    (ops/triton/selective_state_update.py:157-192):
    ``state' = state * exp(dt*A) + dt*B*x``, ``out = C . state' + D*x``,
    ``out * silu(z)``.

    state: (batch, dim, dstate); x, dt, z: (batch, dim); A: (dim, dstate);
    B, C: (batch, dstate); D, dt_bias: (dim,).  Returns (out (batch, dim)
    in x.dtype, new_state in state.dtype).
    """
    dt = dt.float()
    if dt_bias is not None:
        dt = dt + dt_bias.float()
    if dt_softplus:
        dt = F.softplus(dt)
    xf = x.float()
    dA = torch.exp(dt[:, :, None] * A.float())
    dB = dt[:, :, None] * B.float()[:, None, :]
    new_state = state.float() * dA + dB * xf[:, :, None]
    out = (new_state * C.float()[:, None, :]).sum(-1)
    if D is not None:
        out = out + D.float() * xf
    if z is not None:
        out = out * F.silu(z.float())
    return out.to(x.dtype), new_state.to(state.dtype)


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


def dwconv3d_ref(x, weight, bias, T, H, W):
    """3-D depthwise conv (3x3x3, stride 1, zero padding 1, groups = C) of
    ``(batch, T*H*W, C)`` channels-last tokens over (T, H, W), by
    ``F.conv3d`` in x's dtype; weight ``(C, 1, 3, 3, 3)``, bias ``(C,)`` or
    None.  Returns the tokens' layout."""
    batch, N, C = x.shape
    xv = x.reshape(batch, T, H, W, C).permute(0, 4, 1, 2, 3)
    y = F.conv3d(xv, weight, bias, padding=1, groups=C)
    return y.permute(0, 2, 3, 4, 1).reshape(batch, N, C)


def _dwconv3d_taps(x, T, H, W):
    """Tap (i, j, k) of ``(batch, T*H*W, C)`` tokens, for i, j, k in
    row-major order: the ``(batch, T, H, W, C)`` view of x[b, t+i-1, h+j-1,
    w+k-1, c], 0 outside the frame."""
    batch, _, C = x.shape
    xp = F.pad(x.reshape(batch, T, H, W, C), (0, 0, 1, 1, 1, 1, 1, 1))
    for i in range(3):
        for j in range(3):
            for k in range(3):
                yield xp[:, i:i + T, j:j + H, k:k + W]


def dwconv3d_bwd_ref(x, dy, weight, T, H, W, with_bias=True):
    """The conv's gradients: (dx, dweight ``(C, 1, 3, 3, 3)``, dbias or
    None).  dx is the same conv of dy with the taps mirrored and no bias;
    dweight's tap (i, j, k) is the sum of dy times x's tap (i, j, k); dbias
    the sum of dy."""
    batch, N, C = x.shape
    dx = dwconv3d_ref(dy, weight.flip((2, 3, 4)), None, T, H, W)
    dy5 = dy.reshape(batch, T, H, W, C)
    dweight = torch.stack([(dy5 * tap).sum((0, 1, 2, 3))
                           for tap in _dwconv3d_taps(x, T, H, W)], 1)
    dbias = dy.sum((0, 1)) if with_bias else None
    return dx, dweight.reshape(C, 1, 3, 3, 3), dbias


def dwconv3d_bwd_tiled_ref(x, dy, weight, T, H, W, rows, items_per_step,
                           with_bias=True):
    """The backward kernel's decomposition, in plain PyTorch: a model for
    the tests (no code path calls it).  An item is the W outputs of one
    (b, t, h) row, items numbered in (b, t, h) order.  A block row steps
    through groups of ``items_per_step`` items: row r takes the groups r,
    r + rows, r + 2 rows, ..., its thread y the y-th item of each.

    - dx: each output's sum over the mirrored taps, k outer and (i, j)
      inner, the order in which the kernel's walk along w adds them;
    - a thread's partials of dweight's 27 taps and of dbias: its items'
      sums, item after item;
    - the block row's partial: its threads' summed in y order, one
      ``(rows, 28, C)`` buffer;
    - dweight and dbias: the rows summed in row order.

    Returns what ``dwconv3d_bwd_ref`` returns."""
    batch, N, C = x.shape
    mirrored = weight.reshape(C, 27).flip(1)
    dyt = list(_dwconv3d_taps(dy, T, H, W))
    dx = torch.zeros_like(dy).reshape(batch, T, H, W, C)
    for k in range(3):
        for ij in range(9):
            dx = dx + mirrored[:, 3 * ij + k] * dyt[3 * ij + k]
    dy5 = dy.reshape(batch, T, H, W, C)
    per_item = lambda v: v.sum(3).reshape(-1, C)  # each row's sum over w
    items = torch.stack([per_item(dy5 * tap) for tap in
                         _dwconv3d_taps(x, T, H, W)] + [per_item(dy5)], 1)
    groups = -(-items.shape[0] // items_per_step)
    steps = -(-groups // rows)
    items = F.pad(items, (0, 0, 0, 0, 0, steps * rows * items_per_step
                          - items.shape[0]))
    items = items.reshape(steps, rows, items_per_step, 28, C)
    threads = items[0]
    for s in range(1, steps):  # each thread's items, in order
        threads = threads + items[s]
    part = threads[:, 0]
    for y in range(1, items_per_step):  # the block's threads, in y order
        part = part + threads[:, y]
    total = part[0]
    for r in range(1, rows):  # the block rows, in row order
        total = total + part[r]
    return (dx.reshape(batch, N, C), total[:27].t().reshape(C, 1, 3, 3, 3),
            total[27] if with_bias else None)
