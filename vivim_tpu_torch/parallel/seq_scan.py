"""Sequence-sharded selective scan over the ``seq`` axis of a mesh.

Port of the JAX package's ``parallel/seq_scan.py``, the SSM analogue of
ring attention, for clips too long for one card: the L axis of a scan is
cut into S contiguous shards, one per rank of the ``seq`` group, and the
(batch, dim, dstate) scan state is carried across ranks.
``seq_sharded_selective_scan_local`` is the body (the JAX function of that
name): each rank holds only its (batch, L/S, ·) shards of u, delta, B, C
and z, as the sequence-sharded Mamba layers before it made them
(``nn/mamba.py``), and gets its shard of the output back.
``seq_sharded_selective_scan`` is the whole-in / whole-out wrapper (the
JAX ``shard_map`` island): slice, the body, gather.  ``delta_softplus`` is
always on (the only mode Vivim uses).

Forward, with the carry of shard k ``(a_k, h_k)``: ``a_k = exp(A * sum_t
softplus(delta_t + bias))`` over the shard, ``h_k`` its last state scanned
from zero; the true state at the end of shard k is ``H_k = a_k * H_{k-1}
+ h_k`` (the pair rule ``(a2, b2) o (a1, b1) = (a1 a2, a2 b1 + b2)``):
1. every shard but the last scans from zero for ``h_k``: shard 0's scan is
   already its true one (K1's training variant under autograd, which keeps
   the chunk states for K2; the inference variant otherwise), a middle
   shard's is the inference K1 without z (only its last state is used);
2. one all_gather of the (S, 2, batch, dim, dstate) carries, and an
   exclusive prefix gives shard k its initial state ``H_{k-1}``;
3. every shard but the first scans again from ``H_{k-1}``: its true scan;
   the global last state is the last shard's, broadcast when asked for.

Backward, in one ``torch.autograd.Function``, from the cotangent of this
rank's output shard.  K2's adjoint of the initial state is linear in the
adjoint ``G_k`` of the shard's last state: ``dh0 = dh0|_{G=0} + a_k G_k``.
So:
a. every shard but the first runs K2 for the adjoint it sends left: the
   last shard from the global last state's cotangent (its gradients are
   then final, and its ``dh0`` is ``G_{S-2}``), a middle shard from a zero
   ``G`` (only its ``dh0`` is used);
b. one all_gather of those (S, batch, dim, dstate) adjoints; shard k sums
   ``G_k`` right to left, ``G_{j-1} = dh0_j + a_j G_j``;
c. every shard but the last runs K2 from ``G_k``: its true gradients.
The gradients of A, D and delta_bias are summed over the ``seq`` group
(the JAX ``shard_map`` transpose of a replicated input); those of u,
delta, B, C and z are this rank's shards'.  Launches per scan and rank:
with S = 2, one K1-training and one K2 on each rank (one inference K1 in a
forward without autograd); a middle shard (S > 2) adds one inference K1
and one K2.

The JAX module picks a batch axis inside its island on a hybrid ("data",
"seq") mesh; here a data rank holds its own block of the batch already, so
the body sees that block, and the ``seq`` group is the one collective
group of the scan.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vivim_tpu_torch.kernels import refs
from vivim_tpu_torch.kernels import selective_scan as ss
from vivim_tpu_torch.parallel import comm


def _carry_decay(delta, A, delta_bias):
    """exp(A * sum_t softplus(delta_t + bias)): (batch, dim, dstate) fp32."""
    raw = delta.float()
    if delta_bias is not None:
        bias = delta_bias.float()
        raw = raw + (bias[:, None, :] if bias.dim() == 2 else bias)
    total = F.softplus(raw).sum(1)                       # (batch, dim)
    Af = A.float()
    return torch.exp((Af if Af.dim() == 3 else Af[None]) * total[..., None])


def _scan_train(plain, u, delta, A, B, C, D, bias, h0):
    """K1-training (or its plain version): (pre-gate out, states, last)."""
    if plain:
        return refs.selective_scan_fwd_states_ref(
            u, delta, A, B, C, D, bias, True, h0, chunk=ss.CHUNK)
    return ss.selective_scan_fwd_states_cuda(u, delta, A, B, C, D, bias,
                                             True, h0)


def _scan_infer(plain, u, delta, A, B, C, D, z, bias, h0):
    """The inference K1 (or its plain version): (out, last)."""
    if plain:
        return refs.selective_scan_ref(u, delta, A, B, C, D, z, bias, True,
                                       True, initial_state=h0)
    return ss.selective_scan_fwd_cuda(u, delta, A, B, C, D, z, bias, True,
                                      h0)


def _scan_bwd(plain, u, delta, A, B, C, D, bias, cs, dout, dlast):
    if plain:
        return refs.selective_scan_bwd_ref(u, delta, A, B, C, D, bias, cs,
                                           dout, dlast, True, chunk=ss.CHUNK)
    return ss.selective_scan_bwd_cuda(u, delta, A, B, C, D, bias, cs, dout,
                                      dlast, True)


def _shard_forward(u, delta, A, B, C, D, z, bias, group, plain, train,
                   want_last):
    """Steps 1-3 of the forward on this rank's shards; returns (y, last or
    None, saved), where ``saved`` holds what the backward needs under
    autograd."""
    n, k = comm.size(group), comm.rank(group)
    first, last_shard = k == 0, k == n - 1

    h_loc = cs = y_pre = y = last = None
    if first:
        if train:
            y_pre, cs, last = _scan_train(plain, u, delta, A, B, C, D, bias,
                                          None)
        else:
            y, last = _scan_infer(plain, u, delta, A, B, C, D, z, bias, None)
        h_loc = last
    elif not last_shard:
        _, h_loc = _scan_infer(plain, u, delta, A, B, C, D, None, bias, None)
    a_loc = _carry_decay(delta, A, bias)
    carries = comm.all_gather(torch.stack(
        [a_loc, torch.zeros_like(a_loc) if h_loc is None
         else h_loc.float()]), group)                    # (S, 2, b, d, N)
    if not first:
        h_in = carries[0, 1]
        for j in range(1, k):
            h_in = carries[j, 0] * h_in + carries[j, 1]
        if train:
            y_pre, cs, last = _scan_train(plain, u, delta, A, B, C, D, bias,
                                          h_in)
        else:
            y, last = _scan_infer(plain, u, delta, A, B, C, D, z, bias, h_in)
    if train:
        y = y_pre
        if z is not None:
            y = (y_pre.float() * F.silu(z.float())).to(y_pre.dtype)
    glob = None
    if want_last:
        glob = comm.broadcast_(last.float().contiguous(), n - 1, group)
    saved = (cs, y_pre, carries[:, 0]) if train else None
    return y, glob, saved


class SeqShardedScanFn(torch.autograd.Function):
    """The sharded scan under autograd on this rank's shards: forward steps
    1-3, backward a-c of the module docstring.  Returns (this rank's y,
    global last state or None)."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, z, delta_bias, group, plain,
                want_last):
        y, last, (cs, y_pre, decays) = _shard_forward(
            u, delta, A, B, C, D, z, delta_bias, group, plain, True,
            want_last)
        ctx.save_for_backward(u, delta, A, B, C, D, z, delta_bias, cs,
                              y_pre, decays)
        ctx.group, ctx.plain = group, plain
        ctx.set_materialize_grads(False)
        return y, last

    @staticmethod
    def backward(ctx, dy, dlast):
        u, delta, A, B, C, D, z, bias, cs, y_pre, decays = ctx.saved_tensors
        group, plain = ctx.group, ctx.plain
        n, k = comm.size(group), comm.rank(group)
        dout = torch.zeros_like(y_pre) if dy is None else dy
        dz = None
        if z is not None:  # the gate's grads; K2 sees the pre-gate cotangent
            zf = z.float()
            sig = torch.sigmoid(zf)
            silu = zf * sig
            doutf = dout.float()
            dz = (doutf * y_pre.float() * (sig + silu * (1.0 - sig))).to(
                z.dtype)
            dout = doutf * silu
        dout = dout.to(u.dtype)
        bwd = lambda g: _scan_bwd(plain, u, delta, A, B, C, D, bias, cs,
                                  dout, g)
        grads = None
        sent = torch.zeros_like(decays[0])
        if k > 0:  # (a): the adjoint this shard sends left
            g_a = bwd(dlast if k == n - 1 else None)
            sent = g_a[7]
            if k == n - 1:
                grads = g_a
        adj = comm.all_gather(sent.float(), group)       # (S, b, d, N)
        if k < n - 1:  # (b), (c): this shard's G_k, then its gradients
            g = adj[n - 1]
            for j in range(n - 2, k, -1):
                g = adj[j] + decays[j] * g
            grads = bwd(g)
        ddelta, du, dB, dC, dA, dD, dbias, _ = grads
        # parameter grads: per batch row from K2; shared forms sum the rows,
        # and every shard's part is summed over the seq group
        if A.dim() == 2:
            dA = dA.sum(0)
        if D is not None and D.dim() == 1:
            dD = dD.sum(0)
        if bias is not None and bias.dim() == 1:
            dbias = dbias.sum(0)
        pgrads = [dA] + ([dD] if D is not None else []) + (
            [dbias] if bias is not None else [])
        flat = comm.all_reduce_sum(torch.cat([g.float().reshape(-1)
                                              for g in pgrads]), group)
        out, i = [], 0
        for g in pgrads:
            out.append(flat[i:i + g.numel()].view_as(g))
            i += g.numel()
        dA = out[0].to(A.dtype)
        dD = out[1].to(D.dtype) if D is not None else None
        dbias = out[-1].to(bias.dtype) if bias is not None else None
        # activation grads: this rank's shard's, as its inputs are
        return (du.to(u.dtype), ddelta.to(delta.dtype), dA, dB.to(B.dtype),
                dC.to(C.dtype), dD, dz, dbias, None, None, None)


def seq_sharded_selective_scan_local(
    u, delta, A, B, C, D=None, z=None, delta_bias=None, group=None,
    implementation=None, return_last_state=True,
):
    """The body: u, delta, B, C and z are this rank's (batch, L/S, ·)
    shards of the ``group``'s sequence; returns this rank's (batch, L/S,
    dim) output and the global last state (None unless
    ``return_last_state``).  The gradients of u, delta, B, C and z are this
    rank's shards'; those of A, D and delta_bias are summed over the group.
    The kernels run on CUDA tensors, their plain versions on CPU ones or
    with ``implementation="ref"``.  A is (dim, dstate) or per batch (batch,
    dim, dstate); D and delta_bias (dim,) or (batch, dim)."""
    if B.dim() != 3 or C.dim() != 3:
        raise ValueError("the sharded scan takes (batch, L, dstate) B and C")
    plain = implementation == "ref" or not u.is_cuda
    if ss._needs_grad(u, delta, A, B, C, D, z, delta_bias):
        return SeqShardedScanFn.apply(u, delta, A, B, C, D, z, delta_bias,
                                      group, plain, return_last_state)
    with torch.no_grad():
        y, last, _ = _shard_forward(u, delta, A, B, C, D, z, delta_bias,
                                    group, plain, False, return_last_state)
    return y, last


def seq_sharded_selective_scan(
    u, delta, A, B, C, D=None, z=None, delta_bias=None, mesh=None,
    axis_name: str = "seq", implementation=None, return_last_state=True,
):
    """The whole (batch, L, dim) output and the global last state (None
    unless ``return_last_state``) of the scan with L sharded over
    ``mesh``'s ``axis_name`` group, from whole (replicated) inputs; L
    divides by the group's size.  Each rank takes its shards
    (``comm.seq_shard``: the backward gathers their cotangents in one
    collective), runs ``seq_sharded_selective_scan_local`` and gathers the
    output (``comm.seq_gather_replicated``)."""
    group = mesh.group(axis_name)
    n = comm.size(group)
    if u.shape[1] % n:
        raise ValueError(f"L={u.shape[1]} does not divide over {n} shards")
    seqs = [u, delta, B, C] + ([z] if z is not None else [])
    parts = comm.seq_shard(group, *seqs)
    ul, dl, Bl, Cl = parts[:4]
    y, last = seq_sharded_selective_scan_local(
        ul, dl, A, Bl, Cl, D=D, z=parts[4] if z is not None else None,
        delta_bias=delta_bias, group=group, implementation=implementation,
        return_last_state=return_last_state)
    return comm.seq_gather_replicated(y, group), last
