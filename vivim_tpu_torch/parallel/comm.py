"""The collectives of the parallel paths, the one place that calls
``torch.distributed``.

Each function takes a process group (one axis of a ``mesh.Mesh``) and
works for any group size; a group of None is this process alone, and the
function is then the identity.

The same calls serve NCCL and gloo: ``all_gather_into_tensor``,
``all_reduce`` and ``broadcast``.  gloo is a host library: it runs its
collectives of CUDA tensors through host memory itself (torch 2.11 on the
H100 gathers, reduce-scatters, all-reduces and broadcasts CUDA tensors
over gloo; ``chip_smoke.py`` probes each and prints what it finds), so
nothing here copies to the host by hand.  gloo's point-to-point calls do
not take CUDA tensors: on the H100 (torch 2.11) ``send`` / ``recv`` and
``batch_isend_irecv`` of them each fail with "writev: Bad address" or
abort the process (``chip_smoke.py`` probes both, each in its own
processes), so ``ppermute`` takes a gather on that pair (its docstring).  The counters,
which ``chip_smoke.py`` prints per step and per token: ``GATHERED``
(all_gather calls and the bytes each rank sent), ``REDUCED`` (all_reduce
calls and bytes) and ``HOPPED`` (``ppermute`` calls and the bytes this
rank sent).

The adjoint convention of the parallel paths, stated once:
- every rank backpropagates its own copy of the loss, and the gradients
  are then averaged over the ``data`` axis, never summed over ``seq`` (the
  ranks of one ``seq`` row hold equal copies; the steps average over them
  too, which changes nothing in exact arithmetic and keeps the copies
  bitwise equal);
- the adjoint of gathering an activation that every rank of the group goes
  on to use in the same way (a replicated activation) is this rank's own
  slice of the cotangent, not a sum over the ranks; the adjoint of taking
  this rank's slice of a replicated input is the gather of the slices'
  cotangents.  (``torch.distributed.nn.functional.all_gather``'s backward
  sums, and would count the gradient once per rank.)
- the adjoint of an ``all_reduce`` sum that every rank goes on to use is
  an ``all_reduce`` sum of the cotangents (``AllReduceSum``) when each
  rank's use of it reaches the loss through its own part of the model (the
  tensor-parallel x_proj output: each rank's channels read dt, B and C),
  and the identity when the sum is replicated onward, since every rank's
  copy of the loss then gives the whole cotangent (``reduce_from_model``,
  Megatron's g);
- the adjoint of a replicated input that each rank's part of the model
  reads (the tensor-parallel mixer's input, the pipeline's microbatches)
  is the sum of the ranks' partial cotangents (``copy_to_model``,
  Megatron's f).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# all_gather calls of this process and the bytes each rank sent
GATHERED = [0, 0]
# all_reduce calls of this process and the bytes of each rank's tensor
REDUCED = [0, 0]
# ppermute calls of this process and the bytes this rank sent
HOPPED = [0, 0]


def reset_counters():
    for c in (GATHERED, REDUCED, HOPPED):
        c[0] = c[1] = 0


def _count(counter, nbytes):
    counter[0] += 1
    counter[1] += nbytes


def world():
    """The group of every rank of the run (None without one)."""
    return dist.group.WORLD if dist.is_initialized() else None


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_gather(x, group):
    """(n, *x.shape): every rank's ``x`` stacked in group-rank order."""
    n = size(group)
    if n == 1:
        return x[None]
    x = x.contiguous().reshape((-1,) + tuple(x.shape[1:]))
    # concatenated along dim 0, the layout every backend takes
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    _count(GATHERED, x.numel() * x.element_size())
    return out.view((n,) + tuple(x.shape))


def all_reduce_sum(x, group):
    """Sum of every rank's ``x`` (a new tensor)."""
    if size(group) == 1:
        return x.clone()
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    _count(REDUCED, out.numel() * out.element_size())
    return out


def all_reduce_mean_(tensors, group):
    """Average a list of tensors over the group in place, through one flat
    fp32 buffer (one collective, whatever the number of tensors)."""
    n = size(group)
    if n == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    _count(REDUCED, flat.numel() * flat.element_size())
    flat /= n
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


def broadcast_(x, src_rank, group):
    """Overwrite ``x`` with group rank ``src_rank``'s ``x``, in place."""
    if size(group) > 1:
        dist.broadcast(x, src=dist.get_global_rank(group, src_rank),
                       group=group)
    return x


class AllReduceSum(torch.autograd.Function):
    """Differentiable sum over the group: its backward sums the
    cotangents, since every rank's loss reads the sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x, group):
    """``x`` as it is; the backward sums the cotangents over the group
    (Megatron's f): for a replicated input of which each rank's part of the
    model gives only a partial cotangent."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    """The sum of every rank's ``x``; the backward passes the cotangent on
    as it is (Megatron's g): for a sum that every rank then uses in the same
    way, so that each rank's copy of the loss holds its whole cotangent."""
    return _ReduceFromModel.apply(x, group)


def _hop(x, perm, group):
    x = x.contiguous()
    dsts = [d for s, d in perm if s == rank(group)]
    _count(HOPPED, x.numel() * x.element_size() * len(dsts))
    if size(group) == 1:
        return x.clone() if dsts else torch.zeros_like(x)
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return _hop_gather(x, perm, group)
    return _hop_p2p(x, perm, group)


def _hop_p2p(x, perm, group):
    me = rank(group)
    out = torch.zeros_like(x)
    peer = lambda r: dist.get_global_rank(group, r)
    ops = [dist.P2POp(dist.isend, x, peer(d), group)
           for s, d in perm if s == me]
    ops += [dist.P2POp(dist.irecv, out, peer(s), group)
            for s, d in perm if d == me]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


def _hop_gather(x, perm, group):
    """Every rank's ``x`` through one all_gather, of which this rank keeps
    its source's: gloo sends host memory only (module docstring)."""
    srcs = [s for s, d in perm if d == rank(group)]
    n = size(group)
    every = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                        dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(every, x, group=group)
    every = every.view((n,) + tuple(x.shape))
    return every[srcs[0]].clone() if srcs else torch.zeros_like(x)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return _hop(x, perm, group)

    @staticmethod
    def backward(ctx, g):
        return _hop(g, tuple((d, s) for s, d in ctx.perm), ctx.group), \
            None, None


def ppermute(x, perm, group):
    """``jax.lax.ppermute``: each (src, dst) pair of group ranks in
    ``perm`` sends src's ``x`` to dst; a rank that no pair sends to gets
    zeros.  The backward sends the cotangents along the inverse pairs.

    The route: ``batch_isend_irecv`` (NCCL, and gloo on CPU tensors);
    with gloo and CUDA tensors one ``all_gather_into_tensor`` of every
    rank's ``x`` instead, of which each rank keeps its source's (gloo's
    point-to-point calls take host memory only).  ``HOPPED`` counts the
    call and the bytes this rank sends to its destinations."""
    return _PPermute.apply(x, tuple(perm), group)
