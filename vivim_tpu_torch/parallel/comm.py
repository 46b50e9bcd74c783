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
nothing here copies to the host by hand.  ``GATHERED`` counts the
gathers (calls and bytes sent), which ``chip_smoke.py`` prints per step.

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
  an ``all_reduce`` sum of the cotangents (``AllReduceSum``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# all_gather calls of this process and the bytes each rank sent
GATHERED = [0, 0]


def reset_gathered():
    GATHERED[0] = GATHERED[1] = 0


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
    GATHERED[0] += 1
    GATHERED[1] += x.numel() * x.element_size()
    return out.view((n,) + tuple(x.shape))


def all_reduce_sum(x, group):
    """Sum of every rank's ``x`` (a new tensor)."""
    if size(group) == 1:
        return x.clone()
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def all_reduce_mean_(tensors, group):
    """Average a list of tensors over the group in place, through one flat
    fp32 buffer (one collective, whatever the number of tensors)."""
    n = size(group)
    if n == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
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
