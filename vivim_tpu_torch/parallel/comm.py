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
processes), so ``ppermute`` takes a gather on that pair (its docstring),
and so does every exchange of the sequence-sharded layers.  The counters,
which ``chip_smoke.py`` prints per step and per token: ``GATHERED``
(all_gather calls and the bytes each rank sent), ``REDUCED`` (all_reduce
calls and bytes), ``HOPPED`` (``ppermute`` calls and the bytes this
rank sent; the sequence-sharded layers' conv halos) and ``SEQ`` (each
other exchange of those layers, forward and backward: calls and the bytes
this rank sent; those bytes are counted in ``GATHERED`` or ``REDUCED``
too).

The adjoint convention of the parallel paths, stated once:
- every rank backpropagates its own copy of the loss; a gradient that
  every rank holds whole (a replicated layer's, or one a collective
  already summed) is averaged over the ranks that hold it, and one that a
  rank holds only its token shard's part of (a sequence-sharded layer's)
  is summed over its ``seq`` row, then averaged over ``data``
  (``train/loop.py::average_grads``);
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
  reads (the tensor-parallel mixer's input, the pipeline's microbatches,
  the expert-parallel dispatched tokens) is the sum of the ranks' partial
  cotangents (``copy_to_model``, Megatron's f);
- so gathering the expert-parallel outputs, which every rank combines
  alike, takes this rank's block of the cotangent (``gather_replicated``);
  gathering the rows of a data-sharded batch that every rank's own loss
  then reads whole (the MoE routing over the global batch) sums the
  ranks' cotangents of this rank's rows (``gather_rows``).
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
# the sequence-sharded layers' exchanges (``seq_*`` below), forward and
# backward: calls of this process and the bytes this rank sent
SEQ = {"shard": [0, 0], "permute": [0, 0], "gather_partial": [0, 0],
       "gather_replicated": [0, 0]}


def reset_counters():
    for c in (GATHERED, REDUCED, HOPPED, *SEQ.values()):
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


def all_reduce_mean_(tensors, group, divisors=None):
    """Sum a list of tensors over the group in place, through one flat
    fp32 buffer (one collective, whatever the number of tensors), and
    divide each by its entry of ``divisors`` (default: the group's size,
    the mean)."""
    n = size(group)
    if not tensors or (n == 1 and divisors is None):
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    if n > 1:
        dist.all_reduce(flat, group=group)
        _count(REDUCED, flat.numel() * flat.element_size())
    i = 0
    for t, d in zip(tensors, divisors or [n] * len(tensors)):
        t.copy_(flat[i:i + t.numel()].view_as(t) / d)
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


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return g[rank(ctx.group)], None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = size(group)
        return all_gather(x, group).reshape((n * x.shape[0],)
                                            + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        n, r = size(ctx.group), rank(ctx.group)
        return all_reduce_sum(g, ctx.group).view(
            (n, -1) + tuple(g.shape[1:]))[r], None


def gather_replicated(x, group):
    """(n, *x.shape): every rank's ``x`` stacked in group-rank order; the
    backward keeps this rank's block of the cotangent, for a gather that
    every rank then uses in the same way (each rank's copy of the loss holds
    the whole cotangent; a sum would count it n times)."""
    if size(group) == 1:
        return x[None]
    return _GatherReplicated.apply(x, group)


def gather_rows(x, group):
    """Every rank's rows of ``x`` concatenated in group-rank order along
    dim 0; the backward sums every rank's cotangent of this rank's rows
    (one all_reduce of the whole cotangent): for a batch whose ranks each
    hold their own rows and their own loss, where each loss reads every
    row."""
    if size(group) == 1:
        return x
    return _GatherRows.apply(x, group)


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


# ------------------------------------------- sequence-sharded layers
#
# A rank of a ``seq`` group of S holds the tokens [r Ls, (r+1) Ls) of a
# (N, L, C) sequence, Ls = L / S (dim 1 is the token axis).  Each exchange
# below is one all_gather and a local select (gloo's point-to-point calls
# do not take CUDA tensors), the halo a ``ppermute`` (which takes that
# route on gloo with CUDA tensors), and each backward is the exact adjoint
# under the convention of the module docstring.


def _count_seq(what, x):
    _count(SEQ[what], x.numel() * x.element_size())


def _seq_whole(parts):
    """(S, N, Ls, *rest) gathered shards -> (N, S * Ls, *rest)."""
    return parts.transpose(0, 1).reshape(
        (parts.shape[1], -1) + tuple(parts.shape[3:]))


class _SeqShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        n, r = size(group), rank(group)
        return tuple(x.narrow(1, r * (x.shape[1] // n), x.shape[1] // n)
                     .clone() for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        # every slice's cotangent, in one collective
        dtype = gs[0].dtype
        for g in gs[1:]:
            dtype = torch.promote_types(dtype, g.dtype)
        widths = [g.shape[-1] for g in gs]
        flat = torch.cat([g.to(dtype) for g in gs], -1)
        _count_seq("shard", flat)
        whole = _seq_whole(all_gather(flat, ctx.group)).split(widths, -1)
        return (None,) + tuple(w.to(g.dtype) for w, g in zip(whole, gs))


def seq_shard(group, *xs):
    """This rank's token shard of each replicated (N, L, ·) tensor in
    ``xs`` (a tuple).  Backward: the shards' cotangents gathered to the
    whole L (one all_gather for all of them), since every rank's replicated
    layers before it consume the whole."""
    return _SeqShard.apply(group, *xs)


def seq_gather_replicated(x, group):
    """The whole (N, L, ·) sequence from every rank's (N, Ls, ·) shard, for
    replicated layers after a sharded stack.  Backward: this rank's slice of
    the cotangent (``gather_replicated``: every rank's copy of the loss
    gives the whole one)."""
    _count_seq("gather_replicated", x)
    return _seq_whole(gather_replicated(x, group))


class _SeqGatherPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        _count_seq("gather_partial", x)
        return _seq_whole(all_gather(x, group))

    @staticmethod
    def backward(ctx, g):
        n, r = size(ctx.group), rank(ctx.group)
        _count_seq("gather_partial", g)
        ls = g.shape[1] // n
        return all_reduce_sum(g, ctx.group).narrow(1, r * ls, ls), None


def seq_gather_partial(x, group):
    """The whole (N, L, ·) sequence from every rank's shard, for an op that
    every rank computes whole and of whose result each rank keeps only its
    own slice (the Mix-FFN's 3-D conv).  Backward: each rank's cotangent of
    the whole is the part its slice of the result gives, so they are summed
    (one all_reduce) before this rank takes its slice."""
    return _SeqGatherPartial.apply(x, group)


def seq_halo(x, k, group):
    """The k tokens before this rank's (N, Ls, C) shard: the left
    neighbour's last k, zeros on rank 0 (a causal conv's left padding);
    k <= Ls.  A ``ppermute`` of every rank's last k tokens to its right
    neighbour (counted in ``HOPPED``): the backward sends the halo's
    cotangent back, where it adds to the neighbour's last k tokens'."""
    if k > x.shape[1]:
        raise ValueError(f"a halo of {k} tokens needs shards of at least "
                         f"{k}, not {x.shape[1]}")
    n = size(group)
    return ppermute(x[:, x.shape[1] - k:], [(r, r + 1) for r in range(n - 1)],
                    group)


def _permute_local(x, index, group, what):
    """out[p] = this rank's slice of the whole x[p or 0] taken at
    ``index[p]``: x (Pin, N, Ls, C), index (P, L) -> (P, N, Ls, C)."""
    n, r = size(group), rank(group)
    ls = x.shape[2]
    _count_seq(what, x)
    parts = all_gather(x, group).movedim(0, 2)           # (Pin, N, S, Ls, C)
    mine = index[:, r * ls:(r + 1) * ls]
    src, pos = mine // ls, mine % ls
    return torch.stack([parts[p if x.shape[0] > 1 else 0][:, src[p], pos[p]]
                        for p in range(index.shape[0])])


class _SeqPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, index, group):
        ctx.group, ctx.n_in = group, x.shape[0]
        ctx.save_for_backward(index)
        return _permute_local(x, index, group, "permute")

    @staticmethod
    def backward(ctx, g):
        index, = ctx.saved_tensors
        inverse = torch.empty_like(index).scatter_(
            1, index, torch.arange(index.shape[1], device=index.device)
            .expand_as(index))
        gx = _permute_local(g.contiguous(), inverse, ctx.group, "permute")
        if ctx.n_in == 1:
            gx = gx.sum(0, keepdim=True)
        return gx, None, None


def seq_permute(x, index, group):
    """Re-order a sequence-sharded sequence: ``index`` (P, L) holds P
    permutations of the L global positions, and output p is this rank's
    shard of the whole sequence taken at ``index[p]`` (``whole[:,
    index[p]]``).  x is (Pin, N, Ls, C), Pin 1 (each permutation of the same
    sequence) or P (each its own); returns (P, N, Ls, C).  Backward: the
    inverse permutations of the cotangents, summed over p when Pin is 1.
    Any permutation, so a shard need not align with frames."""
    return _SeqPermute.apply(x, index, group)
