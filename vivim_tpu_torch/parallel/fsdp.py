"""ZeRO-style sharding of the parameters and AdamW moments over ``data``.

Port of the JAX package's ``parallel/fsdp.py``.  There the state is only
placed sharded and XLA's partitioner inserts the gathers and the
reduce-scatters; here ``Zero`` does both by hand, over the port's own
``AdamW`` (``train/loop.py``), whose fp32 masters, bf16
``functional_call`` cast, remat recompute and checkpoint layout all work
on plain tensors.  (FSDP2's ``fully_shard`` turns the parameters into
DTensors, which each of those would have to learn.)

The rule (``_leaf_spec``) is the JAX one: shard the largest dimension that
divides by the axis size, ties going to the later dimension, and keep
leaves under ``MIN_SHARD_ELEMS`` elements replicated.  Dimensions are
ranked in the JAX package's layout of the leaf (flax Dense kernels are
(in, out), convs HWIO / DHWIO, the Mamba conv1d kernel (width, d)), so the
port shards the same dimension the JAX package does.

At rest, each sharded parameter and both its moments live on every rank
as that rank's 1/N slice (the model's own tensor is empty); the replicated
leaves, the BatchNorm statistics, the step and the generator are whole on
every rank.  A step gathers the parameters for the forward and backward,
averages the gradients over the axis (one all_reduce, as data parallel's)
and keeps each rank's slice, clips by the global norm of the whole
gradient, updates the slices, and frees the gathered parameters: the same
update as data parallel.  Checkpoints are written whole by rank 0
(``Zero.full``), in the one-card layout.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn

from vivim_tpu_torch.parallel import comm

# Leaves smaller than this stay replicated: sharding a 768-element bias
# saves nothing and costs a collective per use.
MIN_SHARD_ELEMS = 16384


def _leaf_spec(shape, n_shards: int, order=None,
               min_shard_elems: int | None = None):
    """The dimension of ``shape`` to shard over ``n_shards``, or None for
    replicated: the largest divisible one, ties going to the later one in
    ``order`` (the dimensions in the JAX layout; default: as they are).
    ``min_shard_elems`` defaults to ``MIN_SHARD_ELEMS``."""
    if min_shard_elems is None:
        min_shard_elems = MIN_SHARD_ELEMS
    if not shape or int(np.prod(shape)) < min_shard_elems:
        return None
    best = None
    for d in (range(len(shape)) if order is None else order):
        if shape[d] % n_shards == 0 and shape[d] >= (
                shape[best] if best is not None else 0):
            best = d
    return best


def _jax_order(module: nn.Module, parent: nn.Module):
    """The dimensions of ``module.weight`` in the order of the JAX
    package's layout of that leaf."""
    if isinstance(module, nn.Conv1d):       # Mamba conv1d: (d, 1, w) ~ (w, d)
        return (2, 1, 0)
    if isinstance(module, nn.Conv2d):       # OIHW ~ HWIO
        return (2, 3, 1, 0)
    if isinstance(module, nn.Conv3d):       # OIDHW ~ DHWIO
        return (2, 3, 4, 1, 0)
    if isinstance(module, nn.Linear):
        from vivim_tpu_torch.nn.mamba import MambaV3

        # the Mamba projections keep the torch (out, in) layout in JAX too
        return (0, 1) if isinstance(parent, MambaV3) else (1, 0)
    return None


def fsdp_state_shardings(state, mesh, axis: str = "data",
                         min_shard_elems: int | None = None):
    """{parameter name: sharded dimension, or None for replicated} of a
    TrainState's model over ``mesh``'s ``axis``; the moments follow their
    parameter, and the buffers, the step and the generator are
    replicated."""
    n = mesh.size(axis)
    orders = {}
    for mname, mod in state.model.named_modules():
        for child_name, child in mod.named_children():
            if getattr(child, "weight", None) is not None:
                key = f"{mname}.{child_name}" if mname else child_name
                orders[f"{key}.weight"] = _jax_order(child, mod)
    return {name: _leaf_spec(tuple(p.shape), n, orders.get(name),
                             min_shard_elems)
            for name, p in state.model.named_parameters()}


def _slice(x, dim, index, n):
    k = x.shape[dim] // n
    return x.narrow(dim, index * k, k)


class Zero:
    """The sharded state of one TrainState (``shard_state_fsdp`` makes it
    and sets ``state.zero``); the train and eval steps call ``gather`` /
    ``release`` around the model, ``reduce_grads`` before the update."""

    def __init__(self, state, mesh, shardings, axis: str = "data"):
        self.group = mesh.group(axis)
        self.n, self.index = mesh.size(axis), mesh.index(axis)
        self.opt = state.opt
        params = dict(state.model.named_parameters())
        self.leaves = []        # (optimizer index, parameter, dim)
        for i, name in enumerate(self.opt.names):
            dim = shardings[name]
            if dim is None:
                continue
            p = params[name]
            shard = _slice(p.detach(), dim, self.index, self.n).clone()
            self.opt.params[i] = shard
            self.opt.mu[i] = _slice(self.opt.mu[i], dim, self.index,
                                    self.n).clone()
            self.opt.nu[i] = _slice(self.opt.nu[i], dim, self.index,
                                    self.n).clone()
            self.leaves.append((i, p, dim))
        self.opt.reduce_norm = self._norm
        self.release()

    def gather(self):
        """Every sharded parameter whole in the model (one all_gather)."""
        shards = [self.opt.params[i] for i, _, _ in self.leaves]
        for (_, p, dim), full in zip(self.leaves, self._gather(shards)):
            p.data = full

    def release(self):
        """Free the gathered parameters: the slices stay the state."""
        for _, p, _ in self.leaves:
            p.data = p.data.new_empty(0)
            p.grad = None

    def _gather(self, shards):
        """The whole tensors of equal-split ``shards``, one collective."""
        if not shards:
            return []
        flat = comm.all_gather(torch.cat([s.reshape(-1) for s in shards]),
                               self.group)               # (n, total)
        out, off = [], 0
        for (_, _, dim), s in zip(self.leaves, shards):
            parts = flat[:, off:off + s.numel()].reshape(
                (self.n,) + tuple(s.shape))
            out.append(torch.cat(list(parts.unbind(0)), dim))
            off += s.numel()
        return out

    def reduce_grads(self, group, divisor=None):
        """Sum every gradient over ``group`` (the axis, or every rank of
        the mesh) in one all_reduce (the bytes of data parallel's) and
        divide it by ``divisor(parameter)`` (default: the group's size, the
        mean; ``train/loop.py::average_grads``), and keep the sharded ones'
        slices of this rank (``opt.params[i].grad``)."""
        idx = {i for i, _, _ in self.leaves}
        whole = [p for j, p in enumerate(self.opt.params)
                 if j not in idx and p.grad is not None]
        live = [(i, p, d) for i, p, d in self.leaves if p.grad is not None]
        params = whole + [p for _, p, _ in live]
        comm.all_reduce_mean_([p.grad for p in params], group,
                              None if divisor is None
                              else [divisor(p) for p in params])
        for i, _, _ in self.leaves:
            self.opt.params[i].grad = None
        for i, p, d in live:
            self.opt.params[i].grad = _slice(p.grad, d, self.index,
                                             self.n).contiguous()
            p.grad = None

    def _norm(self, norms, live):
        """The global gradient norm from the per-leaf norms of the live
        leaves: the slices' squares summed over the axis."""
        sharded = {i for i, _, _ in self.leaves}
        mask = torch.tensor([i in sharded for i in live],
                            device=norms.device)
        sq = norms.float() ** 2
        part = comm.all_reduce_sum(sq[mask].sum().reshape(1), self.group)
        return torch.sqrt(part[0] + sq[~mask].sum())

    @contextlib.contextmanager
    def full(self):
        """The whole parameters in the model and the whole moments in the
        optimizer (collective: every rank enters), e.g. to write or read a
        checkpoint in the one-card layout; on exit each rank takes its
        slices back from them, so what was loaded inside is kept."""
        idx = [i for i, _, _ in self.leaves]
        shards = {"mu": [self.opt.mu[i] for i in idx],
                  "nu": [self.opt.nu[i] for i in idx]}
        self.gather()
        for key, parts in shards.items():
            moments = getattr(self.opt, key)
            for i, full in zip(idx, self._gather(parts)):
                moments[i] = full
        try:
            yield self
        finally:
            for j, (i, p, dim) in enumerate(self.leaves):
                self.opt.params[i].copy_(_slice(p.data, dim, self.index,
                                                self.n))
                for key, parts in shards.items():
                    moments = getattr(self.opt, key)
                    parts[j].copy_(_slice(moments[i], dim, self.index,
                                          self.n))
                    moments[i] = parts[j]
            self.release()


def shard_state_fsdp(state, mesh, axis: str = "data",
                     min_shard_elems: int | None = None):
    """Shard a fresh (replicated) TrainState over ``mesh``'s ``axis`` in
    place; returns ``(state, shardings)``, with ``state.zero`` set."""
    shardings = fsdp_state_shardings(state, mesh, axis, min_shard_elems)
    state.zero = Zero(state, mesh, shardings, axis)
    return state, shardings


def state_bytes_per_device(state) -> int:
    """Bytes of the parameters and AdamW moments this rank holds: the
    number the memory claim is made from (the BatchNorm statistics, the
    step and the generator are replicated and small)."""
    opt = state.opt
    return sum(t.numel() * t.element_size()
               for t in list(opt.params) + list(opt.mu) + list(opt.nu))
