"""Pipeline parallelism (GPipe) for the Mamba LM's layer stack.

Port of the JAX package's ``parallel/pipeline.py``, its SPMD schedule as it
is: the ``n_layer`` blocks split into ``k`` contiguous stages of ``n_layer /
k`` layers over a ``pipe`` mesh axis, one stage per rank
(``stack_pipeline_params``); the batch split into ``M`` microbatches; ``M +
k - 1`` ticks, at each of which every rank applies its stage to its current
activation and the activations move one stage on (``comm.ppermute``, a
neighbour hop).  Stage 0 takes microbatch t in at tick t, picked by a
tensor mask (``torch.where(first, feed, h_in)``), not by a branch on the
rank; the last stage banks microbatch t - (k - 1); one sum over the pipe
group (``reduce_from_model``) gives every rank the banked outputs, and the
final norm and the tied head run whole on every rank.

Why the mask: every rank builds an autograd graph of the same shape, so one
``loss.backward()`` runs the inverse hops in the same order on every rank
and gives every stage its gradients (what ``jax.grad`` through the JAX
island gives).  A branch on the rank would give the ranks different graphs,
and their backwards would wait on each other in different collectives.
The price is the JAX schedule's: a stage runs its layers at every tick,
the bubble included, so each rank launches n_layer / k x (M + k - 1) scans
per forward (and as many K2 per backward: the masked ticks are in the
graph with zero cotangents).  The hop after the last tick feeds nothing
and is not sent: M + k - 2 hops per forward.

The microbatches enter replicated and only stage 0 reads them, so they pass
``copy_to_model`` over the pipe axis: the embedding's gradient (lookup and
tied head) is equal on every rank and to the one-device one.  ``batch_axis``
composes with data parallel on a ("data", "pipe") mesh: a rank takes its
block of each microbatch (``mesh.local_rows``).
"""

from __future__ import annotations

import functools

import torch

from vivim_tpu_torch.nn import lm as lm_lib
from vivim_tpu_torch.nn import streaming
from vivim_tpu_torch.parallel import comm
from vivim_tpu_torch.parallel.mesh import Mesh, local_rows


def stack_pipeline_params(params, n_layer: int, n_stages: int, stage: int):
    """Stage ``stage``'s contiguous layers of an LM's flat parameter dict:
    a list of ``n_layer // n_stages`` (mixer params, norm params) pairs,
    local layer j being layer ``stage * n_layer // n_stages + j``.  Reads
    only those layers' keys, so a rank's dict may hold only its stage."""
    if n_layer % n_stages:
        raise ValueError(
            f"n_layer {n_layer} not divisible by {n_stages} pipeline stages")
    lps = n_layer // n_stages
    layers = []
    for i in range(stage * lps, (stage + 1) * lps):
        mixer = lm_lib.sub_params(params, f"backbone.layers.{i}.mixer.")
        if not mixer:
            raise KeyError(f"layer {i} of stage {stage} is not in params")
        layers.append((mixer, lm_lib.sub_params(
            params, f"backbone.layers.{i}.norm.")))
    return layers


def _schedule(stage_fn, x_mb, stage, n_stages, group):
    """The GPipe ticks over (M, mb, L, d) microbatches: (M, mb, L, d)
    outputs of the last stage, on every rank."""
    n_micro = x_mb.shape[0]
    first = torch.tensor(stage == 0, device=x_mb.device)
    last = torch.tensor(stage == n_stages - 1, device=x_mb.device)
    hop = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    n_ticks = n_micro + n_stages - 1
    h_in = torch.zeros_like(x_mb[0])
    bank = []
    for t in range(n_ticks):
        h = stage_fn(torch.where(first, x_mb[min(t, n_micro - 1)], h_in))
        if t >= n_stages - 1:  # the last stage banks microbatch t - (k - 1)
            bank.append(torch.where(last, h, torch.zeros_like(h)))
        if t < n_ticks - 1:
            h_in = comm.ppermute(h, hop, group)
    return comm.reduce_from_model(torch.stack(bank), group)


def lm_pp_forward(cfg, params, tokens, mesh: Mesh, axis_name: str = "pipe",
                  n_micro: int | None = None, batch_axis: str | None = None,
                  implementation=None):
    """Pipeline-parallel ``MambaLM`` forward: same params, same logits.

    ``k`` = the ``axis_name`` axis's size; ``cfg.n_layer`` must divide by
    it.  ``n_micro``: microbatches (default ``k``; the batch must divide by
    it).  ``params``: the LM's flat dict (``nn.lm.lm_params``), whole or
    holding only this rank's stage beside the embedding and ``norm_f``;
    ``tokens``: the global (B, L) batch.  Differentiable: the gradients
    land in ``params``' own tensors.  Returns (B_r, L, padded_vocab) logits
    of this rank's rows over ``batch_axis`` (all B without it)."""
    k = mesh.size(axis_name)
    if cfg.n_layer % k:
        raise ValueError(f"n_layer {cfg.n_layer} not divisible by "
                         f"{axis_name} axis size {k}")
    n_micro = k if n_micro is None else n_micro
    if tokens.shape[0] % n_micro:
        raise ValueError(f"batch {tokens.shape[0]} not divisible by n_micro "
                         f"{n_micro}")
    lm_lib.check_kernel_config(cfg, tokens.device, implementation)
    tokens = local_rows(tokens, mesh, batch_axis, n_micro)
    stage = mesh.index(axis_name)
    layers = stack_pipeline_params(params, cfg.n_layer, k, stage)
    apply_norm = lm_lib.norm_fn_for(cfg)
    emb = params["backbone.embedding.weight"]
    dtype = emb.dtype
    prefill = functools.partial(streaming.mamba_prefill,
                                implementation=implementation)

    def stage_fn(h):
        for mp, np_ in layers:
            h = h + prefill(mp, apply_norm(np_, h).to(dtype))[0].to(h.dtype)
        return h

    h = emb[tokens]
    if cfg.residual_in_fp32:
        h = h.float()
    group = mesh.group(axis_name)
    x_mb = comm.copy_to_model(
        h.reshape(n_micro, h.shape[0] // n_micro, *h.shape[1:]), group)
    y = _schedule(stage_fn, x_mb, stage, k, group)
    h = apply_norm(lm_lib.sub_params(params, "backbone.norm_f."),
                   y.reshape(-1, *y.shape[2:])).to(dtype)
    return h @ emb.t()
