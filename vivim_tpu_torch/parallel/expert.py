"""Expert parallelism for the MoE FFN and the MoE-Mamba LM.

Port of the JAX package's ``parallel/expert.py``.  Only the expert FFNs
scale with E: their stacked weights ``wi`` (E, M, F) / ``wo`` (E, F, M)
split over an ``expert`` mesh axis of k ranks, so each rank holds and runs
E / k experts.  The router (a (T, E) softmax), the dispatch and the
combine stay replicated on every rank of the axis, as in the JAX island;
with every token on every rank no all_to_all is needed.  Per MoE block and
rank (``parallel/comm.py``'s counters):

- forward: the dispatched tokens (E, C, M) pass ``copy_to_model``; the
  rank runs ``expert_ffn`` on its E / k blocks; one all_gather
  (``gather_replicated``) puts the (E, C, M) outputs back together;
- backward: the gather takes this rank's block of the cotangent (every
  rank backpropagates the same replicated loss: a sum would scale the
  experts' gradients by k); ``copy_to_model`` all_reduces the tokens'
  cotangent, which each rank holds for its own experts only, so that the
  router, the norms and every mixer below get the whole gradient.

On a ("data", "expert") mesh (``batch_axis="data"``) each rank holds its
rows of the batch.  The JAX routing is global (capacity ``ceil(cf *
T_global / E)``, slots filled in the global token order, the aux loss over
every token), so each MoE block gathers its input over ``data`` first
(``gather_rows``: in the backward, the sum over the data ranks of their
cotangents of this rank's rows, since each data rank's loss reads every
row) and keeps this rank's rows of the combined output.

Parameters travel as flat dicts under ``MoEMambaLM``'s names;
``split_ep_params`` gives a rank its experts once.
"""

from __future__ import annotations

import functools

from vivim_tpu_torch.nn import moe as moe_lib
from vivim_tpu_torch.parallel import comm
from vivim_tpu_torch.parallel.mesh import Mesh, local_rows

_EXPERT_LEAVES = ("wi", "wo")


def _check_divisible(n_experts: int, mesh: Mesh, axis_name: str):
    k = mesh.size(axis_name)
    if n_experts % k:
        raise ValueError(f"n_experts {n_experts} not divisible by "
                         f"{axis_name} axis size {k}")


def _own_experts(w, n_experts, mesh, axis_name):
    """This rank's experts of a stacked leaf: a slice of the whole (E, ...)
    leaf, or the leaf itself when it is already this rank's split."""
    k = mesh.size(axis_name)
    n = n_experts // k
    if w.shape[0] == n_experts:
        return w.narrow(0, mesh.index(axis_name) * n, n)
    if w.shape[0] != n:
        raise ValueError(f"an expert leaf of {w.shape[0]} experts is neither "
                         f"all {n_experts} nor this rank's {n}")
    return w


def ep_expert_apply(mesh: Mesh, axis_name: str = "expert"):
    """An ``expert_apply`` hook for ``moe_ffn`` that runs the stacked
    expert FFNs split over ``axis_name``: each rank computes its own E / k
    experts on their (E / k, C, M) token blocks.  ``wi`` / ``wo`` may be
    whole or this rank's split (``split_ep_params``); E (the leading dim of
    ``expert_in``) must divide by the axis size."""
    group = mesh.group(axis_name)

    def apply(wi, wo, expert_in):
        E = expert_in.shape[0]
        _check_divisible(E, mesh, axis_name)
        wi, wo = (_own_experts(w, E, mesh, axis_name) for w in (wi, wo))
        x = comm.copy_to_model(expert_in, group)
        n = E // mesh.size(axis_name)
        mine = x.narrow(0, mesh.index(axis_name) * n, n)
        out = moe_lib.expert_ffn(wi, wo, mine)
        return comm.gather_replicated(out, group).reshape(expert_in.shape)

    return apply


def ep_moe_ffn(params, x, mesh: Mesh, axis_name: str = "expert",
               capacity_factor: float = 1.25, top_k: int = 1,
               batch_axis: str | None = None):
    """Expert-parallel ``moe_ffn``: same parameters (whole or this rank's
    split), same outputs, experts split over ``axis_name``.  ``x``: (...,
    M), the whole batch, or with ``batch_axis`` this rank's rows of it
    (leading dim); the routing is the whole batch's either way.  Returns
    ``(y, aux_loss)``, ``y`` shaped as ``x``."""
    _check_divisible(params["router_kernel"].shape[1], mesh, axis_name)
    hook = ep_expert_apply(mesh, axis_name)
    if batch_axis is None or mesh.size(batch_axis) == 1:
        return moe_lib.moe_ffn(params, x, capacity_factor=capacity_factor,
                               top_k=top_k, expert_apply=hook)
    y, aux = moe_lib.moe_ffn(
        params, comm.gather_rows(x, mesh.group(batch_axis)),
        capacity_factor=capacity_factor, top_k=top_k, expert_apply=hook)
    rows = x.shape[0]
    return y.narrow(0, mesh.index(batch_axis) * rows, rows), aux


def split_ep_params(params, mesh: Mesh, axis_name: str = "expert"):
    """This rank's split of an MoE LM's flat parameter dict: every
    ``moe_{i}.wi`` / ``moe_{i}.wo`` narrowed to the rank's E / k experts
    and cloned (a rank that keeps the split holds only its share), every
    other leaf as it is, in the dict's order."""
    out = {}
    for name, v in params.items():
        block, _, leaf = name.rpartition(".")
        if block.startswith("moe_") and leaf in _EXPERT_LEAVES:
            _check_divisible(v.shape[0], mesh, axis_name)
            v = _own_experts(v, v.shape[0], mesh, axis_name).clone()
        out[name] = v
    return out


def lm_ep_forward(cfg, params, tokens, mesh: Mesh,
                  axis_name: str = "expert", batch_axis: str | None = None,
                  implementation=None):
    """Expert-parallel ``MoEMambaLM`` forward: same parameters, same
    logits and aux loss, with every MoE block's experts split over
    ``axis_name``; mixers, norms and the tied head run whole on every rank.

    ``params``: the LM's flat dict (``dict(model.named_parameters())``) or
    this rank's ``split_ep_params`` of it; ``tokens``: the global (B, L)
    batch.  Returns ``(logits (B_r, L, padded_vocab), aux_loss)`` of this
    rank's rows over ``batch_axis`` (all B without it)."""
    _check_divisible(cfg.n_experts, mesh, axis_name)
    moe_fn = functools.partial(
        ep_moe_ffn, mesh=mesh, axis_name=axis_name,
        capacity_factor=cfg.capacity_factor, top_k=cfg.top_k,
        batch_axis=batch_axis)
    return moe_lib.moe_lm_forward(
        cfg, params, local_rows(tokens, mesh, batch_axis), implementation,
        moe_fn)
