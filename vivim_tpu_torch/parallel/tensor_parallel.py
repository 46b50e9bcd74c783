"""Tensor-parallel (Megatron-style) Mamba mixer, LM forward and decode.

Port of the JAX package's ``parallel/tensor_parallel.py``.  The selective
scan is independent per channel, so sharding ``d_inner`` over a ``model``
mesh axis keeps the conv -> dt / scan -> gate chain local to each rank,
and K1 (K1-training and K2 under a gradient) runs on its d_inner / k
channels.  Per mixer and forward two all_reduces over the axis's group
(``parallel/comm.py``):

- ``in_proj`` is column-parallel: each rank takes its d_inner / k rows
  of the fused (2 d_inner, d_model) weight's x half and of its z half (a
  contiguous slice of the fused weight would mix x rows with z rows),
  and holds them fused, x rows first;
- ``x_proj`` is row-parallel: each rank's partial (B, L, dt_rank + 2 N)
  product is summed over the group (``AllReduceSum``: dt, B and C are
  shared by every channel, so each rank's cotangent of them is partial);
- ``dt_proj``, ``A_log``, ``D`` and the conv are per channel; the scan
  and the silu(z) gate are local;
- ``out_proj`` is row-parallel: the partial (B, L, d_model) products are
  summed (``reduce_from_model``) and the whole out bias is added once,
  after the sum.

The mixer's replicated input passes ``copy_to_model``, so the norms, the
residual stream and the embedding get the whole gradient.  Each rank
backpropagates its own copy of the loss (comm's convention): a rank's
gradients of its split are the split of the one-device gradients, and
the replicated leaves' gradients are equal on every rank.  The mixer's
arithmetic is ``nn.streaming``'s, given the group.

Parameters travel as the LM's flat dict (``nn.lm.lm_params``: reference
names).  ``split_tp_params`` gives a rank its split of it once: every
mixer leaf sliced to the rank's channels, every other leaf as it is, under
the same names; ``lm_tp_forward`` and ``tp_generate`` take that split.
``batch_axis`` composes with data parallel on a ("data", "model") mesh
(``mesh.make_hybrid_mesh(dp, k, ("data", "model"))``): the tokens are the
global batch and a rank computes its block of the rows
(``mesh.local_rows``).
"""

from __future__ import annotations

import functools

import torch

from vivim_tpu_torch.nn import lm as lm_lib
from vivim_tpu_torch.nn import streaming
from vivim_tpu_torch.parallel import comm
from vivim_tpu_torch.parallel.mesh import Mesh, local_rows

# the dim of each mixer leaf that holds its d_inner channels (None: the
# leaf is whole on every rank); a single-direction MambaV3's leaves.
# in_proj holds 2 d_inner rows, x then z: a rank takes its rows of each.
_MIXER_RULES = {
    "in_proj.weight": 0, "in_proj.bias": 0,
    "conv1d.weight": 0, "conv1d.bias": 0,
    "x_proj.weight": 1,
    "dt_proj.weight": 0, "dt_proj.bias": 0,
    "A_log": 0, "D": 0,
    "out_proj.weight": 1,
    "out_proj.bias": None,
}
_MIXER = ".mixer."


def _split_mixer(mp, index, k, axis_name, where="the mixer"):
    """One mixer's flat dict -> rank ``index``'s split of it: views of the
    per-channel leaves, the in_proj rows copied (x then z)."""
    d_inner = mp["A_log"].shape[0]
    if d_inner % k:
        raise ValueError(f"d_inner {d_inner} not divisible by {axis_name} "
                         f"axis size {k}")
    unknown = sorted(set(mp) - set(_MIXER_RULES))
    if unknown:
        raise ValueError(
            f"TP has no sharding rule for mixer param(s) {unknown} in "
            f"{where} — supported: single-direction MambaV3 trees "
            f"({sorted(_MIXER_RULES)})")
    n = d_inner // k
    out = {}
    for name, v in mp.items():
        dim = _MIXER_RULES[name]
        if name.startswith("in_proj."):
            out[name] = torch.cat([v[:d_inner].narrow(0, index * n, n),
                                   v[d_inner:].narrow(0, index * n, n)])
        else:
            out[name] = v if dim is None else v.narrow(dim, index * n, n)
    return out


def split_tp_params(params, mesh: Mesh, axis_name: str = "model"):
    """This rank's split of an LM's flat parameter dict: every
    ``*.mixer.*`` group through the TP rules (``_MIXER_RULES``; a mixer leaf
    without a rule raises, as the bi-directional trees' do), every other
    leaf as it is, in the dict's order.  The per-channel leaves are views
    of the given tensors and in_proj's rows a copy: a rank that keeps only
    the split clones it and drops the whole dict."""
    k, index = mesh.size(axis_name), mesh.index(axis_name)
    mixers = {}
    for name, v in params.items():
        if _MIXER in name:
            prefix, leaf = name.split(_MIXER, 1)
            mixers.setdefault(prefix, {})[leaf] = v
    split = {prefix: _split_mixer(mp, index, k, axis_name,
                                  f"{prefix}{_MIXER[:-1]}")
             for prefix, mp in mixers.items()}
    out = {}
    for name, v in params.items():
        if _MIXER not in name:
            out[name] = v
            continue
        prefix = name.split(_MIXER, 1)[0]
        if prefix in split:
            out.update({f"{prefix}{_MIXER}{leaf}": t
                        for leaf, t in split.pop(prefix).items()})
    return out


def tp_mixer_prefill(mp, x, *, group, implementation=None):
    """TP twin of ``nn.streaming.mamba_prefill`` over this rank's split
    mixer ``mp``: (out (B, L, d_model), conv_state, ssm_state), the states
    of this rank's channels only (``tp_mixer_step`` takes them)."""
    return streaming.mamba_prefill(mp, x, implementation, group=group)


def tp_mixer_step(mp, x, conv_state, ssm_state, *, group):
    """TP twin of ``nn.streaming.mamba_step`` over this rank's channels:
    two all_reduces per call (dt / B / C, and the output)."""
    return streaming.mamba_step(mp, x, conv_state, ssm_state, group=group)


def tp_mamba_mixer(params, x, mesh: Mesh, axis_name: str = "model",
                   batch_axis: str | None = None, implementation=None):
    """One single-direction Mamba mixer, tensor-parallel over ``axis_name``.

    ``params``: the mixer's flat dict as ``MambaV3(bimamba_type="none")``
    names it (``in_proj.weight``, ``conv1d.*``, ``x_proj.weight``,
    ``dt_proj.*``, ``A_log``, ``D``, ``out_proj.weight``, and the biases of
    ``bias=True``), whole; d_inner must divide by the axis size.  ``x``:
    (B, L, d_model), the same on every rank of the axis.  Returns (B_r, L,
    d_model): this rank's rows over ``batch_axis`` (all B without it)."""
    mp = _split_mixer(params, mesh.index(axis_name), mesh.size(axis_name),
                      axis_name)
    return tp_mixer_prefill(mp, local_rows(x, mesh, batch_axis),
                            group=mesh.group(axis_name),
                            implementation=implementation)[0]


def lm_tp_forward(cfg, params, tokens, mesh: Mesh, axis_name: str = "model",
                  batch_axis: str | None = None, implementation=None):
    """Tensor-parallel ``MambaLM`` forward: same params, same logits.

    ``params``: this rank's ``split_tp_params`` of the LM's flat dict
    (``nn.lm.lm_params``); ``tokens``: the global (B, L) batch.  The
    embedding lookup, the norms and the tied head run whole on every rank;
    every mixer runs through ``tp_mixer_prefill``.  Returns (B_r, L,
    padded_vocab) logits of this rank's rows over ``batch_axis``."""
    lm_lib.check_kernel_config(cfg, tokens.device, implementation)
    parts = lm_lib.parts_for(cfg, params, implementation)
    prefill = functools.partial(tp_mixer_prefill,
                                group=mesh.group(axis_name),
                                implementation=implementation)
    return lm_lib.forward_parts(parts, local_rows(tokens, mesh, batch_axis),
                                prefill)


def tp_generate(model, params, tokens, max_new_tokens, mesh: Mesh,
                axis_name: str = "model", generator=None, temperature=1.0,
                top_k=0, top_p=1.0, eos_token_id=None, implementation=None):
    """Tensor-parallel decode: ``nn.lm.generate``'s prefill and token loop
    with every mixer channel-split over ``axis_name``; each rank's conv and
    ssm decode cache is its own channel slice (1/k of the cache), two
    all_reduces per layer and token.  ``params``: this rank's
    ``split_tp_params``; ``model`` gives the config only.

    ``generator``: a ``torch.Generator`` seeded alike on every rank (one
    seeded 0 when None).  The logits are sums that every rank holds alike,
    so the ranks draw the same tokens; a gather of the result checks it and
    raises if they differ.  Returns (B, L0 + max_new_tokens) tokens."""
    group = mesh.group(axis_name)
    prefill = functools.partial(tp_mixer_prefill, group=group,
                                implementation=implementation)
    step = functools.partial(tp_mixer_step, group=group)
    out = lm_lib.generate(
        model, params, tokens, max_new_tokens,
        generator=generator, temperature=temperature, top_k=top_k,
        top_p=top_p, eos_token_id=eos_token_id, mixer_prefill=prefill,
        mixer_step=step)
    every = comm.all_gather(out, group)
    if not all(torch.equal(every[0], e) for e in every[1:]):
        raise RuntimeError("tp_generate: the ranks of the model axis drew "
                           "different tokens")
    return out
