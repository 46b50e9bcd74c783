"""Remat in the PyTorch port (``-remat pre_scan`` / ``-remat blocks``).

- ``mamba_inner(remat=True)``, plain and grouped: values and gradients
  equal the port's ``remat=False`` and agree with the JAX package's
  ``mamba_inner(remat=True)`` (sequential ref scan) at the gradient
  tolerance, rtol 1e-3 / atol 2e-3.
- A tiny Vivim at each remat level with dropout and drop-path on: two
  train steps from one generator seed give the parameters, losses and
  generator state of the run without remat, at rtol 1e-5 / atol 1e-6 (the
  same ops on the CPU), in fp32, in bf16 (the cast parameters under
  ``functional_call``) and with ``grad_accum``.  The random layers draw
  from explicit generators, so these fail if ``nn.layers.checkpoint`` does
  not replay the generators' states in the recompute.
- With dropout at 0, the remat model's loss and gradients agree with the
  JAX package's remat Vivim at the JAX test's rtol 5e-3 / atol 1e-3
  (tests/test_dropout_and_remat.py).
- State-dict keys do not change with remat; a checkpointed region refuses
  a BatchNorm.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from vivim_tpu.convert.torch_to_jax import vivim_params_from_torch
from vivim_tpu.kernels.mamba_inner import mamba_inner as jmamba_inner
from vivim_tpu.kernels.mamba_inner import (
    mamba_inner_grouped as jmamba_inner_grouped,
)
from vivim_tpu.nn.vivim import Vivim as JVivim
from vivim_tpu.nn.vivim import VivimConfig as JConfig
from vivim_tpu_torch.convert.from_jax import vivim_state_dict_from_jax
from vivim_tpu_torch.kernels.mamba_inner import (
    mamba_inner,
    mamba_inner_grouped,
)
from vivim_tpu_torch.nn.layers import checkpoint, init_weights
from vivim_tpu_torch.nn.vivim import Vivim, VivimConfig
from vivim_tpu_torch.train import loop

torch.set_num_threads(1)

G, NB, L, D_INNER, N, RANK = 3, 2, 24, 8, 4, 2


def _inner_inputs(grouped, seed=0):
    """numpy inputs of ``mamba_inner`` (or its grouped form)."""
    rng = np.random.default_rng(seed)
    g = (G,) if grouped else ()
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    out = dict(
        xz=f(G * NB if grouped else NB, L, 2 * D_INNER),
        conv_w=0.3 * f(*g, 4, D_INNER), conv_b=0.1 * f(*g, D_INNER),
        x_proj=0.3 * f(*g, RANK + 2 * N, D_INNER),
        dt_proj=0.3 * f(*g, D_INNER, RANK), D=f(*g, D_INNER),
        bias=0.1 * f(*g, D_INNER))
    out["A_log" if grouped else "A"] = (
        0.1 * f(*g, D_INNER, N) if grouped
        else -0.5 - rng.random((D_INNER, N)).astype(np.float32))
    return out


def _port_inner(inp, grouped, remat):
    """(value, grads) of sum(y^2) through the port's function."""
    t = {k: torch.tensor(v, requires_grad=True) for k, v in inp.items()}
    if grouped:
        y = mamba_inner_grouped(t["xz"], t["conv_w"], t["conv_b"],
                                t["x_proj"], t["dt_proj"], t["A_log"],
                                t["D"], t["bias"], nb=NB, remat=remat)
    else:
        y = mamba_inner(t["xz"], t["conv_w"], t["conv_b"], t["x_proj"],
                        t["dt_proj"], t["A"], D=t["D"], delta_bias=t["bias"],
                        remat=remat)
    loss = (y ** 2).sum()
    loss.backward()
    return loss.item(), {k: v.grad.numpy() for k, v in t.items()}


def _jax_inner(inp, grouped):
    names = sorted(inp)

    def loss(*args):
        a = dict(zip(names, args))
        if grouped:
            y = jmamba_inner_grouped(
                a["xz"], a["conv_w"], a["conv_b"], a["x_proj"],
                a["dt_proj"], a["A_log"], a["D"], a["bias"], nb=NB,
                implementation="ref", remat=True)
        else:
            y = jmamba_inner(a["xz"], a["conv_w"], a["conv_b"], a["x_proj"],
                             a["dt_proj"], a["A"], D=a["D"],
                             delta_bias=a["bias"], implementation="ref",
                             remat=True)
        return jnp.sum(y ** 2)

    v, g = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(names)))))(
        *[jnp.asarray(inp[k]) for k in names])
    return float(v), {k: np.asarray(x) for k, x in zip(names, g)}


@pytest.mark.parametrize("grouped", [False, True])
def test_mamba_inner_remat(grouped):
    inp = _inner_inputs(grouped)
    v0, g0 = _port_inner(inp, grouped, remat=False)
    v1, g1 = _port_inner(inp, grouped, remat=True)
    assert v1 == v0
    for k in g0:
        np.testing.assert_array_equal(g1[k], g0[k], err_msg=k)
    vj, gj = _jax_inner(inp, grouped)
    np.testing.assert_allclose(v1, vj, rtol=1e-3)
    for k in g1:
        np.testing.assert_allclose(g1[k], gj[k], rtol=1e-3, atol=2e-3,
                                   err_msg=k)


def _remat_cfg(cfg, level):
    if level == "pre_scan":
        return dataclasses.replace(cfg, remat_pre_scan=True)
    if level == "blocks":
        return dataclasses.replace(
            cfg, remat_blocks=True,
            segformer=dataclasses.replace(cfg.segformer, remat_layers=True))
    return cfg


def _no_dropout(cfg):
    return dataclasses.replace(
        cfg, drop_path_rate=0.0, dropout_rate=0.0,
        segformer=dataclasses.replace(cfg.segformer, drop_path_rate=0.0,
                                      classifier_dropout=0.0))


def _batch(seed, B=2, T=2, S=32, C=3):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, C, (B, T, S, S))
    return {"clip": torch.from_numpy(
                rng.standard_normal((B, T, S, S, 3)).astype(np.float32)),
            "masks": torch.from_numpy(np.eye(C, dtype=np.float32)[labels])}


def _two_steps(level, compute_dtype=None, grad_accum=1):
    """Two train steps of a tiny Vivim (dropouts at their defaults, all
    on) from seed 0: (losses, state_dict, generator state)."""
    cfg = _remat_cfg(VivimConfig.tiny_test(scan_implementation=None), level)
    model = init_weights(Vivim(cfg), torch.Generator().manual_seed(0))
    state = loop.create_train_state(model, 1e-3, 1e-2, 2, seed=5)
    step = loop.make_train_step(model, "recall_focused", 3,
                                compute_dtype=compute_dtype,
                                grad_accum=grad_accum)
    losses = []
    for i in range(2):
        state, m = step(state, _batch(i))
        losses.append(m["loss"].item())
    return losses, model.state_dict(), state.generator.get_state()


@pytest.mark.parametrize("level,dtype,grad_accum", [
    ("pre_scan", None, 1), ("blocks", None, 1), ("blocks", None, 2),
    ("pre_scan", torch.bfloat16, 1), ("blocks", torch.bfloat16, 1)])
def test_remat_steps_equal_the_plain_steps(level, dtype, grad_accum):
    want_losses, want_sd, want_gen = _two_steps("none", dtype, grad_accum)
    losses, sd, gen = _two_steps(level, dtype, grad_accum)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=1e-6)
    assert sd.keys() == want_sd.keys()
    for k, v in sd.items():
        torch.testing.assert_close(v, want_sd[k], rtol=1e-5, atol=1e-6,
                                   msg=k)
    assert torch.equal(gen, want_gen)


@pytest.mark.parametrize("level", ["pre_scan", "blocks"])
def test_remat_vivim_matches_jax(level):
    """Loss sum(logits^2) of a train-mode forward and its gradients, dropout
    at 0, against the JAX remat Vivim (its test's tolerances)."""
    cfg = _remat_cfg(_no_dropout(VivimConfig.micro_test(
        scan_implementation=None)), level)
    model = init_weights(Vivim(cfg), torch.Generator().manual_seed(1))
    x = np.random.default_rng(0).standard_normal((1, 2, 32, 32, 3)).astype(
        np.float32)
    jcfg = _remat_cfg(_no_dropout(JConfig.micro_test()), level)
    variables = vivim_params_from_torch(
        {k: v.numpy() for k, v in model.state_dict().items()}, jcfg)

    def jloss(params):
        out, _ = JVivim(jcfg).apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), False, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(2)})
        return jnp.sum(out ** 2)

    jv, jg = jax.jit(jax.value_and_grad(jloss))(variables["params"])
    want = vivim_state_dict_from_jax(
        {"params": jg, "batch_stats": variables["batch_stats"]}, cfg)

    model.train()
    loss = (model(torch.from_numpy(x)) ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jv), rtol=5e-3)
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    assert len(grads) > 50
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=5e-3,
                                   atol=1e-3, err_msg=name)


def test_remat_keeps_state_dict_keys_and_eval_logits():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 3, 32, 32, 3)).astype(np.float32))
    outs, keys = [], []
    for level in ("none", "pre_scan", "blocks"):
        cfg = _remat_cfg(VivimConfig.tiny_test(scan_implementation=None),
                         level)
        model = init_weights(Vivim(cfg), torch.Generator().manual_seed(0))
        keys.append({k: tuple(v.shape) for k, v in
                     model.state_dict().items()})
        with torch.no_grad():
            outs.append(model.eval()(x))
    assert keys[0] == keys[1] == keys[2]
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)
    torch.testing.assert_close(outs[2], outs[0], rtol=0, atol=0)


def test_checkpoint_refuses_a_batchnorm():
    region = nn.Sequential(nn.Linear(4, 4), nn.BatchNorm1d(4))
    with pytest.raises(ValueError, match="BatchNorm"):
        checkpoint(region, torch.zeros(2, 4, requires_grad=True))
