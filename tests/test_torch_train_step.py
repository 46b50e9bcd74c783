"""One train step of the PyTorch port against the JAX package's.

The same weights (the port's seeded init, with random BatchNorm running
statistics, taken to JAX by ``vivim_params_from_torch``) and the same numpy
batch go through the port's ``make_train_step`` (on the CPU: the scan's
autograd Function with the plain kernel versions) and the JAX
``make_train_step`` with ``scan_implementation="ref"``.  Dropout,
drop-path and scale dropout are 0: the two frameworks' random streams
cannot match.  Compared: loss, jaccard, grad_norm, and every parameter and
BatchNorm statistic after the update.  Tolerances: loss rtol 1e-4;
grad_norm rtol 1e-3 (the grads' tolerance); parameters atol 2e-5, 2 % of
lr = 1e-3.  Adam's first steps move each element by about lr, so a wrong
gradient or schedule shows at 1e-3, and a wrong decay mask at lr * wd * |p|
(wd = 5).  The BatchNorm statistics are statistics of activations: the
modules' tolerance, rtol 1e-3 / atol 1e-4.  The biases that reach the train-mode BatchNorm only as
per-channel shifts (``ZERO_GRAD``) have a true gradient of exactly zero,
since the batch mean cancels them: both frameworks give them noise, which
Adam scales to lr * g / (|g| + 1e-8).  For those the test asserts that the
port's gradient is at noise level instead of comparing noise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivim_tpu.convert.torch_to_jax import vivim_params_from_torch
from vivim_tpu.nn.vivim import Vivim as JVivim
from vivim_tpu.nn.vivim import VivimConfig as JConfig
from vivim_tpu.train import loop as jloop
from vivim_tpu_torch.nn.layers import init_weights
from vivim_tpu_torch.nn.vivim import Vivim, VivimConfig
from vivim_tpu_torch.train import loop

torch.set_num_threads(1)

LR = 1e-3
# (JAX key, port name) of the parameters whose gradient is structurally 0
ZERO_GRAD = (("['linear_c_0']['bias']", "decoder.linear_c.0.proj.bias"),
             ("['linear_c_1']['bias']", "decoder.linear_c.1.proj.bias"),
             ("['encoder']['mamba_1_0']['mlp']['fc2']['bias']",
              "encoder.stages.1.0.0.mlp.fc2.bias"))


def _no_dropout(cfg):
    return dataclasses.replace(
        cfg, drop_path_rate=0.0, dropout_rate=0.0,
        segformer=dataclasses.replace(cfg.segformer, drop_path_rate=0.0,
                                      classifier_dropout=0.0))


def _port_model(seed=0):
    cfg = _no_dropout(VivimConfig.micro_test(scan_implementation=None))
    model = init_weights(Vivim(cfg), torch.Generator().manual_seed(seed))
    bn = model.decoder.batch_norm
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        bn.running_mean.copy_(0.1 * torch.randn(16, generator=g))
        bn.running_var.copy_(0.5 + torch.rand(16, generator=g))
    return model, cfg


def _batch(seed, B=2, T=2, S=32, C=3):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, C, (B, T, S, S))
    return {"clip": rng.standard_normal((B, T, S, S, 3)).astype(np.float32),
            "masks": np.eye(C, dtype=np.float32)[labels]}


def _jax_state(sd, weight_decay, total_steps, decay_mask):
    jcfg = _no_dropout(JConfig.micro_test(scan_implementation="ref"))
    variables = vivim_params_from_torch(sd, jcfg)
    tx, _ = jloop.make_optimizer(LR, weight_decay, total_steps,
                                 decay_mask=decay_mask)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = jloop.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=tx.init(params), rng=jax.random.PRNGKey(0))
    return JVivim(jcfg), jcfg, state, tx


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("decay_mask,grad_accum,n_steps", [
    ("tagged", 1, 1),
    ("torch", 2, 3),   # cosine lr over three steps, two micro-batches
])
def test_train_step_matches_jax(decay_mask, grad_accum, n_steps):
    model, cfg = _port_model()
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    weight_decay = 5.0  # large enough that a wrong decay mask shows
    jmodel, jcfg, jstate, tx = _jax_state(sd, weight_decay, n_steps,
                                          decay_mask)
    jstep = jloop.make_train_step(jmodel, "recall_focused", 3, tx,
                                  grad_accum=grad_accum)
    state = loop.create_train_state(model, LR, weight_decay, n_steps,
                                    seed=0, decay_mask=decay_mask)
    step = loop.make_train_step(model, "recall_focused", 3,
                                grad_accum=grad_accum)
    for i in range(n_steps):
        batch = _batch(i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(m["jaccard"]), float(jm["jaccard"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-3)
    assert state.step == n_steps == int(jstate.step)
    grads = {n: p.grad for n, p in model.named_parameters()}
    for _, name in ZERO_GRAD:
        assert grads[name].abs().max() < 1e-6 * float(m["grad_norm"]), name
    got = vivim_params_from_torch(
        {k: v.detach().numpy() for k, v in model.state_dict().items()}, jcfg)
    for what in ("params", "batch_stats"):
        want_flat, got_flat = _flat(jstate.__getattribute__(what)), _flat(
            got[what])
        assert set(want_flat) <= set(got_flat)
        skip = {k for k, _ in ZERO_GRAD} if what == "params" else set()
        tol = (dict(rtol=1e-4, atol=2e-5) if what == "params"
               else dict(rtol=1e-3, atol=1e-4))
        for k, w in want_flat.items():
            if k in skip:
                continue
            np.testing.assert_allclose(got_flat[k], w, **tol,
                                       err_msg=f"{what}{k}")
    moved = max(np.abs(got_flat[k] - np.asarray(v)).max()
                for k, v in _flat(vivim_params_from_torch(
                    sd, jcfg)["batch_stats"]).items())
    assert moved > 1e-3  # the BatchNorm statistics were updated


def test_decay_masks_match_jax():
    """The tagged mask decays exactly the parameters the JAX mask decays,
    under the weight mapping; "torch" decays all."""
    model, _ = _port_model()
    jcfg = _no_dropout(JConfig.micro_test())
    for mode in ("tagged", "torch"):
        mask = loop._no_decay_mask(model, mode)
        sd = {k: (np.ones if mask.get(k) else np.zeros)(v.shape, np.float32)
              for k, v in model.state_dict().items()}
        tree = vivim_params_from_torch(sd, jcfg)["params"]
        want = (jloop._no_decay_mask(tree) if mode == "tagged"
                else jax.tree_util.tree_map(lambda _: True, tree))
        flat, flat_w = _flat(tree), _flat(want)
        assert len(flat) > 40
        for k, v in flat.items():
            assert bool(v.all()) == bool(flat_w[k]), (mode, k)
            assert bool(v.any()) == bool(flat_w[k]), (mode, k)


def test_cosine_schedule_matches_optax():
    _, schedule = jloop.make_optimizer(3e-4, 0.01, 10)
    for s in range(14):
        np.testing.assert_allclose(loop.cosine_lr(3e-4, 10, 0.01, s),
                                   float(schedule(s)), rtol=1e-6)


def test_eval_step_matches_jax():
    model, cfg = _port_model(seed=3)
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    jmodel, _, jstate, _ = _jax_state(sd, 0.0, 1, "tagged")
    batch = _batch(7)
    jl, jconf, jcm = jloop.make_eval_step(jmodel, "recall_focused", 3)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state = loop.create_train_state(model, LR, 0.0, 1, seed=0)
    loss, conf, cm, preds = loop.make_eval_step(
        model, "recall_focused", 3, return_preds=True)(
            state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    np.testing.assert_array_equal(conf.numpy(), np.asarray(jconf))
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
    assert tuple(preds.shape) == (4, 32, 32)
    assert not model.training
