"""The port's edge-aware and binary training paths against the JAX
package's, on the same numpy inputs.

- Losses (``structure_loss``, the edge terms, InverseForm on random
  regressor weights carried across, both edge criteria): values within rtol
  1e-5 / atol 1e-6, gradients against ``jax.grad`` within rtol 1e-3 / atol
  2e-3 (``tests/test_torch_losses.py``'s tolerances).
- Saliency metrics: every class's ``get_results()`` within rtol 1e-12.
- The binary step (center frame, Adam without clipping, with and without
  the edge head, ``grad_accum`` 1 and 2) and the multiclass step with the
  ``-with_edge`` criterion, one update at the micro config with every
  dropout at 0 (the two frameworks' random streams cannot match): loss,
  parameters and BatchNorm statistics at ``tests/test_torch_train_step.py``'s
  tolerances, with its structurally-zero-gradient biases checked as noise.
- The binary eval step and ``BinaryValidator.results()``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_step import LR, ZERO_GRAD, _flat, _no_dropout
from vivim_tpu.convert.torch_to_jax import vivim_params_from_torch
from vivim_tpu.nn.vivim import Vivim as JVivim
from vivim_tpu.nn.vivim import VivimConfig as JConfig
from vivim_tpu.train import binary as jbinary
from vivim_tpu.train import edge_loss as jedge
from vivim_tpu.train import losses as jlosses
from vivim_tpu.train import loop as jloop
from vivim_tpu.train import saliency_metrics as jsm
from vivim_tpu_torch.convert.from_jax import inverse_net_state_dict_from_jax
from vivim_tpu_torch.nn.layers import init_weights
from vivim_tpu_torch.nn.vivim import Vivim, VivimConfig
from vivim_tpu_torch.train import binary, loop
from vivim_tpu_torch.train import edge_loss as tedge
from vivim_tpu_torch.train import losses as tlosses
from vivim_tpu_torch.train import saliency_metrics as tsm

torch.set_num_threads(1)

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-3, atol=2e-3)
# the InverseForm tiles: 48 x 96 cut into 3 x 6 tiles of 16 (the
# reference's 672 x 1344 into tiles of 224 holds 100 M regressor weights)
RESIZED, TILE = 48, 16


def _maps(seed, N=2, H=24, W=20, C=1):
    """Seg logits, a binary or one-hot mask, edge logits, edge labels in
    {0, 1, 2} (2 is ignored by edge_bce)."""
    rng = np.random.default_rng(seed)
    seg = (2.0 * rng.standard_normal((N, H, W, C))).astype(np.float32)
    if C == 1:
        mask = (rng.random((N, H, W, 1)) < 0.3).astype(np.float32)
    else:
        mask = np.eye(C, dtype=np.float32)[rng.integers(0, C, (N, H, W))]
    edge = (1.5 * rng.standard_normal((N, H, W, 1)) + 0.5).astype(np.float32)
    labels = rng.choice([0.0, 1.0, 2.0], (N, H, W, 1), p=[0.7, 0.25, 0.05])
    return seg, mask, edge, labels.astype(np.float32)


def _inverse_params(seed=0, channels=1):
    rng = np.random.default_rng(seed)
    dims = (2 * TILE * TILE * channels, 1000, 32, 4)
    return {f"fc{i}": {
        "kernel": (rng.standard_normal((dims[i], dims[i + 1]))
                   / np.sqrt(dims[i])).astype(np.float32),
        "bias": (0.1 * rng.standard_normal(dims[i + 1])).astype(np.float32)}
        for i in range(3)}


def _inverse_net(params):
    net = tedge.InverseNet(tile=TILE)
    # a 2-channel edge map's tiles are twice as wide as the reference's
    net.fc[0] = torch.nn.Linear(params["fc0"]["kernel"].shape[0], 1000)
    net.load_state_dict(inverse_net_state_dict_from_jax(params))
    return net


@pytest.fixture
def small_inverse_form(monkeypatch):
    """Both packages' criteria build their InverseForm at the small tile."""
    monkeypatch.setattr(jedge, "make_inverse_form", functools.partial(
        jedge.make_inverse_form, resized_dim=RESIZED))
    monkeypatch.setattr(tedge, "make_inverse_form", functools.partial(
        tedge.make_inverse_form, resized_dim=RESIZED))


def _check(jfn, tfn, arrays, wrt):
    """Value and gradients w.r.t. the arrays at indices ``wrt``."""
    want, jgrads = jax.value_and_grad(jfn, argnums=wrt)(
        *[jnp.asarray(a) for a in arrays])
    ts = [torch.tensor(a, requires_grad=i in wrt)
          for i, a in enumerate(arrays)]
    got = tfn(*ts)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **VAL)
    for i, g in zip(wrt, jgrads):
        # no graph reaches an input the loss reads only through a gate:
        # its gradient is 0, which JAX returns as zeros
        got_g = (ts[i].grad.numpy() if ts[i].grad is not None
                 else np.zeros_like(arrays[i]))
        np.testing.assert_allclose(got_g, np.asarray(g), **GRAD)


@pytest.mark.parametrize("iou,legacy_wbce", [
    (True, False), (False, False), (True, True), (False, True)])
def test_structure_loss_matches_jax(iou, legacy_wbce):
    seg, mask, _, _ = _maps(0)
    _check(lambda p, m: jlosses.structure_loss(p, m, iou, legacy_wbce),
           lambda p, m: tlosses.structure_loss(p, m, iou, legacy_wbce),
           (seg, mask), (0,))


def test_edge_bce_matches_jax():
    _, _, edge, labels = _maps(1)
    assert (labels == 2).any()  # ignored through the zero weight
    _check(jedge.edge_bce, tedge.edge_bce, (edge, labels), (0,))


@pytest.mark.parametrize("C", [1, 3])
def test_edge_attention_matches_jax(C):
    seg, mask, edge, _ = _maps(2, C=C)
    gate = edge > 0.8
    assert gate.any() and not gate.all()
    if C == 1:
        jl, tl = jlosses.structure_loss, tlosses.structure_loss
    else:
        jl, tl = jedge._structure_on_onehot, tedge._structure_on_onehot
    _check(lambda s, m, e: jedge.edge_attention(s, m, e, seg_loss=jl),
           lambda s, m, e: tedge.edge_attention(s, m, e, seg_loss=tl),
           (seg, mask, edge), (0, 2))


def test_inverse_form_matches_jax():
    """Random regressor weights carried across by
    ``inverse_net_state_dict_from_jax``; the edge input is a 2-channel map
    so that the log-softmax is not identically 0.  The regressor takes no
    gradient, the edge prediction does."""
    params = _inverse_params(channels=2)
    rng = np.random.default_rng(3)
    edge = rng.standard_normal((2, 20, 24, 2)).astype(np.float32)
    target = (rng.random((2, 20, 24, 2)) < 0.2).astype(np.float32)
    net = _inverse_net(params)
    _check(jedge.make_inverse_form(params, resized_dim=RESIZED),
           tedge.make_inverse_form(net, resized_dim=RESIZED),
           (edge, target), (0,))
    assert all(p.grad is None and not p.requires_grad
               for p in net.parameters())


def test_inverse_net_has_the_reference_layout():
    with torch.device("meta"):
        sd = tedge.InverseNet().state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        "fc.0.weight": (1000, 2 * 224 * 224), "fc.0.bias": (1000,),
        "fc.2.weight": (32, 1000), "fc.2.bias": (32,),
        "fc.4.weight": (4, 32), "fc.4.bias": (4,)}


@pytest.mark.parametrize("with_inverse", [False, True])
def test_multiclass_edge_criterion_matches_jax(with_inverse,
                                               small_inverse_form):
    rng = np.random.default_rng(4)
    B, T, H, W = 2, 3, 16, 20
    seg = (2.0 * rng.standard_normal((B, T, H, W, 3))).astype(np.float32)
    masks = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (B, T, H, W))]
    edge = (1.5 * rng.standard_normal((B, T, H, W, 1))
            + 0.5).astype(np.float32)
    edges = (rng.random((B, T, H, W, 1)) < 0.3).astype(np.float32)
    params = _inverse_params(1) if with_inverse else None
    _check(jedge.make_multiclass_edge_criterion(params),
           tedge.make_multiclass_edge_criterion(
               _inverse_net(params) if with_inverse else None),
           (seg, masks, edge, edges), (0, 2))


@pytest.mark.parametrize("with_inverse,legacy_wbce", [
    (False, False), (True, False), (False, True)])
def test_joint_edge_seg_loss_matches_jax(with_inverse, legacy_wbce, capsys,
                                         small_inverse_form):
    seg, mask, edge, labels = _maps(5)
    labels = np.minimum(labels, 1.0)
    params = _inverse_params(2) if with_inverse else None
    jkw = tkw = {}
    if legacy_wbce:
        jkw = dict(seg_loss=lambda p, m: jlosses.structure_loss(
            p, m, legacy_wbce=True))
        tkw = dict(seg_loss=lambda p, m: tlosses.structure_loss(
            p, m, legacy_wbce=True))
    jfn = jedge.make_joint_edge_seg_loss(params, **jkw)
    jwarn = capsys.readouterr().out
    tfn = tedge.make_joint_edge_seg_loss(
        _inverse_net(params) if with_inverse else None, **tkw)
    assert capsys.readouterr().out == jwarn
    assert ("InverseForm term is disabled" in jwarn) is (not with_inverse)
    _check(jfn, tfn, (seg, mask, edge, labels), (0, 2))


def _saliency_cases():
    rng = np.random.default_rng(6)
    yy, xx = np.mgrid[:40, :48]
    blob = ((yy - 18) ** 2 + (xx - 25) ** 2 < 120).astype(np.float64)
    return [
        (rng.random((40, 48)), blob),
        (np.clip(blob + 0.3 * rng.standard_normal(blob.shape), 0, 1), blob),
        (rng.random((40, 48)), np.zeros_like(blob)),          # all-zero GT
        (rng.random((40, 48)), np.ones_like(blob)),           # all-one GT
        (np.zeros_like(blob), blob),                          # flat pred
        ((255 * rng.random((40, 48))).round(), blob * 255),   # 0..255 range
    ]


@pytest.mark.parametrize("name", ["MAE", "Fmeasure", "Smeasure", "Emeasure",
                                  "WeightedFmeasure", "Medical"])
def test_saliency_metric_matches_jax(name):
    want, got = getattr(jsm, name)(), getattr(tsm, name)()
    for pred, gt in _saliency_cases():
        want.step(pred, gt)
        got.step(pred, gt)
    w, g = want.get_results(), got.get_results()
    assert set(w) == set(g)
    for k in w:
        np.testing.assert_allclose(np.asarray(g[k], np.float64),
                                   np.asarray(w[k], np.float64), rtol=1e-12,
                                   atol=0, err_msg=k)


def _port_model(out_chans, with_edge, seed=0):
    cfg = _no_dropout(VivimConfig.micro_test(
        scan_implementation=None, out_chans=out_chans, with_edge=with_edge))
    model = init_weights(Vivim(cfg), torch.Generator().manual_seed(seed))
    bn = model.decoder.batch_norm
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        bn.running_mean.copy_(0.1 * torch.randn(16, generator=g))
        bn.running_var.copy_(0.5 + torch.rand(16, generator=g))
    return model, cfg


def _jax_vars(model, out_chans, with_edge):
    sd = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    jcfg = _no_dropout(JConfig.micro_test(
        scan_implementation="ref", out_chans=out_chans, with_edge=with_edge))
    variables = vivim_params_from_torch(sd, jcfg)
    return JVivim(jcfg), jcfg, sd, {
        k: jax.tree_util.tree_map(jnp.asarray, variables[k])
        for k in ("params", "batch_stats")}


def _binary_batch(seed, B=2, T=3, S=32):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:S, :S]
    masks = np.zeros((B, T, S, S, 1), np.float32)
    for b in range(B):
        for t in range(T):
            cy, cx = rng.integers(8, S - 8, 2)
            masks[b, t, ..., 0] = (yy - cy) ** 2 + (xx - cx) ** 2 < 40
    edges = np.abs(np.diff(masks, axis=3, append=masks[:, :, :, -1:]))
    return {"clip": rng.standard_normal((B, T, S, S, 3)).astype(np.float32),
            "masks": masks, "edges": edges}


def _multiclass_batch(seed, B=2, T=3, S=32, C=3):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, C, (B, T, S, S))
    return {"clip": rng.standard_normal((B, T, S, S, 3)).astype(np.float32),
            "masks": np.eye(C, dtype=np.float32)[labels],
            "edges": (rng.random((B, T, S, S, 1)) < 0.2).astype(np.float32)}


def _compare_state(model, jcfg, jstate, sd, loss, jloss, grad_scale):
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    grads = {n: p.grad for n, p in model.named_parameters()}
    for _, name in ZERO_GRAD:
        assert grads[name].abs().max() < 1e-6 * grad_scale, name
    got = vivim_params_from_torch(
        {k: v.detach().numpy() for k, v in model.state_dict().items()}, jcfg)
    for what in ("params", "batch_stats"):
        want_flat, got_flat = _flat(getattr(jstate, what)), _flat(got[what])
        assert set(want_flat) <= set(got_flat)
        skip = {k for k, _ in ZERO_GRAD} if what == "params" else set()
        tol = (dict(rtol=1e-4, atol=2e-5) if what == "params"
               else dict(rtol=1e-3, atol=1e-4))
        for k, w in want_flat.items():
            if k not in skip:
                np.testing.assert_allclose(got_flat[k], w, **tol,
                                           err_msg=f"{what}{k}")
    moved = max(np.abs(got_flat[k] - np.asarray(v)).max()
                for k, v in _flat(vivim_params_from_torch(
                    sd, jcfg)["batch_stats"]).items())
    assert moved > 1e-3  # the BatchNorm statistics were updated


@pytest.mark.parametrize("with_edge,grad_accum", [
    (False, 1), (False, 2), (True, 1), (True, 2)])
def test_binary_train_step_matches_jax(with_edge, grad_accum):
    model, _ = _port_model(1, with_edge)
    jmodel, jcfg, sd, jvars = _jax_vars(model, 1, with_edge)
    tx, _ = jbinary.make_binary_optimizer(LR, 1)
    jstate = jloop.TrainState(
        step=jnp.zeros((), jnp.int32), params=jvars["params"],
        batch_stats=jvars["batch_stats"], opt_state=tx.init(jvars["params"]),
        rng=jax.random.PRNGKey(0))
    jedge_fn = jedge.make_joint_edge_seg_loss() if with_edge else None
    jstep = jbinary.make_binary_train_step(jmodel, tx, with_edge, jedge_fn,
                                           grad_accum=grad_accum)
    opt, _ = binary.make_binary_optimizer(model, LR, 1)
    state = loop.TrainState(step=0, model=model, opt=opt,
                            generator=torch.Generator().manual_seed(0))
    step = binary.make_binary_train_step(
        model, tedge.make_joint_edge_seg_loss() if with_edge else None,
        grad_accum=grad_accum)
    batch = _binary_batch(grad_accum + 2 * with_edge)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state, m = step(state, {k: torch.from_numpy(v)
                            for k, v in batch.items()})
    assert state.step == 1 == int(jstate.step)
    grad_scale = float(torch.linalg.vector_norm(torch.stack(
        [p.grad.norm() for p in model.parameters() if p.grad is not None])))
    _compare_state(model, jcfg, jstate, sd, float(m["loss"]),
                   float(jm["loss"]), grad_scale)


def test_binary_optimizer_does_not_clip():
    """A gradient of norm 1e3 moves each parameter by lr (Adam's first step
    with no clipping), as optax.adam does."""
    model = torch.nn.Linear(4, 3)
    opt, schedule = binary.make_binary_optimizer(model, 1e-2, 10)
    before = [p.detach().clone() for p in model.parameters()]
    for p in model.parameters():
        p.grad = torch.full_like(p, 500.0)
    assert opt.step() is None
    for p, b in zip(model.parameters(), before):
        torch.testing.assert_close(b - p.detach(), torch.full_like(b, 1e-2))
    _, jschedule = jbinary.make_binary_optimizer(1e-2, 10)
    for s in range(12):
        np.testing.assert_allclose(schedule(s), float(jschedule(s)),
                                   rtol=1e-6)


@pytest.mark.parametrize("with_edge", [False, True])
def test_binary_eval_step_and_validator_match_jax(with_edge):
    model, _ = _port_model(1, with_edge, seed=3)
    jmodel, _, _, jvars = _jax_vars(model, 1, with_edge)
    jstate = jloop.TrainState(step=0, params=jvars["params"],
                              batch_stats=jvars["batch_stats"],
                              opt_state=None, rng=None)
    batch = _binary_batch(7)
    jl, jpred, jmask = jbinary.make_binary_eval_step(jmodel, with_edge)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state = loop.TrainState(step=0, model=model, opt=None, generator=None)
    loss, pred, mask = binary.make_binary_eval_step(model)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert not model.training and tuple(pred.shape) == (2, 32, 32, 1)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    # the validators on the same center frames (the JAX step's), the
    # port's fed torch tensors
    want, got = jbinary.BinaryValidator(), binary.BinaryValidator()
    for i in range(2):
        p = np.asarray(jpred) ** (i + 1)
        want.update(jl, p, np.asarray(jmask))
        got.update(torch.tensor(float(jl)), torch.from_numpy(p),
                   torch.from_numpy(np.array(jmask)))
    w, g = want.results(), got.results()
    assert list(g) == list(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-12, err_msg=k)


@pytest.mark.parametrize("grad_accum,bf16", [(1, False), (2, False),
                                             (1, True)])
def test_multiclass_with_edge_step_matches_jax(grad_accum, bf16):
    """``make_train_step`` with ``make_multiclass_edge_criterion``.  In
    bf16 the edge logits reach the loss as the model gives them (the loss
    casts); compared on the loss at the bf16 tolerance, and the grad norm
    only for being finite: on the CPU, torch's oneDNN bf16 conv of the
    channels-last ``sr`` input errs by about its own size (2.13.0+cpu), so
    the port's bf16 gradients there are not the card's."""
    model, _ = _port_model(3, True, seed=5)
    jmodel, jcfg, sd, jvars = _jax_vars(model, 3, True)
    tx, _ = jloop.make_optimizer(LR, 0.5, 1)
    jstate = jloop.TrainState(
        step=jnp.zeros((), jnp.int32), params=jvars["params"],
        batch_stats=jvars["batch_stats"], opt_state=tx.init(jvars["params"]),
        rng=jax.random.PRNGKey(0))
    jstep = jloop.make_train_step(
        jmodel, "recall_focused", 3, tx,
        edge_loss_fn=jedge.make_multiclass_edge_criterion(),
        compute_dtype=jnp.bfloat16 if bf16 else None, grad_accum=grad_accum)
    state = loop.create_train_state(model, LR, 0.5, 1, seed=0)
    step = loop.make_train_step(
        model, "recall_focused", 3,
        compute_dtype=torch.bfloat16 if bf16 else None,
        grad_accum=grad_accum,
        edge_loss_fn=tedge.make_multiclass_edge_criterion())
    batch = _multiclass_batch(11 + grad_accum)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state, m = step(state, {k: torch.from_numpy(v)
                            for k, v in batch.items()})
    if bf16:
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=3e-2, atol=5e-2)
        assert np.isfinite(float(m["grad_norm"]))
        return
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-3)
    _compare_state(model, jcfg, jstate, sd, float(m["loss"]),
                   float(jm["loss"]), float(m["grad_norm"]))


def test_multiclass_eval_step_with_edges_matches_jax():
    model, _ = _port_model(3, True, seed=6)
    jmodel, _, _, jvars = _jax_vars(model, 3, True)
    jstate = jloop.TrainState(step=0, params=jvars["params"],
                              batch_stats=jvars["batch_stats"],
                              opt_state=None, rng=None)
    batch = _multiclass_batch(13)
    jcrit = jedge.make_multiclass_edge_criterion()
    jl, jconf, _ = jloop.make_eval_step(
        jmodel, "recall_focused", 3, with_edge=True, edge_loss_fn=jcrit)(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state = loop.TrainState(step=0, model=model, opt=None, generator=None)
    loss, conf, _ = loop.make_eval_step(
        model, "recall_focused", 3, with_edge=True,
        edge_loss_fn=tedge.make_multiclass_edge_criterion())(
            state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    np.testing.assert_array_equal(conf.numpy(), np.asarray(jconf))
    plain, _, _ = loop.make_eval_step(model, "recall_focused", 3,
                                      with_edge=True)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(loss) > float(plain)  # the edge terms count


def test_edge_head_and_edge_loss_come_together():
    model, _ = _port_model(3, True)
    state = loop.create_train_state(model, LR, 0.0, 1, seed=0)
    batch = {k: torch.from_numpy(v)
             for k, v in _multiclass_batch(0).items()}
    with pytest.raises(ValueError, match="come together"):
        loop.make_train_step(model, "recall_focused", 3)(state, batch)
