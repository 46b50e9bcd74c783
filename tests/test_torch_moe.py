"""The port's MoE FFN and MoE-Mamba LM (``vivim_tpu_torch/nn/moe.py``)
against the JAX package's ``nn/moe.py``: the counterparts of
``tests/test_moe.py``'s 9 cases, each held against the JAX function on the
same numpy inputs from a seed (the JAX LM on its sequential scan,
``scan_implementation="ref"``; the port on the CPU, where the scan's
plain versions run).

Tolerances: dispatch bit-equal, combine and aux within 1e-6 (the same fp32
softmax on both sides); ``moe_ffn`` within 1e-5; gradients within rtol
1e-4 / atol 1e-5; the LM's logits and aux within 1e-4.  The router
kernels are scaled up so that routing is decisive and capacity drops
tokens: every case with drops says so, and asserts it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.torch_lm_helpers import moe_pair
from vivim_tpu.nn import moe as jmoe
from vivim_tpu_torch.convert import from_jax
from vivim_tpu_torch.nn import moe as tmoe

torch.set_num_threads(1)

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _params(seed, M=16, E=4, F_=32, router_scale=0.5):
    """Numpy MoE params from a seed (the JAX test's scales)."""
    rng = np.random.default_rng(seed)
    return {"router_kernel": (router_scale * rng.standard_normal((M, E))
                              ).astype(np.float32),
            "wi": (0.1 * rng.standard_normal((E, M, F_))).astype(np.float32),
            "wo": (0.1 * rng.standard_normal((E, F_, M))).astype(np.float32)}


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _probs(seed, T, E):
    return np.array(jax.nn.softmax(jnp.asarray(_x(seed, T, E) * 2.0), -1))


def _t(d):
    return {k: torch.from_numpy(v.copy()) for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def test_moe_capacity_matches_jax():
    for T, E, cf in ((64, 4, 1.0), (64, 4, 1.25), (3, 8, 1.0), (256, 8, 1.25),
                     (10, 3, 1.1), (7, 7, 1.0), (1, 8, 0.5)):
        assert tmoe.moe_capacity(T, E, cf) == jmoe.moe_capacity(T, E, cf)


# (T, E, C, top_k): the first of each top-k drops tokens; the top-2 case
# at C = 5 fills slots in round 2 after round 1's
DISPATCH_CASES = {"top1_drops": (12, 3, 2, 1), "top1_ample": (10, 4, 10, 1),
                  "top2_drops": (12, 3, 5, 2), "top2_ample": (8, 4, 8, 2)}


@pytest.mark.parametrize("case", list(DISPATCH_CASES))
def test_dispatch_matches_jax(case):
    T, E, C, k = DISPATCH_CASES[case]
    probs = _probs(1, T, E)
    jd, jc, ja = (np.asarray(v) for v in jmoe.moe_dispatch(
        jnp.asarray(probs), C, top_k=k))
    td, tc, ta = tmoe.moe_dispatch(torch.from_numpy(probs), C, top_k=k)
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    kept = jd.reshape(T, -1).sum(-1)
    if case.endswith("drops"):
        assert kept.min() < k, "this case must drop tokens"
    else:
        assert (kept == k).all()
    if case == "top2_drops":
        # round 2 fills slots after round 1's: some expert holds a token of
        # each round
        first = F.one_hot(torch.from_numpy(probs).argmax(-1), E).numpy()
        per_expert = jd.sum((0, 2))
        assert (per_expert > first.sum(0)).any()


def test_moe_ffn_matches_jax_with_drops():
    p = _params(2, router_scale=2.0)
    x = _x(3, 10, 16)
    y_j, aux_j = jmoe.moe_ffn(_j(p), jnp.asarray(x), capacity_factor=1.0)
    y_t, aux_t = tmoe.moe_ffn(_t(p), torch.from_numpy(x),
                              capacity_factor=1.0)
    probs = jax.nn.softmax(jnp.asarray(x) @ p["router_kernel"], -1)
    d, _, _ = jmoe.moe_dispatch(probs, jmoe.moe_capacity(10, 4, 1.0))
    assert float(jnp.sum(d)) < 10, "capacity must drop a token here"
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_leading_dims_match_jax(top_k):
    p = _params(4)
    x = _x(5, 2, 6, 16)
    y_j, aux_j = jmoe.moe_ffn(_j(p), jnp.asarray(x), top_k=top_k)
    y_t, aux_t = tmoe.moe_ffn(_t(p), torch.from_numpy(x), top_k=top_k)
    assert y_t.shape == x.shape
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)
    y2, _ = tmoe.moe_ffn(_t(p), torch.from_numpy(x.reshape(12, 16)),
                         top_k=top_k)
    np.testing.assert_allclose(y_t.numpy(), y2.numpy().reshape(2, 6, 16),
                               atol=1e-6)


def _jax_ffn_grads(p, x, **kw):
    def loss(p, x):
        y, aux = jmoe.moe_ffn(p, x, **kw)
        return jnp.mean(y ** 2) + 1e-2 * aux

    return jax.grad(loss, argnums=(0, 1))(_j(p), jnp.asarray(x))


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_grads_match_jax(top_k):
    """Router, wi, wo and x against ``jax.grad`` of mean(y^2) + 1e-2 aux,
    with drops (capacity factor 1.0): the router gets its gradient through
    the gates and the aux loss, x through the dispatch and the router."""
    p = _params(6, router_scale=2.0)
    x = _x(7, 8, 16)
    gp_j, gx_j = _jax_ffn_grads(p, x, capacity_factor=1.0, top_k=top_k)
    tp = {k: v.requires_grad_(True) for k, v in _t(p).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.moe_ffn(tp, tx, capacity_factor=1.0, top_k=top_k)
    ((y ** 2).mean() + 1e-2 * aux).backward()
    for k in p:
        assert float(tp[k].grad.abs().max()) > 0, k
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(gp_j[k]),
                                   err_msg=k, **GRAD_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx_j),
                               err_msg="x", **GRAD_TOL)


def test_expert_gelu_is_tanh():
    """``jax.nn.gelu`` is the tanh approximation: the port's experts match
    the JAX ones within 1e-6, and the same experts with torch's default
    erf GELU miss them by far more than ``moe_ffn``'s 1e-5 tolerance."""
    p = _params(8)
    x = _x(9, 4, 12, 16)
    want = np.asarray(jmoe.expert_ffn(jnp.asarray(p["wi"]),
                                      jnp.asarray(p["wo"]), jnp.asarray(x)))
    t = _t(p)
    got = tmoe.expert_ffn(t["wi"], t["wo"], torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    h = F.gelu(torch.bmm(torch.from_numpy(x), t["wi"]))  # erf
    erf = torch.bmm(h, t["wo"]).numpy()
    assert np.abs(erf - want).max() > 1e-4


def test_switch_ffn_on_converted_params():
    x = _x(10, 2, 5, 16)
    m = jmoe.SwitchFFN(n_experts=4, d_ff=32)
    v = m.init(jax.random.PRNGKey(9), jnp.asarray(x))
    y_j, aux_j = m.apply(v, jnp.asarray(x))
    t = tmoe.SwitchFFN(16, 4, 32)
    t.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in
                       v["params"].items()}, strict=True)
    with torch.no_grad():
        y_t, aux_t = t(torch.from_numpy(x))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)
    assert float(aux_t) > 0.0
    # the init draws N(0, 0.02), the JAX scheme
    t.init_parameters(torch.Generator().manual_seed(0))
    assert abs(float(t.wi.detach().std()) - 0.02) < 2e-3


LM_CASES = {"layernorm": {}, "rmsnorm": dict(rms_norm=True)}
LM_BASE = dict(vocab_size=40, d_model=16, n_layer=2, n_experts=4, d_ff=32,
               moe_every=1)


def _jax_lm_grads(jmodel, params, toks, w):
    def loss(p):
        logits, aux = jmodel.apply({"params": p}, toks)
        logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), -1)
        ce = -jnp.take_along_axis(logp, toks[:, 1:, None], -1).mean()
        return ce + w * aux

    return jax.value_and_grad(loss)(params)


@pytest.mark.parametrize("norm", list(LM_CASES))
def test_moe_mamba_lm_matches_jax(norm):
    """Logits and aux within 1e-4 of ``MoEMambaLM.apply``; the next-token
    loss + aux_loss_weight x aux within 1e-6 relative and every leaf's
    gradient against ``jax.grad`` (the tied embedding's too)."""
    cfg_kw = dict(LM_BASE, **LM_CASES[norm])
    jmodel, params, tmodel, cfg = moe_pair(cfg_kw)
    toks = np.random.default_rng(12).integers(0, 40, (2, 8)).astype(np.int32)
    logits_j, aux_j = jmodel.apply({"params": params}, jnp.asarray(toks))
    tt = torch.from_numpy(toks).long()
    logits_t, aux_t = tmodel(tt)
    assert logits_t.shape == (2, 8, cfg.padded_vocab)
    np.testing.assert_allclose(logits_t.detach().numpy(),
                               np.asarray(logits_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(aux_t.item(), float(aux_j), rtol=1e-4)
    assert aux_t.item() > 0.0
    value, grads = _jax_lm_grads(jmodel, params, jnp.asarray(toks),
                                 cfg.aux_loss_weight)
    want = from_jax.moe_lm_state_dict_from_jax(grads, cfg)
    logp = torch.log_softmax(logits_t[:, :-1].float(), -1)
    loss = -logp.gather(-1, tt[:, 1:, None]).mean() \
        + cfg.aux_loss_weight * aux_t
    np.testing.assert_allclose(loss.item(), float(value), rtol=1e-6)
    loss.backward()
    named = dict(tmodel.named_parameters())
    assert set(named) == set(want)
    for k, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                   err_msg=k, **GRAD_TOL)
    for blk in ("moe_0", "moe_1"):
        for leaf in ("router_kernel", "wi", "wo"):
            assert float(named[f"{blk}.{leaf}"].grad.abs().max()) > 0


def test_moe_every_zero_disables():
    cfg_kw = dict(vocab_size=40, d_model=16, n_layer=2, moe_every=0)
    jmodel, params, tmodel, _ = moe_pair(cfg_kw, seed=13)
    assert not any(k.startswith("moe") for k in params)
    assert not any(k.startswith("moe") for k in tmodel.state_dict())
    toks = np.random.default_rng(14).integers(0, 40, (1, 4)).astype(np.int32)
    logits_j, aux_j = jmodel.apply({"params": params}, jnp.asarray(toks))
    logits_t, aux_t = tmodel(torch.from_numpy(toks).long())
    assert float(aux_j) == 0.0 and float(aux_t) == 0.0
    np.testing.assert_allclose(logits_t.detach().numpy(),
                               np.asarray(logits_j), rtol=1e-4, atol=1e-4)


def test_moe_every_two_and_init():
    """``moe_every=2``: an MoE block after mixer 1 only; ``init_moe_lm``
    seeds a model on the CPU when asked for it, the same from one seed,
    the embedding N(0, initializer_range), and ``moe_lm_forward`` on its
    parameters is the module's forward."""
    cfg = tmoe.MoEMambaLMConfig(vocab_size=40, d_model=16, n_layer=2,
                                n_experts=4, d_ff=32, moe_every=2)
    a = tmoe.init_moe_lm(cfg, seed=3, device="cpu")
    b = tmoe.init_moe_lm(cfg, seed=3, device="cpu")
    names = {k.split(".")[0] for k in a.state_dict()}
    assert {"moe_1", "moe_norm_1"} <= names and "moe_0" not in names
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    assert abs(float(a.embedding.detach().std()) - 0.02) < 2e-3
    toks = torch.randint(0, 40, (2, 6), generator=torch.Generator()
                         .manual_seed(0))
    with torch.no_grad():
        logits, aux = a(toks)
        logits2, aux2 = tmoe.moe_lm_forward(cfg, dict(a.named_parameters()),
                                            toks)
    assert torch.equal(logits, logits2) and torch.equal(aux, aux2)
