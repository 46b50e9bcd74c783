"""Gradients of the port's Mamba LM (``nn/lm.py``) against ``jax.grad``.

A next-token cross-entropy of seeded tokens through the port's
``MambaLM.forward`` and through ``forward_functional`` (the prefill path
that ``generate`` and the eval core use), on the CPU, where the scan's
autograd Function runs the plain versions of K1-training and K2; the
oracle is ``jax.grad`` of the same loss through the JAX ``MambaLM.apply``
on its sequential scan (``implementation="ref"``: the Pallas backward is
wrong for d_inner > 128, ROADMAP F1).  Same weights on both sides
(``tests/torch_lm_helpers.py``, norms, dt biases and D perturbed); the
JAX gradient tree crosses into the port's names with
``from_jax.mamba_lm_state_dict_from_jax`` (a linear map, so it maps
gradients as it maps weights).  Every leaf at rtol 1e-4 / atol 1e-5, ten
times tighter than ROADMAP's gradient level (rtol 1e-3 / atol 2e-3): both
sides are fp32 sequential sums, apart by summation order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_lm_helpers import make_pair, tokens
from vivim_tpu_torch.convert import from_jax
from vivim_tpu_torch.nn import lm as tlm

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
NORMS = {"layernorm": {}, "rmsnorm": dict(rms_norm=True),
         "rmsnorm_fp32_residual": dict(rms_norm=True, residual_in_fp32=True)}


def next_token_loss(logits, toks):
    """Mean cross-entropy of each position's next token (torch)."""
    logp = torch.log_softmax(logits[:, :-1].float(), -1)
    return -logp.gather(-1, toks[:, 1:, None]).mean()


def jax_grads(jmodel, params, toks):
    def loss(p):
        logits = jmodel.apply({"params": p}, toks)
        logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), -1)
        return -jnp.take_along_axis(logp, toks[:, 1:, None], -1).mean()

    value, grads = jax.value_and_grad(loss)(params)
    return float(value), grads


@pytest.fixture(scope="module", params=list(NORMS))
def case(request):
    jmodel, params, tmodel = make_pair(seed=3, **NORMS[request.param])
    toks = tokens((2, 11), seed=4)
    value, grads = jax_grads(jmodel, params, jnp.asarray(toks))
    want = {k: v.numpy() for k, v in from_jax.mamba_lm_state_dict_from_jax(
        grads, tmodel.cfg.n_layer).items() if k != "lm_head.weight"}
    return tmodel, torch.from_numpy(toks).long(), value, want


def _check(got_loss, grads, value, want):
    np.testing.assert_allclose(float(got_loss.detach()), value, rtol=1e-6)
    assert set(grads) == set(want)
    for k, g in grads.items():
        assert g is not None, k
        np.testing.assert_allclose(g.numpy(), want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_module_gradients_match_jax(case):
    tmodel, toks, value, want = case
    tmodel.zero_grad()
    loss = next_token_loss(tmodel(toks), toks)
    loss.backward()
    _check(loss, {k: p.grad for k, p in tmodel.named_parameters()}, value,
           want)


def test_forward_functional_gradients_match_jax(case):
    """``forward_functional`` is differentiable in its dict's tensors; the
    eval core and ``generate`` stay graph-free on their own."""
    tmodel, toks, value, want = case
    params = {k: v.clone().requires_grad_(True)
              for k, v in tlm.lm_params(tmodel).items()}
    loss = next_token_loss(tlm.forward_functional(tmodel, params, toks), toks)
    loss.backward()
    _check(loss, {k: p.grad for k, p in params.items()}, value, want)
    assert not tlm.generate(tmodel, params, toks[:1, :4], 2).requires_grad
