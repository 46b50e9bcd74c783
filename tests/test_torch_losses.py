"""Every entry of the PyTorch port's ``LOSSES`` against the JAX package's,
on the same numpy logits and targets, values and gradients (fp32; rtol
1e-5 / atol 1e-6 on values, the grads' rtol 1e-3 / atol 2e-3 on
gradients)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivim_tpu.train import losses as jlosses
from vivim_tpu_torch.train import losses as tlosses

torch.set_num_threads(1)


def test_same_table():
    assert list(tlosses.LOSSES) == list(jlosses.LOSSES)
    assert list(tlosses.LOSSES)[0] == "recall_focused"


@pytest.mark.parametrize("name", sorted(jlosses.LOSSES))
def test_loss_matches_jax(name):
    rng = np.random.default_rng(sorted(jlosses.LOSSES).index(name))
    logits = (2.0 * rng.standard_normal((3, 40, 36, 3))).astype(np.float32)
    targets = rng.integers(0, 3, (3, 40, 36))
    targets[1] = 0  # a frame where only the background is present
    want, jgrad = jax.value_and_grad(
        lambda x: jlosses.LOSSES[name](x, jnp.asarray(targets), 3))(
            jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = tlosses.LOSSES[name](x, torch.from_numpy(targets), 3)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=1e-3,
                               atol=2e-3)
