"""MambaV3 and MambaLayer of the PyTorch port against the JAX package.

Weights come from the JAX ``init`` and cross through
``vivim_tpu_torch.convert.from_jax``; outputs are compared against the JAX
modules on the sequential scan (``scan_implementation="ref"``) at rtol 1e-3
/ atol 1e-4, the level of tests/test_vivim_golden.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from vivim_tpu.nn import mamba as jm
from vivim_tpu_torch.convert import from_jax
from vivim_tpu_torch.nn import mamba as tm
from vivim_tpu_torch.nn.layers import init_weights

torch.set_num_threads(1)

B, T, S, D_MODEL = 2, 5, 6, 16


def _x(seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, T * S, D_MODEL)).astype(np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("bimamba", ["v3", "v2", "none"])
def test_mamba_v3_matches_jax(bimamba):
    x = _x()
    jmod = jm.MambaV3(d_model=D_MODEL, bimamba_type=bimamba,
                      scan_implementation="ref")
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), nframes=T)
    want = jmod.apply(params, jnp.asarray(x), nframes=T)
    tmod = tm.MambaV3(D_MODEL, bimamba_type=bimamba)
    tmod.load_state_dict(from_jax.mamba_state_dict_from_jax(
        _np_tree(params["params"])), strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), nframes=T)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-4)


def test_mamba_layer_matches_jax():
    x = _x(1)
    jmod = jm.MambaLayer(dim=D_MODEL, scan_implementation="ref")
    params = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x), T, 2, 3)
    want = jmod.apply(params, jnp.asarray(x), T, 2, 3)
    sd = {}
    from_jax._mamba_layer(sd, "0", _np_tree(params["params"]))
    tmod = nn.Sequential(tm.MambaLayer(D_MODEL)).eval()
    tmod.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tmod[0](torch.from_numpy(x), T, 2, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-4)


def test_permutations_match_jax():
    x = np.arange(B * T * S * 3, dtype=np.float32).reshape(B, T * S, 3)
    p = tm.frame_to_position_major(torch.from_numpy(x), T)
    np.testing.assert_array_equal(
        p.numpy(), np.asarray(jm.frame_to_position_major(jnp.asarray(x), T)))
    np.testing.assert_array_equal(
        tm.position_to_frame_major(p, T).numpy(), x)


def test_seeded_init_follows_the_reference_scheme():
    """A_log = log(1..N), D = 1, dt bias maps through softplus into
    [dt_min, dt_max]; the same seed gives the same weights."""
    make = lambda: init_weights(tm.MambaV3(D_MODEL),
                                torch.Generator().manual_seed(3))
    m = make()
    np.testing.assert_allclose(m.A_s_log[0].detach().numpy(),
                               np.log(np.arange(1, 17)), rtol=1e-6)
    assert (m.D_b == 1).all()
    dt = torch.nn.functional.softplus(m.dt_proj.bias)
    assert (dt >= 1e-4 - 1e-6).all() and (dt <= 0.1 + 1e-5).all()
    for a, b in zip(m.state_dict().values(), make().state_dict().values()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="not divisible"):
        m(torch.zeros(1, 10, D_MODEL), nframes=3)


def test_drop_layers():
    """DropPath and FastDropout: identity in eval; in training each
    element (DropPath: each sample) is zero or scaled by 1/keep, drawn from
    the explicit generator they are given (none set: they raise)."""
    from vivim_tpu_torch.nn.layers import DropPath, FastDropout

    x = torch.ones(64, 3, 5)
    gen = torch.Generator().manual_seed(0)
    for layer, keep in ((DropPath(0.25), 0.75),
                        (FastDropout(0.25), 192 / 256)):
        assert torch.equal(layer.eval()(x), x)
        with pytest.raises(RuntimeError, match="explicit generator"):
            layer.train()(x)
        layer.generator = gen
        y = layer.train()(x)
        vals = torch.unique(y)
        assert len(vals) == 2 and vals[0] == 0, vals
        assert vals[1] == torch.tensor(1.0 / keep), vals
    dp = DropPath(0.5).train()
    dp.generator = gen
    y = dp(x)
    assert all(len(set(row.flatten().tolist())) == 1 for row in y)
