"""The streaming decode path of the PyTorch port against the JAX package:
the decode refs (``causal_conv1d_update(_ref)``,
``selective_state_update_ref``, ``selective_scan_ref_cm``) and
``nn.streaming`` (``allocate_cache``, ``mamba_step``, ``mamba_prefill``).

Inputs are made from a seed with numpy; the JAX mixer's weights cross with
``from_jax.mamba_state_dict_from_jax``; the JAX side runs its sequential
scan (``scan_implementation="ref"``).  Tolerance: fp32 rtol 1e-3 / atol
1e-4, the module level of tests/test_vivim_golden.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivim_tpu.kernels import refs as jrefs
from vivim_tpu.kernels.causal_conv1d import (
    causal_conv1d_update as jconv_update,
)
from vivim_tpu.nn import streaming as jstream
from vivim_tpu.nn.mamba import MambaV3 as JMambaV3
from vivim_tpu_torch.convert import from_jax
from vivim_tpu_torch.kernels import causal_conv1d as tconv
from vivim_tpu_torch.kernels import refs as trefs
from vivim_tpu_torch.nn import streaming as tstream
from vivim_tpu_torch.nn.mamba import MambaV3 as TMambaV3

torch.set_num_threads(1)

RTOL, ATOL = 1e-3, 1e-4
D_MODEL, BATCH = 16, 2


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def mixer():
    """(JAX MambaV3 "none" module, its params, the port's mixer dict)."""
    m = JMambaV3(d_model=D_MODEL, bimamba_type="none",
                 scan_implementation="ref")
    params = m.init(jax.random.PRNGKey(0), jnp.zeros((BATCH, 12, D_MODEL)))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    # a dt bias and D off their init values, so every term counts
    rng = _rng(7)
    params["dt_proj_bias"] = params["dt_proj_bias"] + rng.normal(
        0, 0.3, params["dt_proj_bias"].shape).astype(np.float32)
    params["D"] = rng.normal(1, 0.5, params["D"].shape).astype(np.float32)
    return m, params, from_jax.mamba_state_dict_from_jax(params)


@pytest.mark.parametrize("fn", ["kernel", "ref"])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("activation", [None, "silu"])
def test_causal_conv1d_update_matches_jax(fn, bias, activation):
    rng = _rng(1)
    width, dim = 4, 24
    x = rng.standard_normal((BATCH, dim)).astype(np.float32)
    state = rng.standard_normal((BATCH, width, dim)).astype(np.float32)
    w = rng.standard_normal((width, dim)).astype(np.float32)
    b = rng.standard_normal(dim).astype(np.float32) if bias else None
    jfn = jconv_update if fn == "kernel" else jrefs.causal_conv1d_update_ref
    tfn = (tconv.causal_conv1d_update if fn == "kernel"
           else trefs.causal_conv1d_update_ref)
    want, want_state = jfn(jnp.asarray(x), jnp.asarray(state),
                           jnp.asarray(w), None if b is None
                           else jnp.asarray(b), activation)
    got, got_state = tfn(torch.from_numpy(x), torch.from_numpy(state),
                         torch.from_numpy(w), None if b is None
                         else torch.from_numpy(b), activation)
    _close(got, want)
    np.testing.assert_array_equal(got_state.numpy(), np.asarray(want_state))


def test_causal_conv1d_update_sums_in_fp32():
    """bf16 in: the kernel's sum runs in fp32 (rounded once, at the end),
    as the JAX kernel's; equal to the JAX result in bf16."""
    rng = _rng(2)
    x = rng.standard_normal((BATCH, 32)).astype(np.float32)
    state = rng.standard_normal((BATCH, 4, 32)).astype(np.float32)
    w = rng.standard_normal((4, 32)).astype(np.float32)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    jbf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    got, _ = tconv.causal_conv1d_update(bf(x), bf(state), bf(w), None,
                                        "silu")
    want, _ = jconv_update(jbf(x), jbf(state), jbf(w), None, "silu")
    assert got.dtype == torch.bfloat16
    # bf16 output: one rounding of the same fp32 value (one bf16 ulp)
    _close(got.float(), np.asarray(want.astype(jnp.float32)), rtol=8e-3,
           atol=1e-6)


@pytest.mark.parametrize("gated", [True, False])
def test_selective_state_update_ref_matches_jax(gated):
    rng = _rng(3)
    d, n = 24, 16
    arr = lambda *s: rng.standard_normal(s).astype(np.float32)
    state, x, dt = arr(BATCH, d, n), arr(BATCH, d), 0.5 * arr(BATCH, d)
    A = -np.exp(arr(d, n) * 0.5).astype(np.float32)
    B, C, D, z, bias = arr(BATCH, n), arr(BATCH, n), arr(d), arr(BATCH, d), \
        arr(d)
    kw = dict(D=D, z=z, dt_bias=bias, dt_softplus=True) if gated else {}
    want, want_state = jrefs.selective_state_update_ref(
        *map(jnp.asarray, (state, x, dt, A, B, C)),
        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()})
    got, got_state = trefs.selective_state_update_ref(
        *map(torch.from_numpy, (state, x, dt, A, B, C)),
        **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()})
    _close(got, want)
    _close(got_state, want_state)
    assert got_state.dtype == torch.float32


@pytest.mark.parametrize("last", [True, False])
def test_selective_scan_ref_cm_matches_jax(last):
    rng = _rng(4)
    d, n, L = 12, 4, 9
    arr = lambda *s: rng.standard_normal(s).astype(np.float32)
    u, delta, z = arr(BATCH, d, L), 0.5 * arr(BATCH, d, L), arr(BATCH, d, L)
    A = -np.exp(0.5 * arr(d, n)).astype(np.float32)
    B, C, D, bias = arr(BATCH, n, L), arr(BATCH, n, L), arr(d), arr(d)
    args = (u, delta, A, B, C, D, z, bias)
    want = jrefs.selective_scan_ref_cm(*map(jnp.asarray, args),
                                       delta_softplus=True,
                                       return_last_state=last)
    got = trefs.selective_scan_ref_cm(*map(torch.from_numpy, args),
                                      delta_softplus=True,
                                      return_last_state=last)
    if last:
        _close(got[0], want[0])
        _close(got[1], want[1])
    else:
        _close(got, want)


def test_allocate_cache_matches_jax():
    jc, js = jstream.allocate_cache(3, D_MODEL, d_state=8, d_conv=3)
    tc, ts = tstream.allocate_cache(3, D_MODEL, d_state=8, d_conv=3)
    assert tuple(tc.shape) == jc.shape and tuple(ts.shape) == js.shape
    assert tc.dtype == torch.float32 and ts.dtype == torch.float32
    assert not tc.any() and not ts.any()


def test_mamba_step_matches_jax(mixer):
    _, params, sd = mixer
    rng = _rng(5)
    d_inner = 2 * D_MODEL
    x = rng.standard_normal((BATCH, D_MODEL)).astype(np.float32)
    cs = rng.standard_normal((BATCH, 4, d_inner)).astype(np.float32)
    ss = rng.standard_normal((BATCH, d_inner, 16)).astype(np.float32)
    want = jstream.mamba_step(params, jnp.asarray(x), jnp.asarray(cs),
                              jnp.asarray(ss))
    got = tstream.mamba_step(sd, torch.from_numpy(x), torch.from_numpy(cs),
                             torch.from_numpy(ss))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("L", [2, 11])
def test_mamba_prefill_matches_jax(mixer, L):
    """Output and both states; L = 2 is shorter than the conv window (the
    conv state left-padded with zeros)."""
    _, params, sd = mixer
    x = _rng(6).standard_normal((BATCH, L, D_MODEL)).astype(np.float32)
    want = jstream.mamba_prefill(params, jnp.asarray(x), implementation="ref")
    got = tstream.mamba_prefill(sd, torch.from_numpy(x))
    for what, g, w in zip(("out", "conv_state", "ssm_state"), got, want):
        assert tuple(g.shape) == w.shape, what
        _close(g, w)


def test_prefill_then_steps_equal_full_forward(mixer):
    """Prefill 8 tokens, step the last 4: equal to the full forward of the
    port's MambaV3 and of the JAX module over all 12."""
    m, params, sd = mixer
    x = _rng(8).standard_normal((BATCH, 12, D_MODEL)).astype(np.float32)
    tmod = TMambaV3(D_MODEL, bimamba_type="none")
    tmod.load_state_dict(sd, strict=True)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        full = tmod(xt)
        out, cs, ss = tstream.mamba_prefill(sd, xt[:, :8])
        outs = [out]
        for t in range(8, 12):
            o, cs, ss = tstream.mamba_step(sd, xt[:, t], cs, ss)
            outs.append(o[:, None])
    stitched = torch.cat(outs, 1)
    _close(stitched, full)
    _close(stitched, m.apply({"params": params}, jnp.asarray(x)))
