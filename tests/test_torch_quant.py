"""int8 weights of the PyTorch port (``nn/quant.py``) against the JAX
package's ``nn/quant.py``.

The quantized weights and activations and the int32 products must be equal
(the product is exact); what follows an fp32 rescale is held at fp32 rtol
1e-3 / atol 1e-4, and an int8 ``generate`` at the bf16 tolerance, rtol
3e-2 / atol 5e-2 (a row's int8 rounding may flip where the two frameworks'
float activations differ in the last bit).  Inputs from a seed with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_lm_helpers import make_pair, tokens
from vivim_tpu.nn import lm as jlm
from vivim_tpu.nn import quant as jq
from vivim_tpu.nn import streaming as jstream
from vivim_tpu_torch.convert import from_jax
from vivim_tpu_torch.nn import lm as tlm
from vivim_tpu_torch.nn import quant as tq
from vivim_tpu_torch.nn import streaming as tstream

torch.set_num_threads(1)

RTOL, ATOL = 1e-3, 1e-4
BF16_RTOL, BF16_ATOL = 3e-2, 5e-2


def _arr(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        np.asarray(torch.as_tensor(got).float()),
        np.asarray(jnp.asarray(want).astype(jnp.float32)), rtol=rtol,
        atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_int8_q_and_s_equal_jax(dtype, axis):
    w = _arr((24, 40), 0)
    w[3] = 0.0  # an all-zero channel: scale 1, no division by zero
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    jw = jnp.asarray(w).astype(getattr(jnp, dtype))
    got, want = tq.quantize_int8(tw, axis), jq.quantize_int8(jw, axis)
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))


def test_activation_rows_and_int32_products_equal_jax():
    x, w = _arr((2, 7, 64), 1, 3.0), _arr((48, 64), 2)
    x[0, 2] = 0.0
    txq, txs = tq._quantize_rows(torch.from_numpy(x))
    jxq, jxs = jq._quantize_rows(jnp.asarray(x))
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(txs.numpy(), np.asarray(jxs))
    wq = jq.quantize_int8(jnp.asarray(w))["q"]
    want = jax.lax.dot_general(jxq, wq, (((2,), (1,)), ((), ())),
                               preferred_element_type=jnp.int32)
    got = tq.int_mm(txq.reshape(-1, 64), torch.from_numpy(np.array(wq)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.reshape(2, 7, 48).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("shape", [(5, 64), (1, 64), (2, 7, 64)])
def test_matmul_t_matches_jax(shape):
    x, w = _arr(shape, 3), _arr((32, 64), 4)
    for tw, jw in ((torch.from_numpy(w), jnp.asarray(w)),
                   (tq.quantize_int8(torch.from_numpy(w)),
                    jq.quantize_int8(jnp.asarray(w)))):
        got = tq.matmul_t(torch.from_numpy(x), tw)
        want = jq.matmul_t(jnp.asarray(x), jw)
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        _close(got, want)


def test_embed_lookup_and_lm_head_match_jax():
    emb = _arr((11, 16), 5)
    emb[3] = 0.0
    toks = np.array([[0, 3, 10, 5]])
    temb, jemb = tq.quantize_int8(torch.from_numpy(emb)), jq.quantize_int8(
        jnp.asarray(emb))
    for dtype in (None, "bfloat16"):
        got = tq.embed_lookup(temb, torch.from_numpy(toks),
                              dtype=dtype and torch.bfloat16)
        want = jq.embed_lookup(jemb, jnp.asarray(toks),
                               dtype=dtype and jnp.bfloat16)
        _close(got, want, rtol=0, atol=0)
    np.testing.assert_array_equal(
        tq.embed_lookup(torch.from_numpy(emb), torch.from_numpy(toks)).numpy(),
        emb[toks])
    h = _arr((3, 16), 6)
    _close(tq.lm_head(torch.from_numpy(h), temb),
           jq.lm_head(jnp.asarray(h), jemb))


def test_quantize_lm_params_matches_jax():
    """The same tensors quantized (in / out proj, the tied embedding), equal
    q and s; the others cast by ``activation_dtype``; ``compute_dtype`` and
    ``tree_has_qtensor`` agree."""
    _, params, tmodel = make_pair(seed=3)
    jqv = jq.quantize_lm_params({"params": params},
                                activation_dtype=jnp.bfloat16)["params"]
    tqp = tq.quantize_lm_params(tlm.lm_params(tmodel),
                                activation_dtype=torch.bfloat16)
    quantized = sorted(k for k, v in tqp.items() if tq.is_qtensor(v))
    assert quantized == sorted(
        ["backbone.embedding.weight"]
        + [f"backbone.layers.{i}.mixer.{n}.weight" for i in range(2)
           for n in ("in_proj", "out_proj")])
    pairs = [("backbone.embedding.weight", jqv["embedding"])] + [
        (f"backbone.layers.{i}.mixer.{n}.weight",
         jqv[f"mixer_{i}"][f"{n}_kernel"]) for i in range(2)
        for n in ("in_proj", "out_proj")]
    for k, jv in pairs:
        np.testing.assert_array_equal(tqp[k]["q"].numpy(),
                                      np.asarray(jv["q"]), err_msg=k)
        np.testing.assert_array_equal(tqp[k]["s"].numpy(),
                                      np.asarray(jv["s"]), err_msg=k)
    assert tqp["backbone.layers.0.mixer.x_proj.weight"].dtype \
        == torch.bfloat16
    assert tqp["backbone.norm_f.weight"].dtype == torch.bfloat16
    assert tq.compute_dtype(tqp) == torch.bfloat16
    assert jq.compute_dtype(jqv) == jnp.bfloat16
    assert tq.compute_dtype(tlm.lm_params(tmodel)) == torch.float32
    assert tq.tree_has_qtensor(tqp) and jq.tree_has_qtensor(jqv)
    assert not tq.tree_has_qtensor(tlm.lm_params(tmodel))


def test_quantized_mamba_step_matches_jax():
    _, params, _ = make_pair(seed=4)
    mp = params["mixer_0"]
    jqp = jq.quantize_lm_params(mp)
    tqp = tq.quantize_lm_params(from_jax.mamba_state_dict_from_jax(mp))
    x, cs, ss = _arr((2, 16), 7), _arr((2, 4, 32), 8), _arr((2, 32, 16), 9)
    want = jstream.mamba_step(jqp, jnp.asarray(x), jnp.asarray(cs),
                              jnp.asarray(ss))
    got = tstream.mamba_step(tqp, torch.from_numpy(x), torch.from_numpy(cs),
                             torch.from_numpy(ss))
    for g, w in zip(got, want):
        _close(g, w, BF16_RTOL, BF16_ATOL)


@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm_fp32_residual"])
def test_int8_generate_and_forward_match_jax(norm):
    """The bench's int8 dict (int8 weights, bf16 elsewhere) on both sides:
    ``forward_functional`` logits, and ``generate`` forced to JAX's greedy
    tokens, within the bf16 tolerance."""
    kw = dict(rms_norm=True, residual_in_fp32=True) if norm != "layernorm" \
        else {}
    jmodel, params, tmodel = make_pair(seed=5, **kw)
    jqv = jq.quantize_lm_params({"params": params},
                                activation_dtype=jnp.bfloat16)
    tqp = tq.quantize_lm_params(tlm.lm_params(tmodel),
                                activation_dtype=torch.bfloat16)
    toks = tokens((2, 7), seed=12)
    _close(tlm.forward_functional(tmodel, tqp, torch.from_numpy(toks).long()),
           jlm.forward_functional(jmodel, jqv, jnp.asarray(toks)),
           BF16_RTOL, BF16_ATOL)
    want, want_scores = jlm.generate(jmodel, jqv, jnp.asarray(toks), 5,
                                     temperature=0.0, output_scores=True)
    got, scores = tlm.generate(
        tmodel, tqp, torch.from_numpy(toks).long(), 5, temperature=0.0,
        teacher_outputs=torch.from_numpy(np.array(want)), output_scores=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _close(scores, want_scores, BF16_RTOL, BF16_ATOL)
