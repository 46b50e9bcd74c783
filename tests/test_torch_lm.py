"""The Mamba LM of the PyTorch port (``nn/lm.py``) against the JAX package.

The JAX ``MambaLM`` is initialised from a seed (norms, dt biases and D
moved off their init values), its weights cross with
``from_jax.mamba_lm_state_dict_from_jax``, and tokens come from numpy.  The
JAX side runs its sequential scan (``scan_implementation="ref"``), the port
its plain versions on the CPU.  Tolerances: logits and scores at fp32 rtol
1e-3 / atol 1e-4 (the module level of tests/test_vivim_golden.py); tokens
and masks exactly; bf16 at rtol 3e-2 / atol 5e-2 (tests/
test_selective_scan.py's bf16 level).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_lm_helpers import make_pair, to_bf16, tokens
from tests.torch_vivim_ref import MambaLMRefTorch
from vivim_tpu.convert.torch_to_jax import mamba_lm_params_from_torch
from vivim_tpu.nn import lm as jlm
from vivim_tpu_torch.convert import from_jax
from vivim_tpu_torch.nn import lm as tlm
from vivim_tpu_torch.nn.mamba import MambaV3

torch.set_num_threads(1)

RTOL, ATOL = 1e-3, 1e-4
BF16_RTOL, BF16_ATOL = 3e-2, 5e-2
NORMS = {"layernorm": {}, "rmsnorm_fp32_residual": dict(
    rms_norm=True, residual_in_fp32=True)}


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        np.asarray(torch.as_tensor(got).float()),
        np.asarray(jnp.asarray(want).astype(jnp.float32)), rtol=rtol,
        atol=atol)


@pytest.fixture(scope="module", params=list(NORMS))
def pair(request):
    return make_pair(seed=0, **NORMS[request.param])


def test_config_from_mamba_json_matches_jax():
    d = {"d_model": 768, "n_layer": 24, "vocab_size": 50277,
         "ssm_cfg": {"d_state": 8, "expand": 3}, "rms_norm": True,
         "residual_in_fp32": True, "fused_add_norm": True,
         "pad_vocab_size_multiple": 16, "norm_epsilon": 1e-6}
    j = jlm.config_from_mamba_json(d)
    t = tlm.config_from_mamba_json(d)
    assert {k: getattr(t, k) for k in j.__dataclass_fields__} \
        == {k: getattr(j, k) for k in j.__dataclass_fields__}
    assert t.padded_vocab == j.padded_vocab == 50288


def test_state_dict_keys_are_the_reference_lm_heads():
    """``MambaLM``'s keys are the reference MambaLMHeadModel's, both norm
    kinds; a ``MambaV3(bimamba_type="none")`` mixer has the reference
    Mamba's keys and shapes, key for key."""
    for rms in (False, True):
        ref = MambaLMRefTorch(50, 16, 2, rms_norm=rms)
        model = tlm.MambaLM(tlm.MambaLMConfig(50, 16, 2, rms_norm=rms,
                                              pad_vocab_multiple=1))
        ref_shapes = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
        ref_shapes["lm_head.weight"] = ref_shapes["backbone.embedding.weight"]
        assert {k: tuple(v.shape) for k, v in model.state_dict().items()} \
            == ref_shapes
    mixer = MambaV3(16, bimamba_type="none")
    ref_mixer = ref.backbone.layers[0].mixer
    assert {k: tuple(v.shape) for k, v in mixer.state_dict().items()} \
        == {k: tuple(v.shape) for k, v in ref_mixer.state_dict().items()}
    # the head is tied to the embedding
    assert model.lm_head.weight is model.backbone.embedding.weight


def test_reference_checkpoint_loads_strictly_and_matches():
    """A reference-layout state_dict (tests/torch_vivim_ref.py's
    MambaLMRefTorch, RMSNorm) loads strictly and gives its logits."""
    torch.manual_seed(4)
    ref = MambaLMRefTorch(48, 16, 2, rms_norm=True).eval()
    sd = dict(ref.state_dict())
    sd["lm_head.weight"] = sd["backbone.embedding.weight"]
    model = tlm.MambaLM(tlm.MambaLMConfig(48, 16, 2, rms_norm=True))
    model.load_state_dict(sd, strict=True)
    toks = torch.from_numpy(tokens((2, 7), vocab=48)).long()
    with torch.no_grad():
        _close(model(toks), ref(toks))


def test_logits_match_jax(pair):
    jmodel, params, tmodel = pair
    toks = tokens((2, 9))
    want = jmodel.apply({"params": params}, jnp.asarray(toks))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(toks).long())
    assert tuple(got.shape) == want.shape == (2, 9, 56)
    _close(got, want)


def test_forward_functional_matches_jax(pair):
    jmodel, params, tmodel = pair
    toks = tokens((2, 9), seed=2)
    want = jlm.forward_functional(jmodel, {"params": params},
                                  jnp.asarray(toks))
    got = tlm.forward_functional(tmodel, tlm.lm_params(tmodel),
                                 torch.from_numpy(toks).long())
    _close(got, want)


def test_norms_and_rescale_match_jax():
    rng = np.random.default_rng(5)
    h = rng.standard_normal((3, 16)).astype(np.float32)
    w, b = (rng.standard_normal(16).astype(np.float32) for _ in range(2))
    _close(tlm.layer_norm({"weight": torch.from_numpy(w),
                           "bias": torch.from_numpy(b)}, torch.from_numpy(h)),
           jlm.layer_norm({"scale": w, "bias": b}, jnp.asarray(h)))
    _close(tlm.rms_norm({"weight": torch.from_numpy(w)}, torch.from_numpy(h)),
           jlm.rms_norm({"scale": w}, jnp.asarray(h)))
    jmodel, params, tmodel = make_pair(seed=1)
    want = jlm.rescale_residual_projections(params, 2)
    got = tlm.rescale_residual_projections(tmodel.state_dict(), 2)
    sd = from_jax.mamba_lm_state_dict_from_jax(want, 2)
    assert set(got) == set(sd)
    for k in sd:
        np.testing.assert_allclose(got[k].numpy(), sd[k].numpy(), rtol=1e-7,
                                   err_msg=k)


def test_jax_to_port_to_jax_round_trip_is_exact(pair):
    _, params, _ = pair
    sd = from_jax.mamba_lm_state_dict_from_jax(params, 2)
    back = mamba_lm_params_from_torch(sd, 2)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]),
                                      np.asarray(leaf), err_msg=str(path))


def test_generate_greedy_matches_jax(pair):
    jmodel, params, tmodel = pair
    prompt = tokens((2, 5), seed=3)
    want, want_scores = jlm.generate(
        jmodel, {"params": params}, jnp.asarray(prompt), 6, temperature=0.0,
        output_scores=True)
    got, scores = tlm.generate(tmodel, tlm.lm_params(tmodel),
                               torch.from_numpy(prompt).long(), 6,
                               temperature=0.0, output_scores=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _close(scores, want_scores)


def test_generate_teacher_forcing_and_scores_match_jax(pair):
    """The teacher covers the prompt and 3 of 5 new positions; later
    positions are greedy.  Tokens equal, scores at the logits tolerance."""
    jmodel, params, tmodel = pair
    prompt = tokens((1, 3), seed=4)
    teacher = np.concatenate([prompt, tokens((1, 3), seed=5)], 1)
    want, want_scores = jlm.generate(
        jmodel, {"params": params}, jnp.asarray(prompt), 5, temperature=0.0,
        teacher_outputs=jnp.asarray(teacher), output_scores=True)
    got, scores = tlm.generate(
        tmodel, tlm.lm_params(tmodel), torch.from_numpy(prompt).long(), 5,
        temperature=0.0, teacher_outputs=torch.from_numpy(teacher),
        output_scores=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[:, 3:6].numpy(), teacher[:, 3:6])
    _close(scores, want_scores)


def test_eos_masking_matches_jax(pair):
    """After eos every row emits only eos, as the JAX loop does (it runs
    every step whatever eos says)."""
    jmodel, params, tmodel = pair
    prompt = tokens((2, 4), seed=6)
    free = jlm.generate(jmodel, {"params": params}, jnp.asarray(prompt), 6,
                        temperature=0.0)
    eos = int(free[0, 5])  # a token row 0 emits at its second step
    want = jlm.generate(jmodel, {"params": params}, jnp.asarray(prompt), 6,
                        temperature=0.0, eos_token_id=eos)
    got = tlm.generate(tmodel, tlm.lm_params(tmodel),
                       torch.from_numpy(prompt).long(), 6, temperature=0.0,
                       eos_token_id=eos)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    row = got[0, 4:].tolist()
    assert eos in row and set(row[row.index(eos):]) == {eos}
    # a teacher that goes on after eos: the forced tokens are masked too
    teacher = np.concatenate(
        [prompt, np.array([[eos, (eos + 1) % 50, (eos + 2) % 50]] * 2)], 1)
    want = jlm.generate(jmodel, {"params": params}, jnp.asarray(prompt), 5,
                        temperature=0.0, eos_token_id=eos,
                        teacher_outputs=jnp.asarray(teacher))
    got = tlm.generate(tmodel, tlm.lm_params(tmodel),
                       torch.from_numpy(prompt).long(), 5, temperature=0.0,
                       eos_token_id=eos,
                       teacher_outputs=torch.from_numpy(teacher))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[:, 4:] == eos).all()


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 5, 1.0), (1.0, 0, 0.8), (1.3, 10, 0.6),
    (1.0, 1, 1.0)])
def test_sampling_filter_mask_matches_jax(monkeypatch, temperature, top_k,
                                          top_p):
    """The port's filter keeps exactly the tokens JAX's ``_sample_logits``
    hands to its draw, and gives them the same values."""
    logits = np.random.default_rng(7).normal(0, 2, (4, 56)).astype(
        np.float32)
    seen = []

    def categorical(rng, lg, axis=-1):
        seen.append(np.asarray(lg))
        return jnp.argmax(lg, axis)

    monkeypatch.setattr(jax.random, "categorical", categorical)
    jlm._sample_logits(jax.random.PRNGKey(0), jnp.asarray(logits),
                       temperature, top_k, top_p)
    got = tlm.filter_logits(torch.from_numpy(logits), temperature, top_k,
                            top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(seen[0]))
    keep = ~np.isinf(got)
    assert keep.sum(-1).min() >= 1
    np.testing.assert_allclose(got[keep], seen[0][keep], rtol=1e-6)


def test_top_k_1_at_temperature_1_gives_jax_tokens(pair):
    """The bench's default draw (top-k 1, temperature 1) keeps one token per
    row, so the port's tokens equal JAX's whatever the random stream."""
    jmodel, params, tmodel = pair
    prompt = tokens((2, 5), seed=8)
    want = jlm.generate(jmodel, {"params": params}, jnp.asarray(prompt), 6,
                        rng=jax.random.PRNGKey(1), temperature=1.0, top_k=1)
    got = tlm.generate(tmodel, tlm.lm_params(tmodel),
                       torch.from_numpy(prompt).long(), 6,
                       generator=torch.Generator().manual_seed(1),
                       temperature=1.0, top_k=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampling_draws_from_the_generator(pair):
    """Full-vocabulary sampling: the same seed gives the same tokens,
    every drawn token is one the filter kept, and the draw follows the
    generator (another seed, other tokens)."""
    _, _, tmodel = pair
    prompt = torch.from_numpy(tokens((2, 3), seed=9)).long()
    run = lambda seed: tlm.generate(
        tmodel, tlm.lm_params(tmodel), prompt, 12,
        generator=torch.Generator().manual_seed(seed), temperature=1.0,
        top_k=10)
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    logits = tlm.forward_functional(tmodel, tlm.lm_params(tmodel), a)
    kept = ~torch.isinf(tlm.filter_logits(logits, 1.0, 10, 1.0))
    drawn = a[:, 3:]
    assert kept[:, 2:-1].gather(-1, drawn[..., None]).all()


def test_bf16_generate_matches_jax(pair):
    """Every floating tensor in bf16 on both sides (the bench's --dtype
    bfloat16), decoding forced to JAX's greedy tokens: scores within the
    bf16 tolerance."""
    jmodel, params, tmodel = pair
    jb = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
    prompt = tokens((1, 6), seed=10)
    want, want_scores = jlm.generate(
        jmodel, {"params": jb}, jnp.asarray(prompt), 6, temperature=0.0,
        output_scores=True)
    got, scores = tlm.generate(
        tmodel, to_bf16(tlm.lm_params(tmodel)),
        torch.from_numpy(prompt).long(), 6, temperature=0.0,
        teacher_outputs=torch.from_numpy(np.array(want)),
        output_scores=True)
    assert scores.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _close(scores, want_scores, BF16_RTOL, BF16_ATOL)


def test_any_d_state_on_cpu_and_ref():
    """d_state 8: the CPU and implementation="ref" run it, and the card
    takes it too (the kernels take 1 to 256: tests/test_torch_cuda.py and
    chip_smoke.py's phase 13; tests/test_torch_lm_cli.py holds the
    config check)."""
    jmodel, params, tmodel = make_pair(seed=2, d_state=8)
    toks = tokens((1, 6), seed=11)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(toks).long())
    _close(got, jmodel.apply({"params": params}, jnp.asarray(toks)))
    tlm.check_kernel_config(tmodel.cfg, "cpu")
    tlm.check_kernel_config(tmodel.cfg, "cuda", implementation="ref")
    tlm.check_kernel_config(tmodel.cfg, "cuda")
