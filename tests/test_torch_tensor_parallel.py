"""Tensor-parallel Mamba mixer and LM of the port (``parallel/
tensor_parallel.py``) against the JAX package's unsharded modules, on gloo
process groups of the CPU: the counterparts of ``tests/
test_tensor_parallel.py``'s 11 cases, case by case.

The JAX cases split d_inner over 8 devices; here 2 ranks split it (one
spawn runs the mixers, the LM's logits and gradients, the decode and the
eval core), and 4 ranks form the 2 x 2 ("data", "model") mesh that the
JAX case builds as 2 x 4.  The CLI case runs ``bench_generation
--tp_shards 2`` (with ``lm_eval_harness --pp_stages 2``) in 2 ranks.  The
oracle is the JAX ``MambaV3`` / ``MambaLM`` at ``implementation="ref"`` in
this process, never the JAX TP functions (their 8-device compiles keep
that file in the slow tier); the weights cross with ``convert/
from_jax.py``.  Tolerances are the JAX file's: the mixer at 1e-5, logits
at 1e-4, gradients at rtol 2e-4 / atol 2e-4 x max(|grad|, 1), tokens and
greedy flags exactly; a log-likelihood within 1e-3 relative.  The
sampled decode (temperature 0.8, top-k 5) and the eval core's greedy
continuation are held against the port's one-device ``generate`` / core
on the same weights and generator seed (both held against JAX in
``tests/test_torch_lm*.py``; JAX's sampling stream cannot be matched), the
greedy decode against JAX's.  The errors (d_inner that does not split, a
mixer leaf without a rule) need no rank and no oracle.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parallel_helpers as H
from tests.torch_lm_helpers import make_pair
from vivim_tpu.cli.lm_eval_harness import MambaEvalCore as JCore
from vivim_tpu.nn import lm as jlm
from vivim_tpu.nn.mamba import MambaV3 as JMambaV3
from vivim_tpu_torch.cli import bench_generation as tbench
from vivim_tpu_torch.cli import lm_eval_harness as teval
from vivim_tpu_torch.convert import from_jax
from vivim_tpu_torch.nn import lm as tlm
from vivim_tpu_torch.nn.mamba import MambaV3 as TMambaV3
from vivim_tpu_torch.parallel import tensor_parallel as tp
from vivim_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

LM_CFG = dict(vocab_size=50, d_model=32, n_layer=2)
PAIR = dict(vocab=50, d_model=32, n_layer=2)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _mixer(seed, bias=False):
    """(JAX output, port mixer state_dict + x) of a single-direction
    MambaV3 on (2, 24, 32) tokens; biased mixers with non-zero biases."""
    model = JMambaV3(d_model=32, bimamba_type="none", bias=bias,
                     scan_implementation="ref")
    x = jax.random.normal(jax.random.PRNGKey(seed), (2, 24, 32), jnp.float32)
    params = dict(model.init(jax.random.PRNGKey(seed + 1), x)["params"])
    if bias:
        for i, name in enumerate(("in_proj_bias", "out_proj_bias")):
            params[name] = 0.1 * jax.random.normal(
                jax.random.PRNGKey(seed + 10 + i), params[name].shape)
    y = model.apply({"params": params}, x)
    sd = {k: v.numpy() for k, v in
          from_jax.mamba_state_dict_from_jax(params).items()}
    return np.asarray(y), dict(sd, x=np.asarray(x))


def _lm_sd(params, toks):
    sd = from_jax.mamba_lm_state_dict_from_jax(params, LM_CFG["n_layer"])
    return dict({k: v.numpy() for k, v in sd.items()}, tokens=toks)


def _biased(params):
    """The JAX LM tree with in / out projection biases in every mixer (the
    JAX case's)."""
    p = dict(params)
    for i in range(LM_CFG["n_layer"]):
        mp = dict(p[f"mixer_{i}"])
        k1, k2 = jax.random.split(jax.random.PRNGKey(100 + i))
        mp["in_proj_bias"] = 0.1 * jax.random.normal(
            k1, (2 * mp["A_log"].shape[0],))
        mp["out_proj_bias"] = 0.1 * jax.random.normal(
            k2, (mp["out_proj_kernel"].shape[0],))
        p[f"mixer_{i}"] = mp
    return p


def _loss_grads(jmodel, params, toks):
    g = jax.grad(lambda p: jnp.sum(jmodel.apply({"params": p}, toks) ** 2))(
        params)
    return from_jax.mamba_lm_state_dict_from_jax(g, LM_CFG["n_layer"])


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    """One 2-rank spawn for every 2-rank case; the JAX oracles beside."""
    out = tmp_path_factory.mktemp("tp2")
    want = {}
    for name, seed, bias in (("mixer", 0, False), ("mixer_bias", 7, True)):
        want[name], inputs = _mixer(seed, bias)
        H.save(out, name, **inputs)
    jmodel, params, tmodel = make_pair(seed=1, **PAIR)
    toks = np.random.default_rng(2).integers(0, 50, (2, 16)).astype(np.int32)
    gen_toks = np.random.default_rng(3).integers(0, 50, (2, 8)).astype(
        np.int32)
    H.save(out, "lm", **_lm_sd(params, toks))
    H.save(out, "gen", **_lm_sd(params, gen_toks))
    bparams = _biased(params)
    H.save(out, "lm_bias", **_lm_sd(bparams, gen_toks[:1, :6]))
    jt = jnp.asarray(toks)
    want["logits"] = np.asarray(jmodel.apply({"params": params}, jt))
    want["grads"] = {k: v.numpy() for k, v in
                     _loss_grads(jmodel, params, jt).items()}
    want["gen0"] = np.asarray(jlm.generate(
        jmodel, {"params": params}, jnp.asarray(gen_toks), 6,
        rng=jax.random.PRNGKey(3), **H.GEN_CASES[0]))
    with torch.no_grad():
        want["gen1"] = tlm.generate(
            tmodel, tlm.lm_params(tmodel), torch.from_numpy(gen_toks).long(),
            6, generator=torch.Generator().manual_seed(H.GEN_SEED),
            **H.GEN_CASES[1]).numpy()
    want["gen_bias"] = np.asarray(jlm.generate(
        jmodel, {"params": bparams}, jnp.asarray(gen_toks[:1, :6]), 5,
        rng=jax.random.PRNGKey(3), temperature=0.0))
    core = JCore(jmodel, {"params": params}, H.CharTok(), max_gen_toks=5)
    want["ll"], want["greedy"] = core.loglikelihood_pair(*H.SCORE_PAIR)
    want["until"] = teval.MambaEvalCore(
        tmodel, tlm.lm_params(tmodel), H.CharTok(),
        max_gen_toks=5).generate_until_str("ab")
    H.run_ranks(H.tp_body, 2, out, LM_CFG)
    return [H.load(out, f"tp_rank{r}") for r in range(2)], want


def test_tp_mixer_matches_unsharded(tp2):
    ranks, want = tp2
    for r in ranks:
        np.testing.assert_allclose(r["mixer_y"], want["mixer"], rtol=1e-5,
                                   atol=1e-5)


def test_tp_mixer_requires_divisible_d_inner():
    """d_model 31: d_inner 62 does not split over 4 ranks (the JAX case:
    60 over 8).  The check comes before any collective."""
    sd = TMambaV3(31, bimamba_type="none").state_dict()
    mesh = Mesh({"model": 4}, {"model": 0}, {"model": None})
    with pytest.raises(ValueError, match="not divisible"):
        tp.tp_mamba_mixer(sd, torch.zeros(1, 4, 31), mesh)


def test_tp_lm_forward_matches(tp2):
    ranks, want = tp2
    for r in ranks:
        np.testing.assert_allclose(r["logits"], want["logits"], **LOGIT_TOL)


def _scaled_close(got, ref, msg):
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4 * scale,
                               err_msg=msg)


def test_tp_lm_grads_match(tp2):
    """Every leaf's gradient through the TP forward from a rank's split is
    the split of the unsharded gradient (the in_proj rows of the rank's x
    and z channels, the per-channel leaves' slices); a replicated leaf's
    (embedding, norms, out bias) is whole and equal on both ranks."""
    ranks, want = tp2
    torch_grads = {k: torch.from_numpy(v) for k, v in want["grads"].items()
                   if k != "lm_head.weight"}
    for i, r in enumerate(ranks):
        mesh = Mesh({"model": 2}, {"model": i}, {"model": None})
        split = tp.split_tp_params(torch_grads, mesh)
        assert {f"g:{k}" for k in split} == {k for k in r
                                             if k.startswith("g:")}
        for k, ref in split.items():
            _scaled_close(r[f"g:{k}"], ref.numpy(), f"rank {i} {k}")
            if ".mixer." not in k or k.endswith("out_proj.bias"):
                np.testing.assert_array_equal(r[f"g:{k}"],
                                              ranks[0][f"g:{k}"], err_msg=k)


def test_tp_generate_matches_unsharded(tp2):
    """Greedy tokens up to eos equal JAX's; the sampled ones equal the
    port's one-device draw from the same generator; both ranks alike."""
    ranks, want = tp2
    for r in ranks:
        np.testing.assert_array_equal(r["gen0"], want["gen0"])
        np.testing.assert_array_equal(r["gen1"], want["gen1"])


def test_eval_core_tp_scoring_matches(tp2):
    ranks, want = tp2
    for r in ranks:
        assert abs(float(r["ll"]) - want["ll"]) \
            < 1e-3 * max(abs(want["ll"]), 1.0)
        assert bool(r["greedy"]) == want["greedy"]
        assert str(r["until"]) == want["until"]
        # the core holds its own split, not views of the whole weights
        assert int(r["core_bytes"]) == int(r["split_bytes"])


def test_bench_generation_tp_smoke(tmp_path):
    """``bench_generation --tp_shards 2`` in 2 gloo ranks prints the JAX
    CLI's line on rank 0 only, and ``lm_eval_harness --pp_stages 2`` scores
    as one device's eval core on the same seeded weights."""
    tiny = ["--vocab", "64", "--d_model", "32", "--n_layer", "2",
            "--device", "cpu", "--dist_backend", "gloo"]
    bench = tiny + ["--promptlen", "4", "--genlen", "2", "--repeats", "1",
                    "--topk", "1", "--tp_shards", "2"]
    evals = tiny + ["--tasks", "stand_in", "--pp_stages", "2"]
    H.run_ranks(H.lm_cli_body, 2, tmp_path, bench, evals)
    ranks = [json.loads((tmp_path / f"lm_cli_rank{r}.json").read_text())
             for r in range(2)]
    assert ranks[1]["bench"] == []
    out = json.loads(ranks[0]["bench"][-1])
    assert list(out) == ["prompt_len", "gen_len", "batch", "total_sec",
                         "tokens_per_sec", "dtype"]
    assert out["gen_len"] == 2 and out["tokens_per_sec"] > 0
    model, params = teval.load_lm(None, 64, 32, 2, device="cpu")
    want = teval.MambaEvalCore(model, params, H.CharTok()).loglikelihood_pair(
        *H.SCORE_PAIR)
    for r in ranks:
        assert r["eval"][0] == pytest.approx(want[0], rel=1e-4, abs=1e-4)
        assert r["eval"][1] == want[1]


def test_tp_hybrid_data_model_mesh(tmp_path):
    """DP x TP on a 2 x 2 ("data", "model") mesh (the JAX case's 2 x 4):
    each rank's data block of the batch, its mixers split over model, gives
    the unsharded logits of those rows."""
    jmodel, params, _ = make_pair(seed=4, **PAIR)
    toks = np.random.default_rng(5).integers(0, 50, (4, 16)).astype(np.int32)
    H.save(tmp_path, "lm4", **_lm_sd(params, toks))
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(toks)))
    H.run_ranks(H.tp_hybrid_body, 4, tmp_path, LM_CFG)
    seen = set()
    for i in range(4):
        r = H.load(tmp_path, f"tp_hybrid_rank{i}")
        seen.add(tuple(r["coords"]))
        np.testing.assert_allclose(r["logits"], want[r["rows"]], **LOGIT_TOL)
    assert seen == {(0, 0), (0, 1), (1, 0), (1, 1)}


def test_tp_mixer_with_biases_matches_unsharded(tp2):
    """bias=True: the in_proj bias split with its halves, the out_proj bias
    added once after the sum."""
    ranks, want = tp2
    for r in ranks:
        np.testing.assert_allclose(r["mixer_bias_y"], want["mixer_bias"],
                                   rtol=1e-5, atol=1e-5)


def test_tp_generate_with_biased_mixers(tp2):
    ranks, want = tp2
    for r in ranks:
        np.testing.assert_array_equal(r["gen_bias"], want["gen_bias"])


def test_tp_unknown_mixer_param_raises():
    sd = tlm.lm_params(tlm.MambaLM(tlm.MambaLMConfig(**LM_CFG)))
    sd["backbone.layers.0.mixer.mystery_kernel"] = torch.zeros(4, 4)
    mesh = Mesh({"model": 2}, {"model": 0}, {"model": None})
    with pytest.raises(ValueError, match="mystery_kernel"):
        tp.split_tp_params(sd, mesh)
    bi = {f"backbone.layers.0.mixer.{k}": v for k, v in
          TMambaV3(16, bimamba_type="v2").state_dict().items()}
    with pytest.raises(ValueError, match="conv1d_b.weight"):
        tp.split_tp_params(bi, mesh)


def test_int8_and_pipeline_with_tp_stop_as_jax():
    """``--dtype int8`` with ``--tp_shards`` stops with the JAX CLI's
    message before any rank starts; tensor and pipeline parallel together
    raise the JAX eval core's ``ValueError``."""
    with pytest.raises(SystemExit, match="single-device decode only"):
        tbench.main(["--tp_shards", "2", "--dtype", "int8", "--device",
                     "cpu"])
    model, params = teval.load_lm(None, 50, 16, 2, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        teval.MambaEvalCore(model, params, H.CharTok(), tp_shards=2,
                            pp_stages=2)
