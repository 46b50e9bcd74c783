"""Pipeline-parallel Mamba LM of the port (``parallel/pipeline.py``)
against the JAX package's unsharded ``MambaLM``, on gloo process groups of
the CPU: the counterparts of ``tests/test_pipeline.py``'s 8 cases, case by
case, and the two routes of the pipeline's hop (``comm.ppermute``).

The JAX cases run 8 stages; here one 2-rank spawn runs 2 stages (the
forward and gradients of 8 layers at 2 microbatches, the RMSNorm / fp32
residual config, 4 microbatches through 2 stages, the eval core, the hop
routes) and one 4-rank spawn runs 4 stages (forward and gradients) and
the 2 x 2 ("data", "pipe") mesh that the JAX case builds as 2 x 4.  The
oracle is the JAX ``MambaLM`` at ``implementation="ref"`` in this process,
never the JAX pipeline (its 8-device compiles keep that file in the slow
tier); the weights cross with ``convert/from_jax.py``.  Tolerances are the
JAX file's: logits at 1e-4, gradients at rtol 2e-4 / atol 2e-4 x
max(|grad|, 1); a log-likelihood within 1e-3 relative, greedy flags
exactly.  The validation errors need no rank and no oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parallel_helpers as H
from tests.torch_lm_helpers import make_pair
from vivim_tpu.cli.lm_eval_harness import MambaEvalCore as JCore
from vivim_tpu_torch.cli import lm_eval_harness as teval
from vivim_tpu_torch.convert import from_jax
from vivim_tpu_torch.nn import lm as tlm
from vivim_tpu_torch.parallel import pipeline as pp
from vivim_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# (npz name, config, batch, n_micro, with gradients)
CASES = {
    "fwd8": (dict(n_layer=8), 4, 2, True),
    "rms8": (dict(n_layer=8, rms_norm=True, residual_in_fp32=True), 2, 2,
             False),
    "micro4": (dict(n_layer=2), 8, 4, False),
}
HYBRID = (dict(n_layer=4), 4)


def _cfg(kw):
    return dict(vocab_size=50, d_model=32, **kw)


def _write(out, name, kw, batch, seed):
    """The case's weights and tokens for the ranks; returns the JAX model,
    its params and the tokens."""
    jmodel, params, _ = make_pair(seed=seed, vocab=50, d_model=32, **kw)
    toks = np.random.default_rng(seed + 50).integers(
        0, 50, (batch, 16)).astype(np.int32)
    sd = from_jax.mamba_lm_state_dict_from_jax(params, kw["n_layer"])
    H.save(out, name, tokens=toks, **{k: v.numpy() for k, v in sd.items()})
    return jmodel, params, jnp.asarray(toks)


def _oracle(jmodel, params, toks, n_layer, grads):
    logits = np.asarray(jmodel.apply({"params": params}, toks))
    if not grads:
        return logits, None
    g = jax.grad(lambda p: jnp.sum(jmodel.apply({"params": p}, toks) ** 2))(
        params)
    return logits, {k: v.numpy() for k, v in
                    from_jax.mamba_lm_state_dict_from_jax(g, n_layer).items()
                    if k != "lm_head.weight"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-rank and the 4-rank spawns; the JAX oracles beside."""
    out = tmp_path_factory.mktemp("pp")
    want = {}
    for seed, (name, (kw, batch, _, grads)) in enumerate(CASES.items()):
        jmodel, params, toks = _write(out, name, kw, batch, seed)
        want[name] = _oracle(jmodel, params, toks, kw["n_layer"], grads)
        if name == "fwd8":
            core = JCore(jmodel, {"params": params}, H.CharTok())
            want["core"] = core.loglikelihood_pair(*H.SCORE_PAIR)
    jmodel, params, toks = _write(out, "hybrid", *HYBRID, seed=9)
    want["hybrid"] = _oracle(jmodel, params, toks, 4, False)
    cases = [(name, _cfg(kw), n_micro, grads)
             for name, (kw, _, n_micro, grads) in CASES.items()]
    H.run_ranks(H.pp_body, 2, out, cases)
    H.run_ranks(H.pp_body, 4, out, cases[:1], _cfg(HYBRID[0]))
    return out, want


def _ranks(out, name, world):
    return [H.load(out, f"pp_{name}_w{world}_rank{r}") for r in range(world)]


def _scaled_close(got, ref, msg):
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4 * scale,
                               err_msg=msg)


def test_stack_pipeline_params_layout():
    """Stage s's local layer j is layer s * n_layer / k + j; stages that
    do not divide the layers raise."""
    sd = tlm.lm_params(tlm.MambaLM(tlm.MambaLMConfig(50, 16, 4)))
    stage1 = pp.stack_pipeline_params(sd, 4, 2, 1)
    assert len(stage1) == 2
    assert stage1[0][0]["A_log"] is sd["backbone.layers.2.mixer.A_log"]
    stage0 = pp.stack_pipeline_params(sd, 4, 2, 0)
    assert stage0[1][1]["weight"] is sd["backbone.layers.1.norm.weight"]
    with pytest.raises(ValueError, match="not divisible"):
        pp.stack_pipeline_params(sd, 4, 3, 0)


@pytest.mark.parametrize("world", [2, 4])
def test_pp_lm_forward_matches(runs, world):
    """8 layers, batch 4, 2 microbatches, over 2 and 4 stages."""
    out, want = runs
    for r in _ranks(out, "fwd8", world):
        np.testing.assert_allclose(r["logits"], want["fwd8"][0], **LOGIT_TOL)


def test_pp_lm_forward_matches_rms_fp32_residual(runs):
    """The pretrained checkpoints' config (RMSNorm, fp32 residual): the fp32
    residual stream through the hops."""
    out, want = runs
    for r in _ranks(out, "rms8", 2):
        np.testing.assert_allclose(r["logits"], want["rms8"][0], **LOGIT_TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_pp_lm_grads_match(runs, world):
    """One ``backward`` of sum(logits ** 2) on every rank gives each
    stage's layers their gradients on the rank that holds them (none
    elsewhere), and the embedding and ``norm_f`` theirs whole and equal on
    every rank."""
    out, want = runs
    ranks = _ranks(out, "fwd8", world)
    lps = 8 // world
    for k, ref in want["fwd8"][1].items():
        held = [i for i, r in enumerate(ranks) if f"g:{k}" in r]
        if k.startswith("backbone.layers."):
            assert held == [int(k.split(".")[2]) // lps], k
        else:
            assert held == list(range(world)), k
            for i in held[1:]:
                np.testing.assert_array_equal(ranks[i][f"g:{k}"],
                                              ranks[0][f"g:{k}"], err_msg=k)
        for i in held:
            _scaled_close(ranks[i][f"g:{k}"], ref, f"rank {i} {k}")


def test_pp_hops_per_forward(runs):
    """M + k - 2 hops per forward (none after the last tick) and as many
    in the backward, each one (mb, L, d_model) fp32 activation."""
    out, _ = runs
    for name, world in (("fwd8", 2), ("fwd8", 4), ("micro4", 2)):
        kw, batch, n_micro, grads = CASES[name]
        n = (n_micro + world - 2) * (2 if grads else 1)
        for r in _ranks(out, name, world):
            assert r["hops"].tolist() == [n, n * (batch // n_micro) * 16
                                          * 32 * 4]


def test_pp_composes_with_dp(runs):
    """("data", "pipe") 2 x 2 (the JAX case's 2 x 4): each data row's block
    of every microbatch through a 2-stage pipeline gives the unsharded
    logits of those rows."""
    out, want = runs
    rows = set()
    for i in range(4):
        r = H.load(out, f"pp_hybrid_rank{i}")
        rows.update(r["rows"].tolist())
        np.testing.assert_allclose(r["logits"], want["hybrid"][0][r["rows"]],
                                   **LOGIT_TOL)
    assert rows == set(range(HYBRID[1]))


def test_pp_validation_errors():
    """6 layers over 8 stages, and a batch of 3 in 2 microbatches, raise
    before any collective."""
    cfg = tlm.MambaLMConfig(50, 16, 6)
    sd = tlm.lm_params(tlm.MambaLM(cfg))
    toks = torch.zeros(3, 5, dtype=torch.long)
    mesh8 = Mesh({"pipe": 8}, {"pipe": 0}, {"pipe": None})
    with pytest.raises(ValueError, match="not divisible"):
        pp.lm_pp_forward(cfg, sd, toks, mesh8)
    mesh2 = Mesh({"pipe": 2}, {"pipe": 0}, {"pipe": None})
    with pytest.raises(ValueError, match="batch 3"):
        pp.lm_pp_forward(cfg, sd, toks, mesh2, n_micro=2)


def test_eval_core_pp_scoring_matches(runs):
    """The eval core's --pp_stages path scores as the unsharded forward,
    and refuses to combine with --tp_shards."""
    out, want = runs
    ll1, greedy1 = want["core"]
    for i in range(2):
        r = H.load(out, f"pp_core_rank{i}")
        assert abs(float(r["ll"]) - ll1) < 1e-3 * max(abs(ll1), 1.0)
        assert bool(r["greedy"]) == greedy1
    model, params = teval.load_lm(None, 50, 16, 2, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        teval.MambaEvalCore(model, params, H.CharTok(), tp_shards=8,
                            pp_stages=8)


def test_pp_more_microbatches_than_stages(runs):
    """4 microbatches through 2 stages (the bubble shrinks as M grows)."""
    out, want = runs
    for r in _ranks(out, "micro4", 2):
        np.testing.assert_allclose(r["logits"], want["micro4"][0],
                                   **LOGIT_TOL)


def test_ppermute_routes_agree(runs):
    """The point-to-point route and the gather route (gloo's, for CUDA
    tensors) hand each rank its ring neighbour's tensor; the backward sends
    each cotangent back to its source."""
    out, _ = runs
    x = [np.arange(6.0).reshape(2, 3) + 10 * r for r in range(2)]
    for i in range(2):
        r = H.load(out, f"pp_core_rank{i}")
        for key in ("_hop_p2p", "_hop_gather", "ppermute"):
            np.testing.assert_array_equal(r[key], x[1 - i], err_msg=key)
        # rank i's x went to rank 1 - i, whose loss weighs it by 2 - i
        np.testing.assert_array_equal(r["ppermute_grad"],
                                      np.full((2, 3), 2.0 - i))
