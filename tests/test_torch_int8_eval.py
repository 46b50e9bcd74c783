"""The port's int8 task check (``vivim_tpu_torch/cli/int8_eval.py``) against
the JAX package's ``scripts/int8_eval.py`` and its pieces:

- the corpus, equal to the JAX script's ``make_corpus`` to the token;
- the optimizer, ``optax.adamw(3e-3, weight_decay=1e-2)`` (decay on every
  leaf, no clipping, a constant rate): two steps from the same gradients
  give the same parameters within 1e-6;
- the fp32 scores of held-out pairs through the port's eval core within
  1e-4 of the JAX ``MambaEvalCore`` on converted weights, greedy flags
  equal;
- a tiny ``main(--device cpu)`` (2 steps, d_model 16, 1 layer, 2 pairs)
  that writes every key of the JSON, and prints it.
"""

import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from tests.torch_lm_helpers import make_pair
from vivim_tpu.cli.lm_eval_harness import MambaEvalCore as JCore
from vivim_tpu_torch.cli import int8_eval
from vivim_tpu_torch.cli.lm_eval_harness import MambaEvalCore as TCore
from vivim_tpu_torch.convert import from_jax

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_int8_eval", ROOT / "scripts" / "int8_eval.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_corpus_and_pairs_match_the_jax_script():
    js = _jax_script()
    want = js.make_corpus(np.random.default_rng(0), 20_000)
    got = int8_eval.make_corpus(np.random.default_rng(0), 20_000)
    np.testing.assert_array_equal(got, want)
    tok = js._ToyTokenizer()
    pairs = int8_eval.heldout_pairs(got[5000:], 4)
    for i, (ctx, cont) in enumerate(pairs):
        seg = want[5000 + i * 65:5000 + (i + 1) * 65]
        assert ctx == tok.decode(seg[:48].tolist())
        assert cont == tok.decode(seg[48:64].tolist())
    assert int8_eval.ToyTokenizer().encode(ctx) == seg[:48].tolist()


def test_adamw_matches_optax_adamw():
    """Two steps of the check's optimizer from gradients given alike (the
    JAX gradients of a next-token loss, mapped to the port's names): every
    parameter, the norms, biases, A_log and D included, within 1e-6 of
    ``optax.adamw``'s."""
    jmodel, params, tmodel = make_pair(seed=5, vocab=32, d_model=16,
                                       n_layer=2)
    toks = jnp.asarray(np.random.default_rng(6).integers(0, 32, (2, 9)))

    def loss(p):
        logits = jmodel.apply({"params": p}, toks[:, :-1])
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        return -jnp.take_along_axis(logp, toks[:, 1:, None], -1).mean()

    tx = optax.adamw(3e-3, weight_decay=1e-2)
    state = tx.init(params)
    opt = int8_eval.make_optimizer(tmodel, 2)
    named = dict(tmodel.named_parameters())
    for _ in range(2):
        g = jax.grad(loss)(params)
        upd, state = tx.update(g, state, params)
        params = optax.apply_updates(params, upd)
        for k, v in from_jax.mamba_lm_state_dict_from_jax(g, 2).items():
            if k in named:
                named[k].grad = v.clone()
        opt.step()
    want = from_jax.mamba_lm_state_dict_from_jax(params, 2)
    for k, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_fp32_scores_match_the_jax_eval_core():
    jmodel, params, tmodel = make_pair(seed=7, vocab=32, d_model=16,
                                       n_layer=2)
    corpus = int8_eval.make_corpus(np.random.default_rng(0), 2000)
    pairs = int8_eval.heldout_pairs(corpus, 6)
    tok = int8_eval.ToyTokenizer()
    jcore = JCore(jmodel, {"params": params}, tok)
    tcore = TCore(tmodel, {k: v.detach() for k, v in
                           tmodel.named_parameters()}, tok)
    for ctx, cont in pairs:
        ll_j, greedy_j = jcore.loglikelihood_pair(ctx, cont)
        ll_t, greedy_t = tcore.loglikelihood_pair(ctx, cont)
        np.testing.assert_allclose(ll_t, ll_j, rtol=1e-4, atol=1e-4)
        assert greedy_t == greedy_j


def test_main_on_the_cpu_writes_every_key(tmp_path, monkeypatch, capsys):
    for k, v in (("D_MODEL", 16), ("N_LAYER", 1), ("STEPS", 2),
                 ("N_EVAL", 2)):
        monkeypatch.setenv(f"INT8_EVAL_{k}", str(v))
    out = tmp_path / "int8_eval_torch.json"
    res = int8_eval.main(["--device", "cpu", "--out", str(out)])
    written = json.loads(out.read_text())
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert written == printed == json.loads(json.dumps(res))
    assert set(written) == {
        "config", "uniform_nll", "train_nll_curve", "final_train_nll",
        "results", "nll_delta_bf16_vs_fp32", "nll_delta_int8_vs_fp32",
        "device", "card", "train_seconds", "seconds"}
    assert set(written["results"]) == {"float32", "bfloat16", "int8"}
    for r in written["results"].values():
        assert set(r) == {"nll_per_token", "ppl", "greedy_exact_match"}
        assert np.isfinite(r["nll_per_token"])
    assert len(written["train_nll_curve"]) == 1
    assert written["card"] == "cpu" and written["device"] == "cpu"
    assert written["uniform_nll"] == np.log(32)
    assert "d_model=16 n_layer=1" in written["config"]
    assert written["nll_delta_int8_vs_fp32"] == (
        written["results"]["int8"]["nll_per_token"]
        - written["results"]["float32"]["nll_per_token"])
