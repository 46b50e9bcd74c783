"""The LM entry points of the PyTorch port against the JAX package's:
``cli/lm_eval_harness.py`` (``MambaEvalCore``, ``load_lm``, ``main``) and
``cli/bench_generation.py``, on the CPU.

Same weights on both sides (``from_jax.mamba_lm_state_dict_from_jax``, or
one snapshot directory both load), a character tokenizer, the JAX side on
its sequential scan.  Log-likelihoods at rtol 1e-4 / atol 1e-4 (a sum of
fp32 log-probabilities from logits held at 1e-4 elsewhere), int8 ones at
the bf16 tolerance rtol 3e-2 / atol 5e-2; generated text and greedy flags
exactly.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_lm_helpers import ToyTokenizer, make_pair, tokens
from tests.torch_vivim_ref import MambaLMRefTorch
from vivim_tpu.cli import lm_eval_harness as jeval
from vivim_tpu.nn import quant as jq
from vivim_tpu_torch.cli import bench_generation as tbench
from vivim_tpu_torch.cli import lm_eval_harness as teval
from vivim_tpu_torch.nn import lm as tlm
from vivim_tpu_torch.nn import quant as tq

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-4
BF16_RTOL, BF16_ATOL = 3e-2, 5e-2
TINY = ["--vocab", "50", "--d_model", "16", "--n_layer", "2",
        "--promptlen", "5", "--genlen", "3", "--repeats", "1"]


@pytest.fixture(scope="module")
def cores():
    """(JAX core, port core) on the same weights, fp32 and int8."""
    jmodel, params, tmodel = make_pair(seed=6)
    tok = ToyTokenizer()
    tparams = tlm.lm_params(tmodel)
    return {
        "fp32": (jeval.MambaEvalCore(jmodel, {"params": params}, tok,
                                     max_gen_toks=5),
                 teval.MambaEvalCore(tmodel, tparams, tok, max_gen_toks=5)),
        "int8": (jeval.MambaEvalCore(
            jmodel, jq.quantize_lm_params({"params": params}), tok,
            max_gen_toks=5),
                 teval.MambaEvalCore(tmodel, tq.quantize_lm_params(tparams),
                                     tok, max_gen_toks=5)),
    }


@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_eval_core_loglikelihood_matches_jax(cores, kind):
    jcore, tcore = cores[kind]
    tol = dict(rel=RTOL, abs=ATOL) if kind == "fp32" \
        else dict(rel=BF16_RTOL, abs=BF16_ATOL)
    for ctx, cont in (("abc", "de"), ("", "hello"), ("mamba", "s")):
        want, want_greedy = jcore.loglikelihood_pair(ctx, cont)
        got, greedy = tcore.loglikelihood_pair(ctx, cont)
        assert got == pytest.approx(want, **tol)
        assert greedy == want_greedy
    assert tcore.loglikelihood_rolling_str("abcd") == pytest.approx(
        jcore.loglikelihood_rolling_str("abcd"), **tol)


@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_eval_core_generate_until_matches_jax(cores, kind):
    jcore, tcore = cores[kind]
    for ctx in ("ab", "the cat", ""):
        text = tcore.generate_until_str(ctx)
        assert text == jcore.generate_until_str(ctx)
        if len(text) > 1:
            stop = (text[1],)
            assert tcore.generate_until_str(ctx, until=stop) \
                == jcore.generate_until_str(ctx, until=stop)


def test_eval_core_int8_scores_through_forward_functional(cores):
    """An int8 dict scores through the decode path's forward; a float one
    through the model itself."""
    _, tcore = cores["int8"]
    ids = [1, 2, 3, 4, 5]
    toks = torch.tensor([ids])
    want = tlm.forward_functional(tcore.model, tcore.params, toks)
    torch.testing.assert_close(tcore._fwd(toks), want, rtol=0, atol=0)
    _, fcore = cores["fp32"]
    with torch.no_grad():
        torch.testing.assert_close(fcore._fwd(toks), fcore.model(toks),
                                   rtol=0, atol=0)


def _write_snapshot(root, seed, d_state=16, **cfg):
    torch.manual_seed(seed)
    ref = MambaLMRefTorch(48, 32, 2, d_state=d_state,
                          rms_norm=cfg.get("rms_norm", False)).eval()
    torch.save(ref.state_dict(), root / "pytorch_model.bin")
    (root / "config.json").write_text(json.dumps(
        {"d_model": 32, "n_layer": 2, "vocab_size": 48,
         "ssm_cfg": {"d_state": d_state}, **cfg}))
    return ref


def test_load_lm_from_local_snapshot_matches_jax(tmp_path):
    """A snapshot (config.json + pytorch_model.bin in the reference layout,
    RMSNorm, fp32 residual, without lm_head.weight) loads strictly and
    gives the JAX ``load_lm``'s logits on the same files."""
    ref = _write_snapshot(tmp_path, 11, rms_norm=True, residual_in_fp32=True,
                          fused_add_norm=True, pad_vocab_size_multiple=8)
    model, params = teval.load_lm(None, 0, 0, 0, hf_dir=str(tmp_path),
                                  device="cpu")
    jmodel, jparams = jeval.load_lm(None, 0, 0, 0, hf_dir=str(tmp_path))
    assert model.cfg.rms_norm and model.cfg.residual_in_fp32
    assert model.cfg.padded_vocab == jmodel.cfg.padded_vocab == 48
    assert not model.training and set(params) == {
        k for k, _ in model.named_parameters()}
    toks = tokens((2, 7), seed=13, vocab=48)
    with torch.no_grad():
        got = model(torch.from_numpy(toks).long())
        ref_logits = ref(torch.from_numpy(toks).long())
    want = jmodel.apply(jparams, jnp.asarray(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(got.numpy(), ref_logits.numpy(), rtol=1e-3,
                               atol=1e-4)


def test_load_lm_ckpt_and_random_init(tmp_path):
    ref = _write_snapshot(tmp_path, 12)
    model, _ = teval.load_lm(str(tmp_path / "pytorch_model.bin"), 48, 32, 2,
                             device="cpu")
    for k, v in ref.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    a, pa = teval.load_lm(None, 50, 16, 2, device="cpu", seed=3)
    _, pb = teval.load_lm(None, 50, 16, 2, device="cpu", seed=3)
    assert a.cfg.padded_vocab == 56 and a.cfg.n_layer == 2
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert float(pa["backbone.embedding.weight"].std()) == pytest.approx(
        0.02, rel=0.2)


def test_load_lm_from_hub_repo(tmp_path, monkeypatch):
    """``hf_repo`` resolves through huggingface_hub.snapshot_download (mocked
    here: no network), then loads as ``hf_dir``; offline it stops naming
    --hf_dir, as the JAX CLI does."""
    import huggingface_hub

    _write_snapshot(tmp_path, 13)
    seen = []
    monkeypatch.setattr(huggingface_hub, "snapshot_download",
                        lambda repo_id, **kw: seen.append(repo_id)
                        or str(tmp_path))
    model, _ = teval.load_lm(None, 0, 0, 0, hf_repo="state-spaces/mamba-130m",
                             device="cpu")
    assert seen == ["state-spaces/mamba-130m"] and model.cfg.d_model == 32

    def boom(repo_id, **kw):
        raise OSError("name resolution failed")

    monkeypatch.setattr(huggingface_hub, "snapshot_download", boom)
    for load in (teval.load_lm, jeval.load_lm):
        with pytest.raises(SystemExit, match="--hf_dir"):
            load(None, 0, 0, 0, hf_repo="state-spaces/mamba-130m")


def test_d_state_other_than_16_is_refused_on_the_card(tmp_path):
    """The CUDA kernels take d_state 1 to 256, the limit mamba_ssm's CUDA
    scan has: ``device="cuda"`` takes every d_state in it and refuses 257
    before any weight is read (the check needs no card); the CPU and
    ``implementation="ref"`` take 257 too."""
    for d_state in (1, 8, 12, 16, 64, 256):
        cfg = tlm.MambaLMConfig(vocab_size=50, d_model=16, n_layer=2,
                                d_state=d_state)
        for dev in ("cuda", torch.device("cuda", 0)):
            tlm.check_kernel_config(cfg, dev)
    wide = tlm.MambaLMConfig(vocab_size=50, d_model=16, n_layer=2,
                             d_state=257)
    for dev in ("cuda", torch.device("cuda", 0)):
        with pytest.raises(ValueError, match=r"d_state 257: .* 1 to 256"):
            tlm.check_kernel_config(wide, dev)
    tlm.check_kernel_config(wide, "cpu")
    tlm.check_kernel_config(wide, "cuda", implementation="ref")
    _write_snapshot(tmp_path, 14, d_state=257)
    (tmp_path / "pytorch_model.bin").write_bytes(b"not read")
    with pytest.raises(ValueError, match="d_state 257"):
        teval.load_lm(None, 0, 0, 0, hf_dir=str(tmp_path), device="cuda")
    model, _ = teval.load_lm(None, 50, 16, 2, device="cpu")
    assert model.cfg.d_state == 16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_bench_generation_prints_the_jax_line(capsys, dtype):
    tbench.main(TINY + ["--dtype", dtype, "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(out) == ["prompt_len", "gen_len", "batch", "total_sec",
                         "tokens_per_sec", "dtype"]
    assert (out["prompt_len"], out["gen_len"], out["batch"], out["dtype"]) \
        == (5, 3, 1, dtype)
    assert out["tokens_per_sec"] > 0


def test_bench_generation_keys_equal_the_jax_cli(capsys):
    from vivim_tpu.cli import bench_generation as jbench

    jbench.main(TINY)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    tbench.main(TINY + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(got) == list(want)
    assert {k: got[k] for k in ("prompt_len", "gen_len", "batch", "dtype")} \
        == {k: want[k] for k in ("prompt_len", "gen_len", "batch", "dtype")}


def test_unported_and_missing_pieces_stop_as_the_jax_clis(tmp_path):
    """Missing pieces stop as the JAX CLIs do.  ``--tp_shards`` /
    ``--pp_stages`` run under torchrun (``tests/test_torch_tensor_parallel.
    py``); outside it the bench stops naming the torchrun command, the eval
    CLI stops first for the missing ``lm_eval`` (the JAX CLI's order), and
    the eval core finds no process group to shard over."""
    with pytest.raises(SystemExit, match="--prompt needs --tokenizer"):
        tbench.main(TINY + ["--device", "cpu", "--prompt", "hi"])
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node 2"):
        tbench.main(TINY + ["--device", "cpu", "--tp_shards", "2"])
    with pytest.raises(SystemExit, match="single-device decode only"):
        tbench.main(TINY + ["--device", "cpu", "--tp_shards", "2",
                            "--dtype", "int8"])
    for flag in ("--tp_shards", "--pp_stages"):
        for main in (teval.main, jeval.main):
            with pytest.raises(SystemExit, match="lm_eval is not installed"):
                main(["--tasks", "x", flag, "2"])
    for main in (teval.main, jeval.main):
        with pytest.raises(SystemExit, match="lm_eval is not installed"):
            main(["--tasks", "lambada_openai"])
    model, params = teval.load_lm(None, 50, 16, 2, device="cpu")
    for kw in (dict(tp_shards=2), dict(pp_stages=4)):
        with pytest.raises(ValueError, match="use torchrun"):
            teval.MambaEvalCore(model, params, ToyTokenizer(), **kw)
    with pytest.raises(ValueError, match="mutually exclusive"):
        teval.MambaEvalCore(model, params, ToyTokenizer(), tp_shards=2,
                            pp_stages=2)
