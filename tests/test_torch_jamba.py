"""Jamba on the LM's serving path (``nn/jamba.py``, ``nn/attention.py``,
the dropless block of ``nn/moe.py``, the dt / B / C norms of
``nn/streaming.py``) against the benchmark's plain reference
(``perfbench/reference/jamba.py``), and that reference against
transformers' ``JambaForCausalLM`` (``use_mamba_kernels=False``, eager
attention), all on one seeded state dict under transformers' names.

Tiny widths, a whole period of 8 layers (attention at layer 4, experts at
the odd layers), 4 experts top-2, fp32 on the CPU.  Tolerance: logits at
``ATOL`` = 1e-4 absolute (they reach about 2): the readings are 1e-6 to
3e-6 (float32 against the reference's float64 scan and transformers'
float32 loop), so the margin is some 40 times, while each mutation below
moves the logits by 1e-2 or more.
"""

import dataclasses
import json

import pytest
import torch

from perfbench import weights
from perfbench.reference import jamba as ref
from vivim_tpu_torch.nn import attention, jamba, lm, moe

torch.set_num_threads(1)

ATOL = 1e-4

TINY = {"attn_layer_offset": 4, "attn_layer_period": 8,
        "expert_layer_offset": 1, "expert_layer_period": 2,
        "hidden_act": "silu", "hidden_size": 32, "intermediate_size": 48,
        "mamba_conv_bias": True, "mamba_d_conv": 4, "mamba_d_state": 16,
        "mamba_dt_rank": 8, "mamba_expand": 2, "mamba_proj_bias": False,
        "model_type": "jamba", "num_attention_heads": 4, "num_experts": 4,
        "num_experts_per_tok": 2, "num_hidden_layers": 8,
        "num_key_value_heads": 2, "rms_norm_eps": 1e-06,
        "sliding_window": None, "tie_word_embeddings": False,
        "vocab_size": 64}
# AI21-Jamba2-Mini's config.json, as published
MINI = {"attn_layer_offset": 4, "attn_layer_period": 8,
        "expert_layer_offset": 1, "expert_layer_period": 2,
        "hidden_act": "silu", "hidden_size": 4096,
        "intermediate_size": 14336, "mamba_conv_bias": True,
        "mamba_d_conv": 4, "mamba_d_state": 16, "mamba_dt_rank": 256,
        "mamba_expand": 2, "mamba_proj_bias": False,
        "max_position_embeddings": 262144, "model_type": "jamba",
        "num_attention_heads": 32, "num_experts": 16,
        "num_experts_per_tok": 2, "num_hidden_layers": 32,
        "num_key_value_heads": 8, "num_logits_to_keep": 1,
        "rms_norm_eps": 1e-06, "sliding_window": None,
        "tie_word_embeddings": False, "use_mamba_kernels": True,
        "vocab_size": 65536}


def state_dict(seed=3):
    """The benchmark's seeded weights at tiny widths, the norms moved off
    1 so that a dropped norm shows."""
    sd = weights.make({n: (s, torch.float32)
                       for n, s in ref.names(TINY).items()}, seed, "cpu")
    gen = torch.Generator().manual_seed(seed)
    for k in sd:
        if "norm" in k:
            sd[k] = sd[k] + 0.3 * torch.randn(sd[k].shape, generator=gen)
    return sd


@pytest.fixture(scope="module")
def models():
    sd = state_dict()
    reference = ref.build(TINY, "cpu")
    reference.load_state_dict(sd, strict=True)
    port = jamba.JambaLM(jamba.config_from_jamba_json(TINY)).eval()
    port.load_state_dict(sd, strict=True)
    return port, reference, sd


def tokens(batch, length, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, TINY["vocab_size"], (batch, length),
                         generator=gen)


def gap(a, b):
    return float((a.float() - b.float()).abs().max())


def generated_gap(port, reference, prompt, new=6, params=None):
    """The widest gap between generate's scores (an eager prefill, then the
    decode graph over the hybrid cache) and the reference's full forward
    over the prompt and the served tokens."""
    params = lm.lm_params(port) if params is None else params
    out, scores = lm.generate(port, params, prompt, new, top_k=1,
                              output_scores=True)
    with torch.no_grad():
        want = reference(out[:, :-1])[:, prompt.shape[1] - 1:]
    return gap(scores, want)


def test_config_from_jamba_json_takes_the_published_keys():
    cfg = jamba.config_from_jamba_json(MINI, num_hidden_layers=8)
    kinds = ["attention" if cfg.is_attention(i) else "mamba"
             for i in range(8)]
    assert kinds == ["mamba"] * 4 + ["attention"] + ["mamba"] * 3
    assert cfg.moe_layers() == [1, 3, 5, 7]
    assert (cfg.d_inner, cfg.head_dim, cfg.d_state, cfg.mamba_dt_rank) == (
        8192, 128, 16, 256)
    with pytest.raises(ValueError):
        jamba.config_from_jamba_json(dict(MINI, sliding_window=4096))


def test_layer_pattern_and_keys_are_transformers():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.JambaConfig(
        **{k: v for k, v in MINI.items() if k != "model_type"})
    cfg = jamba.config_from_jamba_json(MINI)
    assert hf_cfg.layers_block_type == [
        "attention" if cfg.is_attention(i) else "mamba" for i in range(32)]
    assert hf_cfg.layers_num_experts == [
        16 if cfg.has_experts(i) else 1 for i in range(32)]
    small = transformers.JambaForCausalLM(transformers.JambaConfig(
        **{k: v for k, v in TINY.items() if k != "model_type"},
        use_mamba_kernels=False))
    port = jamba.JambaLM(jamba.config_from_jamba_json(TINY))
    assert sorted(small.state_dict()) == sorted(port.state_dict()) == sorted(
        ref.names(TINY))


def test_reference_matches_transformers(models):
    transformers = pytest.importorskip("transformers")
    _, reference, sd = models
    hf = transformers.JambaForCausalLM(transformers.JambaConfig(
        **{k: v for k, v in TINY.items() if k != "model_type"},
        use_mamba_kernels=False, attn_implementation="eager")).eval()
    hf.load_state_dict(sd, strict=True)
    x = tokens(2, 11)
    with torch.no_grad():
        assert gap(hf(x).logits, reference(x)) < ATOL


def test_forward_matches_reference(models):
    port, reference, _ = models
    x = tokens(2, 11)
    with torch.no_grad():
        got = port(x)
        assert got.dtype == torch.float32
        assert gap(got, reference(x)) < ATOL
        # the reference's logits at chosen positions are its full ones
        assert gap(reference(x, positions=[3, 10]),
                   reference(x)[:, [3, 10]]) == 0.0


@pytest.mark.parametrize("prompt_len", [3, 9])   # 3: below d_conv
def test_generate_through_the_hybrid_cache_matches_reference(models,
                                                             prompt_len):
    port, reference, _ = models
    assert generated_gap(port, reference, tokens(2, prompt_len)) < ATOL
    assert isinstance(port._decoding_cache, lm.DecodeGraph)


def test_prefill_then_decode_steps_match_full_forward(models):
    """The functions under ``generate`` by hand: the K/V cache of
    ``max_len`` positions and its position, stepped eagerly."""
    port, reference, _ = models
    x = tokens(2, 10, seed=5)
    parts = port.split_params(lm.lm_params(port))
    with torch.no_grad():
        logits, states = lm.prefill(parts, x[:, :6], max_len=10)
        got = [logits]
        for t in range(6, 9):
            logits, states = lm.decode_step(parts, x[:, t], states)
            got.append(logits)
        want = reference(x[:, :9])[:, 5:]
    assert gap(torch.stack(got, 1), want) < ATOL
    cache, pos = states[4]
    assert cache.shape == (2, 2, 2, 10, 8) and int(pos) == 9


def per_token_moe(params, x, top_k):
    """The dropless block token by token, from its definition."""
    out = []
    for row in x:
        probs = torch.softmax(params["router.weight"] @ row, -1)
        gates, chosen = torch.topk(probs, top_k)
        y = 0
        for g, e in zip(gates, chosen.tolist()):
            p = lambda n: params[f"experts.{e}.{n}_proj.weight"]
            y = y + g * (p("down") @ (torch.nn.functional.silu(p("gate") @ row)
                                      * (p("up") @ row)))
        out.append(y)
    return torch.stack(out)


def test_dropless_block_matches_a_per_token_loop(models):
    port, _, _ = models
    params = lm.sub_params(lm.lm_params(port), "model.layers.1.feed_forward.")
    x = torch.randn(13, TINY["hidden_size"],
                    generator=torch.Generator().manual_seed(2))
    want = per_token_moe(params, x, 2)
    assert gap(moe.dropless_moe(params, x, 2), want) < 1e-5
    assert gap(moe.dropless_moe_step(params, x, 2), want) < 1e-5


def test_generate_combines_once_per_moe_layer_in_the_prefill_only(
        models, monkeypatch):
    """Each MoE layer (the odd ones) combines through ``moe_combine`` once
    in a prefill, with no shared expert; the decode steps never call it."""
    port, _, _ = models
    calls = []
    combine = moe.moe_combine
    monkeypatch.setattr(moe, "moe_combine",
                        lambda *a: calls.append(a[3]) or combine(*a))
    parts = port.split_params(lm.lm_params(port))
    x = tokens(2, 7)
    with torch.no_grad():
        _, states = lm.prefill(parts, x[:, :5], max_len=7)
        assert len(port.cfg.moe_layers()) == 4 and calls == [None] * 4
        for t in (5, 6):
            lm.decode_step(parts, x[:, t], states)
    assert len(calls) == 4


def test_generate_reads_two_to_four_experts_per_layer_and_step(models):
    port, _, _ = models
    params = lm.lm_params(port)
    read = int(moe.experts_read("cpu"))
    lm.generate(port, params, tokens(2, 5), 3, top_k=1)
    # each of the 3 steps (the last one's too) reads 2 to 4 distinct
    # experts in each of 4 layers; the prefill counts none
    assert 3 * 4 * 2 <= int(moe.experts_read("cpu")) - read <= 3 * 4 * 4


def test_experts_read_is_one_tensor_per_device(models):
    """A captured step adds to the count it was captured with: splitting
    another model's dict, of another MoE shape, keeps the same tensor."""
    port, _, _ = models
    before = moe.experts_read("cpu")
    wide = jamba.JambaLM(jamba.config_from_jamba_json(dict(
        TINY, num_experts=8, num_hidden_layers=4)))
    wide.split_params(lm.lm_params(wide))
    port.split_params(lm.lm_params(port))
    assert moe.experts_read("cpu") is before
    assert moe.experts_read(torch.device("cpu")) is before


def test_dropless_step_counts_distinct_experts(models):
    port, _, _ = models
    params = lm.sub_params(lm.lm_params(port), "model.layers.1.feed_forward.")
    x = torch.randn(5, TINY["hidden_size"],
                    generator=torch.Generator().manual_seed(4))
    _, experts = moe._route(params, x, 2)
    read = int(moe.experts_read("cpu"))
    moe.dropless_moe_step(params, x, 2)
    assert int(moe.experts_read("cpu")) - read == len(set(
        experts.flatten().tolist()))


def test_kv_bytes_count_the_caches(models):
    port, _, _ = models
    before = attention.KV_BYTES
    lm.generate(port, lm.lm_params(port), tokens(2, 5), 3, top_k=1)
    # one attention layer: (2, 2, kv 2, 5 + 3 positions, head_dim 8) fp32
    assert attention.KV_BYTES - before == 2 * 2 * 2 * 8 * 8 * 4


def renormalised_route(params, xt, top_k):
    gates, experts = torch.topk(torch.softmax(
        xt.float() @ params["router.weight"].float().t(), -1), top_k, dim=-1)
    return gates / gates.sum(-1, keepdim=True), experts


def test_mutations_fail_the_tolerance(models, monkeypatch):
    port, reference, _ = models
    x = tokens(2, 11)
    params = lm.lm_params(port)
    # the dt / B / C norms left out
    no_norms = {k: v for k, v in params.items()
                if not k.endswith(("dt_layernorm.weight",
                                   "b_layernorm.weight",
                                   "c_layernorm.weight"))}
    with torch.no_grad():
        want = reference(x)
        assert gap(lm.forward_functional(port, no_norms, x), want) > ATOL
        # top-1 routing
        top1 = jamba.JambaLM(dataclasses.replace(port.cfg,
                                                 num_experts_per_tok=1))
        top1.load_state_dict(port.state_dict())
        assert gap(top1(x), want) > ATOL
        # renormalised top-2 gates
        with monkeypatch.context() as m:
            m.setattr(moe, "_route", renormalised_route)
            assert gap(port(x), want) > ATOL
    # a K/V position that does not advance in decode
    real = attention.gqa_step

    def stuck(params, x, cache, pos, n_heads, n_kv, scale=None):
        # the step reads the position but advances a copy of it
        out, cache, _ = real(params, x, cache, pos.clone(), n_heads, n_kv,
                             scale)
        return out, cache, pos
    with monkeypatch.context() as m:
        m.setattr(attention, "gqa_step", stuck)
        port._decoding_cache = None
        assert generated_gap(port, reference, tokens(2, 9)) > ATOL
    port._decoding_cache = None


def write_snapshot(path, weights_of=None):
    """A snapshot directory: ``config.json`` and, given, the weights in two
    safetensors shards with their index, as a sharded checkpoint is
    published."""
    with open(path / "config.json", "w") as f:
        json.dump(TINY, f)
    if weights_of is None:
        return str(path)
    from safetensors.torch import save_file

    names = sorted(weights_of)
    shards = {f"model-0000{k + 1}-of-00002.safetensors": names[k::2]
              for k in range(2)}
    for shard, keys in shards.items():
        save_file({n: weights_of[n] for n in keys}, path / shard)
    with open(path / jamba.INDEX, "w") as f:
        json.dump({"weight_map": {n: shard for shard, keys in shards.items()
                                  for n in keys}}, f)
    return str(path)


def test_load_jamba_reads_a_snapshot_strictly(models, tmp_path):
    pytest.importorskip("safetensors")
    _, _, sd = models
    model, params = jamba.load_jamba(write_snapshot(tmp_path, sd),
                                     device="cpu")
    assert set(params) == set(sd)
    assert all(torch.equal(params[k], sd[k]) for k in sd)


def test_load_jamba_without_weights_draws_the_seeded_init(tmp_path):
    """A directory with no index: ``init_parameters`` from the seed, the
    same for the same seed."""
    path = write_snapshot(tmp_path)
    _, a = jamba.load_jamba(path, device="cpu", seed=5)
    _, b = jamba.load_jamba(path, device="cpu", seed=5)
    _, c = jamba.load_jamba(path, device="cpu", seed=6)
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = "model.layers.0.mamba.in_proj.weight"
    assert not torch.equal(a[w], c[w])
    assert torch.equal(a["model.layers.0.mamba.D"], torch.ones(64))


def test_load_jamba_cuts_the_layers_of_a_snapshot(models, tmp_path):
    """A 4-layer cut of the 8-layer snapshot loads its first 4 layers
    strictly and leaves the rest of the file unread."""
    pytest.importorskip("safetensors")
    _, _, sd = models
    model, params = jamba.load_jamba(write_snapshot(tmp_path, sd),
                                     device="cpu", num_hidden_layers=4)
    assert len(model.model.layers) == 4
    assert all(torch.equal(params[k], sd[k]) for k in params)
    assert "model.layers.4.self_attn.q_proj.weight" not in params


def test_bench_generation_takes_a_jamba_config_dir(tmp_path, capsys):
    from vivim_tpu_torch.cli import bench_generation

    out = bench_generation.main([
        "--hf_dir", write_snapshot(tmp_path), "--device", "cpu",
        "--promptlen", "5", "--genlen", "3", "--batch", "2",
        "--repeats", "1"])
    assert out.shape == (2, 8)
    line = json.loads(capsys.readouterr().out.splitlines()[0])
    assert line["gen_len"] == 3 and line["batch"] == 2
