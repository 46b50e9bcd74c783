"""Falcon-H1 on the LM's serving path (``nn/falcon_h1.py``, the parallel
layer of ``nn/lm.py``, the rotary positions of ``nn/attention.py``, the
µP multipliers and the per-group gated norm of the Mamba-2 mixer in
``nn/streaming.py``) against the benchmark's plain reference
(``perfbench/reference/falcon_h1.py``), and both against transformers'
``FalconH1ForCausalLM`` (its torch path, eager attention), all on one
seeded state dict under transformers' names.

Tiny widths: 2 layers, each attention (4 query and 2 key/value heads of 8,
RoPE at theta 100, so that every frequency turns within a few positions)
beside a Mamba-2 mixer (8 heads of 8 in 2 groups, d_state 16), a SwiGLU of
48, every µP multiplier set off 1 and off the others, fp32 on the CPU.
Tolerance: logits at ``ATOL`` = 1e-4 absolute (they reach about 1): the
readings are 1e-7 to 1e-6 (float32 against the reference's float64 scan and
transformers' float32 chunked scan), so the margin is some 100 times, while
each mutation below moves the logits by more than it.

The NoPE and one-norm-group paths (Jamba's, Granite's) are held bit for bit
to the parent's formulas, kept here: the attention without positions and
Granite's gated norm over all d_inner channels.
"""

import dataclasses
import functools
import json
import math
import os

import pytest
import torch
import torch.nn.functional as F

from perfbench.reference import falcon_h1 as ref
from vivim_tpu_torch.nn import attention, falcon_h1, lm, streaming
from vivim_tpu_torch.nn.quant import matmul_t

torch.set_num_threads(1)

ATOL = 1e-4

TINY = {"attention_bias": False, "attention_in_multiplier": 0.8,
        "attention_out_multiplier": 0.5, "attn_layer_indices": None,
        "embedding_multiplier": 2.5, "head_dim": 8, "hidden_act": "silu",
        "hidden_size": 32, "intermediate_size": 48, "key_multiplier": 0.4,
        "lm_head_multiplier": 0.25, "mamba_chunk_size": 16,
        "mamba_conv_bias": True, "mamba_d_conv": 4, "mamba_d_head": 8,
        "mamba_d_ssm": 64, "mamba_d_state": 16, "mamba_expand": 2,
        "mamba_n_groups": 2, "mamba_n_heads": 8,
        "mamba_norm_before_gate": False, "mamba_proj_bias": False,
        "mamba_rms_norm": True, "mlp_bias": False,
        "mlp_multipliers": [0.6, 0.7], "model_type": "falcon_h1",
        "num_attention_heads": 4, "num_hidden_layers": 2,
        "num_key_value_heads": 2, "projectors_bias": False,
        "rms_norm_eps": 1e-5, "rope_scaling": None, "rope_theta": 100,
        "ssm_in_multiplier": 0.5,
        "ssm_multipliers": [0.9, 0.8, 0.7, 1.3, 0.6],
        "ssm_out_multiplier": 0.3, "tie_word_embeddings": False,
        "vocab_size": 64}
# Falcon-H1-34B's config.json: the benchmark's file, uncut
with open(os.path.join(os.path.dirname(__file__), os.pardir, "perfbench",
                       "configs", "falcon-h1-34b-18l.json")) as f:
    PUBLISHED = json.load(f)
PUBLISHED.update(PUBLISHED["published"])


def state_dict(cfg=TINY, seed=3):
    """Seeded weights at tiny widths: fan-in scaled projections, a
    unit-normal embedding, Mamba2's A and dt init, D and the norms moved
    off 1 so that a dropped one shows."""
    gen = torch.Generator().manual_seed(seed)
    rand = lambda s: torch.rand(s, generator=gen)
    randn = lambda s: torch.randn(s, generator=gen)
    sd = {}
    for n, s in ref.names(cfg).items():
        if n.endswith("A_log"):
            t = torch.log(1 + 15 * rand(s))
        elif n.endswith("dt_bias"):
            dt = torch.exp(math.log(1e-3) + math.log(100) * rand(s))
            t = dt + torch.log(-torch.expm1(-dt))
        elif n.endswith(".D") or "norm" in n:
            t = 1 + 0.2 * randn(s)
        elif "embed" in n:
            t = randn(s)
        elif "conv1d" in n:
            t = (rand(s) * 2 - 1) * 0.5
        else:
            t = randn(s) / math.sqrt(s[-1])
        sd[n] = t
    return sd


def port_of(cfg, sd):
    model = falcon_h1.FalconH1LM(falcon_h1.config_from_falcon_json(cfg))
    model.load_state_dict(sd, strict=True)
    return model.eval()


def reference_of(cfg, sd):
    model = ref.FalconH1(cfg)
    model.load_state_dict(sd, strict=True)
    return model


@pytest.fixture(scope="module")
def models():
    sd = state_dict()
    return port_of(TINY, sd), reference_of(TINY, sd), sd


def tokens(batch, length, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, TINY["vocab_size"], (batch, length),
                         generator=gen)


def gap(a, b):
    return float((a.float() - b.float()).abs().max())


def transformers_model(cfg, sd):
    transformers = pytest.importorskip("transformers")
    hf = transformers.FalconH1ForCausalLM(transformers.FalconH1Config(
        **{k: v for k, v in cfg.items() if k != "model_type"},
        attn_implementation="eager"))
    hf.load_state_dict(sd, strict=True)
    return hf.eval()


def test_config_from_falcon_json_takes_the_published_keys():
    cfg = falcon_h1.config_from_falcon_json(PUBLISHED, num_hidden_layers=18)
    assert cfg.num_hidden_layers == 18
    assert (cfg.hidden_size, cfg.num_attention_heads,
            cfg.num_key_value_heads, cfg.head_dim, cfg.intermediate_size,
            cfg.vocab_size) == (5120, 20, 4, 128, 21504, 261120)
    assert (cfg.d_inner, cfg.conv_dim, cfg.mamba_n_heads, cfg.mamba_d_head,
            cfg.mamba_n_groups, cfg.d_state) == (4096, 5120, 32, 128, 2,
                                                 256)
    assert cfg.rope_theta == 1e11 and not cfg.tie_word_embeddings
    assert cfg.key_multiplier == pytest.approx(0.011048543456039804)
    assert cfg.ssm_multipliers == tuple(PUBLISHED["ssm_multipliers"])
    assert cfg.mlp_multipliers == tuple(PUBLISHED["mlp_multipliers"])
    assert (cfg.embedding_multiplier, cfg.lm_head_multiplier,
            cfg.ssm_in_multiplier, cfg.ssm_out_multiplier,
            cfg.attention_in_multiplier, cfg.attention_out_multiplier) == (
        PUBLISHED["embedding_multiplier"], 0.0078125, 0.25,
        PUBLISHED["ssm_out_multiplier"], 1, 0.0375)
    assert falcon_h1.config_from_falcon_json(PUBLISHED).num_hidden_layers \
        == 72


@pytest.mark.parametrize("change", [
    {"attention_bias": True}, {"projectors_bias": True}, {"mlp_bias": True},
    {"mamba_proj_bias": True}, {"rope_scaling": {"rope_type": "linear",
                                                 "factor": 2.0}},
    {"attn_layer_indices": [1]}, {"mamba_norm_before_gate": True},
    {"mamba_rms_norm": False}, {"hidden_act": "gelu"},
    # 3 groups of 64 / 3 channels, 16 groups of 4 cut the heads of 8
    {"mamba_n_groups": 3}, {"mamba_n_groups": 16},
    {"mamba_n_heads": 6}], ids=lambda c: next(iter(c)))
def test_config_refuses_what_the_port_does_not_run(change):
    with pytest.raises(ValueError):
        falcon_h1.config_from_falcon_json(dict(TINY, **change))


def test_attn_layer_indices_naming_every_layer_are_taken():
    cfg = falcon_h1.config_from_falcon_json(dict(TINY,
                                                 attn_layer_indices=[0, 1]))
    assert cfg.num_hidden_layers == 2


def test_a_d_state_past_the_kernels_is_refused_on_the_card():
    cfg = falcon_h1.config_from_falcon_json(dict(TINY, mamba_d_state=512))
    with pytest.raises(ValueError, match="d_state 512"):
        lm.check_kernel_config(cfg, "cuda")
    lm.check_kernel_config(cfg, "cpu")


def test_state_dict_keys_are_transformers_and_load_strictly_both_ways():
    hf = transformers_model(TINY, state_dict())
    port = falcon_h1.FalconH1LM(falcon_h1.config_from_falcon_json(TINY))
    assert sorted(hf.state_dict()) == sorted(port.state_dict()) == sorted(
        ref.names(TINY))
    hf.load_state_dict(port.state_dict(), strict=True)
    port.load_state_dict(hf.state_dict(), strict=True)


@pytest.mark.parametrize("length", [11, 20])   # 20: past the chunk of 16
def test_port_and_reference_match_transformers(models, length):
    port, reference, sd = models
    hf = transformers_model(TINY, sd)
    x = tokens(2, length)
    with torch.no_grad():
        want = hf(x).logits
        assert gap(reference(x), want) < ATOL
        got = port(x)
        assert got.dtype == torch.float32
        assert gap(got, want) < ATOL


def test_forward_matches_reference(models):
    port, reference, _ = models
    x = tokens(2, 11)
    with torch.no_grad():
        assert gap(port(x), reference(x)) < ATOL
        assert gap(reference(x, positions=[3, 10]),
                   reference(x)[:, [3, 10]]) == 0.0


@pytest.mark.parametrize("prompt_len", [3, 9])   # 3: below d_conv
def test_generate_through_the_parallel_states_matches_reference(
        models, prompt_len):
    """generate's scores (an eager prefill, then the decode graph over each
    layer's Mamba-2 states and K/V cache, RoPE at the device position)
    against the reference's full forward over the prompt and the served
    tokens, at every decoded position."""
    port, reference, _ = models
    prompt = tokens(2, prompt_len)
    out, scores = lm.generate(port, lm.lm_params(port), prompt, 6, top_k=1,
                              output_scores=True)
    with torch.no_grad():
        want = reference(out[:, :-1])[:, prompt_len - 1:]
    assert gap(scores, want) < ATOL
    assert isinstance(port._decoding_cache, lm.DecodeGraph)


def test_prefill_then_decode_steps_match_full_forward(models):
    """The functions under ``generate`` by hand: each layer's record of
    four states (the xBC window, the (B, d_ssm, N) fp32 state, the K/V
    cache of ``max_len`` positions and its position), stepped in place."""
    port, reference, _ = models
    x = tokens(2, 10, seed=5)
    parts = port.split_params(lm.lm_params(port))
    with torch.no_grad():
        logits, states = lm.prefill(parts, x[:, :6], max_len=10)
        got = [logits]
        for t in range(6, 9):
            logits, states2 = lm.decode_step(parts, x[:, t], states)
            assert all(a is b for s, s2 in zip(states, states2)
                       for a, b in zip(s, s2))
            got.append(logits)
        want = reference(x[:, :9])[:, 5:]
    assert gap(torch.stack(got, 1), want) < ATOL
    for window, ssm, cache, pos in states:
        assert window.shape == (2, 4, 64 + 2 * 2 * 16)
        assert ssm.shape == (2, 64, 16) and ssm.dtype == torch.float32
        assert cache.shape == (2, 2, 2, 10, 8) and int(pos) == 9


def test_kv_bytes_count_every_layers_cache(models):
    port, _, _ = models
    parts = port.split_params(lm.lm_params(port))
    before = attention.KV_BYTES
    with torch.no_grad():
        lm.prefill(parts, tokens(2, 5), max_len=12)
    # 2 layers x (B 2, K and V, 2 heads, 12 positions, 8) fp32
    assert attention.KV_BYTES - before == 2 * 2 * 2 * 2 * 12 * 8 * 4


def test_rope_matches_transformers_in_bf16_bit_for_bit():
    """The rotation of ``nn/attention.py`` (cos and sin in fp32 cast to
    bf16, ``rotate_half``) against transformers' rotary embedding and
    ``apply_rotary_pos_emb`` at the published theta and head_dim, over the
    prefill's positions and at one device-side decode position."""
    transformers = pytest.importorskip("transformers")
    from transformers.models.falcon_h1 import modeling_falcon_h1 as hf

    cfg = transformers.FalconH1Config(**{
        k: v for k, v in PUBLISHED.items() if k in (
            "hidden_size", "num_attention_heads", "head_dim", "rope_theta",
            "max_position_embeddings", "mamba_d_ssm", "mamba_n_heads")})
    rotary = hf.FalconH1RotaryEmbedding(cfg)
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 7, 20, 128, generator=gen).bfloat16() * 20
    k = torch.randn(2, 7, 4, 128, generator=gen).bfloat16()
    rp = attention.make_rope(PUBLISHED["rope_theta"], 128)
    positions = torch.arange(4090, 4097)
    got_q, got_k = attention._rotate(rp, positions, q, k)
    cos, sin = rotary(q, positions[None])
    want_q, want_k = hf.apply_rotary_pos_emb(q.transpose(1, 2),
                                             k.transpose(1, 2), cos, sin)
    assert torch.equal(got_q, want_q.transpose(1, 2))
    assert torch.equal(got_k, want_k.transpose(1, 2))
    one_q, one_k = attention._rotate(rp, positions[3:4], q[:, 3:4],
                                     k[:, 3:4])
    assert torch.equal(one_q, got_q[:, 3:4])
    assert torch.equal(one_k, got_k[:, 3:4])


def test_spans_open_once_per_layer_in_prefill_only(models, monkeypatch):
    """``lm.ssm`` around each mixer's recurrence and ``lm.attn`` around each
    attention branch, in the prefill; the decode graph opens neither."""
    port, _, _ = models
    opened = []
    for mod in (streaming, lm):
        real = mod.span
        monkeypatch.setattr(mod, "span", lambda name, real=real: (
            opened.append(name) or real(name)))
    parts = port.split_params(lm.lm_params(port))
    x = tokens(2, 7)
    with torch.no_grad():
        _, states = lm.prefill(parts, x, max_len=10)
        assert opened == ["lm.ssm", "lm.attn"] * 2
        graph = lm.decode_graph(port, parts, lm.lm_params(port), states)
        step = graph.start(states)
        for t in range(3):
            step(x[:, t])
    assert opened == ["lm.ssm", "lm.attn"] * 2 + ["graph.key"]


def all_channel_norm(m, y, z):
    """The gated norm over all d_ssm channels (Granite's), not per group."""
    f = y.float()
    if z is not None:
        f = f * F.silu(z.float())
    f = f * torch.rsqrt((f * f).mean(-1, keepdim=True) + m.norm_eps)
    return (m.params["norm.weight"] * f).to(y.dtype)


def replace_layers(parts, **mixer):
    return dataclasses.replace(parts, layers=[
        dataclasses.replace(layer, mixer=dataclasses.replace(
            layer.mixer, **mixer)) for layer in parts.layers])


def replace_ssm(parts, **ssm):
    return dataclasses.replace(parts, layers=[
        dataclasses.replace(layer, mixer=dataclasses.replace(
            layer.mixer, ssm=dataclasses.replace(layer.mixer.ssm, **ssm)))
        for layer in parts.layers])


MUTATIONS = {
    "no_rope": lambda p: dataclasses.replace(p, rope=None),
    "no_key_multiplier": lambda p: dataclasses.replace(
        p, rope=dataclasses.replace(p.rope, key_multiplier=1.0)),
    "rope_theta_1e4": lambda p: dataclasses.replace(p, rope=attention.
                                                    make_rope(1e4, 8)),
    "no_embedding_multiplier": lambda p: dataclasses.replace(
        p, embedding_multiplier=1.0),
    "no_lm_head_multiplier": lambda p: dataclasses.replace(
        p, lm_head_multiplier=1.0),
    "no_attention_in": lambda p: replace_layers(p, attn_in=1.0),
    "no_attention_out": lambda p: replace_layers(p, attn_out=1.0),
    "no_ssm_out": lambda p: replace_layers(p, ssm_out=1.0),
    "no_ssm_in": lambda p: replace_ssm(p, in_multiplier=1.0),
    "no_mup_vector": lambda p: replace_ssm(p, mup=None),
    "norm_over_all_channels": lambda p: replace_ssm(p, norm_groups=1),
    "no_mlp_multipliers": lambda p: dataclasses.replace(p, layers=[
        dataclasses.replace(layer, ff=functools.partial(
            falcon_h1.mlp, layer.ff.args[0], 1.0, 1.0))
        for layer in p.layers]),
}


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_mutations_fail_the_tolerance(models, mutation):
    port, reference, _ = models
    x = tokens(2, 11)
    parts = port.split_params(lm.lm_params(port))
    with torch.no_grad():
        want = reference(x)
        assert gap(lm.forward_parts(parts, x), want) < ATOL
        bad = MUTATIONS[mutation](parts)
        assert gap(lm.forward_parts(bad, x), want) > ATOL


def test_all_channel_norm_fails_in_decode_too(models, monkeypatch):
    port, reference, _ = models
    x = tokens(2, 9, seed=4)
    parts = port.split_params(lm.lm_params(port))
    with torch.no_grad():
        _, states = lm.prefill(parts, x[:, :2], max_len=9)
        monkeypatch.setattr(streaming, "gated_norm", all_channel_norm)
        got = [lm.decode_step(parts, x[:, t], states)[0]
               for t in range(2, 8)]
        want = reference(x[:, :8])[:, 2:]
        assert gap(torch.stack(got, 1), want) > ATOL


# the parent's formulas of what this module's model changed in the shared
# code: the attention without positions and the gated norm over all
# channels, its weight times the rounded value
def parent_gqa_prefill(params, x, n_heads, n_kv, max_len=None, scale=None):
    b, L, _ = x.shape
    q, k, v = parent_qkv(params, x, n_heads, n_kv)
    max_len = L if max_len is None else max_len
    cache = x.new_zeros(b, 2, n_kv, max_len, k.shape[-1])
    cache[:, 0, :, :L] = k.transpose(1, 2)
    cache[:, 1, :, :L] = v.transpose(1, 2)
    group = n_heads // n_kv
    q = q.transpose(1, 2)
    k = k.transpose(1, 2).repeat_interleave(group, 1)
    v = v.transpose(1, 2).repeat_interleave(group, 1)
    y = F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=scale)
    y = y.transpose(1, 2).reshape(b, L, -1)
    pos = torch.full((1,), L, dtype=torch.long, device=x.device)
    return matmul_t(y, params["o_proj.weight"]), cache, pos


def parent_gqa_step(params, x, cache, pos, n_heads, n_kv, scale=None):
    b = x.shape[0]
    q, k, v = parent_qkv(params, x, n_heads, n_kv)
    head_dim = k.shape[-1]
    cache.index_copy_(3, pos, torch.stack([k, v], 1)[:, :, :, None])
    q = q.reshape(b, n_kv, n_heads // n_kv, head_dim)
    seen = (torch.arange(cache.shape[3], device=x.device) <= pos)[
        None, None, None]
    y = F.scaled_dot_product_attention(q, cache[:, 0], cache[:, 1],
                                       attn_mask=seen, scale=scale)
    return matmul_t(y.reshape(b, -1), params["o_proj.weight"]), cache, \
        pos.add_(1)


def parent_qkv(params, x, n_heads, n_kv):
    head_dim = params["q_proj.weight"].shape[0] // n_heads
    split = lambda t, n: t.reshape(*t.shape[:-1], n, head_dim)
    return (split(matmul_t(x, params["q_proj.weight"]), n_heads),
            split(matmul_t(x, params["k_proj.weight"]), n_kv),
            split(matmul_t(x, params["v_proj.weight"]), n_kv))


def parent_gated_norm(m, y, z):
    f = y.float()
    if z is not None:
        f = f * F.silu(z.float())
    f = f * torch.rsqrt((f * f).mean(-1, keepdim=True) + m.norm_eps)
    return m.params["norm.weight"] * f.to(y.dtype)


def granite_model(groups):
    from tests import test_torch_granite as tg
    from vivim_tpu_torch.nn import granite

    cfg = dict(tg.TINY, mamba_n_groups=groups)
    return tg.load(granite.GraniteHybridLM(
        granite.config_from_granite_json(cfg)), tg.state_dict(cfg))


def jamba_model():
    from tests import test_torch_jamba as tj
    from vivim_tpu_torch.nn import jamba

    port = jamba.JambaLM(jamba.config_from_jamba_json(tj.TINY))
    port.load_state_dict(tj.state_dict(), strict=True)
    return port.eval()


@pytest.mark.parametrize("model", ["jamba", "granite-1", "granite-2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nope_hybrids_are_bit_identical_to_the_parent_formulas(
        monkeypatch, model, dtype):
    """Jamba's and Granite's tiny generate (prefill, then the decode graph)
    under this tree's attention and gated norm equal, bit for bit, the
    same under the parent's formulas."""
    port = (jamba_model() if model == "jamba"
            else granite_model(int(model[-1])))
    params = {k: v.to(dtype) for k, v in lm.lm_params(port).items()}
    prompt = tokens(2, 7, seed=6)

    def run():
        port._decoding_cache = None
        return lm.generate(port, params, prompt, 5, top_k=1,
                           output_scores=True)

    out, scores = run()
    with monkeypatch.context() as m:
        m.setattr(attention, "gqa_prefill", parent_gqa_prefill)
        m.setattr(attention, "gqa_step", parent_gqa_step)
        m.setattr(streaming, "gated_norm", parent_gated_norm)
        want_out, want_scores = run()
    assert torch.equal(out, want_out)
    assert torch.equal(scores, want_scores)


def write_snapshot(path, weights_of=None, cfg=TINY):
    """A snapshot directory: ``config.json`` and, given, the weights in two
    safetensors shards with their index."""
    with open(path / "config.json", "w") as f:
        json.dump(cfg, f)
    if weights_of is None:
        return str(path)
    from safetensors.torch import save_file

    from vivim_tpu_torch.nn import jamba

    names = sorted(weights_of)
    shards = {f"model-0000{k + 1}-of-00002.safetensors": names[k::2]
              for k in range(2)}
    for shard, keys in shards.items():
        save_file({n: weights_of[n] for n in keys}, path / shard)
    with open(path / jamba.INDEX, "w") as f:
        json.dump({"weight_map": {n: shard for shard, keys in shards.items()
                                  for n in keys}}, f)
    return str(path)


def test_load_falcon_h1_reads_a_snapshot_strictly(models, tmp_path):
    pytest.importorskip("safetensors")
    _, _, sd = models
    model, params = falcon_h1.load_falcon_h1(write_snapshot(tmp_path, sd),
                                             device="cpu")
    assert set(params) == set(sd)
    assert all(torch.equal(params[k], sd[k]) for k in sd)
    # a cut to the first layer leaves the rest of the files unread
    model, params = falcon_h1.load_falcon_h1(str(tmp_path), device="cpu",
                                             num_hidden_layers=1)
    assert model.cfg.num_hidden_layers == 1
    assert "model.layers.1.mamba.A_log" not in params


def test_load_falcon_h1_without_weights_draws_the_mamba2_init(tmp_path):
    path = write_snapshot(tmp_path)
    _, a = falcon_h1.load_falcon_h1(path, device="cpu", seed=5)
    _, b = falcon_h1.load_falcon_h1(path, device="cpu", seed=5)
    _, c = falcon_h1.load_falcon_h1(path, device="cpu", seed=6)
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = "model.layers.0.mamba.in_proj.weight"
    assert not torch.equal(a[w], c[w])
    pre = "model.layers.0.mamba."
    A = torch.exp(a[pre + "A_log"])
    dt = torch.nn.functional.softplus(a[pre + "dt_bias"])
    assert bool(((A >= 1) & (A <= 16)).all())
    assert bool(((dt >= 1e-3 - 1e-6) & (dt <= 0.1 + 1e-6)).all())
    assert torch.equal(a[pre + "D"], torch.ones(8))
    assert torch.equal(a[pre + "norm.weight"], torch.ones(64))


def test_bench_generation_takes_a_falcon_h1_config_dir(tmp_path, capsys):
    from vivim_tpu_torch.cli import bench_generation

    out = bench_generation.main([
        "--hf_dir", write_snapshot(tmp_path), "--device", "cpu",
        "--promptlen", "5", "--genlen", "3", "--batch", "2",
        "--repeats", "1", "--n_layer", "1"])
    assert out.shape == (2, 8)
    line = json.loads(capsys.readouterr().out.splitlines()[0])
    assert line["gen_len"] == 3 and line["batch"] == 2
