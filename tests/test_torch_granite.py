"""Granite 4.0-H on the LM's serving path (``nn/granite.py``, the Mamba-2
mixer of ``nn/streaming.py``, the per-head ``ssm_step``, the renormalised
top-k block with stacked and shared experts of ``nn/moe.py``, the µP
scalars of ``nn/lm.py``) against the benchmark's plain reference
(``perfbench/reference/granite.py``), and that reference against
transformers' ``GraniteMoeHybridForCausalLM`` (its torch path, eager
attention), all on one seeded state dict under transformers' names.

Tiny widths: 4 layers (attention at layer 2), Mamba-2 with 8 heads of 8 at
d_state 16, 8 experts top-3 with a shared expert, Granite's µP scalars and
an attention scale of 0.1 (not 1/sqrt(8)), fp32 on the CPU.  Tolerance:
logits at ``ATOL`` = 1e-4 absolute (they reach about 2.4): the readings
are 2e-7 to 1e-6 (float32 against the reference's float64 scan and
transformers' float32 chunked scan), so the margin is some 100 times,
while each mutation below moves the logits by 8.6e-4 (A of the wrong head)
to 35 (no logit scaling).
"""

import dataclasses
import json
import math
import os

import pytest
import torch

from perfbench.reference import granite as ref
from vivim_tpu_torch.kernels import mamba_step as mk
from vivim_tpu_torch.kernels.selective_scan import selective_scan
from vivim_tpu_torch.nn import granite, lm, moe, streaming

torch.set_num_threads(1)

ATOL = 1e-4

TINY = {"attention_bias": False, "attention_multiplier": 0.1,
        "embedding_multiplier": 12, "hidden_act": "silu", "hidden_size": 32,
        "intermediate_size": 24, "layer_types": ["mamba", "mamba",
                                                 "attention", "mamba"],
        "logits_scaling": 16, "mamba_chunk_size": 256,
        "mamba_conv_bias": True, "mamba_d_conv": 4, "mamba_d_head": 8,
        "mamba_d_state": 16, "mamba_expand": 2, "mamba_n_groups": 1,
        "mamba_n_heads": 8, "mamba_proj_bias": False,
        "model_type": "granitemoehybrid", "num_attention_heads": 4,
        "num_experts_per_tok": 3, "num_hidden_layers": 4,
        "num_key_value_heads": 2, "num_local_experts": 8,
        "position_embedding_type": "nope", "residual_multiplier": 0.22,
        "rms_norm_eps": 1e-05, "shared_intermediate_size": 40,
        "tie_word_embeddings": True, "vocab_size": 64}
# granite-4.0-h-small's config.json: the benchmark's file, uncut
with open(os.path.join(os.path.dirname(__file__), os.pardir, "perfbench",
                       "configs", "granite-4.0-h-small-10l.json")) as f:
    SMALL = json.load(f)
SMALL.update(SMALL["published"])


def state_dict(cfg=TINY, seed=3):
    """Seeded weights at tiny widths: fan-in scaled projections and
    experts, a unit-normal embedding, Mamba2's A and dt init, D and the
    norms moved off 1 so that a dropped one shows."""
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


def load(model, sd):
    model.load_state_dict(dict(sd, **{"lm_head.weight": sd[
        "model.embed_tokens.weight"]}), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def models():
    sd = state_dict()
    reference = ref.Granite(TINY)
    reference.load_state_dict(sd, strict=True)
    port = load(granite.GraniteHybridLM(granite.config_from_granite_json(
        TINY)), sd)
    return port, reference, sd


def tokens(batch, length, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, TINY["vocab_size"], (batch, length),
                         generator=gen)


def gap(a, b):
    return float((a.float() - b.float()).abs().max())


def generated_gap(port, reference, prompt, new=6):
    """The widest gap between generate's scores (an eager prefill, then the
    decode graph over the Mamba-2 states and the K/V cache) and the
    reference's full forward over the prompt and the served tokens."""
    out, scores = lm.generate(port, lm.lm_params(port), prompt, new,
                              top_k=1, output_scores=True)
    with torch.no_grad():
        want = reference(out[:, :-1])[:, prompt.shape[1] - 1:]
    return gap(scores, want)


def transformers_model(cfg, sd):
    transformers = pytest.importorskip("transformers")
    hf = transformers.GraniteMoeHybridForCausalLM(
        transformers.GraniteMoeHybridConfig(
            **{k: v for k, v in cfg.items() if k != "model_type"},
            attn_implementation="eager"))
    return load(hf, sd)


def test_config_from_granite_json_takes_the_published_keys():
    cfg = granite.config_from_granite_json(SMALL, num_hidden_layers=10)
    assert cfg.layer_types == ("mamba",) * 5 + ("attention",) + (
        "mamba",) * 4
    assert (cfg.d_inner, cfg.conv_dim, cfg.mamba_n_heads, cfg.mamba_d_head,
            cfg.d_state, cfg.head_dim) == (8192, 8448, 128, 64, 128, 128)
    assert (cfg.num_local_experts, cfg.num_experts_per_tok,
            cfg.intermediate_size, cfg.shared_intermediate_size) == (
        72, 10, 768, 1536)
    assert (cfg.embedding_multiplier, cfg.residual_multiplier,
            cfg.logits_scaling, cfg.attention_multiplier) == (
        12, 0.22, 16, 1 / 128)
    assert cfg.tie_word_embeddings and cfg.rms_norm_eps == 1e-5
    whole = granite.config_from_granite_json(SMALL)
    assert [i for i, k in enumerate(whole.layer_types)
            if k == "attention"] == [5, 15, 25, 35]


@pytest.mark.parametrize("change", [
    {"position_embedding_type": "rope"}, {"hidden_act": "gelu"},
    {"layer_types": ["mamba", "mamba", "linear", "mamba"]},
    {"attention_bias": True},
    # 3 groups of 64 / 3 channels cut the heads of 8
    {"mamba_n_groups": 3}, {"mamba_n_groups": 16},
    # granite-4.0-h-micro's dense layers: the shared MLP alone
    {"num_local_experts": 0, "num_experts_per_tok": 0}])
def test_config_refuses_what_the_port_does_not_run(change):
    with pytest.raises(ValueError):
        granite.config_from_granite_json(dict(TINY, **change))


def test_a_d_state_past_the_kernels_is_refused_on_the_card():
    cfg = granite.config_from_granite_json(dict(TINY, mamba_d_state=512))
    with pytest.raises(ValueError, match="d_state 512"):
        lm.check_kernel_config(cfg, "cuda")
    lm.check_kernel_config(cfg, "cpu")


def test_state_dict_keys_are_transformers():
    hf = transformers_model(TINY, state_dict())
    port = granite.GraniteHybridLM(granite.config_from_granite_json(TINY))
    assert sorted(hf.state_dict()) == sorted(port.state_dict()) == sorted(
        list(ref.names(TINY)) + ["lm_head.weight"])
    # the port's dict loads into transformers' model strictly and back
    hf.load_state_dict(port.state_dict(), strict=True)
    port.load_state_dict(hf.state_dict(), strict=True)


@pytest.mark.parametrize("groups", [1, 2])
def test_reference_matches_transformers(groups):
    cfg = dict(TINY, mamba_n_groups=groups)
    sd = state_dict(cfg)
    hf = transformers_model(cfg, sd)
    reference = ref.Granite(cfg)
    reference.load_state_dict(sd, strict=True)
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
        assert gap(reference(x, positions=[3, 10]),
                   reference(x)[:, [3, 10]]) == 0.0


@pytest.mark.parametrize("prompt_len", [3, 9])   # 3: below d_conv
def test_generate_through_the_hybrid_cache_matches_reference(models,
                                                             prompt_len):
    port, reference, _ = models
    assert generated_gap(port, reference, tokens(2, prompt_len)) < ATOL
    assert isinstance(port._decoding_cache, lm.DecodeGraph)


@pytest.mark.parametrize("groups", [1, 2])
def test_prefill_then_decode_steps_match_full_forward(groups):
    """The functions under ``generate`` by hand, the states stepped
    eagerly in place: the Mamba-2 conv window over xBC (2 x 64 + 2 groups
    x 2 x 16 channels) and its (B, d_inner, N) state, the K/V cache."""
    cfg = dict(TINY, mamba_n_groups=groups)
    sd = state_dict(cfg)
    reference = ref.Granite(cfg)
    reference.load_state_dict(sd, strict=True)
    port = load(granite.GraniteHybridLM(granite.config_from_granite_json(
        cfg)), sd)
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
    window, ssm = states[0]
    assert window.shape == (2, 4, 64 + 2 * groups * 16)
    assert ssm.shape == (2, 64, 16) and ssm.dtype == torch.float32
    cache, pos = states[2]
    assert cache.shape == (2, 2, 2, 10, 8) and int(pos) == 9


@pytest.mark.parametrize("groups", [1, 2])
def test_k1_per_channel_mapping_matches_the_head_form(groups):
    """The scan the prefill runs (each head's dt, dt_bias, A and D repeated
    over its channels; B and C per group) against the reference's
    head-form recurrence, one exp a (step, head)."""
    gen = torch.Generator().manual_seed(7)
    b, L, heads, P, n = 2, 19, 6, 4, 8
    r = lambda *s: torch.randn(*s, generator=gen)
    x, dt, B, C = r(b, L, heads * P), r(b, L, heads), r(b, L, groups, n), \
        r(b, L, groups, n)
    A_log, D, dt_bias = torch.rand(heads, generator=gen) * 2, r(heads), \
        r(heads) * 0.5 - 2
    m = streaming.mamba2({"A_log": A_log, "D": D, "dt_bias": dt_bias,
                          "norm.weight": torch.ones(heads * P)}, groups, n,
                         1e-5)
    y, last = selective_scan(
        x, dt.repeat_interleave(P, -1), m.A, B if groups > 1 else B[:, :, 0],
        C if groups > 1 else C[:, :, 0], D=m.D, delta_bias=m.dt_bias,
        delta_softplus=True, return_last_state=True)
    for row in range(b):
        want, state = ref.ssd(
            x[row].reshape(L, heads, P),
            torch.nn.functional.softplus(dt[row] + dt_bias),
            -torch.exp(A_log), B[row], C[row], D, chunk=8)
        assert gap(y[row], want.reshape(L, -1)) < 1e-5
        assert gap(last[row], state.reshape(heads * P, n)) < 1e-5


def head_form_step(state, x, dt, A_log, B, C, D, z, dt_bias, P, groups):
    """One token of the Mamba-2 recurrence from its definition, float64:
    state (b, heads, P, N), B and C (b, groups, N)."""
    d = lambda t: t.double()
    dt = torch.nn.functional.softplus(d(dt) + d(dt_bias))        # (b, H)
    b, heads = dt.shape
    rep = heads // groups
    Bh = d(B).repeat_interleave(rep, 1)                          # (b, H, N)
    Ch = d(C).repeat_interleave(rep, 1)
    xh = d(x).reshape(b, heads, P)
    state = (torch.exp(dt * -torch.exp(d(A_log)))[..., None, None] * state
             + (dt[..., None] * xh)[..., None] * Bh[:, :, None])
    y = (state * Ch[:, :, None]).sum(-1) + d(D)[:, None] * xh
    return (y.reshape(b, -1) * torch.nn.functional.silu(d(z))), state


@pytest.mark.parametrize("groups", [1, 2])
def test_ssm_step_per_head_matches_the_head_form(groups):
    """``ssm_step`` given the head size reads dt, dt_bias, A_log and D per
    head and B, C per group: 4 steps against the head-form step."""
    gen = torch.Generator().manual_seed(9)
    b, heads, P, n = 3, 6, 4, 8
    r = lambda *s: torch.randn(*s, generator=gen)
    state = torch.zeros(b, heads * P, n)
    want_state = torch.zeros(b, heads, P, n, dtype=torch.float64)
    A_log, D, dt_bias = torch.rand(heads, generator=gen) * 2, r(heads), \
        r(heads) * 0.5 - 2
    for _ in range(4):
        x, dt, z = r(b, heads * P), r(b, heads), r(b, heads * P)
        B, C = r(b, groups * n), r(b, groups * n)
        got = mk.ssm_step(state, x, dt, A_log[:, None].expand(heads, n), B,
                          C, D, z, dt_bias, head_dim=P, n_groups=groups)
        want, want_state = head_form_step(
            want_state, x, dt, A_log, B.reshape(b, groups, n),
            C.reshape(b, groups, n), D, z, dt_bias, P, groups)
        assert gap(got, want) < 1e-5
        assert gap(state, want_state.reshape(b, heads * P, n)) < 1e-5


def per_token_moe(params, x, top_k):
    """The renormalised block token by token, from its definition: the top
    k router logits, a softmax over them, each chosen expert's SwiGLU, the
    shared expert's added."""
    silu = torch.nn.functional.silu
    glu = lambda w_in, w_out, row: w_out @ (
        silu(w_in[:w_in.shape[0] // 2] @ row)
        * (w_in[w_in.shape[0] // 2:] @ row))
    out = []
    for row in x:
        top, chosen = torch.topk(params["router.weight"] @ row, top_k)
        y = glu(params["shared.input_linear.weight"],
                params["shared.output_linear.weight"], row)
        for g, e in zip(torch.softmax(top, -1), chosen.tolist()):
            y = y + g * glu(params["input_linear.weight"][e],
                            params["output_linear.weight"][e], row)
        out.append(y)
    return torch.stack(out)


def test_renormalised_top10_and_shared_expert_match_a_per_token_loop():
    cfg = dict(TINY, num_local_experts=12, num_experts_per_tok=10)
    port = load(granite.GraniteHybridLM(granite.config_from_granite_json(
        cfg)), state_dict(cfg))
    ff = port.split_params(lm.lm_params(port)).layers[1].ff.args[0]
    assert sorted(ff) == ["input_linear.weight", "output_linear.weight",
                          "router.weight", "shared.input_linear.weight",
                          "shared.output_linear.weight"]
    x = torch.randn(13, 32, generator=torch.Generator().manual_seed(2))
    want = per_token_moe(ff, x, 10)
    assert gap(moe.dropless_moe(ff, x, 10, renormalize=True), want) < 1e-5
    assert gap(moe.dropless_moe_step(ff, x, 10, renormalize=True),
               want) < 1e-5


def test_generate_combines_once_per_layer_in_the_prefill_only(models,
                                                               monkeypatch):
    """Every layer's MoE block combines its routed rows through
    ``moe_combine`` once in a prefill; the decode steps never call it."""
    port, _, _ = models
    calls = []
    combine = moe.moe_combine
    monkeypatch.setattr(moe, "moe_combine",
                        lambda *a: calls.append(a[0].shape) or combine(*a))
    parts = port.split_params(lm.lm_params(port))
    x = tokens(2, 7)
    with torch.no_grad():
        _, states = lm.prefill(parts, x[:, :5], max_len=7)
        assert calls == [(2 * 5 * TINY["num_experts_per_tok"],
                          TINY["hidden_size"])] * TINY["num_hidden_layers"]
        for t in (5, 6):
            lm.decode_step(parts, x[:, t], states)
    assert len(calls) == TINY["num_hidden_layers"]


def test_generate_reads_the_chosen_experts_of_every_layer(models):
    port, _, _ = models
    read = int(moe.experts_read("cpu"))
    lm.generate(port, lm.lm_params(port), tokens(2, 5), 3, top_k=1)
    # each of the 3 steps reads 3 to 6 distinct experts of 8 (2 rows,
    # top-3) in each of 4 layers; the prefill counts none
    assert 3 * 4 * 3 <= int(moe.experts_read("cpu")) - read <= 3 * 4 * 6


def test_ssm_span_opens_once_per_mamba_layer_in_prefill_only(models,
                                                             monkeypatch):
    port, _, _ = models
    opened = []
    real = streaming.span
    monkeypatch.setattr(streaming, "span",
                        lambda name: opened.append(name) or real(name))
    parts = port.split_params(lm.lm_params(port))
    x = tokens(2, 7)
    with torch.no_grad():
        _, states = lm.prefill(parts, x, max_len=10)
        assert opened == ["lm.ssm"] * 3
        graph = lm.decode_graph(port, parts, lm.lm_params(port), states)
        step = graph.start(states)
        for t in range(3):
            step(x[:, t])
    assert opened == ["lm.ssm"] * 3


def wrong_head_a(m):
    """The prefill's channel c given A of head c % heads, not c //
    head_dim; the step's heads read their neighbours' A_log."""
    a = -torch.exp(m.params["A_log"].float()).repeat(m.head_dim)
    return dataclasses.replace(
        m, A=a[:, None].expand(-1, m.d_state).contiguous(),
        A_log_heads=m.A_log_heads.roll(1, 0))


def gate_after_norm(m, y, z):
    f = y.float()
    f = f * torch.rsqrt((f * f).mean(-1, keepdim=True) + m.norm_eps)
    if z is not None:
        f = f * torch.nn.functional.silu(z.float())
    return m.params["norm.weight"] * f.to(y.dtype)


@pytest.mark.parametrize("mutation", [
    "residual_multiplier", "embedding_multiplier", "logits_scaling",
    "attn_scale", "gates_not_renormalised", "no_shared_expert",
    "a_per_channel", "gate_after_norm"])
def test_mutations_fail_the_tolerance(models, monkeypatch, mutation):
    port, reference, _ = models
    x = tokens(2, 11)
    parts = port.split_params(lm.lm_params(port))
    with torch.no_grad():
        want = reference(x)
        assert gap(lm.forward_parts(parts, x), want) < ATOL
        if mutation in ("residual_multiplier", "embedding_multiplier",
                        "logits_scaling"):
            parts = dataclasses.replace(parts, **{mutation: 1.0})
        elif mutation == "attn_scale":   # 1/sqrt(head_dim)
            parts = dataclasses.replace(parts, attn_scale=None)
        elif mutation == "gates_not_renormalised":   # Jamba's rule
            monkeypatch.setattr(moe, "_route_renormalised", moe._route)
        elif mutation == "no_shared_expert":
            monkeypatch.setattr(moe, "_shared", lambda params, x: None)
        elif mutation == "a_per_channel":
            parts = dataclasses.replace(parts, layers=[
                dataclasses.replace(layer, mixer=wrong_head_a(layer.mixer))
                if layer.kind == "mamba2" else layer
                for layer in parts.layers])
        else:
            monkeypatch.setattr(streaming, "gated_norm", gate_after_norm)
        assert gap(lm.forward_parts(parts, x), want) > ATOL


def test_a_per_channel_mutation_also_fails_in_decode(models):
    """The step reads A_log per head: its heads given their neighbours' A
    fail over the decode of 8 tokens."""
    port, reference, _ = models
    x = tokens(2, 11, seed=4)
    parts = port.split_params(lm.lm_params(port))
    bad = dataclasses.replace(parts, layers=[
        dataclasses.replace(layer, mixer=wrong_head_a(layer.mixer))
        if layer.kind == "mamba2" else layer for layer in parts.layers])
    with torch.no_grad():
        _, states = lm.prefill(parts, x[:, :2], max_len=11)
        got = [lm.decode_step(bad, x[:, t], states)[0] for t in range(2, 10)]
        want = reference(x[:, :10])[:, 2:]
        assert gap(torch.stack(got, 1), want) > ATOL


def write_snapshot(path, weights_of=None, cfg=TINY):
    """A snapshot directory: ``config.json`` and, given, the weights (the
    tied head saved once) in two safetensors shards with their index."""
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


def test_load_granite_reads_a_snapshot_strictly(models, tmp_path):
    pytest.importorskip("safetensors")
    _, _, sd = models
    model, params = granite.load_granite(write_snapshot(tmp_path, sd),
                                         device="cpu")
    assert set(params) == set(sd)
    assert all(torch.equal(params[k], sd[k]) for k in sd)
    assert model.lm_head.weight is model.model.embed_tokens.weight
    # a cut to the first 2 layers leaves the rest of the files unread
    model, params = granite.load_granite(str(tmp_path), device="cpu",
                                         num_hidden_layers=2)
    assert model.cfg.layer_types == ("mamba", "mamba")
    assert "model.layers.2.self_attn.q_proj.weight" not in params


def test_load_granite_without_weights_draws_the_mamba2_init(tmp_path):
    path = write_snapshot(tmp_path)
    _, a = granite.load_granite(path, device="cpu", seed=5)
    _, b = granite.load_granite(path, device="cpu", seed=5)
    _, c = granite.load_granite(path, device="cpu", seed=6)
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = "model.layers.0.mamba.in_proj.weight"
    assert not torch.equal(a[w], c[w])
    pre = "model.layers.0.mamba."
    A = torch.exp(a[pre + "A_log"])
    dt = torch.nn.functional.softplus(a[pre + "dt_bias"])
    assert bool(((A >= 1) & (A <= 16)).all())
    assert bool(((dt >= 1e-3 - 1e-6) & (dt <= 0.1 + 1e-6)).all())
    assert torch.equal(a[pre + "D"], torch.ones(8))


def test_bench_generation_takes_a_granite_config_dir(tmp_path, capsys):
    from vivim_tpu_torch.cli import bench_generation

    out = bench_generation.main([
        "--hf_dir", write_snapshot(tmp_path), "--device", "cpu",
        "--promptlen", "5", "--genlen", "3", "--batch", "2",
        "--repeats", "1", "--n_layer", "3"])
    assert out.shape == (2, 8)
    line = json.loads(capsys.readouterr().out.splitlines()[0])
    assert line["gen_len"] == 3 and line["batch"] == 2
