"""The port's compiled serving execution (``utils/cuda_graphs.py``): the
device-side confusion matrix, ``GraphedCall``'s key, the LM's static-state
decode (``nn/lm.py::DecodeGraph``) and the serving forward of
``cli/infer.py::run_inference``, against the JAX package where it has the
same function.

On the CPU a ``GraphedCall`` runs its function eagerly on the same static
buffers the card's graph replays, so the CPU cases hold the buffers' logic;
the ``cuda`` cases hold a captured forward and a captured decode against
eager on the card and skip here.  They import no JAX, so on the card:

    python -m pytest --noconftest tests/test_torch_graphs.py -q -m cuda

The JAX side is imported inside the cases that compare with it.
Tolerances: the confusion matrix and the decode chain exactly; LM logits
and scores at tests/test_torch_lm.py's fp32 rtol 1e-3 / atol 1e-4, tokens
exactly; on the card the replayed logits within atol 1e-5 of eager's.
"""

import argparse
import logging

import numpy as np
import pytest
import torch

from vivim_tpu_torch.cli import infer
from vivim_tpu_torch.cli.common import build_model
from vivim_tpu_torch.kernels import selective_scan as ss
from vivim_tpu_torch.nn import lm as tlm
from vivim_tpu_torch.nn.layers import init_weights
from vivim_tpu_torch.nn.quant import quantize_lm_params
from vivim_tpu_torch.train.metrics import confusion_matrix
from vivim_tpu_torch.utils import cuda_graphs

torch.set_num_threads(1)

RTOL, ATOL = 1e-3, 1e-4


def _labels(shape, nc, seed):
    """Labels in [0, nc) with class nc - 2 absent and nc - 1 present."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, nc, shape)
    x[x == nc - 2] = nc - 1
    return x


@pytest.mark.parametrize("nc", [2, 3, 4])
def test_confusion_matrix_equals_jax_device_matrix(nc):
    """Exact and int64, rows ground truth and columns prediction; class
    nc - 2 absent from the ground truth, the label nc - 1 present in
    both."""
    import jax.numpy as jnp

    from vivim_tpu.train.loop import confusion_matrix_device

    targets = _labels((3, 7, 9), nc, seed=nc)
    preds = np.random.default_rng(10 + nc).integers(0, nc, (3, 7, 9))
    preds.flat[1] = nc - 1
    got = confusion_matrix(torch.from_numpy(preds),
                           torch.from_numpy(targets), nc)
    want = np.asarray(confusion_matrix_device(
        jnp.asarray(preds), jnp.asarray(targets), nc))
    assert got.dtype == torch.int64 and got.shape == (nc, nc)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[nc - 2] == 0).all() and got.sum() == preds.size
    assert got[nc - 1].sum() == (targets == nc - 1).sum()


def _mlp():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.BatchNorm1d(3))


def test_graphed_call_key_follows_shapes_dtypes_and_weights():
    """Same shapes and weights, same key; a new shape, dtype or weight
    tensor (a new dict, a model moved by ``.to()``), a new key;
    ``load_state_dict`` copies in place and keeps it."""
    model = _mlp()
    call = cuda_graphs.GraphedCall(model, model)
    x = torch.zeros(2, 4)
    key = call.key(x)
    assert call.key(torch.ones(2, 4)) == key
    assert call.key(torch.zeros(5, 4)) != key
    assert call.key(torch.zeros(2, 4, dtype=torch.float64)) != key
    model.load_state_dict(_mlp().state_dict())
    assert call.key(x) == key
    model.double()
    assert call.key(x) != key
    params = {"w": torch.zeros(3), "q": {"q": torch.zeros(2, dtype=torch.int8),
                                         "s": torch.ones(2)}}
    by_dict = cuda_graphs.GraphedCall(lambda t: t, params)
    other = dict(params, w=torch.zeros(3))
    assert (cuda_graphs.GraphedCall(lambda t: t, other).key(x)
            != by_dict.key(x))
    assert len(cuda_graphs.tensors_of(params)) == 3


def test_graphed_call_on_the_cpu_calls_its_function():
    seen = []
    call = cuda_graphs.GraphedCall(lambda t: seen.append(t) or t * 2)
    x = torch.arange(3.0)
    assert torch.equal(call(x), x * 2) and seen[0] is x
    assert not call.graphs


class _Replays:
    def __init__(self):
        self.n = 0

    def replay(self):
        self.n += 1


def test_graph_replays_add_the_launches_their_capture_counted():
    """A ``Graph`` copies its inputs in, replays, and adds what its capture
    counted to each counter at every replay (a launch counter equals the
    launches that run); the scan kernels' counters are registered."""
    counters = argparse.Namespace(K=5, J=1)
    static = torch.zeros(3)
    graph = cuda_graphs.Graph(_Replays(), (static,), static,
                              [((counters, "K"), 8)])
    r0 = cuda_graphs.REPLAYS
    for i in range(3):
        x = torch.full((3,), float(i))
        assert graph(x) is static and torch.equal(static, x)
    assert graph.graph.n == 3 and cuda_graphs.REPLAYS - r0 == 3
    assert (counters.K, counters.J) == (5 + 3 * 8, 1)
    for name in ("LAUNCHES", "TRAIN_LAUNCHES", "BWD_LAUNCHES"):
        assert (ss, name) in cuda_graphs._COUNTERS


def _lm(seed=0, **kw):
    cfg = tlm.MambaLMConfig(vocab_size=50, d_model=16, n_layer=2, **kw)
    return init_weights(tlm.MambaLM(cfg),
                        torch.Generator().manual_seed(seed)).eval()


def _variants(model):
    params = tlm.lm_params(model)
    return {"float32": params,
            "bfloat16": {k: v.to(torch.bfloat16) for k, v in params.items()},
            "int8": quantize_lm_params(params,
                                       activation_dtype=torch.bfloat16)}


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_decode_graph_steps_equal_plain_decode_steps(kind):
    """8 steps of the static-state decode from a prefill equal a chain of
    plain ``decode_step`` calls bit for bit: logits and every state; the
    prefill's states are read, not stepped (the chain steps its own copies
    in place)."""
    model = _lm(rms_norm=True, residual_in_fp32=True)
    params = _variants(model)[kind]
    parts = tlm.split_params(model, params)
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(0, 50, (2, 5)))
    with torch.no_grad():
        _, states = tlm.prefill(parts, prompt)
        flat = [t for s in states for t in s]
        before = [t.clone() for t in flat]
        step = tlm.decode_graph(model, parts, params, states).start(states)
        want_states = [tuple(t.clone() for t in s) for s in states]
        for t in rng.integers(0, 50, (8, 2)):
            tok = torch.from_numpy(t)
            got = step(tok).clone()
            want, want_states = tlm.decode_step(parts, tok, want_states)
            assert torch.equal(got, want)
    dg = model._decoding_cache
    for g, w in zip(dg.states, want_states):
        assert all(torch.equal(a, b) for a, b in zip(g, w))
    for b, s in zip(before, flat):
        assert torch.equal(b, s)


def test_generate_keeps_one_decode_graph_per_key(caplog):
    """The same parameters reuse the model's graph (a new dict of the same
    tensors too); another dtype or batch replaces it; the mixer hooks run
    the eager loop with one log line and leave it alone."""
    model = _lm()
    kinds = _variants(model)
    prompt = torch.ones(1, 4, dtype=torch.long)
    gen = lambda p, x=prompt, **kw: tlm.generate(model, p, x, 3,
                                                 temperature=0.0, **kw)
    first = gen(kinds["float32"])
    dg = model._decoding_cache
    gen(tlm.lm_params(model))
    assert model._decoding_cache is dg
    gen(kinds["bfloat16"])
    assert model._decoding_cache is not dg
    dg = model._decoding_cache
    gen(kinds["bfloat16"], torch.ones(2, 4, dtype=torch.long))
    assert model._decoding_cache is not dg
    dg = model._decoding_cache
    from vivim_tpu_torch.nn import streaming

    with caplog.at_level(logging.INFO, logger=tlm.__name__):
        hooked = gen(kinds["float32"], mixer_step=streaming.mamba_step)
    assert torch.equal(hooked, first)
    assert model._decoding_cache is dg
    assert sum("eager decode loop" in r.message for r in caplog.records) == 1


@pytest.fixture(scope="module")
def pair():
    from tests.torch_lm_helpers import make_pair

    return make_pair(seed=0, rms_norm=True, residual_in_fp32=True)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL)


def _tokens(shape, seed):
    from tests.torch_lm_helpers import tokens

    return tokens(shape, seed=seed)


def test_generate_greedy_through_the_decode_graph_matches_jax(pair):
    import jax.numpy as jnp

    from vivim_tpu.nn import lm as jlm

    jmodel, params, tmodel = pair
    prompt = _tokens((2, 5), seed=21)
    want, want_scores = jlm.generate(
        jmodel, {"params": params}, jnp.asarray(prompt), 7, temperature=0.0,
        output_scores=True)
    tmodel._decoding_cache = None
    got, scores = tlm.generate(tmodel, tlm.lm_params(tmodel),
                               torch.from_numpy(prompt).long(), 7,
                               temperature=0.0, output_scores=True)
    assert isinstance(tmodel._decoding_cache, tlm.DecodeGraph)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _close(scores, want_scores)


def test_teacher_forcing_and_scores_through_the_decode_graph_match_jax(pair):
    """The teacher covers the prompt and 3 of 6 new positions; every score
    is its own step's logits (no later step overwrote a kept one)."""
    import jax.numpy as jnp

    from vivim_tpu.nn import lm as jlm

    jmodel, params, tmodel = pair
    prompt = _tokens((1, 4), seed=22)
    teacher = np.concatenate([prompt, _tokens((1, 3), seed=23)], 1)
    want, want_scores = jlm.generate(
        jmodel, {"params": params}, jnp.asarray(prompt), 6, temperature=0.0,
        teacher_outputs=jnp.asarray(teacher), output_scores=True)
    got, scores = tlm.generate(
        tmodel, tlm.lm_params(tmodel), torch.from_numpy(prompt).long(), 6,
        temperature=0.0, teacher_outputs=torch.from_numpy(teacher),
        output_scores=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[:, 4:7].numpy(), teacher[:, 4:7])
    _close(scores, want_scores)
    assert not torch.equal(scores[:, -1], scores[:, -2])


def test_eos_through_the_decode_graph_matches_jax(pair):
    import jax.numpy as jnp

    from vivim_tpu.nn import lm as jlm

    jmodel, params, tmodel = pair
    prompt = _tokens((2, 4), seed=24)
    free = jlm.generate(jmodel, {"params": params}, jnp.asarray(prompt), 6,
                        temperature=0.0)
    eos = int(free[1, 5])
    want = jlm.generate(jmodel, {"params": params}, jnp.asarray(prompt), 6,
                        temperature=0.0, eos_token_id=eos)
    got = tlm.generate(tmodel, tlm.lm_params(tmodel),
                       torch.from_numpy(prompt).long(), 6, temperature=0.0,
                       eos_token_id=eos)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    row = got[1, 4:].tolist()
    assert set(row[row.index(eos):]) == {eos}


class _Batches:
    def __init__(self, batches, batch_size):
        self.batches, self.batch_size = batches, batch_size

    def __iter__(self):
        return iter(self.batches)


def _clips(sizes, T=3, S=32, C=3, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for b in sizes:
        labels = rng.integers(0, C, (b, T, S, S))
        out.append({
            "clip": rng.standard_normal((b, T, S, S, 3)).astype(np.float32),
            "masks": np.eye(C, dtype=np.float32)[labels]})
    return out


def _infer_args(tmp_path):
    return argparse.Namespace(segformer="tiny", num_classes=3,
                              with_edge=False, clip_length=3, image_size=32,
                              output_dir=str(tmp_path), save_vis=False,
                              vis_count=0)


def test_run_inference_with_a_smaller_last_batch_counts_as_jax(tmp_path):
    """Batches of 2, 2 and 1 clips: the confusion matrix and every frame
    count equal the JAX CLI's ``run_inference`` on the same clips and
    weights."""
    from vivim_tpu.cli import infer as jinfer
    from vivim_tpu.convert.torch_to_jax import vivim_params_from_torch
    from vivim_tpu.nn.vivim import Vivim as JVivim
    from vivim_tpu.nn.vivim import VivimConfig as JConfig

    args = _infer_args(tmp_path)
    model, _ = build_model(args, device="cpu", seed=3)
    loader = _Batches(_clips((2, 2, 1)), 2)
    res, cm, perf = infer.run_inference(args, model, loader, device="cpu")
    variables = vivim_params_from_torch(
        {k: v.numpy() for k, v in model.state_dict().items()},
        JConfig.tiny_test(scan_implementation=None))
    jres, jcm, jperf = jinfer.run_inference(
        args, JVivim(JConfig.tiny_test(scan_implementation=None)), variables,
        loader)
    np.testing.assert_array_equal(cm, jcm)
    assert cm.sum() == 5 * 3 * 32 * 32
    assert perf["total_frames"] == jperf["total_frames"] == 15
    assert res["class_counts"] == jres["class_counts"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_captured_forward_matches_eager_on_the_card(cuda, tmp_path):
    """The serving forward replayed per batch shape (2 and 1 clips): its
    logits within atol 1e-5 of the eager module's, its predictions and
    counts equal to eager's; K1 counts what runs (the warm-ups and every
    replay, not the capture), and ``run_inference`` counts what eager
    counts."""
    args = _infer_args(tmp_path)
    model, cfg = build_model(args, device=cuda, seed=3)
    model.eval()
    batches = _clips((2, 2, 1))
    per_fwd = sum(cfg.depths)
    first = per_fwd * (cuda_graphs.WARMUP_CALLS + 1)   # warm-ups + replay
    launched = []
    with torch.inference_mode():
        logits = cuda_graphs.GraphedCall(model, model)
        eager_fwd = infer.serving_forward(model, 3)
        graphed = cuda_graphs.GraphedCall(eager_fwd, model)
        c0 = cuda_graphs.CAPTURES
        cm = torch.zeros(3, 3, dtype=torch.long, device=cuda)
        for b in batches:
            clip = torch.from_numpy(b["clip"]).to(cuda)
            masks = torch.from_numpy(b["masks"]).to(cuda)
            want = eager_fwd(clip, masks)
            k0 = ss.LAUNCHES
            got = graphed(clip, masks)
            launched.append(ss.LAUNCHES - k0)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
            cm += got[2]
            torch.testing.assert_close(logits(clip), model(clip), rtol=0,
                                       atol=1e-5)
        assert cuda_graphs.CAPTURES - c0 == 4
    assert launched == [first, per_fwd, first]
    loader = _Batches(batches, 2)
    _, got_cm, _ = infer.run_inference(args, model, loader, device=cuda)
    np.testing.assert_array_equal(got_cm, cm.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_captured_decode_matches_eager_on_the_card(cuda, kind):
    """8 replayed decode steps against the eager chain (fp32 within 1e-5;
    bf16 and int8 within their dtype's step), and ``generate`` through the
    graph giving the eager loop's greedy tokens and scores (each kept
    score a copy: the next replay overwrites the graph's logits)."""
    from vivim_tpu_torch.nn import streaming

    model = _lm(rms_norm=True, residual_in_fp32=True).to(cuda)
    params = _variants(model)[kind]
    parts = tlm.split_params(model, params)
    prompt = torch.ones(2, 5, dtype=torch.long, device=cuda)
    atol = 1e-5 if kind == "float32" else 5e-2
    with torch.no_grad():
        _, states = tlm.prefill(parts, prompt)
        r0 = cuda_graphs.REPLAYS
        step = tlm.decode_graph(model, parts, params, states).start(states)
        want_states = states
        for t in range(8):
            tok = torch.full((2,), t + 3, dtype=torch.long, device=cuda)
            got = step(tok)
            want, want_states = tlm.decode_step(parts, tok, want_states)
            torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                       atol=atol)
        assert cuda_graphs.REPLAYS - r0 == 8
        eager, eager_scores = tlm.generate(
            model, params, prompt, 16, temperature=0.0, output_scores=True,
            mixer_step=streaming.mamba_step)
        k0 = ss.LAUNCHES
        graphed, scores = tlm.generate(model, params, prompt, 16,
                                       temperature=0.0, output_scores=True)
    assert ss.LAUNCHES - k0 == model.cfg.n_layer
    assert torch.equal(graphed, eager)
    torch.testing.assert_close(scores.float(), eager_scores.float(), rtol=0,
                               atol=atol)
