"""The port's spans and capture counter (``utils/profiling.py::span``,
``utils/cuda_graphs.py::CAPTURE_S``) and the benchmark's readers of them
(``perfbench/spans.py``, ``perfbench/metrics/``).

On the CPU: no span enters ``record_function`` without a profiler; under
the benchmark's profiler each path's spans land in the profile, one unit
span per step or request with its phases nested in it; the readers on
hand-made profiles.  The ``cuda`` case holds ``CAPTURE_S`` on the card and
skips here.  No JAX, so on the card:

    python -m pytest --noconftest tests/test_torch_spans.py -q -m cuda
"""

import argparse
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

from perfbench import harness, spans, tiny, trace
from vivim_tpu_torch.cli import infer
from vivim_tpu_torch.cli.common import build_model
from vivim_tpu_torch.cli.lm_eval_harness import MambaEvalCore
from vivim_tpu_torch.nn import lm as tlm
from vivim_tpu_torch.nn.layers import init_weights
from vivim_tpu_torch.nn.vivim import Vivim, VivimConfig
from vivim_tpu_torch.train import loop
from vivim_tpu_torch.utils import cuda_graphs, profiling

torch.set_num_threads(1)

METRICS = os.path.join(harness.HERE, "metrics")


def metric(name):
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), os.path.join(METRICS,
                                                         name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# --- the program's paths at tiny sizes: (run(n units), unit span, phases)


def _train(n):
    model = init_weights(Vivim(VivimConfig.micro_test(scan_implementation=None)),
                         torch.Generator().manual_seed(0))
    state = loop.create_train_state(model, 1e-4, 0.01, 10, seed=1)
    step = loop.make_train_step(model, "recall_focused", 3)
    rng = np.random.default_rng(0)
    batch = {"clip": torch.from_numpy(rng.standard_normal(
                 (1, 2, 32, 32, 3)).astype(np.float32)),
             "masks": torch.eye(3)[torch.from_numpy(
                 rng.integers(0, 3, (1, 2, 32, 32)))]}

    def run():
        nonlocal state
        for _ in range(n):
            state, _ = step(state, batch)
    return run


class _Batches:
    batch_size = 1

    def __init__(self, n):
        rng = np.random.default_rng(0)
        self.batches = [{
            "clip": rng.standard_normal((1, 2, 32, 32, 3)).astype(np.float32),
            "masks": np.eye(3, dtype=np.float32)[
                rng.integers(0, 3, (1, 2, 32, 32))]} for _ in range(n)]

    def __iter__(self):
        return iter(self.batches)


def _serve(n, tmp_path):
    args = argparse.Namespace(segformer="tiny", num_classes=3,
                              with_edge=False, clip_length=2, image_size=32,
                              output_dir=str(tmp_path), save_vis=False,
                              vis_count=0)
    model, _ = build_model(args, device="cpu", seed=3)
    loader = _Batches(n)
    return lambda: infer.run_inference(args, model, loader, device="cpu")


def _lm():
    cfg = tlm.MambaLMConfig(vocab_size=50, d_model=16, n_layer=2)
    model = init_weights(tlm.MambaLM(cfg),
                         torch.Generator().manual_seed(0)).eval()
    return model, tlm.lm_params(model)


NEW_TOKENS = 3


def _generate(n):
    model, params = _lm()
    prompt = torch.arange(1, 6)[None]

    def run():
        for _ in range(n):
            tlm.generate(model, params, prompt, NEW_TOKENS,
                         output_scores=True)
    return run


class _Tokenizer:
    def encode(self, text):
        return [int(t) for t in text.split()]

    def decode(self, ids):
        return " ".join(map(str, ids))


def _score(n):
    model, params = _lm()
    core = MambaEvalCore(model, params, _Tokenizer(), eot_token_id=0)

    def run():
        for i in range(n):
            core.loglikelihood_rolling_str(" ".join(str(1 + (i + k) % 40)
                                                    for k in range(12)))
    return run


PATHS = {
    "train": (lambda n, tmp: _train(n), "train.step",
              {"train.forward", "train.backward", "train.optimizer",
               "dwconv3d"}),
    "serve": (_serve, "serve.request", {"serve.copy_in", "serve.readback"}),
    "generate": (lambda n, tmp: _generate(n), "lm.generate",
                 {"lm.forward", "lm.draw", "graph.key"}),
    "score": (lambda n, tmp: _score(n), "lm.score", {"lm.forward"}),
}


def test_span_enters_record_function_only_while_a_profiler_records():
    """The flag ``span`` reads is the one the profiler sets: off, the
    shared no-op; on, a ``record_function`` range."""
    assert not autograd_profiler._is_profiler_enabled
    assert profiling.span("a") is profiling.span("b") is profiling._NO_SPAN
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled
        assert isinstance(profiling.span("a"), record_function)
    assert profiling.span("a") is profiling._NO_SPAN


@pytest.mark.parametrize("path", sorted(PATHS))
def test_no_span_enters_record_function_without_a_profiler(
        path, tmp_path, monkeypatch):
    """A train step, ``run_inference`` over 2 requests, ``generate`` and
    ``_score``, each twice, with ``record_function``'s enter made to
    raise."""
    run = PATHS[path][0](2, tmp_path)

    def refuse(self):
        raise AssertionError(f"record_function({self.name!r}) entered")
    monkeypatch.setattr(record_function, "__enter__", refuse)
    run()


@pytest.mark.parametrize("path", sorted(PATHS))
def test_spans_nest_in_one_unit_span_per_unit(path, tmp_path):
    """Under the benchmark's profiler: every span inside the window, one
    unit span per step or request, each phase inside a unit span."""
    make, unit, phases = PATHS[path]
    run = make(2, tmp_path)
    p = trace.profile(run, lambda: None, False)
    units = spans.intervals(p, unit)
    assert len(units) == 2
    names = {n for n, _, _ in p.host}
    assert phases <= names, phases - names
    for name in phases | {unit}:
        for s, e in spans.intervals(p, name):
            assert 0.0 <= s <= e <= p.t1
            assert any(us <= s and e <= ue for us, ue in units), name
    if path == "generate":
        assert len(spans.intervals(p, "lm.draw")) == 2 * NEW_TOKENS


def _profile(host, units=2):
    return trace.Profile(0.0, 1.0, [], host, units=units)


def _run(profile):
    return argparse.Namespace(profile=profile)


def test_host_ms_sums_a_span_per_unit():
    p = _profile([("graph.key", 0.1, 0.102), ("graph.replay", 0.2, 0.201),
                  ("graph.key", 0.3, 0.304), ("aten::mm", 0.1, 0.5)],
                 units=2)
    assert spans.host_ms(_run(p), "graph.key") == pytest.approx(3.0)
    assert spans.host_ms(_run(p), "graph.replay") == pytest.approx(0.5)
    assert metric("serve.graph_key_ms")(_run(p)) == pytest.approx(3.0)


def test_launches_count_by_containment_on_any_thread():
    """A launch counts in the span its call starts in: the backward's
    launches come from autograd's thread, outside any op of the main
    thread's; a graph's replay counts once; copies are no launches."""
    p = _profile([
        ("train.step", 0.0, 0.9),
        ("train.forward", 0.0, 0.3),
        ("aten::mm", 0.01, 0.02), ("cudaLaunchKernel", 0.011, 0.012),
        ("cuLaunchKernel", 0.1, 0.101),
        ("cudaMemcpyAsync", 0.2, 0.21),
        ("train.backward", 0.3, 0.6),
        ("autograd::engine::evaluate_function: MmBackward0", 0.4, 0.5),
        ("cudaLaunchKernelExC_v11060", 0.35, 0.351),   # autograd's thread
        ("cudaLaunchKernel", 0.45, 0.451),
        ("train.optimizer", 0.6, 0.8),
        ("cudaGraphLaunch", 0.7, 0.75),
        ("cudaLaunchKernel", 0.85, 0.86),   # in the step, in no phase
    ], units=1)
    read = lambda name: metric(name)(_run(p))
    assert read("train.forward_launches") == 2
    assert read("train.backward_launches") == 2
    assert read("train.optimizer_launches") == 1
    assert spans.launches(_run(p), "train.step") == 6
    assert read("train.step_launches") == 6
    two = _profile(p.host + [("train.step", 1.0, 1.5),
                             ("train.backward", 1.0, 1.5),
                             ("cudaLaunchKernel", 1.2, 1.3)], units=2)
    assert metric("train.backward_launches")(_run(two)) == 1.5


def test_a_replayed_step_counts_its_graph_launch_once():
    """A replayed train step: the generators' seed and offset fills and
    one graph launch in ``train.step``; its phases' spans never open, so
    their readers give None."""
    p = _profile([
        ("train.step", 0.0, 0.5),
        ("cudaMemcpyAsync", 0.01, 0.02),   # the static inputs
        ("graph.replay", 0.03, 0.4),
        *[("cudaLaunchKernel", 0.05 + 0.01 * i, 0.055 + 0.01 * i)
          for i in range(4)],
        ("cudaGraphLaunch", 0.1, 0.3),
        ("cudaMemcpyAsync", 0.41, 0.42),   # the outputs' clones
    ], units=1)
    assert metric("train.step_launches")(_run(p)) == 5
    for name in ("train.forward_launches", "train.backward_launches",
                 "train.optimizer_launches"):
        assert metric(name)(_run(p)) is None


def test_replayed_share_reads_the_step_counters(monkeypatch):
    read = metric("train.replayed_share")
    monkeypatch.setattr(loop, "STEPS", 0)
    monkeypatch.setattr(loop, "REPLAYED_STEPS", 0)
    assert read(None) is None
    monkeypatch.setattr(loop, "STEPS", 200)
    monkeypatch.setattr(loop, "REPLAYED_STEPS", 198)
    assert read(None) == pytest.approx(99.0)
    monkeypatch.delattr(loop, "REPLAYED_STEPS")
    assert read(None) is None
    monkeypatch.delitem(sys.modules, loop.__name__)
    assert read(None) is None


NEW_SPAN_METRICS = [
    "train.forward_launches", "train.backward_launches",
    "train.optimizer_launches", "serve.graph_key_ms", "lm.forward_launches",
    "train.step_launches"]


@pytest.mark.parametrize("name", NEW_SPAN_METRICS)
def test_span_metrics_read_none_without_their_span(name):
    """A program that opens no span (the parent of the spans, or no
    profile) gives no reading, never 0."""
    read = metric(name)
    plain = _profile([("aten::mm", 0.1, 0.2), ("cudaLaunchKernel", 0.1,
                                                0.11)], units=2)
    assert read(_run(plain)) is None
    assert read(_run(None)) is None


def test_capture_s_reads_the_counter_only_after_a_capture(monkeypatch):
    read = metric("setup.capture_s")
    monkeypatch.setattr(cuda_graphs, "CAPTURES", 0)
    monkeypatch.setattr(cuda_graphs, "CAPTURE_S", 0.0)
    assert read(None) is None
    monkeypatch.setattr(cuda_graphs, "CAPTURES", 2)
    monkeypatch.setattr(cuda_graphs, "CAPTURE_S", 1.25)
    assert read(None) == 1.25
    monkeypatch.delattr(cuda_graphs, "CAPTURE_S")
    assert read(None) is None


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["vivim-tiny.serve", "mamba-tiny.generate",
                                  "mamba-tiny.score"])
def test_a_traced_tiny_run_leaves_out_what_only_the_card_has(tiny_root, cell):
    """The harness's traced run of a tiny cell on the CPU: correct, and the
    span metrics, which read launches, replays' keys and captures, absent
    (their readers give None, as on a program without the spans)."""
    path, here, bench = tiny_root
    result, _ = tiny.run(path, here, bench, cell, trace=True)
    assert result["correct"], result["checks"]
    assert not set(result["metrics"]) & set(NEW_SPAN_METRICS
                                            + ["setup.capture_s"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_capture_s_grows_on_capture_only(cuda):
    """A ``GraphedCall``'s first call of a key captures and adds its
    seconds; its replays add none; a new shape captures again."""
    lin = torch.nn.Linear(8, 8).to(cuda)
    call = cuda_graphs.GraphedCall(lambda x: (lin(x),), lin)
    n0, s0 = cuda_graphs.CAPTURES, cuda_graphs.CAPTURE_S
    call(torch.ones(2, 8, device=cuda))
    s1 = cuda_graphs.CAPTURE_S
    assert cuda_graphs.CAPTURES == n0 + 1 and s1 > s0
    for _ in range(3):
        call(torch.ones(2, 8, device=cuda))
    assert cuda_graphs.CAPTURE_S == s1
    call(torch.ones(3, 8, device=cuda))
    assert cuda_graphs.CAPTURES == n0 + 2 and cuda_graphs.CAPTURE_S > s1
