"""The replayed train step's parts on the CPU (``train/loop.py``).

A CUDA graph captures only on the card, so these hold what surrounds it:
AdamW's step count on the device against the Python schedule, the rule
that sends a step through the captured path or runs it eagerly, and the
captured path's bookkeeping (eager warm-ups, the capture, replays, the
outputs kept per step, the generator and the counts) with
``cuda_graphs.capture`` replaced by a stand-in that reruns the captured
call on its static buffers at each replay, as a graph replays its
kernels.  ``chip_smoke.py`` holds the real capture against eager steps on
the card.  No JAX.
"""

import dataclasses
import math
import types

import numpy as np
import pytest
import torch

from vivim_tpu_torch.nn.layers import init_weights
from vivim_tpu_torch.nn.vivim import Vivim, VivimConfig
from vivim_tpu_torch.parallel.mesh import Mesh
from vivim_tpu_torch.train import loop
from vivim_tpu_torch.utils import cuda_graphs

torch.set_num_threads(1)

TOTAL = 7


def _ulps(got, want):
    """|got - want| in float32 ulps of ``want``."""
    want = np.float32(want)
    return abs(float(np.float32(got)) - float(want)) / float(np.spacing(want))


def _opt(total=TOTAL):
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))
    return model, loop.AdamW(model, 1e-3, 0.01, total)


def test_device_schedule_matches_the_python_one():
    """The learning rate and both bias corrections from the device's count
    are the Python doubles' float32 roundings within one ulp, at every
    step from 0 to past the schedule's end, and after ``load_state_dict``
    moves the count."""
    _, opt = _opt()
    b1, b2 = opt.b1, opt.b2

    def check(k):
        lr, c1, c2 = opt._device_scalars()
        assert _ulps(lr, loop.cosine_lr(1e-3, TOTAL, 0.01, k)) <= 1
        assert _ulps(c1, 1.0 - b1 ** (k + 1)) <= 1
        assert _ulps(c2, math.sqrt(1.0 - b2 ** (k + 1))) <= 1
        assert all(t.dtype == torch.float32 for t in (lr, c1, c2))
        opt.replayed()
        assert opt.count == k + 1 and float(opt.device_count()) == k + 1

    for k in range(TOTAL + 3):
        check(k)
    opt.load_state_dict({"count": 3, "mu": opt.mu, "nu": opt.nu})
    assert float(opt._count_t) == 3
    check(3)
    opt.count = 5   # an eager step's count: the device's follows it
    check(5)


def _grads(model, seed):
    g = torch.Generator().manual_seed(seed)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=g)


def test_device_update_matches_the_eager_update():
    """The same gradients through ``step()`` and ``step(on_device=True)``
    over the schedule and past it: equal norms and moments, parameters
    within float32 rounding of the last product."""
    (m_e, o_e), (m_d, o_d) = _opt(), _opt()
    m_d.load_state_dict(m_e.state_dict())
    for k in range(TOTAL + 3):
        _grads(m_e, k)
        _grads(m_d, k)
        n_e = o_e.step()
        n_d = o_d.step(on_device=True)
        o_d.replayed()
        assert torch.equal(n_e, n_d) and o_e.count == o_d.count == k + 1
        for a, b in zip(o_e.mu + o_e.nu, o_d.mu + o_d.nu):
            assert torch.equal(a, b)
        for a, b in zip(m_e.parameters(), m_d.parameters()):
            torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-9)


# --- the rule and the captured path


def _model(seed=0, **kw):
    return init_weights(Vivim(VivimConfig.micro_test(scan_implementation=None,
                                                     **kw)),
                        torch.Generator().manual_seed(seed))


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"clip": torch.from_numpy(rng.standard_normal(
                (1, 2, 32, 32, 3)).astype(np.float32)),
            "masks": torch.eye(3)[torch.from_numpy(
                rng.integers(0, 3, (1, 2, 32, 32)))]}


CARD_BATCH = {"clip": types.SimpleNamespace(is_cuda=True)}


@pytest.mark.parametrize("case", ["plain", "cpu", "data2", "seq2", "zero",
                                  "remat_pre_scan", "remat_blocks",
                                  "remat_layers"])
def test_the_rule_sends_only_one_card_steps_to_the_graph(case):
    """One rank, no ZeRO, no remat, a CUDA batch: replayed; the CPU, a
    mesh of two ranks (data or seq), a ZeRO state and each remat flag run
    eagerly."""
    kw = {"remat_pre_scan": case == "remat_pre_scan",
          "remat_blocks": case == "remat_blocks"}
    cfg = VivimConfig.micro_test(scan_implementation=None, **kw)
    if case == "remat_layers":
        cfg = dataclasses.replace(cfg, segformer=dataclasses.replace(
            cfg.segformer, remat_layers=True))
    model = Vivim(cfg)
    axis = {"data2": "data", "seq2": "seq"}.get(case)
    mesh = (Mesh({"data": 1, axis: 2}, {"data": 0, axis: 0},
                 {"data": None, axis: None}) if axis else None)
    state = loop.create_train_state(model, 1e-4, 0.01, 10, seed=1)
    if case == "zero":
        state.zero = object()
    step = loop.make_train_step(model, mesh=mesh)
    batch = _batch(0) if case == "cpu" else CARD_BATCH
    assert step.replays(state, batch) == (case == "plain")
    assert (step.graphs is None) == (case not in ("plain", "cpu", "zero"))


class _Replayed:
    """A stand-in for a captured ``Graph``: each call copies the inputs
    into the static buffers and reruns the captured call on them, writing
    its results into the first call's outputs, which it returns (a graph's
    static outputs)."""

    def __init__(self, fn, static, generators):
        self.fn, self.inputs, self.generators = fn, static, generators
        self.outputs = None

    def __call__(self, *inputs):
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(x)
        out = self.fn(*self.inputs)
        if self.outputs is None:
            self.outputs = out
        else:
            for o, x in zip(self.outputs, out):
                o.copy_(x)
        return self.outputs


@pytest.fixture
def captured(monkeypatch):
    made = []

    def capture(fn, static, pool=None, warmup=cuda_graphs.WARMUP_CALLS,
                generators=()):
        made.append(_Replayed(fn, static, generators))
        return made[-1]
    monkeypatch.setattr(cuda_graphs, "capture", capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    return made


def _pair(n):
    """(state, step) twice from the same weights and generator seed."""
    out = []
    for _ in range(2):
        model = _model()
        out.append((loop.create_train_state(model, 1e-4, 0.01, n, seed=1),
                    loop.make_train_step(model, "recall_focused", 3)))
    return out


def _replay_steps(state, step, batches):
    """``step``'s captured path on ``batches``, counted as ``step`` counts
    them (``step.graphs`` in place of the CUDA batch the CPU lacks)."""
    out = []
    for b in batches:
        loss, jacc, norm = step.graphs(state, b)
        state.step += 1
        out.append({"loss": loss, "jaccard": jacc, "grad_norm": norm})
    return out


def test_captured_path_steps_as_eager_steps_do(captured):
    """5 steps through the captured path (2 eager, the capture and its
    replay, 2 more replays) against 5 eager steps from the same start,
    dropout on: equal losses, Jaccard, norms and generator states, the
    same counts, parameters and moments within float32 rounding of AdamW's
    last product; each step's metrics keep their values after the later
    steps overwrite the static outputs."""
    n = 5
    (s_e, step_e), (s_r, step_r) = _pair(n)
    batches = [_batch(10 + i) for i in range(n)]
    replayed = loop.REPLAYED_STEPS
    got = _replay_steps(s_r, step_r, batches)
    assert loop.REPLAYED_STEPS - replayed == n - cuda_graphs.WARMUP_CALLS
    assert len(captured) == 1 and captured[0].generators == (s_r.generator,)
    assert got[-1]["loss"] is not captured[0].outputs[0]
    steps = loop.STEPS
    want = []
    for b in batches:
        s_e, m = step_e(s_e, b)
        want.append(m)
    assert loop.STEPS - steps == n
    for g, w in zip(got, want):
        for k in ("loss", "jaccard", "grad_norm"):
            torch.testing.assert_close(g[k], w[k], rtol=1e-6, atol=0, msg=k)
    assert s_r.step == s_e.step == s_r.opt.count == s_e.opt.count == n
    assert float(s_r.opt.device_count()) == n
    assert torch.equal(s_r.generator.get_state(), s_e.generator.get_state())
    for a, b in zip(s_r.opt.params + s_r.opt.mu + s_r.opt.nu,
                    s_e.opt.params + s_e.opt.mu + s_e.opt.nu):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-8)


def test_a_new_state_captures_anew(captured):
    """Another state (a new run, or a resumed one in a new Trainer) drops
    the captured steps and warms up again; a new batch shape captures its
    own graph."""
    (s1, step), _ = _pair(8)
    s2 = loop.create_train_state(s1.model, 1e-4, 0.01, 8, seed=2)
    b = _batch(0)
    _replay_steps(s1, step, [b] * 3)
    assert len(captured) == 1
    _replay_steps(s2, step, [b] * 2)
    assert len(captured) == 1 and len(step.graphs.graphs) == 1
    _replay_steps(s2, step, [b])
    assert len(captured) == 2
    small = {k: v[:, :1] for k, v in b.items()}
    _replay_steps(s2, step, [small] * 3)
    assert len(captured) == 3 and len(step.graphs.graphs) == 2


def test_a_count_moved_on_the_host_reaches_the_replays(captured):
    """``load_state_dict`` (a checkpoint's restore) and eager steps of
    another shape move ``opt.count`` alone; the next replay's schedule
    starts from it."""
    (s, step), _ = _pair(8)
    b = _batch(0)
    _replay_steps(s, step, [b] * 3)
    s.opt.load_state_dict({"count": 6, "mu": s.opt.mu, "nu": s.opt.nu})
    assert float(s.opt._count_t) == 6
    _replay_steps(s, step, [b])
    assert s.opt.count == 7 and float(s.opt.device_count()) == 7
    small = {k: v[:, :1] for k, v in b.items()}
    _replay_steps(s, step, [small])   # eager: the host's count alone
    assert s.opt.count == 8 and s.opt._count_t_at == 7
    _replay_steps(s, step, [b])
    assert s.opt.count == 9 and float(s.opt.device_count()) == 9
