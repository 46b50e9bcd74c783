"""The replayed train step's parts on the CPU (``train/loop.py``).

A CUDA graph captures only on the card, so these hold what surrounds it:
AdamW's step count on the device against the Python schedule, AdamW
against the JAX package's optimizer, the rule that sends a step through
the captured path or runs it eagerly, and the captured path's
bookkeeping (eager warm-ups, the capture, replays, the outputs kept per
step, the generator and the count, restored or moved by eager steps)
with ``cuda_graphs.capture`` replaced by a stand-in that reruns the
captured call on its static buffers at each replay, as a graph replays
its kernels.  ``chip_smoke.py`` holds the real capture against eager
steps on the card.
"""

import dataclasses
import math
import types

import jax
import numpy as np
import optax
import pytest
import torch

from vivim_tpu.train import loop as jloop
from vivim_tpu_torch.nn.layers import init_weights
from vivim_tpu_torch.nn.vivim import Vivim, VivimConfig
from vivim_tpu_torch.parallel.mesh import Mesh
from vivim_tpu_torch.train import loop
from vivim_tpu_torch.train.checkpoints import CheckpointManager
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


def _grads(model, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    for p in model.parameters():
        p.grad = scale * torch.randn(p.shape, generator=g)


def test_device_schedule_matches_the_python_one():
    """The learning rate and both bias corrections from the device's count
    are the Python doubles' float32 roundings within one ulp, at every
    step from 0 to past the schedule's end, after ``load_state_dict``
    moves the count, and after eager steps move it."""
    model, opt = _opt()
    b1, b2 = opt.b1, opt.b2

    def check(k):
        assert opt.count == k
        lr, c1, c2 = opt._device_scalars()
        assert _ulps(lr, loop.cosine_lr(1e-3, TOTAL, 0.01, k)) <= 1
        assert _ulps(c1, 1.0 - b1 ** (k + 1)) <= 1
        assert _ulps(c2, math.sqrt(1.0 - b2 ** (k + 1))) <= 1
        assert all(t.dtype == torch.float32 for t in (lr, c1, c2))
        assert type(opt.count) is int and opt.count == k + 1

    for k in range(TOTAL + 3):
        check(k)
    opt.load_state_dict({"count": 3, "mu": opt.mu, "nu": opt.nu})
    check(3)
    for k in range(2):
        _grads(model, k)
        opt.step()
    check(6)


def test_update_matches_the_jax_optimizer():
    """``AdamW.step`` against the JAX package's optimizer (optax's
    global-norm clip, then AdamW on the cosine schedule with the tagged
    decay mask) from the same gradients, the clip binding on every other
    step, over the schedule and past its end: norms, moments and
    parameters within float32 rounding, and one count per update."""
    model, opt = _opt()
    tx, _ = jloop.make_optimizer(1e-3, 0.01, TOTAL)
    host = lambda xs: {n: jax.numpy.asarray(x.detach().numpy().copy())
                       for n, x in zip(opt.names, xs)}
    params = host(opt.params)
    state = tx.init(params)
    for k in range(TOTAL + 3):
        _grads(model, k, scale=(0.2, 5.0)[k % 2])
        grads = host([p.grad for p in opt.params])
        norm = opt.step()
        upd, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, upd)
        assert opt.count == k + 1
        torch.testing.assert_close(float(norm),
                                   float(optax.global_norm(grads)),
                                   rtol=1e-6, atol=0)
        adam = state[1][0]
        for mine, theirs in ((opt.params, params), (opt.mu, adam.mu),
                             (opt.nu, adam.nu)):
            for name, got in zip(opt.names, mine):
                # a leaf to float32 rounding of its largest element: the
                # moments round in another order (optax's, not lerp's)
                want = torch.from_numpy(np.array(theirs[name]))
                torch.testing.assert_close(
                    got.detach(), want, rtol=1e-6,
                    atol=1e-6 * float(want.abs().max()))


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
    dropout on: the same counts, and losses, Jaccard, norms, generator
    states, parameters and moments bitwise equal (both ways run one AdamW
    update form); each step's metrics keep their values after the later
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
            assert torch.equal(g[k], w[k]), k
    assert s_r.step == s_e.step == s_r.opt.count == s_e.opt.count == n
    assert torch.equal(s_r.generator.get_state(), s_e.generator.get_state())
    for a, b in zip(s_r.opt.params + s_r.opt.mu + s_r.opt.nu,
                    s_e.opt.params + s_e.opt.mu + s_e.opt.nu):
        assert torch.equal(a, b)


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


def test_a_restored_count_and_eager_steps_of_another_shape_reach_the_replays(
        captured, tmp_path):
    """A ``CheckpointManager`` restore and eager steps of another shape
    move the optimizer's one count, and the next replay's schedule starts
    from it: a replay after the restore repeats, bit for bit, the step
    that followed the save."""
    (s, step), _ = _pair(8)
    b = _batch(0)
    _replay_steps(s, step, [b] * 3)   # 2 eager, the capture's replay
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(s, s.step, {})
    _replay_steps(s, step, [b])
    after = [p.clone() for p in s.opt.params]
    assert s.opt.count == 4
    small = {k: v[:, :1] for k, v in b.items()}
    _replay_steps(s, step, [small])   # eager: another shape warms up
    assert s.opt.count == 5
    _replay_steps(s, step, [b])
    assert s.opt.count == 6
    ckpt.restore(s)
    assert s.step == s.opt.count == 3
    _replay_steps(s, step, [b])
    assert type(s.opt.count) is int and s.opt.count == 4
    assert len(captured) == 1
    for a, p in zip(after, s.opt.params):
        assert torch.equal(a, p)

