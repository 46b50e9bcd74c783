"""The output check fails where the timed path is broken: each tiny cell
runs through the harness on the CPU (the look for a chip skipped) with a
fault planted in the program underneath, once for each fault the cell can
have, and ``correct`` must come out false; a sound run beside them comes
out true.  Faults: a train step that returns its state unchanged, a train
step that leaves out half of the batch (the mean over the rest), a train
step sound in set-up that later keeps computing on one batch (a replayed
capture that kept its inputs) or later returns its state unchanged, an
answer altered where it is produced (a pixel's class, a count, a token,
a log-likelihood), and a decode step that leaves its states unchanged.
No cell runs on several chips, so no exchange between chips can be left
out.  Run: ``python -m pytest perfbench -q``."""

import contextlib
from unittest import mock

import pytest
import torch

from perfbench import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def unchanged_step():
    from vivim_tpu_torch.train import loop
    real = loop.make_train_step

    def make(model, *a, **k):
        step = real(model, *a, **k)

        def broken(state, batch):
            before = [p.detach().clone() for p in model.parameters()]
            state, m = step(state, batch)
            with torch.no_grad():
                for p, b in zip(model.parameters(), before):
                    p.copy_(b)
            return state, m
        return broken
    return mock.patch.object(loop, "make_train_step", make)


def half_batch_step():
    from vivim_tpu_torch.train import loop
    real = loop.make_train_step

    def make(model, *a, **k):
        step = real(model, *a, **k)

        def broken(state, batch):
            half = batch["clip"].shape[0] // 2
            return step(state, {k: v[:half] for k, v in batch.items()})
        return broken
    return mock.patch.object(loop, "make_train_step", make)


def captured_batch_step(after=3):
    """From its ``after + 1``-th call on, the step computes on the batch of
    that call, as a replayed capture that kept its first inputs would."""
    from vivim_tpu_torch.train import loop
    real = loop.make_train_step

    def make(model, *a, **k):
        step = real(model, *a, **k)
        calls, kept = [0], {}

        def broken(state, batch):
            calls[0] += 1
            if calls[0] > after:
                kept.setdefault("batch", {k: v.clone()
                                          for k, v in batch.items()})
                batch = kept["batch"]
            return step(state, batch)
        return broken
    return mock.patch.object(loop, "make_train_step", make)


def late_unchanged_step(after=3):
    """Sound for its first ``after`` calls, then returns its state
    unchanged."""
    from vivim_tpu_torch.train import loop
    real = loop.make_train_step

    def make(model, *a, **k):
        step = real(model, *a, **k)
        calls = [0]

        def broken(state, batch):
            calls[0] += 1
            before = [p.detach().clone() for p in model.parameters()]
            state, m = step(state, batch)
            if calls[0] > after:
                with torch.no_grad():
                    for p, b in zip(model.parameters(), before):
                        p.copy_(b)
            return state, m
        return broken
    return mock.patch.object(loop, "make_train_step", make)


def altered_class():
    from vivim_tpu_torch.cli import infer
    real = infer.serving_forward

    def make(model, nc):
        fwd = real(model, nc)

        def broken(clip, masks):
            preds, conf, cm = fwd(clip, masks)
            preds = preds.clone()
            preds[0, 0, 5, 5] = (preds[0, 0, 5, 5] + 1) % nc
            return preds, conf, cm
        return broken
    return mock.patch.object(infer, "serving_forward", make)


def altered_count():
    from vivim_tpu_torch.cli import infer
    real = infer.serving_forward

    def make(model, nc):
        fwd = real(model, nc)

        def broken(clip, masks):
            preds, conf, cm = fwd(clip, masks)
            return preds, conf, cm + torch.eye(nc, dtype=cm.dtype)
        return broken
    return mock.patch.object(infer, "serving_forward", make)


def altered_token():
    from vivim_tpu_torch.nn import lm
    real = lm.generate

    def broken(*a, **k):
        out, scores = real(*a, **k)
        out = out.clone()
        out[0, -2] = (out[0, -2] + 1) % 50
        return out, scores
    return mock.patch.object(lm, "generate", broken)


def unchanged_decode_state():
    from vivim_tpu_torch.nn import lm
    real = lm.decode_step

    def broken(parts, token, conv_states, ssm_states, mixer_step=None):
        logits, _, _ = real(parts, token, conv_states, ssm_states, mixer_step)
        return logits, conv_states, ssm_states
    return mock.patch.object(lm, "decode_step", broken)


def altered_loglikelihood():
    from vivim_tpu_torch.cli import lm_eval_harness
    real = lm_eval_harness.MambaEvalCore._score

    def broken(self, ctx, cont):
        ll, greedy = real(self, ctx, cont)
        return ll + 0.5, greedy
    return mock.patch.object(lm_eval_harness.MambaEvalCore, "_score",
                             broken)


CASES = [
    ("vivim-tiny.train", None),
    ("vivim-tiny.train", unchanged_step),
    ("vivim-tiny.train", half_batch_step),
    ("vivim-tiny.train", captured_batch_step),
    ("vivim-tiny.train", late_unchanged_step),
    ("vivim-tiny.serve", None),
    ("vivim-tiny.serve", altered_class),
    ("vivim-tiny.serve", altered_count),
    ("mamba-tiny.generate", None),
    ("mamba-tiny.generate", altered_token),
    ("mamba-tiny.generate", unchanged_decode_state),
    ("mamba-tiny.score", None),
    ("mamba-tiny.score", altered_loglikelihood),
]


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f.__name__ if f else 'sound'}"
                              for c, f in CASES])
def test_a_broken_timed_path_is_not_correct(root, cell, fault):
    path, here, bench = root
    with fault() if fault else contextlib.nullcontext():
        result, checks = tiny.run(path, here, bench, cell)
    assert result["correct"] is (fault is None), result["checks"]
