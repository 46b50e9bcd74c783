"""The plain reference on the CPU: its chunked float64 scan against the
step-by-step recurrence, and the reference models against the program at
tiny sizes (the same weights from the benchmark's maker, the same dropout
generator).  Run: ``python -m pytest perfbench -q``."""

import statistics

import pytest
import torch

from perfbench import programs, tiny, traffic, weights
from perfbench.reference import mamba_lm, scan, vivim


@pytest.mark.parametrize("L,dt_shift", [(1, 0.0), (255, 0.0), (256, 0.0),
                                        (600, 0.0), (300, 12.0)])
def test_chunked_scan_matches_the_recurrence(L, dt_shift):
    """Within a chunk, across chunk edges, and with dt so large that the
    chunk shrinks (``chunk_for``)."""
    g = torch.Generator().manual_seed(L)
    b, d, n = 2, 5, 4
    r = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)
    u, delta, z = r(b, L, d), r(b, L, d) + dt_shift, r(b, L, d)
    B, C, D, bias = r(b, L, n), r(b, L, n), r(d), r(d)
    A = -(torch.rand(d, n, generator=g, dtype=torch.float64) * 8 + 0.1)
    ins = [t.requires_grad_() for t in (u, delta, A, B, C, D, z, bias)]
    kw = dict(delta_softplus=True)
    y = scan.selective_scan(u, delta, A, B, C, D=D, z=z, delta_bias=bias,
                            **kw)
    want = scan.sequential_scan(u, delta, A, B, C, D=D, z=z,
                                delta_bias=bias, **kw)
    assert torch.allclose(y, want, rtol=1e-10, atol=1e-10)
    dy = r(b, L, d)
    for a, w in zip(torch.autograd.grad(y, ins, dy),
                    torch.autograd.grad(want, ins, dy)):
        assert torch.allclose(a, w, rtol=1e-9, atol=1e-9)


def test_scan_rows_in_blocks_equal_one_block(monkeypatch):
    g = torch.Generator().manual_seed(0)
    u, delta = torch.randn(5, 70, 3, generator=g), torch.randn(5, 70, 3,
                                                                 generator=g)
    B, C = torch.randn(5, 70, 4, generator=g), torch.randn(5, 70, 4,
                                                            generator=g)
    A = -torch.rand(3, 4, generator=g) - 0.5
    whole = scan.selective_scan(u, delta, A, B, C, delta_softplus=True)
    monkeypatch.setattr(scan, "ROW_ELEMS", 70 * 3 * 4 * 2)
    assert torch.equal(scan.selective_scan(u, delta, A, B, C,
                                           delta_softplus=True), whole)


def tiny_vivim():
    cfg = harness_config("vivim-b3")
    w = weights.make(weights.shapes_of(vivim.build(cfg, "meta")), 11, "cpu")
    return cfg, w


def harness_config(name):
    from perfbench import harness
    return tiny.shrink(harness.load_json(
        f"{harness.HERE}/configs/{name}.json"))


def test_reference_vivim_matches_the_program_in_eval_and_a_train_step():
    from vivim_tpu_torch.train import loop

    cfg, w = tiny_vivim()
    port = programs.vivim(cfg, w, "cpu").eval()
    ref = vivim.build(cfg, "cpu")
    ref.load_state_dict(w)
    ref.eval()
    clip, masks = traffic.clip_batch(3, 0, 2, 2, 64, 3)
    with torch.no_grad():
        assert torch.allclose(port(clip), ref(clip), atol=2e-6)
    state = loop.create_train_state(port, 1e-4, 1e-2, 100, seed=5)
    _, m = loop.make_train_step(port, "recall_focused", 3)(
        state, {"clip": clip, "masks": masks})
    ref.train()
    ref.set_generator(torch.Generator().manual_seed(5))
    opt = vivim.AdamW(ref, 1e-4, 1e-2, 100)
    loss = vivim.clip_loss(ref, clip, masks, 3)
    loss.backward()
    opt.step()
    assert float(m["loss"]) == pytest.approx(float(loss.detach()), rel=1e-6)
    grads = {n: float(g.norm()) for n, g in opt.last_grads.items()}
    med = statistics.median(grads.values())
    prog = {n: float(mu.norm()) / 0.1 for n, mu in zip(state.opt.names,
                                                        state.opt.mu)}
    assert max(abs(prog[n] - grads[n]) / max(grads[n], med)
               for n in grads) < 1e-4
    # leaves whose gradient is rounding (a bias under softmax or before
    # BatchNorm) move by Adam's sign of rounding: left out, as in the check
    params = dict(port.named_parameters())
    for n, p in ref.named_parameters():
        if grads.get(n, 0.0) >= 1e-3 * med:
            assert torch.allclose(params[n], p, atol=1e-6), n


def test_reference_lm_matches_the_program():
    from vivim_tpu_torch.nn import lm

    cfg = harness_config("mamba-130m")
    ref = mamba_lm.build(cfg, "cpu")
    w = weights.make(weights.shapes_of(ref), 3, "cpu")
    ref.load_state_dict(w)
    model, params = programs.lm(cfg, w, "cpu")
    tokens = traffic.token_ids(1, 0, 2, 33, cfg["vocab_size"])
    with torch.no_grad():
        want = ref(tokens)
        assert want.shape[-1] == 56
        assert torch.allclose(model(tokens), want, atol=1e-5)
        assert torch.allclose(lm.forward_functional(model, params, tokens),
                              want, atol=1e-5)
