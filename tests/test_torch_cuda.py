"""The PyTorch port's CUDA kernels on the card, against their plain versions.

The kernel tests run at d_state N in ``NS`` (the kernels take 1 to 256; 16
is the Vivim and mamba-130m width, 12 and 24 masked widths).  Marked
``cuda``: each test skips without a CUDA device.  The file imports
torch and the port only, so it runs on a machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest`` because tests/conftest.py sets up JAX.)  Tolerances are
the JAX suite's: fp32 rtol 6e-4 / atol 2e-3, bf16 rtol 3e-2 / atol 5e-2;
grads rtol 1e-3 / atol 2e-3; model logits atol 1e-3.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vivim_tpu_torch.kernels import refs
from vivim_tpu_torch.kernels import selective_scan as ss

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (6e-4, 2e-3), torch.bfloat16: (3e-2, 5e-2)}
GRAD_TOL = {torch.float32: (1e-3, 2e-3), torch.bfloat16: (3e-2, 5e-2)}
NS = (1, 8, 12, 16, 24, 64, 256)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _inputs(dev, b=3, L=333, d=160, n=16, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dev)
    bc = f(b, L, 2 * n)  # B and C as strided column views, as on the path
    return dict(u=f(b, L, d), delta=0.5 * f(b, L, d),
                A=-(0.5 + torch.from_numpy(rng.random((b, d, n)).astype(
                    np.float32)).to(dev)),
                B=bc[..., :n], C=bc[..., n:], D=f(b, d), z=f(b, L, d),
                delta_bias=0.1 * f(b, d), initial_state=f(b, d, n))


def _scan(fn, t, dtype):
    kw = dict(t)
    seq = [kw.pop(k).to(dtype) for k in ("u", "delta")]
    A = kw.pop("A")
    B, C = kw.pop("B").to(dtype), kw.pop("C").to(dtype)
    kw["z"] = kw["z"].to(dtype)
    return fn(*seq, A, B, C, delta_softplus=True, return_last_state=True,
              **kw)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda, dtype, n):
    """Ragged L and d, per-batch A/D/bias, initial and last state."""
    t = _inputs(cuda, n=n)
    with torch.no_grad():
        before = ss.LAUNCHES
        got = _scan(ss.selective_scan, t, dtype)
        assert ss.LAUNCHES == before + 1
        want = _scan(refs.selective_scan_ref, t, dtype)
    torch.cuda.synchronize()
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    rtol, atol = TOL[dtype]
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=atol)


def test_grouped_bc_and_shared_params(cuda):
    """Grouped B/C fold into the batch; shared (D, N) A with batch stride
    0; no z, D or bias."""
    rng = np.random.default_rng(1)
    f = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(cuda)
    u, delta = f(2, 100, 32), 0.5 * f(2, 100, 32)
    A = -(0.5 + torch.rand(32, 16, device=cuda))
    B, C = f(2, 100, 2, 16), f(2, 100, 2, 16)
    with torch.no_grad():
        got = ss.selective_scan(u, delta, A, B, C, delta_softplus=True)
        want = refs.selective_scan_ref(u, delta, A, B, C,
                                       delta_softplus=True)
    torch.testing.assert_close(got, want, rtol=6e-4, atol=2e-3)


def test_cuda_refuses_what_has_no_kernel(cuda):
    """A constant (dim, dstate) B (no TPU kernel takes it: the sequential
    plain scan, as in the JAX package) and d_state 8 (K1) give the CPU's
    result on the card; d_state 257 (above the kernels' 256) is refused."""
    t = _inputs(cuda, b=1, L=16, d=8)
    B_const = torch.randn(8, 16, device=cuda)
    for args in ((t["u"], t["delta"], t["A"][0], B_const, t["C"]),
                 (t["u"], t["delta"], t["A"][..., :8], t["B"][..., :8],
                  t["C"][..., :8])):
        with torch.no_grad():
            before = ss.LAUNCHES
            got = ss.selective_scan(*args, delta_softplus=True)
            launched = ss.LAUNCHES - before
            want = ss.selective_scan(*[a.cpu() for a in args],
                                     delta_softplus=True)
        assert launched == (0 if args[3] is B_const else 1)
        torch.testing.assert_close(got.cpu(), want, rtol=6e-4, atol=2e-3)
    wide = torch.zeros(1, 16, 257, device=cuda)
    with pytest.raises(ValueError, match="d_state 257"):
        with torch.no_grad():
            ss.selective_scan(t["u"], t["delta"],
                              torch.zeros(8, 257, device=cuda), wide, wide)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_training_kernels_match_plain_versions(cuda, dtype, n):
    """K1's training variant and K2 against their plain versions: ragged L,
    d = 160 (several K2 blocks), shared A / D / bias, an initial state and
    a non-zero dlast.  K2 runs on K1's own chunk states, so each kernel is
    held alone."""
    t = _inputs(cuda, n=n)
    u, delta = t["u"].to(dtype), t["delta"].to(dtype)
    B, C = t["B"].to(dtype), t["C"].to(dtype)
    A, D, bias = t["A"][0], t["D"][0], t["delta_bias"][0]
    h0 = t["initial_state"]
    got = ss.selective_scan_fwd_states_cuda(u, delta, A, B, C, D, bias,
                                            True, h0)
    want = refs.selective_scan_fwd_states_ref(u, delta, A, B, C, D, bias,
                                              True, h0, chunk=ss.CHUNK)
    rtol, atol = TOL[dtype]
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=atol)
    rng = np.random.default_rng(3)
    dout = torch.from_numpy(rng.standard_normal(u.shape).astype(
        np.float32)).to(cuda, dtype)
    dlast = torch.from_numpy(rng.standard_normal(h0.shape).astype(
        np.float32)).to(cuda)
    before = ss.BWD_LAUNCHES
    got = ss.selective_scan_bwd_cuda(u, delta, A, B, C, D, bias, got[1],
                                     dout, dlast, True)
    assert ss.BWD_LAUNCHES == before + 1
    want = refs.selective_scan_bwd_ref(u, delta, A, B, C, D, bias,
                                       want[1], dout, dlast, True,
                                       chunk=ss.CHUNK)
    torch.cuda.synchronize()
    rtol, atol = GRAD_TOL[dtype]
    names = ("ddelta", "du", "dB", "dC", "dA", "dD", "dbias", "dh0")
    for name, g, w in zip(names, got, want):
        assert g.dtype == (dtype if name in ("ddelta", "du", "dB", "dC")
                           else torch.float32), name
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                   atol=atol, msg=name)


@pytest.mark.parametrize("n", [16, 24])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [1, 17, 63, 65, 333])
def test_forward_kernel_across_chunk_edges(cuda, L, dtype, n):
    """K1's chunk-parallel passes at lengths that cross its chunk edges
    (Lc - 1 and Lc + 1 for a forced Lc = 64; the Lc the wrapper picks at
    these sizes is 16), d = 160 with an initial state: both variants, and
    K2 on the training variant's chunk states.  dt near 0.05, so the state
    carried from one chunk to the next still counts."""
    t = _inputs(cuda, L=L, n=n, seed=L)
    u, delta = t["u"].to(dtype), (t["delta"] - 3.0).to(dtype)
    B, C, z = t["B"].to(dtype), t["C"].to(dtype), t["z"].to(dtype)
    A, D, bias, h0 = t["A"], t["D"], t["delta_bias"], t["initial_state"]
    rtol, atol = TOL[dtype]
    want = refs.selective_scan_ref(u, delta, A, B, C, D, z, bias, True, True,
                                   h0)
    want_s = refs.selective_scan_fwd_states_ref(u, delta, A, B, C, D, bias,
                                                True, h0, chunk=ss.CHUNK)
    got = ss.selective_scan_fwd_cuda(u, delta, A, B, C, D, z, bias, True, h0)
    got_s = ss.selective_scan_fwd_states_cuda(u, delta, A, B, C, D, bias,
                                              True, h0)
    # the same two variants with the parallel chunk forced to 64
    y64, _, last64 = ss._fwd_launch(u, delta, A, B, C, D, z, bias, True, h0,
                                    False, 64)
    got_s64 = ss._fwd_launch(u, delta, A, B, C, D, None, bias, True, h0,
                             True, 64)
    torch.cuda.synchronize()
    for l_chunk, outs in ((None, got + got_s), (64, (y64, last64) + got_s64)):
        for g, w in zip(outs, want + want_s):
            torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                       atol=atol, msg=f"Lc {l_chunk}")
    rng = np.random.default_rng(L)
    dout = torch.from_numpy(rng.standard_normal(u.shape).astype(
        np.float32)).to(cuda, dtype)
    cs = got_s64[1]
    got = ss.selective_scan_bwd_cuda(u, delta, A, B, C, D, bias, cs, dout,
                                     None, True)
    want = refs.selective_scan_bwd_ref(u, delta, A, B, C, D, bias, cs, dout,
                                       None, True, chunk=ss.CHUNK)
    torch.cuda.synchronize()
    rtol, atol = GRAD_TOL[dtype]
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("L", [65, 333, 2048])
def test_forward_kernel_small_dt(cuda, L):
    """dt near 1e-3, the floor of the dt init (delta shifted by -7), fp32:
    K1's softplus must stay accurate where it is small.  Both variants,
    with the wrapper's Lc and a forced Lc = 64, against the plain
    versions; no initial state, so the output carries the states the
    small dt builds."""
    t = _inputs(cuda, L=L, seed=L + 1)
    u, delta, A, B, C, D, z, bias = (
        t["u"], t["delta"] - 7.0, t["A"], t["B"], t["C"], t["D"], t["z"],
        t["delta_bias"])
    rtol, atol = TOL[torch.float32]
    want = refs.selective_scan_ref(u, delta, A, B, C, D, z, bias, True, True)
    want_s = refs.selective_scan_fwd_states_ref(u, delta, A, B, C, D, bias,
                                                True, chunk=ss.CHUNK)
    for l_chunk in (None, 64):
        y, _, last = ss._fwd_launch(u, delta, A, B, C, D, z, bias, True, None,
                                    False, l_chunk)
        got_s = ss._fwd_launch(u, delta, A, B, C, D, None, bias, True, None,
                               True, l_chunk)
        torch.cuda.synchronize()
        for g, w in zip((y, last) + got_s, want + want_s):
            torch.testing.assert_close(g, w, rtol=rtol, atol=atol,
                                       msg=f"Lc {l_chunk}")


@pytest.mark.parametrize("n", NS)
def test_cuda_call_with_grad_launches_k2(cuda, n):
    """A CUDA call that needs a gradient runs K1's training variant and K2
    (z gated outside the kernels), and its nine gradients match autograd
    through the sequential plain version."""
    t = _inputs(cuda, b=2, L=77, d=40, n=n)
    rng = np.random.default_rng(4)
    dout = torch.from_numpy(rng.standard_normal((2, 77, 40)).astype(
        np.float32)).to(cuda)
    dlast = torch.from_numpy(rng.standard_normal((2, 40, n)).astype(
        np.float32)).to(cuda)
    grads = []
    for impl in (None, "ref"):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in t.items()}
        counts = (ss.LAUNCHES, ss.TRAIN_LAUNCHES, ss.BWD_LAUNCHES)
        y, last = _scan(lambda *a, **k: ss.selective_scan(
            *a, implementation=impl, **k), leaves, torch.float32)
        torch.autograd.backward((y, last), (dout, dlast))
        launched = tuple(c1 - c0 for c0, c1 in zip(
            counts, (ss.LAUNCHES, ss.TRAIN_LAUNCHES, ss.BWD_LAUNCHES)))
        assert launched == ((0, 1, 1) if impl is None else (0, 0, 0))
        grads.append({k: v.grad for k, v in leaves.items()})
    torch.cuda.synchronize()
    for k, g in grads[0].items():
        torch.testing.assert_close(g, grads[1][k], rtol=1e-3, atol=2e-3,
                                   msg=k)


def test_tiny_vivim_kernel_vs_plain_scan(cuda):
    """A whole (tiny) model on the card: one launch per MambaLayer, logits
    within 1e-3 of the same model on the plain scan."""
    from vivim_tpu_torch.nn.layers import init_weights
    from vivim_tpu_torch.nn.vivim import Vivim, VivimConfig

    cfg = VivimConfig.tiny_test(scan_implementation=None)
    model = init_weights(Vivim(cfg), torch.Generator().manual_seed(0))
    ref = Vivim(dataclasses.replace(cfg, scan_implementation="ref"))
    ref.load_state_dict(model.state_dict())
    model, ref = model.to(cuda).eval(), ref.to(cuda).eval()
    clip = torch.randn(1, 3, 48, 48, 3, device=cuda)
    with torch.inference_mode():
        before = ss.LAUNCHES
        got = model(clip)
        assert ss.LAUNCHES - before == sum(cfg.depths)
        want = ref(clip)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)


def test_tiny_vivim_train_step_kernel_vs_plain_scan(cuda):
    """One train step of a tiny model through the kernels (8 K1-training
    and 8 K2 launches) against the same step on the plain scan, dropouts
    at 0: loss, jaccard and grad norm, and every gradient within rtol 1e-3
    / atol 2e-3."""
    from vivim_tpu_torch.nn.layers import init_weights
    from vivim_tpu_torch.nn.vivim import Vivim, VivimConfig
    from vivim_tpu_torch.train import loop

    cfg = VivimConfig.tiny_test(scan_implementation=None)
    cfg = dataclasses.replace(
        cfg, drop_path_rate=0.0, dropout_rate=0.0,
        segformer=dataclasses.replace(cfg.segformer, drop_path_rate=0.0,
                                      classifier_dropout=0.0))
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 3, (2, 3, 48, 48))
    batch = {"clip": torch.from_numpy(rng.standard_normal(
                 (2, 3, 48, 48, 3)).astype(np.float32)).to(cuda),
             "masks": torch.from_numpy(np.eye(3, dtype=np.float32)[
                 labels]).to(cuda)}
    out = []
    for impl in (None, "ref"):
        model = init_weights(Vivim(dataclasses.replace(
            cfg, scan_implementation=impl)), torch.Generator().manual_seed(0))
        model = model.to(cuda)
        state = loop.create_train_state(model, 1e-3, 1e-2, 1, seed=0)
        c0 = (ss.LAUNCHES, ss.TRAIN_LAUNCHES, ss.BWD_LAUNCHES)
        _, m = loop.make_train_step(model)(state, batch)
        launched = (ss.LAUNCHES - c0[0], ss.TRAIN_LAUNCHES - c0[1],
                    ss.BWD_LAUNCHES - c0[2])
        assert launched == ((0, 8, 8) if impl is None else (0, 0, 0))
        out.append((m, {n: p.grad for n, p in model.named_parameters()
                        if p.grad is not None}))
    (m_k, g_k), (m_r, g_r) = out
    for k in ("loss", "jaccard", "grad_norm"):
        torch.testing.assert_close(m_k[k], m_r[k], rtol=1e-5, atol=1e-6,
                                   msg=k)
    assert set(g_k) == set(g_r) and len(g_k) > 300
    for n, g in g_k.items():
        torch.testing.assert_close(g, g_r[n], rtol=1e-3, atol=2e-3, msg=n)


@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l_seg", [16, 64])
@pytest.mark.parametrize("L", [1, 17, 333, 1000])
def test_backward_kernel_across_segment_edges(cuda, L, l_seg, dtype, n):
    """K2 with its segment length forced through the private seam
    ``_bwd_launch(l_seg=...)`` (which counts nothing), at lengths that
    cross the segment edges: d = 160, per-batch A / D / bias, an initial
    state, a non-zero dlast, dt near 0.05 so the carry from one segment to
    the next still counts.  K2 runs on K1-training's own chunk states and
    is held against the plain version on the same states."""
    t = _inputs(cuda, L=L, n=n, seed=L + l_seg)
    u, delta = t["u"].to(dtype), (t["delta"] - 3.0).to(dtype)
    B, C = t["B"].to(dtype), t["C"].to(dtype)
    A, D, bias, h0 = t["A"], t["D"], t["delta_bias"], t["initial_state"]
    _, cs, _ = ss.selective_scan_fwd_states_cuda(u, delta, A, B, C, D, bias,
                                                 True, h0)
    rng = np.random.default_rng(L)
    dout = torch.from_numpy(rng.standard_normal(u.shape).astype(
        np.float32)).to(cuda, dtype)
    dlast = torch.from_numpy(rng.standard_normal(h0.shape).astype(
        np.float32)).to(cuda)
    before = ss.BWD_LAUNCHES
    got = ss._bwd_launch(u, delta, A, B, C, D, bias, cs, dout, dlast, True,
                         l_seg)
    assert ss.BWD_LAUNCHES == before
    want = refs.selective_scan_bwd_ref(u, delta, A, B, C, D, bias, cs, dout,
                                       dlast, True, chunk=ss.CHUNK)
    torch.cuda.synchronize()
    rtol, atol = GRAD_TOL[dtype]
    names = ("ddelta", "du", "dB", "dC", "dA", "dD", "dbias", "dh0")
    for name, g, w in zip(names, got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                   atol=atol, msg=f"l_seg {l_seg} {name}")


def test_backward_kernel_in_a_cuda_graph(cuda):
    """K2 as the wrapper picks it (L = 1000, d = 160, batch 3: several
    segments, so all four passes and their scratch) captured in a CUDA
    graph, then replayed on a new cotangent copied into the captured one:
    the same gradients as the plain version on that cotangent."""
    t = _inputs(cuda, L=1000, seed=5)
    u, delta, B, C = t["u"], t["delta"] - 3.0, t["B"], t["C"]
    A, D, bias = t["A"], t["D"], t["delta_bias"]
    _, cs, _ = ss.selective_scan_fwd_states_cuda(u, delta, A, B, C, D, bias,
                                                 True)
    assert ss.bwd_grid(3, 1000, 160, ss.bwd_l_seg(
        3, 1000, 160, torch.cuda.get_device_properties(
            cuda).multi_processor_count, ss.bwd_channels(16)),
        ss.bwd_channels(16))[1] > 1
    rng = np.random.default_rng(6)
    dout = torch.from_numpy(rng.standard_normal(u.shape).astype(
        np.float32)).to(cuda)
    run = lambda: ss.selective_scan_bwd_cuda(u, delta, A, B, C, D, bias, cs,
                                             dout, None, True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = run()
    dout.copy_(torch.from_numpy(rng.standard_normal(u.shape).astype(
        np.float32)).to(cuda))
    graph.replay()
    want = refs.selective_scan_bwd_ref(u, delta, A, B, C, D, bias, cs, dout,
                                       None, True, chunk=ss.CHUNK)
    torch.cuda.synchronize()
    names = ("ddelta", "du", "dB", "dC", "dA", "dD", "dbias", "dh0")
    for name, g, w in zip(names, got, want):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=2e-3, msg=name)


@pytest.mark.parametrize("m", [1, 5, 17, 37])
def test_int8_product_is_exact_on_the_card(cuda, m):
    """``quant.int_mm`` pads the rows for cuBLASLt's int8 route and gives
    the exact int32 product at every row count the LM uses."""
    from vivim_tpu_torch.nn import quant

    g = torch.Generator(device=cuda).manual_seed(m)
    a = torch.randint(-127, 128, (m, 64), generator=g, device=cuda,
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (48, 64), generator=g, device=cuda,
                      dtype=torch.int8)
    want = (a.cpu().long() @ b.cpu().long().t())
    assert torch.equal(quant.int_mm(a, b).cpu().long(), want)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_tiny_lm_generate_on_the_card_vs_the_cpu(cuda, dtype):
    """A 2-layer LM: K1 once per layer in the prefill and never in the
    decode steps; teacher-forced scores equal the CPU's (plain versions) at
    the model-logits tolerance (int8: the bf16 tolerance)."""
    from vivim_tpu_torch.nn import lm, quant
    from vivim_tpu_torch.nn.layers import init_weights

    model = init_weights(lm.MambaLM(lm.MambaLMConfig(
        vocab_size=50, d_model=32, n_layer=2, rms_norm=True,
        residual_in_fp32=True)), torch.Generator().manual_seed(0)).eval()
    params = lm.lm_params(model)
    if dtype == "int8":
        params = quant.quantize_lm_params(params,
                                          activation_dtype=torch.bfloat16)
    toks = torch.randint(0, 50, (1, 37), generator=torch.Generator()
                         .manual_seed(1))
    want_toks, want = lm.generate(model, params, toks, 8, temperature=0.0,
                                  output_scores=True)
    on_card = {k: ({n: t.to(cuda) for n, t in v.items()}
                   if quant.is_qtensor(v) else v.to(cuda))
               for k, v in params.items()}
    ss.LAUNCHES = 0
    got_toks, got = lm.generate(model.to(cuda), on_card, toks.to(cuda), 8,
                                temperature=0.0,
                                teacher_outputs=want_toks.to(cuda),
                                output_scores=True)
    assert ss.LAUNCHES == 2
    rtol, atol = (0, 1e-3) if dtype == "float32" else TOL[torch.bfloat16]
    torch.testing.assert_close(got.float().cpu(), want.float(), rtol=rtol,
                               atol=atol)


def _remat_cfg(cfg, level):
    if level == "pre_scan":
        return dataclasses.replace(cfg, remat_pre_scan=True)
    if level == "blocks":
        return dataclasses.replace(
            cfg, remat_blocks=True,
            segformer=dataclasses.replace(cfg.segformer, remat_layers=True))
    return cfg


def _tiny_step(dev, level, dropout):
    """One train step of a tiny Vivim at remat ``level`` on ``dev``
    (dropouts at their defaults, or 0): (metrics, grads, launches as
    (K1, K1-training, K2), the generator's state after the step)."""
    from vivim_tpu_torch.nn.layers import init_weights
    from vivim_tpu_torch.nn.vivim import Vivim, VivimConfig
    from vivim_tpu_torch.train import loop

    cfg = _remat_cfg(VivimConfig.tiny_test(scan_implementation=None), level)
    if not dropout:
        cfg = dataclasses.replace(
            cfg, drop_path_rate=0.0, dropout_rate=0.0,
            segformer=dataclasses.replace(cfg.segformer, drop_path_rate=0.0,
                                          classifier_dropout=0.0))
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 3, (2, 3, 48, 48))
    batch = {"clip": torch.from_numpy(rng.standard_normal(
                 (2, 3, 48, 48, 3)).astype(np.float32)).to(dev),
             "masks": torch.from_numpy(np.eye(3, dtype=np.float32)[
                 labels]).to(dev)}
    model = init_weights(Vivim(cfg), torch.Generator().manual_seed(0))
    state = loop.create_train_state(model.to(dev), 1e-3, 1e-2, 1, seed=0)
    c0 = (ss.LAUNCHES, ss.TRAIN_LAUNCHES, ss.BWD_LAUNCHES)
    _, m = loop.make_train_step(model)(state, batch)
    launched = (ss.LAUNCHES - c0[0], ss.TRAIN_LAUNCHES - c0[1],
                ss.BWD_LAUNCHES - c0[2])
    grads = {n: p.grad.cpu() for n, p in model.named_parameters()
             if p.grad is not None}
    return m, grads, launched, state.generator.get_state()


@pytest.mark.parametrize("level,launches", [
    ("none", (0, 8, 8)), ("pre_scan", (0, 8, 8)), ("blocks", (0, 16, 8))])
def test_tiny_remat_step_on_the_card_vs_the_cpu(cuda, level, launches):
    """A remat step through the kernels (``blocks`` reruns K1-training in
    the recompute) against the same step on the CPU, dropouts at 0 (the
    card's and the CPU's random streams differ): loss within 1e-5
    relative, every gradient within rtol 1e-3 / atol 2e-3."""
    m_k, g_k, launched, _ = _tiny_step(cuda, level, dropout=False)
    assert launched == launches
    m_c, g_c, _, _ = _tiny_step(torch.device("cpu"), level, dropout=False)
    torch.testing.assert_close(m_k["loss"].cpu(), m_c["loss"], rtol=1e-5,
                               atol=0)
    assert set(g_k) == set(g_c) and len(g_k) > 300
    for n, g in g_k.items():
        torch.testing.assert_close(g, g_c[n], rtol=1e-3, atol=2e-3, msg=n)


@pytest.mark.parametrize("level", ["pre_scan", "blocks"])
def test_tiny_remat_step_keeps_the_card_generator(cuda, level):
    """Dropouts on, one seed: a remat step on the card gives the loss, the
    gradients and the generator state of the step without remat."""
    m_r, g_r, _, gen_r = _tiny_step(cuda, level, dropout=True)
    m_n, g_n, _, gen_n = _tiny_step(cuda, "none", dropout=True)
    assert torch.equal(gen_r, gen_n)
    torch.testing.assert_close(m_r["loss"], m_n["loss"], rtol=1e-5, atol=0)
    for n, g in g_r.items():
        torch.testing.assert_close(g, g_n[n], rtol=1e-3, atol=2e-3, msg=n)


# The Mix-FFN's 3-D depthwise conv (kernels/dwconv3d.py).  Tolerances: y
# and dx (27 fp32 FMAs of unit-scale terms) rtol 1e-5 / atol 1e-5 against
# float64 F.conv3d; dweight and dbias, fp32 sums over every position (up to
# 61,440 at stage 0 of a training step), within 1e-4 of their largest
# magnitude; bf16 tokens rtol 3e-2 / atol 5e-2 (TOL) against float64 on the
# bf16 values.
DW_TOL = dict(rtol=1e-5, atol=1e-5)
DW_SUM_TOL = 1e-4
# (batch, T, H, W, C): Vivim-b3's four Mamba stages at 5 x 256 px, batch 1
# (serving) and 3 (training)
DW_STAGES = tuple((b, 5, s, s, c) for b in (1, 3)
                  for s, c in ((64, 256), (32, 512), (16, 1280), (8, 2048)))
# T, H, W in {1, 2, 5, 7}, C in {1, 3, 16, 130}, batch 1 and 3
DW_RAGGED = ((1, 1, 1, 1, 1), (3, 1, 2, 5, 3), (1, 2, 7, 1, 16),
             (3, 5, 5, 2, 130), (1, 7, 1, 7, 3), (3, 2, 2, 2, 1),
             (1, 5, 7, 5, 130), (3, 7, 5, 7, 16))


def _dw_inputs(dev, case, seed=0):
    """fp32 tokens, weight at its init scale, bias, cotangent."""
    batch, T, H, W, C = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=gen, device=dev)
    return (f(batch, T * H * W, C), f(C, 1, 3, 3, 3) / 27 ** 0.5,
            0.1 * f(C), f(batch, T * H * W, C))


def _dw_float64(x, w, b, dy, T, H, W):
    """y and (dx, dweight, dbias) of float64 F.conv3d (the card's, TF32
    irrelevant in float64), by autograd."""
    x, w, b = (t.double().requires_grad_() for t in (x, w, b))
    y = refs.dwconv3d_ref(x, w, b, T, H, W)
    return y.detach(), torch.autograd.grad(y, (x, w, b), dy.double())


def _dw_check(got_y, got, want_y, want, what, tol=DW_TOL,
              sum_tol=DW_SUM_TOL):
    if got_y is not None:
        torch.testing.assert_close(got_y.double(), want_y, **tol,
                                   msg=f"{what} y")
    torch.testing.assert_close(got[0].double(), want[0], **tol,
                               msg=f"{what} dx")
    for name, g, v in zip(("dweight", "dbias"), got[1:], want[1:]):
        err = (g.double() - v).abs().max().item()
        scale = v.abs().max().item()
        assert err <= sum_tol * scale, (
            f"{what} {name}: {err:.3e} of {scale:.3e}")


@pytest.mark.parametrize("case", DW_STAGES,
                         ids=["b{}_t{}_h{}_w{}_c{}".format(*c)
                              for c in DW_STAGES])
def test_dwconv3d_kernels_at_vivim_stages(cuda, case):
    """The forward (one launch) and the backward (one wrapper call, two
    kernels) at the Vivim-b3 stage shapes, as the wrapper tiles them,
    against float64 F.conv3d."""
    from vivim_tpu_torch.kernels import dwconv3d as dk

    batch, T, H, W, C = case
    x, w, b, dy = _dw_inputs(cuda, case)
    c0 = (dk.LAUNCHES, dk.BWD_LAUNCHES)
    y = dk.dwconv3d_fwd_cuda(x, w, b, T, H, W)
    grads = dk.dwconv3d_bwd_cuda(x, dy, w, T, H, W)
    assert (dk.LAUNCHES, dk.BWD_LAUNCHES) == (c0[0] + 1, c0[1] + 1)
    torch.cuda.synchronize()
    _dw_check(y, grads, *_dw_float64(x, w, b, dy, T, H, W), str(case))


@pytest.mark.parametrize("case", DW_RAGGED,
                         ids=["b{}_t{}_h{}_w{}_c{}".format(*c)
                              for c in DW_RAGGED])
def test_dwconv3d_kernels_at_ragged_shapes_and_tiles(cuda, case):
    """Edge shapes, as the wrapper tiles them and with forced block rows
    (1, 2 and 3: tiles that end mid-frame and cross frames), scalar lanes
    forced too; and tokens read in place as a column slice of a wider
    tensor (token stride 2C)."""
    from vivim_tpu_torch.kernels import dwconv3d as dk

    batch, T, H, W, C = case
    x, w, b, dy = _dw_inputs(cuda, case, seed=1)
    want_y, want = _dw_float64(x, w, b, dy, T, H, W)
    for rows in (None, 1, 2, 3):
        for vec in (None, 1):
            y = dk._fwd_launch(x, w, b, T, H, W, rows, vec)
            grads = dk._bwd_launch(x, dy, w, T, H, W, True, rows)
            torch.cuda.synchronize()
            _dw_check(y, grads, want_y, want, f"{case} rows {rows} vec "
                      f"{vec}")
    wide = torch.cat([x, torch.randn_like(x)], 2)
    xs = wide[..., :C]
    assert xs.stride(1) == 2 * C and xs.stride(2) == 1
    y = dk.dwconv3d_fwd_cuda(xs, w, b, T, H, W)
    grads = dk.dwconv3d_bwd_cuda(xs, dy, w, T, H, W)
    torch.cuda.synchronize()
    _dw_check(y, grads, want_y, want, f"{case} strided")


def test_dwconv3d_module_in_bf16(cuda):
    """``DWConv3d`` on bf16 tokens and a bf16 module: cast up, the kernels
    in fp32, cast back; y, dx and the weight and bias grads against
    float64 F.conv3d on the bf16 values."""
    from vivim_tpu_torch.kernels import dwconv3d as dk
    from vivim_tpu_torch.nn.layers import DWConv3d

    case = (3, 5, 16, 16, 1280)
    batch, T, H, W, C = case
    x, w, b, dy = _dw_inputs(cuda, case, seed=2)
    mod = DWConv3d(C).to(cuda)
    with torch.no_grad():
        mod.dwconv.weight.copy_(w)
        mod.dwconv.bias.copy_(b)
    mod = mod.to(torch.bfloat16)
    xb = x.to(torch.bfloat16).requires_grad_()
    c0 = (dk.LAUNCHES, dk.BWD_LAUNCHES)
    y = mod(xb, T, H, W)
    y.backward(dy.to(torch.bfloat16))
    assert (dk.LAUNCHES, dk.BWD_LAUNCHES) == (c0[0] + 1, c0[1] + 1)
    assert y.dtype == xb.grad.dtype == mod.dwconv.weight.grad.dtype \
        == torch.bfloat16
    conv = mod.dwconv
    want_y, want = _dw_float64(xb.detach(), conv.weight.detach().reshape(
        C, 1, 3, 3, 3), conv.bias.detach(), dy.to(torch.bfloat16), T, H, W)
    rtol, atol = TOL[torch.bfloat16]
    _dw_check(y, (xb.grad, conv.weight.grad, conv.bias.grad), want_y, want,
              "bf16", tol=dict(rtol=rtol, atol=atol), sum_tol=1e-2)


def test_dwconv3d_backward_is_deterministic(cuda):
    """dweight and dbias (and dx) are the same bits on two runs: the
    partials are summed in a fixed order, with no atomics."""
    from vivim_tpu_torch.kernels import dwconv3d as dk

    case = DW_STAGES[4]  # batch 3, stage 0
    batch, T, H, W, C = case
    x, w, _, dy = _dw_inputs(cuda, case, seed=3)
    first = dk.dwconv3d_bwd_cuda(x, dy, w, T, H, W)
    second = dk.dwconv3d_bwd_cuda(x, dy, w, T, H, W)
    torch.cuda.synchronize()
    for name, a, c in zip(("dx", "dweight", "dbias"), first, second):
        assert torch.equal(a, c), name


def test_dwconv3d_in_a_cuda_graph_counts_per_replay(cuda):
    """Eight ``DWConv3d`` forwards (two per Vivim-b3 serving stage)
    captured by ``cuda_graphs.capture``: the replay's outputs equal the
    eager ones bit for bit, and ``LAUNCHES`` counts 8 per warm-up call and
    per replay, none for the capture itself."""
    from vivim_tpu_torch.kernels import dwconv3d as dk
    from vivim_tpu_torch.nn.layers import DWConv3d
    from vivim_tpu_torch.utils import cuda_graphs

    stages = DW_STAGES[:4]
    mods = [DWConv3d(c[4]).to(cuda).eval() for c in stages for _ in (0, 1)]
    inputs = tuple(_dw_inputs(cuda, c, seed=4)[0] for c in stages)

    def run(*xs):
        return tuple(m(xs[i // 2], *stages[i // 2][1:4])
                     for i, m in enumerate(mods))

    with torch.inference_mode():
        eager = run(*inputs)
        c0 = dk.LAUNCHES
        graph = cuda_graphs.capture(run, tuple(x.clone() for x in inputs))
        assert dk.LAUNCHES - c0 == 8 * cuda_graphs.WARMUP_CALLS
        for k in range(3):
            got = graph(*inputs)
            assert dk.LAUNCHES - c0 == 8 * (cuda_graphs.WARMUP_CALLS + k + 1)
    torch.cuda.synchronize()
    for g, e in zip(got, eager):
        assert torch.equal(g, e)


def test_vivim_b3_step_conv_kernels_vs_cudnn(cuda, monkeypatch):
    """One fp32 step (forward, loss, backward) of MiT-b3 Vivim at its
    widths (5 x 64 px clips, batch 1, dropouts 0) with the conv kernels (8
    forward and 8 backward calls) and with the conv as cuDNN ran it before
    them (``F.conv3d`` in fp32, TF32 off, autograd through it): loss within
    1e-5 relative, every gradient within rtol 1e-3 / atol 2e-3."""
    from vivim_tpu_torch.cli.common import build_model
    from vivim_tpu_torch.kernels import dwconv3d as dk
    from vivim_tpu_torch.nn.layers import DWConv3d, init_weights, use_generator
    from vivim_tpu_torch.nn.vivim import Vivim
    from vivim_tpu_torch.train import loop
    from vivim_tpu_torch.train.losses import LOSSES

    args = type("Args", (), dict(segformer="b3", num_classes=3,
                                 with_edge=False))()
    _, cfg = build_model(args, device="cpu", seed=0)
    cfg = dataclasses.replace(
        cfg, drop_path_rate=0.0, dropout_rate=0.0,
        segformer=dataclasses.replace(cfg.segformer, drop_path_rate=0.0,
                                      classifier_dropout=0.0))
    rng = np.random.default_rng(7)
    clip = torch.from_numpy(rng.standard_normal(
        (1, 5, 64, 64, 3)).astype(np.float32)).to(cuda)
    masks = torch.from_numpy(np.eye(3, dtype=np.float32)[
        rng.integers(0, 3, (1, 5, 64, 64))]).to(cuda)
    out = []
    for cudnn in (False, True):
        if cudnn:
            monkeypatch.setattr(dk.DWConv3dFn, "apply", refs.dwconv3d_ref)
        model = init_weights(Vivim(cfg), torch.Generator().manual_seed(0))
        model = use_generator(model.to(cuda).train(),
                              torch.Generator(cuda).manual_seed(0))
        c0 = (dk.LAUNCHES, dk.BWD_LAUNCHES)
        logits, targets = loop.flatten_frames(model(clip), masks)
        loss = LOSSES["recall_focused"](logits, targets, 3)
        loss.backward()
        launched = (dk.LAUNCHES - c0[0], dk.BWD_LAUNCHES - c0[1])
        assert launched == ((0, 0) if cudnn else (8, 8))
        out.append((loss.item(), {n: p.grad for n, p in
                                  model.named_parameters()
                                  if p.grad is not None}))
    (loss_k, g_k), (loss_c, g_c) = out
    conv_grads = {f"{n}.dwconv.{k}" for n, m in model.named_modules()
                  if isinstance(m, DWConv3d) for k in ("weight", "bias")}
    assert abs(loss_k - loss_c) <= 1e-5 * abs(loss_c)
    assert set(g_k) == set(g_c) and len(conv_grads) == 16 \
        and conv_grads <= set(g_k)
    for n, g in g_k.items():
        torch.testing.assert_close(g, g_c[n], rtol=1e-3, atol=2e-3, msg=n)


def test_dwconv3d_refuses_what_the_kernels_do_not_take(cuda):
    """bf16 tokens (``DWConv3d`` casts them up first) and a weight of
    another shape raise before any launch."""
    from vivim_tpu_torch.kernels import dwconv3d as dk

    x, w, b, _ = _dw_inputs(cuda, (1, 2, 3, 4, 8))
    with pytest.raises(ValueError, match="fp32"):
        dk.dwconv3d_fwd_cuda(x.to(torch.bfloat16), w, b, 2, 3, 4)
    with pytest.raises(ValueError, match="weight"):
        dk.dwconv3d_fwd_cuda(x, w[:4], b, 2, 3, 4)


# the decode step's kernels (kernels/mamba_step.py): (batch, d_inner, N,
# activation dtype, ragged): mamba-130m's layer, Jamba's, ragged d and N,
# N from 1 to 256 (1 to 16 lanes a channel, 1 to 16 states a lane); a
# ragged case steps a state whose channel stride is N + 1
MS_CASES = [(1, 1536, 16, torch.float32, False),
            (8, 8192, 16, torch.bfloat16, False),
            (3, 160, 1, torch.float32, False),
            (3, 200, 12, torch.bfloat16, True),
            (2, 160, 16, torch.float32, True),
            (2, 96, 64, torch.float32, False),
            (3, 72, 200, torch.float32, True),
            (1, 96, 256, torch.float32, False)]


def _step_inputs(dev, batch, d, n, dtype, ragged=False, width=4, seed=0):
    """A mixer's step operands as ``mamba_step`` passes them: x and z the
    halves of an in_proj output, the conv weight viewed from (d, 1, W), B
    and C column views of an x_proj output (dt_rank 8 first)."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy(
        (scale * rng.standard_normal(s)).astype(np.float32)).to(dev)
    xz = f(batch, 2 * d).to(dtype)
    x_dbl = f(batch, 8 + 2 * n).to(dtype)
    state = f(batch, d, n + ragged)[..., ragged:]
    A_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=dev)).repeat(d, 1)
    conv = dict(x=xz[:, :d], conv_state=f(batch, width, d).to(dtype),
                weight=f(d, 1, width, scale=0.5).to(dtype)[:, 0, :].t(),
                bias=f(d, scale=0.1).to(dtype))
    ssm = dict(ssm_state=state, x=f(batch, d).to(dtype),
               dt=f(batch, d, scale=0.5).to(dtype), A_log=A_log.to(dtype),
               B=x_dbl[:, 8:8 + n], C=x_dbl[:, 8 + n:], D=f(d).to(dtype),
               z=xz[:, d:], dt_bias=f(d, scale=0.3).to(dtype))
    return conv, ssm


@pytest.mark.parametrize("case", MS_CASES, ids=str)
def test_mamba_step_kernels_match_plain_versions(cuda, case):
    """4 steps of each kernel against its plain version on copies of the
    states: the outputs within the file's tolerance, the conv window the
    same bits, the ssm state within the fp32 tolerance; one launch a
    call."""
    from vivim_tpu_torch.kernels import mamba_step as mk

    batch, d, n, dtype, ragged = case
    conv, ssm = _step_inputs(cuda, batch, d, n, dtype, ragged)
    plain_conv = dict(conv, conv_state=conv["conv_state"].clone())
    plain_ssm = dict(ssm, ssm_state=ssm["ssm_state"].clone())
    rtol, atol = TOL[dtype]
    for step in range(4):
        c0 = mk.LAUNCHES
        got = mk.conv_step(**conv), mk.ssm_step(**ssm)
        assert mk.LAUNCHES == c0 + 2
        want = mk.plain_conv_step(**plain_conv), mk.plain_ssm_step(
            **plain_ssm)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.dtype == dtype
            torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                       atol=atol, msg=f"step {step}")
        assert torch.equal(conv["conv_state"], plain_conv["conv_state"])
        torch.testing.assert_close(ssm["ssm_state"], plain_ssm["ssm_state"],
                                   rtol=TOL[torch.float32][0],
                                   atol=TOL[torch.float32][1])


@pytest.mark.parametrize("n", [16, 24])
def test_ssm_step_at_every_lane_count_matches_plain_version(cuda, n):
    """Each lane count the kernel takes (1 to 16 threads a channel, up to
    16 states a thread), forced past ``ssm_lanes``' pick."""
    from vivim_tpu_torch.kernels import mamba_step as mk

    _, ssm = _step_inputs(cuda, 3, 200, n, torch.float32, seed=3)
    want_state = ssm["ssm_state"].clone()
    want = mk.plain_ssm_step(**dict(ssm, ssm_state=want_state))
    rtol, atol = TOL[torch.float32]
    for lanes in (1, 2, 4, 8, 16):
        if -(-n // lanes) > mk.MAX_PER_LANE:
            continue
        state = ssm["ssm_state"].clone()
        got = mk._ssm_launch(**dict(ssm, ssm_state=state), lanes=lanes)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                                   msg=f"{lanes} lanes")
        torch.testing.assert_close(state, want_state, rtol=rtol, atol=atol,
                                   msg=f"{lanes} lanes, state")


@pytest.mark.parametrize("case", [(8, 8192, 128, 64, 1, torch.bfloat16),
                                  (3, 96, 16, 8, 2, torch.float32),
                                  (2, 120, 24, 4, 3, torch.bfloat16)],
                         ids=str)
def test_ssm_step_per_head_matches_plain_version(cuda, case):
    """``ssm_step`` of a Mamba-2 mixer, against its plain version over 4
    steps: dt, dt_bias, A_log and D per head of ``head_dim`` channels, B
    and C per group, read where they lie (column views of in_proj's output
    and of the conv's; A_log a (heads, N) view of (heads,)); Granite's (8,
    8192, 128) in bf16 with heads of 64 first."""
    from vivim_tpu_torch.kernels import mamba_step as mk

    batch, d, n, head_dim, groups, dtype = case
    heads, gn = d // head_dim, groups * n
    rng = np.random.default_rng(batch + n)
    f = lambda *s, scale=1.0: torch.from_numpy(
        (scale * rng.standard_normal(s)).astype(np.float32)).to(cuda)
    A_log = torch.log(1 + 15 * torch.rand(heads, device=cuda))
    kw = dict(A_log=A_log[:, None].expand(heads, n).to(dtype),
              D=f(heads).to(dtype), dt_bias=f(heads, scale=0.3).to(dtype),
              head_dim=head_dim, n_groups=groups)
    state = f(batch, d, n)
    want_state = state.clone()
    rtol, atol = TOL[dtype]
    for step in range(4):
        zxdt = f(batch, 2 * d + heads).to(dtype)
        xbc = f(batch, d + 2 * gn).to(dtype)
        t = dict(x=xbc[:, :d], B=xbc[:, d:d + gn], C=xbc[:, d + gn:],
                 z=zxdt[:, :d], dt=zxdt[:, 2 * d:], **kw)
        c0 = mk.LAUNCHES
        got = mk.ssm_step(state, **t)
        assert mk.LAUNCHES == c0 + 1
        want = mk.plain_ssm_step(want_state, **t)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol, msg=f"step {step}")
        torch.testing.assert_close(state, want_state,
                                   rtol=TOL[torch.float32][0],
                                   atol=TOL[torch.float32][1])


def test_mamba_step_kernels_in_a_cuda_graph_count_per_replay(cuda):
    """Both kernels captured by ``cuda_graphs.capture``: 2 launches per
    warm-up call and per replay, the replayed states and outputs those of
    eager calls on copies, bit for bit."""
    from vivim_tpu_torch.kernels import mamba_step as mk
    from vivim_tpu_torch.utils import cuda_graphs

    conv, ssm = _step_inputs(cuda, 1, 1536, 16, torch.float32)
    eager_conv = dict(conv, conv_state=conv["conv_state"].clone())
    eager_ssm = dict(ssm, ssm_state=ssm["ssm_state"].clone())

    def run(x):
        return mk.conv_step(**dict(conv, x=x)), mk.ssm_step(**ssm)

    with torch.inference_mode():
        c0 = mk.LAUNCHES
        graph = cuda_graphs.capture(run, (conv["x"].clone(),))
        assert mk.LAUNCHES - c0 == 2 * cuda_graphs.WARMUP_CALLS
        for _ in range(cuda_graphs.WARMUP_CALLS):   # what the warm-ups did
            mk.conv_step(**eager_conv), mk.ssm_step(**eager_ssm)
        c0 = mk.LAUNCHES
        for k in range(3):
            got = graph(conv["x"])
            want = mk.conv_step(**eager_conv), mk.ssm_step(**eager_ssm)
        assert mk.LAUNCHES - c0 == 3 * 2 + 3 * 2
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(conv["conv_state"], eager_conv["conv_state"])
    assert torch.equal(ssm["ssm_state"], eager_ssm["ssm_state"])


def test_lm_decode_graph_steps_through_the_kernels(cuda):
    """A replayed decode step of a 2-layer LM launches both kernels once a
    layer and equals the eager ``decode_step`` on copies of its states."""
    from vivim_tpu_torch.kernels import mamba_step as mk
    from vivim_tpu_torch.nn import lm
    from vivim_tpu_torch.nn.layers import init_weights

    model = init_weights(lm.MambaLM(lm.MambaLMConfig(
        vocab_size=50, d_model=64, n_layer=2)),
        torch.Generator().manual_seed(0)).to(cuda).eval()
    params = lm.lm_params(model)
    parts = lm.split_params(model, params)
    prompt = torch.ones(2, 5, dtype=torch.long, device=cuda)
    with torch.no_grad():
        _, states = lm.prefill(parts, prompt)
        step = lm.decode_graph(model, parts, params, states).start(states)
        for t in range(4):
            tok = torch.full((2,), t + 3, dtype=torch.long, device=cuda)
            c0 = mk.LAUNCHES
            got = step(tok)
            assert mk.LAUNCHES - c0 == 2 * 2
            want, states = lm.decode_step(parts, tok, states)
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    torch.cuda.synchronize()


def test_mamba_step_refuses_what_the_kernels_do_not_take(cuda):
    """fp64 activations, a bf16 ssm state and a state without unit d_state
    stride raise before any launch."""
    from vivim_tpu_torch.kernels import mamba_step as mk

    conv, ssm = _step_inputs(cuda, 2, 64, 16, torch.float32)
    c0 = mk.LAUNCHES
    with pytest.raises(ValueError, match="float64"):
        mk.conv_step(**dict(conv, x=conv["x"].double()))
    with pytest.raises(ValueError, match="ssm_state"):
        mk.ssm_step(**dict(ssm, ssm_state=ssm["ssm_state"].bfloat16()))
    with pytest.raises(ValueError, match="stride"):
        mk.ssm_step(**dict(ssm, ssm_state=ssm["ssm_state"].transpose(
            1, 2).contiguous().transpose(1, 2)))
    assert mk.LAUNCHES == c0


# the prefill MoE's combine (kernels/moe_combine.py): (tokens, experts, k, M,
# shared) Granite-like (top-10 of 12 with a shared expert) and Jamba-like
# (top-2 of 16, none) at ragged T, and top-4 and top-6 (the kernel's
# registers for 2, 4, 8 or 16 choices); M 36 in bf16 is no whole 16-byte
# vector a row, so it runs the kernel's one-value path
COMBINE_CASES = [(1, 12, 10, 64, True), (333, 12, 10, 256, True),
                 (129, 12, 10, 4096, True), (1000, 16, 2, 512, False),
                 (77, 16, 2, 36, False), (65, 8, 4, 128, True),
                 (31, 12, 6, 4096, False)]


def _combine_inputs(dev, tokens, experts, k, m, shared, dtype, seed=0,
                    offset=0):
    """The combine's operands as ``dropless_moe`` makes them (a random top
    k a token sorted by expert, ``pos`` the inverse of the sort,
    renormalised gates); ``offset`` elements shift ys off 16-byte
    alignment."""
    g = torch.Generator().manual_seed(seed)
    top, chosen = torch.topk(torch.randn(tokens, experts, generator=g), k)
    order = torch.argsort(chosen.reshape(-1), stable=True)
    pos = torch.empty(tokens * k, dtype=torch.int32)
    pos[order] = torch.arange(tokens * k, dtype=torch.int32)
    flat = torch.randn(offset + tokens * k * m, generator=g).to(dtype)
    ys = flat.to(dev)[offset:].view(tokens * k, m)
    sh = (torch.randn(tokens, m, generator=g).to(dtype).to(dev) if shared
          else None)
    return ys, pos.view(tokens, k).to(dev), torch.softmax(top, -1).to(dev), sh


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", COMBINE_CASES)
def test_moe_combine_kernel_matches_plain_version(cuda, case, dtype, offset):
    """Exact: the kernel takes the plain version's fp32 operations in its
    order (each product rounded, then added, j = 0 .. k-1, then the shared
    row; no fma) and rounds once, so the two are bit-equal.  ``offset`` 1
    takes the unaligned one-value path."""
    from vivim_tpu_torch.kernels import moe_combine as mc

    ops = _combine_inputs(cuda, *case, dtype, offset=offset)
    c0 = mc.LAUNCHES
    got = mc.moe_combine(*ops)
    assert mc.LAUNCHES == c0 + 1
    want = mc.plain_moe_combine(*ops)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)


def test_moe_combine_kernel_is_deterministic_and_allocates_only_out(cuda):
    """No atomics: two calls are bit-equal.  A call allocates its bf16
    output and nothing of fp32 (T k, M) or (T, M) size."""
    from vivim_tpu_torch.kernels import moe_combine as mc

    ops = _combine_inputs(cuda, 4096, 72, 10, 1024, True, torch.bfloat16)
    first = mc.moe_combine(*ops)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    second = mc.moe_combine(*ops)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    assert torch.equal(first, second)
    assert second.numel() * 2 <= grown < second.numel() * 2 + (1 << 20)


def test_dropless_block_on_the_card_vs_the_cpu(cuda):
    """The block with stacked top-3-of-8 experts and a shared expert, fp32:
    one combine launch, within 1e-5 of the CPU (the GEMMs' sums run in
    another order)."""
    from vivim_tpu_torch.kernels import moe_combine as mc
    from vivim_tpu_torch.nn import moe

    g = torch.Generator().manual_seed(3)
    m, f, e = 64, 48, 8
    r = lambda *s: torch.randn(*s, generator=g) / s[-1] ** 0.5
    params = {"router.weight": r(e, m), "input_linear.weight": r(e, 2 * f, m),
              "output_linear.weight": r(e, m, f),
              "shared.input_linear.weight": r(2 * f, m),
              "shared.output_linear.weight": r(m, f)}
    x = torch.randn(3, 41, m, generator=g)
    want = moe.dropless_moe(params, x, 3, renormalize=True)
    c0 = mc.LAUNCHES
    with torch.no_grad():
        got = moe.dropless_moe({k: v.to(cuda) for k, v in params.items()},
                               x.to(cuda), 3, renormalize=True)
    assert mc.LAUNCHES == c0 + 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


def test_moe_combine_refuses_what_the_kernel_does_not_take(cuda):
    """fp16 rows, a wrong shape, a pos out of range and a tensor that
    requires grad raise before any launch."""
    from vivim_tpu_torch.kernels import moe_combine as mc

    ys, pos, gates, sh = _combine_inputs(cuda, 9, 12, 10, 64, True,
                                         torch.bfloat16)
    c0 = mc.LAUNCHES
    with pytest.raises(ValueError, match="float16"):
        mc.moe_combine(ys.half(), pos, gates, sh.half())
    with pytest.raises(ValueError, match="rows"):
        mc.moe_combine(ys[:-1], pos, gates, sh)
    bad = pos.clone()
    bad[4, 9] = ys.shape[0]
    with pytest.raises(ValueError, match="pos in"):
        mc.moe_combine(ys, bad, gates, sh)
    with pytest.raises(ValueError, match="backward"):
        mc.moe_combine(ys, pos, gates.clone().requires_grad_(), sh)
    assert mc.LAUNCHES == c0


# Falcon-H1's parallel layer (nn/falcon_h1.py): a tiny config of the
# published keys, fp32 on the card, seeded by load_falcon_h1's own init
FALCON_TINY = {
    "attention_in_multiplier": 0.8, "attention_out_multiplier": 0.5,
    "embedding_multiplier": 2.5, "head_dim": 8, "hidden_size": 32,
    "intermediate_size": 48, "key_multiplier": 0.4,
    "lm_head_multiplier": 0.25, "mamba_d_conv": 4, "mamba_d_head": 8,
    "mamba_d_ssm": 64, "mamba_d_state": 16, "mamba_n_groups": 2,
    "mamba_n_heads": 8, "mamba_norm_before_gate": False,
    "mamba_rms_norm": True, "mlp_multipliers": [0.6, 0.7],
    "model_type": "falcon_h1", "num_attention_heads": 4,
    "num_hidden_layers": 2, "num_key_value_heads": 2, "rms_norm_eps": 1e-5,
    "rope_theta": 100, "ssm_in_multiplier": 0.5,
    "ssm_multipliers": [0.9, 0.8, 0.7, 1.3, 0.6], "ssm_out_multiplier": 0.3,
    "vocab_size": 64, "initializer_range": 0.2}


def _falcon(tmp_path, n_layer=2):
    import json

    from vivim_tpu_torch.nn import falcon_h1

    with open(tmp_path / "config.json", "w") as f:
        json.dump(dict(FALCON_TINY, num_hidden_layers=n_layer), f)
    return falcon_h1.load_falcon_h1(str(tmp_path), "cuda", seed=1)


def test_parallel_decode_graph_replays_equal_eager_decode(cuda, tmp_path):
    """The replayed step of the parallel layers (each layer's conv window,
    ssm state, K/V cache and position stepped in place) against the eager
    ``decode_step`` on the prefill's own states, 6 tokens: the same
    kernels in the same order, so fp32 agrees to 1e-5."""
    from vivim_tpu_torch.nn import lm

    model, params = _falcon(tmp_path)
    parts = lm.split_params(model, params)
    prompt = torch.arange(10, device=cuda).reshape(2, 5) % 64
    with torch.no_grad():
        _, states = lm.prefill(parts, prompt, max_len=11)
        step = lm.decode_graph(model, parts, params, states).start(states)
        for t in range(6):
            tok = torch.full((2,), t + 3, dtype=torch.long, device=cuda)
            got = step(tok)
            want, states = lm.decode_step(parts, tok, states)
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    dg = model._decoding_cache
    for g, w in zip(dg.states, states):
        for a, b in zip(g, w):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_rope_position_advances_inside_replays(cuda, tmp_path):
    """After k replays each layer's position is the prompt's length plus k,
    and the keys the replays wrote (rotated at their device-side
    positions) equal a prefill's over the served sequence to 1e-4 (fp32,
    the prefill's batched products against the step's)."""
    from vivim_tpu_torch.nn import lm

    model, params = _falcon(tmp_path)
    parts = lm.split_params(model, params)
    prompt = torch.arange(10, device=cuda).reshape(2, 5) % 64
    with torch.no_grad():
        out = lm.generate(model, params, prompt, 6, top_k=1)
        _, states = lm.prefill(parts, out, max_len=11)
    for (_, _, cache, pos), (_, _, want, want_pos) in zip(
            model._decoding_cache.states, states):
        assert int(pos) == int(want_pos) == 11
        torch.testing.assert_close(cache[:, :, :, 5:], want[:, :, :, 5:],
                                   rtol=0, atol=1e-4)


def test_falcon_decode_replay_launches_two_step_kernels_a_layer(cuda,
                                                               tmp_path):
    """18 parallel layers, as the benchmark's cut: 36 ``mamba_step``
    launches a replay (conv_step and ssm_step a Mamba-2 mixer)."""
    from vivim_tpu_torch.kernels import mamba_step as mk
    from vivim_tpu_torch.nn import lm

    model, params = _falcon(tmp_path, n_layer=18)
    parts = lm.split_params(model, params)
    prompt = torch.ones(2, 5, dtype=torch.long, device=cuda)
    with torch.no_grad():
        _, states = lm.prefill(parts, prompt, max_len=8)
        step = lm.decode_graph(model, parts, params, states).start(states)
        for t in range(3):
            c0 = mk.LAUNCHES
            step(torch.full((2,), t, dtype=torch.long, device=cuda))
            assert mk.LAUNCHES - c0 == 36
    torch.cuda.synchronize()
