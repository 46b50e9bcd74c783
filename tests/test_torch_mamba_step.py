"""The decode step's in-place kernels (``kernels/mamba_step.py``) on the
CPU: their plain versions against the decode refs and against a float64
model of the CUDA kernels' per-channel loops, ``nn.streaming.mamba_step``
against the JAX package's functional step and against the prefill, the
in-place contract, and a ``DecodeGraph`` step that copies no state.

The CUDA kernels themselves run in ``tests/test_torch_cuda.py`` (marked
``cuda``) and ``chip_smoke.py``.  Tolerances: fp32 rtol 1e-5 / atol 1e-6
where the same fp32 math runs in another order, 1e-3 / 1e-4 against the
JAX package (tests/test_torch_streaming.py's), bf16 rtol 2e-2 / atol 2e-2
(one bf16 rounding of outputs of order 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vivim_tpu.nn import streaming as jstream
from vivim_tpu.nn.mamba import MambaV3 as JMambaV3
from vivim_tpu_torch.convert import from_jax
from vivim_tpu_torch.kernels import mamba_step as mk
from vivim_tpu_torch.kernels import refs
from vivim_tpu_torch.nn import lm as tlm
from vivim_tpu_torch.nn.layers import init_weights
from vivim_tpu_torch.nn import streaming as tstream

torch.set_num_threads(1)

TOL = {torch.float32: (1e-5, 1e-6), torch.bfloat16: (2e-2, 2e-2)}
DIM, WIDTH = 24, 4


def _f(rng, *shape, scale=1.0):
    return torch.from_numpy(
        (scale * rng.standard_normal(shape)).astype(np.float32))


def _close(got, want, dtype):
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def _conv_inputs(rng, batch, dtype):
    """x as the x half of an in_proj output (a strided column view), the
    window, the (W, d) weight as the mixer's (d, 1, W) conv weight viewed,
    and the bias."""
    xz = _f(rng, 8, batch, 2 * DIM).to(dtype)
    conv1d = _f(rng, DIM, 1, WIDTH, scale=0.5).to(dtype)
    return ([xz[t, :, :DIM] for t in range(8)],
            _f(rng, batch, WIDTH, DIM).to(dtype), conv1d[:, 0, :].t(),
            _f(rng, DIM, scale=0.1).to(dtype))


def conv_model(x, window, weight, bias):
    """The conv kernel's loop in float64: slot by slot, each slot read
    before the one below it is written; returns (out, window)."""
    w = window.double().clone()
    acc = torch.zeros(x.shape, dtype=torch.float64)
    for k in range(w.shape[1] - 1):
        w[:, k] = w[:, k + 1]
        acc += w[:, k] * weight[k].double()
    w[:, -1] = x.double()
    acc += w[:, -1] * weight[-1].double() + bias.double()
    return acc * torch.sigmoid(acc), w


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_conv_step_matches_refs_over_steps(batch, dtype):
    rng = np.random.default_rng(batch)
    xs, window, weight, bias = _conv_inputs(rng, batch, dtype)
    want_state, model_state = window.clone(), window.clone()
    for x in xs:
        got = mk.conv_step(x, window, weight, bias)
        want, want_state = refs.causal_conv1d_update_ref(
            x, want_state, weight, bias, "silu")
        model, model_state = conv_model(x, model_state, weight, bias)
        assert got.dtype == dtype and got.is_contiguous()
        # the window only moves values: the same bits as the ref's
        assert torch.equal(window, want_state)
        assert torch.equal(window.double(), model_state)
        _close(got, want, dtype)
        _close(got, model, dtype)


def _ssm_inputs(rng, batch, n, dtype):
    """The step's operands as the mixer passes them: x and dt contiguous, z
    the z half of an in_proj output, B and C column views of an x_proj
    output (dt_rank 3 columns first), A_log, D and dt_bias."""
    xz = _f(rng, batch, 2 * DIM).to(dtype)
    x_dbl = _f(rng, batch, 3 + 2 * n).to(dtype)
    A_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32)).repeat(
        DIM, 1) + _f(rng, DIM, n, scale=0.1)
    return dict(x=_f(rng, batch, DIM).to(dtype),
                dt=_f(rng, batch, DIM, scale=0.5).to(dtype),
                A_log=A_log.to(dtype), B=x_dbl[:, 3:3 + n],
                C=x_dbl[:, 3 + n:], D=_f(rng, DIM).to(dtype),
                z=xz[:, DIM:], dt_bias=_f(rng, DIM, scale=0.3).to(dtype))


def ssm_model(state, x, dt, A_log, B, C, D, z, dt_bias):
    """The ssm kernel's per-channel loop in float64: softplus at threshold
    20, A = -exp(A_log), the state walked over n; returns (out, state)."""
    d = lambda t: t.double()
    dt = d(dt) + d(dt_bias)
    dt = torch.where(dt > 20, dt, torch.log1p(torch.exp(dt)))
    s = d(state).clone()
    y = torch.zeros(x.shape, dtype=torch.float64)
    for n in range(s.shape[2]):
        a = -torch.exp(d(A_log[:, n]))
        s[:, :, n] = (s[:, :, n] * torch.exp(dt * a)
                      + (dt * d(B[:, n])[:, None]) * d(x))
        y += s[:, :, n] * d(C[:, n])[:, None]
    y = (y + d(D) * d(x)) * d(z) * torch.sigmoid(d(z))
    return y, s


@pytest.mark.parametrize("n", [1, 16, 64])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_ssm_step_matches_refs_over_steps(dtype, batch, n):
    rng = np.random.default_rng(10 * n + batch)
    state = _f(rng, batch, DIM, n)
    want_state, model_state = state.clone(), state.clone()
    for _ in range(5):
        t = _ssm_inputs(rng, batch, n, dtype)
        got = mk.ssm_step(state, **t)
        A = -torch.exp(t["A_log"].float())
        want, want_state = refs.selective_state_update_ref(
            want_state, t["x"], t["dt"], A, t["B"], t["C"],
            D=t["D"].float(), z=t["z"], dt_bias=t["dt_bias"].float(),
            dt_softplus=True)
        model, model_state = ssm_model(model_state, **t)
        assert got.dtype == dtype and state.dtype == torch.float32
        assert torch.equal(state, want_state)
        torch.testing.assert_close(state.double(), model_state, rtol=1e-5,
                                   atol=1e-6)
        _close(got, want, torch.float32)
        _close(got, model, dtype)


def test_ssm_step_softplus_threshold():
    """dt + bias above 20 passes through, as F.softplus's threshold."""
    rng = np.random.default_rng(2)
    t = _ssm_inputs(rng, 1, 4, torch.float32)
    t["dt"] = torch.full((1, DIM), 19.0)
    t["dt_bias"] = torch.linspace(-2.0, 2.0, DIM)
    state = _f(rng, 1, DIM, 4)
    model, model_state = ssm_model(state.clone(), **t)
    got = mk.ssm_step(state, **t)
    torch.testing.assert_close(state.double(), model_state, rtol=1e-5,
                               atol=1e-6)
    _close(got, model, torch.float32)


@pytest.mark.parametrize("shape,want", [
    ((1, 1536, 1), (1, 1)), ((1, 1536, 3), (4, 1)), ((1, 1536, 12), (16, 1)),
    ((1, 1536, 16), (16, 1)), ((1, 1536, 64), (16, 4)),
    ((1, 96, 200), (16, 13)), ((1, 1536, 256), (16, 16)),
    ((8, 1536, 16), (4, 4)), ((1, 8192, 16), (8, 2)),
    ((8, 8192, 16), (2, 8)), ((32, 8192, 16), (2, 8)),
    ((8, 8192, 256), (16, 16)), ((64, 8192, 64), (4, 16))])
def test_ssm_lanes_cover_d_state(shape, want):
    """Lanes a channel, fewer where the grid fills the card; the states of
    a channel covered, at most 16 a lane."""
    n = shape[2]
    lanes, per_lane = mk.ssm_lanes(*shape)
    assert (lanes, per_lane) == want
    assert lanes * per_lane >= n > lanes * (per_lane - 1)
    assert per_lane <= mk.MAX_PER_LANE and lanes & (lanes - 1) == 0


@pytest.fixture(scope="module")
def mixer():
    """(JAX params of a single-direction mixer, the port's mixer dict)."""
    m = JMambaV3(d_model=16, bimamba_type="none", scan_implementation="ref")
    params = m.init(jax.random.PRNGKey(1), jnp.zeros((2, 12, 16)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(3)
    params["dt_proj_bias"] = params["dt_proj_bias"] + rng.normal(
        0, 0.3, params["dt_proj_bias"].shape).astype(np.float32)
    params["D"] = rng.normal(1, 0.5, params["D"].shape).astype(np.float32)
    return params, from_jax.mamba_state_dict_from_jax(params)


def test_mamba_step_matches_jax_over_8_tokens(mixer):
    params, sd = mixer
    rng = np.random.default_rng(4)
    xs = rng.standard_normal((8, 2, 16)).astype(np.float32)
    cs = rng.standard_normal((2, 4, 32)).astype(np.float32)
    ss = rng.standard_normal((2, 32, 16)).astype(np.float32)
    jcs, jss = jnp.asarray(cs), jnp.asarray(ss)
    tcs, tss = torch.tensor(cs), torch.tensor(ss)
    for x in xs:
        want, jcs, jss = jstream.mamba_step(params, jnp.asarray(x), jcs, jss)
        got, tcs, tss = tstream.mamba_step(sd, torch.tensor(x), tcs, tss)
        for g, w in ((got, want), (tcs, jcs), (tss, jss)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                       atol=1e-4)


def test_mamba_step_steps_the_given_states_in_place(mixer):
    """The returned states are the given tensors, moved to what a step on
    copies of them returns."""
    _, sd = mixer
    rng = np.random.default_rng(5)
    x, cs, ss = _f(rng, 2, 16), _f(rng, 2, 4, 32), _f(rng, 2, 32, 16)
    before = cs.clone(), ss.clone()
    want_out, want_cs, want_ss = tstream.mamba_step(sd, x, cs.clone(),
                                                    ss.clone())
    out, got_cs, got_ss = tstream.mamba_step(sd, x, cs, ss)
    assert got_cs is cs and got_ss is ss
    assert not torch.equal(cs, before[0]) and not torch.equal(ss, before[1])
    assert torch.equal(cs[:, :-1], before[0][:, 1:])
    for g, w in ((out, want_out), (cs, want_cs), (ss, want_ss)):
        assert torch.equal(g, w)


def _jamba_mixer(rng, d_model=16, n=16, dt_rank=4, width=4):
    """A mixer dict with Jamba's dt / B / C RMSNorm weights."""
    d_inner = 2 * d_model
    return {
        "in_proj.weight": _f(rng, 2 * d_inner, d_model, scale=0.3),
        "conv1d.weight": _f(rng, d_inner, 1, width, scale=0.5),
        "conv1d.bias": _f(rng, d_inner, scale=0.1),
        "x_proj.weight": _f(rng, dt_rank + 2 * n, d_inner, scale=0.3),
        "dt_proj.weight": _f(rng, d_inner, dt_rank, scale=0.3),
        "dt_proj.bias": _f(rng, d_inner, scale=0.3) - 1.0,
        "A_log": torch.log(torch.arange(1, n + 1, dtype=torch.float32)
                           ).repeat(d_inner, 1),
        "D": _f(rng, d_inner, scale=0.5) + 1.0,
        "out_proj.weight": _f(rng, d_model, d_inner, scale=0.3),
        "dt_layernorm.weight": 1.0 + _f(rng, dt_rank, scale=0.2),
        "b_layernorm.weight": 1.0 + _f(rng, n, scale=0.2),
        "c_layernorm.weight": 1.0 + _f(rng, n, scale=0.2),
    }


def test_jamba_norm_mixer_steps_equal_its_prefill():
    """Prefill 6 tokens, step 4: the outputs and both states of a prefill
    over all 10."""
    rng = np.random.default_rng(6)
    mp = _jamba_mixer(rng)
    x = _f(rng, 3, 10, 16)
    with torch.no_grad():
        full, full_cs, full_ss = tstream.mamba_prefill(mp, x)
        _, cs, ss = tstream.mamba_prefill(mp, x[:, :6])
        outs = [tstream.mamba_step(mp, x[:, t], cs, ss)[0]
                for t in range(6, 10)]
    torch.testing.assert_close(torch.stack(outs, 1), full[:, 6:], rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(cs, full_cs, rtol=0, atol=0)
    torch.testing.assert_close(ss, full_ss, rtol=1e-4, atol=1e-5)


class _StateCopies(TorchDispatchMode):
    """Records the destination of every ``copy_`` and whether it ran
    inside the step's kernel wrappers."""

    def __init__(self):
        super().__init__()
        self.inside = 0
        self.copies = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.copy_.default:
            self.copies.append((args[0].data_ptr(), self.inside > 0))
        return func(*args, **(kwargs or {}))


def test_decode_graph_step_copies_no_state(monkeypatch):
    """On the CPU the only writes into the decode graph's states are the
    plain kernels' own, one per kernel: the step hands nothing back to
    copy, and returns the graph's own state tensors."""
    cfg = tlm.MambaLMConfig(vocab_size=50, d_model=16, n_layer=2)
    model = init_weights(tlm.MambaLM(cfg),
                         torch.Generator().manual_seed(0)).eval()
    params = tlm.lm_params(model)
    parts = tlm.split_params(model, params)
    prompt = torch.randint(0, 50, (2, 5))
    mode = _StateCopies()

    def inside(fn):
        def wrapped(*a, **k):
            mode.inside += 1
            try:
                return fn(*a, **k)
            finally:
                mode.inside -= 1
        return wrapped

    monkeypatch.setattr(tstream, "conv_step", inside(mk.conv_step))
    monkeypatch.setattr(tstream, "ssm_step", inside(mk.ssm_step))
    seen = []
    real = tlm.decode_step

    def recording(parts, token, states, mixer_step=None):
        out = real(parts, token, states, mixer_step)
        seen.append((states, out[1]))
        return out
    monkeypatch.setattr(tlm, "decode_step", recording)
    flat = lambda records: [t for r in records for t in r]
    with torch.no_grad():
        _, states = tlm.prefill(parts, prompt)
        dg = tlm.decode_graph(model, parts, params, states)
        step = dg.start(states)
        before = [s.clone() for s in flat(dg.states)]
        with mode:
            step(torch.tensor([3, 4]))
    graph_states = flat(dg.states)
    ptrs = {s.data_ptr() for s in graph_states}
    into_states = [(p, k) for p, k in mode.copies if p in ptrs]
    assert into_states and all(k for _, k in into_states)
    assert len(into_states) == 2 * cfg.n_layer
    given, returned = seen[-1]
    assert all(a is b for a, b in zip(flat(returned), graph_states))
    assert all(a is b for a, b in zip(flat(given), graph_states))
    assert all(s.isfinite().all() and not torch.equal(a, s)
               for a, s in zip(before, graph_states))


def _ok_ssm(rng):
    t = _ssm_inputs(rng, 2, 8, torch.float32)
    return _f(rng, 2, DIM, 8), t


@pytest.mark.parametrize("case", [
    "conv x float64", "conv state float16", "conv weight shape",
    "conv x rank", "conv device", "conv width 9",
    "ssm state bf16", "ssm state layout", "ssm x int", "ssm B shape",
    "ssm dstate 257",
])
def test_wrappers_refuse_what_the_kernels_do_not_take(case):
    rng = np.random.default_rng(7)
    xs, window, weight, bias = _conv_inputs(rng, 2, torch.float32)
    state, t = _ok_ssm(rng)
    kind = case.split()[0]
    if case == "conv x float64":
        xs[0] = xs[0].double()
    elif case == "conv state float16":
        window = window.half()
    elif case == "conv weight shape":
        weight = weight[:, :-1]
    elif case == "conv x rank":
        xs[0] = xs[0][:, None]
    elif case == "conv device":
        bias = torch.empty(DIM, device="meta")
    elif case == "conv width 9":
        window = torch.zeros(2, 9, DIM)
        weight = torch.zeros(9, DIM)
    elif case == "ssm state bf16":
        state = state.bfloat16()
    elif case == "ssm state layout":
        state = state.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "ssm x int":
        t["x"] = t["x"].int()
    elif case == "ssm B shape":
        t["B"] = t["B"][:, :-1]
    elif case == "ssm dstate 257":
        state = torch.zeros(2, DIM, 257)
        t["A_log"], t["B"], t["C"] = (torch.zeros(DIM, 257),
                                      torch.zeros(2, 257),
                                      torch.zeros(2, 257))
    before = window.clone() if kind == "conv" else state.clone()
    with pytest.raises(ValueError):
        if kind == "conv":
            mk.conv_step(xs[0], window, weight, bias)
        else:
            mk.ssm_step(state, **t)
    assert torch.equal(window if kind == "conv" else state, before)
