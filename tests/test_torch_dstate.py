"""d_state other than 16 in the port, against the JAX package.

The CUDA kernels K1 (selective-scan forward, both variants) and K2
(backward) take d_state N from 1 to 256, as the Pallas kernels they replace
take any N.  On the CPU the port runs their plain versions, which these
tests hold against the JAX package at N in {1, 4, 8, 12, 32, 64, 256}
(powers of two, and 12 for a width the kernels mask), b = 2, L = 37 (three
16-step chunks, the last ragged), d = 24:

- K1's plain versions, ``refs.selective_scan_fwd_states_ref`` and the
  chunk-parallel ``refs.selective_scan_chunked_ref`` (both variants), against
  the Pallas forward ``_fwd_call`` in interpret mode (inference: y and the
  last state; training: the pre-gate y, the chunk-start states and the last
  state) and the JAX sequential ``refs.selective_scan_ref``;
- K2's plain versions, ``refs.selective_scan_bwd_ref`` and the
  segment-parallel ``refs.selective_scan_bwd_segmented_ref``, against
  ``jax.vjp`` of the JAX sequential reference;
- the port's ``selective_scan`` with constant (dim, dstate) B and C, alone,
  together and beside a grouped one (the routing the JAX package has: its
  sequential reference), forward and every gradient against ``jax.vjp`` of
  the JAX ``selective_scan``;
- ``MambaLM`` at d_state 8 and 64 (d_model 32, 2 layers): logits and every
  gradient against the JAX LM; ``MoEMambaLM`` at d_state 8: logits.

Inputs come from numpy seeds.  Tolerances are the JAX suite's
(tests/test_selective_scan.py): forward fp32 rtol 6e-4 / atol 2e-3, bf16
rtol 3e-2 / atol 5e-2, gradients rtol 1e-3 / atol 2e-3; the LMs as
tests/test_torch_lm_grad.py and tests/test_torch_moe.py hold them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_lm_helpers import make_pair, moe_pair, tokens
from vivim_tpu.kernels import refs as jrefs
from vivim_tpu.kernels.selective_scan import _fwd_call
from vivim_tpu.kernels.selective_scan import selective_scan as jscan
from vivim_tpu_torch.convert import from_jax
from vivim_tpu_torch.kernels import refs as trefs
from vivim_tpu_torch.kernels import selective_scan as tss

torch.set_num_threads(1)

NS = (1, 4, 8, 12, 32, 64, 256)
B, L, D = 2, 37, 24
TOL = {"float32": dict(rtol=6e-4, atol=2e-3),
       "bfloat16": dict(rtol=3e-2, atol=5e-2)}
GRAD_TOL = dict(rtol=1e-3, atol=2e-3)
GRADS = ("ddelta", "du", "dB", "dC", "dA", "dD", "dbias", "dh0")
VJP_NAMES = ("delta", "u", "B", "C", "A", "D", "delta_bias", "initial_state")


@functools.lru_cache(maxsize=None)
def _case(n):
    """numpy inputs at d_state n (shared A / D / bias, an initial state,
    dt near 0.3 so the state carried across the chunks counts), a
    cotangent of the output and of the last state."""
    rng = np.random.default_rng(n)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    inp = dict(u=f(B, L, D), delta=0.5 * f(B, L, D) - 1.0,
               A=-(0.5 + rng.random((D, n))).astype(np.float32),
               B=f(B, L, n), C=f(B, L, n), D=f(D), z=f(B, L, D),
               delta_bias=0.1 * f(D), initial_state=f(B, D, n))
    return inp, f(B, L, D), f(B, D, n)


def _t(inp, dtype="float32"):
    """The inputs as torch tensors, the sequences in ``dtype``."""
    seq = ("u", "delta", "B", "C", "z")
    return {k: torch.from_numpy(v).to(getattr(torch, dtype)) if k in seq
            else torch.from_numpy(v) for k, v in inp.items()}


def _j(inp, dtype="float32"):
    seq = ("u", "delta", "B", "C", "z")
    return {k: jnp.asarray(v).astype(dtype) if k in seq else jnp.asarray(v)
            for k, v in inp.items()}


def _close(got, want, tol, msg):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(
        got, torch.Tensor) else got, dtype=np.float32),
        np.asarray(want, dtype=np.float32), err_msg=msg, **tol)


@functools.lru_cache(maxsize=None)
def _pallas(n, dtype):
    """The Pallas forward in interpret mode: (inference y, last) with z,
    and (training y, chunk states in the port's (b, nk, d, N) layout,
    last) without."""
    inp, _, _ = _case(n)
    j = _j(inp, dtype)
    a = (j["u"], j["delta"], j["A"], j["B"], j["C"], j["D"])
    y, _, last = _fwd_call(*a, j["z"], j["delta_bias"], j["initial_state"],
                           True, tss.CHUNK, 128, save_cs=False)
    ty, cs, tlast = _fwd_call(*a, None, j["delta_bias"], j["initial_state"],
                              True, tss.CHUNK, 128, save_cs=True)
    cs = np.swapaxes(np.asarray(cs), 2, 3)[:, :, :D]
    return (np.asarray(y, np.float32), np.asarray(last)), (
        np.asarray(ty, np.float32), cs, np.asarray(tlast))


@pytest.mark.parametrize("dtype,n", [("float32", n) for n in NS]
                         + [("bfloat16", 64)])
def test_forward_plain_versions_match_pallas(n, dtype):
    """K1's two plain versions against the Pallas forward in interpret mode
    and the JAX sequential reference: the inference variant (y gated by
    silu(z), last state) and the training variant (pre-gate y, the state
    before every 16th step, last state), the chunk-parallel one at a
    parallel chunk of 16 (three chunks) and of 32 (two)."""
    inp, _, _ = _case(n)
    t = _t(inp, dtype)
    (py, plast), (ty, pcs, tlast) = _pallas(n, dtype)
    j = _j(inp, dtype)
    jy, jlast = jrefs.selective_scan_ref(
        j["u"], j["delta"], j["A"], j["B"], j["C"], j["D"], j["z"],
        j["delta_bias"], True, True, initial_state=j["initial_state"])
    tol = TOL[dtype]
    _close(py, jy, tol, "Pallas y vs the JAX reference")
    args = (t["u"], t["delta"], t["A"], t["B"], t["C"], t["D"])
    y, cs, last = trefs.selective_scan_fwd_states_ref(
        *args, t["delta_bias"], True, t["initial_state"], chunk=tss.CHUNK)
    assert tuple(cs.shape) == (B, -(-L // tss.CHUNK), D, n)
    for name, g, w in (("y", y, ty), ("chunk states", cs, pcs),
                       ("last", last, tlast)):
        _close(g, w, tol, f"fwd_states_ref {name}")
    for l_chunk in (16, 32):
        cy, clast = trefs.selective_scan_chunked_ref(
            *args, t["z"], t["delta_bias"], True, t["initial_state"],
            l_chunk=l_chunk, chunk=tss.CHUNK)
        _close(cy, py, tol, f"chunked y, Lc {l_chunk}")
        _close(cy, jy, tol, f"chunked y vs the JAX reference, Lc {l_chunk}")
        _close(clast, plast, tol, f"chunked last, Lc {l_chunk}")
        got = trefs.selective_scan_chunked_ref(
            *args, None, t["delta_bias"], True, t["initial_state"],
            l_chunk=l_chunk, chunk=tss.CHUNK, save_states=True)
        for name, g, w in zip(("y", "chunk states", "last"), got,
                              (ty, pcs, tlast)):
            _close(g, w, tol, f"chunked training {name}, Lc {l_chunk}")


@functools.lru_cache(maxsize=None)
def _jax_vjp(n):
    """jax.vjp of the JAX sequential reference (no z: the kernels' backward
    sees the pre-gate cotangent) at _case(n)."""
    inp, dout, dlast = _case(n)
    names = ("u", "delta", "A", "B", "C", "D", "delta_bias",
             "initial_state")

    def fn(u, delta, A, B_, C, D_, delta_bias, initial_state):
        return jrefs.selective_scan_ref(
            u, delta, A, B_, C, D=D_, delta_bias=delta_bias,
            delta_softplus=True, return_last_state=True,
            initial_state=initial_state)

    _, vjp = jax.vjp(fn, *[jnp.asarray(inp[k]) for k in names])
    grads = vjp((jnp.asarray(dout), jnp.asarray(dlast)))
    return {k: np.asarray(g) for k, g in zip(names, grads)}


@pytest.mark.parametrize("n", NS)
def test_backward_plain_versions_match_jax_vjp(n):
    """K2's two plain versions, on the chunk states of the plain
    K1-training, against jax.vjp of the sequential reference: all eight
    gradients (the shared parameters' per-row grads summed over the batch),
    the segment-parallel one at segments of 16 (three) and 32 (two)."""
    inp, dout, dlast = _case(n)
    t = _t(inp)
    args = (t["u"], t["delta"], t["A"], t["B"], t["C"], t["D"],
            t["delta_bias"])
    _, cs, _ = trefs.selective_scan_fwd_states_ref(
        *args, True, t["initial_state"], chunk=tss.CHUNK)
    want = _jax_vjp(n)
    runs = {"bwd_ref": trefs.selective_scan_bwd_ref(
        *args, cs, torch.from_numpy(dout), torch.from_numpy(dlast), True,
        chunk=tss.CHUNK)}
    for l_seg in (16, 32):
        runs[f"segmented Ls {l_seg}"] = trefs.selective_scan_bwd_segmented_ref(
            *args, cs, torch.from_numpy(dout), torch.from_numpy(dlast), True,
            l_seg=l_seg, chunk=tss.CHUNK)
    for run, got in runs.items():
        for name, vname, g in zip(GRADS, VJP_NAMES, got):
            g = g.numpy()
            if want[vname].shape != g.shape:  # shared parameter
                g = g.sum(0)
            np.testing.assert_allclose(g, want[vname], err_msg=f"{run} {name}",
                                       **GRAD_TOL)


CONSTANT_FORMS = ("constant B", "constant C", "constant B and C",
                  "constant B, grouped C", "grouped B, constant C")


def _const_inputs(form, n=8, seed=5):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    shapes = {"constant": (D, n), "variable": (B, L, n),
              "grouped": (B, L, 2, n)}
    kinds = {"constant B": ("constant", "variable"),
             "constant C": ("variable", "constant"),
             "constant B and C": ("constant", "constant"),
             "constant B, grouped C": ("constant", "grouped"),
             "grouped B, constant C": ("grouped", "constant")}[form]
    inp = dict(u=f(B, L, D), delta=0.5 * f(B, L, D) - 1.0,
               A=-(0.5 + rng.random((D, n))).astype(np.float32),
               B=f(*shapes[kinds[0]]), C=f(*shapes[kinds[1]]), D=f(D),
               z=f(B, L, D), delta_bias=0.1 * f(D),
               initial_state=f(B, D, n))
    return inp, f(B, L, D), f(B, D, n)


@pytest.mark.parametrize("form", CONSTANT_FORMS)
def test_constant_bc_matches_jax(form):
    """The port's selective_scan with constant (dim, dstate) B or C routes
    to the sequential plain version as the JAX package does (no kernel
    launch, one log line): output, last state and the gradients of all nine
    inputs against jax.vjp of the JAX ``selective_scan``."""
    inp, dout, dlast = _const_inputs(form)
    names = tuple(inp)

    def fn(u, delta, A, B_, C, D_, z, delta_bias, initial_state):
        return jscan(u, delta, A, B_, C, D=D_, z=z, delta_bias=delta_bias,
                     delta_softplus=True, return_last_state=True,
                     initial_state=initial_state)

    (jy, jlast), vjp = jax.vjp(fn, *[jnp.asarray(inp[k]) for k in names])
    want = dict(zip(names, vjp((jnp.asarray(dout), jnp.asarray(dlast)))))
    leaves = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in inp.items()}
    counts = (tss.LAUNCHES, tss.TRAIN_LAUNCHES, tss.BWD_LAUNCHES)
    kw = dict(leaves)
    y, last = tss.selective_scan(
        kw.pop("u"), kw.pop("delta"), kw.pop("A"), kw.pop("B"), kw.pop("C"),
        delta_softplus=True, return_last_state=True, **kw)
    torch.autograd.backward((y, last), (torch.from_numpy(dout),
                                        torch.from_numpy(dlast)))
    assert (tss.LAUNCHES, tss.TRAIN_LAUNCHES, tss.BWD_LAUNCHES) == counts
    _close(y.detach(), jy, TOL["float32"], f"{form} y")
    _close(last.detach(), jlast, TOL["float32"], f"{form} last")
    for k, v in leaves.items():
        _close(v.grad, want[k], GRAD_TOL, f"{form} d{k}")


def _lm_jax_grads(jmodel, params, toks):
    """((next-token loss, logits), grads) of the JAX LM, jitted."""
    def loss(p):
        logits = jmodel.apply({"params": p}, toks)
        logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), -1)
        return (-jnp.take_along_axis(logp, toks[:, 1:, None], -1).mean(),
                logits)

    return jax.jit(jax.value_and_grad(loss, has_aux=True))(params)


@pytest.mark.parametrize("d_state", [8, 64])
def test_mamba_lm_matches_jax(d_state):
    """``MambaLM`` at d_state 8 and 64 (d_model 32, 2 layers, RMSNorm):
    logits within 1e-4 of the JAX LM's, the next-token loss within 1e-6
    relative and every gradient within rtol 1e-4 / atol 1e-5 of
    ``jax.grad``'s (tests/test_torch_lm_grad.py's bounds)."""
    jmodel, params, tmodel = make_pair(seed=d_state, d_model=32,
                                       d_state=d_state, rms_norm=True)
    assert tmodel.cfg.d_state == d_state
    toks = tokens((2, 11), seed=d_state + 1)
    jt = jnp.asarray(toks)
    tt = torch.from_numpy(toks).long()
    logits = tmodel(tt)
    (value, jlogits), grads = _lm_jax_grads(jmodel, params, jt)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    want = from_jax.mamba_lm_state_dict_from_jax(grads, tmodel.cfg.n_layer)
    logp = torch.log_softmax(logits[:, :-1].float(), -1)
    loss = -logp.gather(-1, tt[:, 1:, None]).mean()
    np.testing.assert_allclose(loss.item(), float(value), rtol=1e-6)
    loss.backward()
    named = dict(tmodel.named_parameters())
    assert set(named) == set(want) - {"lm_head.weight"}
    for k, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_moe_mamba_lm_matches_jax_at_dstate_8():
    """``MoEMambaLM`` at d_state 8: logits and aux within 1e-4 of
    ``MoEMambaLM.apply`` (tests/test_torch_moe.py's bounds)."""
    cfg_kw = dict(vocab_size=40, d_model=16, n_layer=2, n_experts=4, d_ff=32,
                  d_state=8, rms_norm=True)
    jmodel, params, tmodel, cfg = moe_pair(cfg_kw)
    assert cfg.d_state == 8
    toks = np.random.default_rng(9).integers(0, 40, (2, 8)).astype(np.int32)
    logits_j, aux_j = jax.jit(lambda p, x: jmodel.apply({"params": p}, x))(
        params, jnp.asarray(toks))
    with torch.no_grad():
        logits_t, aux_t = tmodel(torch.from_numpy(toks).long())
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(aux_t.item(), float(aux_j), rtol=1e-4)
