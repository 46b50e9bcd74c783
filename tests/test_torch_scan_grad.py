"""Gradients of the PyTorch port's selective scan against the JAX package.

On CPU tensors ``selective_scan`` runs ``SelectiveScanFn`` with the plain
versions of the two kernels it launches on the card
(``refs.selective_scan_fwd_states_ref`` for K1's training variant,
``refs.selective_scan_bwd_ref`` for K2), so these tests exercise the
autograd glue the card runs.  The oracle for gradients is ``jax.vjp`` of
the JAX package's sequential ``refs.selective_scan_ref``; the two plain
kernel versions are also held against the JAX package's Pallas calls
``_fwd_call(save_cs=True)`` and ``_bwd_call`` in interpret mode.  The
Pallas backward is held only where d <= 128: with more than one d-tile its
dB and dC are wrong (ROADMAP F1).  Tolerances: forward fp32 rtol 6e-4 /
atol 2e-3, grads rtol 1e-3 / atol 2e-3 (tests/test_selective_scan.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivim_tpu.kernels import refs as jrefs
from vivim_tpu.kernels.selective_scan import _bwd_call, _fwd_call
from vivim_tpu_torch.kernels import refs as trefs
from vivim_tpu_torch.kernels import selective_scan as tss

torch.set_num_threads(1)

NAMES = ("u", "delta", "A", "B", "C", "D", "z", "delta_bias",
         "initial_state")
GRAD_TOL = dict(rtol=1e-3, atol=2e-3)


def _inputs(seed, b, L, d, n=16, per_batch=False, has_z=True, h0=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    pb = (b,) if per_batch else ()
    return dict(
        u=f(b, L, d), delta=0.5 * f(b, L, d),
        A=-(0.5 + rng.random(pb + (d, n))).astype(np.float32),
        B=f(b, L, n), C=f(b, L, n), D=f(*pb, d),
        z=f(b, L, d) if has_z else None,
        delta_bias=0.1 * f(*pb, d),
        initial_state=f(b, d, n) if h0 else None)


GRAD_CASES = {
    # name: (input kwargs, seed the last state's cotangent)
    "z_shared": (dict(b=2, L=40, d=8, n=4), False),
    "no_z_per_batch": (dict(b=2, L=37, d=12, per_batch=True,
                            has_z=False), False),
    "h0_dlast_ragged": (dict(b=2, L=45, d=8, n=8, h0=True), True),
    "d160_h0_dlast": (dict(b=2, L=50, d=160, per_batch=True, h0=True),
                      True),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_function_grads_match_jax_vjp(case):
    """All nine cotangents of the Function (on the CPU: the plain kernel
    versions) against jax.vjp of the JAX sequential reference."""
    kw, with_dlast = GRAD_CASES[case]
    inp = _inputs(sorted(GRAD_CASES).index(case), **kw)
    rng = np.random.default_rng(99)
    b, L, d = inp["u"].shape
    n = inp["A"].shape[-1]
    dout = rng.standard_normal((b, L, d)).astype(np.float32)
    dlast = (rng.standard_normal((b, d, n)).astype(np.float32)
             if with_dlast else np.zeros((b, d, n), np.float32))
    present = [k for k in NAMES if inp[k] is not None]

    def jfn(*args):
        kw_ = dict(zip(present, args))
        return jrefs.selective_scan_ref(
            kw_.pop("u"), kw_.pop("delta"), kw_.pop("A"), kw_.pop("B"),
            kw_.pop("C"), delta_softplus=True, return_last_state=True, **kw_)

    (jy, jlast), vjp = jax.vjp(jfn, *[jnp.asarray(inp[k]) for k in present])
    want = dict(zip(present, vjp((jnp.asarray(dout), jnp.asarray(dlast)))))

    t = {k: torch.from_numpy(inp[k]).requires_grad_(True) for k in present}
    args = {k: t.get(k) for k in NAMES}
    y, last = tss.selective_scan(
        args.pop("u"), args.pop("delta"), args.pop("A"), args.pop("B"),
        args.pop("C"), delta_softplus=True, return_last_state=True, **args)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=6e-4, atol=2e-3)
    np.testing.assert_allclose(last.detach().numpy(), np.asarray(jlast),
                               rtol=6e-4, atol=2e-3)
    torch.autograd.backward(
        (y, last), (torch.from_numpy(dout), torch.from_numpy(dlast)))
    for k in present:
        np.testing.assert_allclose(t[k].grad.numpy(), np.asarray(want[k]),
                                   err_msg=k, **GRAD_TOL)


def test_ref_path_still_differentiates_through_the_sequential_scan():
    """implementation="ref" keeps autograd through selective_scan_ref (no
    Function): same grads as the Function within the grad tolerance."""
    inp = _inputs(7, b=2, L=30, d=8, n=4)
    grads = []
    for impl in (None, "ref"):
        t = {k: torch.from_numpy(v).requires_grad_(True)
             for k, v in inp.items() if v is not None}
        y = tss.selective_scan(t["u"], t["delta"], t["A"], t["B"], t["C"],
                               D=t["D"], z=t["z"],
                               delta_bias=t["delta_bias"],
                               delta_softplus=True, implementation=impl)
        assert (y.grad_fn.name() == "SelectiveScanFnBackward"
                ) == (impl is None)
        (y * y).sum().backward()
        grads.append({k: v.grad for k, v in t.items()})
    for k in grads[0]:
        np.testing.assert_allclose(grads[0][k].numpy(), grads[1][k].numpy(),
                                   err_msg=k, **GRAD_TOL)


def _jax_kernel_layout(cs):
    """(b, nk, N, d_pad) Pallas chunk states -> the port's (b, nk, d, N)."""
    return np.swapaxes(np.asarray(cs), 2, 3)


@pytest.mark.parametrize("L,d", [(64, 24), (45, 160)])
def test_fwd_states_ref_matches_pallas_save_cs(L, d):
    inp = _inputs(3, b=2, L=L, d=d, per_batch=True, h0=True)
    chunk = tss.CHUNK
    j = {k: jnp.asarray(v) for k, v in inp.items() if v is not None}
    jy, jcs, jlast = _fwd_call(j["u"], j["delta"], j["A"], j["B"], j["C"],
                               j["D"], None, j["delta_bias"],
                               j["initial_state"], True, chunk, 128,
                               save_cs=True)
    t = {k: torch.from_numpy(v) for k, v in inp.items() if v is not None}
    y, cs, last = trefs.selective_scan_fwd_states_ref(
        t["u"], t["delta"], t["A"], t["B"], t["C"], t["D"],
        t["delta_bias"], True, t["initial_state"], chunk=chunk)
    assert tuple(cs.shape) == (2, -(-L // chunk), d, 16)
    tol = dict(rtol=6e-4, atol=2e-3)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **tol)
    np.testing.assert_allclose(cs.numpy(), _jax_kernel_layout(jcs)[:, :, :d],
                               **tol)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **tol)


@pytest.mark.parametrize("per_batch", [False, True])
def test_bwd_ref_matches_pallas_bwd_call(per_batch):
    """d <= 128 only: one Pallas d-tile, where its dB / dC are right."""
    inp = _inputs(4, b=2, L=50, d=24, per_batch=per_batch, h0=True)
    rng = np.random.default_rng(5)
    dout = rng.standard_normal(inp["u"].shape).astype(np.float32)
    dlast = rng.standard_normal(inp["initial_state"].shape).astype(
        np.float32)
    chunk = tss.CHUNK
    j = {k: jnp.asarray(v) for k, v in inp.items() if v is not None}
    _, jcs, _ = _fwd_call(j["u"], j["delta"], j["A"], j["B"], j["C"],
                          j["D"], None, j["delta_bias"], j["initial_state"],
                          True, chunk, 128, save_cs=True)
    want = _bwd_call(j["u"], j["delta"], j["A"], j["B"], j["C"], j["D"],
                     j["delta_bias"], jcs, jnp.asarray(dout),
                     jnp.asarray(dlast), True, chunk, 128)
    t = {k: torch.from_numpy(v) for k, v in inp.items() if v is not None}
    cs = torch.from_numpy(np.ascontiguousarray(
        _jax_kernel_layout(jcs)[:, :, :24]))
    got = trefs.selective_scan_bwd_ref(
        t["u"], t["delta"], t["A"], t["B"], t["C"], t["D"], t["delta_bias"],
        cs, torch.from_numpy(dout), torch.from_numpy(dlast), True,
        chunk=chunk)
    names = ("ddelta", "du", "dB", "dC", "dA", "dD", "dbias", "dh0")
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **GRAD_TOL)
