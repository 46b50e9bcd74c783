"""The selective-scan backward's segment-parallel decomposition against JAX.

The CUDA backward kernel (K2) cuts L into segments of ``l_seg`` steps,
walks every segment but the first from a zero adjoint carry, chains the
segments right to left over exp(A * S_k), walks every segment's chunks from
its true carry, and sums the parameter-grad partials over the segments.
``refs.selective_scan_bwd_segmented_ref`` models those passes in plain
PyTorch; here it is held against ``jax.vjp`` of the JAX package's sequential
``refs.selective_scan_ref`` and, where d <= 128 (one Pallas d-tile; above
that the Pallas dB / dC are wrong, ROADMAP F1), against its Pallas backward
``_bwd_call`` in interpret mode (at L = 17 and 333), at the segment edges:
L in {1, 15, 16, 17, 64, 333} with l_seg in {16, 32, 64}, d = 24 with
shared A / D / bias and d = 160 with per-batch ones, softplus on, an
initial state and a non-zero last-state cotangent.  The wrapper's choice of l_seg is checked too.
Tolerances: grads rtol 1e-3 / atol 2e-3 (tests/test_selective_scan.py).
"""

import functools
import itertools

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

GRAD_TOL = dict(rtol=1e-3, atol=2e-3)
EDGES = list(itertools.product((1, 15, 16, 17, 64, 333), (16, 32, 64)))
NAMES = ("ddelta", "du", "dB", "dC", "dA", "dD", "dbias", "dh0")
# the JAX vjp's names for the same cotangents
VJP_NAMES = ("delta", "u", "B", "C", "A", "D", "delta_bias",
             "initial_state")


JAX_L = 333  # the length every JAX call runs at (the longest case)


@functools.lru_cache(maxsize=None)
def _case(L, d):
    """Inputs, cotangents and the JAX vjp for (L, d): d = 24 with shared
    parameters, d = 160 with per-batch ones.  dt near 0.05, so a segment's
    decay exp(A * S) is far from 0 and the carry shapes the next segment.

    So that JAX compiles one vjp per d, not one per L, it runs at JAX_L
    steps: the steps past L have delta = -200 (dt = softplus(-200 + bias)
    is 0 in fp32, so a = 1 and no input: the state passes through them
    unchanged and dlast reaches step L - 1 as it is), u, B, C and dout 0;
    they add exactly 0 to every parameter gradient, and the sequence
    gradients are cut back to L."""
    per_batch = d > 128
    b, n = 2, 16
    rng = np.random.default_rng(L * 3 + d)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    pb = (b,) if per_batch else ()
    inp = dict(u=f(b, L, d), delta=0.5 * f(b, L, d) - 3.0,
               A=-(0.5 + rng.random(pb + (d, n))).astype(np.float32),
               B=f(b, L, n), C=f(b, L, n), D=f(*pb, d),
               delta_bias=0.1 * f(*pb, d), initial_state=f(b, d, n))
    dout, dlast = f(b, L, d), f(b, d, n)

    def jfn(u, delta, A, B, C, D, delta_bias, initial_state):
        return jrefs.selective_scan_ref(
            u, delta, A, B, C, D=D, delta_bias=delta_bias,
            delta_softplus=True, return_last_state=True,
            initial_state=initial_state)

    names = ("u", "delta", "A", "B", "C", "D", "delta_bias",
             "initial_state")
    seq = ("u", "delta", "B", "C")
    pad = lambda x, v=0.0: np.pad(x, ((0, 0), (0, JAX_L - L), (0, 0)),
                                  constant_values=v)
    jin = {k: pad(v, -200.0 if k == "delta" else 0.0) if k in seq else v
           for k, v in inp.items()}
    _, vjp = jax.vjp(jfn, *[jnp.asarray(jin[k]) for k in names])
    grads = vjp((jnp.asarray(pad(dout)), jnp.asarray(dlast)))
    want = {k: np.asarray(g)[:, :L] if k in seq else np.asarray(g)
            for k, g in zip(names, grads)}
    return inp, dout, dlast, want


def _segmented(inp, cs, dout, dlast, l_seg):
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    return trefs.selective_scan_bwd_segmented_ref(
        t["u"], t["delta"], t["A"], t["B"], t["C"], t["D"], t["delta_bias"],
        cs, torch.from_numpy(dout), torch.from_numpy(dlast), True,
        l_seg=l_seg, chunk=tss.CHUNK)


@pytest.mark.parametrize("d", [24, 160])
@pytest.mark.parametrize("L,l_seg", EDGES)
def test_segmented_ref_matches_jax_vjp(L, l_seg, d):
    """All eight gradients, on the chunk states of the plain K1-training,
    against jax.vjp of the sequential scan (per-batch-row parameter grads
    summed over the batch where the parameter is shared)."""
    inp, dout, dlast, want = _case(L, d)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    _, cs, _ = trefs.selective_scan_fwd_states_ref(
        t["u"], t["delta"], t["A"], t["B"], t["C"], t["D"], t["delta_bias"],
        True, t["initial_state"], chunk=tss.CHUNK)
    got = _segmented(inp, cs, dout, dlast, l_seg)
    b = inp["u"].shape[0]
    for name, vname, g in zip(NAMES, VJP_NAMES, got):
        g = g.numpy()
        if want[vname].shape != g.shape:  # shared parameter
            assert g.shape[0] == b
            g = g.sum(0)
        np.testing.assert_allclose(g, want[vname], err_msg=name, **GRAD_TOL)


@functools.lru_cache(maxsize=None)
def _pallas(L):
    """The Pallas forward's chunk states and backward at d = 24 (one
    d-tile), on _case(L, 24)."""
    inp, dout, dlast, _ = _case(L, 24)
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    _, jcs, _ = _fwd_call(j["u"], j["delta"], j["A"], j["B"], j["C"],
                          j["D"], None, j["delta_bias"], j["initial_state"],
                          True, tss.CHUNK, 128, save_cs=True)
    want = _bwd_call(j["u"], j["delta"], j["A"], j["B"], j["C"], j["D"],
                     j["delta_bias"], jcs, jnp.asarray(dout),
                     jnp.asarray(dlast), True, tss.CHUNK, 128)
    # Pallas keeps the states as (b, nk, N, d_pad)
    cs = np.ascontiguousarray(np.swapaxes(np.asarray(jcs), 2, 3)[:, :, :24])
    return torch.from_numpy(cs), [np.asarray(w) for w in want]


@pytest.mark.parametrize("L,l_seg", [e for e in EDGES if e[0] in (17, 333)])
def test_segmented_ref_matches_pallas_bwd_call(L, l_seg):
    """Per-batch-row gradients against the Pallas backward in interpret
    mode, both on the Pallas forward's chunk states; at L = 17 (one
    segment edge at most) and L = 333 (up to 21 segments), since each
    interpret-mode run takes seconds."""
    inp, dout, dlast, _ = _case(L, 24)
    cs, want = _pallas(L)
    got = _segmented(inp, cs, dout, dlast, l_seg)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **GRAD_TOL)


def test_segmented_ref_and_grid_refuse_what_the_kernel_refuses():
    inp, dout, dlast, _ = _case(17, 24)
    cs = torch.zeros(2, 2, 24, 16)
    for l_seg in (0, 24):
        with pytest.raises(ValueError, match="multiple"):
            _segmented(inp, cs, dout, dlast, l_seg)
    for l_seg in (0, -16, 24):
        with pytest.raises(ValueError, match="multiple"):
            tss.bwd_grid(9, 333, 160, l_seg, 16)
    with pytest.raises(ValueError, match="segments"):
        tss.bwd_grid(1, 16 * (tss.MAX_SEGMENTS + 1), 16, 16, 16)


@pytest.mark.parametrize("batch,L,dim,want", [
    (9, 20480, 128, (2928, 7)), (9, 5120, 256, (1712, 3)),
    (9, 1280, 640, (1280, 1)), (9, 320, 1024, (320, 1)),
    (3, 20480, 128, None), (9, 333, 160, None), (1, 1, 8, (16, 1)),
    (2, 5_000_000, 16, None)])
def test_bwd_l_seg_fills_the_card_once(batch, L, dim, want):
    """l_seg is a multiple of CHUNK giving at most MAX_SEGMENTS segments;
    with more than one segment the grid fits on the card at once
    (BWD_BLOCKS_PER_SM blocks per SM), and it is the shortest such
    segment: one CHUNK shorter would take more blocks than fit (or exceed
    MAX_SEGMENTS).  On the card the channels per block come from the
    kernel's library (bwd_channels); here they are the 16 the kernel is
    built with.  At the four training stage shapes (scan batch 9) it
    cuts stages 0 and 1 into 7 and 3 segments and leaves 2 and 3 whole."""
    sms, channels = 132, 16
    slots = tss.BWD_BLOCKS_PER_SM * sms
    l_seg = tss.bwd_l_seg(batch, L, dim, sms, channels)
    tiles, segs, b = tss.bwd_grid(batch, L, dim, l_seg, channels)
    assert l_seg % tss.CHUNK == 0 and l_seg >= tss.CHUNK
    assert b == batch and tiles == -(-dim // channels)
    assert segs == max(1, -(-L // l_seg)) <= tss.MAX_SEGMENTS
    if segs > 1:
        assert tiles * segs * batch <= slots or segs == -(
            -L // tss.MAX_SEGMENTS)
    if l_seg > tss.CHUNK:
        shorter = -(-L // (l_seg - tss.CHUNK))
        assert (tiles * shorter * batch > slots
                or shorter > tss.MAX_SEGMENTS)
    if want is not None:
        assert (l_seg, segs) == want
