"""The selective-scan forward's chunk-parallel decomposition against JAX.

The CUDA forward kernel (K1) cuts L into chunks of ``l_chunk`` steps, scans
every chunk from a zero state, carries the chunks' end states over
exp(A * S_k), and re-walks every chunk from its true start state.
``refs.selective_scan_chunked_ref`` models those passes in plain PyTorch;
here it is held against the JAX package's sequential
``refs.selective_scan_ref`` (output and last state, gated by silu(z)) and
against its Pallas forward ``_fwd_call(save_cs=True)`` in interpret mode
(output, 16-step chunk-start states, last state), at the chunk edges: L in
{1, 15, 16, 17, 333} with l_chunk in {16, 64}, ragged d (24, 160), with
and without an initial state, shared and per-batch A / D / bias.  The
wrapper's choice of l_chunk is checked too.  Tolerances: fp32 rtol 6e-4 /
atol 2e-3 (tests/test_selective_scan.py).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivim_tpu.kernels import refs as jrefs
from vivim_tpu.kernels.selective_scan import _fwd_call
from vivim_tpu_torch.kernels import refs as trefs
from vivim_tpu_torch.kernels import selective_scan as tss

torch.set_num_threads(1)

TOL = dict(rtol=6e-4, atol=2e-3)
EDGES = list(itertools.product((1, 15, 16, 17, 333), (16, 64)))


def _inputs(seed, b, L, d, per_batch, h0, n=16):
    """dt = softplus(delta + bias) near 0.05 (Mamba's dt init spans 1e-3
    to 0.1), so a chunk's decay exp(A * S) is far from 0 and the carried
    state shapes the next chunk."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    pb = (b,) if per_batch else ()
    return dict(
        u=f(b, L, d), delta=0.5 * f(b, L, d) - 3.0,
        A=-(0.5 + rng.random(pb + (d, n))).astype(np.float32),
        B=f(b, L, n), C=f(b, L, n), D=f(*pb, d), z=f(b, L, d),
        delta_bias=0.1 * f(*pb, d),
        initial_state=f(b, d, n) if h0 else None)


def _torch(inp):
    return {k: None if v is None else torch.from_numpy(v)
            for k, v in inp.items()}


@pytest.mark.parametrize("L,l_chunk", EDGES)
def test_chunked_ref_matches_jax_sequential_ref(L, l_chunk):
    """Output (z-gated) and last state; each edge case at d = 24 with
    shared parameters and no initial state, and at d = 160 with per-batch
    parameters and an initial state."""
    for d, per_batch, h0 in ((24, False, False), (160, True, True)):
        inp = _inputs(L * 7 + l_chunk + d, 2, L, d, per_batch, h0)
        t = _torch(inp)
        y, last = trefs.selective_scan_chunked_ref(
            t["u"], t["delta"], t["A"], t["B"], t["C"], t["D"], t["z"],
            t["delta_bias"], True, t["initial_state"], l_chunk=l_chunk)
        j = {k: None if v is None else jnp.asarray(v) for k, v in inp.items()}
        jy, jlast = jrefs.selective_scan_ref(
            j["u"], j["delta"], j["A"], j["B"], j["C"], D=j["D"], z=j["z"],
            delta_bias=j["delta_bias"], delta_softplus=True,
            return_last_state=True, initial_state=j["initial_state"])
        assert tuple(y.shape) == (2, L, d) and tuple(last.shape) == (2, d, 16)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), err_msg="y",
                                   **TOL)
        np.testing.assert_allclose(last.numpy(), np.asarray(jlast),
                                   err_msg="last", **TOL)


PALLAS_CASES = [
    # (L, l_chunk, d, per-batch parameters, initial state)
    (1, 64, 24, False, True),
    (15, 16, 160, True, False),
    (16, 16, 24, True, True),
    (17, 16, 160, False, True),
    (17, 64, 24, True, False),
    (333, 16, 24, False, False),
    (333, 64, 160, True, True),
]


@pytest.mark.parametrize("L,l_chunk,d,per_batch,h0", PALLAS_CASES)
def test_chunked_ref_states_match_pallas_save_cs(L, l_chunk, d, per_batch,
                                                 h0):
    """The training variant (no z): output, the state before every 16th
    step and the last state, against the Pallas forward in interpret
    mode."""
    inp = _inputs(L + d, 2, L, d, per_batch, h0)
    chunk = tss.CHUNK
    j = {k: jnp.asarray(v) for k, v in inp.items() if v is not None}
    jy, jcs, jlast = _fwd_call(j["u"], j["delta"], j["A"], j["B"], j["C"],
                               j["D"], None, j["delta_bias"],
                               j.get("initial_state"), True, chunk, 128,
                               save_cs=True)
    t = _torch(inp)
    y, cs, last = trefs.selective_scan_chunked_ref(
        t["u"], t["delta"], t["A"], t["B"], t["C"], t["D"], None,
        t["delta_bias"], True, t["initial_state"], l_chunk=l_chunk,
        chunk=chunk, save_states=True)
    assert tuple(cs.shape) == (2, -(-L // chunk), d, 16)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), err_msg="y", **TOL)
    # Pallas keeps the states as (b, nk, N, d_pad)
    np.testing.assert_allclose(
        cs.numpy(), np.swapaxes(np.asarray(jcs), 2, 3)[:, :, :d],
        err_msg="chunk states", **TOL)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast),
                               err_msg="last", **TOL)


def test_chunked_ref_refuses_what_the_kernel_refuses():
    t = _torch(_inputs(0, 1, 20, 8, False, False))
    args = (t["u"], t["delta"], t["A"], t["B"], t["C"])
    with pytest.raises(ValueError, match="multiple"):
        trefs.selective_scan_chunked_ref(*args, l_chunk=24)
    with pytest.raises(ValueError, match="no z"):
        trefs.selective_scan_chunked_ref(*args, z=t["z"], save_states=True)


@pytest.mark.parametrize("batch,L,dim", [
    (3, 20480, 128), (3, 5120, 256), (3, 1280, 640), (3, 320, 1024),
    (9, 20480, 128), (9, 320, 1024), (3, 333, 160), (1, 1, 8),
    (2, 5_000_000, 16)])
def test_wrapper_l_chunk_fills_the_card(batch, L, dim):
    """l_chunk is a multiple of CHUNK, gives at most MAX_CHUNKS chunks, and
    is the longest such chunk: the next shorter one would already give the
    grid FWD_BLOCKS_PER_SM blocks per SM (or exceed MAX_CHUNKS).  On the
    card the channels per block come from the kernel's library
    (fwd_channels); here they are the 128 it holds at d_state 16."""
    sms, threads = 132, 128
    lc = tss.fwd_l_chunk(batch, L, dim, sms, threads)
    tiles, n_chunks, b = tss.fwd_grid(batch, L, dim, lc, threads)
    assert lc % tss.CHUNK == 0 and lc >= tss.CHUNK
    assert b == batch and tiles == -(-dim // threads)
    assert n_chunks == -(-L // lc) <= tss.MAX_CHUNKS
    if lc > tss.CHUNK:
        shorter = -(-L // (lc - tss.CHUNK))
        assert (tiles * shorter * batch >= tss.FWD_BLOCKS_PER_SM * sms
                or shorter > tss.MAX_CHUNKS)
    if (batch, L, dim) == (3, 20480, 128):  # serving stage 0
        assert (lc, n_chunks) == (128, 160)
