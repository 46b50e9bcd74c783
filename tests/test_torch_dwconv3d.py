"""The Mix-FFN's 3-D depthwise conv (``kernels/dwconv3d.py``) on the CPU.

On the card the conv is a hand-written forward kernel and a backward pair
(dx with per-block partials of the weight and bias grads, then a
fixed-order sum of the partials); on the CPU ``DWConv3dFn`` runs the plain
versions ``refs.dwconv3d_ref`` (``F.conv3d``) and ``refs.dwconv3d_bwd_ref``
through the same glue.  Here the CPU route and
``refs.dwconv3d_bwd_tiled_ref``, the model of the backward kernel's items
(rows along w), block rows and fixed-order partial sums, are held against
float64 ``F.conv3d`` and the JAX package's ``unrolled_depthwise_conv`` (its
``jax.vjp`` for the grads), at edge shapes: T, H, W in {1, 2, 5, 7}, C in
{1, 3, 16, 130}, batch 1 and 3, with block rows whose tiles end mid-frame
and cross frames and batch rows.  Tolerances: fp32 against float64 atol 1e-5
/ rtol 1e-5 for y and dx (27 taps of unit inputs), the weight and bias
grads (sums over every position) within 1e-5 of their largest magnitude;
the tiled model in float64 within 1e-12 of the plain grads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vivim_tpu.nn.layers import unrolled_depthwise_conv
from vivim_tpu_torch.kernels import dwconv3d as dk
from vivim_tpu_torch.kernels import refs
from vivim_tpu_torch.nn.layers import DWConv3d

# (batch, T, H, W, C): every T, H, W in {1, 2, 5, 7} and C in {1, 3, 16,
# 130} at least once, batch 1 and 3
CASES = ((1, 1, 1, 1, 1), (3, 1, 2, 5, 3), (1, 2, 7, 1, 16),
         (3, 5, 5, 2, 130), (1, 7, 1, 7, 3), (3, 2, 2, 2, 1),
         (1, 5, 7, 5, 130), (3, 7, 5, 7, 16))
IDS = ["b{}_t{}_h{}_w{}_c{}".format(*c) for c in CASES]
TOL = dict(rtol=1e-5, atol=1e-5)
SUM_TOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(case, seed=0):
    """fp32 numpy tokens, weight (C, 1, 3, 3, 3) at its init scale, bias
    and a cotangent."""
    batch, T, H, W, C = case
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (f(batch, T * H * W, C), f(C, 1, 3, 3, 3) / 27 ** 0.5,
            0.1 * f(C), f(batch, T * H * W, C))


def _float64(x, w, b, dy, T, H, W):
    """y and (dx, dweight, dbias) of float64 ``F.conv3d`` by autograd."""
    x, w, b = (torch.from_numpy(a).double().requires_grad_()
               for a in (x, w, b))
    batch, N, C = x.shape
    y = F.conv3d(x.reshape(batch, T, H, W, C).permute(0, 4, 1, 2, 3), w, b,
                 padding=1, groups=C).permute(0, 2, 3, 4, 1).reshape(
                     batch, N, C)
    grads = torch.autograd.grad(y, (x, w, b), torch.from_numpy(dy).double())
    return y.detach(), grads


def _jax(x, w, b, dy, T, H, W):
    """y and (dx, dweight, dbias) of the JAX package's unrolled taps (fp32)
    by ``jax.vjp``, in the port's layouts."""
    batch, N, C = x.shape
    kernel = np.transpose(w, (2, 3, 4, 1, 0))  # (3, 3, 3, 1, C)

    def conv(x, k, b):
        return unrolled_depthwise_conv(x.reshape(batch, T, H, W, C), k,
                                       b).reshape(batch, N, C)

    y, vjp = jax.vjp(conv, jnp.asarray(x), jnp.asarray(kernel),
                     jnp.asarray(b))
    dx, dk_, db = vjp(jnp.asarray(dy))
    dweight = np.transpose(np.asarray(dk_), (4, 3, 0, 1, 2))
    return (torch.from_numpy(np.array(y)),
            tuple(torch.from_numpy(np.array(g))
                  for g in (dx, dweight, db)))


def _close_sum(got, want, what):
    """A sum over every position: within ``SUM_TOL`` of its largest
    magnitude."""
    err = (got.double() - want.double()).abs().max().item()
    scale = max(want.double().abs().max().item(), 1e-30)
    assert err <= SUM_TOL * scale, f"{what}: {err:.3e} of {scale:.3e}"


def _check(y, grads, want_y, want_grads, what):
    torch.testing.assert_close(y.double(), want_y.double(), **TOL,
                               msg=f"{what} y")
    torch.testing.assert_close(grads[0].double(), want_grads[0].double(),
                               **TOL, msg=f"{what} dx")
    for name, g, w in zip(("dweight", "dbias"), grads[1:], want_grads[1:]):
        _close_sum(g, w, f"{what} {name}")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cpu_route_matches_float64_and_jax(case):
    """``DWConv3d`` on CPU tensors (``DWConv3dFn`` on the plain versions):
    y and the three grads against float64 ``F.conv3d`` and against the JAX
    package's unrolled taps; no kernel launch is counted."""
    batch, T, H, W, C = case
    x, w, b, dy = _inputs(case)
    mod = DWConv3d(C)
    with torch.no_grad():
        mod.dwconv.weight.copy_(torch.from_numpy(w))
        mod.dwconv.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(x).requires_grad_()
    before = (dk.LAUNCHES, dk.BWD_LAUNCHES)
    y = mod(xt, T, H, W)
    y.backward(torch.from_numpy(dy))
    assert (dk.LAUNCHES, dk.BWD_LAUNCHES) == before
    assert y.dtype == torch.float32 and y.shape == (batch, T * H * W, C)
    grads = (xt.grad, mod.dwconv.weight.grad, mod.dwconv.bias.grad)
    _check(y, grads, *_float64(x, w, b, dy, T, H, W), "float64")
    _check(y, grads, *_jax(x, w, b, dy, T, H, W), "JAX")


def _tilings(case):
    """(rows, items_per_step): the wrapper's backward tiles on 132 and on 2
    SMs, and forced ones whose item groups end mid-frame (3 or 4 rows of a
    frame of H 5 or 7) and step over frames and batch rows."""
    batch, T, H, W, C = case
    out = []
    for sms in (132, 2):
        lanes, rows = dk.bwd_tiling(batch, T, H, C, sms)
        out.append((rows, dk.THREADS // lanes))
    return out + [(2, 4), (3, 3), (1, 1), (1, 256)]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tiled_backward_model_matches_plain(case):
    """The backward kernel's decomposition: in float64 every tiling gives
    the plain grads to 1e-12 (each output and each product counted once);
    in fp32 within the fp32 tolerances of float64 ``F.conv3d``."""
    batch, T, H, W, C = case
    x, w, b, dy = _inputs(case, seed=1)
    want_y, want = _float64(x, w, b, dy, T, H, W)
    x64, w64, dy64 = (torch.from_numpy(a).double() for a in (x, w, dy))
    plain = refs.dwconv3d_bwd_ref(x64, dy64, w64, T, H, W)
    for g, v in zip(plain, want):
        torch.testing.assert_close(g, v, rtol=0, atol=1e-12)
    x32, w32, dy32 = (torch.from_numpy(a) for a in (x, w, dy))
    for rows, step in _tilings(case):
        tiled = refs.dwconv3d_bwd_tiled_ref(x64, dy64, w64, T, H, W, rows,
                                            step)
        for name, g, v in zip(("dx", "dweight", "dbias"), tiled, plain):
            torch.testing.assert_close(g, v, rtol=0, atol=1e-12,
                                       msg=f"rows {rows} step {step} {name}")
        tiled = refs.dwconv3d_bwd_tiled_ref(x32, dy32, w32, T, H, W, rows,
                                            step)
        _check(want_y, tiled, want_y, want, f"fp32 rows {rows} step {step}")


@pytest.mark.parametrize("with_bias", [True, False])
def test_function_without_bias_and_in_bf16(with_bias):
    """``DWConv3dFn`` with and without a bias (the plain backward's dbias
    None then); ``DWConv3d`` in bf16 returns bf16, computed in fp32 from
    the bf16 values."""
    case = (3, 2, 5, 7, 16)
    batch, T, H, W, C = case
    x, w, b, dy = _inputs(case, seed=2)
    if not with_bias:
        b = np.zeros_like(b)
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    bt = torch.from_numpy(b).requires_grad_() if with_bias else None
    y = dk.DWConv3dFn.apply(xt, wt, bt, T, H, W)
    grads = torch.autograd.grad(y, [xt, wt] + ([bt] if with_bias else []),
                                torch.from_numpy(dy))
    want_y, want = _float64(x, w, b, dy, T, H, W)
    torch.testing.assert_close(y.double(), want_y, **TOL)
    torch.testing.assert_close(grads[0].double(), want[0], **TOL)
    for name, g, v in zip(("dweight", "dbias"), grads[1:], want[1:]):
        _close_sum(g, v, name)
    plain = refs.dwconv3d_bwd_ref(xt.detach(), torch.from_numpy(dy),
                                  wt.detach(), T, H, W, with_bias)
    assert (plain[2] is None) == (not with_bias)
    mod = DWConv3d(C).to(torch.bfloat16)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = mod(xb, T, H, W)
    assert got.dtype == torch.bfloat16
    conv = mod.dwconv
    ref = refs.dwconv3d_ref(xb.float(), conv.weight.float(),
                            conv.bias.float(), T, H, W).to(torch.bfloat16)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_tiling_covers_every_item():
    """The wrapper's tiles at the Vivim-b3 stage shapes (T 5, 256 px clips,
    batch 1 and 3; 512 px, batch 12), the micro models' and ragged ones,
    on 132 and 2 SMs: lanes a power of two up to 32 covering C (or 32
    lanes a block), block rows within the grid, and the rows' steps reach
    every row of items once."""
    shapes = [(b, 5, s, s, c) for b in (1, 3)
              for s, c in ((64, 256), (32, 512), (16, 1280), (8, 2048))]
    shapes += [(12, 5, 128, 128, 256), (12, 5, 16, 16, 2048)]
    shapes += list(CASES) + [(2, 1, 1, 1, 16), (1, 3, 4, 4, 16)]
    for sms in (132, 2):
        for batch, T, H, W, C in shapes:
            vec = dk.vec_width(C)
            for v, (lanes, rows) in ((vec, dk.fwd_tiling(batch, T, H, C,
                                                         vec)),
                                     (1, dk.bwd_tiling(batch, T, H, C,
                                                       sms))):
                assert lanes in (1, 2, 4, 8, 16, 32)
                assert lanes >= min(32, -(-C // v))
                assert 1 <= rows <= dk.MAX_ROWS
                groups = -(-batch * T * H // (dk.THREADS // lanes))
                assert rows <= groups
                steps = -(-groups // rows)
                assert (steps - 1) * rows < groups <= steps * rows
    # the serving stage 0 of Vivim-b3: float4 lanes, 64 lanes of channels
    # in two blocks across, 8 rows a block, 40 block rows
    assert dk.vec_width(256) == 4 and dk.vec_width(130) == 1
    assert dk.fwd_tiling(1, 5, 64, 256, 4) == (32, 40)
    # its training stage 0 backward on 132 SMs: 8 channel tiles, 30 block
    # rows of 4 groups of 8 rows (264 blocks at 2 an SM, cut to 240)
    assert dk.bwd_tiling(3, 5, 64, 256, 132) == (32, 30)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """CPU tensors and a token count that is not T*H*W are refused before
    any launch."""
    x = torch.zeros(1, 2 * 3 * 4, 8)
    w = torch.zeros(8, 1, 3, 3, 3)
    with pytest.raises(ValueError, match="CUDA"):
        dk.dwconv3d_fwd_cuda(x, w, None, 2, 3, 4)
    with pytest.raises(ValueError, match="CUDA"):
        dk.dwconv3d_bwd_cuda(x, x, w, 2, 3, 4)
    with pytest.raises(ValueError, match="tokens"):
        DWConv3d(8)(x, 2, 3, 5)
