"""3-D depthwise conv (3x3x3, stride 1, zero padding 1, groups = C) on
channels-last tokens: dispatch to the Hopper kernels of ``csrc/dwconv3d.cu``.

The Mix-FFN's conv of every Vivim MambaLayer (``nn/layers.py::DWConv3d``).
The JAX package sums its 27 channels-last taps in fp32 as plain XLA
(``unrolled_depthwise_conv``), so no Pallas kernel is replaced: on the card
the conv is one kernel written by hand in the forward
(``dwconv3d_fwd_kernel``) and two in the backward (``dwconv3d_bwd_kernel``:
dx and per-block partials of the weight and bias grads; then
``dwconv3d_bwd_sum_kernel``), in place of cuDNN's per-channel-group kernels
and the layout transforms around them.  The kernels read the ``(B, T*H*W,
C)`` tokens as they are (unit channel stride; batch and token strides are
passed) and the weight and bias in ``nn.Conv3d``'s layout, ``(C, 1, 3, 3,
3)`` and ``(C,)``; everything is fp32 (``DWConv3d`` casts other dtypes up).

An item of the kernels is one (b, t, h) row of W outputs.  This module
checks the arguments, picks the tiles from the shape and the SM count
(``fwd_tiling`` / ``bwd_tiling``: block lanes, block rows), allocates
outputs and scratch,
launches on PyTorch's current stream and counts the launches (one count per
wrapper call; a call inside a CUDA graph counts at each replay,
``utils/cuda_graphs.py``).  ``DWConv3dFn`` is the differentiable conv: on
CUDA tensors the kernels, on CPU tensors the plain versions
``refs.dwconv3d_ref`` (``F.conv3d``) and ``refs.dwconv3d_bwd_ref``, so the
CPU runs the same glue.  A CUDA tensor never falls back to cuDNN or to a
plain version: a failed build or launch raises.
``refs.dwconv3d_bwd_tiled_ref`` models the backward's tiling and its
fixed-order partial sums for the tests.
"""

from __future__ import annotations

import ctypes
import sys

import torch
from torch.autograd.function import once_differentiable

from vivim_tpu_torch.kernels import _build, refs
from vivim_tpu_torch.utils import cuda_graphs

# Wrapper calls so far: LAUNCHES forward (one kernel), BWD_LAUNCHES backward
# (two kernels); a caller resets them to 0 to count one run.
LAUNCHES = 0
BWD_LAUNCHES = 0
cuda_graphs.count_launches(sys.modules[__name__], "LAUNCHES", "BWD_LAUNCHES")

THREADS = 256        # threads of a block (kThreads of the source)
MAX_LANES = 32       # channel lanes of a block, its x dimension
MAX_ROWS = 65535     # the grid's y dimension
TAPS = 27
# the backward's grid aims at the blocks that fit on an SM at once (two of
# 256 threads at no more than 128 registers), each walking many items
BWD_BLOCKS_PER_SM = 2
_LIB = None
_SMS = {}


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("dwconv3d")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.vivim_dwconv3d_fwd.argtypes = (
            [ptr] * 4 + [i32] * 5 + [i64] * 2 + [i32] * 3 + [ptr])
        lib.vivim_dwconv3d_fwd.restype = i32
        lib.vivim_dwconv3d_bwd.argtypes = (
            [ptr] * 7 + [i32] * 5 + [i64] * 4 + [i32] * 2 + [ptr])
        lib.vivim_dwconv3d_bwd.restype = i32
        lib.vivim_cuda_error_string.argtypes = [i32]
        lib.vivim_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _sm_count(dev):
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SMS[idx]


def block_lanes(C, vec):
    """A block's channel lanes: the thread vectors covering C, rounded up
    to a power of two, at most ``MAX_LANES``."""
    return min(MAX_LANES, 1 << (-(-C // vec) - 1).bit_length())


def _rows(items, lanes, target):
    """Block rows of the grid for ``items`` items at ``THREADS // lanes``
    items a block row step: about ``target`` (at most ``MAX_ROWS``), cut so
    that every row walks the same number of item groups but the last."""
    groups = -(-items // (THREADS // lanes))
    per_row = -(-groups // max(1, min(target, MAX_ROWS)))
    return -(-groups // per_row)


def fwd_tiling(batch, T, H, C, vec):
    """(lanes, rows) of the forward with ``vec`` channels per thread: one
    item per thread where the grid allows."""
    lanes = block_lanes(C, vec)
    return lanes, _rows(batch * T * H, lanes, MAX_ROWS)


def bwd_tiling(batch, T, H, C, sms):
    """(lanes, rows) of the backward on ``sms`` SMs: about
    ``BWD_BLOCKS_PER_SM`` blocks per SM, each walking its row's items; the
    rows also set the partials' size, (rows, 28, C)."""
    lanes = block_lanes(C, 1)
    tiles = -(-C // lanes)
    return lanes, _rows(batch * T * H, lanes,
                        -(-BWD_BLOCKS_PER_SM * sms // tiles))


def vec_width(C, *tensors):
    """Channels per thread of the forward: 4 (one float4) where C and the
    tensors' batch and token strides are multiples of 4 and the tensors
    16-byte aligned, else 1."""
    ok = C % 4 == 0 and all(
        t.data_ptr() % 16 == 0 and t.stride(0) % 4 == 0
        and t.stride(1) % 4 == 0 for t in tensors)
    return 4 if ok else 1


def _tokens(x, T, H, W, like=None, what="x"):
    """(B, T*H*W, C) fp32 CUDA tokens with unit channel stride."""
    if x.device.type != "cuda":
        raise ValueError(f"the dwconv3d kernels take CUDA tensors; {what} is "
                         f"on {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"the dwconv3d kernels take fp32 ({what} is "
                         f"{x.dtype}); DWConv3d casts other dtypes up")
    if x.dim() != 3 or x.shape[1] != T * H * W or min(T, H, W) < 1:
        raise ValueError(f"{what} {tuple(x.shape)} is not (B, {T}*{H}*{W}, "
                         "C) tokens")
    if like is not None and (x.shape != like.shape
                             or x.device != like.device):
        raise ValueError(f"{what} {tuple(x.shape)} on {x.device} beside x "
                         f"{tuple(like.shape)} on {like.device}")
    return x if x.stride(2) == 1 else x.contiguous()


def _weight(w, dev, shape, what):
    if w is None:
        return None
    if tuple(w.shape) != shape or w.dtype != torch.float32 \
            or w.device != dev:
        raise ValueError(f"{what} must be fp32 {shape} on {dev}; got "
                         f"{w.dtype} {tuple(w.shape)} on {w.device}")
    return w.contiguous()


def _raise_if(err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + _lib().vivim_cuda_error_string(err).decode())


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fwd_launch(x, weight, bias, T, H, W, rows=None, vec=None):
    """The forward kernel; returns y.  ``rows`` and ``vec`` override the
    tiles ``fwd_tiling`` picks (the tests move tile edges with them).
    Counts nothing: ``dwconv3d_fwd_cuda`` counts its calls."""
    x = _tokens(x, T, H, W)
    batch, N, C = x.shape
    weight = _weight(weight, x.device, (C, 1, 3, 3, 3), "weight")
    bias = _weight(bias, x.device, (C,), "bias")
    y = torch.empty((batch, N, C), dtype=torch.float32, device=x.device)
    vec = vec_width(C, x) if vec is None else vec
    lanes, rws = fwd_tiling(batch, T, H, C, vec)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.vivim_dwconv3d_fwd(
            _ptr(x), _ptr(weight), _ptr(bias), _ptr(y), batch, T, H, W, C,
            x.stride(0), x.stride(1), vec, lanes, rows or rws,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_if(err, "dwconv3d_fwd")
    return y


def _bwd_launch(x, dy, weight, T, H, W, with_bias=True, rows=None):
    """The backward kernels; returns (dx, dweight, dbias or None).
    ``rows`` overrides the block rows ``bwd_tiling`` picks.  Counts
    nothing: ``dwconv3d_bwd_cuda`` counts its calls."""
    x = _tokens(x, T, H, W)
    dy = _tokens(dy, T, H, W, like=x, what="dy")
    batch, N, C = x.shape
    weight = _weight(weight, x.device, (C, 1, 3, 3, 3), "weight")
    dev = x.device
    lanes, rws = bwd_tiling(batch, T, H, C, _sm_count(dev))
    rows = rows or rws
    dx = torch.empty((batch, N, C), dtype=torch.float32, device=dev)
    dweight = torch.empty((C, 1, 3, 3, 3), dtype=torch.float32, device=dev)
    dbias = (torch.empty(C, dtype=torch.float32, device=dev) if with_bias
             else None)
    part = torch.empty((rows, TAPS + 1, C), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.vivim_dwconv3d_bwd(
            _ptr(x), _ptr(dy), _ptr(weight), _ptr(dx), _ptr(dweight),
            _ptr(dbias), _ptr(part), batch, T, H, W, C, x.stride(0),
            x.stride(1), dy.stride(0), dy.stride(1), lanes, rows,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_if(err, "dwconv3d_bwd")
    return dx, dweight, dbias


def dwconv3d_fwd_cuda(x, weight, bias, T, H, W):
    """Launch the forward kernel: ``(B, T*H*W, C)`` fp32 tokens on the card
    -> the conv's output, contiguous, as ``refs.dwconv3d_ref``."""
    global LAUNCHES
    y = _fwd_launch(x, weight, bias, T, H, W)
    LAUNCHES += 1
    return y


def dwconv3d_bwd_cuda(x, dy, weight, T, H, W, with_bias=True):
    """Launch the backward kernels; returns what ``refs.dwconv3d_bwd_ref``
    returns: (dx, dweight, dbias), dbias None without ``with_bias``."""
    global BWD_LAUNCHES
    out = _bwd_launch(x, dy, weight, T, H, W, with_bias)
    BWD_LAUNCHES += 1
    return out


class DWConv3dFn(torch.autograd.Function):
    """The differentiable conv: the kernels on CUDA tensors, the plain
    versions on CPU ones.  x: (B, T*H*W, C) fp32 tokens; weight (C, 1, 3,
    3, 3); bias (C,) or None."""

    @staticmethod
    def forward(ctx, x, weight, bias, T, H, W):
        fwd = dwconv3d_fwd_cuda if x.is_cuda else refs.dwconv3d_ref
        y = fwd(x, weight, bias, T, H, W)
        ctx.save_for_backward(x, weight)
        ctx.frame = (T, H, W)
        ctx.with_bias = bias is not None
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        bwd = dwconv3d_bwd_cuda if x.is_cuda else refs.dwconv3d_bwd_ref
        dx, dweight, dbias = bwd(x, dy, weight, *ctx.frame, ctx.with_bias)
        return dx, dweight, dbias, None, None, None
