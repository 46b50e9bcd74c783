"""One decode token of a Mamba mixer, stepped in place: dispatch to the
Hopper kernels of ``csrc/mamba_step.cu``.

``nn/streaming.py::mamba_step`` calls the two halves around the x_proj
product.  ``conv_step`` shifts the conv window (B, W, d_inner) by one slot,
writes the new pre-conv input into the last, and returns silu of the window's
dot with the (W, d_inner) weight plus the bias.  ``ssm_step`` steps the fp32
ssm state (B, d_inner, N) by one token of the selective recurrence (dt
through its bias and softplus, A = -exp(A_log)) and returns the gated output
``(C . state + D x) * silu(z)``.  Both write the states they are given and
return a new (B, d_inner) output in x's dtype.  A Mamba-2 mixer
(``nn/streaming.py::mamba2_step``) steps through the same ``ssm_step`` with
``head_dim`` channels a head sharing dt, dt_bias, A_log and D, and
``n_groups`` groups of channels sharing B and C: its per-head operands are
read as they are, with no per-channel copy.

The JAX package's decode step is plain XLA and functional, so no Pallas
kernel is replaced: on the card each half is one kernel written by hand, in
place of a chain of small PyTorch ops and the copies of the new states into
the decode graph's buffers.  The kernels read every tensor where it lies,
through its strides (x and z are column views of in_proj's output, B and C of
x_proj's), and each in its own dtype: the activations, the window and the
parameters fp32 or bf16, the ssm state fp32 with unit d_state stride.

On CUDA tensors the wrappers launch on PyTorch's current stream and count
each launch in ``LAUNCHES`` (a call inside a CUDA graph counts at each
replay, ``utils/cuda_graphs.py``); a failed build or launch raises, and no
CUDA tensor falls back to the plain versions.  On CPU tensors they run the
plain versions (``plain_conv_step`` / ``plain_ssm_step``: the decode
step's math of ``causal_conv1d_update`` and ``refs.
selective_state_update_ref``, written into the given states with
``copy_``), so the CPU holds the same in-place contract.  Both paths check
their arguments first, alike.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from vivim_tpu_torch.kernels import _build
from vivim_tpu_torch.kernels.causal_conv1d import causal_conv1d_update
from vivim_tpu_torch.kernels.refs import selective_state_update_ref
from vivim_tpu_torch.kernels.selective_scan import MAX_DSTATE
from vivim_tpu_torch.utils import cuda_graphs

# Kernel launches so far (conv_step and ssm_step, one each a call); a caller
# resets it to 0 to count one run.
LAUNCHES = 0
cuda_graphs.count_launches(sys.modules[__name__], "LAUNCHES")

MAX_BATCH = 65535    # the grid's y dimension
MAX_WIDTH = 8        # conv width (kMaxWidth of the source)
MAX_LANES = 16       # ssm_step's threads a channel (kMaxLanes)
MAX_PER_LANE = 16    # and states a thread (kMaxPerLane)
# ssm_step's grid: about this many threads keep the card's memory requests
# in flight at decode sizes, and a larger grid gives each channel fewer
# lanes, down to two (one lane was slower at every shape timed on the H100;
# PERF.md §6)
FILL_THREADS = 1 << 16
MIN_LANES = 2
# dtype codes of the source (kF32, kBF16)
_TYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("mamba_step")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        arrays = [ctypes.POINTER(ptr), ctypes.POINTER(i32),
                  ctypes.POINTER(ctypes.c_int64)]
        lib.vivim_conv_step.argtypes = arrays + [i32, i32, i32, ptr]
        lib.vivim_conv_step.restype = i32
        lib.vivim_ssm_step.argtypes = arrays + [i32] * 7 + [ptr]
        lib.vivim_ssm_step.restype = i32
        lib.vivim_cuda_error_string.argtypes = [i32]
        lib.vivim_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(what, t, shape, like, fp32=False):
    """Raise unless ``t`` is an fp32 (or, unless ``fp32``, bf16) tensor of
    ``shape`` on ``like``'s device."""
    types = (torch.float32,) if fp32 else tuple(_TYPES)
    if t.dtype not in types:
        raise ValueError(f"{what} is {t.dtype}; the mamba step kernels take "
                         + " or ".join(map(str, types)))
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} {tuple(t.shape)} is not {tuple(shape)}")
    if t.device != like.device:
        raise ValueError(f"{what} on {t.device} beside x on {like.device}")


def _check_batch(batch, like):
    if like.is_cuda and not 1 <= batch <= MAX_BATCH:
        raise ValueError(f"batch {batch}: the mamba step kernels take 1 to "
                         f"{MAX_BATCH} rows")


def _launch(fn, name, ptrs, types, strides, *sizes, dev):
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_types = (ctypes.c_int * len(types))(*types)
    c_strides = (ctypes.c_int64 * len(strides))(*strides)
    with torch.cuda.device(dev):
        err = fn(c_ptrs, c_types, c_strides, *sizes,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + _lib().vivim_cuda_error_string(err).decode())


def _ptr(t):
    return None if t is None else t.data_ptr()


def _code(t):
    return 0 if t is None else _TYPES[t.dtype]


def plain_conv_step(x, conv_state, weight, bias=None):
    """``conv_step`` in plain PyTorch: ``causal_conv1d_update`` with silu,
    its new window copied into ``conv_state``."""
    out, new_state = causal_conv1d_update(x, conv_state, weight, bias,
                                          "silu")
    conv_state.copy_(new_state)
    return out


def conv_step(x, conv_state, weight, bias=None):
    """The causal conv's decode step, in place.

    x: (B, d_inner) new pre-conv input (any strides); conv_state: (B, W,
    d_inner) window of past inputs, stepped in place; weight: (W, d_inner);
    bias: (d_inner,) or None.  Returns silu of the new window's dot with
    the weight plus the bias, (B, d_inner) in x's dtype, summed in fp32.
    """
    global LAUNCHES
    if x.dim() != 2 or conv_state.dim() != 3:
        raise ValueError(f"x {tuple(x.shape)} and conv_state "
                         f"{tuple(conv_state.shape)} are not (B, d_inner) "
                         "and (B, W, d_inner)")
    batch, dim = x.shape
    width = conv_state.shape[1]
    if not 1 <= width <= MAX_WIDTH:
        raise ValueError(f"conv width {width}: the mamba step kernels take "
                         f"1 to {MAX_WIDTH}")
    _check("x", x, (batch, dim), x)
    _check("conv_state", conv_state, (batch, width, dim), x)
    _check("weight", weight, (width, dim), x)
    if bias is not None:
        _check("bias", bias, (dim,), x)
    _check_batch(batch, x)
    if not x.is_cuda:
        return plain_conv_step(x, conv_state, weight, bias)
    out = torch.empty((batch, dim), dtype=x.dtype, device=x.device)
    strides = [*x.stride(), *conv_state.stride(), *weight.stride(),
               bias.stride(0) if bias is not None else 0]
    _launch(_lib().vivim_conv_step, "conv_step",
            [x.data_ptr(), conv_state.data_ptr(), weight.data_ptr(),
             _ptr(bias), out.data_ptr()],
            [_code(t) for t in (x, conv_state, weight, bias, out)],
            strides, batch, dim, width, dev=x.device)
    LAUNCHES += 1
    return out


def plain_ssm_step(ssm_state, x, dt, A_log, B, C, D, z, dt_bias,
                   head_dim=1, n_groups=1):
    """``ssm_step`` in plain PyTorch: ``refs.selective_state_update_ref``
    with A = -exp(A_log) and softplus, its new state copied into
    ``ssm_state``; per-head operands repeated over their channels, each
    group of channels stepped with its own B and C."""
    if head_dim > 1:
        dt = dt.repeat_interleave(head_dim, 1)
        A_log, D, dt_bias = (t.repeat_interleave(head_dim, 0)
                             for t in (A_log, D, dt_bias))
    if n_groups > 1:
        g, n = ssm_state.shape[1] // n_groups, ssm_state.shape[2]
        outs = []
        for k in range(n_groups):
            c, bc = slice(k * g, (k + 1) * g), slice(k * n, (k + 1) * n)
            outs.append(plain_ssm_step(
                ssm_state[:, c], x[:, c], dt[:, c], A_log[c], B[:, bc],
                C[:, bc], D[c], z[:, c], dt_bias[c]))
        return torch.cat(outs, 1)
    out, new_state = selective_state_update_ref(
        ssm_state, x, dt, -torch.exp(A_log.float()), B, C, D=D.float(), z=z,
        dt_bias=dt_bias.float(), dt_softplus=True)
    ssm_state.copy_(new_state)
    return out


def ssm_lanes(batch, dim, n):
    """(lanes, states per lane) of ``ssm_step``: a channel's threads, the
    power of two at or above N up to ``MAX_LANES``, halved down to
    ``MIN_LANES`` while the grid's threads exceed ``FILL_THREADS`` and a
    lane would still hold at most ``MAX_PER_LANE`` states; and the states
    each lane holds."""
    lanes = min(MAX_LANES, 1 << (n - 1).bit_length())
    while (lanes > MIN_LANES and batch * dim * lanes > FILL_THREADS
           and -(-n // (lanes // 2)) <= MAX_PER_LANE):
        lanes //= 2
    return lanes, -(-n // lanes)


def ssm_step(ssm_state, x, dt, A_log, B, C, D, z, dt_bias, head_dim=1,
             n_groups=1):
    """One token of the selective recurrence, in place.

    ssm_state: (B, d_inner, N) fp32 with unit N stride, stepped in place;
    x (the conv's output), z: (B, d_inner); dt (before its bias and
    softplus): (B, H); B, C: (B, n_groups * N); A_log: (H, N); D, dt_bias:
    (H,); any strides but the state's.  H = d_inner / ``head_dim``: channel
    c reads head c // head_dim's dt, dt_bias, A_log and D, and the B and C
    of group c // (d_inner / n_groups).  Returns ``(C . state + D x) *
    silu(z)``, (B, d_inner) in x's dtype, computed in fp32.
    """
    global LAUNCHES
    if ssm_state.dim() != 3:
        raise ValueError(f"ssm_state {tuple(ssm_state.shape)} is not (B, "
                         "d_inner, N)")
    batch, dim, n = ssm_state.shape
    _check("ssm_state", ssm_state, (batch, dim, n), x, fp32=True)
    if ssm_state.stride(2) != 1:
        raise ValueError(f"ssm_state's strides {ssm_state.stride()}: the "
                         "kernel takes a unit d_state stride")
    if not 1 <= n <= MAX_DSTATE:
        raise ValueError(f"d_state {n}: the mamba step kernels take 1 to "
                         f"{MAX_DSTATE}")
    if head_dim < 1 or n_groups < 1 or dim % head_dim or dim % n_groups:
        raise ValueError(f"head_dim {head_dim} and n_groups {n_groups} "
                         f"must divide d_inner {dim}")
    heads = dim // head_dim
    for what, t in (("x", x), ("z", z)):
        _check(what, t, (batch, dim), x)
    _check("dt", dt, (batch, heads), x)
    for what, t in (("B", B), ("C", C)):
        _check(what, t, (batch, n_groups * n), x)
    _check("A_log", A_log, (heads, n), x)
    for what, t in (("D", D), ("dt_bias", dt_bias)):
        _check(what, t, (heads,), x)
    _check_batch(batch, x)
    if not x.is_cuda:
        return plain_ssm_step(ssm_state, x, dt, A_log, B, C, D, z, dt_bias,
                              head_dim, n_groups)
    out = _ssm_launch(ssm_state, x, dt, A_log, B, C, D, z, dt_bias,
                      head_dim=head_dim, n_groups=n_groups)
    LAUNCHES += 1
    return out


def _ssm_launch(ssm_state, x, dt, A_log, B, C, D, z, dt_bias, lanes=None,
                head_dim=1, n_groups=1):
    """The ssm kernel on checked CUDA operands; returns the output.
    ``lanes`` overrides the threads a channel ``ssm_lanes`` picks (a power
    of two; timing them).  Counts nothing: ``ssm_step`` counts its calls."""
    batch, dim, n = ssm_state.shape
    lanes = lanes or ssm_lanes(batch, dim, n)[0]
    out = torch.empty((batch, dim), dtype=x.dtype, device=x.device)
    operands = (x, dt, z, B, C, A_log, D, dt_bias)
    strides = [*ssm_state.stride()[:2]]
    for t in operands:
        strides += t.stride()
    _launch(_lib().vivim_ssm_step, "ssm_step",
            [ssm_state.data_ptr()] + [t.data_ptr() for t in operands]
            + [out.data_ptr()],
            [_code(t) for t in operands + (out,)], strides,
            batch, dim, n, lanes, -(-n // lanes), head_dim, dim // n_groups,
            dev=x.device)
    return out
