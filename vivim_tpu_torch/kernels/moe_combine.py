"""The dropless MoE block's combine: dispatch to the Hopper kernel of
``csrc/moe_combine.cu``.

``nn/moe.py::dropless_moe`` sorts its T tokens' k choices by expert, runs
each expert on its rows, and then calls ``moe_combine`` to sum each token's
gated expert outputs and its shared expert's output:

    out[t] = sum_{j < k} gates[t, j] * ys[pos[t, j]]  (+ shared[t])

in fp32, in the order j = 0 .. k-1 and then the shared row, rounded once to
the compute dtype.  ``ys`` (T k, M) holds the expert outputs in sorted
order, ``pos`` (T, k) int32 the sorted row of each token's j-th choice (the
inverse of the sort), ``gates`` (T, k) fp32 in token order, ``shared`` (T,
M) the shared expert's output or None.

The JAX package has no dropless block, so no Pallas kernel is replaced: on
the card one kernel reads each sorted row once and writes each token's row
once, in place of an fp32 copy and an fp32 gate product of every sorted row,
an ``index_add_`` with atomics into a zeroed fp32 (T, M) sum, the shared
expert's fp32 add and a cast.  It uses no atomics, so its result is the same
on every run.

On CUDA tensors ``moe_combine`` launches the kernel on PyTorch's current
stream and counts each launch in ``LAUNCHES`` (registered with
``utils/cuda_graphs.py``); a failed build or launch raises, and no CUDA
tensor falls back to the plain version.  The kernel has no backward, so a
CUDA call refuses a tensor that requires grad; it reads ``pos``'s range on
the host (a sync), so it does not run inside a CUDA graph capture.  On CPU
tensors it runs ``plain_moe_combine``, the same arithmetic in the same
order in plain PyTorch.  Both paths check their arguments first, alike.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from vivim_tpu_torch.kernels import _build
from vivim_tpu_torch.utils import cuda_graphs

# Kernel launches so far (one a CUDA call); a caller resets it to 0 to count
# one run.
LAUNCHES = 0
cuda_graphs.count_launches(sys.modules[__name__], "LAUNCHES")

MAX_K = 16           # choices a token (kMaxK of the source)
# dtype codes of the source (kF32, kBF16)
_TYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("moe_combine")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.vivim_moe_combine.argtypes = ([ptr] * 5
                                          + [i32, i64, i32, i64, ptr])
        lib.vivim_moe_combine.restype = i32
        lib.vivim_cuda_error_string.argtypes = [i32]
        lib.vivim_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def plain_moe_combine(ys, pos, gates, shared=None):
    """``moe_combine`` in plain PyTorch: an fp32 sum started at 0, each
    choice's gated row added in turn (the product rounded, then the sum),
    then the shared row, cast once to ys's dtype."""
    pos = pos.long()
    acc = torch.zeros((pos.shape[0], ys.shape[1]), dtype=torch.float32,
                      device=ys.device)
    for j in range(pos.shape[1]):
        acc += ys[pos[:, j]].float() * gates[:, j, None]
    if shared is not None:
        acc += shared.float()
    return acc.to(ys.dtype)


def _check(ys, pos, gates, shared):
    if ys.dtype not in _TYPES:
        raise ValueError(f"ys is {ys.dtype}; the combine takes float32 or "
                         "bfloat16")
    if ys.dim() != 2 or pos.dim() != 2:
        raise ValueError(f"ys {tuple(ys.shape)} and pos {tuple(pos.shape)} "
                         "are not (T k, M) and (T, k)")
    tokens, k = pos.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k {k}: the combine takes 1 to {MAX_K} choices a "
                         "token")
    if ys.shape[0] != tokens * k:
        raise ValueError(f"ys has {ys.shape[0]} rows, not T k = {tokens} x "
                         f"{k}")
    if ys.shape[0] >= 2 ** 31:
        raise ValueError(f"{ys.shape[0]} rows: pos is int32")
    if pos.dtype != torch.int32:
        raise ValueError(f"pos is {pos.dtype}, not torch.int32")
    if gates.dtype != torch.float32 or tuple(gates.shape) != (tokens, k):
        raise ValueError(f"gates {gates.dtype} {tuple(gates.shape)} are not "
                         f"float32 ({tokens}, {k})")
    if shared is not None and (shared.dtype != ys.dtype or tuple(
            shared.shape) != (tokens, ys.shape[1])):
        raise ValueError(f"shared {shared.dtype} {tuple(shared.shape)} is "
                         f"not {ys.dtype} ({tokens}, {ys.shape[1]})")
    operands = [("ys", ys), ("pos", pos), ("gates", gates)]
    if shared is not None:
        operands.append(("shared", shared))
    for what, t in operands:
        if t.device != ys.device:
            raise ValueError(f"{what} on {t.device} beside ys on {ys.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what} {tuple(t.shape)} is not contiguous")
    if pos.numel():
        lo, hi = torch.stack(torch.aminmax(pos)).tolist()
        if lo < 0 or hi >= ys.shape[0]:
            raise ValueError(f"pos in [{lo}, {hi}]: ys has {ys.shape[0]} "
                             "rows")


def moe_combine(ys, pos, gates, shared=None):
    """Each token's gated expert outputs plus its shared expert's output.

    ys: (T k, M) expert outputs in sorted order, fp32 or bf16; pos: (T, k)
    int32, the row of ys of each token's j-th choice; gates: (T, k) fp32;
    shared: (T, M) in ys's dtype, or None; all contiguous.  Returns (T, M)
    in ys's dtype, summed in fp32 in the order j = 0 .. k-1, then shared.
    """
    global LAUNCHES
    _check(ys, pos, gates, shared)
    if not ys.is_cuda:
        return plain_moe_combine(ys, pos, gates, shared)
    if any(t is not None and t.requires_grad
           for t in (ys, gates, shared)):
        raise ValueError("the combine kernel has no backward: it runs in "
                         "inference only (torch.no_grad)")
    out = torch.empty((pos.shape[0], ys.shape[1]), dtype=ys.dtype,
                      device=ys.device)
    if out.numel() == 0:
        return out
    _launch(ys, pos, gates, shared, out)
    LAUNCHES += 1
    return out


def _launch(ys, pos, gates, shared, out):
    """The kernel on checked CUDA operands, into ``out`` (T, M).  No host
    read, so it can be captured (timing it); counts nothing:
    ``moe_combine`` counts its calls."""
    tokens, k = pos.shape
    with torch.cuda.device(ys.device):
        err = _lib().vivim_moe_combine(
            ys.data_ptr(), pos.data_ptr(), gates.data_ptr(),
            None if shared is None else shared.data_ptr(), out.data_ptr(),
            _TYPES[ys.dtype], tokens, k, ys.shape[1],
            torch.cuda.current_stream(ys.device).cuda_stream)
    if err != 0:
        raise RuntimeError("moe_combine launch failed: "
                           + _lib().vivim_cuda_error_string(err).decode())
