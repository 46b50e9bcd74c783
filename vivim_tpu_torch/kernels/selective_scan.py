"""Selective scan (Mamba S6 recurrence): dispatch to the Hopper kernel.

Port of the JAX package's ``kernels/selective_scan.py`` (``selective_scan``,
``_grouped_selective_scan``, ``selective_scan_cm``).  The Pallas forward
``_fwd_kernel`` becomes the CUDA kernel ``csrc/selective_scan_fwd.cu``
(see the note at its top); this module checks and lays out its arguments,
launches it on PyTorch's current stream and counts the launches.

Dispatch:
- ``implementation=None`` on CUDA tensors launches the kernel; on CPU
  tensors it runs the plain version, ``refs.selective_scan_ref``.
- ``implementation="ref"`` runs the plain version on any device.

Only the forward exists on the GPU: the backward kernel is the ROADMAP's
K2, ported with the training slice.  A CUDA call that would need a gradient
raises.  On the CPU the plain version stays differentiable.

Layout is time-major: ``u/delta/z: (B, L, D)``, ``B/C: (B, L, N)``,
``A: (D, N)`` or per batch ``(B, D, N)``.
"""

from __future__ import annotations

import ctypes

import torch

from vivim_tpu_torch.kernels import _build, refs

# Kernel launches so far; a caller resets it to 0 to count one run.
LAUNCHES = 0

DSTATE = 16  # the kernel's d_state: one half warp per channel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("selective_scan_fwd")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.vivim_selective_scan_fwd.argtypes = (
            [ptr] * 11 + [i32] * 3 + [i64] * 16 + [i32, i32, ptr])
        lib.vivim_selective_scan_fwd.restype = i32
        lib.vivim_cuda_error_string.argtypes = [i32]
        lib.vivim_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _param(p, batch, dim, dstate, device):
    """Shared ``(dim[, dstate])`` or per-batch ``(batch, dim[, dstate])``
    fp32 parameter -> (contiguous tensor, batch stride; 0 = shared)."""
    shared_ndim = 1 if dstate is None else 2
    inner = (dim,) if dstate is None else (dim, dstate)
    p = p.to(device=device, dtype=torch.float32).contiguous()
    if p.dim() == shared_ndim and tuple(p.shape) == inner:
        return p, 0
    if tuple(p.shape) == (batch,) + inner:
        return p, p.stride(0)
    raise ValueError(f"parameter shape {tuple(p.shape)} is neither {inner} "
                     f"nor {(batch,) + inner}")


def _seq(x, shape, like):
    """(B, L, *) activation on ``like``'s device and of its dtype, with
    unit stride on its last axis."""
    if tuple(x.shape) != shape:
        raise ValueError(f"expected shape {shape}, got {tuple(x.shape)}")
    if x.device != like.device:
        raise ValueError(f"tensor on {x.device}, u on {like.device}")
    dtype = like.dtype
    if x.dtype != dtype:
        raise ValueError(f"u, delta, z, B and C must share a dtype; got "
                         f"{x.dtype} beside {dtype}")
    return x if x.stride(-1) == 1 else x.contiguous()


def selective_scan_fwd_cuda(u, delta, A, B, C, D=None, z=None,
                            delta_bias=None, delta_softplus=False,
                            initial_state=None):
    """Launch the Hopper forward kernel; returns (out, last_state fp32).

    All tensors lie on one CUDA device; u, delta, z, B and C are fp32 or
    bf16 of one dtype and may be strided views with unit stride on their
    last axis (the B/C column slices of x_proj's output, z the second half
    of in_proj's) — nothing is copied for them.
    """
    global LAUNCHES
    if u.device.type != "cuda":
        raise ValueError("selective_scan_fwd_cuda takes CUDA tensors")
    if u.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {u.dtype} (fp32 or bf16)")
    batch, L, dim = u.shape
    dstate = A.shape[-1]
    if dstate != DSTATE:
        raise ValueError(f"the CUDA kernel takes d_state {DSTATE}, "
                         f"got {dstate}")
    if batch > 65535:
        raise ValueError(f"batch {batch} exceeds the kernel grid")
    dev = u.device
    u = _seq(u, (batch, L, dim), u)
    delta = _seq(delta, (batch, L, dim), u)
    B = _seq(B, (batch, L, dstate), u)
    C = _seq(C, (batch, L, dstate), u)
    if z is not None:
        z = _seq(z, (batch, L, dim), u)
    A, a_sb = _param(A, batch, dim, dstate, dev)
    if D is None:
        D = torch.zeros(dim, device=dev)
    D, d_sb = _param(D, batch, dim, None, dev)
    if delta_bias is None:
        delta_bias = torch.zeros(dim, device=dev)
    bias, b_sb = _param(delta_bias, batch, dim, None, dev)
    h0_sb = 0
    if initial_state is not None:
        if tuple(initial_state.shape) != (batch, dim, dstate):
            raise ValueError("initial_state must be (batch, dim, dstate)")
        initial_state = initial_state.to(
            device=dev, dtype=torch.float32).contiguous()
        h0_sb = initial_state.stride(0)
    y = torch.empty((batch, L, dim), dtype=u.dtype, device=dev)
    last = torch.empty((batch, dim, dstate), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.vivim_selective_scan_fwd(
            ptr(u), ptr(delta), ptr(z), ptr(B), ptr(C), ptr(A), ptr(D),
            ptr(bias), ptr(initial_state), ptr(y), ptr(last), batch, L, dim,
            u.stride(0), u.stride(1), delta.stride(0), delta.stride(1),
            z.stride(0) if z is not None else 0,
            z.stride(1) if z is not None else 0,
            y.stride(0), y.stride(1), B.stride(0), B.stride(1),
            C.stride(0), C.stride(1), a_sb, d_sb, b_sb, h0_sb,
            int(bool(delta_softplus)), _DTYPES[u.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("selective_scan_fwd launch failed: "
                           + lib.vivim_cuda_error_string(err).decode())
    LAUNCHES += 1
    return y, last


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def selective_scan(
    u,
    delta,
    A,
    B,
    C,
    D=None,
    z=None,
    delta_bias=None,
    delta_softplus=False,
    return_last_state=False,
    initial_state=None,
    implementation=None,
):
    """Selective scan, time-major: see ``refs.selective_scan_ref`` for the
    contract.  ``implementation``: None (the CUDA kernel on CUDA tensors,
    the plain version on CPU tensors) or "ref" (the plain version).
    Grouped 4-D (batch, L, groups, dstate) B/C fold the groups into the
    batch axis (``_grouped_selective_scan``).  On CUDA the kernel takes
    variable B/C with d_state 16; constant (dim, dstate) B or C, alone or
    beside grouped ones, raise there.
    """
    if implementation not in (None, "ref"):
        raise ValueError(f"unknown implementation {implementation!r}")
    ref = lambda: refs.selective_scan_ref(
        u, delta, A, B, C, D, z, delta_bias, delta_softplus,
        return_last_state, initial_state=initial_state)
    if implementation == "ref":
        return ref()
    if (B.dim() == 4 or C.dim() == 4) and B.dim() >= 3 and C.dim() >= 3:
        return _grouped_selective_scan(
            u, delta, A, B, C, D, z, delta_bias, delta_softplus,
            return_last_state, initial_state, implementation)
    if u.device.type == "cpu":
        return ref()
    if B.dim() != 3 or C.dim() != 3:
        raise NotImplementedError(
            "constant (dim, dstate) B or C has no CUDA kernel; pass "
            "implementation='ref'")
    if _needs_grad(u, delta, A, B, C, D, z, delta_bias, initial_state):
        raise NotImplementedError(
            "selective_scan has no backward kernel on the GPU yet (ROADMAP "
            "Queue 2, K2); run under torch.no_grad() / inference_mode(), or "
            "pass implementation='ref'")
    y, last = selective_scan_fwd_cuda(
        u, delta, A, B, C, D, z, delta_bias, delta_softplus, initial_state)
    return (y, last) if return_last_state else y


def _grouped_selective_scan(u, delta, A, B, C, D, z, delta_bias,
                            delta_softplus, return_last_state, initial_state,
                            implementation):
    """Grouped B/C: fold the group axis into batch, (b, L, d) ->
    (b*G, L, d/G), and recurse with per-batch parameters."""
    batch, L, d = u.shape
    G = B.shape[2] if B.dim() == 4 else C.shape[2]
    if d % G:
        raise ValueError(f"dim {d} not divisible by n_groups {G}")
    dpg = d // G

    def fold_seq(x):  # (b, L, d) -> (b*G, L, d/G)
        if x is None:
            return None
        return (x.reshape(batch, L, G, dpg).transpose(1, 2)
                .reshape(batch * G, L, dpg))

    def fold_bc(x):  # (b, L, G, n) -> (b*G, L, n); (b, L, n) broadcasts
        if x.dim() == 3:
            x = x[:, :, None, :].expand(batch, L, G, x.shape[-1])
        return x.transpose(1, 2).reshape(batch * G, L, x.shape[-1])

    def fold_param(p, base_ndim):
        """(d, ...) shared or (b, d, ...) per batch -> (b*G, d/G, ...)."""
        if p is None:
            return None
        if p.dim() == base_ndim + 1:
            return p.reshape((batch * G, dpg) + tuple(p.shape[2:]))
        pg = p.reshape((G, dpg) + tuple(p.shape[1:]))
        return pg[None].expand((batch,) + tuple(pg.shape)).reshape(
            (batch * G, dpg) + tuple(p.shape[1:]))

    h0 = None
    if initial_state is not None:
        h0 = initial_state.reshape(batch * G, dpg, -1)
    out = selective_scan(
        fold_seq(u), fold_seq(delta), fold_param(A, 2), fold_bc(B),
        fold_bc(C), D=fold_param(D, 1), z=fold_seq(z),
        delta_bias=fold_param(delta_bias, 1),
        delta_softplus=delta_softplus, return_last_state=return_last_state,
        initial_state=h0, implementation=implementation)
    unfold = lambda y: (y.reshape(batch, G, L, dpg).transpose(1, 2)
                        .reshape(batch, L, d))
    if return_last_state:
        y, last = out
        return unfold(y), last.reshape(batch, d, -1)
    return unfold(out)


def selective_scan_cm(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                      delta_softplus=False, return_last_state=False,
                      **kwargs):
    """Channel-major ``(batch, dim, L)`` wrapper with the reference
    signature; grouped B/C arrive as (batch, groups, dstate, L)."""
    tm = lambda x: x.transpose(1, 2) if x is not None else None
    bc = lambda x: (x.permute(0, 3, 1, 2) if x.dim() == 4
                    else (tm(x) if x.dim() == 3 else x))
    out = selective_scan(tm(u), tm(delta), A, bc(B), bc(C), D, tm(z),
                         delta_bias, delta_softplus, return_last_state,
                         **kwargs)
    if return_last_state:
        y, last = out
        return tm(y), last
    return tm(out)
