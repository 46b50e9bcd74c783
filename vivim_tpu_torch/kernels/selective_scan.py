"""Selective scan (Mamba S6 recurrence): dispatch to the Hopper kernels.

Port of the JAX package's ``kernels/selective_scan.py`` (``selective_scan``,
``_grouped_selective_scan``, ``selective_scan_cm`` and the custom-VJP glue
``_selective_scan_core`` / ``_core_fwd`` / ``_core_bwd``).  The Pallas
kernels become CUDA kernels (see the notes at the top of each source):

- K1, ``_fwd_kernel`` -> ``csrc/selective_scan_fwd.cu``, in two variants:
  inference (silu(z) gated in the kernel; ``selective_scan_fwd_cuda``) and
  training (no z, chunk-start states saved; ``selective_scan_fwd_states_cuda``);
- K2, ``_bwd_kernel`` -> ``csrc/selective_scan_bwd.cu``
  (``selective_scan_bwd_cuda``).

This module checks and lays out their arguments, allocates their outputs and
scratch, launches them on PyTorch's current stream and counts the launches
(one count per wrapper call, whatever number of CUDA kernels the call runs;
a call inside a CUDA graph counts at each replay, ``utils/cuda_graphs.py``).

Both kernels take d_state N from 1 to ``MAX_DSTATE`` = 256, as mamba_ssm's
CUDA scan does; a channel's states sit in the registers of one thread or of
a few lanes of a warp, by N (see the sources).  K1 is a chunk-parallel
scan: L is cut into chunks of ``l_chunk`` steps (``fwd_l_chunk`` picks it
per shape, a multiple of ``CHUNK``), every chunk but the last is scanned
from a zero state, a carry pass chains the chunks' end states, and every
chunk is then re-walked from its true start state to write the output.
``refs.selective_scan_chunked_ref`` models those passes in plain PyTorch for
the tests.  K2 walks ``CHUNK``-step
chunks right to left from the states K1's training variant saves, in
segments of ``l_seg`` steps (``bwd_l_seg`` picks it per shape, a multiple of
``CHUNK``) that run in parallel: every segment but the first walks its steps
from a zero adjoint carry, a carry pass chains the segments right to left
over exp(A·S_k), and every segment then walks its chunks from its true carry
and writes the gradients, with parameter-grad partials summed over the
segments at the end.  ``refs.selective_scan_bwd_segmented_ref`` models those
passes in plain PyTorch for the tests.

Dispatch (``implementation=None``):
- when no input needs a gradient (or under ``no_grad`` / ``inference_mode``):
  the inference K1 on CUDA tensors, ``refs.selective_scan_ref`` on CPU ones;
- when one does: ``SelectiveScanFn``, a ``torch.autograd.Function`` that runs
  K1-training and gates with silu(z) outside the kernel, and whose backward
  forms dz and the pre-gate cotangent in PyTorch and launches K2 (as
  ``_core_fwd`` / ``_core_bwd`` do).  On CPU tensors it runs the plain
  versions of those two kernels, ``refs.selective_scan_fwd_states_ref`` and
  ``refs.selective_scan_bwd_ref``, so the CPU exercises the same glue.
``implementation="ref"`` runs the sequential plain version on any device,
with autograd through it, and so does a constant (dim, dstate) B or C, alone
or beside a grouped one, on any device, as the JAX package routes it: no
TPU kernel takes it, so there is no kernel to port.  That routing is decided
by the inputs' form before any launch; otherwise a CUDA tensor never falls
back to a plain version: a d_state above 256, a failed build or a failed
launch raises.

Layout is time-major: ``u/delta/z: (B, L, D)``, ``B/C: (B, L, N)``,
``A: (D, N)`` or per batch ``(B, D, N)``.
"""

from __future__ import annotations

import ctypes
import logging
import sys

import torch
import torch.nn.functional as F

from vivim_tpu_torch.kernels import _build, refs
from vivim_tpu_torch.utils import cuda_graphs
from vivim_tpu_torch.utils.profiling import span

_log = logging.getLogger(__name__)

# Kernel launches so far, per kernel; a caller resets them to 0 to count one
# run.  LAUNCHES: K1 inference; TRAIN_LAUNCHES: K1 training; BWD_LAUNCHES: K2.
# The public wrappers' spans ``scan.k1`` / ``scan.k2`` (``utils/profiling``)
# show each eager call in a profile's timeline with its kernels.
LAUNCHES = 0
TRAIN_LAUNCHES = 0
BWD_LAUNCHES = 0
cuda_graphs.count_launches(sys.modules[__name__], "LAUNCHES",
                           "TRAIN_LAUNCHES", "BWD_LAUNCHES")

# the largest d_state the kernels take (mamba_ssm's CUDA scan checks
# dstate <= 256 too; the Pallas kernels take any)
MAX_DSTATE = 256
# Steps between two saved chunk-start states (kChunk of both sources): the
# spacing of K1-training's saved states and K2's chunk.  K1's parallel chunk
# ``l_chunk`` is a multiple of it.
CHUNK = 16
FWD_BLOCKS_PER_SM = 4  # K1's grid aims at this many blocks per SM
MAX_CHUNKS = 65535  # K1's grid y dimension
# K2's grid aims at the blocks that fit on an SM at once (its kMinBlocks: 256
# threads at no more than 64 registers)
BWD_BLOCKS_PER_SM = 4
MAX_SEGMENTS = 65535  # K2's grid y dimension
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIBS = {}
_SMS = {}


def _lib(name):
    lib = _LIBS.get(name)
    if lib is None:
        lib = _build.load(name)
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        if name == "selective_scan_fwd":
            lib.vivim_selective_scan_fwd.argtypes = (
                [ptr] * 14 + [i32] * 6 + [i64] * 16 + [i32, i32, ptr])
            lib.vivim_selective_scan_fwd.restype = i32
            lib.vivim_selective_scan_fwd_channels.argtypes = [i32]
            lib.vivim_selective_scan_fwd_channels.restype = i32
        else:
            lib.vivim_selective_scan_bwd.argtypes = (
                [ptr] * 19 + [i32] * 6 + [i64] * 13 + [i32, i32, ptr])
            lib.vivim_selective_scan_bwd.restype = i32
            lib.vivim_selective_scan_bwd_scratch.argtypes = [i32] * 5
            lib.vivim_selective_scan_bwd_scratch.restype = i64
            lib.vivim_selective_scan_bwd_channels.argtypes = [i32]
            lib.vivim_selective_scan_bwd_channels.restype = i32
        lib.vivim_cuda_error_string.argtypes = [i32]
        lib.vivim_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


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


def _state(x, batch, dim, dstate, dev, what):
    """Optional (batch, dim, dstate) fp32 state, contiguous."""
    if x is None:
        return None
    if tuple(x.shape) != (batch, dim, dstate):
        raise ValueError(f"{what} must be (batch, dim, dstate)")
    return x.to(device=dev, dtype=torch.float32).contiguous()


def check_dstate(dstate):
    """Raise for a d_state the CUDA kernels do not take: 1 to
    ``MAX_DSTATE``."""
    if not 1 <= dstate <= MAX_DSTATE:
        raise ValueError(
            f"d_state {dstate}: the CUDA selective-scan kernels take d_state "
            f"1 to {MAX_DSTATE}, the limit mamba_ssm's CUDA scan has too")


def _check(u, A, name):
    """Raise for what the kernels do not take; returns d_state."""
    if u.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors")
    if u.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {u.dtype} (fp32 or bf16)")
    dstate = A.shape[-1]
    check_dstate(dstate)
    if u.shape[0] > 65535:
        raise ValueError(f"batch {u.shape[0]} exceeds the kernel grid")
    return dstate


def _raise_if(err, lib, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.vivim_cuda_error_string(err).decode())


def _ptr(t):
    return None if t is None else t.data_ptr()


def fwd_channels(dstate):
    """Channels per block of K1 at ``dstate``, as its library was built."""
    check_dstate(dstate)
    return _lib("selective_scan_fwd").vivim_selective_scan_fwd_channels(
        dstate)


def fwd_l_chunk(batch, L, dim, sms, channels):
    """K1's parallel chunk for a shape, on ``sms`` SMs with ``channels``
    channels per block (``fwd_channels``): the longest multiple of
    ``CHUNK`` that still cuts L into enough chunks for the grid (channel
    tiles x chunks x batch) to hold about ``FWD_BLOCKS_PER_SM`` blocks per
    SM, and into at most ``MAX_CHUNKS``."""
    tiles = batch * -(-dim // channels)
    chunks = max(1, -(-FWD_BLOCKS_PER_SM * sms // tiles))
    steps = max(-(-L // chunks), -(-L // MAX_CHUNKS), 1)
    return -(-steps // CHUNK) * CHUNK


def fwd_grid(batch, L, dim, l_chunk, channels):
    """(channel tiles, chunks, batch): the grid of K1's output pass."""
    return (-(-dim // channels), max(1, -(-L // l_chunk)), batch)


def bwd_channels(dstate):
    """Channels per block of K2 at ``dstate``, as its library was built."""
    check_dstate(dstate)
    return _lib("selective_scan_bwd").vivim_selective_scan_bwd_channels(
        dstate)


def bwd_l_seg(batch, L, dim, sms, channels):
    """K2's segment for a shape, on ``sms`` SMs with ``channels`` channels
    per block: the longest multiple of ``CHUNK`` that cuts L into as many
    segments as the grid (channel tiles x segments x batch) can hold while
    it still fits on the card at once, ``BWD_BLOCKS_PER_SM`` blocks per SM
    (one segment when the tiles alone fill it), and into at most
    ``MAX_SEGMENTS``."""
    tiles = batch * -(-dim // channels)
    segs = max(1, BWD_BLOCKS_PER_SM * sms // tiles)
    steps = max(-(-L // segs), -(-L // MAX_SEGMENTS), 1)
    return -(-steps // CHUNK) * CHUNK


def bwd_grid(batch, L, dim, l_seg, channels):
    """(channel tiles, segments, batch): the grid of K2's main pass.
    Raises for an ``l_seg`` the kernel refuses."""
    segs = max(1, -(-L // l_seg)) if l_seg > 0 else 0
    if l_seg <= 0 or l_seg % CHUNK or segs > MAX_SEGMENTS:
        raise ValueError(f"l_seg {l_seg} must be a positive multiple of "
                         f"{CHUNK} giving at most {MAX_SEGMENTS} segments")
    return (-(-dim // channels), segs, batch)


def _sm_count(dev):
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SMS[idx]


def _fwd_launch(u, delta, A, B, C, D, z, delta_bias, delta_softplus,
                initial_state, save_states, l_chunk=None):
    """K1 on CUDA tensors; returns (out, chunk states or None, last state).
    ``l_chunk`` (a multiple of ``CHUNK``) overrides the parallel chunk
    ``fwd_l_chunk`` picks; the card checks use it to cross chunk edges.
    Counts nothing: the public wrappers count their calls."""
    N = _check(u, A, "selective_scan_fwd_cuda")
    batch, L, dim = u.shape
    dev = u.device
    u = _seq(u, (batch, L, dim), u)
    delta = _seq(delta, (batch, L, dim), u)
    B = _seq(B, (batch, L, N), u)
    C = _seq(C, (batch, L, N), u)
    if z is not None:
        z = _seq(z, (batch, L, dim), u)
    A, a_sb = _param(A, batch, dim, N, dev)
    if D is None:
        D = torch.zeros(dim, device=dev)
    D, d_sb = _param(D, batch, dim, None, dev)
    if delta_bias is None:
        delta_bias = torch.zeros(dim, device=dev)
    bias, b_sb = _param(delta_bias, batch, dim, None, dev)
    h0 = _state(initial_state, batch, dim, N, dev, "initial_state")
    lib = _lib("selective_scan_fwd")
    if l_chunk is None:
        l_chunk = fwd_l_chunk(batch, L, dim, _sm_count(dev), fwd_channels(N))
    if l_chunk <= 0 or l_chunk % CHUNK or -(-L // l_chunk) > MAX_CHUNKS:
        raise ValueError(f"l_chunk {l_chunk} must be a positive multiple of "
                         f"{CHUNK} giving at most {MAX_CHUNKS} chunks")
    n_chunks = max(1, -(-L // l_chunk))
    f32 = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    y = torch.empty((batch, L, dim), dtype=u.dtype, device=dev)
    last = f32(batch, dim, N)
    cs = f32(batch, -(-L // CHUNK), dim, N) if save_states else None
    # the carry's scratch: chunk end states, then chunk start states
    hbuf = f32(batch, n_chunks - 1, dim, N) if n_chunks > 1 else None
    sbuf = f32(batch, n_chunks - 1, dim) if n_chunks > 1 else None
    with torch.cuda.device(dev):
        err = lib.vivim_selective_scan_fwd(
            _ptr(u), _ptr(delta), _ptr(z), _ptr(B), _ptr(C), _ptr(A),
            _ptr(D), _ptr(bias), _ptr(h0), _ptr(y), _ptr(last), _ptr(cs),
            _ptr(hbuf), _ptr(sbuf), CHUNK, l_chunk, batch, L, dim, N,
            u.stride(0), u.stride(1), delta.stride(0), delta.stride(1),
            z.stride(0) if z is not None else 0,
            z.stride(1) if z is not None else 0,
            y.stride(0), y.stride(1), B.stride(0), B.stride(1),
            C.stride(0), C.stride(1), a_sb, d_sb, b_sb,
            h0.stride(0) if h0 is not None else 0,
            int(bool(delta_softplus)), _DTYPES[u.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_if(err, lib, "selective_scan_fwd")
    return y, cs, last


def selective_scan_fwd_cuda(u, delta, A, B, C, D=None, z=None,
                            delta_bias=None, delta_softplus=False,
                            initial_state=None):
    """Launch the inference variant of K1; returns (out, last_state fp32).

    All tensors lie on one CUDA device; u, delta, z, B and C are fp32 or
    bf16 of one dtype and may be strided views with unit stride on their
    last axis (the B/C column slices of x_proj's output, z the second half
    of in_proj's) — nothing is copied for them.
    """
    global LAUNCHES
    with span("scan.k1"):
        y, _, last = _fwd_launch(u, delta, A, B, C, D, z, delta_bias,
                                 delta_softplus, initial_state, False)
    LAUNCHES += 1
    return y, last


def selective_scan_fwd_states_cuda(u, delta, A, B, C, D=None,
                                   delta_bias=None, delta_softplus=False,
                                   initial_state=None):
    """Launch the training variant of K1 (no z); returns the pre-gate
    output, the fp32 chunk-start states (batch, ceil(L / CHUNK), dim,
    dstate) and the fp32 last state, as
    ``refs.selective_scan_fwd_states_ref``."""
    global TRAIN_LAUNCHES
    with span("scan.k1"):
        out = _fwd_launch(u, delta, A, B, C, D, None, delta_bias,
                          delta_softplus, initial_state, True)
    TRAIN_LAUNCHES += 1
    return out


def _bwd_launch(u, delta, A, B, C, D, delta_bias, chunk_states, dout,
                dlast, delta_softplus, l_seg=None):
    """K2 on CUDA tensors; returns the eight gradients.  ``l_seg`` (a
    multiple of ``CHUNK``) overrides the segment length ``bwd_l_seg``
    picks; the card checks use it to cross segment edges.  Counts nothing:
    the public wrapper counts its calls."""
    N = _check(u, A, "selective_scan_bwd_cuda")
    batch, L, dim = u.shape
    dev = u.device
    u = _seq(u, (batch, L, dim), u)
    delta = _seq(delta, (batch, L, dim), u)
    B = _seq(B, (batch, L, N), u)
    C = _seq(C, (batch, L, N), u)
    dout = _seq(dout, (batch, L, dim), u)
    A, a_sb = _param(A, batch, dim, N, dev)
    D, d_sb = _param(torch.zeros(dim, device=dev) if D is None else D,
                     batch, dim, None, dev)
    bias, b_sb = _param(
        torch.zeros(dim, device=dev) if delta_bias is None else delta_bias,
        batch, dim, None, dev)
    if tuple(chunk_states.shape) != (batch, -(-L // CHUNK), dim, N) \
            or chunk_states.dtype != torch.float32:
        raise ValueError("chunk_states must be fp32 (batch, ceil(L / "
                         f"{CHUNK}), dim, dstate)")
    cs = chunk_states.contiguous()
    dlast = _state(dlast, batch, dim, N, dev, "dlast")
    lib = _lib("selective_scan_bwd")
    channels = bwd_channels(N)
    if l_seg is None:
        l_seg = bwd_l_seg(batch, L, dim, _sm_count(dev), channels)
    bwd_grid(batch, L, dim, l_seg, channels)  # raises for what K2 refuses
    seq = lambda *s: torch.empty(s, dtype=u.dtype, device=dev)
    f32 = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    ddelta, du = seq(batch, L, dim), seq(batch, L, dim)
    dB, dC = seq(batch, L, N), seq(batch, L, N)
    dA, dh0 = f32(batch, dim, N), f32(batch, dim, N)
    dD, dbias = f32(batch, dim), f32(batch, dim)
    # dB / dC partials, segment carries and parameter-grad partials
    scratch = f32(lib.vivim_selective_scan_bwd_scratch(batch, L, dim, N,
                                                       l_seg))
    with torch.cuda.device(dev):
        err = lib.vivim_selective_scan_bwd(
            _ptr(u), _ptr(delta), _ptr(B), _ptr(C), _ptr(dout), _ptr(A),
            _ptr(D), _ptr(bias), _ptr(cs), _ptr(dlast), _ptr(ddelta),
            _ptr(du), _ptr(dB), _ptr(dC), _ptr(dA), _ptr(dD), _ptr(dbias),
            _ptr(dh0), _ptr(scratch), CHUNK, l_seg, batch, L, dim, N,
            u.stride(0), u.stride(1), delta.stride(0), delta.stride(1),
            B.stride(0), B.stride(1), C.stride(0), C.stride(1),
            dout.stride(0), dout.stride(1), a_sb, d_sb, b_sb,
            int(bool(delta_softplus)), _DTYPES[u.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_if(err, lib, "selective_scan_bwd")
    return ddelta, du, dB, dC, dA, dD, dbias, dh0


def selective_scan_bwd_cuda(u, delta, A, B, C, D, delta_bias, chunk_states,
                            dout, dlast=None, delta_softplus=False):
    """Launch K2; returns what ``refs.selective_scan_bwd_ref`` returns:
    (ddelta, du, dB, dC) contiguous in the activation dtype and per batch
    row in fp32 (dA, dD, dbias, dh0).  ``chunk_states`` come from
    ``selective_scan_fwd_states_cuda`` on the same inputs; D, delta_bias
    and dlast may be None."""
    global BWD_LAUNCHES
    with span("scan.k2"):
        out = _bwd_launch(u, delta, A, B, C, D, delta_bias, chunk_states,
                          dout, dlast, delta_softplus)
    BWD_LAUNCHES += 1
    return out


class SelectiveScanFn(torch.autograd.Function):
    """Differentiable selective scan on the kernels (the plain versions of
    the same two kernels on CPU tensors).  Mirrors the JAX package's
    ``_core_fwd`` / ``_core_bwd``: the silu(z) gate runs outside the
    kernels, so K2 never touches z.  B and C are (batch, L, dstate).
    Returns (out, last_state)."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, z, delta_bias, initial_state,
                delta_softplus):
        if u.is_cuda:
            y_pre, cs, last = selective_scan_fwd_states_cuda(
                u, delta, A, B, C, D, delta_bias, delta_softplus,
                initial_state)
        else:
            y_pre, cs, last = refs.selective_scan_fwd_states_ref(
                u, delta, A, B, C, D, delta_bias, delta_softplus,
                initial_state, chunk=CHUNK)
        y = y_pre
        if z is not None:
            y = (y_pre.float() * F.silu(z.float())).to(y_pre.dtype)
        ctx.save_for_backward(u, delta, A, B, C, D, z, delta_bias, cs, y_pre)
        ctx.delta_softplus = delta_softplus
        ctx.set_materialize_grads(False)
        return y, last

    @staticmethod
    def backward(ctx, dout, dlast):
        u, delta, A, B, C, D, z, delta_bias, cs, y_pre = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(y_pre)
        dz = None
        if z is not None:
            # gating grads in PyTorch; the kernel sees the pre-gate cotangent
            zf = z.float()
            sig = torch.sigmoid(zf)
            silu = zf * sig
            doutf = dout.float()
            dz = (doutf * y_pre.float() * (sig + silu * (1.0 - sig))).to(
                z.dtype)
            dout = doutf * silu
        dout = dout.to(u.dtype)
        bwd = (selective_scan_bwd_cuda if u.is_cuda
               else lambda *a: refs.selective_scan_bwd_ref(*a, chunk=CHUNK))
        ddelta, du, dB, dC, dA, dD, dbias, dh0 = bwd(
            u, delta, A, B, C, D, delta_bias, cs, dout, dlast,
            ctx.delta_softplus)
        # parameter grads are per batch row: sum those of shared parameters
        if A.dim() == 2:
            dA = dA.sum(0)
        if D is not None and D.dim() == 1:
            dD = dD.sum(0)
        if delta_bias is not None and delta_bias.dim() == 1:
            dbias = dbias.sum(0)
        cast = lambda g, x: None if x is None else g.to(x.dtype)
        return (du.to(u.dtype), ddelta.to(delta.dtype), cast(dA, A),
                dB.to(B.dtype), dC.to(C.dtype), cast(dD, D), dz,
                cast(dbias, delta_bias),
                dh0 if ctx.needs_input_grad[8] else None, None)


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
    seq_axis=None,
    mesh=None,
):
    """Selective scan, time-major: see ``refs.selective_scan_ref`` for the
    contract.  ``implementation``: None (the kernels on CUDA tensors, their
    plain versions on CPU tensors; see the module docstring) or "ref" (the
    sequential plain version).  Grouped 4-D (batch, L, groups, dstate) B/C
    fold the groups into the batch axis (``_grouped_selective_scan``).  On
    CUDA the kernels take variable B/C with d_state 1 to ``MAX_DSTATE`` and
    raise for a larger one; a constant (dim, dstate) B or C, alone or beside
    a grouped one, runs the sequential plain version on any device, with
    autograd through it and one log line, as the JAX package routes it.

    ``seq_axis`` + ``mesh`` (a ``parallel.mesh.Mesh``): shard L over the
    ranks of that axis and run the sequence-parallel scan
    (``parallel/seq_scan.py``).  It requires delta_softplus=True and no
    initial_state.  An L that does not divide by the axis size runs the
    one-device scan on every rank, with the JAX package's log line.
    """
    if implementation not in (None, "ref"):
        raise ValueError(f"unknown implementation {implementation!r}")
    n_shards = (mesh.size(seq_axis)
                if seq_axis is not None and mesh is not None else 1)
    if n_shards > 1:
        # one line per call: which scans sharded and which did not
        if u.shape[1] % n_shards == 0:
            _log.info("seq-sharded scan: L=%d sharded over %d '%s' devices "
                      "(shape %s)", u.shape[1], n_shards, seq_axis,
                      tuple(u.shape))
        else:
            _log.info("seq-shard FALLBACK: L=%d %% %d shards != 0 -> "
                      "single-device scan (shape %s)", u.shape[1], n_shards,
                      tuple(u.shape))
    if n_shards > 1 and u.shape[1] % n_shards == 0:
        from vivim_tpu_torch.parallel.seq_scan import (
            seq_sharded_selective_scan,
        )

        if not delta_softplus or initial_state is not None:
            raise ValueError(
                "seq-sharded scan requires delta_softplus=True and no "
                "initial_state")
        y, last = seq_sharded_selective_scan(
            u, delta, A, B, C, D=D, z=z, delta_bias=delta_bias, mesh=mesh,
            axis_name=seq_axis, implementation=implementation,
            return_last_state=return_last_state)
        return (y, last) if return_last_state else y
    ref = lambda: refs.selective_scan_ref(
        u, delta, A, B, C, D, z, delta_bias, delta_softplus,
        return_last_state, initial_state=initial_state)
    if implementation == "ref":
        return ref()
    if (B.dim() == 4 or C.dim() == 4) and B.dim() >= 3 and C.dim() >= 3:
        return _grouped_selective_scan(
            u, delta, A, B, C, D, z, delta_bias, delta_softplus,
            return_last_state, initial_state, implementation)
    if B.dim() != 3 or C.dim() != 3:
        # no TPU kernel takes a constant (dim, dstate) B or C: the JAX
        # package runs its sequential reference for it, and so does the port
        _log.info("constant B/C: B %s, C %s -> sequential plain scan "
                  "(shape %s)", tuple(B.shape), tuple(C.shape),
                  tuple(u.shape))
        return ref()
    if _needs_grad(u, delta, A, B, C, D, z, delta_bias, initial_state):
        y, last = SelectiveScanFn.apply(u, delta, A, B, C, D, z, delta_bias,
                                        initial_state, delta_softplus)
    elif u.device.type == "cpu":
        return ref()
    else:
        y, last = selective_scan_fwd_cuda(
            u, delta, A, B, C, D, z, delta_bias, delta_softplus,
            initial_state)
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
