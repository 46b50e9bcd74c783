"""Tri-directional Mamba mixer (bimamba v3) and the Vivim MambaLayer.

Port of the JAX package's ``nn/mamba.py``.  Parameter names are the reference
Mamba's (mamba_simple.py): ``in_proj``, ``out_proj`` and, per direction
suffix s in {"", "_b", "_s"}, ``conv1d{s}`` (depthwise, (d, 1, width)),
``x_proj{s}``, ``dt_proj{s}`` (weight + bias), ``A{s}_log`` and ``D{s}``.

- ``bimamba_type="v3"``: the forward, time-flipped and frame->position
  permuted sequences and their parameter sets stack along the batch axis,
  so the mixer runs one conv/projection chain and ONE scan launch; the
  three outputs are averaged.
- ``"v2"``: forward + flipped backward, summed (not averaged).
- ``"none"``: forward only.

``remat_pre_scan`` recomputes the conv + projection chain of every
direction in the backward (``mamba_inner(remat=True)``).

Sequence parallel (``seq_axis`` + ``mesh``, the JAX package's
``P(batch, "seq", None)`` tokens): ``MambaLayer`` and ``MambaV3`` called
with ``seq_group`` take and return this rank's (B, L/S, C) token shard of
that group's sequence (``nn/vivim.py`` slices a stage's tokens before its
first layer and gathers them after its last).  Every op is per token on
the shard but these exchanges (``parallel/comm.py``):
- the time-flipped and position-major directions are the shards of
  permutations of the whole sequence (``comm.seq_permute``: one gather of
  xz for both, one of the two outputs for their inverses);
- the causal conv reads the left neighbour's last ``d_conv - 1`` tokens
  (``comm.seq_halo``) and the scan carries its state across the ranks
  (``parallel/seq_scan.py``);
- the Mix-FFN's 3-D conv runs on the whole sequence, gathered
  (``comm.seq_gather_partial``), and each rank keeps its slice, as GSPMD
  places it in the JAX package.
The dropout masks are the slices of the masks one device draws, and the
drop-path masks one device's, so a step does not depend on S.  After a
sharded forward the gradient of every parameter of the layer but the
scan's A_log, D and dt bias (which the scan sums itself) is this rank's
part, summed over the group by the train step
(``MambaLayer.seq_partial_parameters``).  A layer called without
``seq_group`` takes the whole sequence, and its scan shards L over
``seq_axis`` itself when it divides (``selective_scan``), or logs the
JAX package's FALLBACK line and runs whole.
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn

from vivim_tpu_torch.kernels.mamba_inner import (
    mamba_inner,
    mamba_inner_grouped,
)
from vivim_tpu_torch.nn.layers import DropPath, Mlp
from vivim_tpu_torch.parallel import comm

_SUFFIXES = {"v3": ("", "_b", "_s"), "v2": ("", "_b"), "none": ("",)}
# the parameters only the scan reads: its backward sums their gradients
# over the seq group itself
_SCAN_PARAMS = tuple(f"mamba.{p}{s}{q}" for s in _SUFFIXES["v3"]
                     for p, q in (("A", "_log"), ("D", ""),
                                  ("dt_proj", ".bias")))


def frame_to_position_major(x, nframes: int):
    """(B, T*S, C) frame-major tokens -> (B, S*T, C) position-major: the
    scan then runs across frames at a fixed spatial position."""
    B, L, C = x.shape
    return x.reshape(B, nframes, L // nframes, C).transpose(1, 2).reshape(
        B, L, C)


def position_to_frame_major(x, nframes: int):
    """Inverse of ``frame_to_position_major``."""
    B, L, C = x.shape
    return x.reshape(B, L // nframes, nframes, C).transpose(1, 2).reshape(
        B, L, C)


@functools.lru_cache(maxsize=64)
def direction_index(L: int, nframes: int, device: torch.device):
    """(into the directions, out of them): two (2, L) maps of global token
    positions for ``comm.seq_permute``.  The first takes the frame-major
    sequence to the time-flipped and the position-major ones, the second
    takes those two back to frame-major."""
    pos = torch.arange(L, device=device)
    col = pos[None, :, None]
    flip = pos.flip(0)
    return (torch.stack([flip, frame_to_position_major(col, nframes)
                         .flatten()]),
            torch.stack([flip, position_to_frame_major(col, nframes)
                         .flatten()]))


class MambaV3(nn.Module):
    """Selective-SSM mixer with optional bi/tri-directional scans."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4,
                 expand: int = 2, dt_rank: int | None = None,
                 dt_min: float = 0.001, dt_max: float = 0.1,
                 dt_scale: float = 1.0, dt_init_floor: float = 1e-4,
                 conv_bias: bool = True, bias: bool = False,
                 bimamba_type: str = "v3",
                 scan_implementation: str | None = None,
                 remat_pre_scan: bool = False, seq_axis: str | None = None,
                 mesh=None):
        super().__init__()
        if bimamba_type not in _SUFFIXES:
            raise ValueError(f"unknown bimamba_type {bimamba_type!r}")
        self.d_model, self.d_state, self.d_conv = d_model, d_state, d_conv
        self.d_inner = expand * d_model
        self.dt_rank = dt_rank or math.ceil(d_model / 16)
        self.dt_min, self.dt_max = dt_min, dt_max
        self.dt_scale, self.dt_init_floor = dt_scale, dt_init_floor
        self.bimamba_type = bimamba_type
        self.scan_implementation = scan_implementation
        self.remat_pre_scan = remat_pre_scan
        self.seq_axis, self.mesh = seq_axis, mesh
        d_inner, n, rank = self.d_inner, d_state, self.dt_rank
        self.in_proj = nn.Linear(d_model, 2 * d_inner, bias=bias)
        for s in _SUFFIXES[bimamba_type]:
            setattr(self, f"conv1d{s}", nn.Conv1d(
                d_inner, d_inner, d_conv, groups=d_inner, bias=conv_bias,
                padding=d_conv - 1))
            setattr(self, f"x_proj{s}", nn.Linear(d_inner, rank + 2 * n,
                                                  bias=False))
            setattr(self, f"dt_proj{s}", nn.Linear(rank, d_inner))
            setattr(self, f"A{s}_log", nn.Parameter(torch.empty(d_inner, n)))
            setattr(self, f"D{s}", nn.Parameter(torch.empty(d_inner)))
        self.out_proj = nn.Linear(d_inner, d_model, bias=bias)

    @torch.no_grad()
    def init_parameters(self, gen):
        """Reference init (mamba_simple.py:89-121): conv U(+-sqrt(1/width)),
        dt_proj weight U(+-dt_rank^-0.5 * dt_scale), dt_proj bias the
        inverse softplus of a log-uniform dt in [dt_min, dt_max] floored at
        dt_init_floor, A_log = log(1..N) per channel, D = 1."""
        conv_bound = math.sqrt(1.0 / self.d_conv)
        dt_std = self.dt_rank ** -0.5 * self.dt_scale
        for s in _SUFFIXES[self.bimamba_type]:
            conv = getattr(self, f"conv1d{s}")
            nn.init.uniform_(conv.weight, -conv_bound, conv_bound,
                             generator=gen)
            if conv.bias is not None:
                nn.init.uniform_(conv.bias, -conv_bound, conv_bound,
                                 generator=gen)
            dt_proj = getattr(self, f"dt_proj{s}")
            nn.init.uniform_(dt_proj.weight, -dt_std, dt_std, generator=gen)
            dt = torch.exp(
                torch.rand(self.d_inner, generator=gen, device=gen.device)
                * (math.log(self.dt_max) - math.log(self.dt_min))
                + math.log(self.dt_min)).clamp(min=self.dt_init_floor)
            dt_proj.bias.copy_(dt + torch.log(-torch.expm1(-dt)))
            getattr(self, f"A{s}_log").copy_(torch.log(
                torch.arange(1, self.d_state + 1, dtype=torch.float32)
            ).expand(self.d_inner, self.d_state))
            getattr(self, f"D{s}").fill_(1.0)

    def _direction(self, s):
        conv = getattr(self, f"conv1d{s}")
        dt_proj = getattr(self, f"dt_proj{s}")
        return dict(conv_w=conv.weight[:, 0, :].t(), conv_b=conv.bias,
                    x_proj=getattr(self, f"x_proj{s}").weight,
                    dt_proj=dt_proj.weight, dt_bias=dt_proj.bias,
                    A_log=getattr(self, f"A{s}_log"),
                    D=getattr(self, f"D{s}"))

    def _scan(self, xz, s):
        p = self._direction(s)
        return mamba_inner(
            xz, p["conv_w"], p["conv_b"], p["x_proj"], p["dt_proj"],
            -torch.exp(p["A_log"].float()), D=p["D"].float(),
            delta_bias=p["dt_bias"].float(), delta_softplus=True,
            implementation=self.scan_implementation,
            remat=self.remat_pre_scan, seq_axis=self.seq_axis,
            mesh=self.mesh)

    def forward(self, x, nframes: int = 1, seq_group=None):
        """x: (B, L, d_model) frame-major tokens, L = nframes * H * W, or
        with ``seq_group`` this rank's (B, L/S, d_model) shard of them
        (v3 only; module docstring)."""
        B, L, _ = x.shape
        L *= comm.size(seq_group)
        xz = self.in_proj(x)
        if self.bimamba_type == "v3":
            if L % nframes:
                raise ValueError(
                    f"seqlen {L} not divisible by nframes {nframes}")
            ps = [self._direction(s) for s in _SUFFIXES["v3"]]
            stack = lambda key: (None if ps[0][key] is None else
                                 torch.stack([p[key] for p in ps]))
            if seq_group is None:
                xz_all = torch.cat([xz, xz.flip(1),
                                    frame_to_position_major(xz, nframes)])
            else:
                into, back = direction_index(L, nframes, x.device)
                xz_all = torch.cat([xz, *comm.seq_permute(
                    xz[None], into, seq_group)])
            out_all = mamba_inner_grouped(
                xz_all, stack("conv_w"), stack("conv_b"), stack("x_proj"),
                stack("dt_proj"), stack("A_log"), stack("D"),
                stack("dt_bias"), nb=B,
                implementation=self.scan_implementation,
                remat=self.remat_pre_scan, seq_axis=self.seq_axis,
                mesh=self.mesh, seq_group=seq_group)
            out_f, out_b, out_s = out_all.split(B)
            if seq_group is None:
                out = (out_f + out_b.flip(1)
                       + position_to_frame_major(out_s, nframes)) / 3.0
            else:
                out_b, out_s = comm.seq_permute(
                    torch.stack([out_b, out_s]), back, seq_group)
                out = (out_f + out_b + out_s) / 3.0
        elif seq_group is not None:
            raise ValueError("a sequence-sharded mixer is bimamba v3 only, "
                             f"not {self.bimamba_type!r}")
        else:
            out = self._scan(xz, "")
            if self.bimamba_type == "v2":
                # the reference v2 path sums without averaging
                out = out + self._scan(xz.flip(1), "_b").flip(1)
        return self.out_proj(out)


class MambaLayer(nn.Module):
    """Vivim block: ``x + DropPath(Mamba(LN(x)))`` then
    ``x + DropPath(Mlp(LN(x)))`` over (B, T*H*W, C) tokens."""

    def __init__(self, dim: int, d_state: int = 16, d_conv: int = 4,
                 expand: int = 2, mlp_ratio: float = 4.0,
                 dropout_rate: float = 0.0, drop_path: float = 0.0,
                 scan_implementation: str | None = None,
                 gelu_approximate: bool = False,
                 remat_pre_scan: bool = False, seq_axis: str | None = None,
                 mesh=None):
        super().__init__()
        # torch LayerNorm eps 1e-5 (reference vivim.py:147,153)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.mamba = MambaV3(dim, d_state=d_state, d_conv=d_conv,
                             expand=expand, bimamba_type="v3",
                             scan_implementation=scan_implementation,
                             remat_pre_scan=remat_pre_scan,
                             seq_axis=seq_axis, mesh=mesh)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dropout_rate=dropout_rate,
                       gelu_approximate=gelu_approximate)
        self.drop_path = DropPath(drop_path)
        # whether the last forward took a token shard
        self.ran_sharded = False

    def forward(self, x, nframes: int, H: int, W: int, seq_group=None):
        """x: (B, L, C) tokens, L = nframes * H * W, or with ``seq_group``
        this rank's (B, L/S, C) shard of them (module docstring)."""
        self.ran_sharded = seq_group is not None
        x = x + self.drop_path(self.mamba(self.norm1(x), nframes=nframes,
                                          seq_group=seq_group))
        return x + self.drop_path(self.mlp(self.norm2(x), nframes, H, W,
                                           seq_group))

    def seq_partial_parameters(self):
        """The parameters whose gradient on this rank is only its token
        shard's part after the last forward, to be summed over the seq
        group: all but the scan's (``_SCAN_PARAMS``) after a sharded
        forward, none after a whole one."""
        if not self.ran_sharded:
            return []
        return [p for n, p in self.named_parameters()
                if n not in _SCAN_PARAMS]
