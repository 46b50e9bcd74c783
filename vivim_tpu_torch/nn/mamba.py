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
direction in the backward (``mamba_inner(remat=True)``).  ``seq_axis`` +
``mesh`` shard the scan's tokens over that mesh axis
(``parallel/seq_scan.py``); the flips, permutes and projections around it
run whole on every rank of the axis.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from vivim_tpu_torch.kernels.mamba_inner import (
    mamba_inner,
    mamba_inner_grouped,
)
from vivim_tpu_torch.nn.layers import DropPath, Mlp

_SUFFIXES = {"v3": ("", "_b", "_s"), "v2": ("", "_b"), "none": ("",)}


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
                torch.rand(self.d_inner, generator=gen)
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

    def forward(self, x, nframes: int = 1):
        """x: (B, L, d_model) frame-major tokens, L = nframes * H * W."""
        B, L, _ = x.shape
        xz = self.in_proj(x)
        if self.bimamba_type == "v3":
            if L % nframes:
                raise ValueError(
                    f"seqlen {L} not divisible by nframes {nframes}")
            ps = [self._direction(s) for s in _SUFFIXES["v3"]]
            stack = lambda key: (None if ps[0][key] is None else
                                 torch.stack([p[key] for p in ps]))
            xz_all = torch.cat([xz, xz.flip(1),
                                frame_to_position_major(xz, nframes)])
            out_all = mamba_inner_grouped(
                xz_all, stack("conv_w"), stack("conv_b"), stack("x_proj"),
                stack("dt_proj"), stack("A_log"), stack("D"),
                stack("dt_bias"), nb=B,
                implementation=self.scan_implementation,
                remat=self.remat_pre_scan, seq_axis=self.seq_axis,
                mesh=self.mesh)
            out_f, out_b, out_s = out_all.split(B)
            out = (out_f + out_b.flip(1)
                   + position_to_frame_major(out_s, nframes)) / 3.0
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

    def forward(self, x, nframes: int, H: int, W: int):
        x = x + self.drop_path(self.mamba(self.norm1(x), nframes=nframes))
        return x + self.drop_path(self.mlp(self.norm2(x), nframes, H, W))
