"""SegFormer (MiT) encoder, channels-last at its interfaces.

Port of the JAX package's ``nn/segformer.py`` (configs, ``OverlapPatchEmbed``,
``EfficientSelfAttention``, ``DepthwiseConv2d``, ``MixFFN``,
``SegformerLayer``, the stage, ``drop_path_schedule``, ``resize_bilinear``).
Keys follow HuggingFace's SegformerEncoder (``patch_embeddings.{i}``,
``block.{i}.{j}``, ``layer_norm.{i}``), which the reference Vivim nests
under ``encoder.downsample_layers``.

Numerics follow the JAX package, not HF, where the two differ:
- LayerNorm eps is 1e-6 (flax's default) where HF uses 1e-5;
- the spatial-reduction conv pads like flax's "SAME" (asymmetric when the
  map is not divisible by the ratio) where HF pads 0.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch.nn.functional as F
from torch import nn

from vivim_tpu_torch.nn.layers import Dropout, DropPath, checkpoint

LN_EPS = 1e-6  # flax nn.LayerNorm default, as the JAX package uses


@dataclasses.dataclass(frozen=True)
class SegformerConfig:
    num_channels: int = 3
    depths: Sequence[int] = (3, 4, 18, 3)
    hidden_sizes: Sequence[int] = (64, 128, 320, 512)
    num_attention_heads: Sequence[int] = (1, 2, 5, 8)
    sr_ratios: Sequence[int] = (8, 4, 2, 1)
    patch_sizes: Sequence[int] = (7, 3, 3, 3)
    strides: Sequence[int] = (4, 2, 2, 2)
    mlp_ratios: Sequence[int] = (4, 4, 4, 4)
    hidden_dropout: float = 0.0
    attention_dropout: float = 0.0
    drop_path_rate: float = 0.1
    classifier_dropout: float = 0.1
    decoder_hidden_size: int = 768
    num_labels: int = 150
    gelu_approximate: bool = False  # exact erf GELU by default
    # recompute each SegformerLayer in the backward (keep only its input)
    remat_layers: bool = False

    @property
    def num_stages(self):
        return len(self.depths)


def mit_b3() -> SegformerConfig:
    """MiT-b3, the backbone of the reference Vivim."""
    return SegformerConfig()


def mit_b0() -> SegformerConfig:
    return SegformerConfig(depths=(2, 2, 2, 2),
                           hidden_sizes=(32, 64, 160, 256),
                           decoder_hidden_size=256)


def mit_tiny_test() -> SegformerConfig:
    """Miniature config for fast tests."""
    return SegformerConfig(depths=(1, 1, 1, 1),
                           hidden_sizes=(8, 16, 24, 32),
                           num_attention_heads=(1, 2, 2, 4),
                           decoder_hidden_size=32)


def mit_micro_test() -> SegformerConfig:
    """2-stage micro config: the smallest graph with every element."""
    return SegformerConfig(depths=(1, 1),
                           hidden_sizes=(8, 16),
                           num_attention_heads=(1, 2),
                           sr_ratios=(8, 4),
                           patch_sizes=(7, 3),
                           strides=(4, 2),
                           mlp_ratios=(2, 2),
                           decoder_hidden_size=16)


def _nhwc_conv(conv, x):
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class OverlapPatchEmbed(nn.Module):
    """Strided overlapping conv patch embedding + LayerNorm on tokens."""

    def __init__(self, patch_size: int, stride: int, in_channels: int,
                 hidden_size: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, hidden_size, patch_size, stride,
                              padding=patch_size // 2)
        self.layer_norm = nn.LayerNorm(hidden_size, eps=LN_EPS)

    def forward(self, x):
        """x: (B, H, W, C) -> (tokens (B, H'*W', hidden), H', W')."""
        x = _nhwc_conv(self.proj, x)
        B, H, W, C = x.shape
        return self.layer_norm(x.reshape(B, H * W, C)), H, W


def _same_pads(n: int, k: int, s: int):
    """flax/XLA "SAME" padding (low, high) of one spatial axis."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class EfficientSelfAttention(nn.Module):
    """Multi-head attention with sequence reduction on K/V (HF key layout:
    ``self.{query,key,value,sr,layer_norm}``, ``output.dense``)."""

    def __init__(self, hidden_size: int, num_heads: int, sr_ratio: int,
                 attention_dropout: float = 0.0, hidden_dropout: float = 0.0):
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        core = {k: nn.Linear(hidden_size, hidden_size)
                for k in ("query", "key", "value")}
        if sr_ratio > 1:
            core["sr"] = nn.Conv2d(hidden_size, hidden_size, sr_ratio,
                                   sr_ratio)
            core["layer_norm"] = nn.LayerNorm(hidden_size, eps=LN_EPS)
        self.self = nn.ModuleDict(core)
        self.output = nn.ModuleDict({"dense": nn.Linear(hidden_size,
                                                        hidden_size)})
        self.attn_drop = Dropout(attention_dropout)
        self.out_drop = Dropout(hidden_dropout)

    def forward(self, x, H: int, W: int):
        B, L, C = x.shape
        heads = self.num_heads
        hd = C // heads
        core = self.self
        q = core["query"](x)
        kv_in = x
        if self.sr_ratio > 1:
            s = self.sr_ratio
            xs = x.reshape(B, H, W, C).permute(0, 3, 1, 2)
            ph, pw = _same_pads(H, s, s), _same_pads(W, s, s)
            xs = core["sr"](F.pad(xs, (pw[0], pw[1], ph[0], ph[1])))
            kv_in = core["layer_norm"](xs.flatten(2).transpose(1, 2))
        k = core["key"](kv_in).reshape(B, -1, heads, hd).transpose(1, 2)
        v = core["value"](kv_in).reshape(B, -1, heads, hd).transpose(1, 2)
        q = q.reshape(B, L, heads, hd).transpose(1, 2)
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        probs = self.attn_drop(scores.float().softmax(-1).to(x.dtype))
        ctx = (probs @ v).transpose(1, 2).reshape(B, L, C)
        return self.out_drop(self.output["dense"](ctx))


class DepthwiseConv2d(nn.Module):
    """3x3 depthwise conv, SAME padding, channels-last (key ``dwconv``)."""

    def __init__(self, features: int):
        super().__init__()
        self.dwconv = nn.Conv2d(features, features, 3, padding=1,
                                groups=features)

    def forward(self, x):
        return _nhwc_conv(self.dwconv, x)


class MixFFN(nn.Module):
    """dense1 -> 3x3 depthwise conv -> GELU -> dense2 with dropout."""

    def __init__(self, hidden_size: int, mlp_hidden: int,
                 hidden_dropout: float = 0.0, gelu_approximate: bool = False):
        super().__init__()
        self.dense1 = nn.Linear(hidden_size, mlp_hidden)
        self.dwconv = DepthwiseConv2d(mlp_hidden)
        self.dense2 = nn.Linear(mlp_hidden, hidden_size)
        self.drop = Dropout(hidden_dropout)
        self.approximate = "tanh" if gelu_approximate else "none"

    def forward(self, x, H: int, W: int):
        B, L, _ = x.shape
        x = self.dense1(x)
        x = self.dwconv(x.reshape(B, H, W, -1)).reshape(B, L, -1)
        x = self.drop(F.gelu(x, approximate=self.approximate))
        return self.drop(self.dense2(x))


class SegformerLayer(nn.Module):
    """Prenorm attention + prenorm Mix-FFN with stochastic depth."""

    def __init__(self, hidden_size: int, num_heads: int, sr_ratio: int,
                 mlp_ratio: int = 4, drop_path: float = 0.0,
                 attention_dropout: float = 0.0, hidden_dropout: float = 0.0,
                 gelu_approximate: bool = False):
        super().__init__()
        self.layer_norm_1 = nn.LayerNorm(hidden_size, eps=LN_EPS)
        self.attention = EfficientSelfAttention(
            hidden_size, num_heads, sr_ratio, attention_dropout,
            hidden_dropout)
        self.layer_norm_2 = nn.LayerNorm(hidden_size, eps=LN_EPS)
        self.mlp = MixFFN(hidden_size, int(hidden_size * mlp_ratio),
                          hidden_dropout, gelu_approximate)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, H: int, W: int):
        x = x + self.drop_path(self.attention(self.layer_norm_1(x), H, W))
        return x + self.drop_path(self.mlp(self.layer_norm_2(x), H, W))


def drop_path_schedule(cfg: SegformerConfig):
    """Linear stochastic-depth decay over all layers (HF encoder rule)."""
    total = sum(cfg.depths)
    rates = [cfg.drop_path_rate * i / max(total - 1, 1) for i in range(total)]
    out, cur = [], 0
    for d in cfg.depths:
        out.append(tuple(rates[cur:cur + d]))
        cur += d
    return out


class SegformerEncoder(nn.Module):
    """MiT encoder parameters: per stage a patch embed, ``depths[i]``
    layers and a LayerNorm.  ``stage(i, x)`` runs one stage without its
    LayerNorm (the JAX package's ``SegformerStage``): Vivim skips the stage
    norms, which exist only so that the state_dict is the reference's."""

    def __init__(self, cfg: SegformerConfig):
        super().__init__()
        self.cfg = cfg
        dprs = drop_path_schedule(cfg)
        in_ch = [cfg.num_channels] + list(cfg.hidden_sizes[:-1])
        self.patch_embeddings = nn.ModuleList(
            OverlapPatchEmbed(cfg.patch_sizes[i], cfg.strides[i], in_ch[i],
                              cfg.hidden_sizes[i])
            for i in range(cfg.num_stages))
        self.block = nn.ModuleList(
            nn.ModuleList(
                SegformerLayer(cfg.hidden_sizes[i],
                               cfg.num_attention_heads[i], cfg.sr_ratios[i],
                               cfg.mlp_ratios[i], dprs[i][j],
                               cfg.attention_dropout, cfg.hidden_dropout,
                               cfg.gelu_approximate)
                for j in range(cfg.depths[i]))
            for i in range(cfg.num_stages))
        self.layer_norm = nn.ModuleList(
            nn.LayerNorm(h, eps=LN_EPS) for h in cfg.hidden_sizes)

    def stage(self, i: int, x):
        """x: (B, H, W, C_in) -> (tokens (B, H'*W', C_i), H', W')."""
        tokens, H, W = self.patch_embeddings[i](x)
        for layer in self.block[i]:
            tokens = (checkpoint(layer, tokens, H, W)
                      if self.cfg.remat_layers else layer(tokens, H, W))
        return tokens, H, W


def resize_bilinear(x, size):
    """Half-pixel bilinear resize of (B, H, W, C) (= jax.image.resize
    "bilinear" when upsampling)."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size),
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)
