"""Vivim: SegFormer encoder interleaved with temporal Mamba stacks.

Port of the JAX package's ``nn/vivim.py`` (``VivimConfig``, ``VivimEncoder``,
``Vivim``, ``_maybe_scale_dropout``).  State-dict keys are the reference Vivim's:
``encoder.downsample_layers.*`` (the HF SegFormer encoder, its per-stage
``layer_norm.{i}`` kept though unused), ``encoder.stages.{i}.{j}.0.*``
(MambaLayer j of stage i), ``decoder.linear_c.{i}.proj``,
``decoder.linear_fuse``, ``decoder.batch_norm``, ``out`` and the optional
``edgeocr_cls_head``.

Reference quirks kept: the per-stage SegFormer LayerNorm is skipped, and
the Mamba drop-path rate is indexed by stage.  Clips are (B, T, H, W, 3)
channels-last and logits (B, T, H, W, C).

The decode (reference vivim.py:288-327) has two forms, as in the JAX
package:
- eval: each scale is fused at its native resolution (the 1x1 fuse conv
  commutes with the bilinear upsample), upsampled and summed; BatchNorm with
  the running statistics;
- train: each scale is upsampled, then dropped whole with a 50 % gate at
  rate ``dropout_rate / 2`` (``ScaleDropout``), the reversed scales are
  concatenated and fused; BatchNorm with the batch statistics, computed by
  hand because flax updates the running variance with the biased batch
  variance where ``nn.BatchNorm2d`` uses the unbiased one (ROADMAP F3);
  under data parallel (``stats_group``) over every data rank's batch,
  through a differentiable all_reduce of the count, sum and sum of squares.
Then ReLU, the head dropout twice (``FastDropout``), channelwise Dropout2d,
``out``, the resize to the input size and the optional edge head.  The
random layers draw from the generator the train step sets
(``nn.layers.use_generator``).

Remat (``remat_pre_scan``, ``remat_blocks`` and the SegFormer's
``remat_layers``) recomputes in the backward what it does not keep; the
state-dict keys do not change with it, and the decode, which holds the
BatchNorm, is never recomputed.

Sequence parallel (``seq_axis`` + ``mesh``): a stage whose T*H*W tokens
divide over the axis takes this rank's shard of them before its first
MambaLayer (``comm.seq_shard``) and gathers them after its last
(``comm.seq_gather_replicated``), so the Mamba layers hold L/S tokens
(``nn/mamba.py``); the SegFormer stages, the decode and the loss stay
whole on every rank, as in the JAX package's compiled graph.  A stage
whose tokens do not divide runs its layers whole (the scan logs the JAX
package's FALLBACK line).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Sequence

import torch
from torch import nn

from vivim_tpu_torch.nn import segformer as sf
from vivim_tpu_torch.nn.layers import (
    Dropout,
    FastDropout,
    Stochastic,
    checkpoint,
    fast_keep_mask,
)
from vivim_tpu_torch.nn.mamba import MambaLayer
from vivim_tpu_torch.parallel import comm
from vivim_tpu_torch.parallel.comm import AllReduceSum

_log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class VivimConfig:
    in_chans: int = 3
    out_chans: int = 3  # background / solid / non-solid
    depths: Sequence[int] = (2, 2, 2, 2)  # Mamba layers per stage
    feat_size: Sequence[int] = (64, 128, 320, 512)
    drop_path_rate: float = 0.2
    dropout_rate: float = 0.3
    with_edge: bool = False
    hidden_size: int = 768
    segformer: sf.SegformerConfig = dataclasses.field(
        default_factory=sf.mit_b3)
    scan_implementation: str | None = None
    # recompute the Mamba pre-scan chain in the backward
    remat_pre_scan: bool = False
    # recompute each whole MambaLayer in the backward (keep only its
    # input); with segformer.remat_layers, the coarsest memory profile
    remat_blocks: bool = False
    # long-clip mode: shard the Mamba layers' tokens over this axis of
    # ``mesh`` (a parallel.mesh.Mesh; the module docstring)
    seq_axis: str | None = None
    mesh: object = None

    @classmethod
    def tiny_test(cls, **kw):
        seg = sf.mit_tiny_test()
        return cls(feat_size=seg.hidden_sizes, hidden_size=32, segformer=seg,
                   scan_implementation=kw.pop("scan_implementation", "ref"),
                   **kw)

    @classmethod
    def micro_test(cls, **kw):
        """2-stage micro model (mit_micro_test + 1 MambaLayer per stage)."""
        seg = sf.mit_micro_test()
        return cls(depths=(1, 1), feat_size=seg.hidden_sizes, hidden_size=16,
                   segformer=seg,
                   scan_implementation=kw.pop("scan_implementation", "ref"),
                   **kw)


class VivimEncoder(nn.Module):
    """SegFormer stages interleaved with temporal-Mamba stacks."""

    def __init__(self, cfg: VivimConfig):
        super().__init__()
        self.cfg = cfg
        seg = cfg.segformer
        self.downsample_layers = sf.SegformerEncoder(seg)
        total = sum(cfg.depths)
        self.stages = nn.ModuleList()
        for i in range(seg.num_stages):
            dp_rate = cfg.drop_path_rate * i / max(total - 1, 1)
            self.stages.append(nn.ModuleList(
                nn.Sequential(MambaLayer(
                    seg.hidden_sizes[i], drop_path=dp_rate,
                    scan_implementation=cfg.scan_implementation,
                    gelu_approximate=seg.gelu_approximate,
                    remat_pre_scan=cfg.remat_pre_scan,
                    seq_axis=cfg.seq_axis, mesh=cfg.mesh))
                for _ in range(cfg.depths[i])))

    def seq_group(self, L: int):
        """The process group over which a stage of L tokens shards its
        Mamba layers, or None (no seq axis, or L does not divide over it:
        the JAX package's ``x.shape[1] % n_shards`` test)."""
        cfg = self.cfg
        if cfg.seq_axis is None or cfg.mesh is None:
            return None
        n = cfg.mesh.size(cfg.seq_axis)
        if n == 1 or L % n:
            return None
        return cfg.mesh.group(cfg.seq_axis)

    def forward(self, x):
        """x: (B, T, H, W, 3) -> list of per-stage (B*T, H_i, W_i, C_i)."""
        B, T, H, W, C = x.shape
        h = x.reshape(B * T, H, W, C)
        feats = []
        for i, stage in enumerate(self.stages):
            tokens, Hi, Wi = self.downsample_layers.stage(i, h)
            dim = tokens.shape[-1]
            t5 = tokens.reshape(B, T * Hi * Wi, dim)
            group = self.seq_group(t5.shape[1]) if len(stage) else None
            if group is not None:
                n = comm.size(group)
                _log.info("seq-sharded Mamba stage %d: L=%d over %d '%s' "
                          "ranks, %d tokens each (shape %s)", i, t5.shape[1],
                          n, self.cfg.seq_axis, t5.shape[1] // n,
                          tuple(t5.shape))
                t5, = comm.seq_shard(group, t5)
            for block in stage:
                t5 = (checkpoint(block[0], t5, T, Hi, Wi, group)
                      if self.cfg.remat_blocks
                      else block[0](t5, T, Hi, Wi, group))
            if group is not None:
                t5 = comm.seq_gather_replicated(t5, group)
            h = t5.reshape(B * T, Hi, Wi, dim)
            feats.append(h)
        return feats


class ScaleDropout(Stochastic):
    """With probability 1/2, elementwise dropout of a whole scale at
    ``rate`` (``_maybe_scale_dropout``; reference vivim.py:311-312)."""

    def forward(self, x):
        if not self.active():
            return x
        gate = torch.rand((), generator=self.generator, device=x.device) < 0.5
        mask, keep = fast_keep_mask(self.generator, 1.0 - self.rate, x.shape,
                                    x.device)
        return torch.where(gate, torch.where(mask, x / keep, 0.0), x)


class Vivim(nn.Module):
    """Video Vision Mamba segmentation model."""

    def __init__(self, cfg: VivimConfig):
        super().__init__()
        self.cfg = cfg
        seg = cfg.segformer
        hid = cfg.hidden_size
        self.encoder = VivimEncoder(cfg)
        self.decoder = nn.Module()
        self.decoder.linear_c = nn.ModuleList(
            nn.ModuleDict({"proj": nn.Linear(c, hid)})
            for c in seg.hidden_sizes)
        self.decoder.linear_fuse = nn.Conv2d(seg.num_stages * hid, hid, 1,
                                             bias=False)
        self.decoder.batch_norm = nn.BatchNorm2d(hid, eps=1e-5, momentum=0.1)
        self.out = nn.Conv2d(hid, cfg.out_chans, 1)
        # the train-mode regularisation of the decode (no parameters)
        self.scale_drop = ScaleDropout(cfg.dropout_rate / 2)
        self.head_drop = nn.ModuleList(
            FastDropout(seg.classifier_dropout) for _ in range(2))
        self.feature_drop = Dropout(cfg.dropout_rate, broadcast_dims=(1, 2))
        if cfg.with_edge:
            self.edgeocr_cls_head = nn.Conv2d(seg.hidden_sizes[0], 1, 1)
        # the process group over which the train-mode decode BatchNorm
        # takes its statistics (data parallel); None: this batch alone
        self.stats_group = None

    def forward(self, x):
        """x: (B, T, H, W, in_chans) -> logits (B, T, H, W, out_chans);
        with ``cfg.with_edge`` also an edge map (B, T, H, W, 1)."""
        cfg = self.cfg
        B, T, H, W, _ = x.shape
        feats = self.encoder(x)
        hmap = (self._decode_train(feats) if self.training
                else self._decode_eval(feats))
        hmap = torch.relu(hmap)
        for drop in self.head_drop:
            hmap = drop(hmap)
        hmap = self.feature_drop(hmap)
        logits = hmap @ self.out.weight[:, :, 0, 0].t() + self.out.bias
        logits = sf.resize_bilinear(logits, (H, W))
        logits = logits.reshape(B, T, H, W, cfg.out_chans)
        if not cfg.with_edge:
            return logits
        head = self.edgeocr_cls_head
        edge = feats[0] @ head.weight[:, :, 0, 0].t() + head.bias
        edge = sf.resize_bilinear(edge, (H, W)).reshape(B, T, H, W, 1)
        return logits, edge

    def _decode_eval(self, feats):
        """Per-scale fuse at native resolution, upsample, sum; BatchNorm
        with the running statistics."""
        H0, W0 = feats[0].shape[1:3]
        n_stages = len(feats)
        hid = self.cfg.hidden_size
        dec = self.decoder
        Wf = dec.linear_fuse.weight[:, :, 0, 0]     # (hid, n_stages*hid)
        hmap = None
        for i, f in enumerate(feats):
            t = dec.linear_c[i]["proj"](f)           # (BT, Hi, Wi, hid)
            # concat order is reversed scales: scale i owns fuse-kernel
            # input columns (n_stages-1-i)*hid : (n_stages-i)*hid
            j = n_stages - 1 - i
            t = t @ Wf[:, j * hid:(j + 1) * hid].t()
            t = sf.resize_bilinear(t, (H0, W0))
            hmap = t if hmap is None else hmap + t
        bn = dec.batch_norm
        return ((hmap - bn.running_mean) * torch.rsqrt(bn.running_var + bn.eps)
                * bn.weight + bn.bias).to(hmap.dtype)

    def _decode_train(self, feats):
        """Upsample, gated per-scale dropout, concat of the reversed scales,
        1x1 fuse; BatchNorm with the batch statistics, updating the running
        ones as flax does (biased variance, momentum 0.9 = torch 0.1)."""
        H0, W0 = feats[0].shape[1:3]
        dec = self.decoder
        unified = [self.scale_drop(sf.resize_bilinear(
            dec.linear_c[i]["proj"](f), (H0, W0))) for i, f in enumerate(feats)]
        hmap = torch.cat(unified[::-1], dim=-1)
        hmap = hmap @ dec.linear_fuse.weight[:, :, 0, 0].t()
        bn = dec.batch_norm
        hf = hmap.float()
        if self.stats_group is None:
            mean = hf.mean((0, 1, 2))
            var = hf.var((0, 1, 2), unbiased=False)
        else:
            # count, sum and sum of squares over every data rank's batch,
            # as flax computes them over a batch-sharded array
            c = hf.shape[-1]
            stats = AllReduceSum.apply(torch.cat([
                hf.sum((0, 1, 2)), (hf * hf).sum((0, 1, 2)),
                hf.new_full((1,), hf[..., 0].numel())]), self.stats_group)
            mean = stats[:c] / stats[-1]
            var = torch.clamp(stats[c:2 * c] / stats[-1] - mean * mean,
                              min=0.0)
        with torch.no_grad():
            bn.running_mean.lerp_(mean, bn.momentum)
            bn.running_var.lerp_(var, bn.momentum)
            bn.num_batches_tracked += 1
        return ((hf - mean) * torch.rsqrt(var + bn.eps) * bn.weight
                + bn.bias).to(hmap.dtype)
