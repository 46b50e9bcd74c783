"""The plain reference of the Mamba language model (state-spaces/mamba's
``MambaLMHeadModel``), float32 PyTorch.

embedding -> n_layer x [RMSNorm (or LayerNorm), a one-direction Mamba
mixer, residual] -> norm_f -> the head tied to the embedding, over the
vocabulary padded to ``pad_vocab_size_multiple``; with
``residual_in_fp32`` the residual stream is float32 (it is float32 here in
any case).  The mixer is ``reference.vivim.Mixer`` with one direction: the
causal depthwise conv and SiLU, the projections, and the float64 scan of
``reference/scan.py``.  The full sequence runs at once: the reference of
a generation is its prompt and served tokens read in one forward, whose
logit at position t is the one that chose token t + 1.

Parameter names are the mamba reference's state-dict keys
(``backbone.embedding.weight``, ``backbone.layers.{i}.mixer.*``,
``backbone.layers.{i}.norm.weight``, ``backbone.norm_f.weight``), so the
benchmark's state dict loads into it and into the program alike.  Imports
nothing of the program.
"""

from __future__ import annotations

import torch
from torch import nn

from perfbench.reference.vivim import Mixer


def padded_vocab(cfg):
    m = cfg.get("pad_vocab_size_multiple", 8)
    return -(-cfg["vocab_size"] // m) * m


class Norm(nn.Module):
    def __init__(self, dim, eps, rms):
        super().__init__()
        self.eps, self.rms = eps, rms
        self.weight = nn.Parameter(torch.ones(dim))
        if not rms:
            self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, h):
        if self.rms:
            return h * torch.rsqrt((h * h).mean(-1, keepdim=True) + self.eps) \
                * self.weight
        mean = h.mean(-1, keepdim=True)
        var = ((h - mean) ** 2).mean(-1, keepdim=True)
        return (h - mean) * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias


class Block(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        ssm = cfg.get("ssm_cfg") or {}
        eps = cfg.get("norm_epsilon", 1e-5)
        self.norm = Norm(cfg["d_model"], eps, cfg.get("rms_norm", False))
        self.mixer = Mixer(cfg["d_model"], ssm.get("d_state", 16),
                           ssm.get("d_conv", 4), ssm.get("expand", 2),
                           directions=1)


class MambaLM(nn.Module):
    """tokens (B, L) -> logits (B, L, padded vocabulary)."""

    def __init__(self, cfg):
        super().__init__()
        self.backbone = nn.Module()
        self.backbone.embedding = nn.Embedding(padded_vocab(cfg),
                                               cfg["d_model"])
        self.backbone.layers = nn.ModuleList(Block(cfg)
                                             for _ in range(cfg["n_layer"]))
        self.backbone.norm_f = Norm(cfg["d_model"],
                                    cfg.get("norm_epsilon", 1e-5),
                                    cfg.get("rms_norm", False))

    def set_scan(self, fn):
        for m in self.modules():
            if isinstance(m, Mixer):
                m.scan = fn

    def forward(self, tokens):
        emb = self.backbone.embedding.weight
        h = emb[tokens]
        for layer in self.backbone.layers:
            h = h + layer.mixer(layer.norm(h))
        return self.backbone.norm_f(h) @ emb.t()


def build(cfg, device):
    with torch.device(device):
        return MambaLM(cfg)
