#!/usr/bin/env python3
"""Relative error of a bf16 conv of a channels-last (permuted) input.

    python3 scripts/bf16_conv_probe.py

The SegFormer ``sr`` conv of the port takes its input as a permuted view
(``nn/segformer.py``: tokens reshaped to (B, H, W, C), permuted to NCHW),
with kernel = stride = the reduction ratio.  This runs that conv in bf16 on
the CPU and, where there is one, on the card, for the permuted and for the
contiguous input, and prints each one's relative error against the fp64
conv of the same values.  torch 2.13.0+cpu's oneDNN path errs by about the
output's own size on the permuted input; an error near bf16's rounding
(a few 1e-3) is a right conv.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def main():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 64, 8, generator=g)
    w = torch.randn(8, 8, 8, 8, generator=g) * 0.05
    xs = x.reshape(6, 8, 8, 8).permute(0, 3, 1, 2)
    ref = F.conv2d(xs.double(), w.double(), stride=8)
    devices = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
    for dev in devices:
        for name, inp in (("permuted", xs), ("contiguous", xs.contiguous())):
            y = F.conv2d(inp.to(dev).bfloat16(), w.to(dev).bfloat16(),
                         stride=8)
            err = (y.double().cpu() - ref).norm() / ref.norm()
            print(f"torch {torch.__version__} {dev} bf16 conv, {name} "
                  f"input: relative error {err.item():.4e}")


if __name__ == "__main__":
    main()
