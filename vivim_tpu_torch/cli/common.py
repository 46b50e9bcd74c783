"""Shared CLI plumbing: the device and the model from parsed args."""

from __future__ import annotations

import torch

from vivim_tpu_torch.nn import segformer as sf
from vivim_tpu_torch.nn.layers import init_weights
from vivim_tpu_torch.nn.vivim import Vivim, VivimConfig

SEGFORMERS = {"b0": sf.mit_b0, "b3": sf.mit_b3, "tiny": sf.mit_tiny_test}


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises when it names CUDA and there is
    none (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on the GPU; pass "
                "device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def build_model(args, device="cuda", seed: int = 0):
    """Vivim from parsed CLI args (``segformer`` in b0 / b3 / tiny,
    ``num_classes``, ``with_edge``), with random weights from ``seed``,
    in eval mode on ``device``.  Returns (model, cfg)."""
    dev = resolve_device(device)
    seg = SEGFORMERS[args.segformer]()
    cfg = VivimConfig(out_chans=args.num_classes, with_edge=args.with_edge,
                      feat_size=seg.hidden_sizes,
                      hidden_size=seg.decoder_hidden_size, segformer=seg)
    model = Vivim(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval(), cfg
