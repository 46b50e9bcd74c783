"""Vivim model modules (PyTorch)."""

from vivim_tpu_torch.nn.mamba import MambaLayer, MambaV3
from vivim_tpu_torch.nn.vivim import Vivim, VivimConfig, VivimEncoder

__all__ = ["MambaLayer", "MambaV3", "Vivim", "VivimConfig", "VivimEncoder"]
