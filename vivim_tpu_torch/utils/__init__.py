"""Utilities: profiling and tracing helpers."""

from vivim_tpu_torch.utils.profiling import span, trace

__all__ = ["trace", "span"]
