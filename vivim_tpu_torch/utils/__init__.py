"""Utilities: profiling and tracing helpers."""

from vivim_tpu_torch.utils.profiling import step_timer, trace

__all__ = ["trace", "step_timer"]
