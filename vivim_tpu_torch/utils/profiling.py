"""Profiling and tracing.

Port of the JAX package's ``utils/profiling.py``:

- ``trace(logdir)``: a context manager around ``torch.profiler`` (host
  ops, and the CUDA kernels where a card is present) that writes one
  ``<host>_<pid>.<ns>.pt.trace.json`` into ``logdir`` when it exits, a
  trace that TensorBoard's PyTorch profiler plugin and Chrome / Perfetto
  both read;
- ``step_timer``: host-clock step durations with percentile summaries, for
  per-step logging without a full trace (the caller synchronises the
  device inside the timed block).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


class step_timer:
    """Collects step durations; ``summary()`` gives mean / p50 / p90 / max
    in milliseconds."""

    def __init__(self):
        self.times = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        return False

    def summary(self):
        if not self.times:
            return {}
        arr = np.array(self.times) * 1e3
        return {
            "steps": len(arr),
            "mean_ms": float(arr.mean()),
            "p50_ms": float(np.percentile(arr, 50)),
            "p90_ms": float(np.percentile(arr, 90)),
            "max_ms": float(arr.max()),
        }
