"""Profiling and tracing.

Port of the JAX package's ``utils/profiling.py``:

- ``trace(logdir)``: a context manager around ``torch.profiler`` (host
  ops, and the CUDA kernels where a card is present) that writes one
  ``<host>_<pid>.<ns>.pt.trace.json`` into ``logdir`` when it exits, a
  trace that TensorBoard's PyTorch profiler plugin and Chrome / Perfetto
  both read;
- ``span(name)``: the program's named ranges at its layer boundaries (the
  train step's phases, a serving request's parts, the LM's prefill, draw
  and replay, the scan kernels and the 3-D conv).  While a profiler
  records, a span is a ``torch.profiler.record_function`` range, so it
  lands in the profiler's own timeline beside the kernels, on one clock,
  in every trace (``trace``, the Trainer's ``profile_dir``, a benchmark's
  profiled stretch); otherwise it is a shared no-op context, and costs one
  flag check.
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

# entering record_function with no profiler still costs microseconds a
# use, on every request and step: spans enter it only while one records
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a profiler records, else a
    no-op context: ``with span("train.forward"): ...``."""
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _NO_SPAN


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
