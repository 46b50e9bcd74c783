"""What the per-layer metrics read from the program's own spans: a span's
host time per profiled unit, and the kernel launches that start inside
it.

The program opens its spans (``vivim_tpu_torch/utils/profiling.py::span``)
as ``record_function`` ranges while a profiler records, so they sit in the
profile's host events on the device events' clock, beside the CUDA API
calls that launch the kernels.  A launch counts by time alone, on any
thread: the backward launches from autograd's device thread while the main
thread holds ``train.backward``.  A reader returns None where the run has
no such span (no profile, or a program that opens none), never 0.
"""

from __future__ import annotations

import bisect

# host CUDA API calls that put kernels on the device (kineto's names on the
# H100: cudaLaunchKernel, cudaLaunchKernelExC, cuLaunchKernel); a graph's
# replay counts once
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch")


def intervals(profile, name):
    """(start, end) of every span ``name`` of the profile, by start."""
    return sorted((s, e) for n, s, e in profile.host if n == name)


def host_ms(run, name):
    """Summed host ms of the spans ``name`` per profiled unit."""
    p = run.profile
    if p is None or not p.units:
        return None
    spans = intervals(p, name)
    if not spans:
        return None
    return sum(e - s for s, e in spans) / p.units * 1e3


def launches(run, name):
    """Kernel launches per profiled unit whose call starts inside a span
    ``name``."""
    p = run.profile
    if p is None or not p.units:
        return None
    spans = intervals(p, name)   # one name's spans never overlap
    if not spans:
        return None
    starts = [s for s, _ in spans]
    n = 0
    for call, s, _ in p.host:
        if call.startswith(LAUNCH_CALLS):
            i = bisect.bisect_right(starts, s) - 1
            n += i >= 0 and s < spans[i][1]
    return n / p.units if n else None
