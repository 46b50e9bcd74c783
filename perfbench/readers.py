"""What the per-layer metrics share: kernel time by name from the
traced run's profile, a roofline share, the device's idle share, and the
model FLOP utilisation.  Each metric's own file (``metrics/<name>.py``)
names what it reads; a reader returns None where the run gave nothing to
read (no profile, no matching kernel), never 0.
"""

from __future__ import annotations

from perfbench import trace, work

# kernel names of the program (until spans inside the program name them)
K1 = ("selective_scan_fwd",)
K2 = ("selective_scan_bwd", "sum_partials")
# cuDNN's convolutions and the layout kernels around them
CONV = ("conv", "fprop", "dgrad", "wgrad", "winograd", "nhwctonchw",
        "nchwtonhwc")
NOT_KERNELS = ("memcpy", "memset")


def kernels(profile):
    return [ev for ev in profile.device
            if not ev[0].lower().startswith(NOT_KERNELS)]


def per_unit_ms(run, patterns):
    """Summed device ms of the matching kernels per profiled unit."""
    p = run.profile
    if p is None or not p.units:
        return None
    events = trace.matching(p, patterns)
    if not events:
        return None
    return trace.summed_s(events) / p.units * 1e3


def per_unit_union_ms(run, patterns):
    """Device ms per profiled unit in which a matching kernel ran: the
    union of their intervals, so kernels that run at once on several
    streams count once."""
    p = run.profile
    if p is None or not p.units:
        return None
    events = trace.matching(p, patterns)
    if not events:
        return None
    return trace.union((s, e) for _, s, e, _ in events) / p.units * 1e3


def roofline(run, patterns, work_key):
    """The kernel's bound per unit (frozen work counts at the cell's shapes
    over the card's peaks) over its measured device time per unit, in %."""
    ms = per_unit_ms(run, patterns)
    if ms is None or run.peaks is None or work_key not in run.info:
        return None
    return 100.0 * work.bound_s(run.info[work_key], run.peaks) * 1e3 / ms


def unit_s(run):
    """Wall seconds per unit (step or request) of the untraced window: the
    profiler's own host work slows a profiled unit."""
    w = run.window
    return w.seconds / w.units if w.units else None


def idle(run):
    """1 - the device's busy seconds per profiled unit (the union of its
    intervals) over the window's wall seconds per unit, in %."""
    p, wall = run.profile, unit_s(run)
    if p is None or not p.units or not p.device or wall is None:
        return None
    return 100.0 * (1.0 - trace.busy_s(p) / p.units / wall)


def mfu(run):
    """Model FLOPs per unit times the window's units per second over the
    card's fp32 peak, in %."""
    w = run.window
    if run.peaks is None or "flops_per_unit" not in run.info or not w.units:
        return None
    return (100.0 * run.info["flops_per_unit"] * w.units / w.seconds
            / run.peaks[1])
