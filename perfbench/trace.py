"""The traced run's profile: device intervals and host activity from
``torch.profiler``, and their reduction to busy time, kernel time by name
and the breakdown of the result line.

A ``Profile`` holds, in seconds on the profiler's clock, the window (the
``perfbench.window`` range the driver opens around the profiled units and
closes after a synchronize), every device event inside it (kernels,
copies and sets, by kineto's activity type: name, start, end, stream)
and every host event (name, start, end).  Busy is the union of the
device intervals: kernels of one CUDA graph overlap on cuDNN's streams,
so their summed time can exceed the wall time.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses

WINDOW = "perfbench.window"
# kineto's activity types of work on the device
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Profile:
    t0: float
    t1: float
    device: list          # (name, start, end, stream)
    host: list            # (name, start, end)
    units: int = 0        # steps or requests profiled
    tokens: int = 0       # new tokens of the profiled requests

    @property
    def window_s(self):
        return self.t1 - self.t0


def union(intervals):
    """Total length of the union of (start, end) intervals."""
    busy, reach = 0.0, None
    for s, e in sorted(intervals):
        if reach is None or s >= reach:
            busy += e - s
            reach = e
        elif e > reach:
            busy += e - reach
            reach = e
    return busy


def gaps(intervals, t0, t1):
    """(start, end) of every stretch of [t0, t1] no interval covers."""
    out, reach = [], t0
    for s, e in sorted(intervals):
        if s > reach:
            out.append((reach, min(s, t1)))
        reach = max(reach, e)
    if reach < t1:
        out.append((reach, t1))
    return [(s, e) for s, e in out if e > s]


def busy_s(profile):
    return union((s, e) for _, s, e, _ in profile.device)


def matching(profile, patterns):
    """Device events whose lower-cased name holds one of ``patterns``."""
    return [ev for ev in profile.device
            if any(p in ev[0].lower() for p in patterns)]


def summed_s(events):
    return sum(e - s for _, s, e, _ in events)


def host_at(host, starts, t, reach=20000):
    """The innermost host event running at ``t`` (the latest started that
    has not ended), other than the window itself; ``host`` sorted by start
    and ``starts`` their starts."""
    i = bisect.bisect_right(starts, t)
    for name, s, e in reversed(host[max(0, i - reach):i]):
        if e > t and name != WINDOW:
            return name
    return "host (no profiled op)"


def breakdown(profile, top=10):
    """{"device_ops": the device events that took the most summed time,
    "idle_gaps": idle time summed by the host activity at each gap's
    start}, each a list of at most ``top`` [name, seconds]."""
    by_name = {}
    for name, s, e, _ in profile.device:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = gaps([(s, e) for _, s, e, _ in profile.device], profile.t0,
                profile.t1)
    longest = sorted(idle, key=lambda g: g[0] - g[1])[:200]
    host = sorted(profile.host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    by_host = {}
    for s, e in longest:
        label = host_at(host, starts, s)
        by_host[label] = by_host.get(label, 0.0) + (e - s)
    labelled = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:200], v] for n, v in ops],
            "idle_gaps": [[n[:200], v] for n, v in labelled]}


@contextlib.contextmanager
def profiled(cuda):
    """``torch.profiler`` over the body (host and, with ``cuda``, device
    activity); yields a list that holds the ``Profile`` after the body."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out = []
    with profile(activities=acts) as prof:
        yield out
    out.append(reduce(prof.profiler.kineto_results.events(),
                      torch.autograd.DeviceType.CUDA))


def profile(run, sync, cuda):
    """The ``Profile`` of ``run()`` inside the window's range, closed after
    ``sync()``."""
    from torch.profiler import record_function

    with profiled(cuda) as out:
        with record_function(WINDOW):
            run()
            sync()
    return out[0]


def device_work(ev):
    """Whether kineto event ``ev`` is a kernel, a copy or a set, were it
    on the device: its activity type where the event tells it (newer
    PyTorch), else anything but a range (a user annotation)."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        return kind() in DEVICE_WORK
    return not ev.is_user_annotation()


def reduce(events, cuda_type):
    """A ``Profile`` of kineto events: the window from its range, the
    device's kernels, copies and sets and the host events inside it, in
    seconds from the window's start (integer nanoseconds until then: the
    clock's epoch is far).  A ``record_function`` range also shows on the
    device's timeline, as a ``gpu_user_annotation``: device events are
    kept by their activity type, so no range reads as busy."""
    raw = [(ev.name(), ev.start_ns(), ev.end_ns(),
            ev.device_type() == cuda_type, device_work(ev),
            ev.device_resource_id()) for ev in events]
    windows = [(s, e) for n, s, e, dev, _, _ in raw
               if n == WINDOW and not dev]
    if not windows:
        raise RuntimeError(f"the profile holds no {WINDOW} range")
    base, end = windows[0]
    sec = lambda ns: (ns - base) * 1e-9
    t1 = sec(end)
    device, host = [], []
    for n, s, e, dev, work, stream in raw:
        if e <= base or s >= end:
            continue
        if dev:
            if work:
                device.append((n, max(sec(s), 0.0), min(sec(e), t1),
                               stream))
        elif n != WINDOW:
            host.append((n, sec(s), sec(e)))
    return Profile(0.0, t1, device, host)
