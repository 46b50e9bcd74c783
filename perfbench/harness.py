"""One run of one cell: discovery by name, the run's phases, the result
line.

``BENCHMARK.json`` names each cell's configuration and traffic.  The
harness finds, by those names alone:
- the configuration: the ``file`` of its entry in ``configs``;
- the traffic: ``perfbench/traffic/<traffic>.json``, whose ``driver``
  names ``perfbench/drivers/<driver>.py`` (the entry point it drives);
- the limits of the cell's output check: ``perfbench/limits/<cell>.json``;
- each per-layer metric: ``perfbench/metrics/<metric>.py``, whose
  ``read(run)`` returns the value, or None where it finds nothing.

A run: set-up (weights, program, warm-up: ``driver.setup``), the measured
window and, with ``--trace 1``, a profiled stretch after it
(``driver.measure``), the program released, the output check against the
plain reference (``driver.check``), then the result line.  ``setup_s``
runs from the process's start to the window's start.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "vivim_tpu")


@dataclasses.dataclass
class Window:
    """The measured window, on the host clock (seconds): its start and
    end, the units (steps or requests) completed in it with their
    latencies, and what they carried (clips, frames, tokens)."""

    start: float
    end: float
    latencies: list = dataclasses.field(default_factory=list)
    amount: float = 0.0

    @property
    def seconds(self):
        return self.end - self.start

    @property
    def units(self):
        return len(self.latencies)

    def rate(self):
        """``amount`` over the window's seconds."""
        return self.amount / self.seconds


@dataclasses.dataclass
class Check:
    """One number of the output check beside its limit: the run is
    correct when every value is at most its limit."""

    name: str
    value: float
    limit: float
    note: str = ""      # where the value was read (standard error only)

    @property
    def ok(self):
        return math.isfinite(self.value) and self.value <= self.limit


def closed_loop(unit, seconds, clock, sync, profiled_units=0, cuda=False):
    """Units back to back (``unit(i)`` runs unit i, a step or a request,
    until the host has its result) from a synchronized start until one
    ends past ``seconds``; the window closes after a final ``sync``.
    ``profiled_units`` more run after it under the profiler.  Returns
    (window, profile or None); the window's latencies are each unit's
    host seconds."""
    sync()
    window = Window(clock(), 0.0)
    i = 0
    while clock() - window.start < seconds:
        t0 = clock()
        unit(i)
        window.latencies.append(clock() - t0)
        i += 1
    sync()
    window.end = clock()
    profile = None
    if profiled_units:
        from perfbench import trace

        def run():
            for k in range(i, i + profiled_units):
                unit(k)
        profile = trace.profile(run, sync, cuda)
        profile.units = profiled_units
    return window, profile


def synchronizer(device):
    import torch

    return torch.cuda.synchronize if device.startswith("cuda") \
        else (lambda: None)


@contextlib.contextmanager
def tf32(on):
    """TF32 in matmuls and convolutions on or off for the body: the
    control computes the reference one precision below float32."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def percentile(values, q):
    """The ``q``-th percentile, linear between order statistics."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Spec:
    """What a driver gets: the cell's entries and files."""

    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    device: str
    trace: bool
    scratch: str = ""
    here: str = HERE


def resolve(bench, name, root, here=HERE):
    """The ``Spec`` parts of cell ``name``: (cell, config, traffic,
    limits); ``root`` is where BENCHMARK.json's paths start."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, cfgs[cell["config"]]["file"]))
    traffic = load_json(os.path.join(here, "traffic",
                                     f"{cell['traffic']}.json"))
    limits = load_json(os.path.join(here, "limits", f"{name}.json"))
    return cell, config, traffic, limits


def driver_class(traffic):
    return importlib.import_module(
        f"perfbench.drivers.{traffic['driver']}").Cell


def layer_metrics(bench, cell, e2e_names):
    """The per-layer entries this cell reports: listed for it, or listed
    for no cell and moving an end-to-end metric the cell reports."""
    out = []
    for m in bench["per_layer"]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif m["moves"] in e2e_names:
            out.append(m)
    return out


def e2e_metrics(bench, cell):
    return [m for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]


def read_layer(entry, run):
    mod = load_module(os.path.join(run.spec.here, "metrics",
                                   f"{entry['name']}.py"),
                      "perfbench_metric_" + entry["name"].replace(".", "_")
                      .replace("-", "_"))
    return mod.read(run)


def scratch_dir():
    """A fixed directory under the run's TMPDIR for what the program
    writes beside its results (the infer loop's output directory)."""
    import tempfile

    path = os.path.join(tempfile.gettempdir(), "perfbench")
    os.makedirs(path, exist_ok=True)
    return path


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(spec, seconds, t0, clock, bench):
    """Every phase of one run; returns the result dict and the checks."""
    import torch

    cuda = spec.device.startswith("cuda")
    log = lambda what: print(f"perfbench: {what} at {clock() - t0:.3f} s",
                             file=sys.stderr, flush=True)
    log("harness imported")
    drv = driver_class(spec.traffic)(spec)
    drv.setup()
    log("set-up done")
    window, profile = drv.measure(seconds, clock)
    log(f"window {window.start - t0:.3f} to {window.end - t0:.3f} s, "
        f"{window.units} units; measured")
    mem = torch.cuda.max_memory_allocated() if cuda else 0
    info = drv.layer_info() if spec.trace else {}
    drv.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    log("program released")
    checks = drv.check()
    log("checked")
    name = spec.cell["name"]
    e2e = e2e_metrics(bench, name)
    metrics = {}
    if not spec.trace:
        values = dict(drv.end_to_end(window), setup_s=window.start - t0)
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        peaks = None
        if cuda:
            from perfbench import work
            peaks, _, _ = work.device_peaks()
        run = _Run(spec, window, profile, info, peaks)
        for m in layer_metrics(bench, name, {e["name"] for e in e2e}):
            value = read_layer(m, run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": spec.cell["chips"], "memory_peak_bytes": mem}
    result = {"correct": all(c.ok for c in checks),
              "attempted": window.units, "failed": 0,
              "metrics": metrics, "device": device}
    if spec.trace and profile is not None:
        from perfbench import trace
        device["busy_s"] = trace.busy_s(profile)
        device["window_s"] = profile.window_s
        result["breakdown"] = trace.breakdown(profile)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result, checks


@dataclasses.dataclass
class _Run:
    """What a per-layer reader reads."""

    spec: Spec
    window: Window
    profile: object
    info: dict
    peaks: tuple


def main(args, t0, clock, root):
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cell, config, traffic, limits = resolve(bench, args.workload, root)
    import torch

    chips = cell["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"perfbench: cell {cell['name']} needs {chips} CUDA "
              f"device(s); this machine has {have}", file=sys.stderr)
        return 3
    # the configurations state float32 with TF32 off, the program's option
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = Spec(cell, config, traffic, limits, args.seed, "cuda", args.trace,
                scratch_dir())
    return finish(*run_cell(spec, args.seconds, t0, clock, bench))


def run_local(bench, name, root, here, seed, seconds, trace, device):
    """A run without the look for a chip (the tests' entry): (result,
    checks)."""
    import time

    cell, config, traffic, limits = resolve(bench, name, root, here)
    spec = Spec(cell, config, traffic, limits, seed, device, trace,
                scratch_dir(), here)
    return run_cell(spec, seconds, time.perf_counter(), time.perf_counter,
                    bench)


def finish(result, checks):
    """The guard, the checks on standard error, the result line last on
    standard output; the exit code."""
    bad = forbidden_modules()
    if bad:
        print("perfbench: the run loaded " + ", ".join(bad)
              + ": the benchmark runs the port alone", file=sys.stderr)
        return 4
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'} {c.note}".rstrip(),
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
