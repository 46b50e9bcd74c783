"""The harness on the CPU: discovery by name, traffic, the window's
arithmetic, the trace's reduction, the frozen work counts, the result
line and the guards.  Run: ``python -m pytest perfbench -q``."""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from perfbench import harness, tiny, trace, traffic, work

REPO = pathlib.Path(harness.HERE).parent
BENCH = harness.load_json(REPO / "BENCHMARK.json")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def test_every_name_resolves_to_its_files():
    for cell in BENCH["workloads"]:
        _, config, traffic_, limits = harness.resolve(BENCH, cell["name"],
                                                      str(REPO))
        assert config["reduced"] == next(
            c["reduced"] for c in BENCH["configs"]
            if c["name"] == cell["config"])
        drv = harness.driver_class(traffic_)
        assert all(hasattr(drv, m) for m in (
            "setup", "measure", "end_to_end", "layer_info", "release",
            "check", "control"))
        assert limits
    for m in BENCH["per_layer"]:
        path = REPO / "perfbench" / "metrics" / f"{m['name']}.py"
        assert "def read(run)" in path.read_text()


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    for cell in BENCH["workloads"]:
        e2e = {m["name"] for m in harness.e2e_metrics(BENCH, cell["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.layer_metrics(BENCH, cell["name"], e2e)


def test_dummy_config_cell_and_metric_added_as_files_run(root, tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric that
    exist only as new files run through the harness."""
    path, here, bench = root
    bench = json.loads(json.dumps(bench))
    with open(os.path.join(here, "metrics", "dummy.units.py"), "w") as f:
        f.write("def read(run):\n    return float(run.window.units)\n")
    bench["per_layer"].append({
        "name": "dummy.units", "unit": "requests", "better": "higher",
        "source": "host_clock", "layer": "LM request loop",
        "moves": "lm_tokens_per_s", "workloads": ["mamba-tiny.score"]})
    result, checks = tiny.run(path, here, bench, "mamba-tiny.score",
                              trace=True)
    assert result["correct"], result["checks"]
    assert result["metrics"]["dummy.units"]["value"] == result["attempted"]
    assert list(result)[-1] == "checks"


def test_traffic_is_the_same_for_the_same_seed():
    a = traffic.clip_batch(2 ** 31 + 5, 3, 2, 2, 32, 3)
    b = traffic.clip_batch(2 ** 31 + 5, 3, 2, 2, 32, 3)
    c = traffic.clip_batch(2 ** 31 + 6, 3, 2, 2, 32, 3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[1].sum(-1).eq(1).all() and a[1][..., 1:].sum() > 0
    ids = traffic.token_ids(7, 4, 1, 64, 50277)
    assert torch.equal(ids, traffic.token_ids(7, 4, 1, 64, 50277))
    assert not torch.equal(ids, traffic.token_ids(7, 5, 1, 64, 50277))
    assert ids.max() < 50277
    assert traffic.sample(9, 48, 4) == traffic.sample(9, 48, 4)
    assert len(set(traffic.sample(9, 48, 4))) == 4


def test_rates_and_the_p95_are_over_the_whole_window():
    w = harness.Window(10.0, 12.5, latencies=[0.1] * 19 + [1.0], amount=100)
    assert w.units == 20 and w.seconds == 2.5
    assert w.rate() == pytest.approx(40.0)
    lat = [i / 100 for i in range(1, 101)]
    assert harness.percentile(lat, 95) == pytest.approx(0.9505)
    assert harness.percentile([0.1] * 19 + [1.0], 95) == pytest.approx(
        0.1 + 0.05 * 0.9)


def test_idle_share_from_synthetic_intervals():
    dev = [("k1", 0.0, 1.0, 7), ("k2", 0.5, 2.0, 8), ("Memcpy HtoD", 3.0,
                                                       3.5, 7),
           ("k1", 6.0, 7.0, 7)]
    host = [("cudaStreamSynchronize", 2.0, 3.0), ("python", 3.6, 6.0),
            ("inner", 4.0, 5.0)]
    p = trace.Profile(0.0, 10.0, dev, host)
    assert trace.busy_s(p) == pytest.approx(3.5)
    assert trace.gaps([(s, e) for _, s, e, _ in dev], 0.0, 10.0) == [
        (2.0, 3.0), (3.5, 6.0), (7.0, 10.0)]
    b = trace.breakdown(p)
    assert b["device_ops"][0] == ["k1", 2.0]
    labels = dict(b["idle_gaps"])
    assert labels["cudaStreamSynchronize"] == pytest.approx(1.0)
    from perfbench import readers
    p.units = 2
    run = harness._Run(None, harness.Window(0.0, 20.0, latencies=[1.0] * 2),
                       p, {}, None)
    assert readers.idle(run) == pytest.approx(100 * (1 - 1.75 / 10.0))
    assert len(readers.kernels(p)) == 3


def test_conv_time_counts_concurrent_branches_once():
    from perfbench import readers
    dev = [("implicit_convolveNd_sgemm", 0.0, 0.004, 7),
           ("implicit_convolveNd_sgemm", 0.001, 0.005, 8),
           ("nhwcToNchwKernel", 0.006, 0.007, 7),
           ("gemm_kernel", 0.0, 0.010, 9)]
    p = trace.Profile(0.0, 0.02, dev, [], units=2)
    run = harness._Run(None, harness.Window(0.0, 1.0), p, {}, None)
    assert readers.per_unit_ms(run, readers.CONV) == pytest.approx(4.5)
    assert readers.per_unit_union_ms(run, readers.CONV) == pytest.approx(3.0)
    assert readers.per_unit_union_ms(run, ("nothing",)) is None


class _Event:
    """A kineto event as ``trace.reduce`` reads it."""

    def __init__(self, name, start, end, kind, device=False, stream=0):
        self._v = (name, start, end, kind, device, stream)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def activity_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[3].endswith("user_annotation")

    def device_type(self):
        return "cuda" if self._v[4] else "cpu"

    def device_resource_id(self):
        return self._v[5]


class _OlderEvent(_Event):
    """An event of a PyTorch that does not tell its activity type."""

    activity_type = None


@pytest.mark.parametrize("event", [_Event, _OlderEvent])
def test_ranges_on_the_device_timeline_do_not_read_as_busy(event):
    """The window's range and a range nested in it (a span the program
    opens) show on the device's timeline as annotations: only kernels,
    copies and sets count."""
    ms = 1_000_000
    base = 7 * 10 ** 15
    ev = lambda n, s, e, kind, dev=False: event(n, base + s * ms,
                                                base + e * ms, kind, dev, 7)
    events = [
        ev(trace.WINDOW, 0, 100, "user_annotation"),
        ev(trace.WINDOW, 1, 99, "gpu_user_annotation", True),
        ev("train.forward", 10, 60, "user_annotation"),
        ev("train.forward", 12, 80, "gpu_user_annotation", True),
        ev("aten::mm", 10, 11, "cpu_op"),
        ev("cudaLaunchKernel", 10, 11, "cuda_runtime"),
        ev("gemm_kernel", 20, 30, "kernel", True),
        ev("Memcpy HtoD (Pageable -> Device)", 40, 45, "gpu_memcpy", True),
        ev("Memset (Device)", 50, 51, "gpu_memset", True),
        ev("gemm_kernel", 200, 210, "kernel", True),
    ]
    p = trace.reduce(events, "cuda")
    assert p.window_s == pytest.approx(0.1)
    assert [d[0] for d in p.device] == [
        "gemm_kernel", "Memcpy HtoD (Pageable -> Device)", "Memset (Device)"]
    assert trace.busy_s(p) == pytest.approx(0.016)
    assert {h[0] for h in p.host} == {"train.forward", "aten::mm",
                                      "cudaLaunchKernel"}


def test_a_profile_with_a_nested_range_reduces_on_the_cpu():
    from torch.profiler import record_function

    def run():
        with record_function("perfbench.test.inner"):
            torch.ones(8) @ torch.ones(8)
    p = trace.profile(run, lambda: None, False)
    assert p.device == [] and trace.busy_s(p) == 0.0
    names = {h[0] for h in p.host}
    assert "perfbench.test.inner" in names and trace.WINDOW not in names


def test_frozen_work_counts_give_the_kernel_table_bounds():
    """K1 per serving forward 0.152 ms, K1-training per fp32 step 0.457,
    K2 per fp32 step 0.694, K1 per LM prefill 0.024 (PERF.md's table)."""
    cfg = harness.load_json(REPO / "perfbench/configs/vivim-b3.json")
    lm = harness.load_json(REPO / "perfbench/configs/mamba-130m.json")
    peaks = work.card_peaks("NVIDIA H100 80GB HBM3", 132, 1980)
    ms = lambda w: work.bound_s(work.total(w), peaks) * 1e3
    serve = work.vivim_scan_shapes(cfg, 1)
    train = work.vivim_scan_shapes(cfg, 3)
    assert serve[0] == (3, 20480, 128) and len(serve) == 8
    assert ms([work.scan_work(*s, 16, 4) for s in serve]) == pytest.approx(
        0.152, abs=5e-4)
    assert ms([work.train_fwd_work(*s, 16, 4) for s in train]) == \
        pytest.approx(0.457, abs=5e-4)
    assert ms([work.bwd_work(*s, 16, 4) for s in train]) == pytest.approx(
        0.694, abs=5e-4)
    assert ms([work.scan_work(*s, 16, 4) for s in work.lm_scan_shapes(
        lm, 1, 128)]) == pytest.approx(0.024, abs=5e-4)


def test_guard_refuses_a_run_that_loaded_the_jax_package(monkeypatch,
                                                         capsys):
    monkeypatch.setitem(sys.modules, "vivim_tpu", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.finish({"correct": True}, []) != 0
    out = capsys.readouterr()
    assert out.out == "" and "vivim_tpu" in out.err
    monkeypatch.delitem(sys.modules, "vivim_tpu")
    monkeypatch.delitem(sys.modules, "jax.numpy")
    monkeypatch.setitem(sys.modules, "vivim_tpu_torch_like", object())
    assert harness.finish({"correct": True}, []) == 0


def test_no_result_without_the_cuda_devices_the_cell_asks_for():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_the_reference_imports_nothing_of_the_program():
    ref = REPO / "perfbench" / "reference"
    for p in ref.glob("*.py"):
        text = p.read_text()
        assert "vivim_tpu" not in text, p
    code = ("import sys\n"
            "import perfbench.reference.vivim, perfbench.reference.mamba_lm\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('vivim_tpu', 'vivim_tpu_torch', 'jax', 'jaxlib', 'flax')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_nothing_the_harness_runs_imports_jax():
    code = ("import sys\n"
            "import perfbench.harness, perfbench.control, perfbench.readers\n"
            "import perfbench.drivers.vivim_train, perfbench.drivers."
            "vivim_serve, perfbench.drivers.lm_generate, perfbench.drivers."
            "lm_score, perfbench.programs\n"
            "from perfbench import programs\n"
            "import vivim_tpu_torch.cli.infer, vivim_tpu_torch.nn.lm, "
            "vivim_tpu_torch.train.loop, vivim_tpu_torch.cli.lm_eval_harness\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('vivim_tpu', 'jax', 'jaxlib', 'flax')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
