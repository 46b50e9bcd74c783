"""The Jamba cell of the benchmark at tiny widths on the CPU: the cell runs
through ``perfbench.harness.run_local`` (the look for a chip skipped) and
comes out correct, and with a fault planted in the program underneath, once
for each of three faults, it comes out not correct.  Faults: a K/V
position that does not advance in the decode graph, top-2 gates
renormalised to sum to 1, and one row of the batch losing its ssm state at
every decode step.  The tiny root adds, as new files beside the real ones, a
configuration of the real one's keys at tiny widths in float32, a traffic
file and the real cell's limits, as ``perfbench/tiny.py`` does for the
other cells."""

import json
import os
import shutil
from unittest import mock

import pytest
import torch

from perfbench import harness

torch.set_num_threads(1)

CELL = "jamba2-mini-8l.generate-p4096-g128-b8-bf16"
NAME = "jamba-tiny.generate"
WIDTHS = {"hidden_size": 32, "intermediate_size": 48, "mamba_dt_rank": 8,
          "num_attention_heads": 4, "num_key_value_heads": 2,
          "num_experts": 4, "vocab_size": 64, "dtype": "float32"}
TRAFFIC = {"batch": 2, "prompt_len": 9, "new_tokens": 8, "pool": 3,
           "sample_within": 2, "checked": 2, "warmup": 1}


def write(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = tmp_path_factory.mktemp("bench")
    repo = os.path.dirname(harness.HERE)
    here = os.path.join(path, "perfbench")
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(harness.HERE, sub),
                        os.path.join(here, sub))
    bench = harness.load_json(os.path.join(repo, "BENCHMARK.json"))
    cell = {c["name"]: c for c in bench["workloads"]}[CELL]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    rel = "perfbench/configs/jamba-tiny.json"
    write(os.path.join(path, rel), dict(
        harness.load_json(os.path.join(repo, entry["file"])), **WIDTHS))
    bench["configs"].append(dict(entry, name="jamba-tiny", file=rel))
    traffic = harness.load_json(os.path.join(
        harness.HERE, "traffic", f"{cell['traffic']}.json"))
    write(os.path.join(here, "traffic", f"{NAME}.json"),
          dict(traffic, **TRAFFIC))
    shutil.copy(os.path.join(harness.HERE, "limits", f"{CELL}.json"),
                os.path.join(here, "limits", f"{NAME}.json"))
    bench["workloads"].append(dict(cell, name=NAME, config="jamba-tiny",
                                   traffic=NAME))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(NAME)
    write(os.path.join(path, "BENCHMARK.json"), bench)
    return str(path), here, bench


def run(root, trace=False):
    path, here, bench = root
    return harness.run_local(bench, NAME, path, here, 2 ** 31 + 11, 0.3,
                             trace, "cpu")


def test_tiny_jamba_cell_is_correct(root):
    result, checks = run(root)
    assert result["correct"], [(c.name, c.value, c.limit) for c in checks]
    assert result["attempted"] >= 1
    assert set(result["metrics"]) == {"lm_tokens_per_s", "setup_s"}
    assert {c.name for c in checks} == {"logit_err", "logit_err_row_median",
                                        "token_gap"}


def test_tiny_jamba_cell_traced_reads_its_metrics(root):
    result, _ = run(root, trace=True)
    assert result["correct"]
    # on the CPU no device metric has anything to read; none raises, and
    # the window's latencies give the p95
    assert "lm.request_p95_ms" in result["metrics"]
    assert set(result["metrics"]) <= {
        "k1_roofline.lm", "jamba.decode_roofline", "jamba.mfu",
        "lm.forward_launches", "lm.kernels_per_token", "lm.request_p95_ms",
        "device.idle.lm", "setup.capture_s"}


def stuck_position():
    from vivim_tpu_torch.nn import attention
    real = attention.gqa_step

    def stuck(params, x, cache, pos, n_heads, n_kv, scale=None):
        # the step reads the position but advances a copy of it
        out, cache, _ = real(params, x, cache, pos.clone(), n_heads, n_kv,
                             scale)
        return out, cache, pos
    return mock.patch.object(attention, "gqa_step", stuck)


def renormalised_gates():
    from vivim_tpu_torch.nn import moe
    real = moe._route

    def route(params, xt, top_k):
        gates, experts = real(params, xt, top_k)
        return gates / gates.sum(-1, keepdim=True), experts
    return mock.patch.object(moe, "_route", route)


def one_slot_state():
    """Row 0 of the batch loses its Mamba layers' ssm state at every
    decode step: a fault in one slot of eight at the cell's load."""
    from vivim_tpu_torch.nn import streaming
    real = streaming.mamba_step

    def step(params, x, conv_state, ssm_state, *args, **kw):
        ssm_state[:1].zero_()   # the step writes the state in place
        return real(params, x, conv_state, ssm_state, *args, **kw)
    return mock.patch.object(streaming, "mamba_step", step)


@pytest.mark.parametrize("fault", [stuck_position, renormalised_gates,
                                   one_slot_state])
def test_tiny_jamba_cell_fault_reads_not_correct(root, fault):
    with fault():
        result, checks = run(root)
    assert not result["correct"], [(c.name, c.value) for c in checks]


class Event:
    """What ``replay_seconds`` reads of a kineto event."""

    def __init__(self, name, cid, start, end, device=False, kind="kernel"):
        self._name, self._cid, self._s, self._e = name, cid, start, end
        self._dev, self._kind = device, kind

    def name(self):
        return self._name

    def correlation_id(self):
        return self._cid

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._dev
                else torch.autograd.DeviceType.CPU)

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def activity_type(self):
        return self._kind


def test_replay_seconds_spans_each_graph_launch_on_the_device():
    from perfbench.drivers.jamba_generate import replay_seconds

    events = [
        Event("cudaGraphLaunch", 5, 0, 10),
        Event("cudaLaunchKernel", 7, 12, 14),
        Event("cudaGraphLaunch", 9, 20, 30),
        # replay 5's work: a gap inside it counts; the range does not
        Event("gemv", 5, 100, 150, True),
        Event("Memcpy DtoD", 5, 150, 160, True, "gpu_memcpy"),
        Event("addcmul", 5, 170, 200, True),
        Event("graph.replay", 5, 90, 400, True, "gpu_user_annotation"),
        # the eager draw between the replays
        Event("argmax", 7, 200, 260, True),
        # replay 9's
        Event("gemv", 9, 260, 300, True),
        Event("gemv", 9, 300, 360, True),
        # a host event with a launch's id is not device work
        Event("aten::mm", 9, 0, 1000),
    ]
    got = sorted(replay_seconds(events, torch.autograd.DeviceType.CUDA))
    assert got == pytest.approx([100e-9, 100e-9])
    assert replay_seconds(events[:3], torch.autograd.DeviceType.CUDA) == []
