"""The Granite cell of the benchmark at tiny widths on the CPU: the cell runs
through ``perfbench.harness.run_local`` (the look for a chip skipped) and
comes out correct, a traced run reads its metrics, and with a fault planted
in the program underneath, once for each of three faults, it comes out not
correct.  Faults: one row of the batch losing its Mamba-2 ssm state at
every decode step, top-k gates not renormalised (Jamba's rule), a conv
window over xBC that does not advance, and an attention position that does
not advance.  The tiny root adds, as new files
beside the real ones, a configuration of the real one's keys at tiny widths
in float32, a traffic file and the real cell's limits.  Its weights' stds
grow as the hidden size shrinks (times (4096 / 32) ** 0.5: 0.02 is 0.23)
and its logit scaling falls with it (16 is 1.41), and its attention scale
grows as the head shrinks (times (128 / 8) ** 0.5: 1/128 is 1/32), so that
activations, attention scores and logits have the published widths'
scale."""

import json
import os
import shutil
from unittest import mock

import pytest
import torch

from perfbench import granite_program, harness

torch.set_num_threads(1)

CELL = "granite-4.0-h-small-10l.generate-p4096-g128-b8-bf16"
WIDER = (4096 / 32) ** 0.5
HEAD = (128 / 8) ** 0.5
NAME = "granite-tiny.generate"
WIDTHS = {"hidden_size": 32, "intermediate_size": 24,
          "shared_intermediate_size": 40, "num_attention_heads": 4,
          "num_key_value_heads": 2, "mamba_n_heads": 8, "mamba_d_head": 8,
          "mamba_d_state": 16, "num_local_experts": 8,
          "num_experts_per_tok": 3, "vocab_size": 64, "dtype": "float32",
          "logits_scaling": 16 / WIDER,
          "attention_multiplier": 0.0078125 * HEAD}
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
    rel = "perfbench/configs/granite-tiny.json"
    write(os.path.join(path, rel), dict(
        harness.load_json(os.path.join(repo, entry["file"])), **WIDTHS))
    bench["configs"].append(dict(entry, name="granite-tiny", file=rel))
    traffic = harness.load_json(os.path.join(
        harness.HERE, "traffic", f"{cell['traffic']}.json"))
    write(os.path.join(here, "traffic", f"{NAME}.json"),
          dict(traffic, **TRAFFIC))
    shutil.copy(os.path.join(harness.HERE, "limits", f"{CELL}.json"),
                os.path.join(here, "limits", f"{NAME}.json"))
    bench["workloads"].append(dict(cell, name=NAME, config="granite-tiny",
                                   traffic=NAME))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(NAME)
    write(os.path.join(path, "BENCHMARK.json"), bench)
    return str(path), here, bench


def run(root, trace=False):
    path, here, bench = root
    with mock.patch.multiple(granite_program,
                             LINEAR_STD=granite_program.LINEAR_STD * WIDER,
                             OUT_STD=granite_program.OUT_STD * WIDER,
                             QK_STD=granite_program.QK_STD * WIDER):
        return harness.run_local(bench, NAME, path, here, 2 ** 31 + 13, 0.3,
                                 trace, "cpu")


def test_tiny_granite_cell_is_correct(root):
    result, checks = run(root)
    assert result["correct"], [(c.name, c.value, c.limit) for c in checks]
    assert result["attempted"] >= 1
    assert set(result["metrics"]) == {"lm_tokens_per_s", "setup_s"}
    assert {c.name for c in checks} == {"logit_err", "logit_err_row_median",
                                        "token_gap"}


def test_tiny_granite_cell_traced_reads_its_metrics(root):
    result, _ = run(root, trace=True)
    assert result["correct"]
    # on the CPU no device metric has anything to read; none raises, the
    # window's latencies give the p95 and the request's FLOPs the mfu's
    # numerator (its peak is the card's: None here)
    assert "lm.request_p95_ms" in result["metrics"]
    assert set(result["metrics"]) <= {
        "k1_roofline.lm", "granite.decode_roofline", "granite.mfu",
        "granite.ssm_ms", "lm.forward_launches", "lm.kernels_per_token",
        "lm.request_p95_ms", "device.idle.lm", "setup.capture_s"}


def one_slot_state():
    """Row 0 of the batch loses its Mamba-2 layers' ssm state at every
    decode step: a fault in one slot of the batch."""
    from vivim_tpu_torch.nn import streaming
    real = streaming.mamba2_step

    def step(m, x, conv_state, ssm_state):
        ssm_state[:1].zero_()   # the step writes the state in place
        return real(m, x, conv_state, ssm_state)
    return mock.patch.object(streaming, "mamba2_step", step)


def stuck_position():
    """The attention layer's K/V position read but never advanced in
    decode: every step writes its key and value over the last one's."""
    from vivim_tpu_torch.nn import attention
    real = attention.gqa_step

    def stuck(params, x, cache, pos, n_heads, n_kv, scale=None):
        out, cache, _ = real(params, x, cache, pos.clone(), n_heads, n_kv,
                             scale)
        return out, cache, pos
    return mock.patch.object(attention, "gqa_step", stuck)


def gates_not_renormalised():
    from vivim_tpu_torch.nn import moe
    return mock.patch.object(moe, "_route_renormalised", moe._route)


def stuck_window():
    """The xBC conv window read but never advanced in decode."""
    from vivim_tpu_torch.nn import streaming
    real = streaming.conv_step

    def conv(x, conv_state, weight, bias=None):
        return real(x, conv_state.clone(), weight, bias)
    return mock.patch.object(streaming, "conv_step", conv)


@pytest.mark.parametrize("fault", [one_slot_state, gates_not_renormalised,
                                   stuck_window, stuck_position])
def test_tiny_granite_cell_fault_reads_not_correct(root, fault):
    with fault():
        result, checks = run(root)
    assert not result["correct"], [(c.name, c.value) for c in checks]


class Event:
    """What ``span_device_seconds`` reads of a kineto event."""

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


def test_span_device_seconds_sums_the_kernels_launched_in_the_span():
    from perfbench.drivers.granite_generate import span_device_seconds

    cuda = torch.autograd.DeviceType.CUDA
    events = [
        Event("lm.ssm", 0, 100, 200),
        Event("cudaLaunchKernel", 5, 110, 115),      # in the span
        Event("cudaLaunchKernelExC", 6, 150, 160),   # in the span
        Event("cudaLaunchKernel", 7, 210, 215),      # after it
        Event("lm.ssm", 0, 300, 400),
        Event("cuLaunchKernel", 8, 390, 395),        # in the second
        # their work on the device, and a range that is no work
        Event("selective_scan_fwd", 5, 1000, 1400, True),
        Event("Memcpy DtoD", 6, 1400, 1450, True, "gpu_memcpy"),
        Event("gemm", 7, 1500, 1900, True),
        Event("selective_scan_fwd", 8, 2000, 2100, True),
        Event("lm.ssm", 5, 1000, 1500, True, "gpu_user_annotation"),
    ]
    assert span_device_seconds(events, cuda, "lm.ssm") == pytest.approx(
        550e-9)
    assert span_device_seconds(events, cuda, "lm.attn") is None
    assert span_device_seconds(events[:1], cuda, "lm.ssm") is None
