"""The Falcon-H1 cell of the benchmark at tiny widths on the CPU: the cell
runs through ``perfbench.harness.run_local`` (the look for a chip skipped)
and comes out correct, a traced run reads its metrics, and with a fault
planted in the program underneath, once for each of five faults, it comes
out not correct.  Faults: a K/V position that does not advance, the decode
step's rotary positions at position 0, one row of the batch losing its
Mamba-2 ssm state at every decode step, the gated norm over all of d_ssm
instead of per group, and a dropped ``ssm_out_multiplier``.  The tiny root
adds, as new files beside the real ones, a configuration of the real one's
keys at tiny widths in float32 (two layers, 2 Mamba-2 groups of 4 heads of
8 at the published d_state 256, 4 query and 2 key/value heads of 8), a
traffic file and the real cell's limits.  Its weights' stds grow as the
widths shrink (times (5120 / 32) ** 0.5, the hidden size's ratio), so that
activations, attention scores and logits have about the published widths'
scale; d_state stays 256, since the state's share of y grows with it (at
16 a row's lost state read 0.13 row median, under the limit).  The work
counts are held to hand counts at the published widths."""

import dataclasses
import json
import os
import shutil
from unittest import mock

import pytest
import torch

from perfbench import falcon_program, harness

torch.set_num_threads(1)

CELL = "falcon-h1-34b-18l.generate-p4096-g128-b8-bf16"
WIDER = (5120 / 32) ** 0.5
NAME = "falcon-tiny.generate"
WIDTHS = {"hidden_size": 32, "intermediate_size": 48, "num_hidden_layers": 2,
          "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 8,
          "mamba_d_ssm": 64, "mamba_n_heads": 8, "mamba_d_head": 8,
          "mamba_d_state": 256, "vocab_size": 64, "dtype": "float32"}
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
    rel = "perfbench/configs/falcon-tiny.json"
    write(os.path.join(path, rel), dict(
        harness.load_json(os.path.join(repo, entry["file"])), **WIDTHS))
    bench["configs"].append(dict(entry, name="falcon-tiny", file=rel))
    traffic = harness.load_json(os.path.join(
        harness.HERE, "traffic", f"{cell['traffic']}.json"))
    write(os.path.join(here, "traffic", f"{NAME}.json"),
          dict(traffic, **TRAFFIC))
    shutil.copy(os.path.join(harness.HERE, "limits", f"{CELL}.json"),
                os.path.join(here, "limits", f"{NAME}.json"))
    bench["workloads"].append(dict(cell, name=NAME, config="falcon-tiny",
                                   traffic=NAME))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(NAME)
    write(os.path.join(path, "BENCHMARK.json"), bench)
    return str(path), here, bench


def run(root, trace=False):
    path, here, bench = root
    stds = {k: s if k == "embed_tokens.weight" else s * WIDER
            for k, s in falcon_program.STDS.items()}
    with mock.patch.object(falcon_program, "STDS", stds):
        return harness.run_local(bench, NAME, path, here, 2 ** 31 + 13, 0.3,
                                 trace, "cpu")


def test_tiny_falcon_cell_is_correct(root):
    result, checks = run(root)
    assert result["correct"], [(c.name, c.value, c.limit) for c in checks]
    assert result["attempted"] >= 1
    assert set(result["metrics"]) == {"lm_tokens_per_s", "setup_s"}
    assert {c.name for c in checks} == {"logit_err", "logit_err_row_median",
                                        "token_gap"}


def test_tiny_falcon_cell_traced_reads_its_metrics(root):
    result, _ = run(root, trace=True)
    assert result["correct"]
    # on the CPU no device metric has anything to read; none raises, the
    # window's latencies give the p95, and the spans, though the profiler
    # records them, launch no CUDA work
    assert "lm.request_p95_ms" in result["metrics"]
    assert set(result["metrics"]) <= {
        "k1_roofline.lm", "lm.request_p95_ms", "lm.kernels_per_token",
        "device.idle.lm", "lm.forward_launches", "setup.capture_s",
        "lm.ssm_ms", "lm.attn_ms", "lm.decode_roofline", "lm.model_mfu"}


def stuck_position():
    """The K/V position read but never advanced in decode: every step
    writes its key and value over the last one's."""
    from vivim_tpu_torch.nn import attention
    real = attention.gqa_step

    def stuck(params, x, cache, pos, *args):
        out, cache, _ = real(params, x, cache, pos.clone(), *args)
        return out, cache, pos
    return mock.patch.object(attention, "gqa_step", stuck)


def rope_at_zero():
    """The decode step's query and key rotated at position 0, not at the
    cache's position (the cache still written there)."""
    from vivim_tpu_torch.nn import attention
    real = attention._rotate

    def rotate(rp, positions, q, k):
        if positions.numel() == 1:
            positions = torch.zeros_like(positions)
        return real(rp, positions, q, k)
    return mock.patch.object(attention, "_rotate", rotate)


def one_slot_state():
    """Row 0 of the batch loses its Mamba-2 ssm state at every decode
    step: a fault in one slot of the batch."""
    from vivim_tpu_torch.nn import streaming
    real = streaming.mamba2_step

    def step(m, x, conv_state, ssm_state):
        ssm_state[:1].zero_()   # the step writes the state in place
        return real(m, x, conv_state, ssm_state)
    return mock.patch.object(streaming, "mamba2_step", step)


def norm_over_all_channels():
    """The gated norm over all of d_ssm, Granite's, not per group."""
    from vivim_tpu_torch.nn import streaming
    real = streaming.gated_norm
    return mock.patch.object(
        streaming, "gated_norm",
        lambda m, y, z: real(dataclasses.replace(m, norm_groups=1), y, z))


def dropped_ssm_out_multiplier():
    from vivim_tpu_torch.nn import falcon_h1
    real = falcon_h1.FalconH1LM.split_params

    def split(self, params):
        parts = real(self, params)
        return dataclasses.replace(parts, layers=[
            dataclasses.replace(layer, mixer=dataclasses.replace(
                layer.mixer, ssm_out=1.0)) for layer in parts.layers])
    return mock.patch.object(falcon_h1.FalconH1LM, "split_params", split)


@pytest.mark.parametrize("fault", [stuck_position, rope_at_zero,
                                   one_slot_state, norm_over_all_channels,
                                   dropped_ssm_out_multiplier])
def test_tiny_falcon_cell_fault_reads_not_correct(root, fault):
    with fault():
        result, checks = run(root)
    assert not result["correct"], [(c.name, c.value) for c in checks]
    print(fault.__name__, [(c.name, c.value) for c in checks])


@pytest.fixture(scope="module")
def published():
    repo = os.path.dirname(harness.HERE)
    return harness.load_json(os.path.join(
        repo, "perfbench", "configs", "falcon-h1-34b-18l.json"))


def test_k1_work_counts_both_groups_and_no_z(published):
    # 18 calls at (8, 4096, 4096, N 256): u, delta, y and the B and C of
    # 2 groups in bf16, the fp32 states' read and write, 6 N + 8 operations
    # and N exps a channel and step
    b, L, d, n, g = 8, 4096, 4096, 256, 2
    one = (b * L * (3 * d + 2 * g * n) * 2 + b * d * (2 * n + 2) * 4,
           b * L * d * (6 * n + 8), b * L * d * n)
    assert falcon_program.k1_work(published, b, L, 2) == tuple(
        18 * x for x in one)


def test_request_flops_is_the_hand_count(published):
    m, f, v = 5120, 21504, 261120
    in_proj = 4096 + (4096 + 2 * 2 * 256) + 32     # z, xBC, dt
    per_layer = (m * in_proj + 4096 * m + 4 * (4096 + 1024)   # + out, conv
                 + m * 2560 + 2 * m * 512 + 2560 * m          # q, k, v, o
                 + 3 * m * f)                                 # the SwiGLU
    prompt, new = 4096, 128
    pairs = prompt * (prompt + 1) // 2 + sum(prompt + t + 1
                                             for t in range(new))
    scan = 18 * (prompt + new) * 4096 * (6 * 256 + 8)
    want = 8 * ((prompt + new) * 2 * 18 * per_layer
                + 18 * 4 * 20 * 128 * pairs + 2 * m * v * (1 + new) + scan)
    assert falcon_program.request_flops(published, 8, prompt, new) == want
    assert 5.4e14 < want < 5.5e14


def test_decode_bytes_is_the_hand_count(published):
    m, f, v = 5120, 21504, 261120
    layer = (m * 9248 + 5120 * 4 + 5120 + 3 * 32 + 4096 + m * 4096
             + m * 2560 + 2 * m * 512 + m * 2560 + 3 * m * f + 2 * m)
    weights = 18 * layer + m + v * m + 8 * m   # norm_f, head, 8 rows
    kv = 18 * 8 * 2 * 4 * 128 * (4096 + 129 / 2 + 1)
    states = 18 * 2 * 8 * (5120 * 4 * 2 + 4096 * 256 * 4)
    assert falcon_program.decode_bytes(published, 8, 4096, 128, 2) \
        == pytest.approx((weights + kv) * 2 + states, rel=1e-12)
    assert 2.0e10 < (weights + kv) * 2 + states < 2.1e10
