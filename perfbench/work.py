"""The yardstick's arithmetic: the card's published peaks and the
selective-scan kernels' work, frozen here from ``chip_smoke.py`` (PR 13's
kernel table), so that a change to the program cannot move a bound.

A bound is the least time the card could take: the largest of the bytes
over the memory rate, the fp32 operations over the fp32 rate and the
exponentials over the SFU's rate (16 ex2 results per clock per SM on
compute capability 9.0, at the card's highest SM clock).
"""

from __future__ import annotations

import subprocess

# data sheets, dense rates: HBM bytes/s and fp32 (no tensor core) FLOP/s
CARDS = {"H100 PCIe": (2.0e12, 51e12), "H200": (4.8e12, 67e12),
         "H100": (3.35e12, 67e12)}
MUFU_PER_CLOCK_PER_SM = 16
CHUNK = 16          # K1-training saves the state every 16 steps


def nvidia_smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60
    ).stdout.strip().splitlines()[0]


def card_peaks(name, sms, max_sm_mhz):
    """(bytes/s, fp32 FLOP/s, exps/s) of the card called ``name``."""
    for key, (bw, flops) in CARDS.items():
        if key in name:
            return bw, flops, MUFU_PER_CLOCK_PER_SM * sms * max_sm_mhz * 1e6
    raise RuntimeError(f"no peak figures for card {name!r}")


def device_peaks():
    """The peaks of card 0, and its name and power limit."""
    import torch

    name = torch.cuda.get_device_name(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    return card_peaks(name, sms, mhz), name, nvidia_smi("power.limit")


def bound_s(work, peaks):
    """Seconds of the binding term of work = (bytes, fp32 operations,
    exps)."""
    return max(w / p for w, p in zip(work, peaks))


def scan_work(batch, L, d, n, elem):
    """K1, inference variant (z gated, last state): reads u, delta, z, B,
    C, writes y; per state and step one exp and about six other
    operations, per channel and step about eight."""
    nbytes = (batch * L * (4 * d + 2 * n) * elem
              + batch * d * (2 * n + 2) * 4)
    return nbytes, batch * L * d * (6 * n + 8), batch * L * d * n


def train_fwd_work(batch, L, d, n, elem, chunk=CHUNK):
    """K1, training variant: reads u, delta, B, C, writes y, the chunk
    states and the last state; no z."""
    nbytes = (batch * L * (3 * d + 2 * n) * elem
              + batch * -(-L // chunk) * d * n * 4
              + batch * d * (2 * n + 2) * 4)
    return nbytes, batch * L * d * (6 * n + 4), batch * L * d * n


def bwd_work(batch, L, d, n, elem, chunk=CHUNK):
    """K2 as the training step calls it: reads u, delta, dy, B, C and the
    chunk states, writes ddelta, du, dB, dC and the per-row parameter
    gradients; one exp per state and step, about 19 other operations per
    state and step and 20 per channel and step."""
    nbytes = (batch * L * (5 * d + 4 * n) * elem
              + batch * -(-L // chunk) * d * n * 4
              + batch * d * (2 * n + 2 + 4) * 4)
    return nbytes, batch * L * d * (19 * n + 20), batch * L * d * n


def total(works):
    """Elementwise sum of work tuples."""
    return tuple(sum(w[i] for w in works) for i in range(3))


def vivim_scan_shapes(cfg, batch):
    """(scan batch, L, d_inner) of each Mamba layer's scan call of a Vivim
    configuration at ``batch`` clips: the three directions stacked on the
    batch axis, the tokens of every frame of the stage."""
    size, T = cfg["image_size"], cfg["clip_length"]
    seg = cfg["segformer"]
    shapes = []
    for i, depth in enumerate(cfg["mamba_depths"]):
        size = -(-size // seg["strides"][i])
        shapes += [(3 * batch, T * size * size,
                    cfg["expand"] * seg["hidden_sizes"][i])] * depth
    return shapes


def lm_scan_shapes(cfg, batch, L):
    """(batch, L, d_inner) of each layer's scan call of a Mamba LM."""
    ssm = cfg.get("ssm_cfg") or {}
    return [(batch, L, ssm.get("expand", 2) * cfg["d_model"])] * cfg["n_layer"]
