"""Tiny copies of the benchmark's cells for the CPU tests: a root whose
``BENCHMARK.json`` adds, as new files only, a configuration, a traffic
file and limits per tiny cell beside the real ones (widths cut so that a
run takes seconds on the CPU), and the real per-layer metric files."""

from __future__ import annotations

import json
import os
import shutil

from perfbench import harness

TINY = {  # tiny cell: (real cell, tiny config, tiny traffic's changes)
    "vivim-tiny.train": ("vivim-b3.train-bs3-t5-256-fp32", "vivim-tiny",
                         {"batch": 2, "pool": 4}),
    "vivim-tiny.serve": ("vivim-b3.serve-bs1-t5-256-fp32", "vivim-tiny",
                         {"pool": 3, "sample_within": 2, "checked": 2}),
    "mamba-tiny.generate": ("mamba-130m.generate-p128-g128-b1-fp32",
                            "mamba-tiny", {"prompt_len": 9, "new_tokens": 5,
                                           "sample_within": 2, "checked": 2}),
    "mamba-tiny.score": ("mamba-130m.score-l2048-b1-fp32", "mamba-tiny",
                         {"length": 40, "sample_within": 2, "checked": 2}),
}


def shrink(config):
    """A configuration's widths and sizes cut for the CPU."""
    cfg = json.loads(json.dumps(config))
    if cfg["model"] == "vivim":
        cfg["segformer"].update(depths=[1, 1, 1, 1],
                                hidden_sizes=[8, 16, 24, 32],
                                num_attention_heads=[1, 2, 2, 4],
                                decoder_hidden_size=32)
        cfg.update(mamba_depths=[1, 1, 1, 1], image_size=64, clip_length=2)
    else:
        cfg.update(d_model=32, n_layer=2, vocab_size=50)
    return cfg


def make_root(path):
    """A benchmark root under ``path`` with the tiny cells; returns (root,
    here, bench)."""
    repo = os.path.dirname(harness.HERE)
    here = os.path.join(path, "perfbench")
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(harness.HERE, sub),
                        os.path.join(here, sub))
    bench = harness.load_json(os.path.join(repo, "BENCHMARK.json"))
    cells = {c["name"]: c for c in bench["workloads"]}
    cfgs = {c["name"]: c for c in bench["configs"]}
    for name, (real, cfg_name, changes) in TINY.items():
        cell = cells[real]
        if cfg_name not in cfgs:
            src = harness.load_json(os.path.join(repo, cfgs[cell["config"]][
                "file"]))
            rel = f"perfbench/configs/{cfg_name}.json"
            write(os.path.join(path, rel), shrink(src))
            cfgs[cfg_name] = dict(cfgs[cell["config"]], name=cfg_name,
                                  file=rel)
            bench["configs"].append(cfgs[cfg_name])
        traffic = harness.load_json(os.path.join(
            harness.HERE, "traffic", f"{cell['traffic']}.json"))
        write(os.path.join(here, "traffic", f"{name}.json"),
              dict(traffic, **changes))
        shutil.copy(os.path.join(harness.HERE, "limits", f"{real}.json"),
                    os.path.join(here, "limits", f"{name}.json"))
        bench["workloads"].append(dict(cell, name=name, config=cfg_name,
                                       traffic=name))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", []):
                m["workloads"].append(name)
    write(os.path.join(path, "BENCHMARK.json"), bench)
    return str(path), here, bench


def write(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def run(root, here, bench, name, seed=2 ** 31 + 7, seconds=0.3, trace=False):
    """One tiny run on the CPU: (result, checks)."""
    return harness.run_local(bench, name, root, here, seed, seconds, trace,
                             "cpu")
