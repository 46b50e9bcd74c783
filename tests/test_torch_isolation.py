"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, names the JAX package nowhere in its code or in chip_smoke.py,
and its entry points refuse to run on a missing GPU."""

import argparse
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "vivim_tpu_torch"
# the JAX package's name, but not the port's own
JAX_PACKAGE = re.compile(r"\bvivim_tpu\b(?!_torch)")


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'orbax', 'vivim_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr


def test_no_line_names_the_jax_package():
    files = [p for p in PKG.rglob("*") if p.suffix in (".py", ".cu", ".cc")]
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    hits = [f"{p.relative_to(ROOT)}:{i}: {line.strip()}"
            for p in files
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if JAX_PACKAGE.search(line)]
    assert not hits, "\n".join(hits)


def test_entry_points_need_cuda_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    from vivim_tpu_torch.cli import infer
    from vivim_tpu_torch.cli.common import build_model

    args = argparse.Namespace(segformer="tiny", num_classes=3,
                              with_edge=False, ckpt=str(tmp_path / "x.pt"),
                              clip_length=3, output_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        infer.load_model(args)
    model, _ = build_model(args, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        infer.run_inference(args, model, [])
    assert infer.parse_args(["--ckpt", "x", "--data_dir", "y"]).device \
        == "cuda"
    from vivim_tpu_torch.cli import (
        train_binary,
        train_final,
        train_folds,
        train_polyp,
    )

    for cli in (train_folds, train_final, train_binary, train_polyp):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["-data_path", str(tmp_path), "-segformer", "tiny"])
    from vivim_tpu_torch.cli import bench_generation, lm_eval_harness

    tiny = ["--vocab", "50", "--d_model", "16", "--n_layer", "1",
            "--promptlen", "3", "--genlen", "2", "--repeats", "1"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_generation.main(tiny)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm_eval_harness.load_lm(None, 50, 16, 1)
    bench_generation.main(tiny + ["--device", "cpu"])
    model, _ = lm_eval_harness.load_lm(None, 50, 16, 1, device="cpu")
    assert next(model.parameters()).device.type == "cpu"


def test_trainer_needs_cuda_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    from vivim_tpu_torch.nn.layers import init_weights
    from vivim_tpu_torch.nn.vivim import Vivim, VivimConfig
    from vivim_tpu_torch.train.logging import MetricLogger
    from vivim_tpu_torch.train.trainer import Trainer, TrainerConfig

    assert TrainerConfig().device == "cuda"
    model = init_weights(Vivim(VivimConfig.micro_test()),
                         torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(model, TrainerConfig(), [None], [], str(tmp_path / "c"),
                MetricLogger(str(tmp_path / "l")))
