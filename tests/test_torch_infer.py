"""Inference path of the PyTorch port: ``run_inference`` against the JAX
package's on the same synthetic batches and weights, ``main`` end to end on
a gathered synthetic tree (as tests/test_infer_cli.py does for the JAX
CLI), and checkpoint loading."""

import argparse
import json
import os

import numpy as np
import pytest
import torch

from tests.data_fixtures import make_gathered_tree
from vivim_tpu.cli import infer as jinfer
from vivim_tpu.convert.torch_to_jax import vivim_params_from_torch
from vivim_tpu.nn.vivim import Vivim as JVivim
from vivim_tpu.nn.vivim import VivimConfig as JConfig
from vivim_tpu_torch.cli import infer
from vivim_tpu_torch.cli.common import build_model

torch.set_num_threads(1)


class _Batches:
    def __init__(self, batches):
        self.batches = batches
        self.batch_size = batches[0]["clip"].shape[0]

    def __iter__(self):
        return iter(self.batches)


def _batches(n, T=3, S=48, C=3, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        labels = rng.integers(0, C, (1, T, S, S))
        out.append({
            "clip": rng.standard_normal((1, T, S, S, 3)).astype(np.float32),
            "masks": np.eye(C, dtype=np.float32)[labels]})
    return out


def _args(tmp_path, **kw):
    base = dict(segformer="tiny", num_classes=3, with_edge=False,
                clip_length=3, image_size=48, output_dir=str(tmp_path),
                save_vis=False, vis_count=0)
    base.update(kw)
    return argparse.Namespace(**base)


def test_run_inference_matches_jax(tmp_path):
    """Same weights and batches: confusion matrices agree on >= 99.9 % of
    pixels (an argmax near a tie may flip), frame counts exactly."""
    args = _args(tmp_path)
    model, _ = build_model(args, device="cpu", seed=1)
    loader = _Batches(_batches(3))
    res, cm, perf = infer.run_inference(args, model, loader, device="cpu")

    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    jcfg = JConfig.tiny_test(scan_implementation=None)
    variables = vivim_params_from_torch(sd, jcfg)
    jres, jcm, jperf = jinfer.run_inference(args, JVivim(jcfg), variables,
                                            loader)
    total = 3 * 3 * 48 * 48
    assert cm.sum() == jcm.sum() == total
    assert perf["total_frames"] == jperf["total_frames"] == 9
    agree = 1.0 - np.abs(cm - jcm).sum() / (2.0 * total)
    assert agree >= 0.999, (cm, jcm)
    assert res["class_counts"] == jres["class_counts"]
    for m in ("dice", "jaccard", "precision", "recall"):
        np.testing.assert_allclose(res[m]["mean"], jres[m]["mean"],
                                   atol=1e-3)


def test_infer_main_end_to_end(tmp_path):
    data_dir = tmp_path / "test_tree"
    make_gathered_tree(str(data_dir), n_videos=2, n_frames=6, size=48)
    model, _ = build_model(_args(tmp_path), device="cpu")
    ckpt = tmp_path / "vivim_tiny.pt"
    torch.save(model.state_dict(), ckpt)
    out_dir = tmp_path / "results"
    summary = infer.main([
        "--ckpt", str(ckpt), "--data_dir", str(data_dir),
        "--image_size", "48", "--clip_length", "3", "--segformer", "tiny",
        "--output_dir", str(out_dir), "--save_vis", "true",
        "--vis_count", "2", "--device", "cpu"])
    on_disk = json.load(open(out_dir / "metrics.json"))
    assert on_disk["confusion_matrix"] == summary["confusion_matrix"]
    assert on_disk["performance"]["total_frames"] == 12  # 2 vids x 2 clips x 3
    assert on_disk["performance"]["device"] == "cpu"
    cm = np.array(on_disk["confusion_matrix"])
    assert cm.shape == (3, 3) and cm.sum() == 12 * 48 * 48
    for m in ("dice", "jaccard", "precision", "recall"):
        assert np.isfinite(on_disk["metrics"][m]["mean"])
    pngs = [f for f in os.listdir(out_dir) if f.endswith(".png")]
    assert sum(f.startswith("confusion") for f in pngs) == 3
    assert any(f.startswith("vis_") for f in pngs)


def test_load_model_reads_reference_ckpt_and_refuses_orbax(tmp_path):
    """A Lightning-style .ckpt (``model.`` prefix, the unused
    ``decoder.classifier``) loads strictly; a directory (orbax) raises."""
    args = _args(tmp_path, ckpt=str(tmp_path / "ref.ckpt"))
    src, _ = build_model(args, device="cpu", seed=7)
    sd = {f"model.{k}": v for k, v in src.state_dict().items()}
    sd["model.decoder.classifier.weight"] = torch.zeros(3, 32, 1, 1)
    torch.save({"state_dict": sd, "epoch": 3}, args.ckpt)
    model, _ = infer.load_model(args, device="cpu")
    for k, v in src.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    args.ckpt = str(tmp_path)
    with pytest.raises(ValueError, match="orbax"):
        infer.load_model(args, device="cpu")
