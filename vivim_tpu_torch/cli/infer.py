"""Inference CLI: timed sliding-clip evaluation with metrics and plots.

Port of the JAX package's ``cli/infer.py``:
- sliding-clip test dataset over a gathered video tree;
- weights from a port ``.pt`` or a reference Lightning ``.ckpt``;
- timed forward per batch (CUDA events, synchronised before each time is
  read; the first batch is excluded from the FPS as warm-up);
- argmax predictions, per-sample per-class confusion counts and the
  aggregated confusion matrix computed on the device;
- confusion-matrix heatmaps, prediction grids and ``metrics.json``.

Usage:
  python -m vivim_tpu_torch.cli.infer --ckpt vivim.pt --data_dir test/
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from vivim_tpu_torch.cli.common import build_model, resolve_device

CLASS_COLORS = np.array([[0, 0, 0], [255, 0, 0], [255, 255, 0]], np.uint8)
CLASS_NAMES = ["background", "solid", "non-solid"]


def _flag(v):
    return str(v).lower() in ("1", "true")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Vivim inference (PyTorch/CUDA)")
    p.add_argument("--ckpt", type=str, required=True,
                   help="port .pt state_dict or reference Lightning .ckpt")
    p.add_argument("--with_edge", type=_flag, default=False)
    p.add_argument("--num_classes", type=int, default=3)
    p.add_argument("--data_dir", type=str, required=True,
                   help="gathered video tree")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--clip_length", type=int, default=5)
    p.add_argument("--output_dir", type=str, default="results_multiclass")
    p.add_argument("--save_vis", type=_flag, default=False)
    p.add_argument("--vis_count", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--segformer", type=str, default="b3",
                   choices=["b0", "b3", "tiny"])
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def load_model(args, device="cuda"):
    """Build the model and load ``args.ckpt`` (a port ``.pt`` or a
    reference ``.ckpt``) with strict key matching."""
    from vivim_tpu_torch.convert.from_jax import load_reference_state_dict

    model, cfg = build_model(args, device)
    path = os.path.abspath(args.ckpt)
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: orbax checkpoints are JAX-only. Convert "
            "its variables with vivim_tpu_torch.convert.from_jax."
            "vivim_state_dict_from_jax and torch.save the state_dict")
    model.load_state_dict(load_reference_state_dict(path), strict=True)
    return model, cfg


def prepare_test_data(args):
    from vivim_tpu_torch.data.dataset import ClipDataset
    from vivim_tpu_torch.data.loader import DataLoader

    ds = ClipDataset(args.data_dir, size=args.image_size,
                     clip_len=args.clip_length, augment="none",
                     with_edges=False)
    dl = DataLoader(ds, args.batch_size, shuffle=False, num_workers=2,
                    drop_last=False)
    return ds, dl


def _timed(dev, fn):
    """fn() and its seconds; on CUDA timed with events and synchronised."""
    if dev.type == "cuda":
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        e1.synchronize()
        return out, e0.elapsed_time(e1) / 1e3
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def run_inference(args, model, loader, device="cuda"):
    """Predict every batch of ``loader`` (dicts with channels-last numpy
    ``clip`` and ``masks``; ``loader.batch_size``) on ``device``, where the
    model must already be.  Returns (metrics, confusion matrix, perf)."""
    from vivim_tpu_torch.train.metrics import (
        MulticlassMetricsTracker,
        confusion_matrix,
        per_class_confusion,
    )

    dev = resolve_device(device)
    if next(model.parameters()).device != dev:
        raise ValueError(f"the model is not on {dev}")
    nc = args.num_classes

    def forward(clip, masks):
        out = model(clip)
        logits = out[0] if isinstance(out, tuple) else out
        B, T, H, W, _ = logits.shape
        preds = logits.argmax(-1).reshape(B * T, H, W)
        targets = masks.argmax(-1).reshape(B * T, H, W)
        return (preds.reshape(B, T, H, W).to(torch.uint8),
                per_class_confusion(preds, targets, nc),
                confusion_matrix(preds, targets, nc))

    tracker = MulticlassMetricsTracker(nc)
    cm = np.zeros((nc, nc), np.int64)
    batch_times = []
    total_frames = 0
    vis_saved = 0
    os.makedirs(args.output_dir, exist_ok=True)
    with torch.inference_mode():
        for batch in loader:
            clip = torch.from_numpy(batch["clip"]).to(dev)
            masks = torch.from_numpy(batch["masks"]).to(dev)
            (preds, conf, cm_b), secs = _timed(
                dev, lambda: forward(clip, masks))
            batch_times.append(secs)
            total_frames += clip.shape[0] * clip.shape[1]
            tracker.update_from_confusion(conf.cpu().numpy())
            cm += cm_b.cpu().numpy().astype(np.int64)
            if args.save_vis and vis_saved < args.vis_count:
                vis_saved += _save_vis(args, batch, preds.cpu().numpy(),
                                       vis_saved)

    # first batch excluded as warm-up
    times = batch_times[1:] or batch_times
    total_time = sum(times)
    frames_timed = total_frames - (loader.batch_size * args.clip_length
                                   if len(batch_times) > 1 else 0)
    perf = {
        "fps": frames_timed / total_time if total_time > 0 else 0.0,
        "total_frames": int(total_frames),
        "total_time_sec": total_time,
        "avg_batch_time": float(np.mean(times)),
        "min_batch_time": float(np.min(times)),
        "max_batch_time": float(np.max(times)),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    return tracker.get_results(), cm, perf


def _save_vis(args, batch, preds, start_idx):
    """Prediction grids: input | GT overlay | prediction overlay."""
    from PIL import Image

    from vivim_tpu_torch.data.augment import denormalize_image

    B, T = preds.shape[:2]
    for b in range(B):
        t = T // 2
        img = denormalize_image(batch["clip"][b, t])
        img = np.clip(img * 255, 0, 255).astype(np.uint8)
        gt = batch["masks"][b, t].argmax(-1).astype(int)
        pr = preds[b, t].astype(int)
        row = np.concatenate(
            [img, CLASS_COLORS[gt], CLASS_COLORS[pr]], axis=1)
        Image.fromarray(row).save(os.path.join(
            args.output_dir, f"vis_{start_idx + b:04d}.png"))
    return B


def plot_confusion_matrices(cm, output_dir):
    """Raw / row-normalized / column-normalized heatmaps -> PNGs."""
    import matplotlib.pyplot as plt

    from vivim_tpu_torch.train.logging import confusion_heatmap

    cm = cm.astype(np.float64)
    variants = {
        "confusion_matrix": cm,
        "confusion_matrix_row_norm":
            cm / np.maximum(cm.sum(1, keepdims=True), 1),
        "confusion_matrix_col_norm":
            cm / np.maximum(cm.sum(0, keepdims=True), 1),
    }
    for name, mat in variants.items():
        fig = confusion_heatmap(mat, CLASS_NAMES)
        fig.savefig(os.path.join(output_dir, f"{name}.png"))
        plt.close(fig)


def main(argv=None):
    args = parse_args(argv)
    model, _ = load_model(args, args.device)
    _, loader = prepare_test_data(args)
    results, cm, perf = run_inference(args, model, loader, args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    plot_confusion_matrices(cm, args.output_dir)
    summary = {
        "performance": perf,
        "metrics": results,
        "confusion_matrix": cm.tolist(),
    }
    with open(os.path.join(args.output_dir, "metrics.json"), "w") as f:
        json.dump(summary, f, indent=2, default=str)
    print(json.dumps(perf, indent=2))
    for m in ("dice", "jaccard", "precision", "recall"):
        print(m, results[m]["mean"], results[m]["per_class"])
    return summary


if __name__ == "__main__":
    main()
