"""Inference CLI: timed sliding-clip evaluation with metrics and plots.

Port of the JAX package's ``cli/infer.py``:
- sliding-clip test dataset over a gathered video tree, or (``--gathered
  false``) over a raw annotated tree indexed in place;
- weights from a port ``.pt`` (a state_dict or a trainer checkpoint), a
  trainer's checkpoint directory (its ``best_*`` file before its
  ``last_*`` one), or a reference Lightning ``.ckpt``; an orbax directory
  of the JAX package is converted first by ``scripts/orbax_to_torch.py``;
- the forward, argmax predictions, per-sample per-class confusion counts
  and the aggregated confusion matrix computed on the device as one call,
  captured once per batch shape as a CUDA graph and replayed
  (``utils/cuda_graphs.py``: the JAX CLI's jitted ``forward``); on the
  CPU it runs eagerly;
- each batch's copy into the graph and its replay timed (CUDA events,
  synchronised before each time is read; the first batch, which holds the
  capture, is excluded from the FPS as warm-up);
- ``metrics.json``, then the confusion-matrix heatmaps (where matplotlib
  imports) and prediction grids; with ``--wandb``, the same to wandb when
  it starts.

Usage:
  python -m vivim_tpu_torch.cli.infer --ckpt runs/exp/fold_0/ckpt \
      --data_dir test/
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
# raw, row-normalized, column-normalized
HEATMAPS = ("confusion_matrix", "confusion_matrix_row_norm",
            "confusion_matrix_col_norm")


def _flag(v):
    return str(v).lower() in ("1", "true")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Vivim inference (PyTorch/CUDA)")
    p.add_argument("--ckpt", type=str, required=True,
                   help="port .pt (state_dict or trainer checkpoint), a "
                        "trainer's ckpt directory, or a reference .ckpt")
    p.add_argument("--with_edge", type=_flag, default=False)
    p.add_argument("--num_classes", type=int, default=3)
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--clip_length", type=int, default=5)
    p.add_argument("--output_dir", type=str, default="results_multiclass")
    p.add_argument("--save_vis", type=_flag, default=False)
    p.add_argument("--vis_count", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--segformer", type=str, default="b3",
                   choices=["b0", "b3", "tiny"])
    p.add_argument("--wandb", type=_flag, default=False)
    p.add_argument("--gathered", type=_flag, default=True,
                   help="data_dir is already a gathered video tree")
    p.add_argument("--wandb_project", type=str,
                   default="vivim-tpu-inference")
    p.add_argument("--wandb_name", type=str, default="vivim_inference")
    p.add_argument("-cv_group", "--cv_group", type=str,
                   default="Vivim_Inference",
                   help="(reference compatibility; unused)")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def checkpoint_file(path):
    """The file ``--ckpt`` names: ``path`` itself, or in a trainer's
    checkpoint directory its ``best_*.pt`` before its ``last_*.pt``, the
    last name in sorted order (the JAX CLI's rule, by name: ``best_99``
    sorts after ``best_100``)."""
    if not os.path.isdir(path):
        return path
    subs = sorted(d for d in os.listdir(path)
                  if d.startswith(("best_", "last_")) and d.endswith(".pt"))
    if not subs:
        raise ValueError(
            f"{path} holds no best_*.pt or last_*.pt: an orbax checkpoint "
            "of the JAX package is read by JAX only. Convert it with "
            "scripts/orbax_to_torch.py and pass the .pt it writes")
    best = [d for d in subs if d.startswith("best_")]
    return os.path.join(path, (best or subs)[-1])


def load_model(args, device="cuda"):
    """Build the model and load ``args.ckpt`` (see ``checkpoint_file``)
    with strict key matching."""
    from vivim_tpu_torch.convert.from_jax import reference_state_dict
    from vivim_tpu_torch.train.checkpoints import load_params

    model, cfg = build_model(args, device)
    path = checkpoint_file(os.path.abspath(args.ckpt))
    model.load_state_dict(reference_state_dict(load_params(path)),
                          strict=True)
    return model, cfg


def prepare_test_data(args):
    from vivim_tpu_torch.data.dataset import ClipDataset
    from vivim_tpu_torch.data.gather import gather_multiclass_frames
    from vivim_tpu_torch.data.loader import DataLoader

    root = args.data_dir
    if not args.gathered:
        index = gather_multiclass_frames(root, copy=False)
        root = {v: [{"frame": r["frame"], "background": r["background"],
                     "solid": r.get("solid"), "non-solid": r.get("non-solid")}
                    for r in e] for v, e in index.items()}
    ds = ClipDataset(root, size=args.image_size,
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


def serving_forward(model, num_classes):
    """``forward(clip, masks)`` -> (uint8 predictions (B, T, H, W), (B*T,
    C, 4) confusion counts, (C, C) confusion matrix), all on the device:
    what the JAX CLI jits and what ``run_inference`` captures."""
    from vivim_tpu_torch.train.metrics import (
        confusion_matrix,
        per_class_confusion,
    )

    def forward(clip, masks):
        out = model(clip)
        logits = out[0] if isinstance(out, tuple) else out
        B, T, H, W, _ = logits.shape
        preds = logits.argmax(-1).reshape(B * T, H, W)
        targets = masks.argmax(-1).reshape(B * T, H, W)
        return (preds.reshape(B, T, H, W).to(torch.uint8),
                per_class_confusion(preds, targets, num_classes),
                confusion_matrix(preds, targets, num_classes))

    return forward


def run_inference(args, model, loader, device="cuda"):
    """Predict every batch of ``loader`` (dicts with channels-last numpy
    ``clip`` and ``masks``; ``loader.batch_size``) on ``device``, where the
    model must already be.  On the card each batch shape is captured once
    and replayed (a smaller last batch gets its own capture).  Returns
    (metrics, confusion matrix, perf)."""
    from vivim_tpu_torch.train.metrics import MulticlassMetricsTracker
    from vivim_tpu_torch.utils.cuda_graphs import GraphedCall

    dev = resolve_device(device)
    if next(model.parameters()).device != dev:
        raise ValueError(f"the model is not on {dev}")
    nc = args.num_classes
    forward = GraphedCall(serving_forward(model, nc), model)

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


def plot_confusion_matrices(cm, output_dir, wandb_run=None):
    """Raw / row-normalized / column-normalized heatmaps -> PNGs (and wandb
    Images with a run).  Where matplotlib cannot be imported it says which
    heatmaps it did not write."""
    from vivim_tpu_torch.train.logging import confusion_heatmap, pyplot

    plt = pyplot()
    if plt is None:
        print("[infer] matplotlib cannot be imported: not writing "
              + ", ".join(f"{n}.png" for n in HEATMAPS)
              + " (metrics.json holds the confusion matrix)")
        return
    cm = cm.astype(np.float64)
    mats = (cm, cm / np.maximum(cm.sum(1, keepdims=True), 1),
            cm / np.maximum(cm.sum(0, keepdims=True), 1))
    for name, mat in zip(HEATMAPS, mats):
        fig = confusion_heatmap(mat, CLASS_NAMES)
        fig.savefig(os.path.join(output_dir, f"{name}.png"))
        if wandb_run is not None:
            import wandb

            wandb_run.log({name: wandb.Image(fig)})
        plt.close(fig)


def main(argv=None):
    args = parse_args(argv)
    wandb_run = None
    if args.wandb:
        try:
            import wandb

            wandb_run = wandb.init(project=args.wandb_project,
                                   name=args.wandb_name)
        except Exception as e:  # no package, no network: carry on
            print(f"[infer] wandb unavailable ({e})")
    model, _ = load_model(args, args.device)
    _, loader = prepare_test_data(args)
    results, cm, perf = run_inference(args, model, loader, args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    summary = {
        "performance": perf,
        "metrics": results,
        "confusion_matrix": cm.tolist(),
    }
    # before the figures: a host without matplotlib keeps the metrics
    with open(os.path.join(args.output_dir, "metrics.json"), "w") as f:
        json.dump(summary, f, indent=2, default=str)
    plot_confusion_matrices(cm, args.output_dir, wandb_run=wandb_run)
    if wandb_run is not None:
        flat = dict(perf)
        for m in ("dice", "jaccard", "precision", "recall"):
            flat[f"{m}_mean"] = results[m]["mean"]
        wandb_run.log(flat)
        if args.save_vis:
            import wandb

            vis_files = sorted(
                f for f in os.listdir(args.output_dir)
                if f.startswith("vis_") and f.endswith(".png"))
            for f in vis_files[:args.vis_count]:
                wandb_run.log({f"predictions/{f[:-4]}": wandb.Image(
                    os.path.join(args.output_dir, f))})
        wandb_run.finish()
    print(json.dumps(perf, indent=2))
    for m in ("dice", "jaccard", "precision", "recall"):
        print(m, results[m]["mean"], results[m]["per_class"])
    return summary


if __name__ == "__main__":
    main()
