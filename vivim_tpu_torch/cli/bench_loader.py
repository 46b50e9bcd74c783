"""Input-pipeline throughput benchmark: the host loader alone.

Port of the JAX package's ``cli/bench_loader.py`` over the port's loader
and native host ops.  It measures whether the host pipeline (PNG decode ->
augmentation -> native C++ resize + normalize -> EDT edge bands -> collate)
sustains the frame rate the training step consumes:

    required frames/s = train clips/s * clip_length

``measure_loader`` runs the production ``DataLoader`` over a gathered tree
(a synthetic one when none is given) after a warm-up epoch.  A host with
fewer cores than loader threads measures contention, not scaling, so
``--per_stage`` also times each stage in one thread: every stage releases
the GIL (PIL decode, the native ops, numpy), so the one-thread rate bounds
an N-core host at about N times it until memory bandwidth interferes.

Usage:
    python -m vivim_tpu_torch.cli.bench_loader [--data_root DIR]
        [--image_size 256] [--clip_length 5] [--batch_size 3]
        [--num_workers 1] [--epochs 2] [--per_stage]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np


def make_synthetic_tree(root: str, n_videos: int = 6, n_frames: int = 40,
                        size: int = 512, seed: int = 0) -> None:
    """Write a gathered-layout tree: <root>/<video>/NNNN_{frame,background,
    solid,non-solid}.png (data/gather.py output layout)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for v in range(n_videos):
        vdir = os.path.join(root, f"video_{v:02d}")
        os.makedirs(vdir, exist_ok=True)
        for f in range(n_frames):
            img = rng.integers(0, 255, (size, size, 3), np.uint8)
            Image.fromarray(img).save(
                os.path.join(vdir, f"{f:04d}_frame.png"))
            yy, xx = np.mgrid[:size, :size]
            cy, cx = rng.integers(size // 4, 3 * size // 4, 2)
            r = size // 6
            blob = ((yy - cy) ** 2 + (xx - cx) ** 2 < r * r)
            m = (blob * 255).astype(np.uint8)
            Image.fromarray(255 - m).save(
                os.path.join(vdir, f"{f:04d}_background.png"))
            Image.fromarray(m).save(
                os.path.join(vdir, f"{f:04d}_solid.png"))


def measure_loader(data_root=None, image_size=256, clip_length=5,
                   batch_size=3, num_workers=1, epochs=1, augment="medium",
                   with_edges=True, n_videos=6, n_frames=40,
                   cache_decoded=False, pre_resize=False):
    """The ONE loader measurement: production DataLoader over a gathered
    tree (synthetic 6-video x 40-frame when ``data_root`` is None), with a
    warmup epoch (thread spin-up + native lib build + page cache).

    Returns a dict with frames/s and the per-worker rate.
    """
    from vivim_tpu_torch.data.dataset import ClipDataset
    from vivim_tpu_torch.data.loader import DataLoader

    tmp = None
    root = data_root
    if root is None:
        tmp = tempfile.TemporaryDirectory(prefix="vivim_loader_bench_")
        root = tmp.name
        make_synthetic_tree(root, n_videos=n_videos, n_frames=n_frames)
    try:
        ds = ClipDataset(root, size=image_size, clip_len=clip_length,
                         augment=augment, with_edges=with_edges,
                         cache_decoded=cache_decoded, pre_resize=pre_resize)
        loader = DataLoader(ds, batch_size, shuffle=True,
                            num_workers=num_workers)
        frames = 0
        # warmup epoch (also fills the decode cache when enabled, so the
        # measured epochs report the steady-state warm rate)
        for batch in loader:
            frames += batch["clip"].shape[0] * batch["clip"].shape[1]
        t0 = time.time()
        frames = 0
        for ep in range(epochs):
            loader.set_epoch(ep + 1)
            for batch in loader:
                frames += batch["clip"].shape[0] * batch["clip"].shape[1]
        dt = time.time() - t0
    finally:
        if tmp is not None:
            tmp.cleanup()
    fps = frames / dt
    return {
        "frames_per_sec": round(fps, 1),
        "frames": frames,
        "seconds": round(dt, 2),
        "num_workers": num_workers,
        "host_cpus": os.cpu_count() or 1,
        # per WORKER-thread rate.  On a host with >= num_workers cores the
        # stages release the GIL and scale ~linearly; on fewer cores the
        # workers contend and this is NOT a per-core rate (measure with
        # num_workers=1 there — see --per_stage for the derivation).
        "frames_per_sec_per_worker": round(fps / max(num_workers, 1), 1),
        "cache_decoded": cache_decoded,
        "pre_resize": pre_resize,
    }


def measure_stages(data_root=None, image_size=256, clip_length=5,
                   augment="medium", n_clips=6):
    """Single-thread per-stage costs (ms per frame): PNG decode, augment,
    native resize+normalize, mask resize, EDT edge band — so the core count
    needed for a target frame rate is derivable instead of asserted."""
    import random

    from PIL import Image

    from vivim_tpu_torch import native
    from vivim_tpu_torch.data import augment as aug
    from vivim_tpu_torch.data.dataset import ClipDataset, _edge_map

    tmp = None
    root = data_root
    if root is None:
        tmp = tempfile.TemporaryDirectory(prefix="vivim_stage_bench_")
        root = tmp.name
        make_synthetic_tree(root)
    try:
        ds = ClipDataset(root, size=image_size, clip_len=clip_length,
                         augment=augment, with_edges=True)
        ds.load_clip(0)  # warm the native lib + page cache
        S = image_size
        stages = {k: 0.0 for k in (
            "decode_png", "augment", "img_resize_normalize", "mask_resize",
            "edge_band_edt", "total_load_clip")}
        n_frames = 0
        for idx in range(min(n_clips, len(ds))):
            rec = ds.samples[idx]
            rng = random.Random(1234 + idx)
            for entry in rec.frames:
                n_frames += 1
                t0 = time.perf_counter()
                img = Image.open(entry["frame"]).convert("RGB")
                masks = []
                for key in ds.mask_keys:
                    mp = entry.get(key)
                    m = (Image.open(mp).convert("L") if mp
                         else Image.new("L", img.size, 0))
                    masks.append(m)
                t1 = time.perf_counter()
                img, masks = aug.apply_augmentation(img, masks, augment, rng)
                t2 = time.perf_counter()
                native.resize_bilinear_normalize(
                    np.asarray(img, np.uint8), S, S,
                    aug.IMAGENET_MEAN, aug.IMAGENET_STD)
                t3 = time.perf_counter()
                chans = [
                    native.resize_nearest(
                        np.asarray(m, np.uint8), S, S).astype(np.float32)
                    / 255.0 for m in masks]
                onehot = np.stack(chans, axis=-1)
                t4 = time.perf_counter()
                _edge_map((onehot > 0.5).astype(np.uint8))
                t5 = time.perf_counter()
                stages["decode_png"] += t1 - t0
                stages["augment"] += t2 - t1
                stages["img_resize_normalize"] += t3 - t2
                stages["mask_resize"] += t4 - t3
                stages["edge_band_edt"] += t5 - t4
        # end-to-end via the production path for the same clips
        t0 = time.perf_counter()
        for idx in range(min(n_clips, len(ds))):
            ds.load_clip(idx)
        stages["total_load_clip"] = time.perf_counter() - t0
    finally:
        if tmp is not None:
            tmp.cleanup()
    out = {f"{k}_ms_per_frame": round(v / max(n_frames, 1) * 1e3, 2)
           for k, v in stages.items()}
    out["frames_measured"] = n_frames
    total_s = stages["total_load_clip"] / max(n_frames, 1)
    out["single_thread_frames_per_sec"] = round(1.0 / max(total_s, 1e-9), 1)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", default=None,
                    help="gathered frame tree; synthetic when omitted")
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--clip_length", type=int, default=5)
    ap.add_argument("--batch_size", type=int, default=3)
    ap.add_argument("--num_workers", type=int, default=1)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--augment", default="medium")
    ap.add_argument("--no_edges", action="store_true")
    ap.add_argument("--per_stage", action="store_true",
                    help="also print single-thread per-stage costs")
    ap.add_argument("--cache_decoded", action="store_true",
                    help="enable the host decode cache (-cache_decoded on "
                         "the trainers): the warmup epoch fills it, so the "
                         "measured epochs report the steady-state warm rate")
    ap.add_argument("--pre_resize", action="store_true",
                    help="resize to --image_size at decode time, before "
                         "augmentation (-pre_resize on the trainers)")
    args = ap.parse_args(argv)

    res = measure_loader(
        args.data_root, args.image_size, args.clip_length, args.batch_size,
        args.num_workers, args.epochs, args.augment, not args.no_edges,
        cache_decoded=args.cache_decoded, pre_resize=args.pre_resize)
    res = {
        "metric": f"loader_frames_per_sec_{args.image_size}px_"
                  f"aug_{args.augment}_edges{int(not args.no_edges)}",
        "value": res.pop("frames_per_sec"),
        "unit": "frames/sec",
        **res,
    }
    if args.per_stage:
        res["per_stage"] = measure_stages(
            args.data_root, args.image_size, args.clip_length, args.augment)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
