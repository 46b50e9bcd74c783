"""Dataloader sanity checker.

Port of the JAX package's ``cli/check_data.py`` (the reference's manual
scripts complements/check_dataloader.py:38-74 and Check_multiclass.py:13-64):
prints tensor shapes, value ranges and unique mask values for a few
batches, and writes a frame / mask / edge alignment figure where
matplotlib imports (where it does not, it says so and writes none).

Usage:
  python -m vivim_tpu_torch.cli.check_data <gathered_tree> [--image_size 256]
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("root")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--clip_length", type=int, default=3)
    p.add_argument("--batches", type=int, default=2)
    p.add_argument("--out", type=str, default="data_check.png")
    p.add_argument("--binary", action="store_true")
    args = p.parse_args(argv)

    from vivim_tpu_torch.data.dataset import MULTICLASS_KEYS, ClipDataset
    from vivim_tpu_torch.data.loader import DataLoader

    keys = ("background",) if args.binary else MULTICLASS_KEYS
    ds = ClipDataset(args.root, args.image_size, args.clip_length,
                     augment="medium", mask_keys=keys,
                     invert_background=args.binary)
    dl = DataLoader(ds, batch_size=2, num_workers=0, drop_last=False)
    print(f"dataset: {len(ds)} clips from {len(ds.videos)} videos")
    plotted = None
    for i, batch in enumerate(dl):
        if i >= args.batches:
            break
        clip, masks, edges = batch["clip"], batch["masks"], batch["edges"]
        print(f"batch {i}: clip {clip.shape} {clip.dtype} "
              f"range [{clip.min():.3f}, {clip.max():.3f}]")
        print(f"  masks {masks.shape} unique {np.unique(masks)[:6]} "
              f"per-channel sums {masks.sum(axis=(0, 1, 2, 3))}")
        print(f"  edges {edges.shape} range [{edges.min()}, {edges.max()}]")
        if i == 0:
            plotted = _plot(args, batch)
    if plotted is False:
        print(f"matplotlib cannot be imported: not writing the alignment "
              f"figure {args.out}")
    else:
        print(f"alignment figure -> {args.out}")


def _plot(args, batch):
    """The alignment figure of the batch's first clip; False where
    matplotlib cannot be imported."""
    from vivim_tpu_torch.data.augment import denormalize_image
    from vivim_tpu_torch.train.logging import pyplot

    plt = pyplot()
    if plt is None:
        return False
    T = batch["clip"].shape[1]
    fig, axes = plt.subplots(3, T, figsize=(3 * T, 9), squeeze=False)
    for t in range(T):
        img = np.clip(denormalize_image(batch["clip"][0, t]), 0, 1)
        axes[0][t].imshow(img)
        axes[0][t].set_title(f"frame {t}")
        axes[1][t].imshow(batch["masks"][0, t].argmax(-1), cmap="viridis")
        axes[1][t].set_title("mask argmax")
        axes[2][t].imshow(batch["edges"][0, t, :, :, 0], cmap="gray")
        axes[2][t].set_title("edges")
        for r in range(3):
            axes[r][t].axis("off")
    fig.tight_layout()
    fig.savefig(args.out)
    plt.close(fig)
    return True


if __name__ == "__main__":
    main()
