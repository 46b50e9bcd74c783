"""OTU_2D single-image dataset (the optional binary pretraining corpus).

Copy of the JAX package's ``data/otu.py`` (the reference's
complements/OTU_dataset.py:164-254): pairs of ``{root}/images/*.jpg`` and
``{root}/annotations/{name}.PNG`` loaded as clips of one frame, images
bilinear-resized and ImageNet-normalized, masks NEAREST-resized and
binarized, plus radius-2 edge maps.  The output is ClipDataset's dict, so
the binary trainer takes either source.
"""

from __future__ import annotations

import glob
import os
import random as _random

import numpy as np
from PIL import Image

from vivim_tpu_torch.data import augment as aug
from vivim_tpu_torch.data.dataset import _edge_map


class OTUDataset:
    def __init__(self, root, size, augment="medium", seed=42,
                 with_edges=True):
        self.images = sorted(
            glob.glob(os.path.join(root, "images", "*.[jJ][pP][gG]")))
        self.masks_dir = os.path.join(root, "annotations")
        self.size = size
        self.augment = augment or "none"
        self.seed = seed
        self.with_edges = with_edges
        if not self.images:
            raise ValueError(f"no images under {root}/images")

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return len(self.images)

    def load_clip(self, idx, rng=None):
        rng = rng or _random.Random(self.seed + idx)
        path = self.images[idx]
        name = os.path.splitext(os.path.basename(path))[0]
        mask_path = os.path.join(self.masks_dir, name + ".PNG")
        if not os.path.exists(mask_path):
            mask_path = os.path.join(self.masks_dir, name + ".png")
        img = Image.open(path).convert("RGB")
        mask = Image.open(mask_path).convert("L")
        if self.augment != "none":
            img, (mask,) = aug.apply_augmentation(img, [mask], self.augment,
                                                  rng)
        S = self.size
        clip = aug.normalize_image(
            np.asarray(img.resize((S, S), Image.BILINEAR), np.float32)
            / 255.0)[None]
        m = np.asarray(mask.resize((S, S), Image.NEAREST), np.float32)
        m = (m > 0).astype(np.float32)[None, :, :, None]  # (1, S, S, 1)
        out = {"clip": clip.astype(np.float32), "masks": m,
               "paths": (path,)}
        if self.with_edges:
            out["edges"] = _edge_map(
                (m[0] > 0.5).astype(np.uint8))[None]
        return out
