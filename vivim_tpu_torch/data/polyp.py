"""Polyp video-segmentation datasets (the upstream Vivim task).

Copy of the JAX package's ``data/polyp.py``, a re-design of the reference's
original_training_scripts_not_used/data_polyp.py (SalObjDataset :159-271,
SalObjTestDataset :277-345): the original polyp
pipeline the reference repo vendored and then superseded with the
ultrasound multiclass pipeline.  Layout differences vs the gathered
multiclass trees:

- ``{root}/Train/{video}/Frame/*.jpg`` images with sibling
  ``.../GT/*.png`` binary masks (path derived by Frame->GT, jpg->png,
  :184).
- Frames sort numerically by stem unless the video name contains
  "Kvasir" (lexical; :169-172).
- Clips are length-L windows CENTERED ON EVERY FRAME, edge-clamped
  (:173-183) — one clip per frame, unlike the multiclass non-overlapping
  windows.
- Augmentation (:121-141 ``augment``): per-frame colorEnhance with the
  polyp intensity ranges (brightness/contrast U{0.5..1.5}, color U{0..2},
  sharpness U{0..3}; :43-52), then clip-synchronized vertical flip p=.5
  (ImageOps.flip) and horizontal mirror p=.5 (ImageOps.mirror); pepper
  noise on masks (randomPeper, :66-83).
- Masks: bilinear resize then /255 — kept CONTINUOUS, not thresholded
  (gt_transform, :192-194).
- Edge maps: one-hot over {==0, ==1} (convert_mask, :145-157) -> per-class
  EDT band of radius 2, binarized (onehot_to_binary_edges, :227-238).

Tensors are channels-last numpy: clip (T, S, S, 3) ImageNet-normalized,
masks (T, S, S, 1) in [0, 1], edges (T, S, S, 1) in {0, 1}.
"""

from __future__ import annotations

import os
import random as _random

import numpy as np
from PIL import Image, ImageOps

from vivim_tpu_torch import native
from vivim_tpu_torch.data import augment as aug


def _sort_frames(names, video: str):
    if "Kvasir" in video:
        return sorted(names)
    return sorted(names, key=lambda x: int(os.path.splitext(x)[0]))


def centered_windows(n_frames: int, clip_len: int):
    """One edge-clamped centered window per frame (data_polyp.py:173-183:
    ``ii in range(-clip_len//2+1, clip_len//2+1)``).  Python's floor
    division makes ``-clip_len//2`` equal -(clip_len+1)//2, so odd lengths
    center exactly (offsets -2..2 at 5) while even lengths lean one frame
    FORWARD (offsets -1..2 at 4) — reproduced exactly."""
    lo = (-clip_len) // 2 + 1
    hi = clip_len // 2 + 1
    return [[min(max(i + ii, 0), n_frames - 1) for ii in range(lo, hi)]
            for i in range(n_frames)]


def _polyp_color_enhance(img, rng):
    """colorEnhance with the polyp ranges (data_polyp.py:43-52)."""
    factors = (rng.randint(5, 15) / 10.0, rng.randint(5, 15) / 10.0,
               rng.randint(0, 20) / 10.0, rng.randint(0, 30) / 10.0)
    out = native.color_enhance(np.asarray(img, np.uint8), *factors)
    if out is not None:
        return Image.fromarray(out)
    from PIL import ImageEnhance

    for enh, f in zip((ImageEnhance.Brightness, ImageEnhance.Contrast,
                       ImageEnhance.Color, ImageEnhance.Sharpness), factors):
        img = enh(img).enhance(f)
    return img


def _random_peper(arr, rng):
    """Pepper/salt noise on a mask array (data_polyp.py:66-83)."""
    n = int(0.0015 * arr.shape[0] * arr.shape[1])
    for _ in range(n):
        x = rng.randint(0, arr.shape[0] - 1)
        y = rng.randint(0, arr.shape[1] - 1)
        arr[x, y] = 0 if rng.randint(0, 1) == 0 else 255
    return arr


def _edge_from_mask(m01: np.ndarray) -> np.ndarray:
    """convert_mask(gt, 1) -> onehot_to_binary_edges(radius=2, classes=2)
    (data_polyp.py:145-157, :227-238): band around the boundaries of the
    exact-0 and exact-1 level sets of the continuous mask."""
    chans = np.stack([(m01 == 0.0), (m01 == 1.0)]).astype(np.uint8)
    band = native.edge_band(chans, 2.0)
    return (band > 0).astype(np.float32)[:, :, None]


class PolypDataset:
    """Training dataset over ``{root}/Train/{video}/Frame`` trees."""

    split_dir = "Train"

    def __init__(self, root, size, clip_len=5, augment=True, seed=42):
        self.root = root
        self.size = size
        self.clip_len = clip_len
        self.augment = augment
        self.seed = seed
        self.epoch = 0
        self.samples = []  # (frame_paths, gt_paths)
        self._scan()

    def _scan(self):
        base = os.path.join(self.root, self.split_dir)
        for vid in (sorted(os.listdir(base)) if os.path.isdir(base) else ()):
            fdir = os.path.join(base, vid, "Frame")
            if os.path.isdir(fdir):
                self._add_video(vid, fdir)

    def _add_video(self, vid: str, fdir: str):
        frames = _sort_frames(
            [f for f in os.listdir(fdir)
             if f.lower().endswith((".jpg", ".jpeg", ".png"))], vid)
        paths = [os.path.join(fdir, f) for f in frames]
        gts = [p.replace(f"{os.sep}Frame{os.sep}", f"{os.sep}GT{os.sep}")
               .rsplit(".", 1)[0] + ".png" for p in paths]
        for w in centered_windows(len(paths), self.clip_len):
            self.samples.append(([paths[i] for i in w],
                                 [gts[i] for i in w]))

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.samples)

    def load_clip(self, idx: int, rng: _random.Random | None = None):
        rng = rng or _random.Random(
            self.seed * 1_000_003 + idx * 31 + self.epoch)
        frame_paths, gt_paths = self.samples[idx]
        imgs = [Image.open(p).convert("RGB") for p in frame_paths]
        gts = [Image.open(p).convert("L") for p in gt_paths]
        if self.augment:
            imgs = [_polyp_color_enhance(im, rng) for im in imgs]
            if rng.random() < 0.5:  # vertical flip (ImageOps.flip)
                imgs = [ImageOps.flip(im) for im in imgs]
                gts = [ImageOps.flip(g) for g in gts]
            if rng.random() < 0.5:  # horizontal mirror
                imgs = [ImageOps.mirror(im) for im in imgs]
                gts = [ImageOps.mirror(g) for g in gts]
        S = self.size
        clip = np.stack([
            native.resize_bilinear_normalize(
                np.asarray(im, np.uint8), S, S,
                aug.IMAGENET_MEAN, aug.IMAGENET_STD) for im in imgs])
        masks, edges = [], []
        for g in gts:
            arr = np.asarray(g, np.uint8).copy()
            if self.augment:
                arr = _random_peper(arr, rng)
            # PIL bilinear resize then /255 — continuous, unthresholded
            m = np.asarray(
                Image.fromarray(arr).resize((S, S), Image.BILINEAR),
                np.float32) / 255.0
            masks.append(m[:, :, None])
            edges.append(_edge_from_mask(m))
        return {
            "clip": clip.astype(np.float32),
            "masks": np.stack(masks).astype(np.float32),
            "edges": np.stack(edges).astype(np.float32),
            "paths": tuple(frame_paths),
        }


class PolypTestDataset(PolypDataset):
    """Eval dataset (SalObjTestDataset, data_polyp.py:277-345): no
    augmentation, masks and edges still produced for metric computation.
    Accepted layouts:

    - ``{root}/Frame/{video}/*.jpg`` — the reference's test layout
      (CVC-ClinicDB-612-Test; video dirs INSIDE Frame, sorted numerically,
      data_polyp.py:280-290)
    - ``{root}/Frame/*.jpg`` — a single flat video
    - ``{root}/{video}/Frame/*.jpg`` — train-style tree without Train/
    """

    def __init__(self, root, size, clip_len=5, seed=42):
        super().__init__(root, size, clip_len, augment=False, seed=seed)

    def _scan(self):
        root = self.root
        fdir = os.path.join(root, "Frame")
        if os.path.isdir(fdir):
            vids = [v for v in os.listdir(fdir)
                    if os.path.isdir(os.path.join(fdir, v))]
            if vids:
                # reference layout: videos inside Frame, numeric sort
                # (data_polyp.py:282 ``sorted(vid_list, key=int)``)
                try:
                    vids = sorted(vids, key=int)
                except ValueError:
                    vids = sorted(vids)
                for vid in vids:
                    self._add_video(vid, os.path.join(fdir, vid))
            else:
                self._add_video(os.path.basename(root.rstrip(os.sep)), fdir)
            return
        for vid in sorted(os.listdir(root)):
            vdir = os.path.join(root, vid, "Frame")
            if os.path.isdir(vdir):
                self._add_video(vid, vdir)
