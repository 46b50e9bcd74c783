"""Clip dataset over a gathered video tree, eval subset (host numpy).

Copy of the eval path of the JAX package's ``data/dataset.py`` (no augmentation,
no edge maps):
- videos are directories of ``{idx}_frame.png`` files with sibling masks
  ``{idx}_background.png`` / ``{idx}_solid.png`` / ``{idx}_non-solid.png``
  (a missing mask reads as zeros);
- clips are non-overlapping odd-length windows, capped equispaced per video;
- frames: bilinear resize to (size, size), [0, 1], ImageNet normalization;
  masks: nearest resize, stacked on a last channel axis.
Resizing is PIL's (the JAX package's native C++ resize documents PIL as its
fallback and matches it); PIL is imported when a clip is loaded.

Arrays are channels-last: clip (T, S, S, 3), masks (T, S, S, C), float32.
"""

from __future__ import annotations

import os
import re

import numpy as np

from vivim_tpu_torch.data import augment as aug
from vivim_tpu_torch.data import clips as clips_lib

MULTICLASS_KEYS = ("background", "solid", "non-solid")


def _frame_sort_key(name: str):
    m = re.match(r"(\d+)", os.path.splitext(name)[0])
    return int(m.group(1)) if m else 0


def mask_path_for(frame_path: str, key: str) -> str:
    base = os.path.splitext(frame_path)[0]
    return base.replace("frame", key) + ".png"


def index_video_tree(root: str, mask_keys=MULTICLASS_KEYS):
    """Index {root}/{video}/NNNN_frame.png trees: {video: [entry dicts]},
    each entry mapping 'frame' and each mask key to a path (None when the
    mask file is absent)."""
    videos = {}
    for vid in sorted(os.listdir(root)):
        vid_dir = os.path.join(root, vid)
        if not os.path.isdir(vid_dir):
            continue
        frames = sorted(
            (f for f in os.listdir(vid_dir)
             if f.endswith(".png") and "frame" in f.lower()),
            key=_frame_sort_key)
        entries = []
        for f in frames:
            fp = os.path.join(vid_dir, f)
            e = {"frame": fp}
            for key in mask_keys:
                mp = mask_path_for(fp, key)
                e[key] = mp if os.path.exists(mp) else None
            entries.append(e)
        if entries:
            videos[vid] = entries
    return videos


class ClipDataset:
    """Eval clip dataset over a gathered video tree (a directory) or an
    index dict {video: [entry dicts]}."""

    def __init__(self, root, size, clip_len=3, max_num=None,
                 mask_keys=MULTICLASS_KEYS):
        if clip_len % 2 != 1:
            raise ValueError("clip_len must be odd")
        self.size = size
        self.clip_len = clip_len
        self.mask_keys = tuple(mask_keys)
        self.videos = (root if isinstance(root, dict)
                       else index_video_tree(root, self.mask_keys))
        self.samples = []
        for vid, frames in self.videos.items():
            windows = clips_lib.select_equispaced(
                clips_lib.sliding_clip_windows(len(frames), clip_len),
                max_num)
            for w in windows:
                self.samples.append((vid, tuple(frames[i] for i in w)))

    def __len__(self):
        return len(self.samples)

    def load_clip(self, idx: int):
        """Returns dict(clip, masks, paths)."""
        from PIL import Image

        _, frames = self.samples[idx]
        S = self.size
        imgs, masks = [], []
        for entry in frames:
            img = Image.open(entry["frame"]).convert("RGB")
            r = np.asarray(img.resize((S, S), Image.BILINEAR),
                           np.float32) / 255.0
            imgs.append(aug.normalize_image(r).astype(np.float32))
            chans = []
            for key in self.mask_keys:
                mp = entry.get(key)
                m = (Image.open(mp).convert("L") if mp and os.path.exists(mp)
                     else Image.new("L", img.size, 0))
                chans.append(np.asarray(m.resize((S, S), Image.NEAREST),
                                        np.float32) / 255.0)
            masks.append(np.stack(chans, axis=-1))
        return {"clip": np.stack(imgs), "masks": np.stack(masks),
                "paths": tuple(e["frame"] for e in frames)}
