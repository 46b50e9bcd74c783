"""Clip datasets: indexing, loading, and per-clip array assembly (host
numpy).

Copy of the JAX package's ``data/dataset.py`` (the reference's MainDataset,
TestDataset and DynamicDataset of Multiclass_Data.py as one index-based
dataset):
- videos are directories of ``{idx}_frame.png`` files with sibling masks
  ``{idx}_background.png`` / ``{idx}_solid.png`` / ``{idx}_non-solid.png``
  (a missing mask reads as zeros, Multiclass_Data.py:186-193), or an index
  dict of the same entries;
- clips are non-overlapping odd-length windows (clips.py); per-video counts
  are capped equispaced (static) or randomly per epoch (``dynamic``);
- frames: synchronized augmentation (augment.py), then the native
  antialiased-bilinear resize to (size, size) fused with ImageNet
  normalization; masks: the native nearest resize, stacked on a last
  channel axis; edge maps: the per-class distance-transform band of radius
  2 (Multiclass_Data.py:220-234) through ``native.edge_band``.

Arrays are channels-last: clip (T, S, S, 3), masks (T, S, S, C), edges
(T, S, S, 1), float32.
"""

from __future__ import annotations

import dataclasses
import os
import random as _random
import re
import threading as _threading

import numpy as np
from PIL import Image

from vivim_tpu_torch import native
from vivim_tpu_torch.data import augment as aug
from vivim_tpu_torch.data import clips as clips_lib

MULTICLASS_KEYS = ("background", "solid", "non-solid")


@dataclasses.dataclass(frozen=True)
class ClipRecord:
    """One clip: per-frame entries (dicts with 'frame' + mask-key paths)."""

    video: str
    frames: tuple

    @property
    def frame_paths(self):
        return tuple(e["frame"] for e in self.frames)


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


def _edge_map(onehot: np.ndarray, radius: int = 2) -> np.ndarray:
    """(H, W, C) {0,1} masks -> (H, W, 1) edge band (EDT in + out <= radius),
    summed over classes (Multiclass_Data.py:220-234)."""
    masks = np.ascontiguousarray(np.moveaxis(onehot, -1, 0), np.uint8)
    emap = native.edge_band(masks, float(radius))
    return emap[:, :, None].astype(np.float32)


class ClipDataset:
    """Multiclass clip dataset over an indexed video tree.

    Args:
      root: a gathered video-tree directory, or an index dict {video:
        [entry dicts]} (e.g. from gather_multiclass_frames with copy=False).
      size: square resize target.
      clip_len: odd window length.
      max_num: per-video clip cap (max_numerosity).
      augment: intensity preset, or None / "none" for eval.
      mask_keys: mask channel names (MULTICLASS_KEYS, or ("background",)
        for the binary task).
      dynamic: resample the per-video clip subset each epoch.
      seed: base seed for dynamic selection and augmentation.
      with_edges: compute edge maps.
      invert_background: binary pipeline: masks become 1 - mask.
      pad_short_videos: a video shorter than clip_len becomes one window
        padded by repeating its last frame (binary pipeline).
      cache_decoded / cache_mb: keep decoded uint8 frames and masks in host
        RAM, up to cache_mb MB per dataset.
      pre_resize: resize to (size, size) at decode time, before
        augmentation (a throughput mode that reorders interpolation).
    """

    def __init__(self, root, size, clip_len=3, max_num=None, augment="medium",
                 mask_keys=MULTICLASS_KEYS, dynamic=False, seed=42,
                 with_edges=True, invert_background=False,
                 pad_short_videos=False, cache_decoded=False,
                 cache_mb=4096, pre_resize=False):
        if clip_len % 2 != 1:
            raise ValueError("clip_len must be odd")
        self.root = root
        self.size = size
        self.clip_len = clip_len
        self.max_num = max_num
        self.augment = augment if augment else "none"
        self.mask_keys = tuple(mask_keys)
        self.dynamic = dynamic
        self.seed = seed
        self.epoch = 0
        self.with_edges = with_edges
        self.invert_background = invert_background
        self.pad_short_videos = pad_short_videos
        # Decode cache: PNG decode is deterministic, so epochs >= 2 can
        # reuse the decoded uint8 arrays exactly.  Keyed by (path, mode,
        # presize): the same file opened as 'RGB' and 'L' (or with another
        # pre-resize target) must not alias.  Insertion stops at the cap
        # (frames recur uniformly every epoch, so eviction would buy
        # nothing).  The lock guards the check-then-insert of the byte
        # count: the loader's worker threads share this dict.
        self.cache_decoded = bool(cache_decoded)
        self._cache: dict[tuple, np.ndarray] = {}
        self._cache_bytes = 0
        self._cache_limit = int(cache_mb) * (1 << 20)
        self._cache_lock = _threading.Lock()
        self.pre_resize = bool(pre_resize)
        if isinstance(root, dict):
            self.videos = {v: list(entries) for v, entries in root.items()}
        else:
            self.videos = index_video_tree(root, self.mask_keys)
        self._rebuild()

    def _rebuild(self):
        samples = []
        for vid, frames in self.videos.items():
            windows = clips_lib.sliding_clip_windows(len(frames), self.clip_len)
            if not windows and self.pad_short_videos and frames:
                idx = list(range(len(frames)))
                idx += [idx[-1]] * (self.clip_len - len(idx))
                windows = [idx]
            if self.dynamic:
                windows = clips_lib.select_random(
                    windows, self.max_num, self.seed, self.epoch)
            else:
                windows = clips_lib.select_equispaced(windows, self.max_num)
            for w in windows:
                samples.append(ClipRecord(vid, tuple(frames[i] for i in w)))
        self.samples = samples

    def set_epoch(self, epoch: int):
        """Dynamic mode: re-draw the per-video clip subsets (the reference
        rebuilds its DataLoader per epoch, dyn_multiclass_training.py:739-747)."""
        self.epoch = epoch
        if self.dynamic:
            self._rebuild()

    def __len__(self):
        return len(self.samples)

    def _open(self, path: str, mode: str) -> Image.Image:
        """``Image.open(path).convert(mode)`` with the optional pre-resize
        to the target size and the optional decode cache (post-convert,
        post-pre-resize uint8 arrays, so cached == uncached exactly)."""
        presize = self.size if self.pre_resize else None

        def decode():
            im = Image.open(path).convert(mode)
            if presize is not None and im.size != (presize, presize):
                # BILINEAR (antialiased) for frames, NEAREST for masks: the
                # resample pair of the post-augment resize
                resample = (Image.NEAREST if mode == "L"
                            else Image.BILINEAR)
                im = im.resize((presize, presize), resample)
            return im

        if not self.cache_decoded:
            return decode()
        key = (path, mode, presize)
        arr = self._cache.get(key)
        if arr is None:
            im = decode()
            arr = np.asarray(im, np.uint8)
            with self._cache_lock:
                if (key not in self._cache
                        and self._cache_bytes + arr.nbytes
                        <= self._cache_limit):
                    self._cache[key] = arr
                    self._cache_bytes += arr.nbytes
            return im
        return Image.fromarray(arr)

    def load_clip(self, idx: int, rng: _random.Random | None = None):
        """Returns dict(clip, masks, edges?, paths)."""
        rec = self.samples[idx]
        S = self.size
        do_aug = self.augment != "none"
        rng = rng or _random.Random(self.seed * 1_000_003 + idx * 31 + self.epoch)

        imgs, mask_sets = [], []
        for entry in rec.frames:
            img = self._open(entry["frame"], "RGB")
            masks = []
            for key in self.mask_keys:
                mp = entry.get(key)
                if mp and os.path.exists(mp):
                    m = self._open(mp, "L")
                else:
                    m = Image.new("L", img.size, 0)
                masks.append(m)
            if do_aug:
                img, masks = aug.apply_augmentation(
                    img, masks, self.augment, rng)
            imgs.append(img)
            mask_sets.append(masks)

        # resize + normalize on the native path: PIL-matching antialiased
        # bilinear for frames fused with ImageNet normalization, nearest for
        # masks (native/edge_ops.cc; PIL fallback without a toolchain)
        clip = np.stack([
            native.resize_bilinear_normalize(
                np.asarray(im, np.uint8), S, S,
                aug.IMAGENET_MEAN, aug.IMAGENET_STD)
            for im in imgs])
        mask_arrs, edges = [], []
        for masks in mask_sets:
            chans = [
                native.resize_nearest(
                    np.asarray(m, np.uint8), S, S).astype(np.float32) / 255.0
                for m in masks]
            onehot = np.stack(chans, axis=-1)
            if self.invert_background:
                # binary pipeline: the background mask marks non-lesion
                # (complements/main_dataset.py:14-15 invert_mask)
                onehot = 1.0 - onehot
            mask_arrs.append(onehot)
            if self.with_edges:
                edges.append(_edge_map((onehot > 0.5).astype(np.uint8)))
        out = {
            "clip": clip.astype(np.float32),
            "masks": np.stack(mask_arrs).astype(np.float32),
            "paths": rec.frame_paths,
        }
        if self.with_edges:
            out["edges"] = np.stack(edges).astype(np.float32)
        return out
