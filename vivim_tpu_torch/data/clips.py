"""Clip windowing and per-video clip-count capping (host numpy).

Copy of the JAX package's ``data/clips.py``:
- ``sliding_clip_windows``: centers step from ``half`` to ``N - half``
  (exclusive) in strides of ``clip_len``, giving non-overlapping odd-length
  windows ``[center-half, center+half]``;
- ``select_equispaced``: if a video yields more than ``max_num`` clips,
  keep ``max_num`` at ``np.linspace`` indices;
- ``select_random`` (DynamicDataset, Multiclass_Data.py:398-405): re-drawn
  every epoch with ``random.Random(seed + epoch).sample(range(1, n),
  max_num)``, in sorted order; clip 0 is never drawn, as in the reference.
"""

from __future__ import annotations

import random as _random

import numpy as np


def sliding_clip_windows(n_frames: int, clip_len: int):
    """Non-overlapping odd-length window index lists over a video."""
    if clip_len % 2 != 1:
        raise ValueError("clip_len must be odd")
    half = clip_len // 2
    return [list(range(center - half, center + half + 1))
            for center in range(half, n_frames - half, clip_len)]


def select_equispaced(clips: list, max_num: int | None):
    """max_numerosity cap: equispaced subset via linspace indices."""
    if max_num is None or len(clips) <= max_num:
        return list(clips)
    idx = np.linspace(0, len(clips) - 1, max_num, dtype=int)
    return [clips[i] for i in idx]


def select_random(clips: list, max_num: int | None, seed: int, epoch: int):
    """Dynamic per-epoch random subset (DynamicDataset semantics)."""
    if max_num is None or len(clips) <= max_num:
        return list(clips)
    rng = _random.Random(seed + epoch)
    indices = rng.sample(range(1, len(clips)), max_num)
    return [clips[i] for i in sorted(indices)]
