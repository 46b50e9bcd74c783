"""The one generator of the benchmark's inputs.  A traffic file
(``perfbench/traffic/<name>.json``) names its driver and holds the
parameters; this module turns them and ``--seed`` into inputs.

Every input is a function of (seed, stream, index): the same seed gives
the same clips, masks and token ids, and request ``i`` is the same
whatever the run's length.  Clips are standard-normal frames (the
normalised pixels a loader hands over) with one-hot masks of random discs,
one per foreground class and frame, drawn over the background; token ids
are uniform over the configuration's real vocabulary (the padding rows
are never drawn).
"""

from __future__ import annotations

import hashlib

import torch


def sub_seed(seed, *tags):
    """A 63-bit seed of ``seed`` and ``tags``: streams that never share
    draws."""
    text = ":".join(str(x) for x in (seed,) + tags)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1


def clip_batch(seed, index, batch, frames, size, classes, device="cpu"):
    """(clip (batch, frames, size, size, 3) float32, one-hot masks (batch,
    frames, size, size, classes) float32) of request or batch ``index``."""
    gen = torch.Generator(device=device).manual_seed(
        sub_seed(seed, "clip", index))
    clip = torch.randn((batch, frames, size, size, 3), generator=gen,
                       device=device)
    n = (batch, frames, classes - 1)
    cy = torch.randint(size // 8, size - size // 8, n, generator=gen,
                       device=device)
    cx = torch.randint(size // 8, size - size // 8, n, generator=gen,
                       device=device)
    r = torch.randint(max(size // 16, 1), max(size // 4, 2), n,
                      generator=gen, device=device)
    grid = torch.arange(size, device=device)
    labels = torch.zeros((batch, frames, size, size), dtype=torch.long,
                         device=device)
    for c in range(1, classes):
        dy = grid[None, None, :, None] - cy[..., c - 1, None, None]
        dx = grid[None, None, None, :] - cx[..., c - 1, None, None]
        inside = dy * dy + dx * dx < (r[..., c - 1] ** 2)[..., None, None]
        labels = torch.where(inside, c, labels)
    masks = torch.nn.functional.one_hot(labels, classes).float()
    return clip, masks


def token_ids(seed, index, batch, length, vocab):
    """(batch, length) int64 ids of request ``index`` on the host."""
    gen = torch.Generator().manual_seed(sub_seed(seed, "tokens", index))
    return torch.randint(0, vocab, (batch, length), generator=gen)


def sample(seed, population, k):
    """``k`` distinct indices of ``range(population)`` drawn from the
    seed, in increasing order."""
    gen = torch.Generator().manual_seed(sub_seed(seed, "sample"))
    return sorted(torch.randperm(population, generator=gen)[:k].tolist())
