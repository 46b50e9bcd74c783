"""Raw-tree gathering: locate annotated frame dirs and build video trees.

Copy of the JAX package's ``data/gather.py``; behavioural contract from the
reference gatherers:

- ``find_annotated_dirs``: walk for directories containing ``frame.png`` +
  ``background.png`` (complements/create_train_data_multiclass.py:5-10).
- ``gather_multiclass_frames``: group annotated dirs by top-level video
  folder, sort by path, and emit ``{idx:04d}_frame.png`` (+ background +
  optional solid/non-solid) per video
  (create_train_data_multiclass.py:12-50).  ``copy=False`` builds an index
  (symlink-free, no data duplication) instead of copying — the loader
  reads straight from the index; ``copy=True`` reproduces the reference's
  copied tree for compatibility.
- ``gather_binary_frames``: frame + background only
  (complements/create_train_set.py:14-54).
- ``gather_frame_sequences``: length-L sequences centered on each annotated
  frame using ``{n}_frame.png`` neighbor numbering
  (complements/create_sequenced_data_multiclass.py:29-164).
"""

from __future__ import annotations

import os
import re
import shutil
from pathlib import Path

MULTICLASS_FILES = ("frame.png", "background.png")
OPTIONAL_FILES = ("solid.png", "non-solid.png")


def find_annotated_dirs(input_root):
    """Yield dirs holding frame.png + background.png (case-insensitive)."""
    for dirpath, _, filenames in os.walk(input_root):
        files = {f.lower() for f in filenames}
        if "frame.png" in files and "background.png" in files:
            yield Path(dirpath)


def _group_by_video(input_root: Path):
    videos = {}
    for ann in find_annotated_dirs(input_root):
        try:
            rel = ann.relative_to(input_root)
        except ValueError:
            continue
        videos.setdefault(rel.parts[0], []).append(ann)
    return {v: sorted(dirs, key=str) for v, dirs in videos.items()}


def gather_multiclass_frames(input_root, output_root=None, copy=True,
                             optional=OPTIONAL_FILES):
    """Gather annotated frames per video.

    With ``copy=True`` (reference-compatible) copies files into
    ``output_root/{video}/{idx:04d}_{name}.png`` and returns the index.
    With ``copy=False`` returns the index only:
    ``{video: [{'frame': path, 'background': path, 'solid': path|None,
    'non-solid': path|None}, ...]}`` in the same order.
    """
    input_root = Path(input_root).resolve()
    index = {}
    for vid, dirs in _group_by_video(input_root).items():
        entries = []
        for idx, ann in enumerate(dirs):
            entry = {"frame": str(ann / "frame.png"),
                     "background": str(ann / "background.png")}
            for name in optional:
                p = ann / name
                entry[os.path.splitext(name)[0]] = str(p) if p.exists() else None
            entries.append(entry)
            if copy:
                dest = Path(output_root) / vid
                dest.mkdir(parents=True, exist_ok=True)
                prefix = f"{idx:04d}_"
                for fname in MULTICLASS_FILES:
                    shutil.copy2(ann / fname, dest / f"{prefix}{fname}")
                for fname in optional:
                    src = ann / fname
                    if src.exists():
                        shutil.copy2(src, dest / f"{prefix}{fname}")
        index[vid] = entries
    return index


def gather_binary_frames(input_root, output_root=None, copy=True):
    """Frame + background only (binary task, create_train_set.py:14-54)."""
    return gather_multiclass_frames(input_root, output_root, copy, optional=())


def gather_frame_sequences(input_root, output_root, seq_len=5):
    """Build length-L sequences centered on each annotated frame.

    The raw tree names frames ``{n}_frame.png`` within a video dir; for each
    annotated frame n, neighbors n-h..n+h are copied (clamped at bounds by
    skipping incomplete sequences), reproducing the alternative layout of
    create_sequenced_data_multiclass.py:29-164.
    """
    if seq_len % 2 != 1:
        raise ValueError("seq_len must be odd")
    half = seq_len // 2
    input_root, output_root = Path(input_root), Path(output_root)
    n_seqs = 0
    for vid, dirs in _group_by_video(input_root).items():
        for ann in dirs:
            m = re.match(r"(\d+)", ann.name)
            if not m:
                continue
            center = int(m.group(1))
            parent = ann.parent
            neighbor_dirs = []
            for n in range(center - half, center + half + 1):
                cands = [d for d in parent.iterdir()
                         if d.is_dir() and re.match(rf"{n}(\D|$)", d.name)]
                if not cands:
                    break
                neighbor_dirs.append(cands[0])
            if len(neighbor_dirs) != seq_len:
                continue
            dest = output_root / vid / f"seq_{center:04d}"
            dest.mkdir(parents=True, exist_ok=True)
            for i, nd in enumerate(neighbor_dirs):
                for fname in MULTICLASS_FILES + OPTIONAL_FILES:
                    src = nd / fname
                    if src.exists():
                        shutil.copy2(src, dest / f"{i:04d}_{fname}")
            n_seqs += 1
    return n_seqs
