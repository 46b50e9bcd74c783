"""Metric logging: console-free JSONL, and the confusion-matrix heatmap.

Port of the JAX package's ``train/logging.py``.  Every run writes
``metrics.jsonl`` beside its checkpoints.  The JAX package can also log to
wandb; the port cannot (neither machine it runs on has a network), so
``use_wandb=True`` raises.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


class MetricLogger:
    def __init__(self, log_dir: str, use_wandb: bool = False,
                 config: dict | None = None):
        if use_wandb:
            raise ValueError("wandb logging is not available in the port; "
                             "metrics go to metrics.jsonl")
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._fh = open(self.path, "a")
        if config:
            self.log({"config": config}, step=-1)

    def log(self, metrics: dict, step: int):
        rec = {"step": step, "time": time.time()}
        rec.update({k: (float(v) if hasattr(v, "item") or isinstance(
            v, (int, float)) else v) for k, v in metrics.items()})
        self._fh.write(json.dumps(rec, default=str) + "\n")
        self._fh.flush()

    def log_confusion_matrix(self, cm, class_names, step, prefix="val"):
        """Raw, row- and column-normalised confusion matrices."""
        cm = np.asarray(cm, np.float64)
        self.log({
            f"{prefix}/confusion_matrix": cm.tolist(),
            f"{prefix}/confusion_matrix_row_norm":
                (cm / np.maximum(cm.sum(1, keepdims=True), 1)).tolist(),
            f"{prefix}/confusion_matrix_col_norm":
                (cm / np.maximum(cm.sum(0, keepdims=True), 1)).tolist(),
            f"{prefix}/class_names": list(class_names),
        }, step)

    def finish(self):
        self._fh.close()


def confusion_heatmap(mat, class_names):
    """One confusion-matrix heatmap figure (matplotlib, imported here)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    mat = np.asarray(mat, np.float64)
    fig, ax = plt.subplots(figsize=(5, 4))
    im = ax.imshow(mat, cmap="Blues")
    for i in range(mat.shape[0]):
        for j in range(mat.shape[1]):
            ax.text(j, i, f"{mat[i, j]:.2f}" if mat.max() <= 1
                    else f"{int(mat[i, j])}", ha="center", va="center",
                    fontsize=8)
    names = list(class_names)[: mat.shape[0]]
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels(names, rotation=30)
    ax.set_yticks(range(len(names)))
    ax.set_yticklabels(names)
    ax.set_xlabel("prediction")
    ax.set_ylabel("ground truth")
    fig.colorbar(im)
    fig.tight_layout()
    return fig
