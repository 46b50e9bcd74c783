"""Metric logging: JSONL always; wandb when it is installed and asked for.

Port of the JAX package's ``train/logging.py``.  Every run writes
``metrics.jsonl`` beside its checkpoints.  ``use_wandb=True`` also logs
scalars and the confusion-matrix heatmaps to wandb; when wandb cannot be
imported or initialised (no package, no network), the logger says so and
writes JSONL only, as the JAX package's does.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


class MetricLogger:
    def __init__(self, log_dir: str, project: str = "vivim-tpu",
                 run_name: str | None = None, use_wandb: bool = False,
                 config: dict | None = None):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._fh = open(self.path, "a")
        self.wandb = None
        if use_wandb:
            try:
                import wandb

                wandb.init(project=project, name=run_name, config=config or {})
                self.wandb = wandb
            except Exception as e:  # wandb absent or offline: JSONL only
                print(f"[logging] wandb unavailable ({e}); JSONL only")
        if config:
            self.log({"config": config}, step=-1)

    def log(self, metrics: dict, step: int):
        rec = {"step": step, "time": time.time()}
        rec.update({k: (float(v) if hasattr(v, "item") or isinstance(
            v, (int, float)) else v) for k, v in metrics.items()})
        self._fh.write(json.dumps(rec, default=str) + "\n")
        self._fh.flush()
        if self.wandb is not None:
            scalars = {k: v for k, v in metrics.items()
                       if isinstance(v, (int, float))}
            self.wandb.log(scalars, step=max(step, 0))

    def log_confusion_matrix(self, cm, class_names, step, prefix="val"):
        """Raw, row- and column-normalised confusion matrices: arrays in
        JSONL; rendered heatmaps as wandb Images when wandb is on."""
        cm = np.asarray(cm, np.float64)
        row = cm / np.maximum(cm.sum(1, keepdims=True), 1)
        col = cm / np.maximum(cm.sum(0, keepdims=True), 1)
        self.log({
            f"{prefix}/confusion_matrix": cm.tolist(),
            f"{prefix}/confusion_matrix_row_norm": row.tolist(),
            f"{prefix}/confusion_matrix_col_norm": col.tolist(),
            f"{prefix}/class_names": list(class_names),
        }, step)
        if self.wandb is not None:
            import matplotlib.pyplot as plt

            for name, mat in ((f"{prefix}/confusion_matrix_img", cm),
                              (f"{prefix}/confusion_matrix_row_norm_img", row),
                              (f"{prefix}/confusion_matrix_col_norm_img", col)):
                fig = confusion_heatmap(mat, class_names)
                self.wandb.log({name: self.wandb.Image(fig)},
                               step=max(step, 0))
                plt.close(fig)

    def finish(self):
        self._fh.close()
        if self.wandb is not None:
            self.wandb.finish()


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend, or None where matplotlib
    cannot be imported (a host may lack it: the figures are optional)."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


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
