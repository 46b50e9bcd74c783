"""Segmentation metrics: confusion counts on the device, scalar metrics and
the presence-gated per-class tracker on the host.

Port of the JAX package's ``train/metrics.py`` (``per_class_confusion``, dice,
jaccard, precision, recall, ``MulticlassMetricsTracker``) and of
``confusion_matrix_device`` from the JAX package's ``train/loop.py``.  Scalar
metrics keep the reference's edge cases: an empty test and reference
gives 0.0 (NaN with ``nan_for_nonexisting``).
"""

from __future__ import annotations

import numpy as np
import torch


def per_class_confusion(pred_labels, gt_labels, num_classes: int):
    """(N, H, W) integer predictions / ground truth -> (N, C, 4) int64
    [tp, fp, tn, fn] counts, computed on the tensors' device."""
    size = pred_labels[0].numel()
    out = []
    for c in range(num_classes):
        p = pred_labels == c
        g = gt_labels == c
        tp = (p & g).sum((1, 2))
        fp = (p & ~g).sum((1, 2))
        fn = (~p & g).sum((1, 2))
        out.append(torch.stack([tp, fp, size - tp - fp - fn, fn], -1))
    return torch.stack(out, 1)


def confusion_matrix(preds, targets, num_classes: int):
    """Aggregated (C, C) confusion matrix, rows = ground truth, columns =
    prediction, on the tensors' device."""
    idx = targets.reshape(-1).long() * num_classes + preds.reshape(-1).long()
    return torch.bincount(idx, minlength=num_classes * num_classes).reshape(
        num_classes, num_classes)


def _nan_or_zero(nan_for_nonexisting):
    return float("nan") if nan_for_nonexisting else 0.0


def dice(tp, fp, tn, fn, nan_for_nonexisting=False):
    """2TP / (2TP + FP + FN); both empty -> 0/NaN."""
    if tp + fp == 0 and tp + fn == 0:
        return _nan_or_zero(nan_for_nonexisting)
    return float(2.0 * tp / (2 * tp + fp + fn))


def jaccard(tp, fp, tn, fn, nan_for_nonexisting=False):
    if tp + fp == 0 and tp + fn == 0:
        return _nan_or_zero(nan_for_nonexisting)
    return float(tp / (tp + fp + fn))


def precision(tp, fp, tn, fn, nan_for_nonexisting=False):
    if tp + fp == 0:
        return _nan_or_zero(nan_for_nonexisting)
    return float(tp / (tp + fp))


def recall(tp, fp, tn, fn, nan_for_nonexisting=False):
    if tp + fn == 0:
        return _nan_or_zero(nan_for_nonexisting)
    return float(tp / (tp + fn))


def specificity(tp, fp, tn, fn, nan_for_nonexisting=False):
    if tn + fp == 0:
        return _nan_or_zero(nan_for_nonexisting)
    return float(tn / (tn + fp))


def fscore(tp, fp, tn, fn, nan_for_nonexisting=False, beta=1.0):
    if tp + fp == 0 and tp + fn == 0:
        return _nan_or_zero(nan_for_nonexisting)
    b2 = beta * beta
    denom = (1 + b2) * tp + b2 * fn + fp
    if denom == 0:
        return _nan_or_zero(nan_for_nonexisting)
    return float((1 + b2) * tp / denom)


CONFUSION_METRICS = {
    "dice": dice,
    "jaccard": jaccard,
    "precision": precision,
    "recall": recall,
    "f_measure": fscore,
    "specificity": specificity,
}


class MulticlassMetricsTracker:
    """Accumulates per-class metrics only for samples whose ground truth
    contains the class; ``get_results`` gives per-class means (None when
    never present) and the macro mean over present classes."""

    TRACKED = ("dice", "jaccard", "precision", "recall", "f_measure",
               "specificity")

    def __init__(self, num_classes=3):
        self.num_classes = num_classes
        self.reset()

    def reset(self):
        self.values = {m: [[] for _ in range(self.num_classes)]
                       for m in self.TRACKED}
        self.class_counts = [0] * self.num_classes

    def update_from_confusion(self, conf):
        """Accumulate (N, C, 4) [tp, fp, tn, fn] counts (a class is present
        in a sample's ground truth exactly when tp + fn > 0)."""
        conf = np.asarray(conf)
        present = (conf[:, :, 0] + conf[:, :, 3]) > 0
        for i in range(conf.shape[0]):
            for c in range(self.num_classes):
                if not present[i, c]:
                    continue
                self.class_counts[c] += 1
                tp, fp, tn, fn = (int(v) for v in conf[i, c])
                for m in self.TRACKED:
                    self.values[m][c].append(
                        CONFUSION_METRICS[m](tp, fp, tn, fn))

    def get_results(self):
        results = {}
        for m in self.TRACKED:
            per_class = [
                float(np.mean(self.values[m][c]))
                if self.class_counts[c] > 0 else None
                for c in range(self.num_classes)]
            valid = [v for v in per_class if v is not None]
            results[m] = {
                "per_class": per_class,
                "mean": float(np.mean(valid)) if valid else 0.0,
            }
        results["class_counts"] = list(self.class_counts)
        return results
