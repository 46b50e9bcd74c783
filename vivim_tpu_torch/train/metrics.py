"""Segmentation metrics: confusion counts on the device, scalar metrics and
the presence-gated per-class tracker on the host.

Port of the JAX package's ``train/metrics.py`` (``per_class_confusion``,
the confusion-matrix metrics ``CONFUSION_METRICS``, the surface distances,
``ALL_METRICS``, ``MulticlassMetricsTracker``) and of
``confusion_matrix_device`` from the JAX package's ``train/loop.py``.  Scalar
metrics keep the reference's edge cases: an empty test and reference
gives 0.0 (NaN with ``nan_for_nonexisting``).  The surface distances are
medpy's definitions through scipy (surface voxels: a mask minus its
erosion; distances by EDT), on host numpy masks.
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
    """Aggregated (C, C) int64 confusion matrix, rows = ground truth,
    columns = prediction, on the tensors' device: one ``index_add_`` into
    C * C zeros.  Its size is fixed and it reads nothing back to the host,
    so a CUDA graph can capture it (a bincount sizes its output from the
    input's maximum, a host sync)."""
    idx = targets.reshape(-1).long() * num_classes + preds.reshape(-1).long()
    return torch.zeros(num_classes * num_classes, dtype=torch.long,
                       device=idx.device).index_add_(
        0, idx, torch.ones_like(idx)).view(num_classes, num_classes)


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


sensitivity = recall


def specificity(tp, fp, tn, fn, nan_for_nonexisting=False):
    if tn + fp == 0:
        return _nan_or_zero(nan_for_nonexisting)
    return float(tn / (tn + fp))


def accuracy(tp, fp, tn, fn, **_):
    return float((tp + tn) / (tp + fp + tn + fn))


def fscore(tp, fp, tn, fn, nan_for_nonexisting=False, beta=1.0):
    if tp + fp == 0 and tp + fn == 0:
        return _nan_or_zero(nan_for_nonexisting)
    b2 = beta * beta
    denom = (1 + b2) * tp + b2 * fn + fp
    if denom == 0:
        return _nan_or_zero(nan_for_nonexisting)
    return float((1 + b2) * tp / denom)


def false_positive_rate(tp, fp, tn, fn, nan_for_nonexisting=False):
    """FP / (FP + TN) = 1 - specificity, as the reference computes it: 1.0
    (or NaN) where specificity is nonexisting."""
    return 1.0 - specificity(tp, fp, tn, fn, nan_for_nonexisting)


def false_omission_rate(tp, fp, tn, fn, nan_for_nonexisting=False):
    """FN / (TN + FN); test full -> 0/NaN."""
    if tn + fn == 0:
        return _nan_or_zero(nan_for_nonexisting)
    return float(fn / (fn + tn))


def negative_predictive_value(tp, fp, tn, fn, nan_for_nonexisting=False):
    """TN / (TN + FN) = 1 - false_omission_rate."""
    return 1.0 - false_omission_rate(tp, fp, tn, fn, nan_for_nonexisting)


def false_negative_rate(tp, fp, tn, fn, nan_for_nonexisting=False):
    """FN / (TP + FN) = 1 - sensitivity."""
    return 1.0 - sensitivity(tp, fp, tn, fn, nan_for_nonexisting)


def true_negative_rate(tp, fp, tn, fn, nan_for_nonexisting=False):
    """TN / (TN + FP) = specificity."""
    return specificity(tp, fp, tn, fn, nan_for_nonexisting)


def false_discovery_rate(tp, fp, tn, fn, nan_for_nonexisting=False):
    """FP / (TP + FP) = 1 - precision."""
    return 1.0 - precision(tp, fp, tn, fn, nan_for_nonexisting)


def total_positives_test(tp, fp, tn, fn, **_):
    return tp + fp


def total_negatives_test(tp, fp, tn, fn, **_):
    return tn + fn


def total_positives_reference(tp, fp, tn, fn, **_):
    return tp + fn


def total_negatives_reference(tp, fp, tn, fn, **_):
    return tn + fp


CONFUSION_METRICS = {
    "dice": dice,
    "jaccard": jaccard,
    "precision": precision,
    "recall": recall,
    "sensitivity": sensitivity,
    "specificity": specificity,
    "accuracy": accuracy,
    "f_measure": fscore,
    "false_positive_rate": false_positive_rate,
    "false_omission_rate": false_omission_rate,
    "negative_predictive_value": negative_predictive_value,
    "false_negative_rate": false_negative_rate,
    "true_negative_rate": true_negative_rate,
    "false_discovery_rate": false_discovery_rate,
    "total_positives_test": total_positives_test,
    "total_negatives_test": total_negatives_test,
    "total_positives_reference": total_positives_reference,
    "total_negatives_reference": total_negatives_reference,
}


def _surface_distances(test, reference, connectivity=1):
    from scipy.ndimage import (
        binary_erosion,
        distance_transform_edt,
        generate_binary_structure,
    )

    test = np.atleast_1d(np.asarray(test).astype(bool))
    reference = np.atleast_1d(np.asarray(reference).astype(bool))
    footprint = generate_binary_structure(test.ndim, connectivity)
    if not test.any() or not reference.any():
        raise RuntimeError("surface distance undefined for empty masks")
    test_border = test ^ binary_erosion(test, structure=footprint,
                                        iterations=1)
    ref_border = reference ^ binary_erosion(reference, structure=footprint,
                                            iterations=1)
    return distance_transform_edt(~ref_border)[test_border]


def hausdorff_distance(test, reference, connectivity=1,
                       nan_for_nonexisting=False):
    try:
        d1 = _surface_distances(test, reference, connectivity)
        d2 = _surface_distances(reference, test, connectivity)
    except RuntimeError:
        return _nan_or_zero(nan_for_nonexisting)
    return float(max(d1.max(), d2.max()))


def hausdorff_distance_95(test, reference, connectivity=1,
                          nan_for_nonexisting=False):
    try:
        d1 = _surface_distances(test, reference, connectivity)
        d2 = _surface_distances(reference, test, connectivity)
    except RuntimeError:
        return _nan_or_zero(nan_for_nonexisting)
    return float(max(np.percentile(d1, 95), np.percentile(d2, 95)))


def avg_surface_distance(test, reference, connectivity=1,
                         nan_for_nonexisting=False):
    try:
        return float(_surface_distances(test, reference, connectivity).mean())
    except RuntimeError:
        return _nan_or_zero(nan_for_nonexisting)


def avg_surface_distance_symmetric(test, reference, connectivity=1,
                                   nan_for_nonexisting=False):
    try:
        d1 = _surface_distances(test, reference, connectivity)
        d2 = _surface_distances(reference, test, connectivity)
    except RuntimeError:
        return _nan_or_zero(nan_for_nonexisting)
    return float(np.concatenate([d1, d2]).mean())


ALL_METRICS = dict(CONFUSION_METRICS)
ALL_METRICS.update({
    "hausdorff_distance": hausdorff_distance,
    "hausdorff_distance_95": hausdorff_distance_95,
    "avg_surface_distance": avg_surface_distance,
    "avg_surface_distance_symmetric": avg_surface_distance_symmetric,
})


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
