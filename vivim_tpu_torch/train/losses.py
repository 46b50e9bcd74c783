"""Segmentation losses (channels-last, fp32).

Port of the JAX package's ``train/losses.py`` (the ``LOSSES`` table), with
the reference training scripts' semantics
(multiclass_training_folds.py:182-423, final_multiclass_training.py:403-445):

- ``dice_loss``: softmax probs, per-class soft Dice over (H, W), batch-mean
  per class, class-mean.
- ``tversky_loss``: alpha = 0.3 (FP) / beta = 0.7 (FN), favouring recall.
- ``class_balanced_focal_loss``: per-class one-vs-rest BCE with focal weight
  ``t(1-p)^g + (1-t)p^g`` and class weights alpha (None: normalised inverse
  frequency); per-class means are summed.
- ``recall_focused_loss``: the production loss,
  ``0.4 * focal(alpha=[.05, .475, .475], gamma=2) + 0.6 * tversky(.3/.7)``.
- ``combined_focal_dice_loss``: ``(1-w) * focal(gamma=3) + w * dice``.
- ``cross_entropy``.
- ``boundary_aware_loss``: CE + boundary-masked per-class BCE, boundary =
  clipped forward difference of the one-hot target.
- ``multiclass_structure_loss``: per-class weighted BCE + weighted IoU with
  a 31x31 mean-pool boundary-emphasis weight map.

All take ``logits (N, H, W, C)`` and integer ``targets (N, H, W)``.  Every
one is a mean over the batch, so under data parallel the average of the
ranks' losses (and gradients) is the global batch's, except where a weight
comes from the batch itself: ``class_balanced_focal_loss``'s class counts
without ``alpha``, and the edge loss's edge pixel counts
(``edge_loss.edge_bce``).  Those counts are summed over ``batch_group``'s
process group while the train or eval step holds it, as the JAX step
takes them from the global batch.  Beside
the table, ``structure_loss`` is the binary pipeline's loss on one logit
channel and a float mask (modeling/utils.py:89-102), and the legacy VOS
losses of the reference's loss.py (``mask_iou``, ``mask_iou_loss``,
``binary_entropy_loss``, ``cross_entropy_loss``, ``smooth_l1_loss``) take
channels-first (N, K, H, W) probabilities, as there.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

from vivim_tpu_torch.parallel import comm

_EPS = 1e-6
_BATCH_GROUP = contextvars.ContextVar("batch_group", default=None)


@contextlib.contextmanager
def batch_group(group):
    """The losses' batch-wide counts summed over ``group`` (the data ranks
    of a data-parallel step, whose blocks make up the global batch) in the
    body; None: this batch alone."""
    token = _BATCH_GROUP.set(group)
    try:
        yield
    finally:
        _BATCH_GROUP.reset(token)


def batch_sum(x):
    """``x``, a count over this rank's block, summed over the batch group
    (non-differentiable: the counts are of targets)."""
    group = _BATCH_GROUP.get()
    return x if group is None else comm.all_reduce_sum(x, group)


def _onehot(targets, num_classes):
    return F.one_hot(targets.long(), num_classes).float()


def _probs(logits):
    return torch.softmax(logits.float(), dim=-1)


def dice_loss(logits, targets, num_classes=None, smooth=_EPS):
    C = num_classes or logits.shape[-1]
    p = _probs(logits)
    t = _onehot(targets, C)
    inter = (p * t).sum((1, 2))                  # (N, C)
    union = p.sum((1, 2)) + t.sum((1, 2))
    dice = (2.0 * inter + smooth) / (union + smooth)
    return (1.0 - dice.mean(0)).mean()


def tversky_loss(logits, targets, num_classes=None, alpha=0.3, beta=0.7,
                 smooth=_EPS):
    C = num_classes or logits.shape[-1]
    p = _probs(logits)
    t = _onehot(targets, C)
    tp = (p * t).sum((1, 2))
    fp = (p * (1.0 - t)).sum((1, 2))
    fn = ((1.0 - p) * t).sum((1, 2))
    tv = (tp + smooth) / (tp + alpha * fp + beta * fn + smooth)
    return (1.0 - tv.mean(0)).mean()


def class_balanced_focal_loss(logits, targets, num_classes=None, gamma=2.0,
                              alpha=None):
    C = num_classes or logits.shape[-1]
    p = _probs(logits)
    t = _onehot(targets, C)
    if alpha is None:
        counts = batch_sum(torch.cat([t.sum((0, 1, 2)), t.new_full(
            (1,), t[..., 0].numel())]))         # (C,) and the pixel count
        w = counts[-1] / (C * (counts[:-1] + _EPS))
        alpha = w / w.sum()
    else:
        # filled on the device: a copy from pageable host memory cannot be
        # captured in the replayed train step
        alpha = torch.stack([logits.new_full((), float(a),
                                             dtype=torch.float32)
                             for a in alpha])
    focal_w = t * (1.0 - p) ** gamma + (1.0 - t) * p ** gamma
    bce = -t * torch.log(p + _EPS) - (1.0 - t) * torch.log(1.0 - p + _EPS)
    return (alpha * focal_w * bce).mean((0, 1, 2)).sum()


def recall_focused_loss(logits, targets, num_classes=None, gamma=2.0,
                        alpha=(0.05, 0.475, 0.475)):
    """The production loss (multiclass_training_folds.py:339-361)."""
    tv = tversky_loss(logits, targets, num_classes, alpha=0.3, beta=0.7)
    fo = class_balanced_focal_loss(logits, targets, num_classes, gamma,
                                   alpha=alpha)
    return 0.4 * fo + 0.6 * tv


def combined_focal_dice_loss(logits, targets, num_classes=None, gamma=3.0,
                             alpha=None, dice_weight=0.5):
    fo = class_balanced_focal_loss(logits, targets, num_classes, gamma, alpha)
    di = dice_loss(logits, targets, num_classes)
    return (1.0 - dice_weight) * fo + dice_weight * di


def cross_entropy(logits, targets, num_classes=None):
    C = num_classes or logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(_onehot(targets, C) * logp).sum(-1).mean()


def boundary_aware_loss(logits, targets, num_classes=None, weight=0.5):
    C = num_classes or logits.shape[-1]
    p = _probs(logits)
    t = _onehot(targets, C)                      # (N, H, W, C)
    gx = (torch.cat([t[:, :, 1:], t[:, :, -1:]], 2) - t).abs()
    gy = (torch.cat([t[:, 1:], t[:, -1:]], 1) - t).abs()
    boundary = (gx + gy).clamp(0.0, 1.0)
    interior = cross_entropy(logits, targets, C)
    bce = -t * torch.log(p + _EPS) - (1.0 - t) * torch.log(1.0 - p + _EPS)
    bl = (boundary * bce).mean((0, 1, 2))        # per class
    return interior + weight * bl.sum() / C


def _mean_pool_31(x):
    """31x31 stride-1 mean pool, zero padding, constant divisor
    (avg_pool2d count_include_pad=True).  x: (N, H, W, 1)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 31, stride=1, padding=15,
                        count_include_pad=True).permute(0, 2, 3, 1)


def _weighted_structure(pred_logit, mask, eps):
    """Weighted BCE + weighted IoU of one binary channel, (N, H, W, 1)."""
    pred_logit = pred_logit.float()
    mask = mask.float()
    weit = 1.0 + 5.0 * (_mean_pool_31(mask) - mask).abs()
    wbce = F.binary_cross_entropy_with_logits(pred_logit, mask,
                                              reduction="none")
    wbce = (weit * wbce).sum((1, 2, 3)) / weit.sum((1, 2, 3))
    prob = torch.sigmoid(pred_logit)
    inter = (prob * mask * weit).sum((1, 2, 3))
    union = ((prob + mask) * weit).sum((1, 2, 3))
    wiou = 1.0 - (inter + eps) / (union - inter + eps)
    return (wbce + wiou).mean()


def multiclass_structure_loss(logits, targets, num_classes=None, eps=_EPS):
    C = num_classes or logits.shape[-1]
    t = _onehot(targets, C)
    return sum(_weighted_structure(logits[..., c:c + 1], t[..., c:c + 1], eps)
               for c in range(C)) / C


def structure_loss(pred, mask, iou=True, legacy_wbce=False):
    """Binary weighted BCE (+ weighted IoU) of ``pred`` logits and ``mask``,
    both (N, H, W, 1), eps 1 (modeling/utils.py:89-102).

    ``legacy_wbce=True`` is the reference's actual torch behaviour: its
    ``reduce='none'`` string is truthy for torch's legacy shim, so the BCE
    term is an unweighted mean and the boundary weight applies to the IoU
    term only.  The default keeps the intended weighted BCE."""
    if legacy_wbce:
        pred, mask = pred.float(), mask.float()
        weit = 1.0 + 5.0 * (_mean_pool_31(mask) - mask).abs()
        bce = F.binary_cross_entropy_with_logits(pred, mask)
        if not iou:
            return bce
        prob = torch.sigmoid(pred)
        inter = (prob * mask * weit).sum((1, 2, 3))
        union = ((prob + mask) * weit).sum((1, 2, 3))
        wiou = 1.0 - (inter + 1.0) / (union - inter + 1.0)
        return (bce + wiou).mean()
    if iou:
        return _weighted_structure(pred, mask, eps=1.0)
    pred, mask = pred.float(), mask.float()
    weit = 1.0 + 5.0 * (_mean_pool_31(mask) - mask).abs()
    wbce = F.binary_cross_entropy_with_logits(pred, mask, reduction="none")
    return ((weit * wbce).sum((1, 2, 3)) / weit.sum((1, 2, 3))).mean()


LOSSES = {
    "recall_focused": recall_focused_loss,
    "dice": dice_loss,
    "tversky": tversky_loss,
    "focal": class_balanced_focal_loss,
    "combined_focal_dice": combined_focal_dice_loss,
    "boundary_aware": boundary_aware_loss,
    "multiclass_structure": multiclass_structure_loss,
    "cross_entropy": cross_entropy,
}


# Legacy VOS losses (reference loss.py:4-83), kept for capability parity


def mask_iou(pred, target, averaged=True):
    """min / max mask IoU over (N, H, W) soft masks (loss.py:4-22): the
    intersection is the elementwise min, the union the elementwise max, no
    eps."""
    p = pred.float().reshape(pred.shape[0], -1)
    t = target.float().reshape(target.shape[0], -1)
    iou = torch.minimum(p, t).sum(1) / torch.maximum(p, t).sum(1)
    return iou.mean() if averaged else iou


def mask_iou_loss(pred, mask, num_object, ref=None):
    """Per-sample mean of (1 - mask IoU) over the object channels
    (loss.py:61-77).  pred / mask (N, K, H, W): channels [start, start +
    num_object) are scored, start 0 iff K == num_object (the reference
    skips a background channel).  With ``ref`` (N, K', H, W), channel c
    counts only where ref[i, start + c] has foreground (a masked mean)."""
    K = mask.shape[1]
    start = 0 if K == num_object else 1
    p = pred[:, start:num_object + start].float()
    m = mask[:, start:num_object + start].float()
    obj_loss = 1.0 - (torch.minimum(p, m).sum((2, 3))
                      / torch.maximum(p, m).sum((2, 3)))
    if ref is None:
        return obj_loss.mean(1).mean()
    valid = (ref.reshape(ref.shape[0], ref.shape[1], -1).sum(-1) > 0)[
        :, start:].float()
    return ((obj_loss * valid).sum(1) / valid.sum(1).clamp(min=1.0)).mean()


def binary_entropy_loss(pred, target, num_object=None, eps=0.001):
    """Mean binary cross entropy of probabilities, with the reference's eps
    inside the logs (loss.py:24-32; ``num_object`` unused there too)."""
    p, t = pred.float(), target.float()
    return (-t * torch.log(p + eps) - (1 - t) * torch.log(1 - p + eps)).mean()


def cross_entropy_loss(pred, mask, num_object, bootstrap=0.4, ref=None):
    """Bootstrapped cross entropy of softmaxed probabilities (loss.py:34-59):
    per pixel the sum over channels [0, num_object] of -log(pred) * mask
    (a channel zeroed where its ``ref`` has no foreground), then the mean
    of the hardest ``bootstrap`` share of each sample's pixels."""
    N, _, H, W = mask.shape
    ce = -torch.log(pred.float())[:, :num_object + 1] * mask[
        :, :num_object + 1].float()
    if ref is not None:
        valid = (ref.reshape(ref.shape[0], ref.shape[1], -1).sum(-1)
                 > 0).float()
        ce = ce * valid[:, :, None, None]
    per_pixel = ce.sum(1).reshape(N, -1)
    return per_pixel.topk(int(H * W * bootstrap), dim=1).values.mean()


def smooth_l1_loss(pred, target, gamma=0.075):
    """The reference's smooth-L1 (loss.py:79-83) with its in-place quirk:
    the second masked assignment tests the difference after the first
    shrank the entries above gamma, so |d| in (gamma, 1.5 gamma] takes both
    branches, (|d| - gamma/2)^2 / (2 gamma)."""
    d = (pred.float() - target.float()).abs()
    d1 = torch.where(d > gamma, d - gamma / 2, d)
    return torch.where(d1 <= gamma, d1 * d1 / (2 * gamma), d1).mean()
