"""Binary (lesion / background) training steps and threshold-sweep eval.

Port of the JAX package's ``train/binary.py``, with the reference's
semantics (complements/train_binary.py):

- Adam (no weight decay, no gradient clipping, :133) with a per-step cosine
  down to lr * 0.01 (:136);
- the loss covers the CENTER frame only (``pred[nFrames//2::nFrames]``,
  :187): ``structure_loss``, or the joint edge loss with the edge head;
- validation (:205-335): center-frame predictions swept over 256
  thresholds (the Medical curves) plus S-measure, E-measure, MAE and the
  weighted F-measure, in numpy on the host.

The step runs in fp32: the JAX binary step has no compute dtype.  With a
``mesh`` the steps are data parallel as ``train/loop.py``'s: the train
step takes this rank's block and averages the gradients over ``data``; the
eval step takes the whole batch, runs this rank's block when the batch
divides, and gathers the predictions, so ``BinaryValidator`` sees the
whole batch on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from vivim_tpu_torch.nn.layers import use_generator
from vivim_tpu_torch.parallel import comm
from vivim_tpu_torch.train.loop import (
    AdamW,
    average_grads,
    data_group,
    gathered,
    split_eval_batch,
)
from vivim_tpu_torch.train.losses import batch_group, structure_loss


def make_binary_optimizer(model, lr, total_steps, eta_min_ratio=0.01):
    """``optax.adam(cosine_decay_schedule(lr, total_steps, eta_min_ratio),
    b1=0.9, b2=0.999)`` over ``model``'s parameters: the port's AdamW at
    weight decay 0 without clipping.  Returns (optimizer, schedule)."""
    tx = AdamW(model, lr, 0.0, total_steps, eta_min_ratio, clip_norm=None)
    return tx, tx.schedule


def center_frames(x, nframes):
    """(B, T, ...) -> (B, ...) center frame (train_binary.py:187)."""
    return x[:, nframes // 2]


def make_binary_train_step(model, edge_loss_fn=None, grad_accum: int = 1,
                           mesh=None):
    """Returns ``step(state, batch) -> (state, {"loss"})``.

    ``batch``: clip (B, T, H, W, 3) and masks (B, T, H, W, 1) [, edges
    (B, T, H, W, 1)], tensors on the model's device.  The loss is the center
    frame's ``structure_loss``; with the model's edge head and
    ``edge_loss_fn`` (e.g. ``edge_loss.make_joint_edge_seg_loss()``) it is
    ``edge_loss_fn(pred, mask, edge, edges)`` on the center frame instead.
    ``grad_accum``: contiguous micro-batches, gradients and losses
    averaged, the BatchNorm statistics threaded through them in turn, one
    update.  The random layers draw from the state's generator.  ``mesh``:
    data parallel over its ``data`` axis (``batch`` is this rank's
    block)."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    with_edge = model.cfg.with_edge
    group = data_group(mesh)

    def compute_loss(clip, masks, edges):
        T = clip.shape[1]
        out = model(clip)
        logits5, edge5 = out if with_edge else (out, None)
        pred = center_frames(logits5, T)       # (B, H, W, 1)
        mask = center_frames(masks, T)
        if with_edge and edge_loss_fn is not None:
            return edge_loss_fn(pred, mask, center_frames(edge5, T),
                                center_frames(edges, T))
        return structure_loss(pred, mask)

    def step(state, batch):
        clip, masks = batch["clip"], batch["masks"]
        B = clip.shape[0]
        if B % grad_accum:
            raise ValueError(
                f"batch size {B} not divisible by grad_accum={grad_accum}")
        model.train()
        use_generator(model, state.generator)
        model.stats_group = group
        for p in model.parameters():
            p.grad = None
        mb = B // grad_accum
        loss_sum = 0.0
        with gathered(state), batch_group(group):
            for i in range(grad_accum):
                part = slice(i * mb, (i + 1) * mb)
                edges = batch["edges"][part] if "edges" in batch else None
                loss = compute_loss(clip[part], masks[part], edges)
                (loss / grad_accum).backward()
                loss_sum = loss_sum + loss.detach()
            average_grads(state, mesh)
        state.opt.step()
        state.step += 1
        if group is not None:
            loss_sum = comm.all_reduce_sum(loss_sum.reshape(1), group)[0] / (
                comm.size(group))
        return state, {"loss": loss_sum / grad_accum}

    return step


def make_binary_eval_step(model, mesh=None):
    """Returns ``step(state, batch) -> (loss, pred, mask)``: the center
    frame's structure loss, its sigmoid (B, H, W, 1) and its mask, on the
    device.  ``mesh``: the whole batch's, from this rank's block."""
    group = data_group(mesh)

    def step(state, batch):
        model.eval()
        batch, blocked = split_eval_batch(batch, mesh)
        with gathered(state), torch.inference_mode(), \
                batch_group(group if blocked else None):
            out = model(batch["clip"])
            logits5 = out[0] if model.cfg.with_edge else out
            T = batch["clip"].shape[1]
            logits = center_frames(logits5, T)
            mask = center_frames(batch["masks"], T)
            res = (structure_loss(logits, mask), torch.sigmoid(logits), mask)
            if blocked:
                n = comm.size(group)
                res = (comm.all_reduce_sum(res[0].reshape(1), group)[0] / n,
                       comm.all_gather(res[1], group).flatten(0, 1),
                       comm.all_gather(res[2], group).flatten(0, 1))
            return res

    return step


class BinaryValidator:
    """Threshold-sweep validation (train_binary.py:205-335): Medical
    Sen/Spe/Dice/IoU curves, S-measure, E-measure, MAE and weighted
    F-measure over center-frame predictions (tensors, from
    ``make_binary_eval_step``), on the host: one copy of the predictions
    and one of the masks per batch."""

    def __init__(self):
        from vivim_tpu_torch.train import saliency_metrics as SM

        self.medical = SM.Medical()
        self.sm = SM.Smeasure()
        self.em = SM.Emeasure()
        self.mae = SM.MAE()
        self.wfm = SM.WeightedFmeasure()
        self.losses = []

    def update(self, loss, preds, masks):
        self.losses.append(float(loss))
        preds = preds.float().cpu().numpy()[..., 0]
        masks = masks.float().cpu().numpy()[..., 0]
        for p, g in zip(preds, masks):
            self.medical.step(p, g)
            self.sm.step(p, g)
            self.em.step(p, g)
            self.mae.step(p, g)
            self.wfm.step(p, g)

    def results(self):
        med = self.medical.get_results()
        return {
            "val/loss": float(np.mean(self.losses)) if self.losses else 0.0,
            "val/dice": med["maxDice"],
            "val/iou": med["maxIoU"],
            "val/Smeasure": self.sm.get_results()["Smeasure"],
            "val/Emeasure": self.em.get_results()["meanEm"],
            "val/MAE": self.mae.get_results()["MAE"],
            "val/wFmeasure": self.wfm.get_results()["wFmeasure"],
        }
