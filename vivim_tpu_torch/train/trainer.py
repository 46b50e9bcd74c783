"""Epoch-level trainer (the reference's Lightning ``CoolSystem`` +
``Trainer``, multiclass_training_folds.py:449-817).

Port of the JAX package's ``train/trainer.py``:
- epoch loop with validation every ``val_freq`` epochs;
- validation: loss, micro Jaccard, macro Dice, the presence-gated
  per-class tracker and the aggregated confusion matrix, counted on the
  device;
- checkpoints on the monitored metric (val/dice max top-1 for CV,
  train/loss min top-3 for the final retrain) and ``resume``;
- the learning rate logged per epoch;
- ``set_epoch`` on loaders that re-draw their clips per epoch;
- preemption: SIGTERM / SIGINT set a flag checked between steps; the
  trainer saves ``last_<step>`` and returns, and ``resume`` continues.

It runs on ``TrainerConfig.device``, CUDA unless the caller asks for the
CPU.  ``profile_dir`` writes a torch.profiler trace of the first epoch's
steps 1..``profile_steps`` (``utils.profiling.trace``).  The parallel paths
(``zero``, a mesh) are ROADMAP M12 and raise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import signal
import threading
import time

import numpy as np
import torch

from vivim_tpu_torch.cli.common import resolve_device
from vivim_tpu_torch.train import loop as loop_lib
from vivim_tpu_torch.train.checkpoints import CheckpointManager
from vivim_tpu_torch.train.logging import MetricLogger
from vivim_tpu_torch.train.metrics import MulticlassMetricsTracker
from vivim_tpu_torch.utils.profiling import trace


@dataclasses.dataclass
class TrainerConfig:
    epochs: int = 50
    val_freq: int = 1
    lr: float = 1e-4
    weight_decay: float = 1e-2
    num_classes: int = 3
    loss: str = "recall_focused"
    monitor: str = "val/dice"
    monitor_mode: str = "max"
    top_k: int = 1
    log_every: int = 10
    seed: int = 42
    bf16: bool = False  # cast-params mixed precision (fp32 scan state kept)
    grad_accum: int = 1  # micro-batch gradient accumulation per step
    decay_mask: str = "tagged"  # "torch" = decay all params (ref parity)
    profile_dir: str | None = None  # torch.profiler trace of early steps
    profile_steps: int = 5
    zero: bool = False  # ZeRO / FSDP: ROADMAP M12, raises
    device: str = "cuda"


class Trainer:
    def __init__(self, model, cfg: TrainerConfig, train_loader, val_loader,
                 ckpt_dir: str, logger: MetricLogger, mesh=None,
                 with_edge: bool = False, edge_loss_fn=None):
        if cfg.zero or mesh is not None:
            raise NotImplementedError(
                "the parallel training paths (zero, a mesh) are ROADMAP M12")
        self.device = resolve_device(cfg.device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.logger = logger
        self.ckpt = CheckpointManager(
            ckpt_dir, monitor=cfg.monitor, mode=cfg.monitor_mode,
            top_k=cfg.top_k)
        self.total_steps = cfg.epochs * max(len(train_loader), 1)
        self.state = loop_lib.create_train_state(
            self.model, cfg.lr, cfg.weight_decay, self.total_steps, cfg.seed,
            decay_mask=cfg.decay_mask)
        self.lr_schedule = self.state.opt.schedule
        compute_dtype = torch.bfloat16 if cfg.bf16 else None
        edge_loss_fn = edge_loss_fn if with_edge else None
        self.train_step = loop_lib.make_train_step(
            self.model, cfg.loss, cfg.num_classes,
            compute_dtype=compute_dtype, grad_accum=cfg.grad_accum,
            edge_loss_fn=edge_loss_fn)
        self.eval_step = loop_lib.make_eval_step(
            self.model, cfg.loss, cfg.num_classes, with_edge=with_edge,
            compute_dtype=compute_dtype, edge_loss_fn=edge_loss_fn)
        self.epoch = 0
        self.preempted = False
        self._skip_batches = 0  # mid-epoch resume: batches already consumed

    def _install_preemption_handlers(self):
        """SIGTERM / SIGINT -> flag (main thread only); returns the previous
        handlers for restoration."""
        if threading.current_thread() is not threading.main_thread():
            return {}

        def _flag(signum, frame):
            self.preempted = True
            print(f"[trainer] caught signal {signum}: finishing the current "
                  "step, checkpointing, and exiting cleanly")

        return {sig: signal.signal(sig, _flag)
                for sig in (signal.SIGTERM, signal.SIGINT)}

    def resume(self, path: str | None = None):
        self.state = self.ckpt.restore(self.state, path)
        spe = max(len(self.train_loader), 1)
        self.epoch = self.state.step // spe
        # a mid-epoch checkpoint (preemption): the loader's per-epoch order
        # is deterministic, so skipping the consumed prefix continues it
        self._skip_batches = self.state.step - self.epoch * spe
        print(f"[trainer] resumed at step {self.state.step} (epoch "
              f"{self.epoch}" + (f", skipping {self._skip_batches} consumed "
                                 "batches" if self._skip_batches else "")
              + ")")

    def _device_batch(self, batch):
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items() if k != "paths"}

    def train_epoch(self):
        if hasattr(self.train_loader, "set_epoch"):
            self.train_loader.set_epoch(self.epoch)
        skip, self._skip_batches = self._skip_batches, 0
        losses, jaccs = [], []
        t0 = time.time()
        n_frames = 0
        # the trace of steps 1..profile_steps (the first is warm-up); it
        # closes at the window's end or, in a shorter epoch, with the loop
        prof = contextlib.ExitStack()
        with prof:
            for i, batch in enumerate(self.train_loader):
                if i < skip:
                    continue
                if self.epoch == 0 and self.cfg.profile_dir is not None:
                    if i == 1:
                        prof.enter_context(trace(self.cfg.profile_dir))
                    elif i == 1 + self.cfg.profile_steps:
                        prof.close()
                if self.preempted:
                    break
                n_frames += batch["clip"].shape[0] * batch["clip"].shape[1]
                self.state, metrics = self.train_step(
                    self.state, self._device_batch(batch))
                losses.append(metrics["loss"])
                jaccs.append(metrics["jaccard"])
                if i % self.cfg.log_every == 0:
                    self.logger.log(
                        {"train/loss": float(metrics["loss"]),
                         "train/jaccard": float(metrics["jaccard"]),
                         "train/grad_norm": float(metrics["grad_norm"])},
                        step=self.state.step)
        mean = lambda xs: float(torch.stack(xs).mean()) if xs else 0.0
        epoch_metrics = {"train/loss": mean(losses),
                         "train/jaccard": mean(jaccs)}
        epoch_metrics["train/lr"] = self.lr_schedule(self.state.step)
        epoch_metrics["train/frames_per_sec"] = n_frames / max(
            time.time() - t0, 1e-9)
        self.logger.log(epoch_metrics, step=self.state.step)
        return epoch_metrics

    def validate(self):
        nc = self.cfg.num_classes
        tracker = MulticlassMetricsTracker(nc)
        cm = np.zeros((nc, nc), np.int64)
        losses = []
        for batch in self.val_loader:
            # counted on the device: only the (B*T, C, 4) counters and the
            # (C, C) matrix come to the host
            loss, conf, cm_b = self.eval_step(self.state,
                                              self._device_batch(batch))
            losses.append(float(loss))
            tracker.update_from_confusion(conf.cpu().numpy())
            cm += cm_b.cpu().numpy().astype(np.int64)
        results = tracker.get_results()
        # micro Jaccard (torchmetrics MulticlassJaccardIndex "micro") and
        # macro Dice over the classes present in GT or prediction
        # (torchmetrics DiceScore "macro", the checkpoint monitor)
        tps = np.diag(cm).astype(np.float64)
        fps = cm.sum(0) - tps
        fns = cm.sum(1) - tps
        denom = 2 * tps + fps + fns
        present = denom > 0
        metrics = {
            "val/loss": float(np.mean(losses)) if losses else 0.0,
            "val/jacc": float(tps.sum() / max((tps + fps + fns).sum(), 1)),
            "val/dice": (float(np.mean(2 * tps[present] / denom[present]))
                         if present.any() else 0.0),
            "val/accuracy": float(tps.sum() / max(cm.sum(), 1)),
        }
        for m in tracker.TRACKED:
            metrics[f"val/{m}_mean"] = results[m]["mean"]
            for c, v in enumerate(results[m]["per_class"]):
                if v is not None:
                    metrics[f"val/{m}_class{c}"] = v
        self.logger.log(metrics, step=self.state.step)
        self.logger.log_confusion_matrix(
            cm, [f"class_{i}" for i in range(nc)], step=self.state.step)
        return metrics, results, cm

    def fit(self, resume_path: str | None = None):
        if resume_path:
            self.resume(resume_path)
        best = None
        prev_handlers = self._install_preemption_handlers()
        try:
            while self.epoch < self.cfg.epochs:
                em = self.train_epoch()
                if self.preempted:
                    # a resumable 'last' (no metrics: no best-score update)
                    self.ckpt.save(self.state, self.state.step, {})
                    print(f"[trainer] preempted at step {self.state.step} "
                          f"(epoch {self.epoch}): checkpoint saved, exiting")
                    break
                metrics = dict(em)
                if ((self.epoch + 1) % self.cfg.val_freq == 0
                        and len(self.val_loader) > 0):
                    vm, _, _ = self.validate()
                    metrics.update(vm)
                self.epoch += 1
                if self.ckpt.save(self.state, self.state.step, metrics):
                    best = metrics.get(self.cfg.monitor)
        finally:
            for sig, h in prev_handlers.items():
                signal.signal(sig, h)
        return best

