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
steps 1..``profile_steps`` (``utils.profiling.trace``).

With a ``mesh`` (``parallel.mesh``; one process per rank) it trains data
parallel over the mesh's ``data`` axis: the train loader gives each data
rank its block of every batch, and the steps average the gradients and
reduce the metrics (``train/loop.py``); a ``seq`` axis shards the Mamba
scans of the model built on the same mesh.  ``zero`` shards the parameters
and AdamW moments over ``data`` (``parallel/fsdp.py``), after the weight
grafts, when ``fit`` starts.  Every rank runs the epoch loop, the
validation and the checkpoint pick in lockstep; only rank 0 writes the
checkpoints (whole, in the one-card layout) and ``metrics.jsonl``.
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
from vivim_tpu_torch.parallel import comm
from vivim_tpu_torch.parallel.fsdp import shard_state_fsdp
from vivim_tpu_torch.parallel.mesh import replicate
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
    zero: bool = False  # ZeRO: shard params + AdamW moments over 'data'
    device: str = "cuda"


class Trainer:
    def __init__(self, model, cfg: TrainerConfig, train_loader, val_loader,
                 ckpt_dir: str, logger: MetricLogger, mesh=None,
                 with_edge: bool = False, edge_loss_fn=None):
        dp = mesh.size("data") if mesh is not None else 1
        if cfg.zero and dp <= 1:
            # a silently ignored parallelism flag reads as a working config
            raise ValueError(
                "zero=True shards params + optimizer moments over the "
                f"'data' mesh axis, but this run has {dp} 'data' "
                "device(s) — pass -n_devices N (N > 1) or drop -zero")
        if getattr(train_loader, "process_count", dp) != dp:
            raise ValueError(
                f"the train loader splits its batches over "
                f"{train_loader.process_count} process(es), the mesh over "
                f"{dp} data rank(s)")
        self.device = resolve_device(cfg.device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.mesh = mesh
        self.is_main = mesh is None or mesh.is_main
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.logger = logger
        self.ckpt = CheckpointManager(
            ckpt_dir, monitor=cfg.monitor, mode=cfg.monitor_mode,
            top_k=cfg.top_k)
        self.total_steps = cfg.epochs * max(len(train_loader), 1)
        self.state = loop_lib.create_train_state(
            self.model, cfg.lr, cfg.weight_decay, self.total_steps,
            self._seed(cfg.seed), decay_mask=cfg.decay_mask)
        self.lr_schedule = self.state.opt.schedule
        compute_dtype = torch.bfloat16 if cfg.bf16 else None
        edge_loss_fn = edge_loss_fn if with_edge else None
        self.train_step = loop_lib.make_train_step(
            self.model, cfg.loss, cfg.num_classes,
            compute_dtype=compute_dtype, grad_accum=cfg.grad_accum,
            edge_loss_fn=edge_loss_fn, mesh=mesh)
        self.eval_step = loop_lib.make_eval_step(
            self.model, cfg.loss, cfg.num_classes, with_edge=with_edge,
            compute_dtype=compute_dtype, edge_loss_fn=edge_loss_fn,
            mesh=mesh)
        self.epoch = 0
        self.preempted = False
        self._skip_batches = 0  # mid-epoch resume: batches already consumed
        self._placed = mesh is None and not cfg.zero

    def _seed(self, seed):
        """The generator seed of this rank (the data rank folded in)."""
        return seed if self.mesh is None else self.mesh.fold_seed(seed)

    def _place(self):
        """Once, before the first step and after the weight grafts: every
        rank starts from rank 0's weights; ``zero`` shards the state."""
        if self._placed:
            return
        replicate(self.model, self.mesh)
        if self.cfg.zero:
            shard_state_fsdp(self.state, self.mesh)
        self._placed = True

    def _whole(self):
        """The whole state on every rank for the body (ZeRO gathers it)."""
        return (self.state.zero.full() if self.state.zero is not None
                else contextlib.nullcontext())

    def _log(self, metrics, step):
        if self.is_main:
            self.logger.log(metrics, step=step)

    def _agree(self, flag: bool) -> bool:
        """Whether any rank raised ``flag`` (every rank gets the answer)."""
        if self.mesh is None:
            return flag
        t = torch.tensor([float(flag)], device=self.device)
        return bool(comm.all_reduce_sum(t, comm.world()) > 0)

    def _save(self, metrics) -> bool:
        """Rank 0 writes ``last`` (and ``best`` when it ranks); every rank
        gets its answer."""
        with self._whole():
            saved = (self.ckpt.save(self.state, self.state.step, metrics)
                     if self.is_main else False)
        return self._agree(saved)

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
        self._place()
        with self._whole():
            self.state = self.ckpt.restore(self.state, path)
        if self.mesh is not None and self.mesh.index("data") > 0:
            # the checkpoint holds data rank 0's generator
            self.state.generator.manual_seed(
                self._seed(self.cfg.seed + self.state.step))
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
                if self._agree(self.preempted):
                    self.preempted = True
                    break
                n_frames += (batch["clip"].shape[0] * batch["clip"].shape[1]
                             * (self.mesh.size("data") if self.mesh else 1))
                self.state, metrics = self.train_step(
                    self.state, self._device_batch(batch))
                losses.append(metrics["loss"])
                jaccs.append(metrics["jaccard"])
                if i % self.cfg.log_every == 0:
                    self._log(
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
        self._log(epoch_metrics, step=self.state.step)
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
        self._log(metrics, step=self.state.step)
        if self.is_main:
            self.logger.log_confusion_matrix(
                cm, [f"class_{i}" for i in range(nc)], step=self.state.step)
        return metrics, results, cm

    def fit(self, resume_path: str | None = None):
        self._place()
        if resume_path:
            self.resume(resume_path)
        best = None
        prev_handlers = self._install_preemption_handlers()
        try:
            while self.epoch < self.cfg.epochs:
                em = self.train_epoch()
                if self.preempted:
                    # a resumable 'last' (no metrics: no best-score update)
                    self._save({})
                    print(f"[trainer] preempted at step {self.state.step} "
                          f"(epoch {self.epoch}): checkpoint saved, exiting")
                    break
                metrics = dict(em)
                if ((self.epoch + 1) % self.cfg.val_freq == 0
                        and len(self.val_loader) > 0):
                    vm, _, _ = self.validate()
                    metrics.update(vm)
                self.epoch += 1
                if self._save(metrics):
                    best = metrics.get(self.cfg.monitor)
        finally:
            for sig, h in prev_handlers.items():
                signal.signal(sig, h)
        return best

