"""Train and eval steps and the optimizer.

Port of the JAX package's ``train/loop.py``.  Training semantics are the
reference harness's (multiclass_training_folds.py):

- AdamW (betas 0.9 / 0.999, eps 1e-8) after global-norm gradient clipping
  at 1.0, with a per-step cosine from ``lr`` down to ``lr * eta_min_ratio``
  over the run (``optax.cosine_decay_schedule``; the first update uses
  ``lr``);
- the loss covers every clip frame: (B, T, H, W, C) logits and one-hot
  masks flatten to (B*T, ...), targets are the masks' argmax;
- the train metric is the micro Jaccard over the flattened frames.

PyTorch runs eagerly, so a "step" is a plain function that updates the
``TrainState`` in place (the model's parameters and BatchNorm statistics,
the optimizer moments, the step count) and returns it with its metrics.
The random layers draw from the state's generator, which the step hands to
the model (``nn.layers.use_generator``).

Data parallel (a ``mesh`` with a ``data`` axis of more than one rank, one
process per rank): each rank's train step takes its own block of the
global batch, the train-mode decode BatchNorm and the losses' batch-wide
counts (``losses.batch_group``) take their statistics over the axis, the
gradients are averaged over it (a sequence-sharded layer's first summed
over its ``seq`` row, ``average_grads``) before the global-norm clip (once
per step, after the micro-batches), and the metrics are the global
batch's.  A ZeRO state (``state.zero``, ``parallel/fsdp.py``) gathers its
parameters for the step and keeps only its slices after it.  The eval step
takes the whole batch and runs this rank's block of it when the batch
divides over the axis (else every rank runs it whole), and returns the
whole batch's loss and counters.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable

import torch
from torch import nn

from vivim_tpu_torch.nn.layers import use_generator
from vivim_tpu_torch.parallel import comm
from vivim_tpu_torch.parallel.mesh import shard_batch
from vivim_tpu_torch.train import losses as losses_lib
from vivim_tpu_torch.train.metrics import confusion_matrix, per_class_confusion
from vivim_tpu_torch.utils.profiling import span

# the JAX package's name for the device-side confusion matrix
confusion_matrix_device = confusion_matrix


def _no_decay_mask(model: nn.Module, decay_mask: str = "tagged"):
    """{parameter name: whether AdamW decays it}.  "tagged": 2-D and wider
    weights only (no biases, norms, D, A_log: torch AdamW's usual groups
    plus mamba's ``_no_weight_decay`` tags), the parameters the JAX
    package's mask decays under the key mapping of ``convert/from_jax.py``
    (the torch conv1d weight is 3-D where the JAX kernel is 2-D: both are
    decayed).  "torch": every parameter, as the reference's AdamW without
    parameter groups does."""
    if decay_mask not in ("tagged", "torch"):
        raise ValueError(f"decay_mask must be 'tagged' or 'torch', "
                         f"got {decay_mask!r}")
    out = {}
    for name, p in model.named_parameters():
        last = name.split(".")[-1]
        out[name] = decay_mask == "torch" or (
            p.dim() >= 2 and not ("A" in last and last.endswith("_log")))
    return out


def cosine_lr(lr: float, total_steps: int, eta_min_ratio: float, step: int):
    """``optax.cosine_decay_schedule(lr, max(total_steps, 1),
    eta_min_ratio)`` at ``step``."""
    total = max(total_steps, 1)
    frac = min(step, total) / total
    return lr * ((1.0 - eta_min_ratio) * 0.5 * (1.0 + math.cos(math.pi * frac))
                 + eta_min_ratio)


class AdamW:
    """``optax.chain(clip_by_global_norm(clip_norm), adamw(cosine, b1=0.9,
    b2=0.999, eps=1e-8, weight_decay, mask, mu_dtype))`` over a model's
    parameters, with torch's multi-tensor ops.  ``clip_norm=None`` clips
    nothing and, at weight decay 0, is ``optax.adam`` (the binary
    pipeline's).  ``mu_dtype`` (e.g. ``torch.bfloat16``) stores the first
    moment in that dtype; the second stays fp32.  Parameters without a
    gradient are skipped."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, model: nn.Module, lr: float, weight_decay: float,
                 total_steps: int, eta_min_ratio: float = 0.01,
                 clip_norm: float = 1.0, decay_mask: str = "tagged",
                 mu_dtype=None):
        decays = _no_decay_mask(model, decay_mask)
        self.names = [n for n, p in model.named_parameters()
                      if p.requires_grad]
        params = dict(model.named_parameters())
        self.params = [params[n] for n in self.names]
        self.decays = [decays[n] for n in self.names]
        self.lr, self.weight_decay = lr, weight_decay
        self.total_steps, self.eta_min_ratio = total_steps, eta_min_ratio
        self.clip_norm = clip_norm
        self.mu_dtype = mu_dtype
        self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype)
                   for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        # (per-leaf norms, live indices) -> global norm; None: the norm of
        # the leaves here (ZeRO sums its slices' over the data axis)
        self.reduce_norm = None

    def schedule(self, step: int) -> float:
        return cosine_lr(self.lr, self.total_steps, self.eta_min_ratio, step)

    @torch.no_grad()
    def step(self):
        """Clip, update every parameter that has a gradient; returns the
        global gradient norm before clipping (a 0-dim tensor), or None
        without clipping."""
        live = [i for i, p in enumerate(self.params) if p.grad is not None]
        params = [self.params[i] for i in live]
        grads = [p.grad for p in params]
        norm = None
        if self.clip_norm is not None:
            norms = torch.stack([g.float() for g in torch._foreach_norm(grads)])
            norm = (torch.linalg.vector_norm(norms) if self.reduce_norm is None
                    else self.reduce_norm(norms, live))
            # optax scales by max/norm only when norm > max: the factor is 1
            torch._foreach_mul_(grads, self.clip_norm
                                / torch.clamp(norm, min=self.clip_norm))
        lr = self.schedule(self.count)
        self.count += 1
        mu = [self.mu[i].float() for i in live]  # the fp32 ones themselves
        nu = [self.nu[i] for i in live]
        torch._foreach_lerp_(mu, grads, 1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        if self.mu_dtype is not None:
            # stored in mu_dtype, and the update uses the stored value
            for i, m in zip(live, mu):
                self.mu[i].copy_(m)
            mu = [self.mu[i].float() for i in live]
        denom = torch._foreach_sqrt(nu)
        torch._foreach_div_(denom, math.sqrt(1.0 - self.b2 ** self.count))
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, denom)
        torch._foreach_div_(upd, 1.0 - self.b1 ** self.count)
        decayed = [j for j, i in enumerate(live) if self.decays[i]]
        if decayed and self.weight_decay:
            torch._foreach_add_([upd[j] for j in decayed],
                                [params[j] for j in decayed],
                                alpha=self.weight_decay)
        torch._foreach_add_(params, upd, alpha=-lr)
        return norm

    def state_dict(self):
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, sd):
        self.count = int(sd["count"])
        for dst, src in zip(self.mu + self.nu, list(sd["mu"]) + list(sd["nu"])):
            dst.copy_(src)


def make_optimizer(model, lr: float, weight_decay: float, total_steps: int,
                   eta_min_ratio: float = 0.01, clip_norm: float = 1.0,
                   decay_mask: str = "tagged", mu_dtype=None):
    """The optimizer and its learning-rate schedule (step -> lr)."""
    tx = AdamW(model, lr, weight_decay, total_steps, eta_min_ratio,
               clip_norm, decay_mask, mu_dtype)
    return tx, tx.schedule


@dataclasses.dataclass
class TrainState:
    """What a train step updates: the model (parameters and BatchNorm
    statistics), the optimizer, the step count, and the generator every
    random layer draws from."""

    step: int
    model: nn.Module
    opt: AdamW
    generator: torch.Generator
    zero: object = None  # parallel.fsdp.Zero when the state is ZeRO-sharded


def create_train_state(model, lr, weight_decay, total_steps, seed: int,
                       decay_mask="tagged", mu_dtype=None):
    """A fresh TrainState around ``model`` (already initialised and on its
    device); the generator lives on the same device, seeded from ``seed``."""
    dev = next(model.parameters()).device
    tx, _ = make_optimizer(model, lr, weight_decay, total_steps,
                           decay_mask=decay_mask, mu_dtype=mu_dtype)
    return TrainState(step=0, model=model, opt=tx,
                      generator=torch.Generator(dev).manual_seed(seed))


def jaccard_counts(logits, targets, num_classes):
    """Summed (tp, fp, fn) over all classes as a (3,) fp32 vector: the
    sufficient statistic of micro Jaccard, additive over micro-batches."""
    preds = logits.argmax(-1)
    tp = fp = fn = 0
    for c in range(num_classes):
        p = preds == c
        g = targets == c
        tp = tp + (p & g).sum()
        fp = fp + (p & ~g).sum()
        fn = fn + (~p & g).sum()
    return torch.stack([tp, fp, fn]).float()


def micro_jaccard(logits, targets, num_classes):
    """Micro-averaged multiclass Jaccard (torchmetrics semantics)."""
    tp, fp, fn = jaccard_counts(logits, targets, num_classes)
    return tp / torch.clamp(tp + fp + fn, min=1)


def flatten_frames(logits, masks):
    """(B, T, H, W, C) logits and one-hot masks -> (B*T, H, W, C) logits
    and (B*T, H, W) integer targets."""
    B, T, H, W, C = logits.shape
    return (logits.reshape(B * T, H, W, C),
            masks.argmax(-1).reshape(B * T, H, W))


def cast_floating(params, dtype):
    """{name: tensor}: fp32 tensors cast to ``dtype`` (through autograd, so
    the fp32 masters get the gradients), the rest as they are."""
    return {k: v.to(dtype) if v.dtype == torch.float32 else v
            for k, v in params.items()}


def _forward(model, clip, compute_dtype):
    """The model on ``clip``; with ``compute_dtype``, on copies of its fp32
    parameters cast to that dtype (the JAX package's ``cast_floating``:
    A_log, D and dt_bias are cast too, and the Mamba code lifts them back to
    fp32).  Buffers (BatchNorm statistics) stay the model's own fp32."""
    if compute_dtype is None:
        return model(clip)
    params = cast_floating(dict(model.named_parameters()), compute_dtype)
    return torch.func.functional_call(model, params, (clip.to(compute_dtype),))


def _split_edge(model, out, edge_loss_fn):
    """(logits, edge logits or None) of a forward's output; an edge head
    trains only with an edge loss, and an edge loss needs the head."""
    with_edge = getattr(model.cfg, "with_edge", False)
    if with_edge != (edge_loss_fn is not None):
        raise ValueError(
            "the model's edge head and the edge loss come together: "
            f"with_edge={with_edge}, edge_loss_fn="
            f"{'set' if edge_loss_fn is not None else 'None'}")
    return out if with_edge else (out, None)


def data_group(mesh):
    """The process group of ``mesh``'s ``data`` axis, or None (one rank)."""
    return mesh.group("data") if mesh is not None else None


@contextlib.contextmanager
def gathered(state):
    """The model's parameters whole for the body (a ZeRO state gathers
    them, and frees them after)."""
    if state.zero is None:
        yield
        return
    state.zero.gather()
    try:
        yield
    finally:
        state.zero.release()


def seq_partial_parameters(model):
    """Ids of the parameters whose gradient on this rank is only its token
    shard's part (the sequence-sharded Mamba layers' of the last forward,
    ``MambaLayer.seq_partial_parameters``)."""
    return {id(p) for m in model.modules()
            if hasattr(m, "seq_partial_parameters")
            for p in m.seq_partial_parameters()}


def average_grads(state, mesh):
    """Reduce the gradients over every rank of ``mesh`` in one all_reduce
    (ZeRO: into each rank's slices): a gradient of which each rank of a
    ``seq`` row holds only its token shard's part (``seq_partial_
    parameters``) is summed over the row and averaged over ``data``; every
    other one, whole on each rank of the row (a replicated layer's, or the
    scan's A, D and dt bias, which the scan summed itself), is averaged
    over every rank, which over ``data`` is data parallel's mean and over
    ``seq`` keeps the row's copies bitwise equal where the card's
    non-deterministic backward kernels (atomic sums) let them drift
    apart."""
    group = comm.world() if mesh is not None else None
    n = comm.size(group)
    partial = seq_partial_parameters(state.model)
    n_data = n // mesh.size("seq") if mesh is not None else 1
    divisor = lambda p: n_data if id(p) in partial else n
    if state.zero is not None:
        state.zero.reduce_grads(group, divisor)
    elif n > 1:
        live = [p for p in state.opt.params if p.grad is not None]
        comm.all_reduce_mean_([p.grad for p in live], group,
                              [divisor(p) for p in live])


def split_eval_batch(batch, mesh):
    """(this rank's rows of an eval batch, whether they are a block): the
    whole batch when it does not divide over the data axis."""
    n = mesh.size("data") if mesh is not None else 1
    if n == 1 or batch["clip"].shape[0] % n:
        return batch, False
    return shard_batch(batch, mesh), True


def make_train_step(model, loss_fn: Callable | str = "recall_focused",
                    num_classes: int = 3, compute_dtype=None,
                    grad_accum: int = 1, edge_loss_fn=None, mesh=None):
    """Returns ``step(state, batch) -> (state, metrics)``.

    ``batch``: clip (B, T, H, W, 3) and one-hot masks (B, T, H, W, C)
    [, edges (B, T, H, W, 1)], tensors on the model's device.
    ``edge_loss_fn``: fn(seg_logits, seg_masks, edge_logits, edge_masks) on
    the (B, T, ...) tensors (e.g. ``edge_loss.make_multiclass_edge_
    criterion()``), added to the all-frames loss; the model must have the
    edge head then, and only then.  ``compute_dtype``: e.g. torch.bfloat16
    for cast-parameter mixed precision (fp32 masters, losses and scan
    state).  ``grad_accum``: the batch splits into that many contiguous
    micro-batches; their gradients and losses are averaged, their Jaccard
    counts summed, the BatchNorm statistics thread through them in turn,
    and one optimizer update follows.  Metrics: ``loss``, ``jaccard``,
    ``grad_norm`` (before clipping), as 0-dim tensors.  ``mesh``: data
    parallel over its ``data`` axis (see the module docstring): ``batch``
    is this rank's block, and its micro-batches are its blocks of the
    global ones (``DataLoader(micro_batches=grad_accum)``).  Spans
    (``utils/profiling.py::span``): ``train.step`` holds each
    micro-batch's ``train.forward`` (forward, loss, counts) and
    ``train.backward``, then ``train.optimizer`` (the gradients' reduction,
    the clip and AdamW).
    """
    if isinstance(loss_fn, str):
        loss_fn = losses_lib.LOSSES[loss_fn]
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    group = data_group(mesh)

    def step(state: TrainState, batch):
        clip, masks = batch["clip"], batch["masks"]
        B = clip.shape[0]
        if B % grad_accum:
            raise ValueError(
                f"batch size {B} not divisible by grad_accum={grad_accum}")
        with span("train.step"), contextlib.ExitStack() as opt_span:
            model.train()
            use_generator(model, state.generator)
            model.stats_group = group
            for p in model.parameters():
                p.grad = None
            mb = B // grad_accum
            loss_sum = 0.0
            counts = 0.0
            with gathered(state), losses_lib.batch_group(group):
                for i in range(grad_accum):
                    part = slice(i * mb, (i + 1) * mb)
                    with span("train.forward"):
                        logits5, edge5 = _split_edge(
                            model, _forward(model, clip[part], compute_dtype),
                            edge_loss_fn)
                        logits, targets = flatten_frames(logits5, masks[part])
                        loss = loss_fn(logits, targets, num_classes)
                        if edge5 is not None:
                            # the losses cast to fp32 themselves, as in the
                            # JAX step
                            loss = loss + edge_loss_fn(
                                logits5, masks[part], edge5,
                                batch["edges"][part])
                        loss_sum = loss_sum + loss.detach()
                        counts = counts + jaccard_counts(
                            logits.detach(), targets, num_classes)
                    with span("train.backward"):
                        (loss / grad_accum).backward()
                # the gradients' reduction and the update, across the ZeRO
                # parameters' release
                opt_span.enter_context(span("train.optimizer"))
                average_grads(state, mesh)
            grad_norm = state.opt.step()
            opt_span.close()
            state.step += 1
            if group is not None:  # the global batch's loss and counts
                total = comm.all_reduce_sum(
                    torch.cat([loss_sum.reshape(1), counts]), group)
                loss_sum = total[0] / comm.size(group)
                counts = total[1:]
            tp, fp, fn = counts
        return state, {"loss": loss_sum / grad_accum,
                       "jaccard": tp / torch.clamp(tp + fp + fn, min=1),
                       "grad_norm": grad_norm}

    return step


def make_eval_step(model, loss_fn: Callable | str = "recall_focused",
                   num_classes: int = 3, with_edge: bool = False,
                   compute_dtype=None, edge_loss_fn=None,
                   return_preds: bool = False, mesh=None):
    """Returns ``step(state, batch) -> (loss, confusion (B*T, C, 4), cm
    (C, C)[, preds (B*T, H, W)])``, all computed on the device: only the
    counters need to reach the host.  With ``edge_loss_fn`` and
    ``"edges"`` in the batch, the loss includes the edge term, as the
    reference's validation criterion does
    (multiclass_training_folds.py:749-762).  ``mesh``: the whole batch
    comes in and its blocks run on the data ranks (see the module
    docstring); the results are the whole batch's."""
    if isinstance(loss_fn, str):
        loss_fn = losses_lib.LOSSES[loss_fn]
    group = data_group(mesh)

    def step(state: TrainState, batch):
        model.eval()
        batch, blocked = split_eval_batch(batch, mesh)
        with gathered(state), torch.inference_mode(), \
                losses_lib.batch_group(group if blocked else None):
            out = _forward(model, batch["clip"], compute_dtype)
            logits5 = out[0] if with_edge else out
            logits, targets = flatten_frames(logits5, batch["masks"])
            loss = loss_fn(logits, targets, num_classes)
            if with_edge and edge_loss_fn is not None and "edges" in batch:
                loss = loss + edge_loss_fn(logits5, batch["masks"], out[1],
                                           batch["edges"])
            preds = logits.argmax(-1)
            conf = per_class_confusion(preds, targets, num_classes)
            cm = confusion_matrix(preds, targets, num_classes)
            if blocked:  # every block's frames, in batch order
                loss = comm.all_reduce_sum(loss.reshape(1), group)[0] / (
                    comm.size(group))
                conf = comm.all_gather(conf, group).flatten(0, 1)
                cm = comm.all_reduce_sum(cm, group)
                if return_preds:
                    preds = comm.all_gather(preds, group).flatten(0, 1)
            res = (loss, conf, cm)
        return res + (preds,) if return_preds else res

    return step
