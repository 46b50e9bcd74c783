"""Shared CLI plumbing: the device, the model and the loaders from parsed
args, the pretrained-weight grafts (``-hf_dir``, ``-pretrain``), the binary
CLIs' epoch loop, and the refusal of flags whose path the port does not
have yet."""

from __future__ import annotations

import dataclasses
import os

import torch

from vivim_tpu_torch.nn import segformer as sf
from vivim_tpu_torch.nn.layers import init_weights
from vivim_tpu_torch.nn.vivim import Vivim, VivimConfig

SEGFORMERS = {"b0": sf.mit_b0, "b3": sf.mit_b3, "tiny": sf.mit_tiny_test}


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises when it names CUDA and there is
    none (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on the GPU; pass "
                "device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def refuse_unported(args):
    """SystemExit for a training flag whose path the port does not have
    yet, naming the ROADMAP item that takes it: a flag dropped silently
    reads as a working config."""
    refused = []
    if args.seq_shards > 1:
        refused.append(f"-seq_shards {args.seq_shards} (ROADMAP M12)")
    if (args.n_devices or 1) > 1:
        refused.append(f"-n_devices {args.n_devices} (ROADMAP M12)")
    if args.zero:
        refused.append("-zero true (ROADMAP M12)")
    if refused:
        raise SystemExit("not ported yet: " + ", ".join(refused))


def build_model(args, device="cuda", seed: int = 0, out_chans=None):
    """Vivim from parsed CLI args (``segformer`` in b0 / b3 / tiny,
    ``num_classes``, ``with_edge``, ``exact_gelu``, ``remat``), with random
    weights from ``seed``, in eval mode on ``device``.  ``out_chans``
    overrides ``num_classes`` (1 for the binary CLIs).  Returns (model,
    cfg).

    GELU is the tanh form unless ``args.exact_gelu`` is true, as in the JAX
    package; args without the flag (the infer CLI's) get the exact erf.
    ``-remat pre_scan`` recomputes the Mamba pre-scan chain, ``-remat
    blocks`` every MambaLayer and SegFormer layer, as in the JAX package."""
    dev = resolve_device(device)
    seg = SEGFORMERS[args.segformer]()
    if not getattr(args, "exact_gelu", True):
        seg = dataclasses.replace(seg, gelu_approximate=True)
    remat = getattr(args, "remat", "none")
    if remat == "blocks":
        seg = dataclasses.replace(seg, remat_layers=True)
    cfg = VivimConfig(out_chans=args.num_classes if out_chans is None
                      else out_chans, with_edge=args.with_edge,
                      feat_size=seg.hidden_sizes,
                      hidden_size=seg.decoder_hidden_size, segformer=seg,
                      remat_pre_scan=remat == "pre_scan",
                      remat_blocks=remat == "blocks")
    model = Vivim(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval(), cfg


def build_loaders(args, train_root, val_root=None, dynamic=False):
    """Training and validation loaders (the latter None without
    ``val_root``).  ``-cache_mb`` caps each dataset's decode cache, so the
    worst-case host RAM is twice it."""
    from vivim_tpu_torch.data.dataset import ClipDataset
    from vivim_tpu_torch.data.loader import DataLoader

    cache = dict(cache_decoded=getattr(args, "cache_decoded", False),
                 cache_mb=getattr(args, "cache_mb", 4096),
                 pre_resize=getattr(args, "pre_resize", False))
    train_ds = ClipDataset(
        train_root, size=args.image_size, clip_len=args.clip_length,
        max_num=args.max_numerosity, augment=args.augment_intensity,
        dynamic=dynamic, seed=args.seed, with_edges=args.with_edge, **cache)
    train_dl = DataLoader(train_ds, args.train_bs, shuffle=True,
                          num_workers=args.num_workers, seed=args.seed)
    if len(train_dl) == 0:
        raise SystemExit(
            f"{len(train_ds)} training clip(s) under {train_root!r} < "
            f"train_bs={args.train_bs}: every batch would be dropped "
            "(drop_last) and no optimizer step would run — lower -train_bs "
            "or add data")
    val_dl = None
    if val_root is not None:
        val_ds = ClipDataset(
            val_root, size=args.image_size, clip_len=args.clip_length,
            max_num=None,
            augment=args.augment_intensity if args.val_aug else "none",
            seed=args.seed, with_edges=args.with_edge, **cache)
        val_dl = DataLoader(val_ds, args.val_bs, shuffle=False,
                            num_workers=args.num_workers, drop_last=False,
                            seed=args.seed)
    return train_dl, val_dl


def edge_criterion(args):
    """The multiclass CLIs' ``-with_edge`` loss: the center-frame edge terms
    of JointEdgeSegLoss (``make_multiclass_edge_criterion``), or None."""
    if not args.with_edge:
        return None
    from vivim_tpu_torch.train.edge_loss import make_multiclass_edge_criterion

    return make_multiclass_edge_criterion()


def maybe_load_hf_segformer(args, model):
    """``-hf_dir``: graft a local HF SegFormer snapshot (e.g. of
    nvidia/segformer-b3-finetuned-ade-512-512) onto the fresh model in
    place, as the reference does at construction (vivim.py:264-267),
    without network."""
    if not getattr(args, "hf_dir", None):
        return
    from vivim_tpu_torch.convert.from_jax import (
        graft_hf_segformer,
        load_torch_state_dict,
    )

    n = graft_hf_segformer(model, load_torch_state_dict(args.hf_dir))
    print(f"[hf_dir] took {n} tensors from {args.hf_dir}")


def maybe_load_pretrained(args, model):
    """``-pretrain``: partial init from a port checkpoint (a ``save_params``
    file, or a ``CheckpointManager`` best / last file): every tensor whose
    key the checkpoint and the model share, with equal shapes, parameters
    and BatchNorm statistics alike, as the reference's init_weight loads a
    state_dict (multiclass_training_folds.py:519-532); the rest keeps its
    init.  Raises if it takes nothing.  Returns the keys taken (None
    without ``-pretrain``)."""
    if not args.pretrain:
        return None
    from vivim_tpu_torch.train.checkpoints import load_params

    sd = load_params(args.pretrain)
    own = model.state_dict()
    took = {k: v for k, v in sd.items()
            if k in own and tuple(v.shape) == tuple(own[k].shape)}
    if not took:
        raise SystemExit(f"-pretrain {args.pretrain}: no tensor of it "
                         "matches this model's keys and shapes")
    model.load_state_dict(took, strict=False)
    skipped = sorted(set(sd) - set(took))
    kept = sorted(set(own) - set(took))
    print(f"[pretrain] took {len(took)} of the model's {len(own)} tensors "
          f"from {args.pretrain}; skipped {skipped or 'none'}; kept the "
          f"init of {kept or 'none'}")
    return sorted(took)


def train_binary_run(args, model, train_dl, val_dl, run_dir, run_name,
                     edge_loss_fn=None):
    """The binary CLIs' epoch loop (train_binary, train_polyp): Adam with a
    cosine over the run, the center-frame step, validation every
    ``val_freq`` epochs through ``BinaryValidator``, ``metrics.jsonl`` and
    the ``val/dice`` checkpoint (max, top 1) under ``run_dir``.  Returns the
    last epoch's metrics."""
    from vivim_tpu_torch.train import binary
    from vivim_tpu_torch.train.checkpoints import CheckpointManager
    from vivim_tpu_torch.train.logging import MetricLogger
    from vivim_tpu_torch.train.loop import TrainState

    dev = next(model.parameters()).device
    logger = MetricLogger(run_dir, run_name=run_name, use_wandb=args.wandb,
                          config=vars(args))
    total_steps = args.epochs * max(len(train_dl), 1)
    tx, schedule = binary.make_binary_optimizer(model, args.initlr,
                                                total_steps)
    state = TrainState(step=0, model=model, opt=tx,
                       generator=torch.Generator(dev).manual_seed(
                           args.seed + 1))
    train_step = binary.make_binary_train_step(
        model, edge_loss_fn, grad_accum=args.grad_accum)
    eval_step = binary.make_binary_eval_step(model)
    ckpt = CheckpointManager(os.path.join(run_dir, "ckpt"),
                             monitor="val/dice", mode="max", top_k=1)

    def device_batch(batch):
        return {k: torch.as_tensor(v).to(dev, non_blocking=True)
                for k, v in batch.items() if k != "paths"}

    metrics = {}
    for epoch in range(args.epochs):
        train_dl.set_epoch(epoch)
        losses = [train_step(state, device_batch(b))[1]["loss"]
                  for b in train_dl]
        metrics = {"train/loss": (float(torch.stack(losses).mean())
                                  if losses else 0.0),
                   "train/lr": float(schedule(state.step))}
        if (epoch + 1) % args.val_freq == 0:
            validator = binary.BinaryValidator()
            for batch in val_dl:
                validator.update(*eval_step(state, device_batch(batch)))
            metrics.update(validator.results())
            print(f"epoch {epoch}: " + ", ".join(
                f"{k}={v:.4f}" for k, v in metrics.items()))
        logger.log(metrics, step=state.step)
        ckpt.save(state, state.step, metrics)
    logger.finish()
    return metrics
