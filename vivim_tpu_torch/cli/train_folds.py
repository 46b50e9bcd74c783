"""K-fold cross-validation training CLI.

Port of the JAX package's ``cli/train_folds.py`` (the reference's
multiclass_training_folds.py, and its dynamic variant
dyn_multiclass_training.py via ``-dynamic true``): per-fold run over
``{data_path}/fold_i/{train,val}`` trees, Vivim model, recall_focused loss,
AdamW + cosine, checkpoint on val/dice (max, top-1), per-fold metric logs
under ``{save_path}/{exp_name}/fold_{i}``.  Runs on ``-device`` (CUDA
unless ``-device cpu``); ``-n_devices`` / ``-seq_shards`` / ``-zero`` run
under torchrun, one process per rank.

Usage:
  python -m vivim_tpu_torch.cli.train_folds -data_path Multiclass_Folds \\
      -num_folds 5 -clip_length 5 -image_size 256 -train_bs 3 -epochs 50
  torchrun --nproc_per_node 2 -m vivim_tpu_torch.cli.train_folds \\
      -data_path Multiclass_Folds -train_bs 4 -n_devices 2 -zero true
"""

from __future__ import annotations

import os

from vivim_tpu_torch.cli.args import build_train_parser
from vivim_tpu_torch.cli.common import (
    build_loaders,
    build_model,
    edge_criterion,
    init_parallel,
    make_logger,
    maybe_load_hf_segformer,
    maybe_load_pretrained,
)
from vivim_tpu_torch.data.gather import gather_multiclass_frames
from vivim_tpu_torch.train.trainer import Trainer, TrainerConfig


def run_fold(args, fold: int, device=None, mesh=None):
    # the model first: it resolves the device before any data is read
    model, _ = build_model(args, device=device or args.device,
                           seed=args.seed + fold, mesh=mesh)
    fold_dir = os.path.join(args.data_path, f"fold_{fold}")
    # the fold tree stores one dir per frame; index (no copy) into videos
    train_index = gather_multiclass_frames(
        os.path.join(fold_dir, "train"), copy=False)
    val_index = gather_multiclass_frames(
        os.path.join(fold_dir, "val"), copy=False)
    train_index = {v: _entries(e) for v, e in train_index.items()}
    val_index = {v: _entries(e) for v, e in val_index.items()}
    train_dl, val_dl = build_loaders(args, train_index, val_index,
                                     dynamic=args.dynamic, mesh=mesh)
    run_dir = os.path.join(args.save_path, args.exp_name, f"fold_{fold}")
    logger = make_logger(run_dir, f"{args.exp_name}_fold{fold}", args, mesh)
    tcfg = TrainerConfig(
        epochs=args.epochs, val_freq=args.val_freq, lr=args.initlr,
        weight_decay=args.weight_decay, num_classes=args.num_classes,
        loss=args.loss, monitor="val/dice", monitor_mode="max", top_k=1,
        seed=args.seed + fold, bf16=args.bf16, grad_accum=args.grad_accum,
        decay_mask=args.decay_mask, profile_dir=args.profile_dir,
        zero=args.zero, device=device or args.device)
    trainer = Trainer(model, tcfg, train_dl, val_dl,
                      os.path.join(run_dir, "ckpt"), logger, mesh=mesh,
                      with_edge=args.with_edge,
                      edge_loss_fn=edge_criterion(args))
    maybe_load_hf_segformer(args, model)
    maybe_load_pretrained(args, model)
    best = trainer.fit(resume_path=args.resume_path)
    logger.finish()
    if mesh is None or mesh.is_main:
        print(f"[fold {fold}] best {tcfg.monitor}: {best}")
    return best


def _entries(records):
    """gather index records -> ClipDataset entries."""
    return [{"frame": r["frame"], "background": r["background"],
             "solid": r.get("solid"), "non-solid": r.get("non-solid")}
            for r in records]


def main(argv=None):
    parser = build_train_parser(__doc__)
    args = parser.parse_args(argv)
    if not args.data_path:
        parser.error("-data_path is required (root of fold_i dirs)")
    device, mesh = init_parallel(args, "train_folds")
    results = {}
    for fold in range(args.num_folds):
        results[fold] = run_fold(args, fold, device, mesh)
    if mesh is None or mesh.is_main:
        print("CV results:", results)
    return results


if __name__ == "__main__":
    main()
