"""Final full-data retrain CLI.

Port of the JAX package's ``cli/train_final.py`` (the reference's
final_multiclass_training.py, and final_multi_train_dyn.py via ``-dynamic
true``): trains on the FULL training tree (no folds); the validation loader
is the training set without augmentation; checkpoints monitor
``train/loss`` (min, top-3); validation runs once at the end
(check_val_every_n_epoch = epochs-1, final_multiclass_training.py:781-782).
Logs and checkpoints go under ``{save_path}/{exp_name}/final``.  Runs on
``-device`` (CUDA unless ``-device cpu``); ``-n_devices`` / ``-seq_shards``
/ ``-zero`` run under torchrun, one process per rank.

Usage:
  python -m vivim_tpu_torch.cli.train_final -data_path Multiclass_TrainData \\
      -clip_length 5 -image_size 256 -train_bs 3 -epochs 50
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
from vivim_tpu_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    parser = build_train_parser(__doc__)
    args = parser.parse_args(argv)
    if not args.data_path:
        parser.error("-data_path is required (gathered train tree)")
    device, mesh = init_parallel(args, "train_final")

    model, _ = build_model(args, device=device, seed=args.seed, mesh=mesh)
    # val loader = train set, no augmentation (final_multiclass_training.py:462)
    train_dl, val_dl = build_loaders(args, args.data_path, args.data_path,
                                     dynamic=args.dynamic, mesh=mesh)
    run_dir = os.path.join(args.save_path, args.exp_name, "final")
    logger = make_logger(run_dir, f"{args.exp_name}_final", args, mesh)
    tcfg = TrainerConfig(
        epochs=args.epochs,
        val_freq=max(args.epochs - 1, 1),  # validate once at the end
        lr=args.initlr, weight_decay=args.weight_decay,
        num_classes=args.num_classes, loss=args.loss,
        monitor="train/loss", monitor_mode="min", top_k=3, seed=args.seed,
        bf16=args.bf16, grad_accum=args.grad_accum,
        decay_mask=args.decay_mask, profile_dir=args.profile_dir,
        zero=args.zero, device=device)
    trainer = Trainer(model, tcfg, train_dl, val_dl,
                      os.path.join(run_dir, "ckpt"), logger, mesh=mesh,
                      with_edge=args.with_edge,
                      edge_loss_fn=edge_criterion(args))
    maybe_load_hf_segformer(args, model)
    maybe_load_pretrained(args, model)
    best = trainer.fit(resume_path=args.resume_path)
    logger.finish()
    if mesh is None or mesh.is_main:
        print(f"[final] best {tcfg.monitor}: {best}")
    return best


if __name__ == "__main__":
    main()
