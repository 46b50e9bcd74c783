"""Polyp video-segmentation training CLI (the upstream Vivim task).

Port of the JAX package's ``cli/train_polyp.py`` (the reference's
original_training_scripts_not_used/train_pl_polyp.py): binary Vivim over
polyp clip datasets (Frame/GT layout, a centered window per frame), Adam +
cosine, center-frame structure_loss (or JointEdgeSegLoss with
``-with_edge true``; :94), validation by the saliency measures (S / E /
MAE / weighted F; :173-241), through the binary CLIs' loop
(``cli.common.train_binary_run``).  Logs and the val/dice checkpoint go
under ``{save_path}/{exp_name}/polyp``.  ``-bf16`` is accepted and does
nothing: the binary step runs in fp32, as the JAX binary step has no
compute dtype.  Runs on ``-device`` (CUDA unless ``-device cpu``);
``-n_devices`` / ``-seq_shards`` / ``-zero`` run under torchrun, one
process per rank.

Usage:
  python -m vivim_tpu_torch.cli.train_polyp -data_path polyp_root \\
      -clip_length 5 -image_size 256 -epochs 50 [-val_path TestDir]
"""

from __future__ import annotations

import os

from vivim_tpu_torch.cli.args import build_train_parser
from vivim_tpu_torch.cli.common import (
    build_model,
    init_parallel,
    loader_split,
    maybe_load_hf_segformer,
    maybe_load_pretrained,
    train_binary_run,
)
from vivim_tpu_torch.data.loader import DataLoader
from vivim_tpu_torch.data.polyp import PolypDataset, PolypTestDataset


def main(argv=None):
    parser = build_train_parser(__doc__)
    parser.add_argument("-val_path", "--val_path", type=str, default=None,
                        help="test tree ({dir}/Frame layout); defaults to "
                             "the train videos without augmentation")
    args = parser.parse_args(argv)
    if not args.data_path:
        parser.error("-data_path is required (root holding Train/)")
    device, mesh = init_parallel(args, "train_polyp")

    # the model first: it resolves the device before any data is read
    model, _ = build_model(args, device=device, seed=args.seed,
                           out_chans=1, mesh=mesh)
    train_ds = PolypDataset(args.data_path, args.image_size,
                            clip_len=args.clip_length,
                            augment=args.augment_intensity != "none",
                            seed=args.seed)
    if len(train_ds) == 0:
        raise SystemExit(
            f"no training clips found under {args.data_path!r} — expected "
            "{root}/Train/{video}/Frame/*.jpg with sibling GT/*.png")
    if args.val_path:
        val_ds = PolypTestDataset(args.val_path, args.image_size,
                                  clip_len=args.clip_length, seed=args.seed)
        if len(val_ds) == 0:
            raise SystemExit(
                f"no validation clips found under {args.val_path!r} — "
                "accepted layouts: {root}/Frame/{video}/, {root}/Frame/, "
                "{root}/{video}/Frame/")
    else:
        val_ds = PolypDataset(args.data_path, args.image_size,
                              clip_len=args.clip_length, augment=False,
                              seed=args.seed)
    train_dl = DataLoader(train_ds, args.train_bs,
                          num_workers=args.num_workers, seed=args.seed,
                          **loader_split(args, mesh))
    if len(train_dl) == 0:
        raise SystemExit(
            f"{len(train_ds)} training clip(s) < train_bs={args.train_bs}: "
            "every batch would be dropped (drop_last) and no optimizer "
            "step would run — lower -train_bs or add data")
    val_dl = DataLoader(val_ds, args.val_bs, shuffle=False,
                        num_workers=args.num_workers, drop_last=False,
                        seed=args.seed)

    maybe_load_hf_segformer(args, model)
    maybe_load_pretrained(args, model)
    edge_loss_fn = None
    if args.with_edge:
        from vivim_tpu_torch.train.edge_loss import make_joint_edge_seg_loss

        edge_loss_fn = make_joint_edge_seg_loss()
    return train_binary_run(
        args, model, train_dl, val_dl,
        os.path.join(args.save_path, args.exp_name, "polyp"),
        f"{args.exp_name}_polyp", edge_loss_fn, mesh)


if __name__ == "__main__":
    main()
