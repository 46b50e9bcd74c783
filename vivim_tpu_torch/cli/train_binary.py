"""Binary Vivim pretraining CLI.

Port of the JAX package's ``cli/train_binary.py`` (the reference's
complements/train_binary.py): binary Vivim (out_chans=1), Adam + cosine,
structure_loss (or the joint edge loss with ``-with_edge true``) on the
CENTER frame only, validation by the 256-threshold sweep and the S / E /
MAE / weighted-F measures.  Data: a gathered video tree (frame and
background mask, inverted so foreground = lesion,
complements/main_dataset.py:14-15) or the OTU_2D single-image corpus
(``-otu true``).  Logs and the val/dice checkpoint go under
``{save_path}/{exp_name}/binary``.  ``-bf16`` is accepted and does
nothing: the binary step runs in fp32, as the JAX binary step has no
compute dtype.  Runs on ``-device`` (CUDA unless ``-device cpu``);
``-n_devices`` / ``-seq_shards`` / ``-zero`` run under torchrun, one
process per rank.

Usage:
  python -m vivim_tpu_torch.cli.train_binary -data_path TrainData \\
      -clip_length 5 -image_size 256 -epochs 50 [-otu true]
"""

from __future__ import annotations

import os

from vivim_tpu_torch.cli.args import build_train_parser, str2bool
from vivim_tpu_torch.cli.common import (
    build_model,
    init_parallel,
    loader_split,
    maybe_load_hf_segformer,
    maybe_load_pretrained,
    train_binary_run,
)
from vivim_tpu_torch.data.dataset import ClipDataset
from vivim_tpu_torch.data.loader import DataLoader


def main(argv=None):
    parser = build_train_parser(__doc__)
    parser.add_argument("-otu", "--otu", type=str2bool, default=False,
                        help="data_path is an OTU_2D images/annotations dir")
    parser.add_argument("-val_path", "--val_path", type=str, default=None)
    args = parser.parse_args(argv)
    if not args.data_path:
        parser.error("-data_path is required")
    device, mesh = init_parallel(args, "train_binary")

    # the model first: it resolves the device before any data is read
    model, _ = build_model(args, device=device, seed=args.seed,
                           out_chans=1, mesh=mesh)
    if args.otu:
        from vivim_tpu_torch.data.otu import OTUDataset

        train_ds = OTUDataset(args.data_path, args.image_size,
                              augment=args.augment_intensity, seed=args.seed)
        val_ds = OTUDataset(args.val_path or args.data_path, args.image_size,
                            augment="none", seed=args.seed)
    else:
        cache = dict(cache_decoded=args.cache_decoded,
                     cache_mb=args.cache_mb, pre_resize=args.pre_resize)
        train_ds = ClipDataset(
            args.data_path, size=args.image_size, clip_len=args.clip_length,
            max_num=args.max_numerosity, augment=args.augment_intensity,
            mask_keys=("background",), invert_background=True,
            dynamic=args.dynamic, seed=args.seed, **cache)
        val_ds = ClipDataset(
            args.val_path or args.data_path, size=args.image_size,
            clip_len=args.clip_length, augment="none",
            mask_keys=("background",), invert_background=True,
            seed=args.seed, **cache)
    if len(train_ds) == 0:
        raise SystemExit(
            f"no training samples found under {args.data_path!r}")
    train_dl = DataLoader(train_ds, args.train_bs,
                          num_workers=args.num_workers, seed=args.seed,
                          **loader_split(args, mesh))
    if len(train_dl) == 0:
        raise SystemExit(
            f"{len(train_ds)} training sample(s) < train_bs={args.train_bs}: "
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
        os.path.join(args.save_path, args.exp_name, "binary"),
        f"{args.exp_name}_binary", edge_loss_fn, mesh)


if __name__ == "__main__":
    main()
