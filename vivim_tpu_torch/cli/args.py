"""Shared training CLI flags: every flag and default of the JAX package's
``cli/args.py`` (a superset of the reference's cfg.py:4-42), plus
``-device`` and ``-dist_backend``.

Flags accept both single-dash (reference style: ``-image_size``) and
double-dash forms.  ``-n_devices``, ``-seq_shards`` and ``-zero`` above one
rank run under ``torchrun`` (``cli.common.init_parallel``).
"""

from __future__ import annotations

import argparse


def _add(parser, name, **kw):
    parser.add_argument(f"-{name}", f"--{name}", **kw)


def str2bool(v):
    return str(v).lower() in ("1", "true", "yes", "y")


def build_train_parser(description="vivim_tpu_torch training"):
    p = argparse.ArgumentParser(description=description)
    _add(p, "net", type=str, default="Vivim")
    _add(p, "exp_name", type=str, default="vivim_train")
    _add(p, "pretrain", type=str, default=None,
         help="a port checkpoint (save_params, or a best / last file): "
              "every tensor of equal key and shape initialises the model")
    _add(p, "hf_dir", type=str, default=None,
         help="local HF snapshot dir of nvidia/segformer-b3-finetuned-ade-"
              "512-512: its encoder and decode head initialise the model")
    _add(p, "val_freq", type=int, default=5)
    _add(p, "image_size", type=int, default=256)
    _add(p, "train_bs", type=int, default=1)
    _add(p, "val_bs", type=int, default=1)
    _add(p, "test_bs", type=int, default=1)
    _add(p, "initlr", type=float, default=1e-4)
    _add(p, "weight_decay", type=float, default=1e-2)
    _add(p, "data_path", type=str, default=None,
         help="root of the fold tree (train_folds) or train tree (final)")
    _add(p, "clip_length", type=int, default=3)
    _add(p, "epochs", type=int, default=10)
    _add(p, "resume_path", type=str, default=None)
    _add(p, "save_path", type=str, default="runs")
    _add(p, "num_workers", type=int, default=2)
    _add(p, "val_aug", type=str2bool, default=False)
    _add(p, "with_edge", type=str2bool, default=False,
         help="edge head and edge loss")
    _add(p, "num_classes", type=int, default=3)
    _add(p, "num_folds", type=int, default=5)
    _add(p, "seed", type=int, default=42)
    _add(p, "cv_group", type=str, default=None)
    _add(p, "max_numerosity", type=int, default=None,
         help="max clips per video (equispaced, or random when -dynamic)")
    _add(p, "dynamic", type=str2bool, default=False,
         help="re-draw the per-video clip subset every epoch (_dyn scripts)")
    _add(p, "augment_intensity", type=str, default="medium",
         choices=["none", "light", "medium", "heavy"])
    _add(p, "loss", type=str, default="recall_focused")
    _add(p, "decay_mask", type=str, default="tagged",
         choices=["tagged", "torch"],
         help="AdamW weight-decay mask: 'tagged' (default) skips "
              "biases/norms/A_log/D per mamba's _no_weight_decay tags; "
              "'torch' decays everything, matching the reference harness "
              "(multiclass_training_folds.py:505 uses no param groups)")
    _add(p, "wandb", type=str2bool, default=False,
         help="also log to wandb (JSONL only when wandb is unavailable)")
    _add(p, "bf16", type=str2bool, default=False,
         help="run the model in bfloat16 activations")
    _add(p, "n_devices", type=int, default=None,
         help="ranks of the data-parallel mesh: each trains on its block "
              "of every batch, gradients averaged (under torchrun, one "
              "process per rank)")
    _add(p, "seq_shards", type=int, default=1,
         help="shard the Mamba token axis over this many ranks (the "
              "sequence-parallel scan); with -n_devices, a (data, seq) "
              "mesh of n_devices x seq_shards ranks")
    _add(p, "grad_accum", type=int, default=1,
         help="micro-batch gradient accumulation: split each train batch "
              "into this many micro-batches, average the gradients, apply "
              "ONE optimizer update (train_bs must be divisible)")
    _add(p, "zero", type=str2bool, default=False,
         help="ZeRO/FSDP sharding of params and AdamW moments over the "
              "-n_devices data ranks")
    _add(p, "segformer", type=str, default="b3", choices=["b0", "b3", "tiny"])
    _add(p, "exact_gelu", type=str2bool, default=False,
         help="use the exact erf GELU (HF-bit-parity); the tanh form "
              "otherwise, as the JAX training CLIs default to")
    _add(p, "remat", type=str, default="none",
         choices=["none", "pre_scan", "blocks"],
         help="rematerialization level: 'pre_scan' recomputes the Mamba "
              "pre-scan chain in the backward; 'blocks' recomputes whole "
              "MambaLayer / SegformerLayer blocks (torch.utils.checkpoint, "
              "the random layers' draws kept)")
    _add(p, "profile_dir", type=str, default=None,
         help="write a torch.profiler trace of the first training steps")
    _add(p, "cache_decoded", type=str2bool, default=False,
         help="cache decoded PNG frames/masks in host RAM (uint8, exact): "
              "PNG decode is deterministic, so epochs >= 2 skip it; bounded "
              "by -cache_mb")
    _add(p, "cache_mb", type=int, default=4096,
         help="decode-cache cap in MB PER DATASET (insertion stops at the "
              "cap); train and val each own a cache, so worst-case host "
              "RAM is 2x this value")
    _add(p, "pre_resize", type=str2bool, default=False,
         help="resize frames/masks to -image_size at decode time, BEFORE "
              "augmentation (the reference augments at source resolution "
              "then resizes): every host augment op runs on fewer pixels "
              "and -cache_decoded stores smaller arrays — a throughput mode "
              "that reorders interpolation, so augmented pixels differ "
              "from the reference pipeline (exact when augmentation is off)")
    _add(p, "device", type=str, default="cuda",
         help="torch device; 'cpu' runs on the CPU; under torchrun 'cuda' "
              "gives rank r the card LOCAL_RANK, 'cuda:<i>' puts every "
              "rank on card i (gloo only)")
    _add(p, "dist_backend", type=str, default="nccl",
         choices=["nccl", "gloo"],
         help="torch.distributed backend of a run of several ranks (gloo "
              "for the CPU, or for ranks that share one card)")
    # Vestigial reference flags (cfg.py:4-42), accepted for drop-in CLI
    # compatibility and unused (device selection, legacy dataset switches)
    for name, default in (("vis", False), ("train_vis", False),
                          ("gpu", True), ("val_vis", False)):
        _add(p, name, type=str2bool, default=default,
             help="(reference compatibility; unused)")
    for name, default in (("gpu_device", 0), ("out_size", 256),
                          ("crop_size", 256), ("shift_length", 32)):
        _add(p, name, type=int, default=default,
             help="(reference compatibility; unused)")
    for name in ("distributed", "dataset", "weights"):
        _add(p, name, type=str, default=None,
             help="(reference compatibility; unused)")
    return p
