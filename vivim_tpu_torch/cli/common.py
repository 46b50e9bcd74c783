"""Shared CLI plumbing: the device, the model and the loaders from parsed
args, and the refusal of flags whose path the port does not have yet."""

from __future__ import annotations

import dataclasses

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
    if args.remat != "none":
        refused.append(f"-remat {args.remat} (ROADMAP M2c)")
    if args.seq_shards > 1:
        refused.append(f"-seq_shards {args.seq_shards} (ROADMAP M12)")
    if (args.n_devices or 1) > 1:
        refused.append(f"-n_devices {args.n_devices} (ROADMAP M12)")
    if args.zero:
        refused.append("-zero true (ROADMAP M12)")
    if args.pretrain:
        refused.append("-pretrain (ROADMAP M8b)")
    if args.hf_dir:
        refused.append("-hf_dir (ROADMAP M8b)")
    if args.with_edge:
        refused.append("-with_edge true (ROADMAP M9)")
    if refused:
        raise SystemExit("not ported yet: " + ", ".join(refused))


def build_model(args, device="cuda", seed: int = 0):
    """Vivim from parsed CLI args (``segformer`` in b0 / b3 / tiny,
    ``num_classes``, ``with_edge``, ``exact_gelu``), with random weights
    from ``seed``, in eval mode on ``device``.  Returns (model, cfg).

    GELU is the tanh form unless ``args.exact_gelu`` is true, as in the JAX
    package; args without the flag (the infer CLI's) get the exact erf."""
    dev = resolve_device(device)
    seg = SEGFORMERS[args.segformer]()
    if not getattr(args, "exact_gelu", True):
        seg = dataclasses.replace(seg, gelu_approximate=True)
    cfg = VivimConfig(out_chans=args.num_classes, with_edge=args.with_edge,
                      feat_size=seg.hidden_sizes,
                      hidden_size=seg.decoder_hidden_size, segformer=seg)
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
