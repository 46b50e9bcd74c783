"""Shared CLI plumbing: the ranks of a run (``-n_devices``, ``-seq_shards``,
``-zero``, ``-dist_backend``; the LM CLIs' ``--tp_shards`` /
``--pp_stages``), the device, the model and the loaders from
parsed args, the pretrained-weight grafts (``-hf_dir``, ``-pretrain``) and
the binary CLIs' epoch loop."""

from __future__ import annotations

import contextlib
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


def init_parallel(args, cli: str):
    """The device and the mesh of this rank, from ``-n_devices``,
    ``-seq_shards``, ``-zero``, ``-dist_backend`` and ``-device``: (device,
    None) for a one-process run.  Call it first in a training CLI's
    ``main``.

    Several ranks run one process each, under ``torchrun --nproc_per_node
    n_devices x seq_shards``; the process group is joined here.  The mesh
    is the one the JAX package's ``build_model`` / ``trainer_mesh`` build:
    ("data", "seq") with both flags above 1, "seq" or "data" with one.
    Rank r takes ``cuda:LOCAL_RANK``; ``-device cuda:<i>`` puts every rank
    on card i, which only gloo allows (two ranks sharing one card).  The
    errors are the JAX package's where it has them: ``-zero`` without more
    than one data rank, a ``-train_bs`` that does not split evenly."""
    from vivim_tpu_torch.parallel import mesh as mesh_lib

    dp, seq = args.n_devices or 1, args.seq_shards or 1
    if args.zero and dp <= 1:
        # a silently ignored parallelism flag reads as a working config
        raise SystemExit(
            "-zero true shards params + optimizer moments over the 'data' "
            f"mesh axis, but this run has {dp} 'data' device(s) — pass "
            "-n_devices N (N > 1) or drop -zero")
    world = dp * seq
    env_world = int(os.environ.get("WORLD_SIZE", world))
    if env_world != world:
        raise SystemExit(
            f"this run has {env_world} process(es) but -n_devices {dp} x "
            f"-seq_shards {seq} = {world}: launch torchrun --nproc_per_node "
            f"{world}, or set the flags to the world size")
    if world == 1:
        return args.device, None
    if not mesh_lib.in_torchrun():
        raise SystemExit(
            f"-n_devices {dp} -seq_shards {seq} runs one process per rank: "
            f"torchrun --nproc_per_node {world} -m vivim_tpu_torch.cli.{cli} "
            "<flags>")
    if args.train_bs % dp:
        raise SystemExit(
            f"-train_bs {args.train_bs} must be divisible by the 'data' "
            f"mesh size {dp} so every device gets equal batch shards")
    if args.train_bs % (dp * args.grad_accum):
        raise SystemExit(
            f"-train_bs {args.train_bs} must split into -grad_accum "
            f"{args.grad_accum} micro-batches of equal shards over the "
            f"{dp} 'data' devices")
    device = _join_ranks(args.device, args.dist_backend, "-")
    if seq > 1:
        mesh = (mesh_lib.make_hybrid_mesh(dp, seq) if dp > 1
                else mesh_lib.make_mesh(seq, axis="seq"))
    else:
        mesh = mesh_lib.make_mesh(dp, axis="data")
    return str(device), mesh


def _join_ranks(device, backend, dash):
    """This rank's card (``cuda:LOCAL_RANK`` for ``device`` "cuda";
    ``cuda:<i>`` puts every rank on card i, which only gloo allows), set
    as current, and the run's process group joined."""
    from vivim_tpu_torch.parallel import mesh as mesh_lib

    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", "0"))
            dev = torch.device("cuda", local)
            if torch.cuda.is_available() and (
                    local >= torch.cuda.device_count()):
                raise SystemExit(
                    f"rank {local} of this node has no card of its own "
                    f"({torch.cuda.device_count()} visible); run fewer "
                    f"ranks, or share one card with {dash}dist_backend "
                    f"gloo {dash}device cuda:0")
        elif backend == "nccl":
            raise SystemExit(
                f"{dash}device {device} puts every rank on one card, which "
                f"NCCL refuses; pass {dash}device cuda (a card per rank), "
                f"or {dash}dist_backend gloo to share the card")
        if torch.cuda.is_available():
            torch.cuda.set_device(dev)
    mesh_lib.init_distributed(backend)
    return dev


def init_model_parallel(n, axis, flag, device, backend, cli):
    """The device and the 1-D mesh of an LM CLI run of ``n`` ranks over
    ``axis`` (``--tp_shards`` over "model", ``--pp_stages`` over "pipe"):
    (device, None) for one rank.  Several ranks run one process each under
    ``torchrun --nproc_per_node n``, each on its card as the training CLIs'
    ranks (``init_parallel``)."""
    from vivim_tpu_torch.parallel import mesh as mesh_lib

    env_world = int(os.environ.get("WORLD_SIZE", n))
    if env_world != n:
        raise SystemExit(
            f"this run has {env_world} process(es) but {flag} {n}: launch "
            f"torchrun --nproc_per_node {n}, or set the flag to the world "
            "size")
    if n == 1:
        return device, None
    if not mesh_lib.in_torchrun():
        raise SystemExit(
            f"{flag} {n} runs one process per rank: torchrun "
            f"--nproc_per_node {n} -m vivim_tpu_torch.cli.{cli} <flags>")
    dev = _join_ranks(device, backend, "--")
    return str(dev), mesh_lib.make_mesh(n, axis)


def loader_split(args, mesh):
    """The train loader's split of every batch over the data ranks: each
    loads only its block of each micro-batch."""
    if mesh is None:
        return {}
    return dict(process_index=mesh.index("data"),
                process_count=mesh.size("data"),
                micro_batches=args.grad_accum)


class _NoLogger:
    """The logger of a rank that writes nothing (all but rank 0)."""

    def log(self, *args, **kw):
        pass

    log_confusion_matrix = log

    def finish(self):
        pass


def make_logger(run_dir, run_name, args, mesh):
    """``metrics.jsonl`` (and wandb) under ``run_dir``, on rank 0 only."""
    from vivim_tpu_torch.train.logging import MetricLogger

    if mesh is not None and not mesh.is_main:
        return _NoLogger()
    return MetricLogger(run_dir, run_name=run_name, use_wandb=args.wandb,
                        config=vars(args))


def build_model(args, device="cuda", seed: int = 0, out_chans=None,
                mesh=None):
    """Vivim from parsed CLI args (``segformer`` in b0 / b3 / tiny,
    ``num_classes``, ``with_edge``, ``exact_gelu``, ``remat``), with random
    weights from ``seed``, in eval mode on ``device``.  ``out_chans``
    overrides ``num_classes`` (1 for the binary CLIs).  A ``mesh`` with a
    ``seq`` axis (``init_parallel``, ``-seq_shards``) shards the Mamba
    layers' tokens over it.  Returns (model, cfg).

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
    if mesh is not None and mesh.size("seq") > 1:
        cfg = dataclasses.replace(cfg, seq_axis="seq", mesh=mesh)
    model = Vivim(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval(), cfg


def build_loaders(args, train_root, val_root=None, dynamic=False,
                  mesh=None):
    """Training and validation loaders (the latter None without
    ``val_root``).  ``-cache_mb`` caps each dataset's decode cache, so the
    worst-case host RAM is twice it.  With a ``mesh`` each data rank's
    train loader loads its block of every batch (``loader_split``); the
    validation loader loads whole batches, which the eval step splits."""
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
                          num_workers=args.num_workers, seed=args.seed,
                          **loader_split(args, mesh))
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


def setup_data_parallelism(args, state, mesh):
    """The placement of a fresh train state for the binary CLIs' loop (the
    Trainer has its own): rank 0's weights on every rank, after the weight
    grafts, and with ``-zero`` the parameters and AdamW moments sharded
    over ``data``.  Returns ``(state, shardings or None)``."""
    from vivim_tpu_torch.parallel.fsdp import shard_state_fsdp
    from vivim_tpu_torch.parallel.mesh import replicate

    if mesh is None:
        return state, None
    replicate(state.model, mesh)
    if args.zero:
        return shard_state_fsdp(state, mesh)
    return state, None


def train_binary_run(args, model, train_dl, val_dl, run_dir, run_name,
                     edge_loss_fn=None, mesh=None):
    """The binary CLIs' epoch loop (train_binary, train_polyp): Adam with a
    cosine over the run, the center-frame step, validation every
    ``val_freq`` epochs through ``BinaryValidator``, ``metrics.jsonl`` and
    the ``val/dice`` checkpoint (max, top 1) under ``run_dir``.  With a
    ``mesh`` (``init_parallel``) every rank runs the loop, and rank 0
    alone writes.  Returns the last epoch's metrics."""
    from vivim_tpu_torch.train import binary
    from vivim_tpu_torch.train.checkpoints import CheckpointManager
    from vivim_tpu_torch.train.loop import TrainState

    dev = next(model.parameters()).device
    is_main = mesh is None or mesh.is_main
    logger = make_logger(run_dir, run_name, args, mesh)
    total_steps = args.epochs * max(len(train_dl), 1)
    tx, schedule = binary.make_binary_optimizer(model, args.initlr,
                                                total_steps)
    seed = args.seed + 1 if mesh is None else mesh.fold_seed(args.seed + 1)
    state = TrainState(step=0, model=model, opt=tx,
                       generator=torch.Generator(dev).manual_seed(seed))
    state, _ = setup_data_parallelism(args, state, mesh)
    train_step = binary.make_binary_train_step(
        model, edge_loss_fn, grad_accum=args.grad_accum, mesh=mesh)
    eval_step = binary.make_binary_eval_step(model, mesh=mesh)
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
            if is_main:
                print(f"epoch {epoch}: " + ", ".join(
                    f"{k}={v:.4f}" for k, v in metrics.items()))
        logger.log(metrics, step=state.step)
        with (state.zero.full() if state.zero is not None
              else contextlib.nullcontext()):
            if is_main:
                ckpt.save(state, state.step, metrics)
    logger.finish()
    return metrics
