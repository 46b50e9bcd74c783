#!/usr/bin/env python3
"""Convert a JAX Vivim checkpoint (orbax) into a PyTorch state_dict file.

    python scripts/orbax_to_torch.py <orbax dir> <out.pt> [--segformer b3]
        [--num_classes 3] [--with_edge false]

``<orbax dir>`` is what the JAX package writes: a trainer checkpoint
(``{"step", "params", "batch_stats", "opt_state", "rng"}``), a params tree
saved by its ``save_params``, or a trainer's ``ckpt`` directory, from which
the ``best_*`` checkpoint is taken before the ``last_*`` one, the last name
in sorted order (the JAX infer CLI's rule).  A params tree carries no
BatchNorm statistics: the decode's get their init (mean 0, variance 1), as
the JAX infer CLI gives them.

The variables go through ``vivim_tpu_torch.convert.from_jax.
vivim_state_dict_from_jax``, load strictly into the port's model of the
given width, and are written with ``torch.save``.  The port's ``cli/infer``
(``--ckpt``) and the training CLIs' ``-pretrain`` read the file.  This
script imports JAX and orbax; the port itself imports neither.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def checkpoint_dir(path):
    """``path``, or in a trainer's ``ckpt`` directory its best (else last)
    checkpoint by name."""
    subs = sorted(d for d in os.listdir(path)
                  if d.startswith(("best_", "last_"))
                  and os.path.isdir(os.path.join(path, d)))
    if not subs:
        return path
    best = [d for d in subs if d.startswith("best_")]
    return os.path.join(path, (best or subs)[-1])


def restore_variables(path, hidden_size):
    """{"params", "batch_stats"} of the orbax checkpoint at ``path``."""
    import orbax.checkpoint as ocp

    raw = ocp.StandardCheckpointer().restore(checkpoint_dir(path))
    if isinstance(raw, dict) and "params" in raw:
        params, stats = raw["params"], raw.get("batch_stats")
    else:
        params, stats = raw, None
    if not stats:
        stats = {"batch_norm": {"mean": np.zeros(hidden_size, np.float32),
                                "var": np.ones(hidden_size, np.float32)}}
    return {"params": params, "batch_stats": stats}


def convert(path, out, segformer="b3", num_classes=3, with_edge=False):
    """Write the port's state_dict of the checkpoint at ``path`` to
    ``out``; returns it."""
    from vivim_tpu_torch.cli.common import build_model
    from vivim_tpu_torch.convert.from_jax import vivim_state_dict_from_jax

    args = argparse.Namespace(segformer=segformer, num_classes=num_classes,
                              with_edge=with_edge)
    model, cfg = build_model(args, device="cpu")
    variables = restore_variables(os.path.abspath(path), cfg.hidden_size)
    sd = vivim_state_dict_from_jax(variables, cfg)
    model.load_state_dict(sd, strict=True)
    torch.save(sd, out)
    return sd


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("src", help="orbax checkpoint or params directory")
    p.add_argument("out", help="the .pt file to write")
    p.add_argument("--segformer", default="b3", choices=["b0", "b3", "tiny"])
    p.add_argument("--num_classes", type=int, default=3)
    p.add_argument("--with_edge", default="false",
                   type=lambda v: str(v).lower() in ("1", "true"))
    args = p.parse_args(argv)
    sd = convert(args.src, args.out, args.segformer, args.num_classes,
                 args.with_edge)
    print(f"wrote {len(sd)} tensors to {args.out}")


if __name__ == "__main__":
    main()
