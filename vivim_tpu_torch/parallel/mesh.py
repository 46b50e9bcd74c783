"""Process groups, a small named mesh, and the batch helpers.

Port of the JAX package's ``parallel/mesh.py``.  There one process drives
every device of a ``jax.sharding.Mesh`` and XLA inserts the collectives;
here each rank is a process of its own (``torchrun``, or a spawner that
sets torchrun's variables), a ``Mesh`` names its axes and
holds one process group per axis, and the parallel paths call the
collectives themselves (``parallel/comm.py``).

- ``init_distributed``: the process group of this run, from torchrun's
  environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``;
  the CLIs read ``LOCAL_RANK`` for the card), with a timeout, so that a
  rank that died cannot hold the others in a collective for long.
- ``make_mesh(n, axis)``: one axis over the world; ``make_hybrid_mesh(dp,
  n, axes)``: a 2-D mesh, ("data", "seq") by default, whose rank layout is
  the JAX ``devices.reshape(dp, n)``, so the ranks of one row of the second
  axis are contiguous.
- ``shard_batch`` / ``local_rows``: this rank's block of a global batch
  dict / array (the JAX ``shard_batch`` / ``data_sharding``,
  ``PartitionSpec("data")``).  The JAX
  ``global_shard_batch`` is the loader's side here: each data rank's
  ``DataLoader(process_index, process_count)`` loads only its block, which
  the train step takes as it is.  ``replicate``: a broadcast of a module's
  tensors from rank 0.
- The JAX ``shard_map_compat`` has no counterpart: each rank already runs
  its own shard, so there is no mapped region to open.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from vivim_tpu_torch.data.loader import block_rows
from vivim_tpu_torch.parallel import comm

DEFAULT_TIMEOUT_S = 60
# data rank r > 0 draws its dropout masks from seed + r * SEED_STRIDE
SEED_STRIDE = 1_000_003


def init_distributed(backend: str = "nccl",
                     timeout_s: float = DEFAULT_TIMEOUT_S):
    """Join (or find) this run's process group from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; a spawner,
    as the tests and ``chip_smoke.py``, sets the same variables); returns
    (rank, world size).  Every collective of the group fails after
    ``timeout_s`` seconds instead of waiting on a dead rank forever."""
    if not dist.is_initialized():
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"no process group: torchrun's {', '.join(missing)} are "
                "not set; launch with torchrun --nproc_per_node N")
        dist.init_process_group(
            backend, init_method="env://", rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]),
            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank(), dist.get_world_size()


def in_torchrun() -> bool:
    """Whether torchrun (or a process group) set up this process."""
    return dist.is_initialized() or "WORLD_SIZE" in os.environ


@dataclasses.dataclass(eq=False)
class Mesh:
    """Named axes over the ranks of a run: ``shape`` maps each axis to its
    size (in order), ``coords`` to this rank's index on it, ``groups`` to
    the process group of the ranks that differ from this one on that axis
    only (None for an axis of size 1)."""

    shape: dict
    coords: dict
    groups: dict

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.groups.get(axis)

    @property
    def is_main(self) -> bool:
        """Rank 0 of the mesh: the one that writes checkpoints and logs."""
        return all(i == 0 for i in self.coords.values())

    def fold_seed(self, seed: int) -> int:
        """The generator seed of this rank: the ranks of one ``seq`` row
        compute the same replicated layers and must draw the same masks,
        so only the ``data`` index is folded in (data rank 0 keeps
        ``seed``)."""
        return seed + self.index("data") * SEED_STRIDE


def _world(n: int, what: str) -> int:
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(
            f"requested a {what} mesh of {n} rank(s) but this run has "
            f"{world} process(es)" + ("" if dist.is_initialized() else
                                      " (no process group: use torchrun)"))
    return dist.get_rank() if dist.is_initialized() else 0


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    """A 1-D mesh over every rank of the run (``n_devices`` must equal the
    world size: a run that asked for 8 must not train on fewer)."""
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    r = _world(n, f"'{axis}'")
    return Mesh({axis: n}, {axis: r},
                {axis: dist.group.WORLD if n > 1 else None})


def make_hybrid_mesh(dp: int, n: int, axes=("data", "seq")) -> Mesh:
    """A 2-D mesh of ``axes`` (("data", "seq") by default; ("data",
    "model") for tensor parallel, ("data", "pipe") for the pipeline): rank r
    sits at (r // n, r % n), as the JAX ``devices.reshape(dp, n)``.  Every
    rank creates every group, in one order, as ``new_group`` requires."""
    outer, inner = axes
    r = _world(dp * n, f"{dp}x{n} ({outer!r}, {inner!r})")
    d, s = divmod(r, n)
    groups = {outer: None, inner: None}
    if n > 1:
        for row in range(dp):
            g = dist.new_group([row * n + c for c in range(n)])
            if row == d:
                groups[inner] = g
    if dp > 1:
        for col in range(n):
            g = dist.new_group([row * n + col for row in range(dp)])
            if col == s:
                groups[outer] = g
    return Mesh({outer: dp, inner: n}, {outer: d, inner: s}, groups)


def shard_batch(batch, mesh: Mesh | None, axis: str = "data",
                micro_batches: int = 1):
    """This rank's rows of a global batch dict (arrays or tensors with a
    leading batch dim; other entries as they are): its block of the batch,
    or with ``micro_batches`` > 1 its block of each micro-batch
    (``data.loader.block_rows``)."""
    if mesh is None or mesh.size(axis) == 1:
        return batch
    return {k: local_rows(v, mesh, axis, micro_batches)
            if hasattr(v, "ndim") and v.ndim >= 1 else v
            for k, v in batch.items()}


def local_rows(x, mesh: Mesh | None, axis: str | None,
               micro_batches: int = 1):
    """This rank's rows of ``x`` (an array or a tensor with a leading
    batch dim) over ``axis``: all of them without that axis, else its block
    of each micro-batch (``data.loader.block_rows``)."""
    if mesh is None or axis is None or mesh.size(axis) == 1:
        return x
    rows = block_rows(x.shape[0], mesh.index(axis), mesh.size(axis),
                      micro_batches)
    if isinstance(x, torch.Tensor):
        return x[torch.as_tensor(rows, device=x.device)]
    return x[rows]


def replicate(module: torch.nn.Module, mesh: Mesh | None):
    """Broadcast ``module``'s parameters and buffers from rank 0 of the
    mesh to every rank, in place; returns it."""
    if mesh is None or comm.size(comm.world()) == 1:
        return module
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            if t.numel():
                comm.broadcast_(t.data, 0, comm.world())
    return module
