"""Multi-rank runs over ``torch.distributed``, one process per rank.

Submodules: ``comm`` (the collectives, and their adjoint convention),
``mesh`` (process groups, the named mesh, the batch helpers), ``fsdp``
(ZeRO sharding of the parameters and AdamW moments over ``data``),
``seq_scan`` (the sequence-sharded selective scan over ``seq``), and the
Mamba LM's ``tensor_parallel`` (mixers split over ``model``) and
``pipeline`` (GPipe stages over ``pipe``).
"""

from vivim_tpu_torch.parallel.fsdp import (
    fsdp_state_shardings,
    shard_state_fsdp,
)
from vivim_tpu_torch.parallel.mesh import (
    init_distributed,
    make_hybrid_mesh,
    make_mesh,
    replicate,
    shard_batch,
)

__all__ = ["make_mesh", "make_hybrid_mesh", "shard_batch", "replicate",
           "init_distributed", "fsdp_state_shardings", "shard_state_fsdp"]
