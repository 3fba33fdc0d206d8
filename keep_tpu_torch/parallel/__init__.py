"""Data parallelism (counterpart of ``keep_tpu/parallel``): the 'dp' mesh in
one process (``mesh``), and the process group, its environment discovery
and the training step's collectives across processes (``multihost``,
``mesh``). fsdp, tp, sp, pp and ep wait for ROADMAP item 10, step 2."""

from keep_tpu_torch.parallel.mesh import (  # noqa: F401
    all_reduce_grads,
    batch_sharding,
    dp_rank_world,
    gather_rows,
    local_rows,
    make_mesh,
    mean_over_ranks,
    pad_to_multiple,
    replicate,
    shard_batch,
)
