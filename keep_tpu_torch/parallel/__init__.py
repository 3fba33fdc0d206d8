"""Parallelism (counterpart of ``keep_tpu/parallel``): the 'dp' mesh in one
process and the dp × mp / pp / ep process meshes of training (``mesh``),
the process group and its environment discovery (``multihost``), FSDP
(``fsdp``), tensor parallelism (``tp``), sequence parallelism (``sp``) and
pipeline parallelism (``pp``); expert parallelism lives with the MoE trunk
(``models.moe``)."""

from keep_tpu_torch.parallel.mesh import (  # noqa: F401
    ProcessMesh,
    all_reduce_grads,
    batch_sharding,
    dp_rank_world,
    gather_rows,
    local_rows,
    make_hybrid_mesh,
    make_mesh,
    mean_over_ranks,
    pad_to_multiple,
    replicate,
    shard_batch,
    use_mesh,
)
