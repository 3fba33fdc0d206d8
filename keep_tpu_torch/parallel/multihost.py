"""Multi-process coordination over ``torch.distributed`` (counterpart of
``keep_tpu/parallel/multihost.py``).

The reference's ``broadcast_object`` / ``all_gather_object``
(training/path_training/distributed.py:117-137) coordinate Python objects
across DDP ranks, e.g. the experiment name and the resume checkpoint. One
process runs per card; with no launcher in the environment these pass their
argument through, so the same code runs everywhere.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

DEFAULT_PORT = "7709"


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value in (None, "") else int(value)


def discover() -> Optional[dict]:
    """The launcher's rank layout, in the reference's discovery order
    (distributed.py:24-60), or None for a single process:

    1. torchrun: ``MASTER_ADDR`` / ``MASTER_PORT`` (default 7709) /
       ``RANK`` / ``WORLD_SIZE``. torchrun's layout counts at any world
       size, 1 included: a world-1 group runs the same collectives. A rank
       missing at ``WORLD_SIZE > 1`` fails fast (every process would join
       as rank 0 and hang the rendezvous); ``SLURM_PROCID`` may stand in.
    2. SLURM: ``SLURM_PROCID`` / ``SLURM_NTASKS`` (> 1), the address from
       ``MASTER_ADDR`` or ``SLURM_LAUNCH_NODE_IPADDR``.
    3. OpenMPI: ``OMPI_COMM_WORLD_RANK`` / ``OMPI_COMM_WORLD_SIZE`` (> 1),
       the address from ``MASTER_ADDR``.

    The JAX package also reads a Cloud TPU pod's markers
    (``TPU_WORKER_HOSTNAMES``, ``MEGASCALE_*``); they name TPU hosts and
    have no meaning for a card, so they are not read here.

    Returns {'addr', 'port', 'rank', 'world', 'local_rank'}."""
    env = os.environ
    port = env.get("MASTER_PORT") or DEFAULT_PORT
    world = _env_int("WORLD_SIZE")
    if env.get("MASTER_ADDR") and world:
        rank = _env_int("RANK")
        if rank is None:
            rank = _env_int("SLURM_PROCID")
        if rank is None:
            if world > 1:
                raise ValueError(
                    "MASTER_ADDR + WORLD_SIZE>1 set but no RANK (or "
                    "SLURM_PROCID) in the environment — export RANK per "
                    "process (torchrun does)")
            rank = 0
        local = _env_int("LOCAL_RANK")
        return {"addr": env["MASTER_ADDR"], "port": port, "rank": rank,
                "world": world, "local_rank": rank if local is None
                else local}
    for rank_var, world_var, local_var, addr_var in (
            ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID",
             "SLURM_LAUNCH_NODE_IPADDR"),
            ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE",
             "OMPI_COMM_WORLD_LOCAL_RANK", "MASTER_ADDR")):
        world = _env_int(world_var) or 0
        if world > 1:
            rank = _env_int(rank_var) or 0
            local = _env_int(local_var)
            return {"addr": env.get("MASTER_ADDR") or env.get(addr_var)
                    or "127.0.0.1", "port": port, "rank": rank,
                    "world": world,
                    "local_rank": rank if local is None else local}
    return None


def init_from_env(device: str | torch.device = "cuda",
                  backend: Optional[str] = None) -> bool:
    """Initializes ``torch.distributed`` from the launcher's environment
    (``discover``): NCCL when the run's ``device`` is CUDA, gloo on the
    CPU, unless ``backend`` names one. On a CUDA run whose ``device`` names
    no index, the current card becomes the local rank's. Returns True when
    a process group is up (an existing one included), False for a single
    process (a no-op), so that ``python -m keep_tpu_torch.train.main`` runs
    the same under torchrun, srun, mpirun or alone."""
    if dist.is_initialized():
        return True
    layout = discover()
    if layout is None:
        return False
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda" and device.index is None:
        torch.cuda.set_device(layout["local_rank"])
    dist.init_process_group(
        backend, init_method=f"tcp://{layout['addr']}:{layout['port']}",
        world_size=layout["world"], rank=layout["rank"])
    logging.info("torch.distributed (%s): rank %d of %d", backend,
                 layout["rank"], layout["world"])
    return True


def local_device(device: str | torch.device) -> torch.device:
    """The device this process runs on: a CUDA device without an index is
    the current card (the local rank's once ``init_from_env`` ran)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_master() -> bool:
    return process_index() == 0


def broadcast_object(obj: Any, name: str = "broadcast") -> Any:
    """Process 0's picklable ``obj`` on every process (reference
    broadcast_object, distributed.py:117-127); ``name`` is the JAX
    package's label and is not used."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def all_gather_object(obj: Any) -> list[Any]:
    """One picklable object per process, in rank order (reference
    all_gather_object, distributed.py:130-137)."""
    if process_count() == 1:
        return [obj]
    out: list[Any] = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out
