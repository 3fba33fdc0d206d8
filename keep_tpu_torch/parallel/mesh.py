"""Data parallelism: device meshes in one process, and the collectives of a
training step across processes (counterpart of
``keep_tpu/parallel/mesh.py``).

Two forms of one layout, the JAX package's 'dp' axis:

- **In one process** (the server, WSI extraction): a mesh is an ordered
  tuple of ``torch.device``s. A batch splits into one contiguous chunk per
  device, in order; the model is replicated on each device.
- **Across processes** (training, one process per card): rank r of N holds
  rows [r·B/N, (r+1)·B/N) of the global batch. ``gather_rows`` joins the
  rows' features for the loss; ``all_reduce_grads`` sums the gradients.

Every rank computes the same global loss from the gathered features, so a
collective's backward takes the rank's own part of the gradient without
communicating (``gather_rows``: its rows; ``mean_over_ranks``: 1/N), and
summing the ranks' parameter gradients gives the global batch's. A
parameter that enters the loss only after the gather (``logit_scale``)
already holds the whole gradient on every rank: it is not summed.

The JAX package's ``make_hybrid_mesh`` and the tp / pp / sp / ep / fsdp
layouts wait for ROADMAP item 10, step 2.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

STEP_2 = "ROADMAP queue 1, item 10, step 2 (tp, pp, sp, ep, fsdp)"


# -- meshes in one process ----------------------------------------------------


def make_mesh(n_devices: Optional[int] = None, axes: Sequence[str] = ("dp",),
              devices: Optional[Sequence] = None) -> tuple[torch.device, ...]:
    """The first ``n_devices`` of ``devices`` (default: every CUDA device)
    as a 'dp' mesh. Raises ValueError when fewer are present."""
    if tuple(axes) != ("dp",):
        raise NotImplementedError(f"a mesh over axes {tuple(axes)} is "
                                  f"{STEP_2}, not ported yet")
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices) if n_devices is None else int(n_devices)
    if n < 1 or n > len(devices):
        raise ValueError(f"a mesh of {n} devices needs {n} present, found "
                         f"{len(devices)}")
    return tuple(devices[:n])


def batch_sharding(mesh: Sequence, n: int) -> list[slice]:
    """The rows of a batch of ``n`` that each device of ``mesh`` takes: one
    contiguous chunk per device, in order (``n`` divisible by the mesh)."""
    k = len(mesh)
    if n % k:
        raise ValueError(f"a batch of {n} does not divide over {k} devices")
    step = n // k
    return [slice(i * step, (i + 1) * step) for i in range(k)]


def shard_batch(mesh: Sequence, tree, non_blocking: bool = False) -> list:
    """A host batch (an array, or a dict of arrays) split along its leading
    axis: one tree per device of ``mesh``, its chunk copied there."""
    def put(x, rows, device):
        t = torch.as_tensor(np.ascontiguousarray(x[rows]))
        return t.to(device, non_blocking=non_blocking)

    n = len(next(iter(tree.values())) if isinstance(tree, dict) else tree)
    out = []
    for rows, device in zip(batch_sharding(mesh, n), mesh):
        if isinstance(tree, dict):
            out.append({k: put(v, rows, device) for k, v in tree.items()})
        else:
            out.append(put(tree, rows, device))
    return out


def replicate(mesh: Sequence, module: torch.nn.Module) -> list:
    """``module`` on each device of ``mesh``: the module itself where it
    already lives, one copy per other device (a device listed twice shares
    its copy)."""
    own = next(module.parameters()).device
    copies = {own: module}
    for d in mesh:
        if d not in copies:
            copies[d] = copy.deepcopy(module).to(d)
    return [copies[d] for d in mesh]


def pad_to_multiple(x: np.ndarray, multiple: int,
                    axis: int = 0) -> tuple[np.ndarray, int]:
    """Pad the leading axis so it divides the mesh (returns (padded,
    n_valid))."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, rem)
    return np.pad(x, pad), n


# -- data parallelism across processes ----------------------------------------


def dp_rank_world() -> tuple[int, int]:
    """(rank, world) of the process group, (0, 1) without one."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_rows(n: int, name: str = "batch_size") -> slice:
    """This rank's rows of a global batch of ``n``; ValueError naming
    ``name`` when ``n`` does not divide over the ranks."""
    rank, world = dp_rank_world()
    if n % world:
        raise ValueError(f"{name} {n} does not divide over {world} ranks "
                         f"(the global batch splits evenly)")
    step = n // world
    return slice(rank * step, (rank + 1) * step)


def _staged(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend can run a collective on it: gloo takes host
    tensors only, so a CUDA tensor goes through a host copy."""
    if t.is_cuda and dist.get_backend() == "gloo":
        return t.cpu()
    return t


def _all_gather(x: torch.Tensor) -> torch.Tensor:
    world = dist.get_world_size()
    src = _staged(x.contiguous())
    out = src.new_empty((world * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src)
    return out.to(x.device)


def _all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sums ``t`` over the ranks in place."""
    src = _staged(t)
    dist.all_reduce(src)
    if src is not t:
        t.copy_(src)
    return t


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.rows = local_rows(dist.get_world_size() * x.shape[0], "rows")
        return _all_gather(x)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rows]


class _MeanOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce_(x.detach().clone()) / dist.get_world_size()

    @staticmethod
    def backward(ctx, grad):
        return grad / dist.get_world_size()


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x`` joined in rank order (the global batch);
    the backward returns this rank's rows of the gradient. ``x`` itself
    without a process group."""
    if not dist.is_initialized():
        return x
    return _GatherRows.apply(x)


def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks (a statistic of equal shards: the
    global batch's); the backward takes 1/N of the gradient. ``x`` itself
    without a process group."""
    if not dist.is_initialized():
        return x
    return _MeanOverRanks.apply(x)


BUCKET_ELEMENTS = 1 << 26  # 256 MB of fp32 per all-reduce


def all_reduce_grads(grads: dict[str, torch.Tensor],
                     names: Optional[Sequence[str]] = None,
                     replicated: Sequence[str] = ("logit_scale",)) -> dict:
    """Sums the gradients named in ``names`` (default: all) over the ranks,
    flattened into buffers of at most ``BUCKET_ELEMENTS`` values per
    dtype; the gradients of ``replicated`` parameters (used only after the
    gather, so whole on every rank) stay as they are. Returns ``grads``
    updated in place. Nothing to do without a process group."""
    if not dist.is_initialized():
        return grads
    skip = set(replicated)
    todo = [n for n in (grads if names is None else names) if n not in skip]
    buckets: dict[tuple, list[list[str]]] = {}
    for n in todo:
        g = grads[n]
        key = (g.dtype, g.device)
        groups = buckets.setdefault(key, [[]])
        size = sum(grads[m].numel() for m in groups[-1])
        if groups[-1] and size + g.numel() > BUCKET_ELEMENTS:
            groups.append([])
        groups[-1].append(n)
    for groups in buckets.values():
        for group in groups:
            flat = torch.cat([grads[n].reshape(-1) for n in group])
            _all_reduce_(flat)
            off = 0
            for n in group:
                k = grads[n].numel()
                grads[n] = flat[off: off + k].view_as(grads[n])
                off += k
    return grads
