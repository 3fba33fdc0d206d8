"""Device meshes in one process, the process mesh of training across
processes, and the collectives of a training step (counterpart of
``keep_tpu/parallel/mesh.py``).

- **In one process** (the server, WSI extraction): a 'dp' mesh is an
  ordered tuple of ``torch.device``s. A batch splits into one contiguous
  chunk per device, in order; the model is replicated on each device.
- **Across processes** (training, one process per card): the ranks of the
  ``torch.distributed`` group form a ``ProcessMesh``, 'dp' alone or 'dp' ×
  one inner axis: 'mp' (tensor and sequence parallelism: ``parallel.tp``,
  ``parallel.sp``), 'pp' (pipeline stages: ``parallel.pp``) or 'ep'
  (experts: ``models.moe``), as ``make_mesh(axes=("dp", "pp"), shape=(dp,
  pp))`` or ``make_hybrid_mesh``. Ranks are numbered dp-major with the
  inner axis last, so that its groups stay inside a node. The inner ranks
  of one dp index share their rows of the global batch: dp index i of N
  holds rows [i·B/N, (i+1)·B/N). ``gather_rows`` joins the rows' features
  over the dp group for the loss; ``all_reduce_grads`` sums the gradients
  over it.

Every rank computes the same global loss from the gathered features, so a
collective's backward takes the rank's own part of the gradient without
communicating (``gather_rows``: its rows; ``mean_over_ranks``: 1/N), and
summing the ranks' parameter gradients gives the global batch's. A
parameter that enters the loss only after the gather (``logit_scale``)
already holds the whole gradient on every rank: it is not summed.

The training run sets its mesh with ``use_mesh``; without one the dp group
is every rank.

Every collective here goes through ``_staged``: gloo runs its collectives
and its point-to-point sends on host tensors only, and the card's
multi-rank runs share one device over gloo (NCCL refuses two ranks on one
device), so a CUDA tensor travels through a host copy there.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# the axes a process mesh lays ranks out on: data, tensor (and sequence),
# pipeline and expert parallelism
AXES = ("dp", "mp", "pp", "ep")


# -- the process mesh of a training run ----------------------------------------


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """The ranks of the process group laid out over named axes, row-major
    (the last axis inner): this rank's index along each axis and its group
    along each (the ranks that differ from it along that axis only; None
    for an axis of size 1)."""

    axes: tuple[str, ...]
    shape: tuple[int, ...]
    index: tuple[int, ...]
    groups: tuple

    def size(self, axis: str) -> int:
        return self.shape[self.axes.index(axis)] if axis in self.axes else 1

    def rank(self, axis: str) -> int:
        return self.index[self.axes.index(axis)] if axis in self.axes else 0

    def group(self, axis: str):
        return self.groups[self.axes.index(axis)] if axis in self.axes \
            else None


def _process_mesh(axes: Sequence[str], shape: Sequence[int]) -> ProcessMesh:
    """Every rank calls ``dist.new_group`` for every group of every axis in
    one order (the collective contract of ``new_group``) and keeps its
    own."""
    axes, shape = tuple(axes), tuple(int(n) for n in shape)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {shape} over axes {axes} needs "
                         f"{math.prod(shape)} ranks, the group has {world}")
    ranks = np.arange(world).reshape(shape)
    me = dist.get_rank()
    index = tuple(int(i) for i in np.argwhere(ranks == me)[0])
    groups = []
    for a in range(len(axes)):
        lines = np.moveaxis(ranks, a, -1).reshape(-1, shape[a])
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if me in line:
                groups.append(g)
    return ProcessMesh(axes, shape, index, tuple(groups))


def make_hybrid_mesh(ici_shape: Sequence[int], dcn_shape: Sequence[int],
                     axes: Sequence[str]) -> ProcessMesh:
    """A process mesh over several nodes: axis i spans ``dcn_shape[i]`` ·
    ``ici_shape[i]`` ranks, ``dcn_shape`` counting nodes and ``ici_shape``
    the ranks inside one. Keep 'dp' the only axis that crosses nodes, as
    the JAX package's recipe does::

        mesh = make_hybrid_mesh((per_node // tp, tp), (nodes, 1),
                                axes=("dp", "mp"))

    The launcher numbers ranks node-major (torchrun, srun), so the
    row-major layout puts each group of an axis with ``dcn_shape[i] == 1``
    inside one node; an inner axis wider than a node raises."""
    if len(ici_shape) != len(dcn_shape) or len(ici_shape) != len(axes):
        raise ValueError(
            f"ici_shape {tuple(ici_shape)} / dcn_shape {tuple(dcn_shape)} "
            f"/ axes {tuple(axes)} must have equal rank")
    shape = tuple(int(d) * int(i) for d, i in zip(dcn_shape, ici_shape))
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE",
                                  dist.get_world_size()))
    crossing = [i for i, d in enumerate(dcn_shape) if d > 1]
    if crossing:
        # the axes after the last one that crosses nodes lie in one node
        inner = math.prod(shape[crossing[-1] + 1:])
        if inner > per_node or per_node % inner:
            raise ValueError(f"the axes inside a node span {inner} ranks, "
                             f"a node holds {per_node}")
    return _process_mesh(axes, shape)


_MESH: Optional[ProcessMesh] = None


@contextlib.contextmanager
def use_mesh(mesh: Optional[ProcessMesh]):
    """Makes ``mesh`` the training run's mesh while the block runs: the
    collectives of this module then work over its dp group."""
    global _MESH
    saved, _MESH = _MESH, mesh
    try:
        yield mesh
    finally:
        _MESH = saved


def current_mesh() -> Optional[ProcessMesh]:
    return _MESH


def dp_group():
    """The dp group of the current mesh (None: every rank)."""
    return None if _MESH is None else _MESH.group("dp")


# -- meshes in one process ----------------------------------------------------


def make_mesh(n_devices: Optional[int] = None, axes: Sequence[str] = ("dp",),
              devices: Optional[Sequence] = None,
              shape: Optional[Sequence[int]] = None):
    """A 'dp' mesh in one process: the first ``n_devices`` of ``devices``
    (default: every CUDA device), a tuple of ``torch.device``s; ValueError
    when fewer are present. Any other ``axes`` (('dp', 'mp'), ('dp', 'pp'),
    ('dp', 'ep')) is a ``ProcessMesh`` over the ranks of the process group,
    of ``shape`` (default: every rank on 'dp'), the last axis inner; a shape
    whose product is not the group's size raises ValueError."""
    axes = tuple(axes)
    if axes != ("dp",) or shape is not None:
        unknown = [a for a in axes if a not in AXES]
        if unknown or len(set(axes)) != len(axes):
            raise ValueError(f"mesh axes {axes}: each one of {AXES}, once")
        if not dist.is_initialized():
            raise ValueError(f"a mesh over axes {axes} lays out the ranks "
                             f"of a process group: join one first")
        world = dist.get_world_size()
        if shape is None:
            shape = (world,) + (1,) * (len(axes) - 1)
        return _process_mesh(axes, shape)
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
    """(index, size) of this rank along 'dp': the current mesh's, else the
    process group's rank and size; (0, 1) without one."""
    if _MESH is not None:
        return _MESH.rank("dp"), _MESH.size("dp")
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


def group_size(group) -> int:
    return dist.get_world_size(group)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' ``x`` of ``group`` (default: every rank) joined along
    dim 0 in rank order."""
    world = dist.get_world_size(group)
    src = _staged(x.contiguous())
    out = src.new_empty((world * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.to(x.device)


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sums ``t`` over the ranks of ``group`` (default: every rank) in
    place."""
    src = _staged(t)
    dist.all_reduce(src, group=group)
    if src is not t:
        t.copy_(src)
    return t


def send(t: torch.Tensor, dst: int, group) -> None:
    """Sends ``t`` to the rank of index ``dst`` in ``group`` (blocking)."""
    dist.send(_staged(t.contiguous()), dist.get_global_rank(group, dst),
              group=group)


def recv(like: torch.Tensor, src: int, group) -> torch.Tensor:
    """A tensor of ``like``'s shape, dtype and device received from the
    rank of index ``src`` in ``group`` (blocking)."""
    buf = _staged(torch.empty_like(
        like, memory_format=torch.contiguous_format))
    dist.recv(buf, dist.get_global_rank(group, src), group=group)
    return buf.to(like.device)


def reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` [n·k, ...] summed over the ranks of ``group``, rank r keeping
    rows [r·k, (r+1)·k)."""
    world = dist.get_world_size(group)
    src = _staged(x.contiguous())
    out = src.new_empty((src.shape[0] // world,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.to(x.device)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        group = dp_group()
        ctx.rows = local_rows(dist.get_world_size(group) * x.shape[0],
                              "rows")
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rows]


class _MeanOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        group = dp_group()
        ctx.n = dist.get_world_size(group)
        return all_reduce_(x.detach().clone(), group) / ctx.n

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.n


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every dp rank's rows of ``x`` joined in rank order (the global
    batch); the backward returns this rank's rows of the gradient. ``x``
    itself without a process group."""
    if not dist.is_initialized():
        return x
    return _GatherRows.apply(x)


def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the dp ranks (a statistic of equal shards:
    the global batch's); the backward takes 1/N of the gradient. ``x``
    itself without a process group."""
    if not dist.is_initialized():
        return x
    return _MeanOverRanks.apply(x)


BUCKET_ELEMENTS = 1 << 26  # 256 MB of fp32 per all-reduce


def buckets(tensors: dict[str, torch.Tensor], names: Sequence[str],
            elements: int = None) -> list[list[str]]:
    """``names`` in order, grouped by (dtype, device) into buckets of at
    most ``elements`` (default ``BUCKET_ELEMENTS``) values, a larger tensor
    alone in its own."""
    elements = BUCKET_ELEMENTS if elements is None else elements
    out: dict[tuple, list[list[str]]] = {}
    for n in names:
        t = tensors[n]
        groups = out.setdefault((t.dtype, t.device), [[]])
        size = sum(tensors[m].numel() for m in groups[-1])
        if groups[-1] and size + t.numel() > elements:
            groups.append([])
        groups[-1].append(n)
    return [g for groups in out.values() for g in groups]


def all_reduce_grads(grads: dict[str, torch.Tensor],
                     names: Optional[Sequence[str]] = None,
                     replicated: Sequence[str] = ("logit_scale",),
                     group="dp") -> dict:
    """Sums the gradients named in ``names`` (default: all) over the ranks
    of ``group`` (default: the current mesh's dp group, every rank without
    a mesh), flattened into buffers of at most ``BUCKET_ELEMENTS`` values
    per dtype; the gradients of ``replicated`` parameters (used only after
    the gather, so whole on every rank) stay as they are. Returns ``grads``
    updated in place. Nothing to do without a process group."""
    if not dist.is_initialized():
        return grads
    if group == "dp":
        group = dp_group()
    skip = set(replicated)
    todo = [n for n in (grads if names is None else names) if n not in skip]
    for bucket in buckets(grads, todo):
        flat = torch.cat([grads[n].reshape(-1) for n in bucket])
        all_reduce_(flat, group)
        off = 0
        for n in bucket:
            k = grads[n].numel()
            grads[n] = flat[off: off + k].view_as(grads[n])
            off += k
    return grads
