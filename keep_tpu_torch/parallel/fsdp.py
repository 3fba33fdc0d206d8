"""FSDP by hand over the dp group of the process mesh
(counterpart of ``keep_tpu/parallel/fsdp.py``).

The JAX package lays each large leaf out with its largest ``n``-divisible
axis sharded over 'dp' and lets XLA insert the all-gathers and the
reduce-scatters. The port's training step is a function over a parameter
dict, with no module wrapper, so FSDP2's ``fully_shard`` does not fit it;
the same layout is kept by hand:

- each rank keeps only its shard of every large leaf's fp32 master and of
  its AdamW moments (the training state);
- after each update the rank all-gathers the shards into the model's
  compute copy, which the next forward reads;
- the fp32 gradients of the compute copy are reduce-scattered into the
  shards, bucketed like ``mesh.all_reduce_grads``.

The compute copy stays whole between steps (ZeRO-2's layout, not
ZeRO-3's, which would gather each block's parameters only around its use):
a rank holds the whole copy and 1/n of the masters and of the moments.

Leaves below ``min_size`` elements (LayerNorm gains, most biases) and
leaves with no divisible axis replicate. The JAX package stacks the blocks
([L, ...]) and applies ``min_size`` to the stacked leaf, where the port
holds one leaf per block: the threshold here applies to L × the leaf's
size (``stack``, from ``stack_sizes``), so that the same leaves shard in
both packages. A leaf whose only divisible axis is JAX's layer axis stays
replicated here.
"""

from __future__ import annotations

import math
import re
from typing import Optional, Sequence

import torch

from keep_tpu_torch.parallel import mesh as pmesh

_BLOCK = re.compile(r"\.(blocks)\.\d+\.")


def fsdp_spec(shape: Sequence[int], n_dev: int, min_size: int = 1 << 16, *,
              base: Optional[Sequence] = None, axis: str = "dp",
              stack: int = 1) -> tuple:
    """The spec of a leaf of ``shape`` (one axis name or None per axis):
    ``axis`` on its largest still-free ``n_dev``-divisible axis (the last
    of equals, as the JAX package picks), when ``stack`` × its size is at
    least ``min_size``; ``base`` (a tensor-parallel spec) is kept and its
    axes excluded. All None: replicated."""
    spec = ([None] * len(shape) if base is None
            else list(base) + [None] * (len(shape) - len(base)))
    if stack * math.prod(shape) >= min_size:
        cands = [(s, i) for i, s in enumerate(shape)
                 if spec[i] is None and s % n_dev == 0]
        if cands:
            _, ax = max(cands)
            spec[ax] = axis
    return tuple(spec)


def axis_of(spec: tuple, name: str = "dp") -> Optional[int]:
    """The axis ``spec`` shards over ``name``, or None."""
    return spec.index(name) if name in spec else None


def stack_sizes(names) -> dict[str, int]:
    """{name: the number of blocks that hold the same leaf}: L for a
    block's leaf (``…blocks.{i}.…``), 1 for any other."""
    pattern = {n: _BLOCK.sub(".blocks.*.", n) for n in names}
    counts: dict[str, int] = {}
    for p in pattern.values():
        counts[p] = counts.get(p, 0) + 1
    return {n: counts[p] for n, p in pattern.items()}


def state_shardings(shapes: dict[str, Sequence[int]], n_dev: int,
                    min_size: int = 1 << 16) -> dict[str, tuple]:
    """{name: spec} of a state's leaves ({name: shape})."""
    stacks = stack_sizes(shapes)
    return {n: fsdp_spec(tuple(s), n_dev, min_size, stack=stacks[n])
            for n, s in shapes.items()}


def shard_of(t: torch.Tensor, axis: int, n: int, r: int) -> torch.Tensor:
    """Rank r's shard of ``t`` along ``axis``."""
    k = t.shape[axis] // n
    return t.narrow(axis, r * k, k)


def place_state(tree: dict[str, torch.Tensor], n_dev: int, rank: int,
                min_size: int = 1 << 16) -> dict[str, torch.Tensor]:
    """Rank ``rank``'s pieces of the full leaves ``tree``: each sharded
    leaf's shard (a copy), each replicated leaf itself."""
    specs = state_shardings({k: v.shape for k, v in tree.items()}, n_dev,
                            min_size)
    out = {}
    for k, v in tree.items():
        ax = axis_of(specs[k])
        out[k] = v if ax is None else shard_of(v, ax, n_dev,
                                               rank).contiguous()
    return out


def sharded_fraction(shapes: dict[str, Sequence[int]], n_dev: int,
                     min_size: int = 1 << 16) -> float:
    """Fraction of parameter elements that shard: observability for the
    log and the tests."""
    specs = state_shardings(shapes, n_dev, min_size)
    total = sharded = 0
    for k, s in shapes.items():
        n = math.prod(s) or 1
        total += n
        if axis_of(specs[k]) is not None:
            sharded += n
    return sharded / max(total, 1)


def all_gather_shards(shards: dict[str, torch.Tensor],
                      axes: dict[str, int], group) -> dict[str, torch.Tensor]:
    """The full leaves from every dp rank's shards, one all-gather per
    bucket (a collective: every rank of ``group`` calls it with the same
    names)."""
    n = pmesh.group_size(group)
    out = {}
    names = list(shards)
    for bucket in pmesh.buckets(shards, names):
        # each shard moved to put its sharded axis first, flattened
        flat = torch.cat([shards[k].movedim(axes[k], 0).reshape(-1)
                          for k in bucket])
        joined = pmesh.all_gather(flat, group).view(n, -1)
        off = 0
        for k in bucket:
            moved = shards[k].movedim(axes[k], 0)
            m = moved.numel()
            part = joined[:, off: off + m].reshape(n * moved.shape[0],
                                                   *moved.shape[1:])
            out[k] = part.movedim(0, axes[k])
            off += m
    return out


def reduce_scatter_grads(grads: dict[str, torch.Tensor],
                         axes: dict[str, int], group) -> dict[str, torch.Tensor]:
    """Each full gradient summed over the dp ranks, rank r keeping its
    shard along the leaf's sharded axis: one reduce-scatter per bucket."""
    n = pmesh.group_size(group)
    out = {}
    for bucket in pmesh.buckets(grads, list(grads)):
        # row r of the buffer holds every leaf's part for rank r
        flat = torch.cat([grads[k].movedim(axes[k], 0).reshape(n, -1)
                          for k in bucket], dim=1)
        mine = pmesh.reduce_scatter(flat.contiguous(), group).view(-1)
        off = 0
        for k in bucket:
            moved = grads[k].movedim(axes[k], 0)
            shape = (moved.shape[0] // n, *moved.shape[1:])
            m = math.prod(shape)
            out[k] = mine[off: off + m].view(shape).movedim(0, axes[k])
            off += m
    return out
