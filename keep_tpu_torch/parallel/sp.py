"""Sequence parallelism (Megatron-SP) over the mp group by hand (counterpart
of ``keep_tpu/parallel/sp.py``, which states it as a GSPMD sharding
constraint on the [B, S, D] residual stream).

Between the blocks of a tower the stream is split along S over the mp
group: each rank keeps rows [r·Sp/mp, (r+1)·Sp/mp) of the stream padded to
Sp, the least multiple of mp ≥ S (ViT-L's 197 tokens over mp = 2 take one
pad row). The LayerNorms, LayerScale and residual adds run on a rank's rows
only. Each pair's input is gathered over S (backward: reduce-scatter) and
trimmed to S, so that no pad row becomes a key of the attention; a split
pair's output is reduce-scattered back onto the rank's rows (backward:
all-gather), Megatron-SP's collectives in place of tensor parallelism's
all-reduce. The pad rows never reach a real token and the loss does not
read them, so their gradients are zero.

A leaf used on a rank's rows only (the blocks' LayerNorms and LayerScale,
a split pair's row bias, a replicated pair) holds that rank's part of its
gradient: the trainer sums those over the mp group
(``trainer.ParallelLayout``).

The JAX package refuses sp on the MoE trunk; so does the trainer here.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from keep_tpu_torch.parallel import mesh as pmesh


def _gather_s(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' [B, k, ...] joined along dim 1 in rank order."""
    return pmesh.all_gather(x.movedim(1, 0), group).movedim(0, 1)


def _reduce_scatter_s(x: torch.Tensor, group) -> torch.Tensor:
    """[B, n·k, ...] summed over the ranks, rank r keeping rows along dim 1
    [r·k, (r+1)·k)."""
    return pmesh.reduce_scatter(x.movedim(1, 0), group).movedim(0, 1)


def _rows(x: torch.Tensor, n: int, r: int) -> torch.Tensor:
    k = x.shape[1] // n
    return x[:, r * k: (r + 1) * k]


class _Scatter(torch.autograd.Function):
    """This rank's rows forward; backward the ranks' row gradients joined
    (the input is the same on every rank and feeds every rank's rows)."""

    @staticmethod
    def forward(ctx, x, group, n, r):
        ctx.group = group
        return _rows(x, n, r).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _gather_s(grad.contiguous(), ctx.group), None, None, None


class _Slice(torch.autograd.Function):
    """This rank's rows forward; backward its rows' gradient in place,
    zeros elsewhere (the input is this rank's own full computation, whose
    other rows the other ranks keep)."""

    @staticmethod
    def forward(ctx, x, n, r):
        ctx.shape, ctx.n, ctx.r = x.shape, n, r
        return _rows(x, n, r).contiguous()

    @staticmethod
    def backward(ctx, grad):
        full = grad.new_zeros(ctx.shape)
        _rows(full, ctx.n, ctx.r).copy_(grad)
        return full, None, None


class _Gather(torch.autograd.Function):
    """All-gather along S forward; reduce-scatter backward (each rank's
    computation on the full sequence differs, through its own weights or
    its own kept rows)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_s(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter_s(grad, ctx.group), None


class _GatherReplicated(torch.autograd.Function):
    """All-gather along S forward; backward this rank's rows of the
    gradient (what follows is the same on every rank: the tower's end)."""

    @staticmethod
    def forward(ctx, x, group, n, r):
        ctx.n, ctx.r = n, r
        return _gather_s(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _rows(grad, ctx.n, ctx.r).contiguous(), None, None, None


class _ReduceScatter(torch.autograd.Function):
    """Reduce-scatter along S forward (a split pair's partial sums onto
    the ranks' rows); all-gather backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter_s(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _gather_s(grad.contiguous(), ctx.group), None


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """One tower's sequence split: the mp group, its size and this rank's
    index, the true length ``s`` and the padded length ``sp``."""

    group: object
    n: int
    r: int
    s: int
    sp: int

    def _pad(self, x: torch.Tensor) -> torch.Tensor:
        return F.pad(x, (0, 0, 0, self.sp - x.shape[1]))

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The full stream [B, S, D] (the same on every rank) → this rank's
        rows of it padded to ``sp``."""
        return _Scatter.apply(self._pad(x), self.group, self.n, self.r)

    def leave(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows → the full stream [B, S, D] on every rank."""
        return _GatherReplicated.apply(x, self.group, self.n,
                                       self.r)[:, :self.s]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """A pair's input: the full stream, trimmed to S."""
        return _Gather.apply(x, self.group)[:, :self.s]

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """A split pair's partial output [B, S, D] → the sum's rows of this
        rank."""
        return _ReduceScatter.apply(self._pad(x).contiguous(), self.group)

    def scatter(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated pair's output [B, S, D] → this rank's rows."""
        return _Slice.apply(self._pad(x), self.n, self.r)


@dataclasses.dataclass(frozen=True)
class SeqParallel:
    """The ``act_sharding`` of the towers' forwards: the residual stream
    split along S over ``group`` (the mesh's mp group)."""

    group: object
    n: int
    r: int

    def shard(self, s: int) -> SeqShard:
        return SeqShard(self.group, self.n, self.r, s,
                        -(-s // self.n) * self.n)


def seq_shard(act_sharding, s: int) -> SeqShard:
    """A tower's ``act_sharding`` for its stream of length ``s``; anything
    but a ``SeqParallel`` raises TypeError (the JAX package's sharding
    objects have no counterpart here)."""
    if not isinstance(act_sharding, SeqParallel):
        raise TypeError(f"act_sharding is a parallel.sp.SeqParallel (the "
                        f"stream's split over the mesh's mp group; "
                        f"parallel.sp.seq_sharding), got "
                        f"{type(act_sharding).__name__}")
    return act_sharding.shard(s)


def seq_sharding(mesh: pmesh.ProcessMesh, sp_axis: str = "mp") -> SeqParallel:
    """The towers' ``act_sharding`` for ``mesh``: the stream split along S
    over ``sp_axis`` (Megatron-SP reuses the tensor-parallel group; the
    batch is already split over 'dp')."""
    return SeqParallel(mesh.group(sp_axis), mesh.size(sp_axis),
                       mesh.rank(sp_axis))
