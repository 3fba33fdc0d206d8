"""Pipeline parallelism over the 'pp' axis of the process mesh: GPipe over
the visual trunk by hand (counterpart of ``keep_tpu/parallel/pp.py``).

Stage i of n holds layers [i·L/n, (i+1)·L/n) of the trunk (``stage_model_``
leaves the other stages' blocks as ``HeldElsewhere`` placeholders, so that
a rank keeps only its own blocks, their fp32 masters and their moments);
everything else is replicated. A batch splits into M microbatches (default
n) along its leading axis, as the JAX package's ``x.reshape(m, b // m,
...)``. The JAX package writes the schedule as a ``lax.scan`` over M + n − 1
ticks inside one ``shard_map``; here each rank runs its own ticks eagerly:

- forward: stage 0 feeds microbatch t from its input, stage i > 0 receives
  it from stage i − 1 (one [mb, S, D] hop), runs its blocks and sends the
  result on to stage i + 1; the last stage banks it. Bubble ticks compute
  nothing (JAX computes on zeros and masks the result: the same values);
- the last stage's outputs are replicated on every pp rank as JAX's masked
  ``psum`` replicates them (``_Replicate``: the other ranks contribute
  zeros to a sum, exact; its backward passes each rank's gradient, the
  same on every rank, straight through);
- backward (``_Pipeline.backward``): microbatch by microbatch in the
  forward's order, stage i receives its output's gradient from stage i + 1
  (the last stage takes it from the replicated output), runs its blocks'
  backward and sends its input's gradient to stage i − 1. Every send is
  matched by its receive in the same tick order on both sides and the last
  stage receives nothing, so the hops cannot deadlock.

The trunk's input (the stem's output, computed on every rank as in JAX)
reaches the blocks on stage 0 only: its gradient is stage 0's, summed over
the pp group with the other ranks' zeros, so that every leaf that is not
staged gets the same gradient on every pp rank and the copies never drift.

``remat`` keeps only each microbatch's input on a stage and recomputes its
blocks in the backward, one microbatch at a time (the launches of per-block
remat: two forwards and one backward a block): the hops stay outside every
recomputed region, since a send inside one would be sent again.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from keep_tpu_torch.parallel import mesh as pmesh

_STAGED = re.compile(r"^visual\.blocks\.(\d+)\.")


class HeldElsewhere(nn.Module):
    """A trunk block held by another pipeline stage: no parameters, and
    calling it raises (a staged trunk runs through ``pipeline_blocks``)."""

    def __init__(self, index: int, stage: int):
        super().__init__()
        self.index, self.stage = index, stage

    def forward(self, *args, **kw):
        raise RuntimeError(f"block {self.index} of the trunk is held by pp "
                           f"stage {self.stage}: run the staged trunk through "
                           f"parallel.pp.pipeline_blocks (encode_image_pp)")


def stage_of(index: int, depth: int, n: int) -> int:
    """The stage that holds layer ``index`` of ``depth`` over ``n``."""
    return index // (depth // n)


def pp_state_specs(names: Sequence[str], depth: int,
                   n: int) -> dict[str, Optional[int]]:
    """{name: the stage that holds it, or None (replicated)} of a KEEP
    model's parameter names (or its moments', which mirror them): the
    visual trunk's blocks stage along the layer order when ``depth`` % n ==
    0, as ``pp_state_shardings`` stages the stacked [L, ...] leaves whose
    layer axis divides; everything else replicates."""
    out: dict[str, Optional[int]] = {}
    for name in names:
        m = _STAGED.match(name)
        out[name] = (stage_of(int(m.group(1)), depth, n)
                     if m and n > 1 and depth % n == 0 else None)
    return out


def pp_fraction(model: nn.Module, n: int) -> float:
    """Fraction of parameter elements (of the one-process model) staged
    over ``n`` pipeline stages."""
    shapes = {k: p.shape for k, p in model.named_parameters()}
    specs = pp_state_specs(list(shapes), len(model.visual.blocks), n)
    total = staged = 0
    for k, s in shapes.items():
        e = math.prod(s) or 1
        total += e
        if specs[k] is not None:
            staged += e
    return staged / max(total, 1)


@torch.no_grad()
def stage_model_(model: nn.Module, mesh: pmesh.ProcessMesh) -> dict:
    """Stages a KEEP model's visual trunk over the mesh's pp group in
    place: this rank keeps its stage's blocks, the others become
    ``HeldElsewhere``. Returns the specs (``pp_state_specs``, taken on the
    one-process names)."""
    n, r = mesh.size("pp"), mesh.rank("pp")
    blocks = model.visual.blocks
    depth = len(blocks)
    specs = pp_state_specs([k for k, _ in model.named_parameters()], depth,
                           n)
    if n > 1 and depth % n == 0:
        for j in range(depth):
            s = stage_of(j, depth, n)
            if s != r:
                blocks[j] = HeldElsewhere(j, s)
    return specs


def _tensors(blocks: Sequence) -> list[torch.Tensor]:
    """The tensors a stage's blocks compute with: a module's parameters, a
    dict's or a sequence's values."""
    out: list[torch.Tensor] = []
    for blk in blocks:
        if isinstance(blk, nn.Module):
            out.extend(blk.parameters())
        elif isinstance(blk, dict):
            out.extend(blk.values())
        else:
            out.extend(blk)
    return out


class _Pipeline(torch.autograd.Function):
    """This stage's part of the GPipe schedule over the pp group: forward
    the microbatches through the stage's blocks with one hop a boundary;
    the last stage returns its outputs, the others zeros (JAX's mask).
    ``params`` are the stage's tensors, inputs so that their gradients
    come back through the outer autograd."""

    @staticmethod
    def forward(ctx, x, run, mb_rows, group, n, r, remat, *params):
        ctx.run, ctx.group, ctx.n, ctx.r = run, group, n, r
        ctx.mb_rows, ctx.params = mb_rows, params
        keep = not remat and any(ctx.needs_input_grad)
        ins, outs, ys = [], [], []
        for t in range(x.shape[0] // mb_rows):
            if r == 0:
                h = x[t * mb_rows: (t + 1) * mb_rows]
            else:
                h = pmesh.recv(x[:mb_rows], r - 1, group)
            h = h.detach().requires_grad_(keep)
            with torch.set_grad_enabled(keep):
                y = run(h)
            if r < n - 1:
                pmesh.send(y.detach(), r + 1, group)
            else:
                outs.append(y.detach())
            ins.append(h)
            ys.append(y if keep else None)
        ctx.ins, ctx.ys = ins, ys
        if r == n - 1:
            return torch.cat(outs)
        return torch.zeros_like(x)

    @staticmethod
    def backward(ctx, grad):
        n, r, group, mb_rows = ctx.n, ctx.r, ctx.group, ctx.mb_rows
        want = [p for p, need in zip(ctx.params, ctx.needs_input_grad[7:])
                if need]
        grads = [None] * len(want)
        gx = []
        for t, (h, y) in enumerate(zip(ctx.ins, ctx.ys)):
            if r == n - 1:
                g = grad[t * mb_rows: (t + 1) * mb_rows]
            else:
                g = pmesh.recv(h, r + 1, group)
            if y is None:  # remat: this microbatch's stage again
                h = h.detach().requires_grad_(True)
                with torch.enable_grad():
                    y = ctx.run(h)
            got = torch.autograd.grad(y, [h, *want], g, allow_unused=True)
            grads = [a if b is None else b if a is None else a + b
                     for a, b in zip(grads, got[1:])]
            if r > 0:
                pmesh.send(got[0], r - 1, group)
            else:
                gx.append(got[0])
            ctx.ys[t] = None
        grad_x = None
        if ctx.needs_input_grad[0]:
            # stage 0's gradient of the trunk's input on every pp rank
            grad_x = (torch.cat(gx) if r == 0
                      else torch.zeros_like(grad))
            grad_x = pmesh.all_reduce_(grad_x.contiguous(), group)
        it = iter(grads)
        pgrads = [next(it) if need else None
                  for need in ctx.needs_input_grad[7:]]
        return (grad_x, None, None, None, None, None, None, *pgrads)


class _Replicate(torch.autograd.Function):
    """The last stage's outputs on every pp rank: the sum over the group of
    the last stage's outputs and the others' zeros (JAX's masked psum);
    each rank's gradient, the same on every rank, passes straight back."""

    @staticmethod
    def forward(ctx, x, group):
        return pmesh.all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def pipeline_blocks(block_fn: Callable, blocks: Sequence, x: torch.Tensor,
                    mesh: Optional[pmesh.ProcessMesh] = None,
                    axis: str = "pp",
                    num_microbatches: Optional[int] = None,
                    remat: bool = False) -> torch.Tensor:
    """Runs ``x`` [B, ...] (this dp rank's rows, the same on every rank of
    the pp group) through all L layers of ``blocks``, pipelined over the
    mesh's ``axis`` (default: the current mesh); returns what a loop over
    all L layers in one process would, on every pp rank.

    ``block_fn(block, h) -> h`` is one layer's step; ``blocks`` the whole
    trunk's L layers in order (a module, or a dict or a sequence of
    tensors, each), of which this stage runs its own [r·L/n, (r+1)·L/n)
    only: the others may be ``HeldElsewhere``. ValueError when L % n or B %
    M is not 0 (M: ``num_microbatches``, default n). One stage (no mesh, or
    a pp axis of 1) is the plain loop. ``remat`` recomputes the stage's
    blocks in the backward (see the module docstring). Composes with data
    parallelism on a (dp, pp) mesh: each dp index runs its own pipeline on
    its own rows."""
    mesh = pmesh.current_mesh() if mesh is None else mesh
    n = 1 if mesh is None else mesh.size(axis)
    depth = len(blocks)
    if depth % n:
        raise ValueError(f"depth {depth} not divisible by {n} '{axis}' "
                         f"stages")
    m = num_microbatches or n
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible by {m} microbatches")
    if n == 1:  # degenerate mesh: the plain loop
        for blk in blocks:
            x = (checkpoint(block_fn, blk, x, use_reentrant=False) if remat
                 else block_fn(blk, x))
        return x
    group, r = mesh.group(axis), mesh.rank(axis)
    k = depth // n
    local = list(blocks[r * k: (r + 1) * k])  # this stage's layers

    def run(h):
        for blk in local:
            h = block_fn(blk, h)
        return h

    out = _Pipeline.apply(x, run, b // m, group, n, r, remat,
                          *_tensors(local))
    return _Replicate.apply(out, group)


def vit_forward_pp(vit: nn.Module, x: torch.Tensor,
                   mesh: Optional[pmesh.ProcessMesh] = None,
                   axis: str = "pp", num_microbatches: Optional[int] = None,
                   dtype: torch.dtype = torch.float32,
                   use_flash: bool = False, gelu_approx: bool = False,
                   remat: bool = False) -> torch.Tensor:
    """The ViT image encode (``models.vit.VisionTransformer``) with its
    trunk pipelined over ``axis``: the stem and the head run on every rank,
    only the blocks are staged; the same values as ``vit(x, ...)``."""
    tokens = vit.embed(x, dtype)

    def block_fn(blk, h):
        return blk(h, use_flash=use_flash, gelu_approx=gelu_approx)

    tokens = pipeline_blocks(block_fn, vit.blocks, tokens, mesh, axis,
                             num_microbatches, remat=remat)
    return vit.pool(tokens)
