"""Tensor parallelism over the mp group of the process mesh: Megatron
column / row parallelism by hand (counterpart of
``keep_tpu/parallel/tp.py``).

The JAX package states the layout as shardings and lets XLA's SPMD
partitioner derive the math; here each rank holds its shard of every split
leaf as the model's own parameter and the blocks call the collectives
themselves:

- qkv and fc1 are column-parallel (rank r computes its slice of their
  outputs); proj / ``out`` and fc2 are row-parallel (rank r multiplies its
  slice of the inputs, then the partial products are summed over the mp
  group and the bias is added once). LayerNorms, embeddings, the pooler and
  ``logit_scale`` replicate. The visual head's fc1 / fc2 pair splits too, as
  the JAX layout's name rule splits it.
- qkv splits **by head**: rank r holds the q, k and v rows of heads
  [r·H/mp, (r+1)·H/mp), so its slab is [B, S, 3·(H/mp)·Dh] in the layout of
  ``kernels.flash_attention.attention_qkv_slab``, which runs on it with
  ``num_heads = H/mp``. This is the fully local Megatron attention the JAX
  module's docstring describes; the math equals the JAX package's
  contiguous split, which GSPMD re-gathers.
- A pair whose heads (or hidden width) mp does not divide stays replicated,
  as a JAX leaf that does not divide does.
- The conjugate operations are autograd Functions: at a parallel region's
  input the identity forward with an all-reduce backward (``copy_to``), at
  its output the all-reduce forward with an identity backward (the row
  product's sum). Under sequence parallelism (``parallel.sp``) they become
  the all-gather and the reduce-scatter over the sequence.

Gradients: a split leaf's gradient on rank r is its shard's whole gradient
(of this rank's rows: the dp sum follows); a replicated leaf's is the same
on every mp rank, except under sequence parallelism, where a leaf used on a
rank's sequence shard only holds that shard's part (``sp_partial``).

Layout helpers for the trainer and the tests: ``tp_shardings`` (each leaf's
spec), ``tp_fsdp_shardings`` (composed with FSDP over 'dp'), ``place_tp`` /
``place_tp_fsdp`` (a rank's pieces of full leaves), ``tp_fraction``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from keep_tpu_torch.parallel import mesh as pmesh


@dataclasses.dataclass(frozen=True)
class Split:
    """How a leaf splits over mp: ``axis`` of the torch leaf, viewed as
    [groups, mp, chunk] (``groups`` = 3 for qkv, whose q, k and v rows each
    split by head)."""

    axis: int
    groups: int = 1


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """What a block (or the visual head) needs to run split: the mp group,
    its size and this rank's index in it, and which of its pairs split."""

    group: object
    size: int
    rank: int
    attn: bool = False
    mlp: bool = False


def _pairs(model: nn.Module):
    """(column name, row name, units, groups, owner module, pair key) of
    every Megatron pair of a KEEP model: per dense ViT and BERT block the
    attention pair (heads, 3) and the MLP pair (hidden width, 1); the visual
    head's pair (projection width, 1)."""
    from keep_tpu_torch.models import bert, keep, vit

    for name, m in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(m, vit.Block):
            yield (f"{prefix}attn.qkv", f"{prefix}attn.proj",
                   m.cfg.num_heads, 3, m, "attn")
            yield (f"{prefix}mlp.fc1", f"{prefix}mlp.fc2", m.cfg.mlp_dim, 1,
                   m, "mlp")
        elif isinstance(m, bert.Block):
            yield (f"{prefix}attn.qkv", f"{prefix}attn.out",
                   m.cfg.num_attention_heads, 3, m, "attn")
            yield (f"{prefix}mlp.fc1", f"{prefix}mlp.fc2",
                   m.cfg.intermediate_size, 1, m, "mlp")
        elif isinstance(m, keep.VisualHead):
            yield (f"{prefix}fc1", f"{prefix}fc2", m.fc1.weight.shape[0], 1,
                   m, "mlp")


def tp_shardings(model: nn.Module, n_mp: int) -> dict[str, Optional[Split]]:
    """{parameter name: its ``Split`` over mp, or None (replicated)} of a
    KEEP model: column weights and biases on their output axis (qkv by
    head), row weights on their input axis, row biases replicated; a pair
    whose units ``n_mp`` does not divide replicates."""
    specs: dict[str, Optional[Split]] = {
        n: None for n, _ in model.named_parameters()}
    if n_mp <= 1:
        return specs
    for col, row, units, groups, _, _ in _pairs(model):
        if units % n_mp:
            continue
        specs[f"{col}.weight"] = Split(0, groups)
        specs[f"{col}.bias"] = Split(0, groups)
        specs[f"{row}.weight"] = Split(1)
    return specs


def _shard(t: torch.Tensor, split: Split, n: int, r: int) -> torch.Tensor:
    """Rank r's piece of the full leaf ``t``."""
    moved = t.movedim(split.axis, 0)
    g = split.groups
    piece = moved.reshape(g, n, moved.shape[0] // (g * n),
                          *moved.shape[1:])[:, r]
    return piece.reshape(-1, *moved.shape[1:]).movedim(0, split.axis)


def _unshard(pieces: list[torch.Tensor], split: Split) -> torch.Tensor:
    """The full leaf from the ranks' pieces, in rank order."""
    g = split.groups
    moved = [p.movedim(split.axis, 0) for p in pieces]
    chunk = moved[0].shape[0] // g
    parts = [m.reshape(g, chunk, *m.shape[1:]) for m in moved]
    full = torch.stack(parts, dim=1)
    return full.reshape(-1, *moved[0].shape[1:]).movedim(0, split.axis)


def place_tp(full: dict[str, torch.Tensor], specs: dict, n: int,
             r: int) -> dict[str, torch.Tensor]:
    """Rank r's pieces of the full leaves ``full`` (a split leaf's shard,
    a replicated leaf itself)."""
    return {k: v if specs.get(k) is None
            else _shard(v, specs[k], n, r).contiguous()
            for k, v in full.items()}


def gather_tp(local: dict[str, torch.Tensor], specs: dict,
              group) -> dict[str, torch.Tensor]:
    """The full leaves from every mp rank's pieces (a collective: every
    rank of ``group`` calls it with the same names)."""
    n = pmesh.group_size(group)
    out = {}
    for k, v in local.items():
        split = specs.get(k)
        if split is None:
            out[k] = v
            continue
        moved = v.movedim(split.axis, 0).contiguous()
        pieces = pmesh.all_gather(moved, group).chunk(n)
        out[k] = _unshard([p.movedim(0, split.axis) for p in pieces], split)
    return out


@torch.no_grad()
def shard_model_(model: nn.Module, mesh: pmesh.ProcessMesh) -> dict:
    """Splits a KEEP model over the mesh's mp group in place: each split
    leaf becomes this rank's piece (a new parameter), and each block (and
    the visual head) learns which of its pairs split (``.tp``). Returns the
    specs (``tp_shardings``). The MoE trunk is refused, as the JAX trainer
    refuses tp with it."""
    if getattr(model, "moe", False):
        raise ValueError("the MoE trunk trains with dp/fsdp/ep; solver.tp / "
                         "solver.pp are not composed with it")
    n, r, group = mesh.size("mp"), mesh.rank("mp"), mesh.group("mp")
    specs = tp_shardings(model, n)
    split = {}
    for col, _, units, _, owner, key in _pairs(model):
        split.setdefault(id(owner), (owner, set()))
        if units % n == 0:
            split[id(owner)][1].add(key)
    params = dict(model.named_parameters())
    for name, spec in specs.items():
        if spec is None:
            continue
        parent, _, leaf = name.rpartition(".")
        mod = model.get_submodule(parent)
        setattr(mod, leaf, nn.Parameter(
            _shard(params[name].detach(), spec, n, r).contiguous()))
    for owner, keys in split.values():
        owner.tp = TensorParallel(group, n, r, attn="attn" in keys,
                                  mlp="mlp" in keys)
    return specs


def tp_fsdp_shardings(model: nn.Module, n_mp: int, n_dp: int,
                      min_size: int = 1 << 16) -> dict:
    """{name: (tp Split or None, fsdp axis or None)}: the tensor-parallel
    layout over mp composed with FSDP over dp, each large leaf sharding its
    largest still-free dp-divisible axis (``fsdp.fsdp_spec`` with the tp
    axis as ``base``), the threshold on the one-process stacked size as in
    the JAX package."""
    from keep_tpu_torch.parallel import fsdp

    specs = tp_shardings(model, n_mp)
    stacks = fsdp.stack_sizes(specs)
    out = {}
    for name, p in model.named_parameters():
        split = specs[name]
        shape = tuple(p.shape)
        base = None if split is None else tuple(
            "mp" if i == split.axis else None for i in range(len(shape)))
        spec = fsdp.fsdp_spec(shape, n_dp, min_size, base=base,
                              stack=stacks[name])
        out[name] = (split, fsdp.axis_of(spec, "dp"))
    return out


def place_tp_fsdp(full: dict[str, torch.Tensor], layout: dict,
                  mesh: pmesh.ProcessMesh) -> dict[str, torch.Tensor]:
    """This rank's pieces of the full leaves under ``tp_fsdp_shardings``:
    its mp piece, then its dp shard of that."""
    from keep_tpu_torch.parallel import fsdp

    n_mp, r_mp = mesh.size("mp"), mesh.rank("mp")
    n_dp, r_dp = mesh.size("dp"), mesh.rank("dp")
    out = {}
    for k, v in full.items():
        split, axis = layout[k]
        if split is not None:
            v = _shard(v, split, n_mp, r_mp)
        if axis is not None:
            v = fsdp.shard_of(v, axis, n_dp, r_dp)
        out[k] = v.contiguous()
    return out


def tp_fraction(model: nn.Module, n_mp: int) -> float:
    """Fraction of parameter elements (of the one-process model) that split
    over mp."""
    specs = tp_shardings(model, n_mp)
    total = split = 0
    for name, p in model.named_parameters():
        k = math.prod(p.shape) or 1
        total += k
        if specs[name] is not None:
            split += k
    return split / max(total, 1)


# -- the conjugate operations --------------------------------------------------


class _CopyToTP(torch.autograd.Function):
    """Identity forward, all-reduce over mp backward: a column-parallel
    region's input, whose every rank's gradient is a partial one."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return pmesh.all_reduce_(grad.contiguous().clone(), ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce over mp forward, identity backward: the sum of a
    row-parallel product's partial sums."""

    @staticmethod
    def forward(ctx, x, group):
        return pmesh.all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; its gradient summed over ``group`` in the backward
    (the input of a region whose every rank computes a share)."""
    return _CopyToTP.apply(x, group)


def region_in(x: torch.Tensor, tp: Optional[TensorParallel], split: bool,
              seq=None) -> torch.Tensor:
    """The input of a pair: [B, S, D] in full (sequence) on every mp rank.
    Under sequence parallelism ``x`` is this rank's sequence shard: it is
    gathered (backward: reduce-scatter) and trimmed to the true length;
    else a split pair's input is ``copy_to``."""
    if seq is not None:
        return seq.gather(x)
    if split:
        return copy_to(x, tp.group)
    return x


def region_out(partial: torch.Tensor, bias: torch.Tensor,
               tp: Optional[TensorParallel], split: bool, out_dtype,
               seq=None) -> torch.Tensor:
    """A pair's output from its row product without the bias (``partial``,
    in full sequence): under a split pair the partial sums are summed over
    mp (all-reduce; under sequence parallelism a reduce-scatter onto this
    rank's shard), then the fp32 bias is added once and the sum cast to
    ``out_dtype``; a replicated pair under sequence parallelism keeps this
    rank's shard."""
    wide = torch.promote_types(partial.dtype, torch.float32)
    acc = partial.to(wide)
    if seq is not None:
        acc = seq.reduce_scatter(acc) if split else seq.scatter(acc)
    elif split:
        acc = _ReduceFromTP.apply(acc, tp.group)
    return (acc + bias.to(wide)).to(out_dtype)


def row_product(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x @ weightᵀ in x's dtype, no bias: a row-parallel rank's partial
    product (summed in fp32 by ``region_out``)."""
    return torch.nn.functional.linear(x, weight.to(x.dtype))


# -- the pairs of a block under tensor / sequence parallelism -----------------


def attention_pair(qkv: nn.Module, out: nn.Module, x: torch.Tensor,
                   num_heads: int, tp: Optional[TensorParallel], seq=None, *,
                   key_bias: Optional[torch.Tensor] = None,
                   attend=None) -> torch.Tensor:
    """out(attention(qkv(x))) of a pre-normalised ``x`` under tensor and /
    or sequence parallelism: qkv on this rank's heads (H/mp of them when
    the pair splits), the slab attention ``attend`` (the fused kernel's
    ``attention_qkv_slab``; None: the plain ``mha_attention``) on the full
    sequence, the row product summed over mp. [B, S, D] in, x's dtype out,
    this rank's sequence rows under ``seq``."""
    from keep_tpu_torch.ops.nn import mha_attention

    split = tp is not None and tp.attn
    a = region_in(x, tp, split, seq)
    b, s, _ = a.shape
    slab = qkv(a)
    heads = num_heads // tp.size if split else num_heads
    if attend is not None:
        attn = attend(slab, key_bias=key_bias, num_heads=heads)
    else:
        d = slab.shape[-1] // 3
        q, k, v = slab.reshape(b, s, 3, heads, d // heads).permute(
            2, 0, 3, 1, 4)
        bias = None if key_bias is None else key_bias[:, None, None, :]
        attn = mha_attention(q, k, v, bias=bias).transpose(1, 2).reshape(
            b, s, d)
    if not (split or seq is not None):
        return out(attn)
    return region_out(row_product(attn, out.weight), out.bias, tp, split,
                      x.dtype, seq)


def mlp_pair(mlp: nn.Module, x: torch.Tensor,
             tp: Optional[TensorParallel], seq=None, *,
             gelu_approx: bool = False) -> torch.Tensor:
    """fc2(act(fc1(x))) of a pre-normalised ``x`` under tensor and / or
    sequence parallelism: fc1 on this rank's slice of the hidden width, the
    fc2 product summed over mp."""
    from keep_tpu_torch.ops.nn import gelu, quick_gelu

    split = tp is not None and tp.mlp
    h = mlp.fc1(region_in(x, tp, split, seq))
    h = (quick_gelu(h) if getattr(mlp, "act", "gelu") == "quick_gelu"
         else gelu(h, approximate=gelu_approx))
    if not (split or seq is not None):
        return mlp.fc2(h)
    return region_out(row_product(h, mlp.fc2.weight), mlp.fc2.bias, tp,
                      split, x.dtype, seq)
