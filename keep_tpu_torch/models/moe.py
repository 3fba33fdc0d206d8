"""The Switch-MoE MLP and MoE ViT trunk (counterpart of
``keep_tpu/models/moe.py``).

Switch Transformer routing (Fedus et al. 2021) as the JAX package writes
it, with its two dispatches:

- ``moe_mlp`` (``dispatch="einsum"``): GShard routing per group (a batch
  row), per-expert capacity C = ceil(k·S/E · capacity_factor) per group,
  top-k as k rounds of argmax (the first maximum wins, as ``jnp.argmax``),
  one-hot dispatch and combine tensors [G, S, E, C]; tokens over capacity
  are dropped (the residual stream carries them);
- ``moe_mlp_gather`` (``dispatch="gather"``): global routing of all T
  tokens as one group, slots claimed in (round, token) order through a
  chunked cumsum, the inverse map a scatter of token ids (every dropped
  token writes the one pad slot E·C, never a kept one), rows moved by
  gathers; forced ``route``s and ``return_route`` (top-1).

The router's logits and softmax are true fp32 (TF32 off for its product:
``ops.nn.ieee_fp32``): a flipped near-tie would send a token to another
expert. The aux loss is E · Σ_e f_e · P_e (Switch eq. 4), 1 at balance.

Expert linears (``ExpertLinear``: ``weight`` [E, out, in], ``bias`` [E,
out], the JAX ``kernel`` [E, in, out] transposed) run as batched products
in the activation dtype. Quantized (``QExpertLinear``, per (expert,
column) scales from ``quant.quantize_kernel``), as the JAX package's XLA
einsums, not its kernels: W8A8 quantizes the activations per row by
division (``round(x / ascale)``, half to even) and takes the exact int32
product, per expert through ``torch._int_mm`` on the card (PyTorch has no
batched int8 GEMM for CUDA tensors; its int32 sums equal any other exact
route, and the fp32 epilogue stays in the JAX order) and in float64 on
the CPU (exact: |sum| ≤ 127²·K < 2^53); W8A16 dequantizes the int8 weight
into the activation dtype's product.

The trunk's attention is plain (``mha_attention``), as in the JAX block;
its qkv / proj and the stem's patch embed are ``ops.nn`` linears, so
the int8 model runs them through ``kernels.qmatmul`` (#8).

Under data parallelism (``global_batch()``, which the trainer enters) the
routing is the global batch's, as XLA computes the JAX package's over its
mesh: the aux loss's f_e and P_e are means over every rank's tokens, and
the gather dispatch claims its slots in global (round, token) order under
the global batch's capacity. The grouped dispatch routes each batch row
alone, so its routing needs no exchange.

Expert parallelism (the 'ep' axis of a (dp, ep) process mesh,
``shard_experts_``; the JAX package's ``ep_shardings``): each rank of an ep
group holds E/ep of the experts of every ``wi`` / ``wo`` whose E divides,
and the rows of its dp index, the same on every rank of the group. The
grouped dispatch computes the rank's experts only, on those rows, then
completes the experts' output over the ep group (an all-gather along E,
whose backward is the rank's own slice of the gradient, the same on every
rank) before the combine einsum, so that the combine's bits are one
process's. The rows' gradient from the rank's experts is that share of the
whole: it is summed over the group (``parallel.tp.copy_to``). The gather
dispatch is refused under ep, as the JAX trainer refuses it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from keep_tpu_torch.configs import ViTConfig
from keep_tpu_torch.models.vit import (Attention, patchify,
                                       resample_pos_embed)
from keep_tpu_torch.ops.nn import (LayerNorm, Linear, QLinear, gelu,
                                   ieee_fp32, mha_attention)
from keep_tpu_torch.parallel import mesh as dp
from keep_tpu_torch.parallel import tp as ptp

_GLOBAL_BATCH = False
EP_GATHER_REFUSED = ("solver.ep requires vision.moe_dispatch='einsum' (the "
                     "grouped one-hot dispatch is the EP-shardable form; "
                     "'gather' is the single-device/dp fast path)")


@contextlib.contextmanager
def global_batch(enabled: bool = True):
    """Routes over the process group's global batch inside the block (a
    no-op without a process group)."""
    global _GLOBAL_BATCH
    prev, _GLOBAL_BATCH = _GLOBAL_BATCH, enabled
    try:
        yield
    finally:
        _GLOBAL_BATCH = prev


def _routed_as_now(fn):
    """``fn`` run under the ``global_batch`` setting of this moment (a
    remat's recompute runs in the backward, outside the caller's block)."""
    enabled = _GLOBAL_BATCH

    def run(*args, **kw):
        with global_batch(enabled):
            return fn(*args, **kw)
    return run


def _ranks() -> tuple[int, int]:
    return dp.dp_rank_world() if _GLOBAL_BATCH else (0, 1)


def _switch_aux(e: int, f_e: torch.Tensor, p_e: torch.Tensor
                ) -> torch.Tensor:
    """E · Σ_e f_e · P_e, the statistics over the global batch under
    ``global_batch()``."""
    if _ranks()[1] > 1:
        f_e, p_e = dp.mean_over_ranks(f_e), dp.mean_over_ranks(p_e)
    return e * (f_e * p_e).sum()


def moe_capacity(group_tokens: int, num_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Per-expert token capacity of a group."""
    return max(1, math.ceil(top_k * group_tokens / num_experts
                            * capacity_factor))


def _chunked_cumsum(x: torch.Tensor, rows: int = 128) -> torch.Tensor:
    """Inclusive cumsum along axis 0 as the JAX package's two-level scan
    (within chunks of ``rows``' stride, then across chunk totals); exact on
    integers, so the same slots whatever the order."""
    t = x.shape[0]
    cols = -(-t // rows)
    xp = F.pad(x, (0, 0) * (x.dim() - 1) + (0, rows * cols - t))
    x3 = xp.reshape((rows, cols) + x.shape[1:])
    within = torch.cumsum(x3, dim=1)
    totals = torch.cumsum(within[:, -1], dim=0)
    off = torch.cat([torch.zeros_like(totals[:1]), totals[:-1]], dim=0)
    return (within + off[:, None]).reshape((rows * cols,) + x.shape[1:])[:t]


class Router(nn.Module):
    """The unbiased router, ``weight`` [E, D] (the JAX ``kernel`` [D, E]
    transposed), kept in fp32 whatever the compute dtype."""

    def __init__(self, dim: int, experts: int, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(experts, dim, device=device))

    def probs(self, x: torch.Tensor) -> torch.Tensor:
        """softmax of the fp32 logits of x [..., D] → [..., E]."""
        with ieee_fp32():
            logits = torch.matmul(x.float(), self.weight.float().t())
        return torch.softmax(logits, dim=-1)


class ExpertLinear(Linear):
    """Expert-stacked linear: x [..., E, C, in] → [..., E, C, out] in x's
    dtype, ``weight`` [E, out, in] and ``bias`` [E, out]. A ``Linear``, so
    that the models' weight casts and ``quantize_source`` treat it as one."""

    def __init__(self, experts: int, in_features: int, out_features: int, *,
                 device=None):
        nn.Module.__init__(self)
        self.weight = nn.Parameter(torch.empty(experts, out_features,
                                               in_features, device=device))
        self.bias = nn.Parameter(torch.empty(experts, out_features,
                                             device=device))
        self.register_buffer("pre_scale", None)
        self.fp32_weight = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        return (expert_matmul(x, w.transpose(-1, -2))
                + self.bias.to(x.dtype)[:, None, :])


def expert_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., E, C, K] @ w [E, K, N] → [..., E, C, N] as one batched
    product over the experts: the leading axes are folded into the rows
    (a broadcast ``matmul`` would expand w over them)."""
    e, k, n = w.shape
    xe = x.movedim(-3, 0)
    out = torch.bmm(xe.reshape(e, -1, k), w)
    return out.reshape(xe.shape[:-1] + (n,)).movedim(0, -3)


def int8_expert_product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of int8 activations xq [..., E, C, K] and
    int8 weights wq [E, N, K] → [..., E, C, N]: per expert through
    ``torch._int_mm`` on the card (rows padded to its 17-row minimum), in
    float64 on the CPU."""
    if not xq.is_cuda:
        return torch.matmul(xq.double(), wq.double().transpose(-1, -2)).to(
            torch.int32)
    e, n, k = wq.shape
    xe = xq.movedim(-3, 0)
    lead = xe.shape[1:-1]
    xe = xe.reshape(e, -1, k)
    m = xe.shape[1]
    outs = []
    for i in range(e):
        a = xe[i]
        if m < 17:
            a = F.pad(a, (0, 0, 0, 17 - m))
        outs.append(torch._int_mm(a.contiguous(), wq[i].t())[:m])
    return torch.stack(outs).reshape(e, *lead, n).movedim(0, -3)


class QExpertLinear(nn.Module):
    """An int8 ``ExpertLinear``: ``weight_q`` [E, out, in] int8,
    ``weight_scale`` [E, out] and ``bias`` [E, out] fp32. W8A8 by default;
    ``w_only`` (W8A16, the JAX ``w_only`` marker) dequantizes the weight
    into the activation dtype's product instead. Inference only. The
    marker travels in the state dict as the module's extra state
    (``{"w_only": bool}``), so a state dict rebuilds the form it was
    written from (``compat.export.load_quantized``,
    ``compat.torch_loader.from_jax_params``)."""

    def __init__(self, experts: int, in_features: int, out_features: int, *,
                 w_only: bool = False, device=None):
        super().__init__()
        self.w_only = w_only
        self.register_buffer("weight_q", torch.zeros(
            experts, out_features, in_features, dtype=torch.int8,
            device=device))
        self.register_buffer("weight_scale",
                             torch.ones(experts, out_features, device=device))
        self.register_buffer("bias",
                             torch.zeros(experts, out_features, device=device))

    def get_extra_state(self) -> dict:
        return {"w_only": self.w_only}

    def set_extra_state(self, state: dict) -> None:
        self.w_only = bool(state["w_only"])

    @classmethod
    def from_quantized(cls, weight_q: torch.Tensor,
                       weight_scale: torch.Tensor, bias: torch.Tensor, *,
                       w_only: bool = False) -> "QExpertLinear":
        e, n, k = weight_q.shape
        m = cls(e, k, n, w_only=w_only, device=weight_q.device)
        m.weight_q = weight_q.detach().to(torch.int8).contiguous()
        m.weight_scale = weight_scale.detach().float().contiguous()
        m.bias = bias.detach().float().contiguous()
        return m

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = self.bias[:, None, :]
        if self.w_only:
            w = (self.weight_q.to(x.dtype)
                 * self.weight_scale[:, :, None].to(x.dtype))
            return expert_matmul(x, w.transpose(-1, -2)) + bias.to(x.dtype)
        xf = x.float()
        amax = xf.abs().amax(dim=-1, keepdim=True)
        ascale = amax.clamp_min(1e-8) / torch.full_like(amax, 127.0)
        xq = torch.clamp(torch.round(xf / ascale), -127, 127).to(torch.int8)
        acc = int8_expert_product(xq, self.weight_q)
        out = acc.float() * ascale * self.weight_scale[:, None, :]
        return (out + bias).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class ExpertParallel:
    """The ep group an ``MoEMLP``'s experts split over: its size and this
    rank's index in it (the rank holds experts [rank·E/size,
    (rank+1)·E/size))."""

    group: object
    size: int
    rank: int


class MoEMLP(nn.Module):
    """``router`` [E, D], ``wi`` (D → F) and ``wo`` (F → D) per expert."""

    def __init__(self, dim: int, hidden: int, experts: int, *, device=None):
        super().__init__()
        self.num_experts = experts
        self.router = Router(dim, experts, device=device)
        self.wi = ExpertLinear(experts, dim, hidden, device=device)
        self.wo = ExpertLinear(experts, hidden, dim, device=device)
        # the expert-parallel split (shard_experts_); None: every expert here
        self.ep: ExpertParallel | None = None

    def experts(self, x: torch.Tensor, gelu_approx: bool) -> torch.Tensor:
        return self.wo(gelu(self.wi(x), approximate=gelu_approx))


def _top_k_rounds(probs: torch.Tensor, top_k: int):
    """(indices, gates) [K, ...] of k rounds of argmax over the last axis,
    each round's winner masked out: ``lax.top_k``'s order, ties to the
    lower index."""
    remaining, idx, gate = probs, [], []
    for _ in range(top_k):
        i = torch.argmax(remaining, dim=-1)
        idx.append(i)
        gate.append(torch.gather(remaining, -1, i[..., None])[..., 0])
        remaining = remaining * (1.0 - F.one_hot(i, probs.shape[-1]).to(
            probs.dtype))
    return torch.stack(idx), torch.stack(gate)


def moe_mlp(p: MoEMLP, x: torch.Tensor, *, top_k: int = 1,
            capacity_factor: float = 1.25, gelu_approx: bool = False
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The sparse MLP over a [..., S, D] stream, routed per group (the
    leading axes; a 2-D input is one group) → (out, aux)."""
    orig = x.shape
    d = orig[-1]
    xg = x[None] if x.dim() == 2 else x.reshape(-1, orig[-2], d)
    g, s, _ = xg.shape
    e = p.num_experts
    if top_k > e:
        raise ValueError(f"top_k={top_k} > num_experts={e}")
    c = moe_capacity(s, e, top_k, capacity_factor)
    probs = p.router.probs(xg)  # [G, S, E]
    dev = x.device
    remaining = probs
    dispatch = torch.zeros(g, s, e, c, device=dev)
    combine = torch.zeros(g, s, e, c, device=dev)
    fill = torch.zeros(g, e, dtype=torch.int32, device=dev)
    importance = torch.zeros(e, device=dev)
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)  # [G, S]
        gate = torch.gather(remaining, -1, idx[..., None])[..., 0]
        onehot = F.one_hot(idx, e).float()  # [G, S, E]
        pos = torch.cumsum(onehot, dim=1) - onehot + fill[:, None, :].float()
        my_pos = (pos * onehot).sum(-1)  # [G, S]
        kept = (my_pos < c).float() * onehot.sum(-1)
        # positions past the capacity give an all-zero slot row
        slot = F.one_hot(my_pos.long().clamp(max=c), c + 1)[..., :c].float()
        disp = onehot[..., None] * slot[..., None, :] * kept[..., None, None]
        dispatch = dispatch + disp
        combine = combine + disp * gate[..., None, None]
        fill = torch.minimum(
            fill + (onehot * kept[..., None]).sum(1).to(torch.int32),
            torch.tensor(c, dtype=torch.int32, device=dev))
        importance = importance + onehot.sum((0, 1))
        remaining = remaining * (1.0 - onehot)
    # Switch aux: f_e over every (token, round) assignment before drops
    f_e = importance / (top_k * g * s)
    aux = _switch_aux(e, f_e, probs.mean((0, 1)))
    if p.ep is None:
        expert_in = torch.einsum("gsec,gsd->gecd", dispatch.to(x.dtype), xg)
        out = p.experts(expert_in, gelu_approx)
    else:  # this rank's experts, then every expert's output
        k = e // p.ep.size
        mine = dispatch[:, :, p.ep.rank * k: (p.ep.rank + 1) * k]
        expert_in = torch.einsum("gsec,gsd->gecd", mine.to(x.dtype),
                                 ptp.copy_to(xg, p.ep.group))
        out = _GatherExperts.apply(p.experts(expert_in, gelu_approx),
                                   p.ep.group, p.ep.rank)
    yt = torch.einsum("gsec,gecd->gsd", combine.to(x.dtype), out)
    return yt.reshape(orig), aux


class _GatherExperts(torch.autograd.Function):
    """[G, E/ep, C, D] of this rank's experts → [G, E, C, D] of the ep
    group's, in rank order; backward this rank's slice of the gradient
    (the same gradient on every rank of the group)."""

    @staticmethod
    def forward(ctx, out, group, rank):
        ctx.k, ctx.rank = out.shape[1], rank
        return dp.all_gather(out.movedim(1, 0), group).movedim(0, 1)

    @staticmethod
    def backward(ctx, grad):
        k, r = ctx.k, ctx.rank
        return grad[:, r * k: (r + 1) * k], None, None


def ep_specs(model: nn.Module, n_ep: int) -> dict:
    """{parameter name: ``parallel.tp.Split`` of its expert axis over ep,
    or None (replicated)} (``ep_shardings``): the expert-stacked ``wi`` /
    ``wo`` leaves of the MoE blocks split their expert axis (ndim − 3 for a
    weight, ndim − 2 for a bias: 0 in both); a leaf whose E does not divide
    ``n_ep`` and every other leaf (router, attention, LayerNorms, the text
    tower) replicate."""
    out = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        axis = None
        if "moe" in parts and ("wi" in parts or "wo" in parts):
            axis = p.ndim - 3 if parts[-1] == "weight" else p.ndim - 2
            if not (0 <= axis < p.ndim and p.shape[axis] % n_ep == 0):
                axis = None
        out[name] = None if axis is None or n_ep <= 1 else ptp.Split(axis)
    return out


@torch.no_grad()
def shard_experts_(model: nn.Module, mesh) -> dict:
    """Splits an MoE model's experts over the mesh's ep group in place:
    each split ``wi`` / ``wo`` leaf becomes this rank's experts (a new
    parameter) and each ``MoEMLP`` whose experts split learns its group
    (``.ep``). Returns the specs (``ep_specs``, on the one-process
    shapes)."""
    n, r, group = mesh.size("ep"), mesh.rank("ep"), mesh.group("ep")
    specs = ep_specs(model, n)
    for name, m in model.named_modules():
        if isinstance(m, MoEMLP) and specs[f"{name}.wi.weight"] is not None:
            m.ep = ExpertParallel(group, n, r)
    pieces = ptp.place_tp({k: p.detach() for k, p in model.named_parameters()
                           if specs[k] is not None}, specs, n, r)
    for name, piece in pieces.items():
        parent, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(parent), leaf, nn.Parameter(piece))
    return specs


def moe_mlp_gather(p: MoEMLP, x: torch.Tensor, *, top_k: int = 1,
                   capacity_factor: float = 1.25, gelu_approx: bool = False,
                   route: torch.Tensor | None = None,
                   return_route: bool = False) -> tuple:
    """The sparse MLP with global routing and gather-only data movement →
    (out, aux), and the realized [T] top-1 assignment with
    ``return_route``. ``route`` [T] forces the token → expert assignment
    (the gate still reads the router's probability there); both top-1
    only."""
    if (route is not None or return_route) and top_k != 1:
        raise ValueError("route tracing/forcing is top-1 only")
    if p.ep is not None:
        raise ValueError(EP_GATHER_REFUSED)
    orig = x.shape
    d = orig[-1]
    xf = x.reshape(-1, d)
    t = xf.shape[0]
    e = p.num_experts
    if top_k > e:
        raise ValueError(f"top_k={top_k} > num_experts={e}")
    rank, world = _ranks()
    # the capacity of the global batch's T (equal shards)
    c = moe_capacity(t * world, e, top_k, capacity_factor)
    probs = p.router.probs(xf)  # [T, E]
    if route is not None:
        route = torch.as_tensor(route, device=x.device).long()
        lo, hi = int(route.min()), int(route.max())
        if lo < 0 or hi >= e:
            raise ValueError(f"forced route indices must be in [0, {e}); "
                             f"got min={lo} max={hi}")
        idx = route[None]
        gate = torch.gather(probs, 1, route[:, None]).t()
    else:
        idx, gate = _top_k_rounds(probs, top_k)  # [K, T] round-major
    k = idx.shape[0]
    idx_f = idx.reshape(-1)
    onehot = F.one_hot(idx_f, e).to(torch.int32)  # [K·T, E]
    counts = _chunked_cumsum(onehot)
    my_pos = ((counts - onehot) * onehot).sum(-1)
    if world > 1:
        # global (round, token) order: a slot of round j comes after every
        # rank's earlier rounds and the lower ranks' round j
        per_round = onehot.reshape(k, t, e).sum(1)  # [K, E]
        every = dp.gather_rows(per_round[None])  # [world, K, E]
        before = (every.sum(0) - per_round).cumsum(0) - (every.sum(0)
                                                         - per_round)
        offset = before + every[:rank].sum(0)  # [K, E]
        rounds = torch.arange(k, device=x.device).repeat_interleave(t)
        my_pos = my_pos + offset[rounds, idx_f].to(my_pos.dtype)
    kept = my_pos < c
    slot = torch.where(kept, idx_f * c + my_pos, e * c)  # E·C: the pad slot
    # the inverse map: kept slots are unique; every dropped token writes
    # the pad slot, which is cut off below
    token_ids = torch.arange(t, device=x.device).repeat(k)
    inv = torch.full((e * c + 1,), t, dtype=torch.long, device=x.device)
    inv[slot] = token_ids
    tok = inv[:e * c].reshape(e, c)
    filled = tok < t
    expert_in = torch.where(filled[..., None], xf[tok.clamp(max=t - 1)],
                            torch.zeros((), dtype=x.dtype, device=x.device))
    out = p.experts(expert_in, gelu_approx)  # [E, C, D]
    flat = torch.cat([out.reshape(e * c, d),
                      torch.zeros(1, d, dtype=out.dtype, device=x.device)])
    w = (gate * kept.reshape(k, t)).to(x.dtype)
    yt = (flat[slot.reshape(k, t)] * w[..., None]).sum(0)
    aux = _switch_aux(e, onehot.float().mean(0), probs.mean(0))
    if return_route:
        return yt.reshape(orig), aux, idx[0]
    return yt.reshape(orig), aux


class MoEBlock(nn.Module):
    """Pre-LN block: the ViT's attention sub-block (plain attention), then
    the sparse MLP."""

    def __init__(self, cfg: ViTConfig, experts: int, *, device=None):
        super().__init__()
        d = cfg.embed_dim
        self.cfg = cfg
        self.norm1 = LayerNorm(d, cfg.ln_eps, device=device)
        self.attn = Attention(d, device=device)
        self.norm2 = LayerNorm(d, cfg.ln_eps, device=device)
        self.moe = MoEMLP(d, cfg.mlp_dim, experts, device=device)

    def forward(self, x: torch.Tensor, route: torch.Tensor | None = None, *,
                top_k: int = 1, capacity_factor: float = 1.25,
                gelu_approx: bool = False, dispatch: str = "einsum",
                collect_ln_stats: bool = False,
                return_route: bool = False) -> tuple:
        """→ (out, aux) + (stats,) with ``collect_ln_stats`` (the abs-max
        of the two LayerNorm outputs, {"qkv": [D], "wi": [D]}) + (route,)
        with ``return_route``."""
        b, s, d = x.shape
        h = self.cfg.num_heads
        if collect_ln_stats and isinstance(self.attn.qkv, QLinear):
            raise ValueError("LN-stats calibration needs the unquantized "
                             "fp path")
        ln1 = self.norm1(x)
        q, k, v = self.attn.qkv(ln1).reshape(b, s, 3, h, d // h).permute(
            2, 0, 3, 1, 4)
        attn = mha_attention(q, k, v).transpose(1, 2).reshape(b, s, d)
        x = x + self.attn.proj(attn)
        ln2 = self.norm2(x)
        kw = dict(top_k=top_k, capacity_factor=capacity_factor,
                  gelu_approx=gelu_approx)
        if dispatch == "gather":
            r = moe_mlp_gather(self.moe, ln2, route=route,
                               return_route=return_route, **kw)
        elif dispatch == "einsum":
            if route is not None or return_route:
                raise ValueError("route tracing/forcing needs "
                                 "dispatch='gather'")
            r = moe_mlp(self.moe, ln2, **kw)
        else:
            raise ValueError(f"unknown moe dispatch {dispatch!r} (expected "
                             f"'einsum' or 'gather')")
        out = (x + r[0], r[1])
        if collect_ln_stats:
            out += ({"qkv": ln1.float().abs().amax(dim=(0, 1)),
                     "wi": ln2.float().abs().amax(dim=(0, 1))},)
        return out + tuple(r[2:])


class MoETrunk(nn.Module):
    """``depth`` (default ``cfg.depth``) stacked MoE blocks of
    ``num_experts`` experts (the JAX ``moe.init``)."""

    def __init__(self, cfg: ViTConfig, num_experts: int,
                 depth: int | None = None, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.blocks = nn.ModuleList(
            MoEBlock(cfg, num_experts, device=device)
            for _ in range(cfg.depth if depth is None else depth))

    def forward_trunk(self, tokens: torch.Tensor, *, top_k: int = 1,
                      capacity_factor: float = 1.25,
                      gelu_approx: bool = False, remat: bool = False,
                      dispatch: str = "einsum", ln_stats: bool = False,
                      routes: torch.Tensor | None = None,
                      return_routes: bool = False) -> tuple:
        """[B, S, D] → (tokens, the mean aux over layers) + ({"qkv": [L,
        D], "wi": [L, D]},) with ``ln_stats`` + (realized routes [L, T],)
        with ``return_routes``. ``routes`` [L, T] forces each layer's
        assignment (gather dispatch, top-1). ``remat`` recomputes each
        block in the backward."""
        kw = dict(top_k=top_k, capacity_factor=capacity_factor,
                  gelu_approx=gelu_approx, dispatch=dispatch,
                  collect_ln_stats=ln_stats, return_route=return_routes)
        auxes, stats, realized = [], [], []
        for i, blk in enumerate(self.blocks):
            route = None if routes is None else routes[i]
            if remat:
                # the backward's recompute routes as the forward did
                out = checkpoint(_routed_as_now(blk), tokens, route,
                                 use_reentrant=False, **kw)
            else:
                out = blk(tokens, route, **kw)
            tokens = out[0]
            auxes.append(out[1])
            rest = list(out[2:])
            if ln_stats:
                stats.append(rest.pop(0))
            if return_routes:
                realized.append(rest.pop(0))
        result = (tokens, torch.stack(auxes).mean())
        if ln_stats:
            result += ({k: torch.stack([st[k] for st in stats])
                        for k in ("qkv", "wi")},)
        if return_routes:
            result += (torch.stack(realized),)
        return result

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "MoETrunk":
        """The JAX ``moe.init`` statistics: linear and expert weights
        normal with std fan_in^-0.5, zero biases, unit LayerNorms, the
        router std .02."""
        for m in self.modules():
            if isinstance(m, Linear):
                m.weight.normal_(0.0, m.weight.shape[-1] ** -0.5,
                                 generator=generator)
                m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, Router):
                m.weight.normal_(0.0, 0.02, generator=generator)
        return self


class MoEVisionTransformer(MoETrunk):
    """The MoE-ViT image encoder (the JAX ``moe.vit_forward`` /
    ``init_vit``): the ViT's stem (patchify, CLS, pos embed resampled to
    the image's grid), the MoE trunk of ``cfg.moe_experts`` experts, the
    final LayerNorm on the CLS token."""

    def __init__(self, cfg: ViTConfig, *, device=None):
        super().__init__(cfg, cfg.moe_experts, device=device)
        d = cfg.embed_dim
        self.patch_embed = Linear(cfg.patch_size * cfg.patch_size * 3, d,
                                  device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(
            1, cfg.num_prefix_tokens + cfg.num_patches, d, device=device))
        self.norm = LayerNorm(d, cfg.ln_eps, device=device)

    def forward(self, x: torch.Tensor, *, dtype: torch.dtype = torch.float32,
                remat: bool = False, gelu_approx: bool = False,
                ln_stats: bool = False, routes: torch.Tensor | None = None,
                return_routes: bool = False) -> tuple:
        """[B, H, W, 3] → ([B, D] pooled, aux) + (stats,) + (routes,), as
        ``forward_trunk``; top-k, capacity and dispatch from the config."""
        b, h, w, _ = x.shape
        cfg = self.cfg
        ps = cfg.patch_size
        if h % ps or w % ps:
            raise ValueError(f"image size {(h, w)} not a multiple of "
                             f"patch_size {ps}")
        x = x.to(dtype)
        tokens = self.patch_embed(patchify(x, ps))
        cls = self.cls_token.to(dtype).expand(b, 1, cfg.embed_dim)
        tokens = torch.cat([cls, tokens], dim=1)
        pos = resample_pos_embed(self.pos_embed, (h // ps, w // ps),
                                 cfg.num_prefix_tokens)
        tokens = tokens + pos.to(dtype)
        out = self.forward_trunk(
            tokens, top_k=cfg.moe_top_k,
            capacity_factor=cfg.moe_capacity_factor, gelu_approx=gelu_approx,
            remat=remat, dispatch=cfg.moe_dispatch, ln_stats=ln_stats,
            routes=routes, return_routes=return_routes)
        # LayerNorm is per token: the CLS row alone
        return (self.norm(out[0][:, 0]),) + out[1:]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator
                     ) -> "MoEVisionTransformer":
        """``MoETrunk``'s init, the patch embed std fan_in^-0.5, the CLS
        token and pos embed truncated normal (±2σ, σ = .02), a unit final
        LayerNorm (the JAX ``init_vit``)."""
        super().init_weights(generator)
        for t in (self.cls_token, self.pos_embed):
            nn.init.trunc_normal_(t, 0.0, 0.02, -0.04, 0.04,
                                  generator=generator)
        return self
