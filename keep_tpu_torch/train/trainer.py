"""The training step (counterpart of ``keep_tpu/train/trainer.py``).

encode_image / encode_text (bf16 compute over fp32 master weights, per-block
remat) → HyMetricLoss or CLIP loss with ``exp(logit_scale)`` (+
``moe_aux_weight`` · the MoE trunk's load-balancing loss) → gradients →
freeze mask → AdamW (``optim.AdamW``) → freeze mask on the updates →
``logit_scale`` clamped to [0, ln 100]. Gradient accumulation caches every
microbatch's features without grad, then re-forwards each chunk with the
cached rest as negatives and sums the chunks' gradients.

The JAX package jits one step per freeze phase; here ``static_frozen`` sets
``requires_grad_(False)`` on the frozen parameters at each step, so autograd
builds no graph through a frozen tower and runs no backward there. The
parameters are the model's own and are updated in place.

LoRA fine-tuning (``make_train_step(lora_scale=, base=)``): the state holds
the adapter dict only (``train/lora.py``), so that the optimizer keeps no
moments for the frozen base; the step swaps the merged weights into the
model for its forward and backward.

Data parallelism, under a ``torch.distributed`` process group: each rank's
batch holds its rows of the global batch, and ``node_connection`` is the
global batch's. The towers' features are gathered across the ranks
(``parallel.gather_rows``), so every rank computes the global batch's loss,
its negatives and hard mining included, as XLA does for the JAX package
over its mesh; the MoE trunk routes over the global batch
(``moe.global_batch``). There is no ``DistributedDataParallel`` wrapper:
right after the backward the gradient dict is summed over the ranks
(``parallel.all_reduce_grads``, the trainable leaves only), and clipping,
the freeze mask and AdamW run on the sum, as the optax chain sees the
global gradient. ``logit_scale`` enters the loss after the gather, so each
rank already holds its whole gradient: it is not summed.

The other layouts (``ParallelLayout``, over a 'dp' × 'mp' process mesh):
under tensor parallelism the model holds this rank's pieces of the split
leaves (``parallel.tp``) and the state is over them; under sequence
parallelism the towers split their streams along S (``parallel.sp``) and
the gradients of the leaves used on a rank's rows only are summed over mp;
under FSDP the state holds this rank's shards of the large leaves
(``parallel.fsdp``), their gradients are reduce-scattered over dp, and
after each update the shards are all-gathered into the model's compute
copy. Under pipeline parallelism (a 'dp' × 'pp' mesh) the model keeps its
stage's trunk blocks only (``parallel.pp``) and the image tower runs
through the pipeline (``encode_image_pp``); under expert parallelism ('dp'
× 'ep') it keeps its experts of each MoE block (``models.moe``). Either
way the state holds the model's own leaves, and every leaf's gradient
sums over dp only: a staged leaf or an expert is whole on its rank, and a
replicated leaf comes out the same on every rank of the pp or ep group.
Clipping takes the global norm over the pieces, a replicated leaf counted
once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import re
from typing import Callable, Optional

import numpy as np
import torch

from keep_tpu_torch.models import moe
from keep_tpu_torch.models.keep import KEEPModel
from keep_tpu_torch.parallel import fsdp as pfsdp
from keep_tpu_torch.parallel import mesh as pmesh
from keep_tpu_torch.parallel import pp as ppp
from keep_tpu_torch.parallel import tp as ptp
from keep_tpu_torch.parallel.mesh import all_reduce_grads, gather_rows
from keep_tpu_torch.train import lora
from keep_tpu_torch.train.loss import clip_loss, hy_metric_loss
from keep_tpu_torch.train.optim import AdamW

LOGIT_SCALE_MAX = math.log(100.0)
_IN_BLOCK = re.compile(r"^(visual|text)\.blocks\.\d+\.")


@dataclasses.dataclass
class ParallelLayout:
    """The training state's layout over a process mesh and the step's
    collectives for it. ``tp``: every parameter's ``parallel.tp.Split``
    over mp (None: replicated; every one-process name is a key);
    ``fsdp``: {name: the axis of its (mp-local) leaf sharded over dp};
    ``sp``: the towers' ``act_sharding``; ``sp_partial``: the leaves whose
    gradients sum over mp under it; ``pp``: {name: the stage that holds
    it} of the staged trunk leaves; ``ep``: {name: ``parallel.tp.Split``
    of its expert axis over ep} of the split expert leaves."""

    mesh: pmesh.ProcessMesh
    tp: dict
    fsdp: dict
    sp: Optional[object] = None
    sp_partial: frozenset = frozenset()
    pp: dict = dataclasses.field(default_factory=dict)
    ep: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def build(cls, model: KEEPModel, mesh: pmesh.ProcessMesh, *,
              fsdp: bool = False, sp: bool = False,
              min_size: int = 1 << 16) -> "ParallelLayout":
        """Splits ``model`` over the mesh's inner group (mp, pp or ep, when
        it has one) and lays the state out: the specs are taken on the
        one-process shapes, before the split."""
        from keep_tpu_torch.parallel.sp import seq_sharding

        n_mp, n_dp = mesh.size("mp"), mesh.size("dp")
        specs = ptp.tp_fsdp_shardings(model, n_mp, n_dp, min_size)
        staged = experts = {}
        if n_mp > 1:
            ptp.shard_model_(model, mesh)
        if mesh.size("pp") > 1:
            staged = ppp.stage_model_(model, mesh)
        if mesh.size("ep") > 1:
            experts = moe.shard_experts_(model, mesh)
        tp = {n: split for n, (split, _) in specs.items()}
        shards = ({n: ax for n, (_, ax) in specs.items() if ax is not None}
                  if fsdp and n_dp > 1 else {})
        partial = frozenset(n for n in tp if sp and tp[n] is None
                            and _IN_BLOCK.match(n))
        return cls(mesh, tp, shards, seq_sharding(mesh) if sp else None,
                   partial,
                   {n: s for n, s in staged.items() if s is not None},
                   {n: s for n, s in experts.items() if s is not None})

    @property
    def pp_mesh(self) -> Optional[pmesh.ProcessMesh]:
        """The mesh the image tower pipelines over, or None."""
        return self.mesh if self.mesh.size("pp") > 1 else None

    def state_params(self, model: KEEPModel) -> dict:
        """The state's leaves: this rank's fp32 master shard of each FSDP
        leaf (a copy), the model's own parameter of every other."""
        n, r = self.mesh.size("dp"), self.mesh.rank("dp")
        return {k: pfsdp.shard_of(p.detach().float(), self.fsdp[k], n,
                                  r).clone() if k in self.fsdp else p
                for k, p in model.named_parameters()}

    def reduce_grads(self, grads: dict, live) -> dict:
        """The full gradients of the model's leaves (this rank's rows) →
        the state's: summed over mp where sequence parallelism left a part
        on each rank, then reduce-scattered over dp into the FSDP shards,
        summed over dp elsewhere (``logit_scale`` aside, as in
        ``all_reduce_grads``)."""
        live = set(live)
        if self.sp_partial:
            all_reduce_grads(grads, [n for n in grads
                                     if n in self.sp_partial and n in live],
                             replicated=(), group=self.mesh.group("mp"))
        dp = self.mesh.group("dp")
        all_reduce_grads(grads, [n for n in grads
                                 if n in live and n not in self.fsdp],
                         group=dp)
        if not self.fsdp:
            return grads
        n, r = self.mesh.size("dp"), self.mesh.rank("dp")
        sharded = {k: grads[k] for k in grads if k in self.fsdp and k in live}
        out = dict(grads)
        out.update(pfsdp.reduce_scatter_grads(
            sharded, {k: self.fsdp[k] for k in sharded}, dp))
        for k in self.fsdp:
            if k not in live:
                out[k] = pfsdp.shard_of(grads[k], self.fsdp[k], n, r)
        return out

    @torch.no_grad()
    def refresh(self, model: KEEPModel, params: dict) -> None:
        """The FSDP shards in ``params`` all-gathered into the model's
        compute copy (what the next forward reads)."""
        if not self.fsdp:
            return
        full = pfsdp.all_gather_shards({k: params[k] for k in self.fsdp},
                                       self.fsdp, self.mesh.group("dp"))
        own = dict(model.named_parameters())
        for k, v in full.items():
            own[k].copy_(v)

    def _inner(self) -> str:
        """The mesh's axis besides 'dp' ('mp' when it has none)."""
        return next((a for a in self.mesh.axes if a != "dp"), "mp")

    def norm(self, grads: dict) -> torch.Tensor:
        """The global gradient norm over the state's leaves: each leaf's
        sum of squares summed over the ranks that split it (dp for an FSDP
        shard; mp, pp or ep for a tensor-parallel piece, a stage's leaf or
        an expert; every rank for an FSDP shard of a tensor-parallel
        piece), a replicated leaf counted once."""
        parts: dict[tuple, torch.Tensor] = {}
        for k, g in grads.items():
            key = (k in self.fsdp, self.tp.get(k) is not None
                   or k in self.pp or k in self.ep)
            sq = torch.sum(g.float() * g.float())
            parts[key] = parts[key] + sq if key in parts else sq
        groups = {(False, False): False, (True, False): self.mesh.group("dp"),
                  (False, True): self.mesh.group(self._inner()),
                  (True, True): None}
        total = 0.0
        for key, sq in parts.items():
            if groups[key] is not False:
                sq = pmesh.all_reduce_(sq.clone(), groups[key])
            total = total + sq
        return torch.sqrt(total)

    @torch.no_grad()
    def full(self, tree: dict) -> dict:
        """The one-process leaves from every rank's pieces of ``tree``
        (the state's leaves, or its moments): FSDP shards all-gathered over
        dp, then tensor-parallel pieces over mp. A collective: every rank
        calls it."""
        out = {k: v.detach() for k, v in tree.items()}
        if self.fsdp:
            out.update(pfsdp.all_gather_shards(
                {k: tree[k] for k in self.fsdp}, self.fsdp,
                self.mesh.group("dp")))
        if self.mesh.size("mp") > 1:
            out = ptp.gather_tp(out, self.tp, self.mesh.group("mp"))
        if self.ep:
            out = ptp.gather_tp(out, self.ep, self.mesh.group("ep"))
        if self.pp:
            out.update(self._gather_stages(out))
        return out

    def _gather_stages(self, tree: dict) -> dict:
        """Every stage's trunk leaves from the pp ranks' own (``tree``
        holds this rank's stage): the stages' blocks have the same leaves,
        so the j-th of each stage's names travel in one all-gather."""
        n, me = self.mesh.size("pp"), self.mesh.rank("pp")
        names = [[k for k, s in self.pp.items() if s == stage]
                 for stage in range(n)]
        out = {}
        for j, k in enumerate(names[me]):
            every = pmesh.all_gather(tree[k][None].contiguous(),
                                     self.mesh.group("pp"))
            for stage in range(n):
                out[names[stage][j]] = every[stage]
        return out

    def place(self, full: dict) -> dict:
        """This rank's pieces of one-process leaves: its mp piece, then
        its dp shard of that; its experts; its stage's leaves and the
        replicated ones."""
        me = self.mesh.rank("pp")
        full = {k: v for k, v in full.items() if self.pp.get(k, me) == me}
        out = ptp.place_tp_fsdp(full, {k: (self.tp.get(k), self.fsdp.get(k))
                                       for k in full}, self.mesh)
        if self.ep:
            out = ptp.place_tp(out, self.ep, self.mesh.size("ep"),
                               self.mesh.rank("ep"))
        return out

    @torch.no_grad()
    def load(self, model: KEEPModel, state: "TrainState", params: dict,
             opt_state: Optional[dict] = None) -> None:
        """One-process leaves (a checkpoint's) into the split model and
        the state: the model's parameters take their mp pieces, the state
        its pieces, the moments theirs."""
        n_mp, r_mp = self.mesh.size("mp"), self.mesh.rank("mp")
        device = next(model.parameters()).device
        own = dict(model.named_parameters())
        pieces = ptp.place_tp({k: params[k] for k in own}, self.tp, n_mp,
                              r_mp)
        if self.ep:
            pieces = ptp.place_tp(pieces, self.ep, self.mesh.size("ep"),
                                  self.mesh.rank("ep"))
        for k, v in pieces.items():
            own[k].copy_(v)
        local = self.place({k: params[k] for k in own})
        for k, p in state.params.items():
            if p is not own[k]:
                p.copy_(local[k])
        if opt_state is not None:
            state.opt_state = {
                "count": int(opt_state["count"]),
                **{m: {k: v.to(device) for k, v in self.place(
                    opt_state[m]).items()} for m in ("mu", "nu")}}


@dataclasses.dataclass
class TrainState:
    # the model's parameters, or LoRA adapters; updated in place
    params: dict[str, torch.Tensor]
    opt_state: dict
    step: int


def tree_state(model: KEEPModel | dict, tx: AdamW,
               layout: Optional[ParallelLayout] = None) -> TrainState:
    """The state over a model's parameters (this rank's pieces under a
    ``layout``), or over a dict of trainable tensors (LoRA adapters)."""
    if layout is not None:
        params = layout.state_params(model)
    else:
        params = (dict(model) if isinstance(model, dict)
                  else dict(model.named_parameters()))
    return TrainState(params=params,
                      opt_state=tx.init({n: p.detach()
                                         for n, p in params.items()}),
                      step=0)


@dataclasses.dataclass(frozen=True)
class LossConfig:
    kind: str = "hierarchy_metric"  # or 'clip'
    caption_num: int = 32
    loss_subtype: str = "lhp-hn"


_ARRAYS = ("pixels", "input_ids", "attention_mask", "token_type_ids",
           "node_connection", "labels")


def to_device(batch: dict, device) -> dict:
    """The batch's arrays as tensors on ``device`` (token ids as int64)."""
    out = {}
    for k, v in batch.items():
        if k not in _ARRAYS or v is None:
            continue
        t = torch.as_tensor(np.asarray(v))
        if k in ("input_ids", "attention_mask", "token_type_ids", "labels"):
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out


def _encode_batch(model: KEEPModel, batch: dict, remat: bool = True,
                  act_sharding=None, pp_mesh=None):
    """(image features, text features, the MoE aux loss: 0 when dense) of
    this rank's rows; the aux loss is the global batch's.
    ``act_sharding``: the towers' sequence split (``parallel.sp``);
    ``pp_mesh``: the mesh whose 'pp' axis the visual trunk is staged over
    (GPipe, ``parallel.pp``)."""
    kw = {} if act_sharding is None else {"act_sharding": act_sharding}
    if pp_mesh is not None:
        if model.moe:
            # encode_image_pp raises too; fail here so that library callers
            # of compute_loss cannot train the router with a zero aux loss
            raise NotImplementedError(
                "pipeline parallelism does not compose with the MoE trunk")
        img = model.encode_image_pp(batch["pixels"], pp_mesh, remat=remat)
        aux = torch.zeros((), device=img.device)
    else:
        with moe.global_batch():
            img, aux = model.encode_image(batch["pixels"], remat=remat,
                                          return_aux=True, **kw)
    txt = model.encode_text(batch["input_ids"], batch.get("attention_mask"),
                            batch.get("token_type_ids"), remat=remat, **kw)
    return img, txt, aux


def _loss(img, txt, batch, scale, loss_cfg: LossConfig, caption_num: int):
    """The loss of the global batch's features ``img`` / ``txt``."""
    if loss_cfg.kind == "hierarchy_metric":
        return hy_metric_loss(img, txt, batch["node_connection"], scale,
                              caption_num=caption_num,
                              loss_type=loss_cfg.loss_subtype)
    labels = batch.get("labels")
    return clip_loss(img, txt, scale,
                     labels=None if labels is None else labels.reshape(-1))


def _global_labels(batch: dict, row_dim: int = 0) -> dict:
    """``batch`` with its per-row ``labels`` gathered across the ranks
    along ``row_dim``."""
    labels = batch.get("labels")
    if labels is None:
        return batch
    return {**batch, "labels": gather_rows(labels.transpose(0, row_dim)
                                           ).transpose(0, row_dim)}


def compute_loss(model: KEEPModel, batch: dict, loss_cfg: LossConfig, *,
                 remat: bool = True, act_sharding=None,
                 pp_mesh=None) -> torch.Tensor:
    img, txt, aux = _encode_batch(model, batch, remat, act_sharding,
                                  pp_mesh)
    loss = _loss(gather_rows(img), gather_rows(txt), _global_labels(batch),
                 torch.exp(model.logit_scale), loss_cfg,
                 loss_cfg.caption_num)
    if model.moe:
        loss = loss + model.cfg.vision.moe_aux_weight * aux
    return loss


def _apply_freeze(tree: dict, frozen: Optional[dict]) -> dict:
    """Zeroes the leaves whose freeze mask is 1 (grads, so Adam sees zeros;
    updates, so weight decay cannot move a frozen parameter)."""
    if frozen is None:
        return tree
    return {n: t * (1.0 - frozen[n]) for n, t in tree.items()}


@torch.no_grad()
def _optimizer_apply(state: TrainState, grads: dict, tx: AdamW,
                     frozen: Optional[dict], loss: torch.Tensor,
                     layout: Optional[ParallelLayout] = None,
                     model: Optional[KEEPModel] = None):
    """The freeze → update → clamp → metrics tail shared by both steps;
    under FSDP the updated shards then refresh the model's compute copy."""
    grads = _apply_freeze(grads, frozen)
    params = {n: p.detach() for n, p in state.params.items()}
    updates, state.opt_state = tx.update(grads, state.opt_state, params)
    updates = _apply_freeze(updates, frozen)
    for n, p in state.params.items():
        p.add_(updates[n])
    ls = state.params["logit_scale"]
    ls.clamp_(0.0, LOGIT_SCALE_MAX)
    if layout is not None:
        layout.refresh(model, state.params)
    state.step += 1
    return state, {"loss": loss, "grad_norm": tx.norm(grads),
                   "logit_scale": torch.exp(ls)}


def _live(params: dict) -> list[str]:
    return [n for n, p in params.items() if p.requires_grad]


def _grads(loss: torch.Tensor, params: dict) -> dict:
    """d loss / d params, zeros where a parameter takes no gradient."""
    live = _live(params)
    got = torch.autograd.grad(loss, [params[n] for n in live],
                              allow_unused=True)
    out = {n: torch.zeros_like(p) for n, p in params.items()}
    for n, g in zip(live, got):
        if g is not None:
            out[n] = g
    return out


def _set_static_frozen(params: dict, static_frozen: Optional[dict]) -> None:
    for n, p in params.items():
        p.requires_grad_(static_frozen is None or not static_frozen[n])


def make_train_step(model: KEEPModel, loss_cfg: LossConfig, tx: AdamW, *,
                    remat: bool = True,
                    static_frozen: Optional[dict] = None,
                    lora_scale: Optional[float] = None,
                    base: Optional[dict] = None,
                    layout: Optional[ParallelLayout] = None) -> Callable:
    """One optimizer step: ``step(state, batch, frozen=None) → (state,
    metrics)``. ``batch`` holds device tensors (``to_device``); ``frozen`` is
    an ``optim.freeze_mask`` dict of 0/1. ``static_frozen`` ({name: bool})
    also takes the frozen parameters out of autograd for the step; grads
    and updates are then the same as under the dynamic mask alone.

    ``lora_scale`` switches the step to LoRA fine-tuning: ``state.params``
    is the adapter dict, ``base`` every parameter of the model as a tensor
    that takes no gradient (``{n: p.detach()}``), and the forward and the
    backward run on ``lora.apply_lora(base, adapters, lora_scale)`` swapped
    into the model; gradients reach only the adapters.

    ``layout`` (a ``ParallelLayout``) trains the model split over a process
    mesh: the gradients are taken on the model's own (compute) parameters
    and reduced into the state's pieces."""
    if lora_scale is not None and base is None:
        raise ValueError("a LoRA step needs the base parameters (base=)")
    if lora_scale is not None and layout is not None:
        raise ValueError("a LoRA step composes with dp only")

    def step(state: TrainState, batch: dict, frozen: Optional[dict] = None):
        compute = (state.params if layout is None
                   else dict(model.named_parameters()))
        _set_static_frozen(compute, static_frozen)
        weights = (contextlib.nullcontext() if lora_scale is None else
                   lora.swapped(model, lora.apply_lora(base, state.params,
                                                       lora_scale)))
        with weights:
            loss = compute_loss(model, batch, loss_cfg, remat=remat,
                                act_sharding=layout and layout.sp,
                                pp_mesh=layout and layout.pp_mesh)
            grads = _grads(loss, compute)
        if layout is None:
            all_reduce_grads(grads, _live(state.params))
        else:
            grads = layout.reduce_grads(grads, _live(compute))
        return _optimizer_apply(state, grads, tx, frozen, loss.detach(),
                                layout, model)

    return step


def make_accum_train_step(model: KEEPModel, loss_cfg: LossConfig, tx: AdamW,
                          accum_freq: int, *, remat: bool = True,
                          layout: Optional[ParallelLayout] = None
                          ) -> Callable:
    """Gradient accumulation with cached negatives: ``batches`` arrays carry
    a leading [accum_freq, micro, ...] axis, except ``node_connection``,
    which is ONE [accum·caption_num]² reachability matrix over every chunk's
    group labels. Each chunk's loss is the full super-batch loss with only
    that chunk's features live; the chunk gradients sum into one optimizer
    step (``logit_scale``'s gradient so ~accum× the full-batch one, as in
    the reference). Under data parallelism each chunk holds this rank's
    rows of the microbatch; the cache and the live chunk are the gathered
    global microbatches. ``layout``: as for ``make_train_step`` (sequence
    parallelism does not compose with accumulation)."""
    if layout is not None and layout.sp is not None:
        raise ValueError("solver.sp does not compose with accum_freq > 1")

    def step(state: TrainState, batches: dict, frozen: Optional[dict] = None):
        compute = (state.params if layout is None
                   else dict(model.named_parameters()))
        _set_static_frozen(compute, None)
        stacked = {k: v for k, v in batches.items() if k != "node_connection"}
        chunks = [{k: v[j] for k, v in stacked.items()}
                  for j in range(accum_freq)]
        with torch.no_grad():
            feats = [_encode_batch(model, mb, remat=False) for mb in chunks]
        img_cache = torch.cat([gather_rows(f[0]) for f in feats])
        txt_cache = torch.cat([gather_rows(f[1]) for f in feats])
        micro = img_cache.shape[0] // accum_freq
        batches = _global_labels(batches, row_dim=1)
        grads, losses = None, []
        for j, mb in enumerate(chunks):
            img_j, txt_j, aux_j = _encode_batch(model, mb, remat)
            lo, hi = j * micro, (j + 1) * micro
            img_all = torch.cat([img_cache[:lo], gather_rows(img_j),
                                 img_cache[hi:]])
            txt_all = torch.cat([txt_cache[:lo], gather_rows(txt_j),
                                 txt_cache[hi:]])
            loss = _loss(img_all, txt_all, batches,
                         torch.exp(model.logit_scale), loss_cfg,
                         accum_freq * loss_cfg.caption_num)
            if model.moe:
                # the chunk gradients sum: each chunk's aux at 1 / accum, so
                # that the aux gradient is that of the chunks' mean
                loss = loss + (model.cfg.vision.moe_aux_weight
                               / accum_freq) * aux_j
            g = _grads(loss, compute)
            grads = g if grads is None else {n: grads[n] + g[n] for n in g}
            losses.append(loss.detach())
        if layout is None:
            all_reduce_grads(grads, _live(state.params))
        else:
            grads = layout.reduce_grads(grads, _live(compute))
        return _optimizer_apply(state, grads, tx, frozen,
                                torch.stack(losses).mean(), layout, model)

    return step
