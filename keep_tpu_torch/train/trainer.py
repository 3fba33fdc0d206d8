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
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from keep_tpu_torch.models import moe
from keep_tpu_torch.models.keep import KEEPModel
from keep_tpu_torch.parallel.mesh import all_reduce_grads, gather_rows
from keep_tpu_torch.train import lora
from keep_tpu_torch.train.loss import clip_loss, hy_metric_loss
from keep_tpu_torch.train.optim import AdamW, global_norm

LOGIT_SCALE_MAX = math.log(100.0)


@dataclasses.dataclass
class TrainState:
    # the model's parameters, or LoRA adapters; updated in place
    params: dict[str, torch.Tensor]
    opt_state: dict
    step: int


def tree_state(model: KEEPModel | dict, tx: AdamW) -> TrainState:
    """The state over a model's parameters, or over a dict of trainable
    tensors (LoRA adapters)."""
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


def _encode_batch(model: KEEPModel, batch: dict, remat: bool = True):
    """(image features, text features, the MoE aux loss: 0 when dense) of
    this rank's rows; the aux loss is the global batch's."""
    with moe.global_batch():
        img, aux = model.encode_image(batch["pixels"], remat=remat,
                                      return_aux=True)
    txt = model.encode_text(batch["input_ids"], batch.get("attention_mask"),
                            batch.get("token_type_ids"), remat=remat)
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
                 remat: bool = True) -> torch.Tensor:
    img, txt, aux = _encode_batch(model, batch, remat)
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
                     frozen: Optional[dict], loss: torch.Tensor):
    """The freeze → update → clamp → metrics tail shared by both steps."""
    grads = _apply_freeze(grads, frozen)
    params = {n: p.detach() for n, p in state.params.items()}
    updates, state.opt_state = tx.update(grads, state.opt_state, params)
    updates = _apply_freeze(updates, frozen)
    for n, p in state.params.items():
        p.add_(updates[n])
    ls = state.params["logit_scale"]
    ls.clamp_(0.0, LOGIT_SCALE_MAX)
    state.step += 1
    return state, {"loss": loss, "grad_norm": global_norm(grads),
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
                    base: Optional[dict] = None) -> Callable:
    """One optimizer step: ``step(state, batch, frozen=None) → (state,
    metrics)``. ``batch`` holds device tensors (``to_device``); ``frozen`` is
    an ``optim.freeze_mask`` dict of 0/1. ``static_frozen`` ({name: bool})
    also takes the frozen parameters out of autograd for the step; grads
    and updates are then the same as under the dynamic mask alone.

    ``lora_scale`` switches the step to LoRA fine-tuning: ``state.params``
    is the adapter dict, ``base`` every parameter of the model as a tensor
    that takes no gradient (``{n: p.detach()}``), and the forward and the
    backward run on ``lora.apply_lora(base, adapters, lora_scale)`` swapped
    into the model; gradients reach only the adapters."""
    if lora_scale is not None and base is None:
        raise ValueError("a LoRA step needs the base parameters (base=)")

    def step(state: TrainState, batch: dict, frozen: Optional[dict] = None):
        _set_static_frozen(state.params, static_frozen)
        weights = (contextlib.nullcontext() if lora_scale is None else
                   lora.swapped(model, lora.apply_lora(base, state.params,
                                                       lora_scale)))
        with weights:
            loss = compute_loss(model, batch, loss_cfg, remat=remat)
            grads = _grads(loss, state.params)
        all_reduce_grads(grads, _live(state.params))
        return _optimizer_apply(state, grads, tx, frozen, loss.detach())

    return step


def make_accum_train_step(model: KEEPModel, loss_cfg: LossConfig, tx: AdamW,
                          accum_freq: int, *, remat: bool = True) -> Callable:
    """Gradient accumulation with cached negatives: ``batches`` arrays carry
    a leading [accum_freq, micro, ...] axis, except ``node_connection``,
    which is ONE [accum·caption_num]² reachability matrix over every chunk's
    group labels. Each chunk's loss is the full super-batch loss with only
    that chunk's features live; the chunk gradients sum into one optimizer
    step (``logit_scale``'s gradient so ~accum× the full-batch one, as in
    the reference). Under data parallelism each chunk holds this rank's
    rows of the microbatch; the cache and the live chunk are the gathered
    global microbatches."""

    def step(state: TrainState, batches: dict, frozen: Optional[dict] = None):
        _set_static_frozen(state.params, None)
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
            g = _grads(loss, state.params)
            grads = g if grads is None else {n: grads[n] + g[n] for n in g}
            losses.append(loss.detach())
        all_reduce_grads(grads, _live(state.params))
        return _optimizer_apply(state, grads, tx, frozen,
                                torch.stack(losses).mean())

    return step
