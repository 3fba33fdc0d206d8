"""The training step (counterpart of ``keep_tpu/train/trainer.py``).

encode_image / encode_text (bf16 compute over fp32 master weights, per-block
remat) → HyMetricLoss or CLIP loss with ``exp(logit_scale)`` → gradients →
freeze mask → AdamW (``optim.AdamW``) → freeze mask on the updates →
``logit_scale`` clamped to [0, ln 100]. Gradient accumulation caches every
microbatch's features without grad, then re-forwards each chunk with the
cached rest as negatives and sums the chunks' gradients.

The JAX package jits one step per freeze phase; here ``static_frozen`` sets
``requires_grad_(False)`` on the frozen parameters at each step, so autograd
builds no graph through a frozen tower and runs no backward there. The
parameters are the model's own and are updated in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from keep_tpu_torch.models.keep import KEEPModel
from keep_tpu_torch.train.loss import clip_loss, hy_metric_loss
from keep_tpu_torch.train.optim import AdamW, global_norm

LOGIT_SCALE_MAX = math.log(100.0)


@dataclasses.dataclass
class TrainState:
    params: dict[str, torch.nn.Parameter]  # the model's, updated in place
    opt_state: dict
    step: int


def tree_state(model: KEEPModel, tx: AdamW) -> TrainState:
    params = dict(model.named_parameters())
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
    img = model.encode_image(batch["pixels"], remat=remat)
    txt = model.encode_text(batch["input_ids"], batch.get("attention_mask"),
                            batch.get("token_type_ids"), remat=remat)
    return img, txt


def _loss(img, txt, batch, scale, loss_cfg: LossConfig, caption_num: int):
    if loss_cfg.kind == "hierarchy_metric":
        return hy_metric_loss(img, txt, batch["node_connection"], scale,
                              caption_num=caption_num,
                              loss_type=loss_cfg.loss_subtype)
    labels = batch.get("labels")
    return clip_loss(img, txt, scale,
                     labels=None if labels is None else labels.reshape(-1))


def compute_loss(model: KEEPModel, batch: dict, loss_cfg: LossConfig, *,
                 remat: bool = True) -> torch.Tensor:
    img, txt = _encode_batch(model, batch, remat)
    return _loss(img, txt, batch, torch.exp(model.logit_scale), loss_cfg,
                 loss_cfg.caption_num)


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


def _grads(loss: torch.Tensor, params: dict) -> dict:
    """d loss / d params, zeros where a parameter takes no gradient."""
    live = [n for n, p in params.items() if p.requires_grad]
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
                    static_frozen: Optional[dict] = None) -> Callable:
    """One optimizer step: ``step(state, batch, frozen=None) → (state,
    metrics)``. ``batch`` holds device tensors (``to_device``); ``frozen`` is
    an ``optim.freeze_mask`` dict of 0/1. ``static_frozen`` ({name: bool})
    also takes the frozen parameters out of autograd for the step; grads
    and updates are then the same as under the dynamic mask alone."""

    def step(state: TrainState, batch: dict, frozen: Optional[dict] = None):
        _set_static_frozen(state.params, static_frozen)
        loss = compute_loss(model, batch, loss_cfg, remat=remat)
        grads = _grads(loss, state.params)
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
    the reference)."""

    def step(state: TrainState, batches: dict, frozen: Optional[dict] = None):
        _set_static_frozen(state.params, None)
        stacked = {k: v for k, v in batches.items() if k != "node_connection"}
        chunks = [{k: v[j] for k, v in stacked.items()}
                  for j in range(accum_freq)]
        with torch.no_grad():
            feats = [_encode_batch(model, mb, remat=False) for mb in chunks]
        img_cache = torch.cat([f[0] for f in feats])
        txt_cache = torch.cat([f[1] for f in feats])
        micro = feats[0][0].shape[0]
        grads, losses = None, []
        for j, mb in enumerate(chunks):
            img_j, txt_j = _encode_batch(model, mb, remat)
            lo, hi = j * micro, (j + 1) * micro
            img_all = torch.cat([img_cache[:lo], img_j, img_cache[hi:]])
            txt_all = torch.cat([txt_cache[:lo], txt_j, txt_cache[hi:]])
            loss = _loss(img_all, txt_all, batches,
                         torch.exp(model.logit_scale), loss_cfg,
                         accum_freq * loss_cfg.caption_num)
            g = _grads(loss, state.params)
            grads = g if grads is None else {n: grads[n] + g[n] for n in g}
            losses.append(loss.detach())
        return _optimizer_apply(state, grads, tx, frozen,
                                torch.stack(losses).mean())

    return step
