"""Training losses: symmetric InfoNCE (CLIP) and the hierarchical hard-mining
metric loss (HyMetricLoss). Counterpart of ``keep_tpu/train/loss.py``.

Everything runs in fp32 on the features (the towers' outputs are cast
first). Single process: the JAX package's cross-shard gather
(``axis_name``) comes with distributed training. DO-graph reachability runs
on the host per batch and enters the loss as an [N_id, N_id] ±1 array.
"""

from __future__ import annotations

import functools
import json
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from keep_tpu_torch.ops.nn import l2_normalize

# ---------------------------------------------------------------------------
# CLIP InfoNCE
# ---------------------------------------------------------------------------


def clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
              logit_scale: torch.Tensor, *,
              labels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Symmetric InfoNCE over the local batch; with ``labels``, the
    label-masked denominator of ``mask_contrastive_loss``."""
    logits_i = logit_scale * image_features @ text_features.T
    logits_t = logits_i.T
    if labels is not None:
        return 0.5 * (mask_contrastive_loss(logits_i, labels)
                      + mask_contrastive_loss(logits_t, labels))
    gt = torch.arange(logits_i.shape[0], device=logits_i.device)
    return 0.5 * (F.cross_entropy(logits_i, gt) + F.cross_entropy(logits_t, gt))


def mask_contrastive_loss(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Label-masked InfoNCE: same-label off-diagonal pairs are excluded from
    the denominator (row-shifted exp against fp32 overflow)."""
    n = logits.shape[0]
    lab = labels.to(torch.int32) + 1
    diff = lab[None, :] - lab[:, None]
    eye = torch.eye(n, dtype=logits.dtype, device=logits.device)
    mask = (diff != 0).to(logits.dtype) + eye
    mask = torch.where(mask != 0, 1.0, 0.0)
    shifted = logits - torch.max(logits, 1, keepdim=True).values.detach()
    denom = torch.sum(torch.exp(shifted) * mask, dim=1)
    num = torch.exp(torch.diagonal(shifted))
    return -torch.mean(torch.log(num / denom))


# ---------------------------------------------------------------------------
# Hierarchical hard-mining metric loss
# ---------------------------------------------------------------------------


class DOGraph:
    """Disease-Ontology parent graph for negative masking.
    ``node_parents[label]`` = list of parents; reachability is memoized."""

    def __init__(self, node_parents: dict[str, list[str]]):
        self.parents = node_parents
        self._memo: dict[tuple[str, str], bool] = {}

    @classmethod
    def from_json(cls, path: str) -> "DOGraph":
        with open(path) as f:
            nodes = json.load(f)
        return cls({k: v["parent"] for k, v in nodes.items()})

    def reachable(self, start: str, end: str) -> bool:
        """True iff ``start`` is an ancestor of ``end`` (or equal)."""
        key = (start, end)
        cached = self._memo.get(key)
        if cached is None:
            cached = self._memo[key] = self._reachable(start, end)
        return cached

    def _reachable(self, start: str, end: str) -> bool:
        if start not in self.parents or end not in self.parents:
            return False
        if start == end:
            return True
        frontier = [end]
        seen = set()
        while frontier:
            nxt = []
            for node in frontier:
                for p in self.parents.get(node, ()):
                    if p == start:
                        return True
                    if p not in seen:
                        seen.add(p)
                        nxt.append(p)
            frontier = nxt
        return False

    def node_connection(self, labels: Sequence[str]) -> np.ndarray:
        """[N_id, N_id] of ±1: −1 where two group labels are DO ancestor /
        descendant related (excluded from negatives), +1 elsewhere."""
        n = len(labels)
        out = np.ones((n, n), np.float32)
        for i in range(n):
            for j in range(n):
                if i != j and (self.reachable(labels[i], labels[j])
                               or self.reachable(labels[j], labels[i])):
                    out[i, j] = -1.0
        return out

    def unknown_connection(self, labels: Sequence[str]) -> np.ndarray:
        """[N_id, N_id] mask for the extra-negative block: −1 off-diagonal,
        −1 on the diagonal for 'unknown' labels."""
        n = len(labels)
        out = -np.ones((n, n), np.float32)
        for i in range(n):
            if labels[i] != "unknown":
                out[i, i] = 1.0
        return out


@functools.lru_cache(maxsize=8)
def _kron_masks_np(n_id: int, n_ins: int):
    eye = np.eye(n_id, dtype=np.float32)
    right = np.kron(eye, np.ones((n_ins, 1), np.float32))  # [n, N_id]
    left = right.T  # [N_id, n]
    within = np.kron(eye, np.ones((n_ins, n_ins), np.float32))  # 1 in-group
    sign = np.where(within > 0, -1.0, 1.0).astype(np.float32)  # -1 in-group
    return right, left, within, sign, eye


def _kron_masks(n_id: int, n_ins: int, device) -> tuple[torch.Tensor, ...]:
    # fresh tensors per call: the cached numpy arrays are shared
    return tuple(torch.from_numpy(m).to(device)
                 for m in _kron_masks_np(n_id, n_ins))


def _exp_ftz(x: torch.Tensor) -> torch.Tensor:
    """exp with subnormal results flushed to zero, as the TPU (and XLA on
    the CPU) computes it: an underflowed group sum must reach the reciprocal
    guards below as an exact 0, where 1/subnormal would be inf."""
    e = torch.exp(x)
    return torch.where(e < torch.finfo(e.dtype).tiny, torch.zeros_like(e), e)


def _metric_loss(sim: torch.Tensor, scale: torch.Tensor, n_id: int,
                 n_ins: int, loss_type: str) -> torch.Tensor:
    """One direction of the metric loss. ``sim`` is [n, n] or
    [n, n + n_extra] with extra negative columns."""
    n = n_id * n_ins
    rows, cols = sim.shape
    right, left, within, sign, pos_id = _kron_masks(n_id, n_ins, sim.device)

    sf = sim * scale
    sf_qq = sf[:, :n]
    # the exponent is clamped at 85 (fp32 exp overflows at ~88.7; a row
    # shift is not loss-invariant here, positives enter as reciprocals)
    e = _exp_ftz(torch.clamp(sf_qq * sign, max=85.0))
    group_sums = e @ right  # [n, N_id]
    pos_mask = right

    def l1_log_diag(mat: torch.Tensor) -> torch.Tensor:
        l1 = mat / torch.sum(torch.abs(mat), dim=1, keepdim=True)
        return -torch.mean(torch.log(torch.diagonal(l1)[: mat.shape[0]]))

    def recip(x: torch.Tensor, zero: torch.Tensor) -> torch.Tensor:
        # 1/x with 1 where `zero` holds (the exp-underflow guards)
        return 1.0 / torch.where(zero, torch.ones_like(x), x)

    if loss_type == "hp-hn":
        gg = left @ group_sums
        inv_diag = recip(gg, gg == 0)
        gg = gg * (1 - pos_id) + inv_diag * pos_id
        return l1_log_diag(gg)

    if loss_type == "lhp-hn":
        inv_pos = recip(group_sums, group_sums * pos_mask == 0)
        staged = group_sums * (1 - pos_mask) + inv_pos * pos_mask
        gg = left @ staged
        if cols != rows:
            # extra negative text block (same N_id × N_ins structure): per
            # group, the exp-mass of its own extra-column block
            extra = _exp_ftz(torch.clamp(sf[:, n:] * within, max=85.0))
            add_diag = torch.diagonal(left @ extra @ right)
            gg = torch.cat([gg, add_diag[:, None]], dim=1)
        return l1_log_diag(gg)

    if loss_type == "hp-lhn":
        inv_neg = recip(group_sums, group_sums * (1 - pos_mask) == 0)
        staged = inv_neg * (1 - pos_mask) + group_sums * pos_mask
        pooled = left @ staged
        return l1_log_diag(recip(pooled, pooled == 0))

    if loss_type == "lhp-lhn":
        inv_all = recip(group_sums, group_sums == 0)
        gg = left @ inv_all
        gg = (1.0 / gg) * (1 - pos_id) + gg * pos_id
        return l1_log_diag(gg)

    raise ValueError(f"unknown loss_type {loss_type}")


def hy_metric_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                   node_connection: torch.Tensor, logit_scale: torch.Tensor,
                   *, caption_num: int, loss_type: str = "lhp-hn",
                   unknown_connection: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """HyMetricLoss: DO-related pairs masked to sim −1, then the symmetric
    i→t + t→i metric loss halves. ``node_connection`` is
    ``DOGraph.node_connection`` of the batch's group labels;
    ``unknown_connection`` masks extra text columns when ``text_features``
    has more rows than ``image_features``."""
    img = l2_normalize(image_features.float())
    txt = l2_normalize(text_features.float())
    n = img.shape[0]
    n_id = caption_num
    n_ins = n // caption_num

    sim = img @ txt.T  # [n, n_txt]
    ones = torch.ones(n_ins, n_ins, device=sim.device)
    node_mask = torch.kron(node_connection.float().to(sim.device), ones)
    if txt.shape[0] != n:
        if unknown_connection is None:
            raise ValueError("extra text columns require unknown_connection")
        node_mask = torch.cat(
            [node_mask,
             torch.kron(unknown_connection.float().to(sim.device), ones)],
            dim=1)
    sim = sim.masked_fill(node_mask == -1, -1.0)

    it = _metric_loss(sim, logit_scale, n_id, n_ins, loss_type) / 2
    ti = _metric_loss(sim[:n, :n].T, logit_scale, n_id, n_ins, loss_type) / 2
    return it + ti
