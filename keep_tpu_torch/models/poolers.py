"""Text-feature pooler registry (counterpart of
``keep_tpu/models/poolers.py``; the reference's hf_model.py:45-94).

A pooler maps (last_hidden_state [B, S, D], attention_mask [B, S],
pooler_output [B, D] or None) → [B, D]. The reference's MaxPooler fills
the VALID positions with −inf (an inverted mask); this one, as the JAX
package's, takes the max over the valid positions.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

_POOLERS: dict[str, Callable] = {}


def register_pooler(name: str):
    def wrap(fn):
        _POOLERS[name] = fn
        return fn

    return wrap


def get_pooler(name: str) -> Callable:
    if name not in _POOLERS:
        raise KeyError(f"unknown pooler {name!r}; have {sorted(_POOLERS)}")
    return _POOLERS[name]


@register_pooler("mean_pooler")
def mean_pooler(hidden: torch.Tensor, mask: torch.Tensor,
                pooler_output=None) -> torch.Tensor:
    m = mask.to(hidden.dtype)[..., None]
    return (hidden * m).sum(dim=1) / m.sum(dim=1)


@register_pooler("max_pooler")
def max_pooler(hidden: torch.Tensor, mask: torch.Tensor,
               pooler_output=None) -> torch.Tensor:
    neg = torch.tensor(float("-inf"), dtype=hidden.dtype,
                       device=hidden.device)
    return torch.where(mask[..., None].bool(), hidden, neg).amax(dim=1)


@register_pooler("cls_pooler")
def cls_pooler(hidden: torch.Tensor, mask: torch.Tensor,
               pooler_output: Optional[torch.Tensor] = None) -> torch.Tensor:
    if pooler_output is not None:
        return pooler_output
    return hidden[:, 0]


@register_pooler("cls_last_hidden_state_pooler")
def cls_last_hidden_state_pooler(hidden: torch.Tensor, mask: torch.Tensor,
                                 pooler_output=None) -> torch.Tensor:
    return hidden[:, 0]
