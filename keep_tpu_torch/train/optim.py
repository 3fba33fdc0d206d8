"""AdamW with the reference's weight-decay exemptions and freeze masks
(counterpart of ``keep_tpu/train/optim.py``).

The JAX package builds an optax chain; this module is the same chain as
plain functions over named parameter tensors, in the same order:

1. zero the gradients of BatchNorm running statistics (``bn_stats_mask``;
   KEEP has none, the mask is kept for trunks that do);
2. clip by global norm: ``g·max_norm/norm`` when ``norm ≥ max_norm``;
3. Adam, bias-corrected by ONE global step count (optax's ``count``), so
   every parameter, frozen or not, sees the same correction;
4. decoupled weight decay ``+ wd·p`` where ``wd_mask`` holds;
5. ``· −lr(count)``.

``torch.optim.AdamW`` is not used: it keeps a step per parameter and skips
parameters without a gradient, so its bias correction drifts from optax's
after a freeze phase, and ``clip_grad_norm_`` divides by ``norm + 1e-6``.
The moments are updated in place (they belong to the optimizer state).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

Params = dict[str, torch.Tensor]

_MU_DTYPES = {None: torch.float32, "float32": torch.float32,
              "bfloat16": torch.bfloat16}


def wd_mask(model: nn.Module) -> dict[str, bool]:
    """True where weight decay applies, decided by module: every ``Linear``
    weight (the patch embed, the visual head and the pooler included) and the
    three BERT embedding tables. Biases, LayerNorm gains, ``cls_token``,
    ``pos_embed``, ``ls1``/``ls2`` and ``logit_scale`` are not decayed."""
    from keep_tpu_torch.models.bert import Embeddings
    from keep_tpu_torch.ops.nn import Linear

    decayed = set()
    for mname, m in model.named_modules():
        prefix = f"{mname}." if mname else ""
        if isinstance(m, Linear):
            decayed.add(prefix + "weight")
        elif isinstance(m, Embeddings):
            decayed.update(prefix + n for n in ("word", "position",
                                                 "token_type"))
    return {n: n in decayed for n, _ in model.named_parameters()}


def bn_stats_mask(names) -> dict[str, bool]:
    """True for BatchNorm running-statistic leaves (``mean``/``var``), which
    the optimizer must never move."""
    return {n: n.rsplit(".", 1)[-1] in ("mean", "var") for n in names}


def global_norm(tensors: Params) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares (fp32)."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float())
                          for t in tensors.values()))


def freeze_mask(names, frozen_fn: Callable) -> dict[str, float]:
    """{name: 1.0 where ``frozen_fn(path)`` holds, else 0.0}, with ``path``
    the dotted name split into its parts (``('visual', 'blocks', '0', ...)``,
    the JAX package's key paths)."""
    return {n: 1.0 if frozen_fn(tuple(n.split("."))) else 0.0 for n in names}


@dataclasses.dataclass
class AdamW:
    """The optax chain of ``keep_tpu.train.optim.adamw``. ``learning_rate``
    maps the step count to the learning rate; ``decay_mask`` is ``wd_mask``
    of the model; ``mu_dtype='bfloat16'`` stores the first moment in bf16
    (the second stays fp32)."""

    learning_rate: Callable[[int], float]
    decay_mask: dict[str, bool]
    weight_decay: float = 0.2
    b1: float = 0.9
    b2: float = 0.98
    eps: float = 1e-6
    grad_clip_norm: Optional[float] = None
    mu_dtype: Optional[str] = None

    def __post_init__(self):
        if self.mu_dtype not in _MU_DTYPES:
            raise ValueError(f"mu_dtype must be one of {list(_MU_DTYPES)}, "
                             f"got {self.mu_dtype!r}")

    def init(self, params: Params) -> dict:
        mu_dtype = _MU_DTYPES[self.mu_dtype]
        return {"count": 0,
                "mu": {n: torch.zeros_like(p, dtype=mu_dtype)
                       for n, p in params.items()},
                "nu": {n: torch.zeros_like(p, dtype=torch.float32)
                       for n, p in params.items()}}

    @torch.no_grad()
    def update(self, grads: Params, state: dict,
               params: Params) -> tuple[Params, dict]:
        """(updates to add to the parameters, the new state). ``grads`` holds
        every parameter's gradient (zeros for frozen ones); the moments in
        ``state`` are updated in place."""
        bn = bn_stats_mask(grads)
        g = {n: torch.zeros_like(t) if bn[n] else t for n, t in grads.items()}
        if self.grad_clip_norm is not None:
            norm = global_norm(g)
            if not bool(norm < self.grad_clip_norm):
                g = {n: (t / norm) * self.grad_clip_norm for n, t in g.items()}
        count = state["count"] + 1
        dev = next(iter(params.values())).device
        bc1 = 1 - torch.tensor(self.b1, device=dev) ** count
        bc2 = 1 - torch.tensor(self.b2, device=dev) ** count
        lr = torch.tensor(-self.learning_rate(state["count"]),
                          dtype=torch.float32, device=dev)
        mu_store = _MU_DTYPES[self.mu_dtype]
        updates = {}
        for n, t in g.items():
            mu_old, nu = state["mu"][n], state["nu"][n]
            # b1·mu in the moment's stored dtype, b1 rounded to it too (JAX
            # casts the Python scalar to a bf16 moment's dtype), then the sum
            # in fp32
            b1 = torch.tensor(self.b1, dtype=mu_old.dtype, device=dev)
            mu = (1 - self.b1) * t + (b1 * mu_old).float()
            nu.mul_(self.b2).add_((1 - self.b2) * (t * t))
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.decay_mask[n]:
                u = u + self.weight_decay * params[n]
            updates[n] = lr * u
            mu_old.copy_(mu.to(mu_store))
        return updates, {"count": count, "mu": state["mu"],
                         "nu": state["nu"]}
