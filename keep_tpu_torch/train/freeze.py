"""Freeze scheduling: towers frozen for the first K epochs, and the check
that frozen weights did not move (counterpart of ``keep_tpu/train/freeze.py``).

A frozen tower enters training twice: as the dynamic 0/1 mask of
``optim.freeze_mask`` (grads and updates are zeroed, so weight decay cannot
move it either), and as ``requires_grad_(False)`` for the phase, so that
autograd builds no graph and runs no backward through it."""

from __future__ import annotations

import dataclasses
import math
from typing import FrozenSet, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class FreezeSchedule:
    freeze_visual_epochs: int = 0
    freeze_text_epochs: int = 0
    freeze_knowledge_epochs: int = 0
    keep_text_head_open: bool = True  # mlp_embed stays trainable

    def frozen_towers(self, epoch: int) -> FrozenSet[str]:
        out = set()
        if epoch < self.freeze_visual_epochs:
            out.add("visual")
        if epoch < self.freeze_text_epochs:
            out.add("text")
        if epoch < self.freeze_knowledge_epochs:
            out.add("knowledge")
        return frozenset(out)

    def frozen_fn(self, epoch: int):
        towers = self.frozen_towers(epoch)
        keep_head = self.keep_text_head_open

        def fn(path_keys: Sequence[str]) -> bool:
            if not path_keys or path_keys[0] not in towers:
                return False
            return not (path_keys[0] == "text" and keep_head
                        and "mlp_embed" in path_keys)

        return fn

    def phases(self, epochs: int) -> list[tuple[int, FrozenSet[str]]]:
        """[(first_epoch, frozen_towers)] at each change over the run."""
        out = []
        prev = None
        for e in range(epochs):
            cur = self.frozen_towers(e)
            if cur != prev:
                out.append((e, cur))
                prev = cur
        return out


@torch.no_grad()
def snapshot(params: dict[str, torch.Tensor]) -> dict[str, float]:
    """L2 norm of each top-level group of parameters (``visual``,
    ``visual_head``, ``text``, ``logit_scale``)."""
    sums: dict[str, float] = {}
    for name, p in params.items():
        top = name.split(".", 1)[0]
        sums[top] = sums.get(top, 0.0) + float(torch.sum(p.float() ** 2))
    return {k: math.sqrt(v) for k, v in sums.items()}


def diff_report(before: dict[str, float], after_params: dict[str, torch.Tensor],
                atol: float = 1e-7) -> dict[str, str]:
    """{group: 'frozen' | 'open'} by comparing norms across an epoch."""
    after = snapshot(after_params)
    return {k: ("frozen" if abs(after[k] - before[k])
                <= atol * max(1.0, before[k]) else "open")
            for k in before}
