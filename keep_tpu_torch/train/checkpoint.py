"""Checkpoint and resume (counterpart of ``keep_tpu/train/checkpoint.py``,
which writes Orbax checkpoints).

One file per epoch, ``<ckpt_dir>/epoch_<n>.pt``: the parameters, the
optimizer state (moments and step count), the step and the epoch, written
with ``torch.save`` to a temporary file in the same directory and moved into
place with ``os.replace``, so a reader never sees half a checkpoint.
``restore(epoch=None)`` loads the newest one (resume 'latest').

Reading the JAX package's Orbax checkpoints is out of scope: convert a JAX
parameter tree with ``compat.torch_loader.from_jax_params`` instead.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Optional

import torch

_NAME = re.compile(r"epoch_(\d+)\.pt")


def path(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(ckpt_dir, f"epoch_{epoch}.pt")


def save(ckpt_dir: str, epoch: int, params: dict, opt_state: Any = None,
         step: int = 0, keep_previous: bool = True) -> str:
    """Writes checkpoint ``epoch`` atomically; with ``keep_previous=False``
    the older epochs are deleted after it is in place. Returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {"params": {k: v.detach().cpu() for k, v in params.items()},
               "opt_state": _to_cpu(opt_state), "step": int(step),
               "epoch": int(epoch)}
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
        os.replace(tmp, path(ckpt_dir, epoch))
    except BaseException:
        os.unlink(tmp)
        raise
    if not keep_previous:
        for e in list_epochs(ckpt_dir):
            if e != epoch:
                os.remove(path(ckpt_dir, e))
    return path(ckpt_dir, epoch)


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def list_epochs(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.fullmatch,
                                               os.listdir(ckpt_dir)) if m)


def latest_epoch(ckpt_dir: str) -> Optional[int]:
    """The newest saved epoch, or None."""
    epochs = list_epochs(ckpt_dir)
    return epochs[-1] if epochs else None


def restore(ckpt_dir: str, epoch: Optional[int] = None,
            map_location="cpu") -> dict:
    """{'params', 'opt_state', 'step', 'epoch'} of checkpoint ``epoch``
    (default: the newest). Raises FileNotFoundError when there is none."""
    if epoch is None:
        epoch = latest_epoch(ckpt_dir)
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    return torch.load(path(ckpt_dir, epoch), map_location=map_location,
                      weights_only=True)
