"""Checkpoint and resume (counterpart of ``keep_tpu/train/checkpoint.py``,
which writes Orbax checkpoints).

One file per epoch, ``<ckpt_dir>/epoch_<n>.pt``: the parameters, the
optimizer state (moments and step count), the step and the epoch, written
with ``torch.save`` to a temporary file in the same directory and moved into
place with ``os.replace``, so a reader never sees half a checkpoint.
``restore(epoch=None)`` loads the newest one (resume 'latest').
``CheckpointWriter(async_save=True)`` writes in a background thread while
training goes on; its ``save`` returns once it holds a host copy of the
tensors, which the next step may then update in place.

Reading the JAX package's Orbax checkpoints is out of scope: convert a JAX
parameter tree with ``compat.torch_loader.from_jax_params`` instead.
"""

from __future__ import annotations

import os
import re
import tempfile
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Optional

import torch

_NAME = re.compile(r"epoch_(\d+)\.pt")


def path(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(ckpt_dir, f"epoch_{epoch}.pt")


def save(ckpt_dir: str, epoch: int, params: dict, opt_state: Any = None,
         step: int = 0, keep_previous: bool = True) -> str:
    """Writes checkpoint ``epoch`` atomically; with ``keep_previous=False``
    the older epochs are deleted after it is in place. Returns its path.
    One-shot wrapper over ``CheckpointWriter``."""
    w = CheckpointWriter(ckpt_dir, keep_previous=keep_previous)
    try:
        w.save(epoch, params, opt_state, step=step)
    finally:
        w.close()
    return path(ckpt_dir, epoch)


class CheckpointWriter:
    """Per-epoch saves into ``ckpt_dir``. ``save`` copies the tensors to the
    host and waits for the copy (the train step updates the parameters in
    place), then writes, in the caller's thread or, with
    ``async_save=True``, in one background thread while training goes on;
    saves are written in order. ``wait`` blocks until every save is on disk
    and re-raises a failed one; ``close`` waits and stops the thread."""

    def __init__(self, ckpt_dir: str, async_save: bool = False,
                 keep_previous: bool = True):
        self.ckpt_dir = ckpt_dir
        self.keep_previous = keep_previous
        self._pool = (ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix="checkpoint")
                      if async_save else None)
        self._pending: list[Future] = []
        os.makedirs(ckpt_dir, exist_ok=True)

    def save(self, epoch: int, params: dict, opt_state: Any = None,
             step: int = 0) -> None:
        payload = {"params": _to_host(params), "opt_state": _to_host(opt_state),
                   "step": int(step), "epoch": int(epoch)}
        if self._pool is None:
            self._write(epoch, payload)
        else:
            self._pending.append(self._pool.submit(self._write, epoch,
                                                   payload))

    def _write(self, epoch: int, payload: dict) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.ckpt_dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                torch.save(payload, f)
            os.replace(tmp, path(self.ckpt_dir, epoch))
        except BaseException:
            os.unlink(tmp)
            raise
        if not self.keep_previous:
            for e in list_epochs(self.ckpt_dir):
                if e != epoch:
                    os.remove(path(self.ckpt_dir, e))

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)


def _to_host(tree):
    """A host copy of every tensor of ``tree``, made before this returns:
    ``Tensor.to(copy=True)`` copies a CPU tensor too, where ``.cpu()``
    would hand back its storage."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
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
