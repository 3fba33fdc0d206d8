"""Image preprocessing of the serving path (counterpart of part of
``keep_tpu/ops/preprocess.py``).

The server normalises model-size uint8 tiles on the device
(``normalize_only``) and resizes other sizes on the host with PIL, using the
torchvision window arithmetic below. The device-side bicubic ``preprocess``
is not ported yet.
"""

from __future__ import annotations

import functools

import torch

from keep_tpu_torch.configs import PreprocessConfig


def resized_output_size(h: int, w: int, size: int) -> tuple[int, int]:
    """torchvision ``Resize(int)``: shortest side → size, the other side
    scaled and truncated to int."""
    if h <= w:
        return size, int(size * w / h)
    return int(size * h / w), size


def crop_window(out_size: int, crop: int) -> int:
    """torchvision ``CenterCrop`` top/left offset: round((full - crop) / 2)."""
    return int(round((out_size - crop) / 2.0))


@functools.lru_cache(maxsize=16)
def _mean_std(mean: tuple, std: tuple, device: torch.device):
    # made once per device: a fresh host→device copy on every call would
    # wait for the work already queued on the card
    return (torch.tensor(mean, dtype=torch.float32, device=device),
            torch.tensor(std, dtype=torch.float32, device=device))


def normalize_only(images: torch.Tensor,
                   cfg: PreprocessConfig = PreprocessConfig()) -> torch.Tensor:
    """uint8/float [B, S, S, 3] already at model size → normalised fp32."""
    x = images.float() / 255.0
    mean, std = _mean_std(tuple(cfg.mean), tuple(cfg.std), x.device)
    return (x - mean) / std
