"""Image preprocessing on the device (counterpart of
``keep_tpu/ops/preprocess.py``).

The reference's eval transform (quick_start/keep_inference.py:88-93):
  Resize(shortest_side=224, bicubic, antialias) → CenterCrop(224) →
  ToTensor (scale to [0, 1]) → Normalize(ImageNet mean / std)

``preprocess`` does it on the images' device as two fp32 einsums, a
separable resize with PIL-semantics weights (cubic a = −0.5, support 2,
widened by the downscale ratio: antialiasing) into which the crop is
folded, so rows outside the crop are never computed. It takes PIL's pass
order, width then height, and with ``pil_quantize`` rounds (half to even)
and clips to the 8-bit range after each pass, as PIL's 8-bit resampler
does; the residual against PIL is its int16 fixed-point coefficients, well
under 1.5/255 per pixel. The products are taken at full fp32 precision
whatever the caller's TF32 setting. ``normalize_only`` is the tile path,
where tiles are already at model size.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from keep_tpu_torch.configs import PreprocessConfig
from keep_tpu_torch.ops.nn import ieee_fp32


def _cubic_filter(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """PIL's bicubic kernel (Catmull-Rom family, a=-0.5, support 2)."""
    x = np.abs(x)
    return np.where(
        x < 1.0,
        ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
        np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0),
    )


def resize_weights(in_size: int, out_size: int, support: float = 2.0,
                   a: float = -0.5) -> np.ndarray:
    """[out_size, in_size] row-stochastic resample matrix, PIL semantics."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    w = np.zeros((out_size, in_size), np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        xs = np.arange(xmin, xmax)
        k = _cubic_filter((xs + 0.5 - center) / filterscale, a)
        w[i, xmin:xmax] = k / k.sum()
    return w.astype(np.float32)


def resized_output_size(h: int, w: int, size: int) -> tuple[int, int]:
    """torchvision ``Resize(int)``: shortest side → size, the other side
    scaled and truncated to int."""
    if h <= w:
        return size, int(size * w / h)
    return int(size * h / w), size


def crop_window(out_size: int, crop: int) -> int:
    """torchvision ``CenterCrop`` top/left offset: round((full - crop) / 2)."""
    return int(round((out_size - crop) / 2.0))


@functools.lru_cache(maxsize=64)
def _resize_crop_matrices(h: int, w: int, size: int, crop: int):
    """The (height, width) resample matrices with the crop folded in, as
    numpy [crop, h] and [crop, w]."""
    oh, ow = resized_output_size(h, w, size)
    if oh < crop or ow < crop:
        raise ValueError(f"resized {(oh, ow)} smaller than crop {crop}")
    top, left = crop_window(oh, crop), crop_window(ow, crop)
    wh = resize_weights(h, oh)[top: top + crop]
    ww = resize_weights(w, ow)[left: left + crop]
    return wh, ww


@functools.lru_cache(maxsize=64)
def _device_matrices(h: int, w: int, size: int, crop: int,
                     device: torch.device):
    # made once per (h, w, device): a fresh host→device copy on every call
    # would wait for the work already queued on the card
    wh, ww = _resize_crop_matrices(h, w, size, crop)
    return (torch.from_numpy(wh).to(device), torch.from_numpy(ww).to(device))


@functools.lru_cache(maxsize=16)
def _mean_std(mean: tuple, std: tuple, device: torch.device):
    return (torch.tensor(mean, dtype=torch.float32, device=device),
            torch.tensor(std, dtype=torch.float32, device=device))


def _pil_round(x: torch.Tensor) -> torch.Tensor:
    # PIL's 8-bit resampler rounds and clips each pass's result
    # (ImagingResampleHorizontal_8bpc); torch.round is half to even, as
    # jnp.round
    return torch.clamp(torch.round(x), 0.0, 255.0)


def preprocess(images, cfg: PreprocessConfig = PreprocessConfig(),
               crop: int | None = None,
               pil_quantize: bool = True) -> torch.Tensor:
    """uint8 [B, H, W, 3] (or [H, W, 3]) → normalised fp32
    [B, crop, crop, 3], on the images' device (numpy images: the CPU).

    ``pil_quantize=True`` follows PIL / torchvision's 8-bit passes (the
    released model's transform); ``False`` is the pure-float resample."""
    images = torch.as_tensor(images)
    if images.ndim == 3:
        images = images[None]
    _, h, w, _ = images.shape
    crop = crop or cfg.size
    wh, ww = _device_matrices(h, w, cfg.size, crop, images.device)
    x = images.float()
    with ieee_fp32():
        # separable resize + crop in PIL's pass order: width, then height
        x = torch.einsum("ow,bhwc->bhoc", ww, x)
        if pil_quantize:
            x = _pil_round(x)
        x = torch.einsum("oh,bhwc->bowc", wh, x)
    if pil_quantize:
        x = _pil_round(x)
    x = x / 255.0
    mean, std = _mean_std(tuple(cfg.mean), tuple(cfg.std), x.device)
    return (x - mean) / std


def normalize_only(images: torch.Tensor,
                   cfg: PreprocessConfig = PreprocessConfig()) -> torch.Tensor:
    """uint8/float [B, S, S, 3] already at model size → normalised fp32."""
    x = images.float() / 255.0
    mean, std = _mean_std(tuple(cfg.mean), tuple(cfg.std), x.device)
    return (x - mean) / std
