"""Tile extraction from whole-slide images: level-0 image → (tiles, coords)
(counterpart of ``keep_tpu/io/tiles.py``).

The reference consumes CLAM-precomputed h5 features and never cuts tiles
itself; with ``wsi.extract`` this closes the loop: a flat slide image →
tissue tiles → features → zero-shot pipelines. Tissue filtering uses the
saturation / brightness heuristic (background on H&E slides is bright and
unsaturated). Streaming tiles from a pyramidal slide (``iter_wsi_tiles``)
needs the JAX package's native reader, which is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def tissue_mask(
    image: np.ndarray, sat_threshold: int = 15, bright_threshold: int = 240
) -> np.ndarray:
    """[H, W, 3] uint8 RGB → bool tissue mask. A pixel is tissue when it is
    not near-white and has some color saturation."""
    img = np.asarray(image, np.int16)
    mx = img.max(axis=-1)
    mn = img.min(axis=-1)
    saturation = mx - mn
    return (saturation > sat_threshold) & (mx < bright_threshold)


def cut_tiles(
    image: np.ndarray,
    patch_size: int = 256,
    tissue_fraction: float = 0.25,
    stride: Optional[int] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Level-0 RGB image → (tiles [N, P, P, 3] uint8, coords [N, 2] (x, y)).

    Keeps grid-aligned tiles whose tissue fraction exceeds the threshold;
    coords follow the CLAM convention (x, y) at level 0 — ready for
    ``wsi.extract.extract_to_h5`` and the grid pipelines.
    """
    image = np.asarray(image)
    h, w = image.shape[:2]
    stride = stride or patch_size
    mask = tissue_mask(image)
    # integral image for O(1) per-tile tissue counting
    ii = np.zeros((h + 1, w + 1), np.int64)
    ii[1:, 1:] = mask.cumsum(0).cumsum(1)

    tiles, coords = [], []
    min_pixels = tissue_fraction * patch_size * patch_size
    for y in range(0, h - patch_size + 1, stride):
        for x in range(0, w - patch_size + 1, stride):
            count = (
                ii[y + patch_size, x + patch_size]
                - ii[y, x + patch_size]
                - ii[y + patch_size, x]
                + ii[y, x]
            )
            if count >= min_pixels:
                tiles.append(image[y : y + patch_size, x : x + patch_size])
                coords.append((x, y))
    if not tiles:
        return (
            np.zeros((0, patch_size, patch_size, 3), image.dtype),
            np.zeros((0, 2), np.int64),
        )
    return np.stack(tiles), np.asarray(coords, np.int64)
