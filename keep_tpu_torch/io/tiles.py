"""Tile extraction from whole-slide images: level-0 image → (tiles, coords)
(counterpart of ``keep_tpu/io/tiles.py``).

The reference consumes CLAM-precomputed h5 features and never cuts tiles
itself; with ``wsi.extract`` this closes the loop: a flat slide image →
tissue tiles → features → zero-shot pipelines. Tissue filtering uses the
saturation / brightness heuristic (background on H&E slides is bright and
unsaturated). ``iter_wsi_tiles`` streams the tissue tiles of a pyramidal
slide chunk by chunk through ``io.wsi`` (no OpenSlide needed).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

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


def iter_wsi_tiles(
    slide,
    patch_size: int = 256,
    tissue_fraction: float = 0.25,
    chunk: int = 256,
    level: int = 0,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Stream (tiles, coords) chunks from a pyramidal slide — no OpenSlide
    needed (``io.wsi.open_slide``: native libtiff, else OpenSlide, else
    PIL).

    ``slide``: path or an open reader. Tiles are cut on a ``patch_size``
    grid at ``level``; coords are (x, y) top-left in that level's
    coordinates (level 0 ⇒ the CLAM convention the h5 pipelines use).
    Tissue filtering runs on a ≤2048px thumbnail with the same
    saturation/brightness heuristic as :func:`cut_tiles`."""
    from keep_tpu_torch.io.wsi import open_slide

    opened = isinstance(slide, (str, bytes, os.PathLike))
    reader = open_slide(slide) if opened else slide
    try:
        yield from _iter_reader_tiles(reader, patch_size, tissue_fraction,
                                      chunk, level)
    finally:
        if opened:
            reader.close()


def tissue_coords(reader, patch_size: int, tissue_fraction: float,
                  level: int = 0) -> np.ndarray:
    """[N, 2] int64 (x, y) top-left corners, in ``level``'s coordinates, of
    the ``patch_size`` grid cells whose share of tissue on a ≤2048px
    thumbnail's mask (:func:`tissue_mask`) is at least ``tissue_fraction``
    (no tile decodes)."""
    w, h = reader.level_dimensions[level]
    scale = max(1, -(-max(w, h) // 2048))  # ceil: keep the overview ≤2048px
    overview = np.asarray(reader.get_thumbnail((w // scale, h // scale)))
    mask = tissue_mask(overview)
    # actual thumbnail scale (get_thumbnail preserves aspect, may differ
    # from the requested box by a pixel)
    sy = h / max(1, overview.shape[0])
    sx = w / max(1, overview.shape[1])
    coords = []
    for y in range(0, h - patch_size + 1, patch_size):
        for x in range(0, w - patch_size + 1, patch_size):
            my0, mx0 = int(y / sy), int(x / sx)
            my1 = max(my0 + 1, int((y + patch_size) / sy))
            mx1 = max(mx0 + 1, int((x + patch_size) / sx))
            if mask[my0:my1, mx0:mx1].mean() >= tissue_fraction:
                coords.append((x, y))
    return np.asarray(coords, np.int64).reshape(-1, 2)


def _iter_reader_tiles(reader, patch_size, tissue_fraction, chunk, level):
    ds = reader.level_downsamples[level]
    # pass 1: tissue-candidate coords from the thumbnail mask (host-cheap)
    coords = tissue_coords(reader, patch_size, tissue_fraction, level)

    # pass 2: decode chunk-by-chunk — batched threaded native reads when
    # the reader supports them (per-thread TIFF handles, GIL released),
    # else one read_region per tile
    batched = getattr(reader, "read_regions", None)
    for i in range(0, len(coords), chunk):
        cs = coords[i : i + chunk]
        locs = np.rint(cs * ds).astype(np.int64)
        if batched is not None:
            tiles = batched(locs, level, (patch_size, patch_size))
        else:  # e.g. an openslide.OpenSlide passed directly
            tiles = np.stack([
                np.asarray(reader.read_region(
                    (int(lx), int(ly)), level, (patch_size, patch_size)
                ))[..., :3]
                for lx, ly in locs
            ])
        yield tiles, cs
