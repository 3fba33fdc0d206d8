"""Zero-shot WSI pipelines: detection, segmentation, subtyping (counterpart
of ``keep_tpu/wsi/pipelines.py``).

The decision rules are the reference's (WSI_evaluation/detection_utils.py:
88-100, segment_utils.py:44-152, subtyping_utils.py:67-83):
softmax(logits·10), strict > threshold, first-seen dedupe, 2×2 neighbour
refine, the Normal class excluded from subtyping. The patch axis runs as
tensor ops on the features' device over a dense coordinate grid. The fp32
products are taken at full fp32 precision whatever the caller's TF32
setting (``ops.nn.ieee_fp32``), so a patch lands on the same side of a
threshold either way.

Pass the features as a tensor on the device to run on; numpy features run
on the CPU. The classifier follows the features. ``score_tiles_sharded``
runs the patch axis over a device mesh (``wsi.sharded``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from keep_tpu_torch.metrics.classification import (dice_from_counts,
                                                   roc_best_threshold)
from keep_tpu_torch.ops.nn import ieee_fp32, l2_normalize
from keep_tpu_torch.wsi.grid import CoordGrid, heatmap_image, refine_grid

def score_tiles(classifier, features, scale: float = 10.0) -> torch.Tensor:
    """[N, D] tile features × [D, C] classifier → [N, C] softmax(sim·scale)
    (detection_utils.py:90-93), on the features' device."""
    feats = l2_normalize(torch.as_tensor(features).float())
    cls = torch.as_tensor(classifier).to(feats.device, torch.float32)
    with ieee_fp32():
        logits = feats @ cls
    return torch.softmax(logits * scale, dim=-1)


def score_tiles_sharded(classifier, features, mesh=None,
                        scale: float = 10.0) -> torch.Tensor:
    """``score_tiles`` with the patch axis over ``mesh``'s devices (default:
    every card): the tiles padded to a multiple of the mesh, each device's
    chunk scored, the [N, C] result on the first device."""
    from keep_tpu_torch.wsi.sharded import _mesh_or_default, over_mesh

    return over_mesh(_mesh_or_default(mesh), features,
                     lambda f: score_tiles(classifier, f, scale))


def zero_shot_detection(
    classifier,
    tile_features,
    tile_coords: np.ndarray,
    patch_size: int = 256,
    overlap: bool = False,
    threshold: float = 0.5,
) -> float:
    """WSI tumor probability = fraction of (deduped) patches whose class-1
    prob exceeds ``threshold`` (detection_utils.py:88-100)."""
    grid = CoordGrid.from_coords(tile_coords, patch_size)
    probs_kept = _refined_probs(classifier, tile_features, grid, overlap)
    preds = (probs_kept[:, 1] > threshold).float()
    # the mean as the sum times the fp32 reciprocal of the count, as
    # jnp.mean computes it, so that the fraction has the JAX package's bits
    inv_n = torch.tensor(1.0 / preds.shape[0], dtype=torch.float32,
                         device=preds.device)
    return float(preds.sum() * inv_n)


def _refined_probs(classifier, tile_features, grid: CoordGrid,
                   overlap: bool) -> torch.Tensor:
    """[M, C] (optionally neighbour-refined) probabilities in first-seen
    patch order: the one scatter → refine → gather rule every pipeline
    shares."""
    probs = score_tiles(classifier, tile_features)
    if overlap:
        g, occ = grid.scatter(probs)
        return grid.gather(refine_grid(g, occ))
    return probs[torch.from_numpy(grid.keep).to(probs.device)]


def refined_tumor_probs(classifier, tile_features, grid: CoordGrid,
                        overlap: bool = True) -> torch.Tensor:
    """[M] refined class-1 probabilities in first-seen patch order."""
    return _refined_probs(classifier, tile_features, grid, overlap)[:, 1]


def _scored_grid(classifier, tile_features, tile_coords, patch_size,
                 overlap):
    grid = CoordGrid.from_coords(tile_coords, patch_size)
    g, occ = grid.scatter(score_tiles(classifier, tile_features))
    if overlap:
        g = refine_grid(g, occ)
    return g, occ


def tumor_heatmap(
    classifier,
    tile_features,
    tile_coords: np.ndarray,
    patch_size: int = 224,
    *,
    overlap: bool = True,
    downsample: int = 16,
) -> np.ndarray:
    """uint8 tumor-probability heatmap over the slide's patch bounding box:
    per-patch class-1 probabilities (2×2-refined with ``overlap``) painted
    at ``patch_size/downsample`` pixels per patch, prob·255, unscored cells
    0 (the counterpart of the Dice painting, segment_utils.py:122-152).
    Save with ``PIL.Image.fromarray``."""
    g, occ = _scored_grid(classifier, tile_features, tile_coords, patch_size,
                          overlap)
    return heatmap_image(g[..., 1].cpu().numpy(), occ.cpu().numpy(),
                         patch_size, downsample)


def subtype_class_map(
    classifier,
    tile_features,
    tile_coords: np.ndarray,
    patch_size: int = 256,
    *,
    overlap: bool = True,
    downsample: int = 16,
) -> np.ndarray:
    """uint8 class-index map: per occupied cell, argmax class + 1 (0 =
    unscored) at ``patch_size/downsample`` pixels per patch, the picture of
    the subtyping refine (subtyping_utils.py:38-65)."""
    g, occ = _scored_grid(classifier, tile_features, tile_coords, patch_size,
                          overlap)
    cls = (torch.argmax(g, dim=-1).cpu().numpy().astype(np.uint8) + 1) * (
        occ.cpu().numpy() > 0)
    cell = max(1, int(round(patch_size / downsample)))
    return np.kron(cls, np.ones((cell, cell), np.uint8))


def patch_labels_from_mask(mask: np.ndarray, coords: np.ndarray,
                           patch_size: int) -> np.ndarray:
    """Per-patch ground truth: 1 iff more than half of the level-0 mask
    pixels under the patch are nonzero (segment_utils.py:97-103), counted
    with an integral image."""
    nz = (np.asarray(mask) != 0).astype(np.int64)
    ii = np.zeros((nz.shape[0] + 1, nz.shape[1] + 1), np.int64)
    ii[1:, 1:] = nz.cumsum(0).cumsum(1)
    h, w = nz.shape
    out = np.zeros(len(coords), np.int64)
    for i, (x, y) in enumerate(np.asarray(coords, np.int64)):
        y0, x0 = min(max(y, 0), h), min(max(x, 0), w)
        y1, x1 = min(y + patch_size, h), min(x + patch_size, w)
        if y1 <= y0 or x1 <= x0:
            continue
        count = ii[y1, x1] - ii[y0, x1] - ii[y1, x0] + ii[y0, x0]
        out[i] = int(count > patch_size * patch_size / 2)
    return out


def dice_at_lowres(
    probs: np.ndarray,
    coords: np.ndarray,
    mask_lowres: np.ndarray,
    mag_num: int,
    patch_size: int,
    threshold: float,
) -> float:
    """Paint the predicted patches into a ~16×-downsampled mask and take
    Dice with the reference's nonzero·256 pixel counting
    (segment_utils.py:122-152)."""
    mask_img = np.asarray(mask_lowres)
    pred_mask = np.zeros_like(mask_img)
    ps = patch_size
    for (x, y), p in zip(np.asarray(coords, np.int64), np.asarray(probs)):
        if p > threshold:
            r0, c0 = int(y / mag_num), int(x / mag_num)
            pred_mask[r0: int(y / mag_num + ps / mag_num),
                      c0: int(x / mag_num + ps / mag_num)] = 255
    mask_sum = np.count_nonzero(mask_img) * 256
    pred_sum = np.count_nonzero(pred_mask) * 256
    intersection = np.count_nonzero(mask_img * pred_mask) * 256
    return dice_from_counts(intersection, mask_sum, pred_sum)


def zero_shot_segment(
    classifier,
    tile_features,
    tile_coords: np.ndarray,
    mask: Optional[np.ndarray] = None,
    mask_path: Optional[str] = None,
    patch_size: int = 224,
    overlap: bool = True,
) -> tuple[float, float]:
    """(AUROC, Dice) for one slide (segment_utils.py:44-60).

    Ground truth from an in-memory level-0 ``mask`` array, or from
    ``mask_path``: through OpenSlide when it can be imported, else through
    ``io.wsi.WSIReader``.
    """
    grid = CoordGrid.from_coords(tile_coords, patch_size)
    probs = refined_tumor_probs(classifier, tile_features, grid,
                                overlap).cpu().numpy()
    kept = grid.kept_coords(tile_coords)

    if mask is not None:
        gt = patch_labels_from_mask(mask, kept, patch_size)
        # the ~16× level the reference takes Dice at
        mag = 16
        lowres = np.asarray(mask)[::mag, ::mag]
    elif mask_path is not None:
        gt, lowres, mag = _mask_path_gt(mask_path, kept, patch_size)
    else:
        raise ValueError("provide mask or mask_path")

    auc, best_thd = roc_best_threshold(gt, probs)
    dice = dice_at_lowres(probs, kept, lowres, mag, patch_size, best_thd)
    return auc, dice


def _mask_path_gt(mask_path: str, coords: np.ndarray, patch_size: int):
    """Slide-file ground truth: OpenSlide when importable (the reference's
    reader, segment_utils.py:91-127), else ``io.wsi.WSIReader``; the same
    decision rules either way."""
    try:
        return _openslide_gt(mask_path, coords, patch_size)
    except ImportError:
        return _tiffwsi_gt(mask_path, coords, patch_size)


def _to_gray(rgb: np.ndarray) -> np.ndarray:
    """PIL ``convert("L")``'s fixed-point ITU-R 601 luma, rounded, so that
    edge pixels binarise as on the OpenSlide route."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(
        np.uint8)


def _tiffwsi_gt(mask_path: str, coords: np.ndarray, patch_size: int):
    from keep_tpu_torch.io.wsi import WSIReader

    with WSIReader(mask_path) as slide:
        gt = np.zeros(len(coords), np.int64)
        for i, (x, y) in enumerate(np.asarray(coords, np.int64)):
            region = _to_gray(slide.read_region(
                (int(x), int(y)), 0, (patch_size, patch_size)))
            gt[i] = int(np.count_nonzero(region) > patch_size * patch_size / 2)
        idx = slide.best_level_for_downsample(16)
        lowres = _to_gray(
            slide.read_region((0, 0), idx, slide.level_dimensions[idx]))
        # truncated as the OpenSlide route's int(level_downsamples[idx])
        return gt, lowres, int(slide.level_downsamples[idx])


def _openslide_gt(mask_path: str, coords: np.ndarray, patch_size: int):
    """Slide-file ground truth through OpenSlide (segment_utils.py:91-127);
    raises ImportError without it."""
    try:
        import openslide
    except ImportError as e:
        raise ImportError(
            "OpenSlide is required for mask_path-based segmentation GT; "
            "pass an in-memory `mask` array instead") from e
    slide = openslide.open_slide(mask_path)
    gt = np.zeros(len(coords), np.int64)
    for i, (x, y) in enumerate(np.asarray(coords, np.int64)):
        region = np.array(slide.read_region(
            (int(x), int(y)), 0, (patch_size, patch_size)).convert("L"))
        gt[i] = int(np.count_nonzero(region) > patch_size * patch_size / 2)
    idx = min(range(len(slide.level_downsamples)),
              key=lambda i: abs(slide.level_downsamples[i] - 16))
    lowres = np.array(slide.read_region(
        (0, 0), idx, slide.level_dimensions[idx]).convert("L"))
    return gt, lowres, int(slide.level_downsamples[idx])


def zero_shot_subtyping(
    classifier,
    tile_features,
    tile_coords: np.ndarray,
    patch_size: int = 256,
    overlap: bool = True,
    exclude_last_class: bool = True,
) -> tuple[int, np.ndarray]:
    """(predicted label, per-class patch fractions). Per-patch argmax of the
    refined softmax(logits·10); the slide's label is the argmax of the class
    fractions without the appended Normal class (subtyping_utils.py:67-83)."""
    grid = CoordGrid.from_coords(tile_coords, patch_size)
    kept = _refined_probs(classifier, tile_features, grid, overlap)
    pred_labels = torch.argmax(kept, dim=-1)
    n_classes = int(classifier.shape[1])
    fractions = (torch.bincount(pred_labels, minlength=n_classes).float()
                 / pred_labels.shape[0]).cpu().numpy()
    usable = fractions[:-1] if exclude_last_class else fractions
    return int(np.argmax(usable)), fractions


def probability_heatmap(
    classifier,
    tile_features,
    tile_coords: np.ndarray,
    patch_size: int = 224,
    overlap: bool = True,
    class_index: int = 1,
) -> tuple[np.ndarray, np.ndarray]:
    """(heatmap [rows, cols], occupancy [rows, cols]) of the refined per-patch
    class probabilities, the dense float picture of the reference's painted
    prediction mask (segment_utils.py:134-140)."""
    g, occ = _scored_grid(classifier, tile_features, tile_coords, patch_size,
                          overlap)
    occ = occ.cpu().numpy()
    return g[..., class_index].cpu().numpy() * occ, occ
