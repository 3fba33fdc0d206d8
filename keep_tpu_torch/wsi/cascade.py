"""Coarse-to-fine cascade WSI sweep (counterpart of
``keep_tpu/wsi/cascade.py``).

The plain sweep encodes every level-0 tissue tile. Most of a slide is
confidently normal or confidently tumour; only regions near the decision
boundary need full resolution. The cascade scores the slide at a coarse
pyramid level first (a d× downsample: d² fewer tiles), then refines only
the coarse tiles whose tumour probability falls within a margin of the
threshold (the WISE-FUSE-style coarse-to-fine selection, arXiv:2508.14537),
through the same fixed-shape batched encoder as the plain sweep
(``wsi.extract.extract_features`` on the model's device).

Semantics: the candidates are exactly the plain sweep's level-0 tissue
grid; confident regions inherit their parent's coarse probability, refined
ones get their own. With ``margin >= 0.5`` every parent refines and the
result equals the plain sweep. It is opt-in: the default pipelines keep the
reference's semantics.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CascadeResult:
    """Outcome of :func:`cascade_detect`. ``probs`` / ``coords`` cover the
    whole level-0 candidate grid (refined tiles carry their own
    probability, the others their parent's), so the usual decision rules
    run on them unchanged."""

    tumor_prob: float            # fraction of candidate tiles called tumour
    probs: np.ndarray            # [N, C] per level-0 candidate tile
    coords: np.ndarray           # [N, 2] level-0 (x, y)
    refined: np.ndarray          # [N] bool: the probability is level 0's
    n_coarse: int                # coarse tiles encoded
    n_fine_encoded: int          # level-0 tiles encoded
    n_fine_total: int            # level-0 tiles a full sweep would encode
    coarse_level: int
    downsample: int

    @property
    def encode_fraction(self) -> float:
        """Tiles encoded by both passes over the full sweep's; below 1 is
        the cascade's gain. A coarse tile costs one fine tile's encode (the
        same pixel count)."""
        if self.n_fine_total == 0:
            return 1.0
        return (self.n_coarse + self.n_fine_encoded) / self.n_fine_total


def _encode_probs(model, reader, locs, level, patch_size, classifier,
                  batch_size, scale, resize):
    """Read the regions (threaded on the native reader) → encode on the
    model's device → softmax(·scale) probabilities, chunk by chunk so that
    the read of one chunk overlaps the card's work on the last."""
    import torch

    from keep_tpu_torch.wsi.extract import extract_features
    from keep_tpu_torch.wsi.pipelines import score_tiles

    def chunks():
        for i in range(0, len(locs), batch_size):
            yield reader.read_regions(locs[i:i + batch_size], level,
                                      (patch_size, patch_size))

    feats = extract_features(model, chunks(), batch_size=batch_size,
                             resize=resize)
    device = next(model.parameters()).device
    return score_tiles(torch.as_tensor(classifier),
                       torch.from_numpy(feats).to(device),
                       scale=scale).cpu().numpy()


def cascade_detect(
    model,
    slide,
    classifier,
    *,
    patch_size: int = 224,
    coarse_downsample: int = 4,
    margin: float = 0.15,
    threshold: float = 0.5,
    tumor_class: int = 1,
    tissue_fraction: float = 0.25,
    batch_size: int = 256,
    scale: float = 10.0,
    resize: bool = False,
) -> CascadeResult:
    """Two-pass zero-shot detection over a pyramidal slide.

    ``classifier``: [D, C] (the prompt-ensemble matrix). Parents whose
    coarse tumour probability ``p`` has ``|p - threshold| <= margin``
    refine to their level-0 tiles; the others stamp ``p`` on every
    candidate tile they hold. ``margin >= 0.5`` refines everything (the
    plain sweep); ``margin = 0`` trusts the coarse pass.

    The decision rule is ``wsi.pipelines.zero_shot_detection``'s
    (softmax·10, no overlap stencil, a threshold on ``tumor_class``); the
    candidate grid has unique coords, so the first-seen rule drops nothing.
    ``resize=True`` takes the tiles through the bicubic resize to the
    model's input size (needed when ``patch_size`` differs from it, as the
    CLI's 256-pixel tiles on the 224-pixel tower)."""
    from keep_tpu_torch.io.tiles import tissue_coords
    from keep_tpu_torch.io.wsi import open_slide

    if not 0.0 <= margin:
        raise ValueError(f"margin must be >= 0, got {margin}")
    opened = isinstance(slide, (str, bytes)) or hasattr(slide, "__fspath__")
    reader = open_slide(slide) if opened else slide
    try:
        level = reader.best_level_for_downsample(coarse_downsample)
        d = int(round(reader.level_downsamples[level]))
        if level == 0 or d < 2:
            raise ValueError(
                f"slide has no coarse level near downsample "
                f"{coarse_downsample} (levels: {reader.level_downsamples}) "
                f"— use the plain sweep")

        # the full sweep's level-0 tissue-candidate grid
        fine = tissue_coords(reader, patch_size, tissue_fraction)
        n_fine_total = len(fine)
        c = classifier.shape[1]
        if n_fine_total == 0:
            return CascadeResult(0.0, np.zeros((0, c), np.float32),
                                 fine, np.zeros(0, bool), 0, 0, 0, level, d)

        # each candidate's parent on the (d·ps)-aligned coarse grid
        span = d * patch_size
        parent = fine // span                         # [N, 2] (px, py)
        uniq, inverse = np.unique(parent, axis=0, return_inverse=True)
        coarse_locs = uniq * span                     # level-0 coords
        coarse_probs = _encode_probs(model, reader, coarse_locs, level,
                                     patch_size, classifier, batch_size,
                                     scale, resize)

        p_tumor = coarse_probs[:, tumor_class]
        refine_parent = np.abs(p_tumor - threshold) <= margin
        refined = refine_parent[inverse]              # [N] per candidate

        probs = coarse_probs[inverse].copy()          # the parent's call
        n_fine_encoded = int(refined.sum())
        if n_fine_encoded:
            probs[refined] = _encode_probs(model, reader, fine[refined], 0,
                                           patch_size, classifier,
                                           batch_size, scale, resize)

        tumor_prob = float((probs[:, tumor_class] > threshold).mean())
        return CascadeResult(tumor_prob, probs, fine, refined,
                             len(uniq), n_fine_encoded, n_fine_total,
                             level, d)
    finally:
        if opened:
            reader.close()
