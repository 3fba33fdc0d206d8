"""The WSI sweep's long axis over a device mesh: prompt screening and the
refined patch-grid probabilities (counterpart of
``keep_tpu/wsi/sharded.py``).

Screening 1,782 classifiers over a 100K-tile slide materialises [P, N, C]
logits (≈ 1.4 GB fp32; the reference loops over the classifiers,
WSI_evaluation/utils.py:119-146). Here the tiles split over the mesh's
devices (``parallel.make_mesh``), one contiguous chunk each, the tile
count padded to a multiple of the mesh; each device scores its chunk,
launched on every device before any result is read. The per-tile results
come together on the first device, where the screening mean runs over the
real tiles only (the padding is cut off, never averaged in), the top-n
picks the single-device ``prompt_select``'s order, and the 2×2 grid refine
runs (``wsi.grid``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from keep_tpu_torch.parallel import batch_sharding, make_mesh
from keep_tpu_torch.wsi.grid import CoordGrid, refine_grid
from keep_tpu_torch.zeroshot.classifier import (select_top,
                                                tile_screening_values)


def _mesh_or_default(mesh: Optional[Sequence]) -> tuple:
    return tuple(mesh) if mesh is not None else make_mesh()


def over_mesh(mesh: Sequence[torch.device], features,
              fn: Callable[[torch.Tensor], torch.Tensor],
              axis: int = 0) -> torch.Tensor:
    """``fn`` of each device's chunk of the [N, ...] ``features`` (the tile
    count padded with zero rows to a multiple of the mesh), the results
    joined along ``axis`` on the first device and cut back to N."""
    feats = torch.as_tensor(np.asarray(features) if isinstance(
        features, np.ndarray) else features)
    n = feats.shape[0]
    rem = (-n) % len(mesh)
    if rem:
        feats = torch.cat([feats, feats.new_zeros((rem,) + feats.shape[1:])])
    outs = []
    for rows, device in zip(batch_sharding(mesh, feats.shape[0]), mesh):
        with (torch.cuda.device(device) if device.type == "cuda"
              else contextlib.nullcontext()):
            outs.append(fn(feats[rows].to(device, non_blocking=True)))
    joined = torch.cat([o.to(mesh[0]) for o in outs], dim=axis)
    return joined.narrow(axis, 0, n)


def prompt_select_sharded(classifiers, features, mesh=None,
                          topn: int = 50) -> torch.Tensor:
    """``zeroshot.classifier.prompt_select`` with the tile axis over
    ``mesh``'s devices (default: every card) → the merged [D, C] ensemble
    on the first device. The screening mean is over the real tiles at any
    N; ``topn`` clamps to the pool size, as the single-device path does."""
    classifiers = torch.as_tensor(classifiers)
    topn = min(topn, int(classifiers.shape[0]))
    mesh = _mesh_or_default(mesh)
    vals = over_mesh(mesh, features,
                     lambda f: tile_screening_values(classifiers, f), axis=1)
    return select_top(classifiers, vals.mean(dim=-1), topn)[0]


def refined_probs_sharded(classifier, features, coords: np.ndarray,
                          patch_size: int, mesh=None, overlap: bool = True,
                          scale: float = 10.0) -> np.ndarray:
    """The sweep with the tiles over ``mesh``'s devices: score each chunk
    → scatter into the dense grid → 2×2 refine → gather, the grid on the
    first device. Returns [M, C] refined probabilities in first-seen patch
    order (``pipelines.refined_tumor_probs``'s, all classes)."""
    from keep_tpu_torch.wsi.pipelines import score_tiles

    mesh = _mesh_or_default(mesh)
    grid = CoordGrid.from_coords(coords, patch_size)
    probs = over_mesh(mesh, features,
                      lambda f: score_tiles(classifier, f, scale))
    if overlap:
        g, occ = grid.scatter(probs)
        out = grid.gather(refine_grid(g, occ))
    else:
        out = probs[torch.from_numpy(grid.keep).to(probs.device)]
    return out.cpu().numpy()

