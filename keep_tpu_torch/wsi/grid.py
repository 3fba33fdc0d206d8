"""Dense coordinate grid of a WSI patch sweep (counterpart of
``keep_tpu/wsi/grid.py``).

The reference's label refinement walks a Python dict keyed by ``"x_y"``
strings and averages each patch's logits with up to 3 neighbours at
``coord − patch_size`` offsets (WSI_evaluation/detection_utils.py:39-74,
segment_utils.py:63-89, subtyping_utils.py:38-65). Here the patch values
are scattered into a dense ``[rows, cols, C]`` grid with an occupancy mask
on their device, and the neighbour average is a 2×2 stencil: four shifted
adds.

Neighbour set of cell (r, c): {(r, c), (r−1, c), (r, c−1), (r−1, c−1)}, the
occupied ones among them: self, top, left and top-left at −patch_size, the
reference's lt/rt/lb/rb lookup with coords = (x, y).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class CoordGrid:
    """Maps N patch coords to dense (row, col) grid cells.

    Built on the host once per slide (integer math); the values then live on
    their device. Duplicate coordinates keep the FIRST occurrence (the
    reference's dict-insert semantics, detection_utils.py:45).
    """

    rows: int
    cols: int
    origin: tuple[int, int]  # (x_min, y_min)
    patch_size: int
    cell_index: np.ndarray  # [M] flat r*cols+c per kept patch
    keep: np.ndarray  # [M] indices into the original N patches (first-seen)

    @classmethod
    def from_coords(cls, coords: np.ndarray, patch_size: int) -> "CoordGrid":
        coords = np.asarray(coords)
        if coords.ndim != 2 or coords.shape[1] != 2:
            raise ValueError(f"coords must be [N, 2] (x, y); got {coords.shape}")
        if len(coords) == 0:
            # a blank slide (cut_tiles yields zero tissue tiles) fails with
            # a message, not an IndexError
            raise ValueError("no patches: empty coords (blank slide?)")
        xy = coords.astype(np.int64)
        rem = xy % patch_size
        if not (rem == rem[0]).all():
            raise ValueError(
                "coords are not on a uniform patch_size grid; exact-offset "
                "neighbor matching (reference semantics) requires alignment"
            )
        x_min, y_min = xy[:, 0].min(), xy[:, 1].min()
        c = (xy[:, 0] - x_min) // patch_size
        r = (xy[:, 1] - y_min) // patch_size
        cols = int(c.max()) + 1
        rows = int(r.max()) + 1
        flat = (r * cols + c).astype(np.int64)
        # first occurrence wins
        _, first_idx = np.unique(flat, return_index=True)
        keep = np.sort(first_idx)
        return cls(rows=rows, cols=cols, origin=(int(x_min), int(y_min)),
                   patch_size=patch_size, cell_index=flat[keep], keep=keep)

    @property
    def num_patches(self) -> int:
        return len(self.cell_index)

    def _index(self, device) -> torch.Tensor:
        return torch.from_numpy(self.cell_index).to(device)

    def scatter(self, values: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """[N, C] per-patch values → ([rows, cols, C] grid, [rows, cols]
        occupancy), on the values' device.

        ``values`` is indexed by the ORIGINAL patch order; duplicates beyond
        the first are dropped (so no cell is written twice).
        """
        values = torch.as_tensor(values)
        vals = values[torch.from_numpy(self.keep).to(values.device)]
        c = vals.shape[-1]
        idx = self._index(values.device)
        grid = vals.new_zeros((self.rows * self.cols, c)).index_copy_(
            0, idx, vals)
        occ = torch.zeros(self.rows * self.cols, dtype=torch.float32,
                          device=values.device)
        occ[idx] = 1.0
        return (grid.reshape(self.rows, self.cols, c),
                occ.reshape(self.rows, self.cols))

    def gather(self, grid: torch.Tensor) -> torch.Tensor:
        """[rows, cols, C] grid → [M, C] per-kept-patch values (first-seen
        order)."""
        flat = grid.reshape(self.rows * self.cols, -1)
        return flat[self._index(grid.device)]

    def kept_coords(self, coords: np.ndarray) -> np.ndarray:
        return np.asarray(coords)[self.keep]


def heatmap_image(grid_vals: np.ndarray, occ: np.ndarray, patch_size: int,
                  downsample: int = 16) -> np.ndarray:
    """Paint a [rows, cols] per-cell probability grid into a uint8 image at
    ``patch_size/downsample`` pixels per cell, the ~16×-downsampled level
    the reference paints its prediction masks at (segment_utils.py:122-152).
    Unoccupied cells render as 0."""
    cell = max(1, int(round(patch_size / downsample)))
    vals = np.clip(np.asarray(grid_vals, np.float32), 0.0, 1.0)
    img = np.round(vals * 255.0).astype(np.uint8) * (np.asarray(occ) > 0)
    return np.kron(img, np.ones((cell, cell), np.uint8))


def refine_grid(grid: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    """2×2 causal stencil: per occupied cell, the mean of the values over the
    occupied subset of {self, top, left, top-left} (the reference's
    refine_seg with overlap=True)."""
    g = grid.float() * occ[..., None]
    gp = F.pad(g, (0, 0, 1, 0, 1, 0))
    op = F.pad(occ, (1, 0, 1, 0))
    vsum = gp[1:, 1:] + gp[:-1, 1:] + gp[1:, :-1] + gp[:-1, :-1]
    count = op[1:, 1:] + op[:-1, 1:] + op[1:, :-1] + op[:-1, :-1]
    return vsum / count.clamp_min(1.0)[..., None]
