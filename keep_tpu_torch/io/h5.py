"""WSI feature IO: CLAM-style h5 files of precomputed patch features and
coords (counterpart of ``keep_tpu/io/h5.py``).

Reference contract (WSI_evaluation/utils.py:11-61, zeroshot_detection_WSI.py:
29-31): ``h5_files/{slide_id}.h5`` with datasets ``features [N, D]`` and
``coords [N, 2]`` (x, y at level 0); labels from a dataframe column through
a label_map. Host-side numpy; one item is one slide. ``h5py`` is imported
where a file is read, so the package imports without it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Mapping, Optional

import numpy as np


def read_h5_slide(path: str) -> tuple[np.ndarray, np.ndarray]:
    import h5py

    with h5py.File(path, "r") as f:
        features = f["features"][:]
        coords = f["coords"][:]
    return np.asarray(features), np.asarray(coords)


@dataclasses.dataclass
class WSIDataset:
    """Iterates (slide_id, features, coords, label) over a cohort dataframe,
    by position."""

    df: "object"  # pandas DataFrame
    data_source: str
    label_map: Optional[Mapping] = None
    index_col: str = "slide_id"
    target_col: str = "Diagnosis"
    use_h5: bool = True

    def __len__(self) -> int:
        return len(self.df)

    def slide_id(self, idx: int) -> str:
        return str(self.df.iloc[idx][self.index_col])

    def label(self, idx: int):
        lbl = self.df.iloc[idx][self.target_col]
        if self.label_map is not None:
            lbl = self.label_map[lbl]
        return lbl

    def __getitem__(self, idx: int) -> dict:
        slide_id = self.slide_id(idx)
        if self.use_h5:
            path = os.path.join(self.data_source, "h5_files", slide_id + ".h5")
            features, coords = read_h5_slide(path)
        else:
            import torch

            path = os.path.join(self.data_source, "pt_files", slide_id + ".pt")
            features = torch.load(path, map_location="cpu").numpy()
            coords = np.zeros((len(features), 2), np.int64)
        return {
            "slide_id": slide_id,
            "features": features,
            "coords": coords,
            "label": self.label(idx),
        }

    def __iter__(self) -> Iterator[dict]:
        for i in range(len(self)):
            yield self[i]
