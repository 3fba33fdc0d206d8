"""Slide IO (counterpart of ``keep_tpu/io``): CLAM-style h5 features and
tile cutting from a flat slide image. The native pyramid reader
(``io/wsi.py``, ``io/fast_decode.py``) is not ported yet."""

from keep_tpu_torch.io.h5 import WSIDataset, read_h5_slide  # noqa: F401
from keep_tpu_torch.io.tiles import cut_tiles, tissue_mask  # noqa: F401
