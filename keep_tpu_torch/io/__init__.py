"""Slide IO (counterpart of ``keep_tpu/io``): CLAM-style h5 features, tile
cutting from a flat slide image, the pyramidal TIFF / SVS reader and writer
(``io.wsi``, over the repo's native libtiff module, built at first use) with
the tiles streamed from it (``io.tiles.iter_wsi_tiles``), and the native
JPEG / PNG decoder (``io.fast_decode``)."""

from keep_tpu_torch.io.fast_decode import decode_files, decode_image  # noqa: F401
from keep_tpu_torch.io.h5 import WSIDataset, read_h5_slide  # noqa: F401
from keep_tpu_torch.io.tiles import cut_tiles, iter_wsi_tiles, tissue_mask  # noqa: F401
from keep_tpu_torch.io.wsi import WSIReader, open_slide, write_pyramid  # noqa: F401
