"""Zero-shot WSI sweeps (counterpart of ``keep_tpu/wsi``): the coordinate
grid, the detection / segmentation / subtyping pipelines, tile feature
extraction, cohort loops and the ``run`` CLI. The cascade and the sharded
sweeps are not ported yet."""

from keep_tpu_torch.wsi.grid import CoordGrid, heatmap_image, refine_grid  # noqa: F401
from keep_tpu_torch.wsi.pipelines import (  # noqa: F401
    score_tiles,
    subtype_class_map,
    tumor_heatmap,
    zero_shot_detection,
    zero_shot_segment,
    zero_shot_subtyping,
)
