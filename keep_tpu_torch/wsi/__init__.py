"""Zero-shot WSI sweeps (counterpart of ``keep_tpu/wsi``): the coordinate
grid, the detection / segmentation / subtyping pipelines, tile feature
extraction, cohort loops, the coarse-to-fine cascade (``wsi.cascade``) and
the ``run`` CLI, and the sweep's long axis over a device mesh
(``wsi.sharded``, ``pipelines.score_tiles_sharded``)."""

from keep_tpu_torch.wsi.grid import CoordGrid, heatmap_image, refine_grid  # noqa: F401
from keep_tpu_torch.wsi.pipelines import (  # noqa: F401
    score_tiles,
    score_tiles_sharded,
    subtype_class_map,
    tumor_heatmap,
    zero_shot_detection,
    zero_shot_segment,
    zero_shot_subtyping,
)
from keep_tpu_torch.wsi.sharded import (  # noqa: F401
    prompt_select_sharded,
    refined_probs_sharded,
)
