from keep_tpu_torch.ops.nn import (  # noqa: F401
    gelu,
    l2_normalize,
    layer_norm,
    linear,
    mha_attention,
)
from keep_tpu_torch.ops.preprocess import normalize_only  # noqa: F401
