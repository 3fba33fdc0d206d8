from keep_tpu_torch.compat.composite import (  # noqa: F401
    load_coca_checkpoint,
    load_kep_checkpoint,
    load_pmc_clip_checkpoint,
)
from keep_tpu_torch.compat.torch_loader import (  # noqa: F401
    from_jax_params,
    load_hf_bert_state_dict,
    load_keep_checkpoint,
    load_keep_state_dict,
    load_timm_vit_state_dict,
)
