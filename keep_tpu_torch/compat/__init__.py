from keep_tpu_torch.compat.torch_loader import (  # noqa: F401
    from_jax_params,
    load_keep_state_dict,
)
