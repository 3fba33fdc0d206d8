"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), each beside its
plain PyTorch version. Importing this package builds nothing."""

from keep_tpu_torch.kernels.flash_attention import (  # noqa: F401
    attention_qkv_slab,
    attention_qkv_slab_reference,
)
