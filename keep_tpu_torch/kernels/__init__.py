"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), each beside its
plain PyTorch version: the fused attention (``flash_attention``), the int8
kernels and their shared math (``_kops``), and the int8 counterparts of the
TPU kernels built from them (``qmatmul``, ``qmlp``, ``qblock``). Importing
this package builds nothing."""

from keep_tpu_torch.kernels.flash_attention import (  # noqa: F401
    attention_qkv_slab,
    attention_qkv_slab_reference,
)
