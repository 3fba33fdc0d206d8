"""keep_tpu_torch — KEEP in PyTorch, for an NVIDIA H100.

A port of ``keep_tpu`` (JAX on a TPU), which stays beside it as the
reference. Module paths mirror the JAX package: ``keep_tpu_torch.models.vit``
is the counterpart of ``keep_tpu.models.vit``. The package imports torch and
numpy, never JAX, and builds nothing when imported: CUDA kernels are
compiled the first time a wrapper launches one.

- ``configs``            — ViT / BERT / KEEP / preprocess dataclasses.
- ``ops``                — linear, fp32 LayerNorm, GELU, attention, L2 norm;
  the bicubic resize and tile normalisation on the device.
- ``kernels``            — hand-written Hopper kernels and their plain
  PyTorch versions: ``attention_qkv_slab``, and the int8 W8A8 kernels
  (``quant_rows``, ``int8_gemm``, ``ln_rows``) that the int8 linear, MLP
  pair and attention sub-blocks (``qmatmul``, ``qmlp``, ``qblock``) run.
- ``quant``              — int8 weight quantization (``QLinear`` swap).
- ``models``             — ViT-L/16, BERT and the ``KEEPModel`` facade.
- ``compat.torch_loader`` — released checkpoint and JAX pytree → state dict.
- ``text``               — WordPiece tokenizer.
- ``serve``              — batching HTTP inference server
  (``python -m keep_tpu_torch.serve``).
- ``io``, ``wsi``, ``zeroshot``, ``metrics`` — the zero-shot WSI sweep:
  tissue tiles, features, prompt-ensemble classifiers, detection /
  segmentation / subtyping (``python -m keep_tpu_torch.wsi.run``).
- ``train``              — the training CLI (``python -m
  keep_tpu_torch.train.main``).
"""

__version__ = "0.1.0"
