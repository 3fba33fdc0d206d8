"""keep_tpu_torch — KEEP and the OpenCLIP model zoo in PyTorch, for an
NVIDIA H100.

A port of ``keep_tpu`` (JAX on a TPU), which stays beside it as the
reference. Module paths mirror the JAX package: ``keep_tpu_torch.models.vit``
is the counterpart of ``keep_tpu.models.vit``. The package imports torch and
numpy, never JAX, and builds nothing when imported: CUDA kernels are
compiled the first time a wrapper launches one.

- ``configs``            — ViT / BERT / KEEP / preprocess dataclasses.
- ``ops``                — linear, fp32 LayerNorm, GELU, attention, L2 norm;
  the bicubic resize and tile normalisation on the device.
- ``kernels``            — hand-written Hopper kernels and their plain
  PyTorch versions: ``attention_qkv_slab`` (any head width from 64 to
  128, any length), and the int8 W8A8 kernels
  (``quant_rows``, ``int8_gemm``, ``ln_rows``) that the int8 linear, MLP
  pair and attention sub-blocks (``qmatmul``, ``qmlp``, ``qblock``) run.
- ``quant``              — int8 weight quantization (``QLinear`` swap).
- ``models``             — the ViT (any image size, the OpenCLIP
  variants), BERT, the ``KEEPModel`` facade, the CLIP text tower and
  ``CLIP``; the zoo's other towers (ModifiedResNet, ConvNeXt, Swin,
  EVA02, the relpos ViT; the RoBERTa / XLM-R / mT5 text towers) and KEP.
- ``presets``, ``factory`` — the 62 OpenCLIP presets (58 built: all but
  CoCa's) and ``create_model`` (with the registry's ``kep`` and
  ``rn50-clip``).
- ``compat``             — released KEEP checkpoints, JAX pytrees and
  OpenAI CLIP checkpoints → state dicts.
- ``text``               — WordPiece and CLIP BPE tokenizers.
- ``serve``              — batching HTTP inference server
  (``python -m keep_tpu_torch.serve``).
- ``io``, ``wsi``, ``zeroshot``, ``metrics`` — the zero-shot WSI sweep:
  tissue tiles, features, prompt-ensemble classifiers, detection /
  segmentation / subtyping (``python -m keep_tpu_torch.wsi.run``); the
  OpenCLIP zero-shot ImageNet classifier (``zeroshot.openclip``).
- ``train``              — the training CLI (``python -m
  keep_tpu_torch.train.main``).
"""

__version__ = "0.1.0"
