"""The KEEP model and its published inference API (counterpart of
``keep_tpu/models/keep.py``).

  encode_image(pixels)       = l2_normalize(visual_head(vit(pixels)))
  encode_text(ids, mask, tt) = l2_normalize(bert(...).pooler_output)

with ``visual_head`` = Linear(1024→768) → exact GELU → Linear(768→768).
Both encoders train (``remat`` for per-block recompute); ``KEEPModel.init``
draws a random model for training from scratch.
"""

from __future__ import annotations

import copy
import math
import os

import torch
from torch import nn

from keep_tpu_torch.configs import KEEPConfig
from keep_tpu_torch.models.bert import BertModel
from keep_tpu_torch.models.vit import VisionTransformer
from keep_tpu_torch.ops.nn import Linear, gelu, l2_normalize


class VisualHead(nn.Module):
    def __init__(self, d_in: int, d_out: int, *, device=None):
        super().__init__()
        self.fc1 = Linear(d_in, d_out, device=device)
        self.fc2 = Linear(d_out, d_out, device=device)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        # the head's GELU is always the exact erf form
        feats = self.fc2(gelu(self.fc1(feats)))
        return l2_normalize(feats.float())


class KEEPModel(nn.Module):
    """ViT-L/16 image tower, visual head and BERT text tower.

    ``dtype`` is the compute dtype. The matmul weights are stored in
    ``weight_dtype``, by default the same (``load_state_dict`` rounds fp32
    values into them; the JAX package casts its fp32 kernels to the same
    values on every call), while LayerNorm, biases and embedding tables stay
    fp32; a narrower weight keeps the fp32 values it was loaded from on the
    host, for ``quantize()``. ``use_flash`` routes attention
    through the fused kernel. ``gelu_approx=None`` means the tanh GELU under
    bf16 and the erf GELU otherwise, as in the JAX package. Parameters are
    created empty: load a state dict (``from_pretrained`` does)."""

    def __init__(self, cfg: KEEPConfig, *, dtype: torch.dtype = torch.float32,
                 use_flash: bool = False, gelu_approx: bool | None = None,
                 device=None, weight_dtype: torch.dtype | None = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.use_flash = use_flash
        self.gelu_approx = (dtype == torch.bfloat16 if gelu_approx is None
                            else gelu_approx)
        self.visual = VisionTransformer(cfg.vision, device=device)
        self.visual_head = VisualHead(cfg.vision.embed_dim, cfg.projection_dim,
                                      device=device)
        self.text = BertModel(cfg.text, device=device)
        self.logit_scale = nn.Parameter(torch.tensor(
            math.log(1.0 / cfg.logit_scale_init), device=device))
        self._cast_linear_weights(weight_dtype or dtype)

    @torch.no_grad()
    def _cast_linear_weights(self, dtype: torch.dtype) -> None:
        for m in self.modules():
            if isinstance(m, Linear):
                m.weight.data = m.weight.data.to(dtype)

    def encode_image(self, pixels: torch.Tensor,
                     remat: bool = False) -> torch.Tensor:
        """[B, H, W, 3] normalised pixels → [B, projection_dim] unit fp32.
        ``remat`` recomputes each block in the backward."""
        feats = self.visual(pixels, dtype=self.dtype, use_flash=self.use_flash,
                            gelu_approx=self.gelu_approx, remat=remat)
        return self.visual_head(feats)

    def encode_text(self, input_ids: torch.Tensor,
                    attention_mask: torch.Tensor | None = None,
                    token_type_ids: torch.Tensor | None = None,
                    remat: bool = False) -> torch.Tensor:
        """[B, S] token ids (+ mask) → [B, hidden] unit fp32 features."""
        out = self.text(input_ids, attention_mask, token_type_ids,
                        dtype=self.dtype, use_flash=self.use_flash,
                        gelu_approx=self.gelu_approx, remat=remat)
        return l2_normalize(out["pooler_output"].float())

    @classmethod
    @torch.no_grad()
    def init(cls, cfg: KEEPConfig, generator: torch.Generator, *,
             logit_scale: float | None = None, device=None,
             **kw) -> "KEEPModel":
        """A randomly initialised model, drawn from ``generator`` with the
        statistics of the JAX package's ``keep.init`` (ViT and head weights
        std fan_in^-0.5, BERT weights and embeddings std .02, zero biases,
        unit LayerNorms, LayerScale at ``layerscale_init``), with
        ``logit_scale = log(1 / logit_scale)`` (default: the config's
        ``logit_scale_init``). ``kw`` go to the constructor; for training
        pass ``weight_dtype=torch.float32`` to keep fp32 master weights."""
        from keep_tpu_torch.compat.torch_loader import (load_keep_state_dict,
                                                        random_keep_state_dict)

        sd = load_keep_state_dict(random_keep_state_dict(
            cfg, generator, device=device, keep_init=True), cfg)
        model = cls(cfg, device=device, **kw)
        model.load_state_dict(sd, strict=True)
        model.logit_scale.fill_(math.log(
            1.0 / (cfg.logit_scale_init if logit_scale is None
                   else logit_scale)))
        return model

    def quantize(self, calib_pixels=None, smooth_alpha: float = 0.5,
                 calib_text=None, moe_w8a16: bool = False) -> "KEEPModel":
        """The W8A8 int8 inference variant (see ``keep_tpu_torch.quant``),
        as a new model; ``self`` stays float and unchanged, as in the JAX
        package, so that the two can be held against each other. In the
        copy, LayerScale is folded into proj and fc2 first (exact), then
        every targeted linear of both towers and the visual head is
        quantized, and the linears that stay float (the text pooler) are
        cast to the compute dtype. ``use_flash`` and ``gelu_approx`` are
        kept: with both on, the blocks run the int8 megakernels.

        Each weight is quantized from the fp32 values it was loaded from
        (``ops.nn.Linear.quantize_source``), whatever dtype stores it, so
        the int8 codes equal the JAX package's ``KEEPModel.quantize()`` bit
        for bit; a weight changed since it was loaded is quantized as
        stored. SmoothQuant calibration (``calib_pixels``, ``calib_text``)
        and the MoE ``moe_w8a16`` option are not ported yet and raise."""
        if calib_pixels is not None or calib_text is not None or moe_w8a16:
            raise NotImplementedError(
                "SmoothQuant calibration (calib_pixels / calib_text) and "
                "moe_w8a16 are not ported yet; quantize "
                "plainly, or calibrate with keep_tpu and load the tree with "
                "compat.torch_loader.from_jax_params")
        from keep_tpu_torch.quant import is_quantized

        if is_quantized(self):
            raise ValueError(
                "the model is already quantized (QLinear present): "
                "double-quantizing int8 weights would corrupt them")
        # the host copies of the fp32 weights are read, never written:
        # the copy shares them
        memo = {id(m.fp32_weight): m.fp32_weight for m in self.modules()
                if isinstance(m, Linear) and m.fp32_weight is not None}
        model = copy.deepcopy(self, memo)
        model._quantize_in_place()
        return model

    @torch.no_grad()
    def _quantize_in_place(self) -> None:
        """``quantize()``'s work on this float model itself."""
        from keep_tpu_torch.models.vit import fold_layerscale
        from keep_tpu_torch.quant import quantize_linear_weights

        for m in self.modules():
            if isinstance(m, Linear):
                m.weight.data = m.quantize_source()
                m.fp32_weight = None
        fold_layerscale(self.visual)
        quantize_linear_weights(self)
        self._cast_linear_weights(self.dtype)

    @classmethod
    def from_pretrained(cls, model_dir: str,
                        dtype: torch.dtype = torch.float32,
                        use_flash: bool = False, device=None,
                        cfg: KEEPConfig | None = None,
                        quantize: bool = False) -> "KEEPModel":
        """Reads ``config.json`` and ``pytorch_model.bin`` (or
        ``model.safetensors``) in the released layout. ``quantize=True``
        returns the int8 model (``quantize()``), quantized from the
        checkpoint's fp32 values before the float linears are cast to
        ``dtype``.

        The JAX package's own int8 artifact (a ``quantized/`` Orbax
        checkpoint, ``keep_tpu.compat.export.save_quantized``) is not read
        by the port: a model dir that carries one raises.

        ``device`` defaults to the card (``cuda``); without one the call
        raises unless the caller asks for the CPU with ``device="cpu"``: it
        never moves to the CPU by itself."""
        from keep_tpu_torch.compat.torch_loader import (load_keep_state_dict,
                                                        load_state_dict_file)

        if os.path.isdir(os.path.join(model_dir, "quantized")):
            raise NotImplementedError(
                f"{model_dir} carries the JAX package's quantized artifact "
                f"(quantized/, an Orbax checkpoint), which the PyTorch port "
                f"does not read; serve it with python -m keep_tpu.serve, or "
                f"load the fp checkpoint and quantize it here (--int8)")
        cfg = cfg or KEEPConfig.from_hf_json(os.path.join(model_dir,
                                                          "config.json"))
        for name in ("pytorch_model.bin", "model.safetensors"):
            weights = os.path.join(model_dir, name)
            if os.path.exists(weights):
                break
        else:
            raise FileNotFoundError(
                f"no pytorch_model.bin or model.safetensors in {model_dir}")
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError('no CUDA device: pass device="cpu" to load on '
                               'the CPU')
        sd = load_keep_state_dict(load_state_dict_file(weights), cfg)
        model = cls(cfg, dtype=dtype, use_flash=use_flash, device=device,
                    weight_dtype=torch.float32 if quantize else None)
        model.load_state_dict(sd, strict=True)
        if quantize:
            # the fresh model is quantized itself: no second copy on the card
            model._quantize_in_place()
        return model.eval()
