"""OpenAI / OpenCLIP CLIP (counterpart of ``keep_tpu/models/clip.py``; the
reference's ``CLIP`` class, training/path_open_clip/model/model.py:186-255):
a ViT image tower whose pooled features go through the ``visual.proj``
matrix, the causal text tower, and a shared ``logit_scale``.

``dtype`` is the compute dtype: the linear weights are stored in it, while
LayerNorms, biases, embeddings and the projection matrices stay fp32 and
are cast on use. ``ln_pre=True`` gives the image tower the OpenAI-CLIP
LayerNorm after the pos embed (the JAX pytree carries it when the
checkpoint does: ``compat.openai.load_openai_clip``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from keep_tpu_torch.configs import ViTConfig
from keep_tpu_torch.models.text_transformer import (TextTransformer,
                                                    TextTransformerConfig)
from keep_tpu_torch.models.vit import VisionTransformer, init_vit_weights
from keep_tpu_torch.ops.nn import cast_linear_weights, l2_normalize


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    vision: ViTConfig = dataclasses.field(
        default_factory=lambda: ViTConfig(
            embed_dim=768, depth=12, num_heads=12, layerscale_init=None,
            ln_eps=1e-5))
    text: TextTransformerConfig = dataclasses.field(
        default_factory=TextTransformerConfig)
    logit_scale_init: float = 1 / 14.285714  # ln(1/0.07), OpenAI's default


class CLIP(nn.Module):
    family = "clip"

    def __init__(self, cfg: CLIPConfig, *, dtype: torch.dtype = torch.float32,
                 ln_pre: bool = False, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.visual = VisionTransformer(cfg.vision, ln_pre=ln_pre,
                                        device=device)
        self.visual.proj = nn.Parameter(
            torch.zeros(cfg.vision.embed_dim, cfg.embed_dim, device=device))
        self.text = TextTransformer(cfg.text, device=device)
        self.logit_scale = nn.Parameter(torch.tensor(
            math.log(1 / cfg.logit_scale_init), device=device))
        cast_linear_weights(self, dtype)

    @property
    def config(self) -> CLIPConfig:
        return self.cfg

    def encode_image(self, pixels: torch.Tensor, *, normalize: bool = False,
                     dtype: torch.dtype | None = None,
                     use_flash: bool = False) -> torch.Tensor:
        """[B, H, W, 3] normalised pixels → [B, embed_dim] in ``dtype``
        (default: the model's), unit fp32 rows with ``normalize``."""
        feats = self.visual(pixels.to(self.logit_scale.device),
                            dtype=dtype or self.dtype, use_flash=use_flash)
        feats = torch.matmul(feats, self.visual.proj.to(feats.dtype))
        return l2_normalize(feats.float()) if normalize else feats

    def encode_text(self, input_ids: torch.Tensor, *, normalize: bool = False,
                    dtype: torch.dtype | None = None) -> torch.Tensor:
        feats = self.text(input_ids, dtype=dtype or self.dtype)
        return l2_normalize(feats.float()) if normalize else feats

    def forward(self, pixels: torch.Tensor, input_ids: torch.Tensor,
                **kw) -> dict:
        """Unit image and text features and exp(logit_scale); ``kw`` go to
        ``encode_image``, as in the JAX package."""
        return {"image_features": self.encode_image(pixels, normalize=True,
                                                    **kw),
                "text_features": self.encode_text(input_ids, normalize=True),
                "logit_scale": self.logit_scale.exp()}

    @classmethod
    @torch.no_grad()
    def init(cls, cfg: CLIPConfig, generator: torch.Generator, *,
             dtype: torch.dtype = torch.float32, device=None) -> "CLIP":
        """A random CLIP drawn from ``generator`` with the JAX package's
        ``clip.init`` statistics (the towers' inits, ``visual.proj`` normal
        with std D^-0.5, ``logit_scale = log(1 / logit_scale_init)``)."""
        model = cls(cfg, device=device)
        init_vit_weights(model.visual, generator)
        model.visual.proj.normal_(0.0, cfg.vision.embed_dim ** -0.5,
                                  generator=generator)
        model.text.init_weights(generator)
        cast_linear_weights(model, dtype)
        model.dtype = dtype
        return model.eval()
