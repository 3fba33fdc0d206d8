"""Model / pipeline configuration dataclasses of the KEEP serving path.

Counterpart of ``keep_tpu/configs.py:15-143``, re-declared because this
package never imports ``keep_tpu`` (its ``__init__`` imports JAX). The fields
and defaults are the JAX package's, so a ``config.json`` written for one
loads into the other. Only the fields the ported slice reads are kept; the
MoE fields of ``ViTConfig`` are accepted from JSON and checked by the ViT.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """timm ``vit_large_patch16_224`` semantics (ViT-L/16, LayerScale 1e-5)."""

    img_size: int = 224
    patch_size: int = 16
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    layerscale_init: Optional[float] = 1e-5
    ln_eps: float = 1e-6
    num_prefix_tokens: int = 1  # CLS
    pool: str = "token"  # 'token' | 'avg' | 'none'
    act: str = "gelu"  # 'gelu' | 'quick_gelu'
    fc_norm: bool = False
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    moe_dispatch: str = "einsum"

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def mlp_dim(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """HF ``BertModel`` semantics: post-LN encoder, tanh pooler over [CLS]."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    ln_eps: float = 1e-12
    pad_token_id: int = 0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_hf_dict(cls, d: dict) -> "BertConfig":
        return cls(
            vocab_size=d.get("vocab_size", 30522),
            hidden_size=d.get("hidden_size", 768),
            num_hidden_layers=d.get("num_hidden_layers", 12),
            num_attention_heads=d.get("num_attention_heads", 12),
            intermediate_size=d.get("intermediate_size", 3072),
            max_position_embeddings=d.get("max_position_embeddings", 512),
            type_vocab_size=d.get("type_vocab_size", 2),
            ln_eps=d.get("layer_norm_eps", 1e-12),
            pad_token_id=d.get("pad_token_id", 0),
        )


@dataclasses.dataclass(frozen=True)
class KEEPConfig:
    """The published KEEP model: ViT-L/16 + 2-layer MLP visual head + BERT."""

    vision: ViTConfig = dataclasses.field(default_factory=ViTConfig)
    text: BertConfig = dataclasses.field(default_factory=BertConfig)
    projection_dim: int = 768
    logit_scale_init: float = 0.04
    max_text_length: int = 256

    @classmethod
    def from_hf_json(cls, path: str) -> "KEEPConfig":
        with open(path) as f:
            return cls.from_hf_dict(json.load(f))

    @classmethod
    def from_hf_dict(cls, d: dict) -> "KEEPConfig":
        """The config of a released ``config.json``'s contents."""
        # the released config carries no usable vision_config (the model is
        # hard-coded timm ViT-L/16); exported configs carry ViTConfig fields
        vision = ViTConfig()
        vc = d.get("vision_config") or {}
        known = {f.name for f in dataclasses.fields(ViTConfig)}
        if vc and set(vc).issubset(known):
            vc = dict(vc)
            if vc.get("layerscale_init") is not None:
                vc["layerscale_init"] = float(vc["layerscale_init"])
            vision = ViTConfig(**vc)
        return cls(
            vision=vision,
            text=BertConfig.from_hf_dict(d.get("text_config") or {}),
            projection_dim=d.get("projection_dim", 768),
            max_text_length=d.get("max_text_length", 256),
        )


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    """Eval transform: shortest side → 224 bicubic, center crop, ImageNet
    mean/std normalisation."""

    size: int = 224
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
