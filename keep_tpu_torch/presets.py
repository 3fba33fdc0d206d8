"""OpenCLIP architecture presets (counterpart of ``keep_tpu/presets.py``):
the reference's ``model_configs/*.json`` inventory, 62 entries
(training/path_open_clip/factory.py:41-62), re-declared as data, and the
builders of the entries whose towers this package has.

``resolve(name)`` maps an entry onto the port's towers, field for field as
the JAX package's ``resolve``:

- plain ViT + CLIP text (``vit``) → ``models.vit`` with the OpenCLIP
  ``ln_pre`` and a projection matrix (``visual_head.proj``) +
  ``models.text_transformer``;
- ``vit_medium_gap`` (``vit_gap``) → ``models.vit`` with no CLS token,
  average pooling and ``fc_norm``, and a linear head;
- ``eva_giant`` (``eva01_g``, EVA01) → ``models.vit`` (a plain pre-LN
  trunk) with timm's classifier head as the projection (a biased linear);
- ``RN*`` (``rn``) → ``models.resnet.ModifiedResNet`` (its attention pool
  projects; no head);
- ``convnext_*`` → ``models.convnext`` + a linear or MLP head (TimmModel's
  head, timm_model.py:95-106);
- ``swin_base_*`` → ``models.swin`` + a linear head;
- ``EVA02-*`` → ``models.eva`` (its own head projects; no head);
- ``vit_relpos_*`` → ``models.vit_relpos`` + a linear head;
- ``*-bert`` (``path_bert``) → BERT + tanh pooler + ``mlp_embed``
  (``models.kep.path_bert_encode``);
- ``roberta`` / ``xlm-roberta`` / ``mt5`` (``hf``) → ``models.hf_text``
  (mean pooler + MLP projection; ``models.t5`` for mT5).

- ``coca_*`` → ``models.coca`` (the ViT trunk with ``ln_pre`` and
  ``pool="none"``, the attentional pooler where the entry has one, the
  causal CLIP token tower or, for ``coca_roberta-ViT-B-32``, the RoBERTa
  tower of ``models.hf_text``, and the multimodal decoder).

These are all 62 entries.

``create_preset(name)`` is ``build_preset(resolve(name))``: a
``PresetModel`` (an ``nn.Module``) with ``encode_image``, ``encode_text``
and ``forward``, the surface of the JAX package's ``PresetModel``
closures, its weights drawn from a seed. As there, the RN and Swin image
towers compute in fp32 whatever ``dtype`` is asked (the JAX closures drop
their keyword arguments), over weights stored in the preset's dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn

from keep_tpu_torch.configs import BertConfig, PreprocessConfig, ViTConfig
from keep_tpu_torch.models.text_transformer import (TextTransformer,
                                                    TextTransformerConfig)
from keep_tpu_torch.models.vit import VisionTransformer, init_vit_weights
from keep_tpu_torch.ops.nn import cast_linear_weights, gelu, l2_normalize

# ---------------------------------------------------------------------------
# data: the reference's training/path_open_clip/model_configs, as in the JAX
# package's presets.py
# ---------------------------------------------------------------------------

_VIT = "vit"  # plain OpenCLIP VisionTransformer

_T = {"context_length": 77, "vocab_size": 49408}  # the common CLIP text base


def _vt(w, h, l):  # text_cfg shorthand
    return dict(_T, width=w, heads=h, layers=l)


PRESETS: dict[str, dict] = {
    # --- plain ViT + CLIP text -------------------------------------------
    "ViT-S-32": {"embed_dim": 384, "vision": {"kind": _VIT, "image_size": 224, "layers": 12, "width": 384, "patch_size": 32}, "text": _vt(384, 6, 12)},
    "ViT-S-32-alt": {"embed_dim": 256, "vision": {"kind": _VIT, "image_size": 224, "layers": 12, "width": 384, "patch_size": 32}, "text": _vt(256, 4, 10)},
    "ViT-S-16": {"embed_dim": 384, "vision": {"kind": _VIT, "image_size": 224, "layers": 12, "width": 384, "patch_size": 16}, "text": _vt(384, 6, 12)},
    "ViT-S-16-alt": {"embed_dim": 256, "vision": {"kind": _VIT, "image_size": 224, "layers": 12, "width": 384, "patch_size": 16}, "text": _vt(256, 4, 10)},
    "ViT-M-32": {"embed_dim": 512, "vision": {"kind": _VIT, "image_size": 224, "layers": 12, "width": 512, "patch_size": 32}, "text": _vt(512, 8, 12)},
    "ViT-M-32-alt": {"embed_dim": 384, "vision": {"kind": _VIT, "image_size": 224, "layers": 12, "width": 512, "patch_size": 32}, "text": _vt(384, 6, 12)},
    "ViT-M-16": {"embed_dim": 512, "vision": {"kind": _VIT, "image_size": 224, "layers": 12, "width": 512, "patch_size": 16}, "text": _vt(512, 8, 12)},
    "ViT-M-16-alt": {"embed_dim": 384, "vision": {"kind": _VIT, "image_size": 224, "layers": 12, "width": 512, "patch_size": 16, "ls_init_value": 1e-4}, "text": _vt(384, 6, 12)},
    "ViT-B-32": {"embed_dim": 512, "vision": {"kind": _VIT, "image_size": 224, "layers": 12, "width": 768, "patch_size": 32}, "text": _vt(512, 8, 12)},
    "ViT-B-32-quickgelu": {"embed_dim": 512, "quick_gelu": True, "vision": {"kind": _VIT, "image_size": 224, "layers": 12, "width": 768, "patch_size": 32}, "text": _vt(512, 8, 12)},
    "ViT-B-32-plus-256": {"embed_dim": 640, "vision": {"kind": _VIT, "image_size": 256, "layers": 12, "width": 896, "patch_size": 32}, "text": _vt(640, 10, 12)},
    "ViT-B-16": {"embed_dim": 512, "vision": {"kind": _VIT, "image_size": 224, "layers": 12, "width": 768, "patch_size": 16}, "text": _vt(512, 8, 12)},
    "ViT-B-16-plus": {"embed_dim": 640, "vision": {"kind": _VIT, "image_size": 224, "layers": 12, "width": 896, "patch_size": 16}, "text": _vt(640, 10, 12)},
    "ViT-B-16-plus-240": {"embed_dim": 640, "vision": {"kind": _VIT, "image_size": 240, "layers": 12, "width": 896, "patch_size": 16}, "text": _vt(640, 10, 12)},
    "ViT-L-14": {"embed_dim": 768, "vision": {"kind": _VIT, "image_size": 224, "layers": 24, "width": 1024, "patch_size": 14}, "text": _vt(768, 12, 12)},
    "ViT-L-14-280": {"embed_dim": 768, "vision": {"kind": _VIT, "image_size": 280, "layers": 24, "width": 1024, "patch_size": 14}, "text": _vt(768, 12, 12)},
    "ViT-L-14-336": {"embed_dim": 768, "vision": {"kind": _VIT, "image_size": 336, "layers": 24, "width": 1024, "patch_size": 14}, "text": _vt(768, 12, 12)},
    "ViT-L-16": {"embed_dim": 768, "vision": {"kind": _VIT, "image_size": 224, "layers": 24, "width": 1024, "patch_size": 16}, "text": _vt(768, 12, 12)},
    "ViT-L-16-320": {"embed_dim": 768, "vision": {"kind": _VIT, "image_size": 320, "layers": 24, "width": 1024, "patch_size": 16}, "text": _vt(768, 12, 12)},
    "ViT-H-14": {"embed_dim": 1024, "vision": {"kind": _VIT, "image_size": 224, "layers": 32, "width": 1280, "head_width": 80, "patch_size": 14}, "text": _vt(1024, 16, 24)},
    "ViT-H-16": {"embed_dim": 1024, "vision": {"kind": _VIT, "image_size": 224, "layers": 32, "width": 1280, "head_width": 80, "patch_size": 16}, "text": _vt(1024, 16, 24)},
    "ViT-g-14": {"embed_dim": 1024, "vision": {"kind": _VIT, "image_size": 224, "layers": 40, "width": 1408, "head_width": 88, "mlp_ratio": 4.3637, "patch_size": 14}, "text": _vt(1024, 16, 24)},
    "ViT-bigG-14": {"embed_dim": 1280, "vision": {"kind": _VIT, "image_size": 224, "layers": 48, "width": 1664, "head_width": 104, "mlp_ratio": 4.9231, "patch_size": 14}, "text": _vt(1280, 20, 32)},
    "ViT-e-14": {"embed_dim": 1280, "vision": {"kind": _VIT, "image_size": 224, "layers": 56, "width": 1792, "head_width": 112, "mlp_ratio": 8.5715, "patch_size": 14}, "text": _vt(1280, 20, 36)},
    # --- ModifiedResNet ---------------------------------------------------
    "RN50": {"embed_dim": 1024, "vision": {"kind": "rn", "image_size": 224, "layers": (3, 4, 6, 3), "width": 64}, "text": _vt(512, 8, 12)},
    "RN50-quickgelu": {"embed_dim": 1024, "quick_gelu": True, "vision": {"kind": "rn", "image_size": 224, "layers": (3, 4, 6, 3), "width": 64}, "text": _vt(512, 8, 12)},
    "RN101": {"embed_dim": 512, "vision": {"kind": "rn", "image_size": 224, "layers": (3, 4, 23, 3), "width": 64}, "text": _vt(512, 8, 12)},
    "RN101-quickgelu": {"embed_dim": 512, "quick_gelu": True, "vision": {"kind": "rn", "image_size": 224, "layers": (3, 4, 23, 3), "width": 64}, "text": _vt(512, 8, 12)},
    "RN50x4": {"embed_dim": 640, "vision": {"kind": "rn", "image_size": 288, "layers": (4, 6, 10, 6), "width": 80}, "text": _vt(640, 10, 12)},
    "RN50x16": {"embed_dim": 768, "vision": {"kind": "rn", "image_size": 384, "layers": (6, 8, 18, 8), "width": 96}, "text": _vt(768, 12, 12)},
    "RN50x64": {"embed_dim": 1024, "vision": {"kind": "rn", "image_size": 448, "layers": (3, 15, 36, 10), "width": 128}, "text": _vt(1024, 16, 12)},
    # --- timm-delegated towers, implemented natively ----------------------
    "convnext_tiny": {"embed_dim": 1024, "vision": {"kind": "convnext", "image_size": 224, "depths": (3, 3, 9, 3), "dims": (96, 192, 384, 768), "proj": "linear"}, "text": _vt(512, 8, 12)},
    "convnext_small": {"embed_dim": 512, "vision": {"kind": "convnext", "image_size": 224, "depths": (3, 3, 27, 3), "dims": (96, 192, 384, 768), "proj": "linear"}, "text": _vt(512, 8, 12)},
    "convnext_base": {"embed_dim": 512, "vision": {"kind": "convnext", "image_size": 224, "depths": (3, 3, 27, 3), "dims": (128, 256, 512, 1024), "proj": "linear"}, "text": _vt(512, 8, 12)},
    "convnext_base_w": {"embed_dim": 640, "vision": {"kind": "convnext", "image_size": 256, "depths": (3, 3, 27, 3), "dims": (128, 256, 512, 1024), "proj": "linear"}, "text": _vt(640, 10, 12)},
    "convnext_base_w_320": {"embed_dim": 640, "vision": {"kind": "convnext", "image_size": 320, "depths": (3, 3, 27, 3), "dims": (128, 256, 512, 1024), "proj": "linear"}, "text": _vt(640, 10, 12)},
    "convnext_large": {"embed_dim": 768, "vision": {"kind": "convnext", "image_size": 224, "depths": (3, 3, 27, 3), "dims": (192, 384, 768, 1536), "proj": "linear"}, "text": _vt(768, 12, 12)},
    "convnext_large_d": {"embed_dim": 768, "vision": {"kind": "convnext", "image_size": 256, "depths": (3, 3, 27, 3), "dims": (192, 384, 768, 1536), "proj": "mlp"}, "text": _vt(768, 12, 16)},
    "convnext_large_d_320": {"embed_dim": 768, "vision": {"kind": "convnext", "image_size": 320, "depths": (3, 3, 27, 3), "dims": (192, 384, 768, 1536), "proj": "mlp"}, "text": _vt(768, 12, 16)},
    "convnext_xlarge": {"embed_dim": 1024, "vision": {"kind": "convnext", "image_size": 256, "depths": (3, 3, 27, 3), "dims": (256, 512, 1024, 2048), "proj": "linear"}, "text": _vt(1024, 16, 20)},
    "convnext_xxlarge": {"embed_dim": 1024, "vision": {"kind": "convnext", "image_size": 256, "depths": (3, 4, 30, 3), "dims": (384, 768, 1536, 3072), "proj": "linear"}, "text": _vt(1024, 16, 24)},
    "convnext_xxlarge_320": {"embed_dim": 1024, "vision": {"kind": "convnext", "image_size": 320, "depths": (3, 4, 30, 3), "dims": (384, 768, 1536, 3072), "proj": "linear"}, "text": _vt(1024, 16, 24)},
    "swin_base_patch4_window7_224": {"embed_dim": 640, "vision": {"kind": "swin", "image_size": 224, "proj": "linear"}, "text": _vt(640, 10, 12)},
    "vit_medium_patch16_gap_256": {"embed_dim": 512, "vision": {"kind": "vit_gap", "image_size": 256, "layers": 12, "width": 512, "patch_size": 16, "proj": "linear"}, "text": _vt(512, 8, 12)},
    "EVA01-g-14": {"embed_dim": 1024, "vision": {"kind": "eva01_g", "image_size": 224, "proj": "linear_bias"}, "text": _vt(768, 12, 12)},
    "EVA01-g-14-plus": {"embed_dim": 1024, "vision": {"kind": "eva01_g", "image_size": 224, "proj": "linear_bias"}, "text": _vt(1024, 16, 24)},
    # EVA02 trunks (models/eva.py, shapes from EVA02-*.json; timm_proj null →
    # the trunk's own head projects to embed_dim)
    "EVA02-B-16": {"embed_dim": 512, "vision": {"kind": "eva02", "proj": "none"}, "text": _vt(512, 8, 12)},
    "EVA02-L-14": {"embed_dim": 768, "vision": {"kind": "eva02", "proj": "none"}, "text": _vt(768, 12, 12)},
    "EVA02-L-14-336": {"embed_dim": 768, "vision": {"kind": "eva02", "proj": "none"}, "text": _vt(768, 12, 12)},
    "EVA02-E-14": {"embed_dim": 1024, "vision": {"kind": "eva02", "proj": "none"}, "text": _vt(1024, 16, 24)},
    "EVA02-E-14-plus": {"embed_dim": 1024, "vision": {"kind": "eva02", "proj": "none"}, "text": _vt(1280, 20, 32)},
    "vit_relpos_medium_patch16_cls_224": {"embed_dim": 512, "vision": {"kind": "vit_relpos", "image_size": 224, "proj": "linear"}, "text": _vt(512, 8, 12)},
    # --- HF text towers ----------------------------------------------------
    "ViT-B-32-bert": {"embed_dim": 768, "vision": {"kind": _VIT, "image_size": 224, "layers": 12, "width": 768, "patch_size": 32}, "text": {"kind": "path_bert", "context_length": 256, "vocab_size": 30522, "width": 768, "heads": 12, "layers": 12}},
    "roberta-ViT-B-32": {"embed_dim": 512, "quick_gelu": True, "vision": {"kind": _VIT, "image_size": 224, "layers": 12, "width": 768, "patch_size": 32}, "text": {"kind": "roberta", "vocab_size": 50265, "width": 768, "heads": 12, "layers": 12, "proj": "mlp"}},
    "xlm-roberta-base-ViT-B-32": {"embed_dim": 512, "vision": {"kind": _VIT, "image_size": 224, "layers": 12, "width": 768, "patch_size": 32}, "text": {"kind": "xlm-roberta", "vocab_size": 250002, "width": 768, "heads": 12, "layers": 12, "proj": "mlp"}},
    "xlm-roberta-large-ViT-H-14": {"embed_dim": 1024, "vision": {"kind": _VIT, "image_size": 224, "layers": 32, "width": 1280, "head_width": 80, "patch_size": 14}, "text": {"kind": "xlm-roberta", "vocab_size": 250002, "width": 1024, "heads": 16, "layers": 24, "proj": "mlp"}},
    # mt5 trunk shapes from the HF google/mt5-{base,xl} configs (data contract)
    "mt5-base-ViT-B-32": {"embed_dim": 512, "vision": {"kind": _VIT, "image_size": 224, "layers": 12, "width": 768, "patch_size": 32}, "text": {"kind": "mt5", "vocab_size": 250112, "width": 768, "heads": 12, "layers": 12, "d_ff": 2048, "proj": "mlp"}},
    "mt5-xl-ViT-H-14": {"embed_dim": 1024, "vision": {"kind": _VIT, "image_size": 224, "layers": 32, "width": 1280, "head_width": 80, "patch_size": 14}, "text": {"kind": "mt5", "vocab_size": 250112, "width": 2048, "heads": 32, "layers": 24, "d_ff": 5120, "proj": "mlp"}},
    # --- CoCa --------------------------------------------------------------
    "coca_ViT-B-32": {"embed_dim": 512, "family": "coca", "vision": {"image_size": 224, "layers": 12, "width": 768, "patch_size": 32, "attentional_pool": True, "attn_pooler_heads": 8}, "text": {"width": 512, "heads": 8, "layers": 12, "vocab_size": 49408}, "multimodal": {"layers": 12, "heads": 8}},
    "coca_ViT-L-14": {"embed_dim": 768, "family": "coca", "vision": {"image_size": 224, "layers": 24, "width": 1024, "patch_size": 14, "attentional_pool": True, "attn_pooler_heads": 8}, "text": {"width": 768, "heads": 12, "layers": 12, "vocab_size": 49408}, "multimodal": {"layers": 12, "heads": 12}},
    "coca_base": {"embed_dim": 512, "family": "coca", "vision": {"image_size": 288, "layers": 12, "width": 768, "patch_size": 18}, "text": {"width": 768, "heads": 12, "layers": 12, "vocab_size": 64000}, "multimodal": {"layers": 12, "heads": 12, "n_queries": 256}},
    # CoCa with a RoBERTa token tower: no attentional pooler (decoder
    # cross-attends raw ViT patch tokens at trunk width 768 == multimodal
    # width), roberta hidden states feed the decoder
    # (coca_roberta-ViT-B-32.json)
    "coca_roberta-ViT-B-32": {"embed_dim": 512, "family": "coca", "vision": {"image_size": 224, "layers": 12, "width": 768, "patch_size": 32}, "text": {"kind": "roberta", "vocab_size": 50265, "width": 768, "heads": 12, "layers": 12, "proj": "linear"}, "multimodal": {"layers": 12, "heads": 8, "context_length": 76}},
}

# per-encoder normalization stats (reference factory.py:246-258 +
# constants.py): OpenCLIP presets default to the OpenAI CLIP stats; the
# pathology encoders (uni/ctp/prov) use ImageNet; res_ssl uses lunit's.
OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
RES_SSL_MEAN = (0.70322989, 0.53606487, 0.66096631)
RES_SSL_STD = (0.21716536, 0.26081574, 0.20723464)

ENCODER_STATS = {
    "uni": (IMAGENET_MEAN, IMAGENET_STD),
    "ctp": (IMAGENET_MEAN, IMAGENET_STD),
    "prov": (IMAGENET_MEAN, IMAGENET_STD),
    "res_ssl": (RES_SSL_MEAN, RES_SSL_STD),
}


class UnsupportedPresetError(NotImplementedError):
    pass


def tokenizer_kind(name: str) -> str:
    """The tokenizer family a preset's text tower expects (the reference's
    ``factory.get_tokenizer``, factory.py:85-98): 'clip' (byte-level BPE,
    ``text.bpe``) or 'bert' (WordPiece, ``text.tokenizer``). The RoBERTa,
    XLM-R and mT5 towers need their upstream HF tokenizers (vocabularies
    that ship with those checkpoints): they raise, as in the JAX
    package."""
    r = resolve(name)
    if r.family == "coca" and r.text_cfg.hf_text is None:
        return "clip"
    if r.text_kind == "clip":
        return "clip"
    if r.text_kind == "path_bert":
        return "bert"
    arch = (r.text_cfg.hf_text if r.family == "coca" else r.text_cfg).arch
    raise UnsupportedPresetError(
        f"{name}: the {arch} text tower uses its upstream HF tokenizer "
        f"({'SentencePiece' if arch in ('xlm-roberta', 'mt5') else 'byte-BPE'}"
        f" vocabulary shipped with the checkpoint); load it via "
        f"transformers.AutoTokenizer from a local checkout")


def preprocess_config(name: str) -> PreprocessConfig:
    """The preset's eval transform: its image size and the OpenAI CLIP
    mean / std (the reference's ``image_transform(model.visual.image_size,
    mean, std)``, factory.py:323-337)."""
    v = resolve(name).vision_cfg
    return PreprocessConfig(size=getattr(v, "img_size", None)
                            or v.image_size,
                            mean=OPENAI_DATASET_MEAN, std=OPENAI_DATASET_STD)


def preset_names() -> list[str]:
    """All 62 preset names, sorted."""
    return sorted(PRESETS)


# ---------------------------------------------------------------------------
# resolution
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ResolvedPreset:
    name: str
    family: str  # 'clip' | 'coca'
    embed_dim: int
    vision_kind: str  # 'vit' | 'vit_gap' | 'eva01_g' | 'rn' | 'convnext'
    #                   | 'swin' | 'eva02' | 'vit_relpos'
    vision_cfg: Any
    vision_proj: str  # 'matrix' | 'linear' | 'linear_bias' | 'mlp' | 'none'
    text_kind: str  # 'clip' | 'path_bert' | 'hf'
    text_cfg: Any
    quick_gelu: bool = False


def resolve(name: str) -> ResolvedPreset:
    """A preset's resolved configs, field for field as the JAX package's
    ``resolve``; ``KeyError`` for an unknown name. A CoCa entry resolves to
    family ``coca`` with its ``CoCaConfig`` as ``text_cfg`` (the JAX
    package's layout)."""
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {preset_names()}")
    raw = PRESETS[name]
    e = raw["embed_dim"]
    qg = raw.get("quick_gelu", False)
    act = "quick_gelu" if qg else "gelu"
    v = raw["vision"]
    if raw.get("family") == "coca":
        cfg = _resolve_coca(raw)
        return ResolvedPreset(name, "coca", e, "vit", cfg.vision, "none",
                              "coca", cfg, qg)
    kind = v["kind"]
    vcfg, vproj = _resolve_vision(name, kind, v, e, act)
    tcfg, tkind = _resolve_text(raw["text"].get("kind", "clip"), raw["text"],
                                e, act)
    return ResolvedPreset(name, "clip", e, kind, vcfg, vproj, tkind, tcfg, qg)


def _resolve_coca(raw: dict):
    """A CoCa entry's ``CoCaConfig``, as the JAX ``resolve``: the pooler
    belongs to the vision config (``coca_base`` has none, and
    ``coca_ViT-L-14``'s runs 8 heads: its multimodal ``attn_pooler_heads``
    is dead config); ``coca_roberta`` takes the RoBERTa tower, no pooler
    and RoBERTa's special ids (<s> 0, <pad> 1, </s> 2)."""
    from keep_tpu_torch.models.coca import CoCaConfig

    e, v, t, mm = raw["embed_dim"], raw["vision"], raw["text"], \
        raw["multimodal"]
    vision = ViTConfig(
        img_size=v["image_size"], patch_size=v["patch_size"],
        embed_dim=v["width"], depth=v["layers"],
        num_heads=v["width"] // v.get("head_width", 64),
        layerscale_init=None, ln_eps=1e-5, pool="none")
    common = dict(embed_dim=e, vocab_size=t["vocab_size"],
                  text_width=t["width"], text_heads=t["heads"],
                  text_layers=t["layers"], decoder_layers=mm["layers"],
                  decoder_heads=mm["heads"], vision=vision)
    if t.get("kind") == "roberta":
        hf, _ = _resolve_text("roberta", t, e, "gelu")
        return CoCaConfig(**common, context_length=mm.get("context_length",
                                                          76),
                          hf_text=hf, use_attn_pool=False, pad_id=1,
                          sot_id=0, eos_id=2)
    return CoCaConfig(**common, context_length=76,
                      use_attn_pool=v.get("attentional_pool", False),
                      attn_pooler_heads=v.get("attn_pooler_heads", 8),
                      n_queries=mm.get("n_queries", 256),
                      sot_id=t["vocab_size"] - 2, eos_id=t["vocab_size"] - 1)


def _resolve_vision(name: str, kind: str, v: dict, e: int, act: str):
    """(config, head kind) of an image tower, as the JAX ``resolve``."""
    if kind == "vit":
        return ViTConfig(
            img_size=v["image_size"], patch_size=v["patch_size"],
            embed_dim=v["width"], depth=v["layers"],
            num_heads=v["width"] // v.get("head_width", 64),
            mlp_ratio=v.get("mlp_ratio", 4.0),
            layerscale_init=v.get("ls_init_value"), ln_eps=1e-5,
            act=act), "matrix"
    if kind == "vit_gap":
        return ViTConfig(
            img_size=v["image_size"], patch_size=v["patch_size"],
            embed_dim=v["width"], depth=v["layers"],
            num_heads=v["width"] // 64, layerscale_init=None, ln_eps=1e-6,
            num_prefix_tokens=0, pool="avg", fc_norm=True), v["proj"]
    if kind == "eva01_g":
        # timm eva_giant_patch14_224: plain pre-LN ViT, width 1408, depth
        # 40, 16 heads, MLP 6144 (ratio 6144 / 1408), no LayerScale, CLS
        return ViTConfig(
            img_size=v["image_size"], patch_size=14, embed_dim=1408,
            depth=40, num_heads=16, mlp_ratio=6144 / 1408,
            layerscale_init=None, ln_eps=1e-6), v["proj"]
    if kind == "rn":
        from keep_tpu_torch.models.resnet import ModifiedResNetConfig

        return ModifiedResNetConfig(
            layers=tuple(v["layers"]), width=v["width"],
            image_size=v["image_size"], heads=v["width"] * 32 // 64,
            output_dim=e), "none"
    if kind == "convnext":
        from keep_tpu_torch.models.convnext import ConvNeXtConfig

        return ConvNeXtConfig(img_size=v["image_size"],
                              depths=tuple(v["depths"]),
                              dims=tuple(v["dims"])), v["proj"]
    if kind == "swin":
        from keep_tpu_torch.models.swin import SwinConfig

        return SwinConfig(img_size=v["image_size"], embed_dim=128,
                          depths=(2, 2, 18, 2), heads=(4, 8, 16, 32),
                          conv_stem=False), v["proj"]
    if kind == "eva02":
        from keep_tpu_torch.models.eva import EVA02_CONFIGS

        return EVA02_CONFIGS[name], "none"  # its head projects
    if kind == "vit_relpos":
        from keep_tpu_torch.models.vit_relpos import ViTRelPosConfig

        # timm vit_relpos_medium_patch16_cls_224: width 512, depth 12,
        # 8 heads, rel_pos_dim 256
        return ViTRelPosConfig(img_size=v["image_size"], patch_size=16,
                               embed_dim=512, depth=12, num_heads=8,
                               rel_pos_hidden=256), v["proj"]
    raise ValueError(f"bad vision kind {kind!r}")


def _resolve_text(tkind: str, t: dict, e: int, act: str):
    """(config, text kind) of a text tower, as the JAX ``resolve``."""
    if tkind == "clip":
        return TextTransformerConfig(
            vocab_size=t["vocab_size"], context_length=t["context_length"],
            width=t["width"], heads=t["heads"], layers=t["layers"],
            output_dim=e, act=act), "clip"
    if tkind == "path_bert":
        return BertConfig(vocab_size=t["vocab_size"], hidden_size=t["width"],
                          num_hidden_layers=t["layers"],
                          num_attention_heads=t["heads"],
                          intermediate_size=4 * t["width"]), "path_bert"
    from keep_tpu_torch.models.hf_text import HFTextConfig

    if tkind == "mt5":
        from keep_tpu_torch.models.t5 import T5EncoderConfig

        trunk = T5EncoderConfig(vocab_size=t["vocab_size"],
                                d_model=t["width"], num_heads=t["heads"],
                                num_layers=t["layers"], d_ff=t["d_ff"])
    elif tkind in ("roberta", "xlm-roberta"):
        trunk = BertConfig(
            vocab_size=t["vocab_size"], hidden_size=t["width"],
            num_hidden_layers=t["layers"], num_attention_heads=t["heads"],
            intermediate_size=4 * t["width"], max_position_embeddings=514,
            type_vocab_size=1, ln_eps=1e-5, pad_token_id=1)
    else:
        raise ValueError(f"bad text kind {tkind!r}")
    return HFTextConfig(arch=tkind, trunk=trunk, output_dim=e, pooler="mean",
                        proj=t["proj"]), "hf"


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------


class PresetHead(nn.Module):
    """The image tower's projection to ``embed_dim`` (the JAX package's
    ``_head_init`` / ``_head_apply``), its matrices [in, out] as there:
    ``matrix`` (``proj``), ``linear`` (``w``), ``linear_bias`` (``w``,
    ``b``), ``mlp`` (TimmModel's head: ``fc1`` [in, 2·out] with bias
    ``fc1_b``, exact GELU, unbiased ``fc2``)."""

    def __init__(self, kind: str, fin: int, fout: int, *, device=None):
        super().__init__()
        self.kind = kind
        z = lambda *shape: nn.Parameter(torch.zeros(*shape, device=device))  # noqa: E731
        if kind == "matrix":
            self.proj = z(fin, fout)
        elif kind in ("linear", "linear_bias"):
            self.w = z(fin, fout)
            if kind == "linear_bias":
                self.b = z(fout)
        elif kind == "mlp":
            self.fc1, self.fc1_b, self.fc2 = z(fin, 2 * fout), z(2 * fout), \
                z(2 * fout, fout)
        else:
            raise ValueError(f"bad head kind {kind!r}")

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Matrices normal with std fan_in^-0.5, biases zero."""
        for p in self.parameters():
            if p.dim() == 2:
                p.normal_(0.0, p.shape[0] ** -0.5, generator=generator)
            else:
                p.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dot = lambda a, w: torch.matmul(a, w.to(a.dtype))  # noqa: E731
        if self.kind == "matrix":
            return dot(x, self.proj)
        if self.kind == "linear":
            return dot(x, self.w)
        if self.kind == "linear_bias":
            return dot(x, self.w) + self.b.to(x.dtype)
        return dot(gelu(dot(x, self.fc1) + self.fc1_b.to(x.dtype)), self.fc2)


# the image towers that compute in fp32 whatever dtype is asked: the JAX
# package's create_preset closures for them drop their keyword arguments
FP32_VISION = ("rn", "swin")
# the image towers of models.vit
_VIT_KINDS = ("vit", "vit_gap", "eva01_g")


def _vision_tower(r: ResolvedPreset, device) -> tuple[nn.Module, int]:
    """The image tower of ``r`` and the width its head takes."""
    v = r.vision_cfg
    if r.vision_kind in _VIT_KINDS:
        return VisionTransformer(v, ln_pre=r.vision_proj == "matrix",
                                 device=device), v.embed_dim
    if r.vision_kind == "rn":
        from keep_tpu_torch.models.resnet import ModifiedResNet

        return ModifiedResNet(v, device=device), r.embed_dim
    if r.vision_kind == "convnext":
        from keep_tpu_torch.models.convnext import ConvNeXt

        return ConvNeXt(v, device=device), v.num_features
    if r.vision_kind == "swin":
        from keep_tpu_torch.models.swin import Swin

        return Swin(v, device=device), v.num_features
    if r.vision_kind == "eva02":
        from keep_tpu_torch.models.eva import Eva

        return Eva(v, device=device), v.out_dim
    from keep_tpu_torch.models.vit_relpos import ViTRelPos

    return ViTRelPos(v, device=device), v.embed_dim


def _text_tower(r: ResolvedPreset, device) -> nn.Module:
    if r.text_kind == "clip":
        return TextTransformer(r.text_cfg, device=device)
    if r.text_kind == "path_bert":
        from keep_tpu_torch.models.kep import PathBert

        return PathBert(r.text_cfg, r.embed_dim, device=device)
    from keep_tpu_torch.models.hf_text import HFText

    return HFText(r.text_cfg, device=device)


class PresetModel(nn.Module):
    """A resolved preset as one module: ``visual`` (with ``ln_pre`` under a
    ``matrix`` head), ``visual_head`` (none where the tower projects),
    ``text`` and ``logit_scale``, named as the JAX package's parameter
    pytree. ``dtype`` is the compute dtype; the linear and conv weights
    are stored in it."""

    family = "clip"

    def __init__(self, preset: ResolvedPreset, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        r = preset
        self.preset = r
        self.dtype = dtype
        self.visual, fin = _vision_tower(r, device)
        self.visual_head = (None if r.vision_proj == "none" else
                            PresetHead(r.vision_proj, fin, r.embed_dim,
                                       device=device))
        self.text = _text_tower(r, device)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07),
                                                     device=device))
        cast_linear_weights(self, dtype)

    @property
    def config(self) -> ResolvedPreset:
        return self.preset

    def encode_image(self, pixels: torch.Tensor, *, normalize: bool = False,
                     dtype: torch.dtype | None = None, **kw) -> torch.Tensor:
        """[B, H, W, 3] normalised pixels → [B, embed_dim] in ``dtype``
        (default: the model's); ``kw`` go to the tower (the ViT's
        ``use_flash``, ``fuse_ln``, ``gelu_approx``, ...; ConvNeXt's
        ``pool``); unit fp32 rows with ``normalize``. The RN and Swin towers
        run in fp32 and take no keywords (``FP32_VISION``), as in the JAX
        package."""
        x = pixels.to(self.logit_scale.device)
        if self.preset.vision_kind in FP32_VISION:
            f = self.visual(x)
        else:
            f = self.visual(x, dtype=dtype or self.dtype, **kw)
        if self.visual_head is not None:
            f = self.visual_head(f)
        return l2_normalize(f.float()) if normalize else f

    def encode_text(self, input_ids: torch.Tensor, *, normalize: bool = False,
                    dtype: torch.dtype | None = None, **kw) -> torch.Tensor:
        """[B, S] ids → [B, embed_dim]; ``kw`` go to the BERT-family towers
        (``use_flash``, which runs them through the fused attention #1).
        The path-BERT's mask is ``ids != 0``, as in the JAX package."""
        ids = input_ids.to(self.logit_scale.device)
        dtype = dtype or self.dtype
        if self.preset.text_kind == "path_bert":
            f = self.text(ids, (ids != 0).long(), dtype=dtype, **kw)
        else:
            f = self.text(ids, dtype=dtype, **kw)
        return l2_normalize(f.float()) if normalize else f

    def forward(self, pixels: torch.Tensor, input_ids: torch.Tensor,
                **kw) -> dict:
        return {"image_features": self.encode_image(pixels, normalize=True,
                                                    **kw),
                "text_features": self.encode_text(input_ids, normalize=True),
                "logit_scale": self.logit_scale.exp()}


def card_device(device=None) -> torch.device:
    """``device``, by default the card; raises when the card is asked for
    and there is none (nothing moves to the CPU by itself)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: pass device="cpu" to build on the '
                           'CPU')
    return device


@torch.no_grad()
def build_preset(preset: ResolvedPreset, seed: int = 0,
                 dtype: torch.dtype = torch.float32,
                 device=None) -> PresetModel:
    """A ``PresetModel`` of ``preset`` (any resolved preset, a shrunk one
    too), its weights drawn on ``device`` (default: the card) from a
    generator seeded with ``seed``, with the JAX package's init
    statistics: each tower's init, the head's matrices std fan_in^-0.5,
    the path-BERT's ``mlp_embed`` std embed_dim^-0.5, ``logit_scale =
    log(1 / 0.07)``."""
    device = card_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    if preset.family == "coca":
        from keep_tpu_torch.models.coca import CoCa

        model = CoCa.init(preset.text_cfg, gen, dtype=dtype, device=device)
        model.preset = preset
        return model.eval()
    model = PresetModel(preset, device=device)
    if preset.vision_kind in _VIT_KINDS:
        init_vit_weights(model.visual, gen)
    else:
        model.visual.init_weights(gen)
    if model.visual_head is not None:
        model.visual_head.init_weights(gen)
    if preset.text_kind == "path_bert":
        model.text.bert.init_weights(gen)
        model.text.mlp_embed.init_weights(gen, preset.embed_dim ** -0.5)
    else:
        model.text.init_weights(gen)
    cast_linear_weights(model, dtype)
    model.dtype = dtype
    return model.eval()


def create_preset(name: str, seed: int = 0,
                  dtype: torch.dtype = torch.float32,
                  device=None) -> PresetModel:
    """``build_preset(resolve(name), ...)``: a ``PresetModel``, or for the
    CoCa entries a ``models.coca.CoCa``."""
    return build_preset(resolve(name), seed=seed, dtype=dtype, device=device)
