"""OpenAI / open_clip CLIP checkpoints → the port's ``models.clip.CLIP``
(counterpart of ``keep_tpu/compat/openai.py``; the reference's
openai.py:24-90): one state dict holding a ViT image tower and the fused
text tower, from a local file (no downloads).

``load_openai_clip`` reads a ``torch.save`` file with ``weights_only=True``
or, failing that, a TorchScript archive (every original OpenAI CLIP
release) through ``torch.jit.load``, infers the architecture from the
shapes when no config is given, and returns the port's state dict with the
config: build ``CLIP(cfg, ln_pre=True)`` and load it. ModifiedResNet towers
(RN50, ...) are refused, as in the JAX package, naming their converter
(``models.resnet.convert_openai_resnet``).
"""

from __future__ import annotations

import pickle
from typing import Mapping

import torch

from keep_tpu_torch.compat.torch_loader import _tensor, normalize_state_dict
from keep_tpu_torch.configs import ViTConfig
from keep_tpu_torch.models.clip import CLIPConfig
from keep_tpu_torch.models.text_transformer import (TextTransformerConfig,
                                                    convert_openclip_text)


def _g(sd: Mapping, k: str) -> torch.Tensor:
    return _tensor(sd[k]).cpu()


def infer_clip_config(sd: Mapping) -> CLIPConfig:
    """The architecture of an OpenAI-layout state dict, from its shapes
    (openai.py's ``build_model``). Every original OpenAI checkpoint uses
    QuickGELU (the reference's ``build_model_from_openai_state_dict``
    hard-codes it); pass an explicit config for open_clip's GELU retrains."""
    conv = sd["visual.conv1.weight"]
    vision_width, patch = conv.shape[0], conv.shape[-1]
    vision_layers = len({k.split(".")[3] for k in sd
                         if k.startswith("visual.transformer.resblocks.")})
    grid = int(round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5))
    embed_dim = sd["text_projection"].shape[1]
    text_width = sd["ln_final.weight"].shape[0]
    text_layers = len({k.split(".")[2] for k in sd
                       if k.startswith("transformer.resblocks.")})
    return CLIPConfig(
        embed_dim=embed_dim,
        vision=ViTConfig(
            img_size=grid * patch, patch_size=patch, embed_dim=vision_width,
            depth=vision_layers, num_heads=vision_width // 64,
            layerscale_init=None, ln_eps=1e-5, act="quick_gelu"),
        text=TextTransformerConfig(
            vocab_size=sd["token_embedding.weight"].shape[0],
            context_length=sd["positional_embedding"].shape[0],
            width=text_width, heads=text_width // 64, layers=text_layers,
            output_dim=embed_dim, act="quick_gelu"))


def convert_openclip_vit_trunk(sd: Mapping, embed_dim: int, depth: int,
                               prefix: str = "visual.",
                               dst: str = "visual.") -> dict:
    """The open_clip / OpenAI ViT trunk (``conv1``, ``class_embedding``,
    ``positional_embedding``, ``ln_pre``, ``transformer.resblocks.N``) under
    ``prefix`` → the port's ``VisionTransformer`` entries under ``dst``,
    without the final norm and projection (which differ between the CLIP
    and CoCa towers). The bias-free patch conv becomes a ``[D, P·P·3]``
    matmul weight in (ph, pw, c) order with a zero bias."""
    conv = _g(sd, prefix + "conv1.weight")  # [D, 3, P, P]
    out = {dst + "patch_embed.weight":
           conv.permute(0, 2, 3, 1).reshape(embed_dim, -1).contiguous(),
           dst + "patch_embed.bias": torch.zeros(embed_dim),
           dst + "cls_token": _g(sd, prefix + "class_embedding").reshape(
               1, 1, -1),
           dst + "pos_embed": _g(sd, prefix + "positional_embedding")[None],
           dst + "ln_pre.weight": _g(sd, prefix + "ln_pre.weight"),
           dst + "ln_pre.bias": _g(sd, prefix + "ln_pre.bias")}
    names = {"norm1": "ln_1", "norm2": "ln_2", "attn.proj": "attn.out_proj",
             "mlp.fc1": "mlp.c_fc", "mlp.fc2": "mlp.c_proj"}
    for i in range(depth):
        src, d = f"{prefix}transformer.resblocks.{i}.", f"{dst}blocks.{i}."
        out[d + "attn.qkv.weight"] = _g(sd, src + "attn.in_proj_weight")
        out[d + "attn.qkv.bias"] = _g(sd, src + "attn.in_proj_bias")
        for ours, theirs in names.items():
            out[d + ours + ".weight"] = _g(sd, src + theirs + ".weight")
            out[d + ours + ".bias"] = _g(sd, src + theirs + ".bias")
    return out


def convert_openai_clip_visual(sd: Mapping, cfg: ViTConfig) -> dict:
    """The OpenAI ViT tower (the trunk, ``ln_post``, ``proj``) → the port's
    ``visual.*`` entries of a ``CLIP`` built with ``ln_pre=True``."""
    out = convert_openclip_vit_trunk(sd, cfg.embed_dim, cfg.depth)
    out["visual.norm.weight"] = _g(sd, "visual.ln_post.weight")
    out["visual.norm.bias"] = _g(sd, "visual.ln_post.bias")
    out["visual.proj"] = _g(sd, "visual.proj")
    return out


def load_openai_clip(path_or_sd, cfg: CLIPConfig | None = None
                     ) -> tuple[dict, CLIPConfig]:
    """(state dict, config) for ``models.clip.CLIP(cfg, ln_pre=True)`` from
    an OpenAI / open_clip checkpoint: a state dict, or the path of a
    ``torch.save`` file or a TorchScript archive."""
    sd = path_or_sd
    if isinstance(path_or_sd, str):
        try:
            sd = torch.load(path_or_sd, map_location="cpu",
                            weights_only=True)
        except (RuntimeError, pickle.UnpicklingError):
            # every original OpenAI CLIP release is a TorchScript archive,
            # which a weights-only load refuses
            sd = torch.jit.load(path_or_sd, map_location="cpu").state_dict()
        sd = normalize_state_dict(sd)
    if "visual.class_embedding" not in sd and cfg is None:
        # a ModifiedResNet tower (RN50, RN50x4, ...): the reference tells ViT
        # from RN by key presence (model.py build_model)
        raise ValueError(
            "RN-tower OpenAI checkpoint: pass an explicit CLIPConfig and "
            "convert the visual tower via models.resnet.convert_openai_resnet "
            "(this loader's auto-infer covers the ViT towers)")
    cfg = cfg or infer_clip_config(sd)
    out = convert_openai_clip_visual(sd, cfg.vision)
    out.update(convert_openclip_text(sd, cfg.text))
    out["logit_scale"] = _g(sd, "logit_scale").reshape(())
    return out, cfg
