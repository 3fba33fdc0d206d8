"""Composite full-model checkpoint converters: CoCa, PMC-CLIP and KEP
(counterpart of ``keep_tpu/compat/composite.py``).

The reference ships these families as single torch state dicts
(coca_model.py:79-457, model/pmc_clip.py:81-269, the KEP training
checkpoint of main.py:424-431). These loaders take the FULL state dict —
vision tower + text tower + pooler / fusion / decoder heads + scalar
parameters — straight into the state dicts of the port's
``models.coca.CoCa``, ``models.pmc_clip.PMCCLIP`` and ``models.kep.
KEPModel``, reusing the per-tower converters
(``compat.openai.convert_openclip_vit_trunk``,
``models.resnet.convert_openai_resnet``, ``compat.torch_loader``'s timm
ViT and HF BERT ones). Every value is the checkpoint's, sliced or
reshaped, never rounded.

The released-layout quirks go through ``torch_loader.normalize_state_dict``:
DDP ``module.`` prefixes, ``{'state_dict': ...}`` training-checkpoint
wrappers, ``position_ids`` buffers.
"""

from __future__ import annotations

import re
import types
from typing import Mapping

import torch

from keep_tpu_torch.compat.torch_loader import (_hf_bert, _tensor, _timm_vit,
                                                normalize_state_dict)
from keep_tpu_torch.configs import BertConfig, ViTConfig


def _g(sd: Mapping, k: str) -> torch.Tensor:
    return _tensor(sd[k])


def _count_layers(sd: Mapping, pattern: str) -> int:
    rx = re.compile(pattern)
    return len({m.group(1) for m in (rx.match(k) for k in sd) if m})


def _sub(sd: Mapping, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _lin(out: dict, dst: str, sd: Mapping, src: str) -> None:
    out[f"{dst}.weight"] = _g(sd, f"{src}.weight")
    out[f"{dst}.bias"] = _g(sd, f"{src}.bias")


def _resblocks(sd: Mapping, fmt: str, depth: int, dst: str,
               cross: bool = False) -> dict:
    """torch ``ResidualAttentionBlock`` keys (ln_1 / attn.in_proj /
    attn.out_proj / ln_2 / mlp.c_fc / mlp.c_proj [+ ln_1_kv]) → the port's
    blocks ``dst.{i}``. Cross-attention blocks split the fused in_proj into
    q (its first W rows) and kv (the rest), the layout of
    ``models.coca``'s cross blocks."""
    out: dict = {}
    for i in range(depth):
        src, d = fmt.format(i), f"{dst}.{i}"
        inw = _g(sd, src + ".attn.in_proj_weight")  # [3W, W]
        inb = _g(sd, src + ".attn.in_proj_bias")
        if cross:
            w = inw.shape[1]
            out[f"{d}.attn.q.weight"] = inw[:w].contiguous()
            out[f"{d}.attn.q.bias"] = inb[:w].contiguous()
            out[f"{d}.attn.kv.weight"] = inw[w:].contiguous()
            out[f"{d}.attn.kv.bias"] = inb[w:].contiguous()
            _lin(out, f"{d}.norm1_kv", sd, src + ".ln_1_kv")
        else:
            out[f"{d}.attn.qkv.weight"] = inw
            out[f"{d}.attn.qkv.bias"] = inb
        for ours, theirs in (("norm1", "ln_1"), ("attn.proj", "attn.out_proj"),
                             ("norm2", "ln_2"), ("mlp.fc1", "mlp.c_fc"),
                             ("mlp.fc2", "mlp.c_proj")):
            _lin(out, f"{d}.{ours}", sd, f"{src}.{theirs}")
    return out


def _load(path_or_sd) -> dict:
    sd = path_or_sd
    if isinstance(path_or_sd, str):
        sd = torch.load(path_or_sd, map_location="cpu", weights_only=True)
    return normalize_state_dict(sd)


# --------------------------------------------------------------------------
# CoCa
# --------------------------------------------------------------------------


def infer_coca_config(sd: Mapping):
    """Shape-sniff a CoCa state dict. Head counts are not recorded in torch
    state dicts: width // 64 (vision, text, decoder) and 8 for the pooler
    (the open_clip CoCa presets); pass an explicit config when they
    differ."""
    from keep_tpu_torch.models.coca import CoCaConfig

    if "visual.attn_pool.query" not in sd:
        raise ValueError(
            "coca checkpoint without an attentional pooler (the coca_base/"
            "coca_roberta layout) — this converter covers the attn-pool + "
            "CLIP-text layout (coca_ViT-B-32/L-14); build the model via "
            "presets.create_preset and load the towers individually")
    conv = sd["visual.conv1.weight"]
    vw, patch = conv.shape[0], conv.shape[-1]
    vlayers = _count_layers(
        sd, r"visual\.transformer\.resblocks\.(\d+)\.ln_1\.weight")
    grid = int(round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5))
    e = sd["visual.ln_post.weight"].shape[0]
    w = sd["text.ln_final.weight"].shape[0]
    return CoCaConfig(
        embed_dim=e,
        vocab_size=sd["text.token_embedding.weight"].shape[0],
        context_length=sd["text.positional_embedding"].shape[0] - 1,
        text_width=w,
        text_heads=max(1, w // 64),
        text_layers=_count_layers(
            sd, r"text\.transformer\.resblocks\.(\d+)\.ln_1\.weight"),
        decoder_layers=_count_layers(
            sd, r"text_decoder\.resblocks\.(\d+)\.ln_1\.weight"),
        decoder_heads=max(1, w // 64),
        n_queries=sd["visual.attn_pool.query"].shape[0],
        attn_pooler_heads=8,
        vision=ViTConfig(
            img_size=grid * patch, patch_size=patch, embed_dim=vw,
            depth=vlayers, num_heads=max(1, vw // 64), layerscale_init=None,
            ln_eps=1e-5, pool="none"),
    )


def convert_coca_state_dict(sd: Mapping, cfg) -> dict:
    """Full reference CoCa state dict → the state dict of the port's
    ``models.coca.CoCa(cfg)`` (every tower)."""
    from keep_tpu_torch.compat.openai import convert_openclip_vit_trunk

    vw, e = cfg.vision.embed_dim, cfg.embed_dim
    out = convert_openclip_vit_trunk(sd, vw, cfg.vision.depth)
    # the attn-pool tower has no trunk-final LN (transformer.py:489-492):
    # the ViT's ``norm`` is the identity
    out["visual.norm.weight"] = torch.ones(vw)
    out["visual.norm.bias"] = torch.zeros(vw)

    # AttentionalPooler (transformer.py:163-187): torch MHA stores separate
    # q / k / v projections when kdim != embed_dim, a fused in_proj_weight
    # when they match
    ap = "visual.attn_pool.attn."
    if ap + "in_proj_weight" in sd:
        qw, kw, vw_ = _g(sd, ap + "in_proj_weight").split(e)
    else:
        qw, kw, vw_ = (_g(sd, ap + f"{n}_proj_weight") for n in "qkv")
    inb = _g(sd, ap + "in_proj_bias")
    out["attn_pool.query"] = _g(sd, "visual.attn_pool.query")
    _lin(out, "attn_pool.ln_q", sd, "visual.attn_pool.ln_q")
    _lin(out, "attn_pool.ln_k", sd, "visual.attn_pool.ln_k")
    for j, (n, wt) in enumerate((("q", qw), ("k", kw), ("v", vw_))):
        out[f"attn_pool.{n}.weight"] = wt.contiguous()
        out[f"attn_pool.{n}.bias"] = inb[j * e:(j + 1) * e].contiguous()
    _lin(out, "attn_pool.proj", sd, ap + "out_proj")
    _lin(out, "ln_post", sd, "visual.ln_post")
    out["visual_proj"] = _g(sd, "visual.proj")

    out["text.token_embedding"] = _g(sd, "text.token_embedding.weight")
    out["text.pos_embed"] = _g(sd, "text.positional_embedding")
    out["text.cls_emb"] = _g(sd, "text.cls_emb").reshape(-1)
    out.update(_resblocks(sd, "text.transformer.resblocks.{}",
                          cfg.text_layers, "text.blocks"))
    _lin(out, "text.ln_final", sd, "text.ln_final")
    out["text.text_projection"] = _g(sd, "text.text_projection")

    out.update(_resblocks(sd, "text_decoder.resblocks.{}",
                          cfg.decoder_layers, "decoder.self_blocks"))
    out.update(_resblocks(sd, "text_decoder.cross_attn.{}",
                          cfg.decoder_layers, "decoder.cross_blocks",
                          cross=True))
    _lin(out, "decoder.ln_final", sd, "text_decoder.ln_final")
    out["decoder.to_logits"] = _g(sd, "text_decoder.text_projection")
    out["logit_scale"] = _g(sd, "logit_scale").reshape(())
    return out


def load_coca_checkpoint(path_or_sd, cfg=None) -> tuple[dict, object]:
    """(state dict, config) for the port's ``models.coca.CoCa`` from a
    reference CoCa checkpoint (a state dict, a training checkpoint or a
    torch file's path)."""
    sd = _load(path_or_sd)
    cfg = cfg or infer_coca_config(sd)
    return convert_coca_state_dict(sd, cfg), cfg


# --------------------------------------------------------------------------
# PMC-CLIP
# --------------------------------------------------------------------------


def infer_pmc_clip_config(sd: Mapping):
    """Shape-sniff a PMC-CLIP state dict (ModifiedRN50 + HF BERT layout,
    the shipped model_config in model/pmc_clip.py:27-50)."""
    from keep_tpu_torch.models.pmc_clip import PMCCLIPConfig
    from keep_tpu_torch.models.resnet import ModifiedResNetConfig

    w, e = sd["text_projection"].shape
    layers = tuple(
        _count_layers(sd, rf"visual\.layer{i}\.(\d+)\.conv1\.weight")
        for i in (1, 2, 3, 4))
    width = sd["visual.conv1.weight"].shape[0] * 2  # stem conv1 = width//2
    vocab, hidden = sd["text_encoder.embeddings.word_embeddings.weight"].shape
    return PMCCLIPConfig(
        embed_dim=e,
        vision=ModifiedResNetConfig(layers=layers, width=width, output_dim=e,
                                    heads=width * 32 // 64),
        text=BertConfig(
            vocab_size=vocab, hidden_size=hidden,
            num_hidden_layers=_count_layers(
                sd, r"text_encoder\.encoder\.layer\.(\d+)\.output\.dense"
                    r"\.weight"),
            num_attention_heads=max(1, hidden // 64),
            intermediate_size=sd["text_encoder.encoder.layer.0.intermediate"
                                 ".dense.weight"].shape[0],
            max_position_embeddings=sd["text_encoder.embeddings."
                                       "position_embeddings.weight"].shape[0]),
        fusion_layers=_count_layers(
            sd, r"fusion_module\.resblocks\.(\d+)\.ln_1\.weight"),
        mlm="mlm_projection" in sd,
    )


def convert_pmc_clip_state_dict(sd: Mapping, cfg) -> dict:
    """Full reference PMC_CLIP state dict → the state dict of the port's
    ``models.pmc_clip.PMCCLIP(cfg)``."""
    from keep_tpu_torch.models.resnet import convert_openai_resnet

    out = {f"visual.{k}": v for k, v in
           convert_openai_resnet(_sub(sd, "visual."), cfg.vision).items()}
    out.update(_hf_bert(sd, cfg.text, "text_encoder.", "text."))
    out["text_projection"] = _g(sd, "text_projection")
    out["img_special_token"] = _g(sd, "img_special_token")
    out.update(_resblocks(sd, "fusion_module.resblocks.{}",
                          cfg.fusion_layers, "fusion"))
    out["logit_scale"] = _g(sd, "logit_scale").reshape(())
    if cfg.mlm and "mlm_projection" in sd:
        out["mlm_projection"] = _g(sd, "mlm_projection")
    return out


def load_pmc_clip_checkpoint(path_or_sd, cfg=None) -> tuple[dict, object]:
    """(state dict, config) for the port's ``models.pmc_clip.PMCCLIP`` from
    a reference PMC_CLIP checkpoint (a state dict, a training checkpoint or
    a file's path)."""
    sd = _load(path_or_sd)
    cfg = cfg or infer_pmc_clip_config(sd)
    return convert_pmc_clip_state_dict(sd, cfg), cfg


# --------------------------------------------------------------------------
# KEP (the training-time model the reference's main.py checkpoints)
# --------------------------------------------------------------------------


def infer_kep_config(sd: Mapping):
    """Shape-sniff a KEP training checkpoint (the timm-ViT 'uni' image
    encoder, the KEEP config path, factory.py:211-217)."""
    from keep_tpu_torch.models.kep import KEPConfig

    conv = sd["visual.patch_embed.proj.weight"]  # [D, 3, P, P]
    vw, patch = conv.shape[0], conv.shape[-1]
    depth = _count_layers(sd, r"visual\.blocks\.(\d+)\.norm1\.weight")
    grid = int(round((sd["visual.pos_embed"].shape[1] - 1) ** 0.5))
    ls = 1e-5 if "visual.blocks.0.ls1.gamma" in sd else None
    e = sd["text.mlp_embed.0.weight"].shape[0]
    b = "text.bert_model."
    vocab, hidden = sd[b + "embeddings.word_embeddings.weight"].shape
    return KEPConfig(
        vision=ViTConfig(img_size=grid * patch, patch_size=patch,
                         embed_dim=vw, depth=depth,
                         num_heads=max(1, vw // 64), layerscale_init=ls),
        text=BertConfig(
            vocab_size=vocab, hidden_size=hidden,
            num_hidden_layers=_count_layers(
                sd, r"text\.bert_model\.encoder\.layer\.(\d+)\.output\.dense"
                    r"\.weight"),
            num_attention_heads=max(1, hidden // 64),
            intermediate_size=sd[b + "encoder.layer.0.intermediate.dense."
                                 "weight"].shape[0],
            max_position_embeddings=sd[b + "embeddings.position_embeddings."
                                       "weight"].shape[0]),
        embed_dim=e,
        visual_embedding_head="visual_head.0.weight" in sd,
        text_embedding_head="text_head.0.weight" in sd,
        with_knowledge="knowledge.mlp_embed.0.weight" in sd,
    )


def _mlp_head(out: dict, dst: str, sd: Mapping, src: str) -> None:
    """torch ``nn.Sequential(Linear, GELU, Linear)`` (the KEP heads, the
    path-BERT ``mlp_embed``; model.py:295-313, knowledge_bert.py:25-29) →
    the port's ``fc1`` / ``fc2``."""
    _lin(out, f"{dst}.fc1", sd, f"{src}.0")
    _lin(out, f"{dst}.fc2", sd, f"{src}.2")


def convert_kep_state_dict(sd: Mapping, cfg) -> dict:
    """Full reference KEP training state dict (main.py:424-431 layout after
    ``normalize_state_dict``) → the state dict of the port's
    ``models.kep.KEPModel(cfg)``."""
    out = _timm_vit(sd, types.SimpleNamespace(vision=cfg.vision), "visual.")

    def path_bert(tower: str) -> None:
        out.update(_hf_bert(sd, cfg.text, f"{tower}.bert_model.",
                            f"{tower}.bert."))
        _mlp_head(out, f"{tower}.mlp_embed", sd, f"{tower}.mlp_embed")

    path_bert("text")
    out["logit_scale"] = _g(sd, "logit_scale").reshape(())
    if cfg.visual_embedding_head and "visual_head.0.weight" in sd:
        _mlp_head(out, "visual_head", sd, "visual_head")
    if cfg.text_embedding_head and "text_head.0.weight" in sd:
        _mlp_head(out, "text_head", sd, "text_head")
    if cfg.with_knowledge and "knowledge.mlp_embed.0.weight" in sd:
        path_bert("knowledge")
    return out


def load_kep_checkpoint(path_or_sd, cfg=None) -> tuple[dict, object]:
    """(state dict, config) for the port's ``models.kep.KEPModel`` from a
    reference KEP training checkpoint (``{epoch, name, state_dict}``, a
    bare state dict or a torch file's path; DDP prefixes handled)."""
    sd = _load(path_or_sd)
    cfg = cfg or infer_kep_config(sd)
    return convert_kep_state_dict(sd, cfg), cfg
