"""OpenCLIP's causal text tower (counterpart of
``keep_tpu/models/text_transformer.py``; the reference's fused text tower
of ``CLIP``, training/path_open_clip/transformer.py:506-631).

Token embedding + learned positions, pre-LN blocks without LayerScale,
causal attention (a full score-level mask, so the plain ``mha_attention``
serves it, as the JAX package's ``use_flash=False`` path does), a final
LayerNorm, pooling at the ARGMAX token id (the EOT token has the highest
id of the CLIP vocabulary), then the ``text_projection`` matrix.

The ``CustomResidualAttentionBlock`` options (transformer.py:246-285) are
carried as in the JAX package: ``scaled_cosine`` (cosine attention with a
learned per-head temperature, ``attn.logit_scale``), ``scale_heads`` (a
per-head output gain, ``attn.head_scale``), ``scale_attn`` (a LayerNorm on
the attention output, ``ln_attn``) and ``scale_fc`` (a LayerNorm after fc1,
``mlp.ln``).

Parameter names follow the JAX pytree; linear weights are torch-layout
``[out, in]``, ``token_embedding`` [V, W], ``pos_embed`` [CTX, W] and
``text_projection`` [W, E] as there.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import numpy as np
import torch
from torch import nn

from keep_tpu_torch.ops.nn import (LayerNorm, Linear, Mlp, cosine_attention,
                                   gelu, mha_attention, quick_gelu)


@dataclasses.dataclass(frozen=True)
class TextTransformerConfig:
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 512
    heads: int = 8
    layers: int = 12
    mlp_ratio: float = 4.0
    output_dim: int = 512
    ln_eps: float = 1e-5
    act: str = "gelu"  # 'gelu' | 'quick_gelu' (OpenAI '-quickgelu' arches)
    scaled_cosine: bool = False
    scale_heads: bool = False
    scale_attn: bool = False
    scale_fc: bool = False

    @property
    def head_dim(self) -> int:
        return self.width // self.heads

    @property
    def mlp_dim(self) -> int:
        return int(self.width * self.mlp_ratio)


class TextAttention(nn.Module):
    def __init__(self, cfg: TextTransformerConfig, *, device=None):
        super().__init__()
        w = cfg.width
        self.qkv = Linear(w, 3 * w, device=device)
        self.proj = Linear(w, w, device=device)
        self.logit_scale = (nn.Parameter(torch.zeros(cfg.heads, device=device))
                            if cfg.scaled_cosine else None)
        self.head_scale = (nn.Parameter(torch.ones(cfg.heads, device=device))
                           if cfg.scale_heads else None)


class TextMlp(Mlp):
    """fc1 → act → fc2, with ``scale_fc``'s LayerNorm ``ln`` after fc1."""

    def __init__(self, cfg: TextTransformerConfig, *, device=None):
        super().__init__(cfg.width, cfg.mlp_dim, act=cfg.act, device=device)
        self.ln = (LayerNorm(cfg.mlp_dim, cfg.ln_eps, device=device)
                   if cfg.scale_fc else None)

    def forward(self, x: torch.Tensor, gelu_approx: bool = False
                ) -> torch.Tensor:
        if self.ln is None:
            return super().forward(x)
        hid = self.ln(self.fc1(x))
        return self.fc2(quick_gelu(hid) if self.act == "quick_gelu"
                        else gelu(hid))


class TextBlock(nn.Module):
    def __init__(self, cfg: TextTransformerConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.norm1 = LayerNorm(cfg.width, cfg.ln_eps, device=device)
        self.attn = TextAttention(cfg, device=device)
        self.ln_attn = (LayerNorm(cfg.width, cfg.ln_eps, device=device)
                        if cfg.scale_attn else None)
        self.norm2 = LayerNorm(cfg.width, cfg.ln_eps, device=device)
        self.mlp = TextMlp(cfg, device=device)

    def forward(self, x: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        h = self.cfg.heads
        q, k, v = self.attn.qkv(self.norm1(x)).reshape(
            b, s, 3, h, d // h).permute(2, 0, 3, 1, 4)
        if self.attn.logit_scale is not None:
            attn = cosine_attention(q, k, v, self.attn.logit_scale,
                                    bias=causal,
                                    head_scale=self.attn.head_scale)
        else:
            attn = mha_attention(q, k, v, bias=causal)
            if self.attn.head_scale is not None:
                attn = attn * self.attn.head_scale.reshape(1, -1, 1, 1).to(
                    attn.dtype)
        attn = self.attn.proj(attn.transpose(1, 2).reshape(b, s, d))
        if self.ln_attn is not None:
            attn = self.ln_attn(attn)
        x = x + attn
        return x + self.mlp(self.norm2(x))


class TextTransformer(nn.Module):
    def __init__(self, cfg: TextTransformerConfig, *, device=None):
        super().__init__()
        w = cfg.width
        self.cfg = cfg
        self.token_embedding = nn.Parameter(
            torch.zeros(cfg.vocab_size, w, device=device))
        self.pos_embed = nn.Parameter(
            torch.zeros(cfg.context_length, w, device=device))
        self.blocks = nn.ModuleList(
            TextBlock(cfg, device=device) for _ in range(cfg.layers))
        self.ln_final = LayerNorm(w, cfg.ln_eps, device=device)
        self.text_projection = nn.Parameter(
            torch.zeros(w, cfg.output_dim, device=device))

    def forward(self, input_ids: torch.Tensor, *,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """[B, S] BPE token ids → [B, output_dim] features, pooled at each
        row's highest id (EOT) and projected, in ``dtype``."""
        b, s = input_ids.shape
        ids = input_ids.to(self.token_embedding.device)
        x = self.token_embedding[ids].to(dtype) + self.pos_embed[:s].to(dtype)
        causal = torch.triu(torch.full((s, s), -1e9, device=x.device),
                            diagonal=1)[None, None]
        for blk in self.blocks:
            x = blk(x, causal)
        x = self.ln_final(x)
        pooled = x[torch.arange(b, device=x.device), ids.argmax(dim=-1)]
        # one rounding of an fp32 sum, as jnp.dot(...,
        # preferred_element_type=float32).astype(dtype)
        return torch.matmul(pooled, self.text_projection.to(pooled.dtype))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "TextTransformer":
        """Draws the weights in place from ``generator`` with the JAX
        package's ``text_transformer.init`` statistics (the reference's
        ``TextTransformer.init_parameters`` stds, transformer.py:557-567):
        qkv std W^-0.5, the residual-out projections W^-0.5·(2L)^-0.5, fc1
        (2W)^-0.5, token embedding .02, positions .01, text projection
        W^-0.5; zero biases, unit LayerNorms, per-head temperatures at
        log 10 and head gains at 1. Returns the tower."""
        cfg = self.cfg
        w = cfg.width
        proj_std = w ** -0.5 * (2 * cfg.layers) ** -0.5
        stds = {"attn.qkv": w ** -0.5, "attn.proj": proj_std,
                "mlp.fc1": (2 * w) ** -0.5, "mlp.fc2": proj_std}
        for blk in self.blocks:
            for name, std in stds.items():
                lin = blk.get_submodule(name)
                lin.weight.normal_(0.0, std, generator=generator)
                lin.bias.zero_()
            for m in blk.modules():
                if isinstance(m, LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
            if blk.attn.logit_scale is not None:
                blk.attn.logit_scale.fill_(math.log(10.0))
            if blk.attn.head_scale is not None:
                blk.attn.head_scale.fill_(1.0)
        self.token_embedding.normal_(0.0, 0.02, generator=generator)
        self.pos_embed.normal_(0.0, 0.01, generator=generator)
        self.ln_final.weight.fill_(1.0)
        self.ln_final.bias.zero_()
        self.text_projection.normal_(0.0, w ** -0.5, generator=generator)
        return self


def convert_openclip_text(sd: Mapping, cfg: TextTransformerConfig,
                          prefix: str = "text.") -> dict:
    """An OpenCLIP / OpenAI text-tower state dict (``token_embedding.weight``,
    ``positional_embedding``, ``transformer.resblocks.N.*``, ``ln_final.*``,
    ``text_projection``; the custom block's ``attn.logit_scale``,
    ``attn.head_scale``, ``ln_attn.*`` and ``mlp.ln.*`` when present) → the
    port's ``TextTransformer`` entries under ``prefix``."""
    def g(k: str) -> torch.Tensor:
        v = sd[k]
        return (v.detach().cpu().float() if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.array(v, np.float32)))

    out = {prefix + "token_embedding": g("token_embedding.weight"),
           prefix + "pos_embed": g("positional_embedding"),
           prefix + "ln_final.weight": g("ln_final.weight"),
           prefix + "ln_final.bias": g("ln_final.bias"),
           prefix + "text_projection": g("text_projection")}
    names = {"norm1": "ln_1", "norm2": "ln_2", "attn.qkv": "attn.in_proj",
             "attn.proj": "attn.out_proj", "mlp.fc1": "mlp.c_fc",
             "mlp.fc2": "mlp.c_proj", "ln_attn": "ln_attn", "mlp.ln": "mlp.ln"}
    for i in range(cfg.layers):
        src, dst = f"transformer.resblocks.{i}.", f"{prefix}blocks.{i}."
        for ours, theirs in names.items():
            if theirs == "attn.in_proj":
                out[dst + "attn.qkv.weight"] = g(src + "attn.in_proj_weight")
                out[dst + "attn.qkv.bias"] = g(src + "attn.in_proj_bias")
            elif src + theirs + ".weight" in sd:
                out[dst + ours + ".weight"] = g(src + theirs + ".weight")
                out[dst + ours + ".bias"] = g(src + theirs + ".bias")
        for extra in ("attn.logit_scale", "attn.head_scale"):
            if src + extra in sd:
                out[dst + extra] = g(src + extra).reshape(-1)
    return out
