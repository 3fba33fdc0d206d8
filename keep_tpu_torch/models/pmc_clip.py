"""PMC-CLIP: the RN50 image tower, a BERT text encoder and an image-text
fusion module with an MLM head (counterpart of
``keep_tpu/models/pmc_clip.py``; the reference's pmc_clip.py:81-269).

- image features: the ModifiedResNet tower (``models.resnet``);
- text features: BERT's last hidden state at the first ``[CLS]`` id
  (PubMedBERT's, ``cls_id``) @ ``text_projection``. The text is encoded
  WITHOUT its mask, as the reference does (pads attend,
  pmc_clip.py:217-221): under ``use_flash`` the tower runs #1 with a zero
  key bias;
- fusion: [text tokens, ``img_special_token``, the image feature] through
  ``fusion_layers`` pre-LN blocks (plain attention, as in the JAX
  package), the two image slots dropped;
- MLM head: log-softmax(fused @ ``mlm_projection``), and ``mlm_loss``.

Parameter names follow the JAX pytree (``fusion.{i}``, ``text.blocks.{i}``,
``visual.layer1.{i}``, ...); the raw matrices keep the JAX layout.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from keep_tpu_torch.configs import BertConfig
from keep_tpu_torch.models.bert import BertModel
from keep_tpu_torch.models.coca import AttnBlock, _dot
from keep_tpu_torch.models.resnet import ModifiedResNet, ModifiedResNetConfig
from keep_tpu_torch.ops.nn import (LayerNorm, Linear, cast_linear_weights,
                                   l2_normalize)


@dataclasses.dataclass(frozen=True)
class PMCCLIPConfig:
    embed_dim: int = 768
    vision: ModifiedResNetConfig = dataclasses.field(
        default_factory=lambda: ModifiedResNetConfig(output_dim=768))
    text: BertConfig = dataclasses.field(default_factory=BertConfig)
    fusion_layers: int = 4
    fusion_heads: int = 8
    context_length: int = 77
    cls_id: int = 2  # PubMedBERT [CLS]
    mlm: bool = True
    ln_eps: float = 1e-5
    mlp_ratio: float = 4.0


class PMCCLIP(nn.Module):
    """The PMC-CLIP model; ``dtype`` is the compute dtype, in which the
    linear and conv weights are stored."""

    family = "pmc_clip"

    def __init__(self, cfg: PMCCLIPConfig, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if cfg.embed_dim != cfg.text.hidden_size:
            # the fusion stream concatenates text hidden states, the special
            # token and the image feature at one width (pmc_clip.py:227-231)
            raise ValueError(
                f"PMC-CLIP requires embed_dim ({cfg.embed_dim}) == "
                f"text.hidden_size ({cfg.text.hidden_size})")
        self.cfg, self.dtype = cfg, dtype
        w = cfg.text.hidden_size
        self.visual = ModifiedResNet(cfg.vision, device=device)
        self.text = BertModel(cfg.text, device=device)
        self.text_projection = nn.Parameter(torch.zeros(w, cfg.embed_dim,
                                                        device=device))
        self.img_special_token = nn.Parameter(
            torch.zeros(1, 1, cfg.embed_dim, device=device))
        self.fusion = nn.ModuleList(
            AttnBlock(w, cfg.mlp_ratio, cfg.ln_eps, device=device)
            for _ in range(cfg.fusion_layers))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07),
                                                     device=device))
        self.mlm_projection = (nn.Parameter(torch.zeros(
            w, cfg.text.vocab_size, device=device)) if cfg.mlm else None)
        cast_linear_weights(self, dtype)

    @property
    def config(self) -> PMCCLIPConfig:
        return self.cfg

    @property
    def device(self) -> torch.device:
        return self.logit_scale.device

    def encode_image(self, pixels: torch.Tensor, *,
                     dtype: torch.dtype | None = None) -> torch.Tensor:
        """[B, H, W, 3] normalised pixels → [B, embed_dim] (unnormalised)."""
        return self.visual(pixels.to(self.device), dtype=dtype or self.dtype)

    def encode_text(self, input_ids: torch.Tensor,
                    attention_mask: torch.Tensor | None,
                    image_features: torch.Tensor, *,
                    dtype: torch.dtype | None = None,
                    use_flash: bool = False) -> dict:
        """→ {"text_features": [B, E] unnormalised, "bert_prediction":
        MLM log-probs [B, S, V] fp32, or None}. ``attention_mask`` is taken
        for the uniform signature and not applied (reference parity: pads
        attend). ``use_flash`` runs the BERT tower through #1."""
        del attention_mask
        cfg = self.cfg
        dtype = dtype or self.dtype
        ids = input_ids.to(self.device)
        hidden = self.text(ids, None, dtype=dtype,
                           use_flash=use_flash)["last_hidden_state"]
        b, _, w = hidden.shape
        # features at the first [CLS] (pmc_clip.py:222-224)
        cls_pos = torch.argmax((ids == cfg.cls_id).int(), dim=1)
        pooled = hidden[torch.arange(b, device=ids.device), cls_pos]
        text_features = _dot(pooled, self.text_projection).to(dtype)
        img = image_features[:, None, :].to(self.device, dtype)
        special = self.img_special_token.to(dtype).expand(b, 1, w)
        x = torch.cat([hidden.to(dtype), special, img], dim=1)
        for blk in self.fusion:
            x = blk(x, None, cfg.fusion_heads)
        x = x[:, :-2]  # drop the special token and the image
        pred = None
        if cfg.mlm and self.mlm_projection is not None:
            pred = torch.log_softmax(_dot(x, self.mlm_projection), dim=-1)
        return {"text_features": text_features, "bert_prediction": pred}

    def forward(self, pixels: torch.Tensor, input_ids: torch.Tensor,
                attention_mask: torch.Tensor | None = None, *,
                dtype: torch.dtype | None = None,
                use_flash: bool = False) -> dict:
        image_features = l2_normalize(
            self.encode_image(pixels, dtype=dtype).float())
        out = self.encode_text(input_ids, attention_mask, image_features,
                               dtype=dtype, use_flash=use_flash)
        return {"image_features": image_features,
                "text_features": l2_normalize(out["text_features"].float()),
                "bert_prediction": out["bert_prediction"],
                "logit_scale": self.logit_scale.exp()}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "PMCCLIP":
        """The JAX ``pmc_clip.init`` statistics: the RN and BERT towers'
        inits, the fusion blocks' linear weights std fan_in^-0.5 with zero
        biases and unit LayerNorms, the projections std width^-0.5, a zero
        ``img_special_token``, ``logit_scale = log(1 / 0.07)``."""
        self.visual.init_weights(generator)
        self.text.init_weights(generator)
        for m in self.fusion.modules():
            if isinstance(m, Linear):
                m.weight.normal_(0.0, m.weight.shape[1] ** -0.5,
                                 generator=generator)
                m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for w in (self.text_projection, self.mlm_projection):
            if w is not None:
                w.normal_(0.0, w.shape[0] ** -0.5, generator=generator)
        self.img_special_token.zero_()
        self.logit_scale.fill_(math.log(1 / 0.07))
        return self

    @classmethod
    def init(cls, cfg: PMCCLIPConfig, generator: torch.Generator, *,
             dtype: torch.dtype = torch.float32, device=None) -> "PMCCLIP":
        model = cls(cfg, device=device)
        model.init_weights(generator)
        cast_linear_weights(model, dtype)
        model.dtype = dtype
        return model


def mlm_loss(bert_prediction: torch.Tensor, labels: torch.Tensor,
             ignore_id: int = 0) -> torch.Tensor:
    """Masked-LM NLL over the non-``ignore_id`` label positions."""
    ll = torch.gather(bert_prediction, -1, labels[..., None].long())[..., 0]
    mask = (labels != ignore_id).float()
    return -(ll * mask).sum() / mask.sum().clamp_min(1.0)
