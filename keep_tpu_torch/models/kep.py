"""KEP, the knowledge-enhanced pretraining model (counterpart of
``keep_tpu/models/kep.py``; the reference's model/model.py:258-376 and
knowledge_bert.py:17-65).

An image tower (``vit``: the ViT; ``rn_clip``: the ModifiedResNet;
``res_ssl``: the torchvision ResNet-50 trunk, globally pooled), a
PATH_BERT text tower (BERT's tanh pooler, then ``mlp_embed``: Linear →
exact GELU → Linear, init std embed_dim^-0.5), optional visual / text MLP
heads (init std .01), a third PATH_BERT **knowledge** tower, and
``logit_scale`` = ln(1 / 0.04).

The ``res_ssl`` trunk has no init of its own (it loads lunit's SSL
weights, model.py:283-285): ``KEPModel.init`` leaves ``visual`` an empty
placeholder, as the JAX package's ``init`` does, and ``install_res_ssl``
puts a converted torchvision checkpoint in its place.

Module names follow the JAX pytree (``visual``, ``visual_head``,
``text.bert``, ``text.mlp_embed``, ``text_head``, ``knowledge``,
``logit_scale``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import torch
from torch import nn

from keep_tpu_torch.configs import BertConfig, ViTConfig
from keep_tpu_torch.models.bert import BertModel
from keep_tpu_torch.models.resnet import (ModifiedResNet,
                                          ModifiedResNetConfig, ResNetTrunk,
                                          convert_torchvision_resnet,
                                          resnet_trunk_pooled)
from keep_tpu_torch.models.vit import VisionTransformer, init_vit_weights
from keep_tpu_torch.ops.nn import (Linear, cast_linear_weights, gelu,
                                   l2_normalize)


@dataclasses.dataclass(frozen=True)
class KEPConfig:
    vision: ViTConfig = dataclasses.field(default_factory=ViTConfig)
    text: BertConfig = dataclasses.field(default_factory=BertConfig)
    embed_dim: int = 768  # TEXT_EMBED_DIM in keep_config.yml
    image_encoder: str = "vit"  # 'vit' | 'res_ssl' | 'rn_clip'
    vision_rn: Optional[ModifiedResNetConfig] = None  # for 'rn_clip'
    visual_embedding_head: bool = True
    text_embedding_head: bool = False
    with_knowledge: bool = True
    logit_scale_init: float = 0.04

    @property
    def rn_config(self) -> ModifiedResNetConfig:
        return self.vision_rn or ModifiedResNetConfig(
            output_dim=self.vision.embed_dim)


class MlpHead(nn.Module):
    """Linear → exact GELU → Linear (``mlp_embed`` and the optional heads)."""

    def __init__(self, fin: int, d: int, *, device=None):
        super().__init__()
        self.fc1 = Linear(fin, d, device=device)
        self.fc2 = Linear(d, d, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, std: float) -> None:
        for lin in (self.fc1, self.fc2):
            lin.weight.normal_(0.0, std, generator=generator)
            lin.bias.zero_()


class PathBert(nn.Module):
    """PATH_BERT: BERT, then ``mlp_embed`` on its pooler output."""

    def __init__(self, cfg: BertConfig, embed_dim: int, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.bert = BertModel(cfg, device=device)
        self.mlp_embed = MlpHead(cfg.hidden_size, embed_dim, device=device)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor | None = None, *,
                dtype: torch.dtype = torch.float32,
                use_flash: bool = False) -> torch.Tensor:
        return path_bert_encode(self, input_ids, attention_mask, dtype=dtype,
                                use_flash=use_flash)


def path_bert_encode(tower: PathBert, input_ids: torch.Tensor,
                     attention_mask: torch.Tensor | None = None, *,
                     dtype: torch.dtype = torch.float32,
                     use_flash: bool = False) -> torch.Tensor:
    """PATH_BERT.encode_text (knowledge_bert.py:56-60): the pooler output
    through ``mlp_embed``, unnormalised."""
    out = tower.bert(input_ids, attention_mask, dtype=dtype,
                     use_flash=use_flash)
    return tower.mlp_embed(out["pooler_output"])


class KEPModel(nn.Module):
    """``dtype`` is the compute dtype; the linear and conv weights are
    stored in it."""

    family = "kep"

    def __init__(self, cfg: KEPConfig, *, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.embed_dim
        if cfg.image_encoder == "vit":
            self.visual = VisionTransformer(cfg.vision, device=device)
            vis_dim = cfg.vision.embed_dim
        elif cfg.image_encoder == "rn_clip":
            self.visual = ModifiedResNet(cfg.rn_config, device=device)
            vis_dim = cfg.rn_config.output_dim
        elif cfg.image_encoder == "res_ssl":
            self.visual = nn.Module()  # the trunk comes from a checkpoint
            vis_dim = 2048  # RN50's pooled width
        else:
            raise ValueError(f"unknown image_encoder {cfg.image_encoder!r}")
        self.visual_head = (MlpHead(vis_dim, d, device=device)
                            if cfg.visual_embedding_head else None)
        self.text = PathBert(cfg.text, d, device=device)
        self.text_head = (MlpHead(d, d, device=device)
                          if cfg.text_embedding_head else None)
        self.knowledge = (PathBert(cfg.text, d, device=device)
                          if cfg.with_knowledge else None)
        self.logit_scale = nn.Parameter(torch.tensor(
            math.log(1 / cfg.logit_scale_init), device=device))
        cast_linear_weights(self, dtype)

    @property
    def config(self) -> KEPConfig:
        return self.cfg

    def encode_image(self, pixels: torch.Tensor, *, normalize: bool = False,
                     dtype: torch.dtype | None = None,
                     use_flash: bool = False) -> torch.Tensor:
        """[B, H, W, 3] normalised pixels → [B, embed_dim] (the visual
        head's output; the tower's own width without one)."""
        dtype = dtype or self.dtype
        x = pixels.to(self.logit_scale.device)
        kind = self.cfg.image_encoder
        if kind == "vit":
            feats = self.visual(x, dtype=dtype, use_flash=use_flash)
        elif kind == "rn_clip":
            feats = self.visual(x, dtype=dtype)
        elif isinstance(self.visual, ResNetTrunk):
            feats = resnet_trunk_pooled(self.visual, x, dtype=dtype)
        else:
            raise ValueError(
                "the res_ssl trunk is not installed: load a torchvision "
                "ResNet-50 checkpoint with kep.install_res_ssl")
        if self.visual_head is not None:
            feats = self.visual_head(feats)
        return l2_normalize(feats.float()) if normalize else feats

    def encode_text(self, input_ids: torch.Tensor,
                    attention_mask: torch.Tensor | None = None, *,
                    normalize: bool = False, dtype: torch.dtype | None = None,
                    use_flash: bool = False) -> torch.Tensor:
        x = self.text(input_ids.to(self.logit_scale.device),
                      _device(attention_mask, self.logit_scale),
                      dtype=dtype or self.dtype, use_flash=use_flash)
        if self.text_head is not None:
            x = self.text_head(x)
        return l2_normalize(x.float()) if normalize else x

    def encode_knowledge(self, input_ids: torch.Tensor,
                         attention_mask: torch.Tensor | None = None, *,
                         normalize: bool = False,
                         dtype: torch.dtype | None = None,
                         use_flash: bool = False) -> torch.Tensor:
        if self.knowledge is None:
            raise ValueError("this KEP has no knowledge tower "
                             "(with_knowledge=False)")
        x = self.knowledge(input_ids.to(self.logit_scale.device),
                           _device(attention_mask, self.logit_scale),
                           dtype=dtype or self.dtype, use_flash=use_flash)
        return l2_normalize(x.float()) if normalize else x

    def forward(self, pixels: torch.Tensor | None = None,
                input_ids: torch.Tensor | None = None,
                attention_mask: torch.Tensor | None = None, **kw) -> dict:
        """The towers' unit features that the inputs allow, with
        exp(logit_scale); ``kw`` (``dtype``, ``use_flash``) go to each."""
        out = {"logit_scale": self.logit_scale.exp()}
        if pixels is not None:
            out["image_features"] = self.encode_image(pixels, normalize=True,
                                                      **kw)
        if input_ids is not None:
            out["text_features"] = self.encode_text(
                input_ids, attention_mask, normalize=True, **kw)
            if self.knowledge is not None:
                out["knowledge_features"] = self.encode_knowledge(
                    input_ids, attention_mask, normalize=True, **kw)
        return out

    @classmethod
    @torch.no_grad()
    def init(cls, cfg: KEPConfig, generator: torch.Generator, *,
             dtype: torch.dtype = torch.float32, device=None) -> "KEPModel":
        """A KEP drawn from ``generator`` with the JAX package's
        ``kep.init`` statistics: the ViT's / ModifiedResNet's / BERT's
        inits, ``mlp_embed`` std embed_dim^-0.5, the other heads std .01,
        zero biases; ``res_ssl`` stays an empty placeholder."""
        model = cls(cfg, device=device)
        if cfg.image_encoder == "vit":
            init_vit_weights(model.visual, generator)
        elif cfg.image_encoder == "rn_clip":
            model.visual.init_weights(generator)
        for tower in (model.text, model.knowledge):
            if tower is not None:
                tower.bert.init_weights(generator)
                tower.mlp_embed.init_weights(generator, cfg.embed_dim ** -0.5)
        for head in (model.visual_head, model.text_head):
            if head is not None:
                head.init_weights(generator, 0.01)
        cast_linear_weights(model, dtype)
        model.dtype = dtype
        return model.eval()


def _device(mask: torch.Tensor | None, like: torch.Tensor):
    return None if mask is None else mask.to(like.device)


@torch.no_grad()
def install_res_ssl(model: KEPModel, sd: Mapping) -> KEPModel:
    """Puts the torchvision ResNet-50 trunk of ``sd`` (a torchvision state
    dict; ``fc`` ignored) in a ``res_ssl`` KEP's ``visual`` placeholder,
    its weights stored in the model's dtype. Returns ``model``."""
    trunk_sd = {k: v for k, v in sd.items() if not k.startswith("fc.")}
    device = model.logit_scale.device
    trunk = ResNetTrunk.for_state_dict(trunk_sd, device=device)
    trunk.load_state_dict(convert_torchvision_resnet(trunk_sd, trunk.layers))
    cast_linear_weights(trunk, model.dtype)
    model.visual = trunk.eval()
    return model


@torch.no_grad()
def load_knowledge_bert(model: KEPModel, torch_path: str,
                        into: str = "text") -> KEPModel:
    """Loads a knowledge-BERT checkpoint (``bert_model.*`` / ``mlp_embed.*``,
    factory.py:200-208) into the text or knowledge tower in place; returns
    ``model``."""
    from keep_tpu_torch.compat.torch_loader import (_hf_bert, _tensor,
                                                    normalize_state_dict)

    sd = normalize_state_dict(torch.load(torch_path, map_location="cpu",
                                         weights_only=True))
    bert = {k[len("bert_model."):]: v for k, v in sd.items()
            if k.startswith("bert_model.")}
    tower_sd = _hf_bert(bert, model.cfg.text, "", "bert.")
    for ours, theirs in (("fc1", "0"), ("fc2", "2")):
        for leaf in ("weight", "bias"):
            tower_sd[f"mlp_embed.{ours}.{leaf}"] = _tensor(
                sd[f"mlp_embed.{theirs}.{leaf}"])
    getattr(model, into).load_state_dict(tower_sd, strict=True)
    return model
