"""ConvNeXt image tower (counterpart of ``keep_tpu/models/convnext.py``;
the reference's ``convnext_*`` presets, which delegate to timm).

Per block: a 7×7 depthwise conv (``groups=C``, padding 3), a channel-last
LayerNorm, fc1 (4× expand), exact GELU, fc2, the LayerScale ``gamma`` and
the residual. Stages are separated by a LayerNorm and a 2×2 stride-2 conv;
the stem is a 4×4 stride-4 conv and a LayerNorm. The trunk's output (timm
``num_classes=0``): a global average pool, then the final LayerNorm →
[B, dims[-1]]; ``pool=False`` returns the last [B, H/32, W/32, C] map.

Activations are NHWC; the convs add their bias in the activation dtype
after one rounding of the product (``ops.nn.conv2d``), fc1 / fc2 are
``ops.nn.Linear`` (fp32 accumulation, fp32 bias, one rounding), and
LayerNorms run in fp32, as in the JAX package. Parameter names follow its
pytree (``stem.conv``, ``stages.{s}.blocks.{i}.dwconv``, ``down_norm``,
``down_conv``, ...).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch
from torch import nn

from keep_tpu_torch.compat.torch_loader import _tensor
from keep_tpu_torch.ops.nn import Conv2d, LayerNorm, Linear, gelu


@dataclasses.dataclass(frozen=True)
class ConvNeXtConfig:
    img_size: int = 224
    depths: Sequence[int] = (3, 3, 9, 3)
    dims: Sequence[int] = (96, 192, 384, 768)
    ls_init: float | None = 1e-6
    ln_eps: float = 1e-6

    @property
    def num_features(self) -> int:
        return self.dims[-1]


class Block(nn.Module):
    def __init__(self, dim: int, cfg: ConvNeXtConfig, *, device=None):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 7, padding=3, groups=dim,
                             device=device)
        self.norm = LayerNorm(dim, cfg.ln_eps, device=device)
        self.fc1 = Linear(dim, 4 * dim, device=device)
        self.fc2 = Linear(4 * dim, dim, device=device)
        self.gamma = (nn.Parameter(torch.full((dim,), cfg.ls_init,
                                              device=device))
                      if cfg.ls_init is not None else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.fc2(gelu(self.fc1(self.norm(self.dwconv(x)))))
        if self.gamma is not None:
            y = y * self.gamma.to(y.dtype)
        return x + y


class Stage(nn.Module):
    def __init__(self, s: int, cfg: ConvNeXtConfig, *, device=None):
        super().__init__()
        dim = cfg.dims[s]
        if s > 0:
            self.down_norm = LayerNorm(cfg.dims[s - 1], cfg.ln_eps,
                                       device=device)
            self.down_conv = Conv2d(cfg.dims[s - 1], dim, 2, stride=2,
                                    device=device)
        else:
            self.down_norm = self.down_conv = None
        self.blocks = nn.ModuleList(Block(dim, cfg, device=device)
                                    for _ in range(cfg.depths[s]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.down_conv is not None:
            x = self.down_conv(self.down_norm(x))
        for blk in self.blocks:
            x = blk(x)
        return x


class Stem(nn.Module):
    def __init__(self, dim: int, eps: float, *, device=None):
        super().__init__()
        self.conv = Conv2d(3, dim, 4, stride=4, device=device)
        self.norm = LayerNorm(dim, eps, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.conv(x))


class ConvNeXt(nn.Module):
    def __init__(self, cfg: ConvNeXtConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.stem = Stem(cfg.dims[0], cfg.ln_eps, device=device)
        self.stages = nn.ModuleList(Stage(s, cfg, device=device)
                                    for s in range(len(cfg.depths)))
        self.norm = LayerNorm(cfg.num_features, cfg.ln_eps, device=device)

    def forward(self, pixels: torch.Tensor, *,
                dtype: torch.dtype = torch.float32, pool: bool = True,
                **_ignored) -> torch.Tensor:
        """[B, H, W, 3] → [B, num_features] (``pool=True``) or the final
        [B, H/32, W/32, C] map (``pool=False``). Other keywords are
        ignored, as in the JAX package."""
        x = self.stem(pixels.to(dtype))
        for stage in self.stages:
            x = stage(x)
        if not pool:
            return x
        return self.norm(x.float().mean(dim=(1, 2)).to(x.dtype))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ConvNeXt":
        """The JAX package's ``init`` statistics: conv and linear weights
        truncated normal (±2σ, σ = .02), zero biases, unit LayerNorms,
        ``gamma`` at ``ls_init``. Returns the module."""
        for m in self.modules():
            if isinstance(m, (Conv2d, Linear)):
                nn.init.trunc_normal_(m.weight, 0.0, 0.02, -0.04, 0.04,
                                      generator=generator)
                m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, Block) and m.gamma is not None:
                m.gamma.fill_(self.cfg.ls_init)
        return self


# ---------------------------------------------------------------- converters


def _convert(sd: Mapping, cfg: ConvNeXtConfig, names: dict) -> dict:
    """The shared walk of the two layouts; ``names`` maps the port's leaf
    paths to the checkpoint's (``{s}`` / ``{i}`` filled per stage / block);
    a gamma missing from the checkpoint is left out."""
    g = lambda k: _tensor(sd[k])  # noqa: E731
    out = {}
    for ours, theirs in names["top"].items():
        out[ours] = g(theirs)
    for s, depth in enumerate(cfg.depths):
        for i in range(depth):
            for ours, theirs in names["block"].items():
                key = theirs.format(s=s, i=i)
                if ours == "gamma" and key not in sd:
                    continue
                out[f"stages.{s}.blocks.{i}.{ours}"] = g(key)
        if s > 0:
            for ours, theirs in names["down"].items():
                out[f"stages.{s}.{ours}"] = g(theirs.format(s=s))
    return out


def _layout(stem: str, stem_norm: str, head: str, block: str,
            leaves: dict, down: str) -> dict:
    return {
        "top": {"stem.conv.weight": f"{stem}.weight",
                "stem.conv.bias": f"{stem}.bias",
                "stem.norm.weight": f"{stem_norm}.weight",
                "stem.norm.bias": f"{stem_norm}.bias",
                "norm.weight": f"{head}.weight", "norm.bias": f"{head}.bias"},
        "block": {ours: f"{block}.{theirs}"
                  for ours, theirs in leaves.items()},
        "down": {"down_norm.weight": f"{down}.0.weight",
                 "down_norm.bias": f"{down}.0.bias",
                 "down_conv.weight": f"{down}.1.weight",
                 "down_conv.bias": f"{down}.1.bias"},
    }


def _leaves(dw: str, norm: str, fc1: str, fc2: str, gamma: str) -> dict:
    out = {}
    for ours, theirs in (("dwconv", dw), ("norm", norm), ("fc1", fc1),
                         ("fc2", fc2)):
        out[f"{ours}.weight"] = f"{theirs}.weight"
        out[f"{ours}.bias"] = f"{theirs}.bias"
    out["gamma"] = gamma
    return out


def convert_hf_convnext(sd: Mapping, cfg: ConvNeXtConfig) -> dict:
    """``transformers.ConvNextModel`` state dict → ``ConvNeXt(cfg)``'s."""
    return _convert(sd, cfg, _layout(
        "embeddings.patch_embeddings", "embeddings.layernorm", "layernorm",
        "encoder.stages.{s}.layers.{i}",
        _leaves("dwconv", "layernorm", "pwconv1", "pwconv2",
                "layer_scale_parameter"),
        "encoder.stages.{s}.downsampling_layer"))


def convert_timm_convnext(sd: Mapping, cfg: ConvNeXtConfig) -> dict:
    """timm ``convnext_*`` state dict (the layout inside OpenCLIP's
    ``convnext_*`` checkpoints, trunk-prefix stripped) → ``ConvNeXt(cfg)``'s."""
    return _convert(sd, cfg, _layout(
        "stem.0", "stem.1", "head.norm", "stages.{s}.blocks.{i}",
        _leaves("conv_dw", "norm", "mlp.fc1", "mlp.fc2", "gamma"),
        "stages.{s}.downsample"))
