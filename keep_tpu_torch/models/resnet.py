"""ModifiedResNet, the OpenAI-CLIP RN image tower, and the torchvision
ResNet-50 trunk (counterpart of ``keep_tpu/models/resnet.py``; the
reference's training/path_open_clip/modified_resnet.py:95-181 and
model/res_ssl.py:5-42).

ModifiedResNet: a stem of three 3×3 convs (the first at stride 2) and an
average pool; four stages of anti-aliased bottlenecks (the stride taken by
an average pool before conv3, and by one before the downsample's conv);
an attention pool whose only query is the mean token. The trunk: a 7×7
stride-2 conv and a 3×3 max pool, then torchvision bottlenecks (the stride
on the 3×3 conv, a strided 1×1 downsample).

BatchNorm runs in inference mode: its scale and shift are folded in fp32
from the running statistics and cast to the activation dtype, as in the
JAX package. Activations are NHWC, [B, H, W, C], as there; each conv runs
``F.conv2d`` on the channels-last view (``ops.nn.conv2d``), its products
accumulated in fp32 and rounded once.

Parameter names follow the JAX pytree (``stem.conv1``, ``layer1.0.bn2``,
``attnpool.q``, ...); conv weights are torch-layout [O, I, kh, kw], the
JAX package's HWIO kernels permuted (3, 2, 0, 1), and a BatchNorm's
``scale`` / ``bias`` / ``mean`` / ``var`` are ``weight`` / ``bias`` /
``running_mean`` / ``running_var``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from keep_tpu_torch.compat.torch_loader import _tensor
from keep_tpu_torch.ops.nn import (Conv2d, Linear, cast_linear_weights,
                                   l2_normalize, mha_attention)


@dataclasses.dataclass(frozen=True)
class ModifiedResNetConfig:
    layers: Sequence[int] = (3, 4, 6, 3)  # RN50
    width: int = 64
    image_size: int = 224
    heads: int = 32
    output_dim: int = 1024
    bn_eps: float = 1e-5

    @property
    def final_channels(self) -> int:
        return self.width * 32

    @property
    def spatial(self) -> int:
        return self.image_size // 32


class BatchNorm(nn.Module):
    """Inference BatchNorm over the last (channel) axis: x·s + t with s =
    weight / sqrt(running_var + eps) and t = bias − running_mean·s, both
    folded in fp32 and cast to x's dtype."""

    def __init__(self, c: int, eps: float = 1e-5, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("running_mean", torch.zeros(c, device=device))
        self.register_buffer("running_var", torch.ones(c, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var.float() + self.eps)
        w = self.weight.float()
        scale = (w * inv).to(x.dtype)
        shift = (self.bias.float() - self.running_mean.float() * w * inv
                 ).to(x.dtype)
        return x * scale + shift


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """k×k average pool at stride k over NHWC x."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), k).permute(0, 2, 3, 1)


def max_pool(x: torch.Tensor, k: int, stride: int,
             padding: int) -> torch.Tensor:
    """k×k max pool over NHWC x, the padding at −inf."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, stride,
                        padding).permute(0, 2, 3, 1)


class Downsample(nn.Module):
    def __init__(self, cin: int, cout: int, eps: float, stride: int = 1, *,
                 device=None):
        super().__init__()
        self.conv = Conv2d(cin, cout, 1, stride=stride, bias=False,
                           device=device)
        self.bn = BatchNorm(cout, eps, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class Bottleneck(nn.Module):
    """The anti-aliased bottleneck (``stride`` by an average pool before
    conv3; ``standard=True``: the torchvision one, the stride on conv2)."""

    def __init__(self, cin: int, planes: int, stride: int, downsample: bool,
                 eps: float, *, standard: bool = False, device=None):
        super().__init__()
        self.stride, self.standard = stride, standard
        s2 = stride if standard else 1
        self.conv1 = Conv2d(cin, planes, 1, bias=False, device=device)
        self.bn1 = BatchNorm(planes, eps, device=device)
        self.conv2 = Conv2d(planes, planes, 3, stride=s2, padding=1,
                            bias=False, device=device)
        self.bn2 = BatchNorm(planes, eps, device=device)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False, device=device)
        self.bn3 = BatchNorm(planes * 4, eps, device=device)
        self.downsample = (Downsample(cin, planes * 4, eps, s2, device=device)
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        pooled = not self.standard and self.stride > 1
        if pooled:
            out = avg_pool(out, self.stride)
        out = self.bn3(self.conv3(out))
        identity = x
        if self.downsample is not None:
            identity = self.downsample(avg_pool(x, self.stride) if pooled
                                       else x)
        return F.relu(out + identity)


class AttentionPool(nn.Module):
    """Attention pooling with the mean token as the one query
    (modified_resnet.py:58-94): the tokens are the mean and the HW
    positions, each plus its learned ``pos_embed`` row."""

    def __init__(self, spatial: int, c: int, heads: int, out_dim: int, *,
                 device=None):
        super().__init__()
        self.heads = heads
        self.pos_embed = nn.Parameter(torch.zeros(spatial ** 2 + 1, c,
                                                  device=device))
        self.q = Linear(c, c, device=device)
        self.k = Linear(c, c, device=device)
        self.v = Linear(c, c, device=device)
        self.c = Linear(c, out_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        tokens = x.reshape(b, h * w, c)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.pos_embed.to(tokens.dtype)[None]
        dh = c // self.heads

        def heads(t):
            return t.reshape(b, -1, self.heads, dh).transpose(1, 2)

        out = mha_attention(heads(self.q(tokens[:, :1])),
                            heads(self.k(tokens)), heads(self.v(tokens)))
        return self.c(out.transpose(1, 2).reshape(b, c))


class Stem(nn.Module):
    def __init__(self, width: int, eps: float, *, device=None):
        super().__init__()
        w2 = width // 2
        self.conv1 = Conv2d(3, w2, 3, stride=2, padding=1, bias=False,
                            device=device)
        self.bn1 = BatchNorm(w2, eps, device=device)
        self.conv2 = Conv2d(w2, w2, 3, padding=1, bias=False, device=device)
        self.bn2 = BatchNorm(w2, eps, device=device)
        self.conv3 = Conv2d(w2, width, 3, padding=1, bias=False,
                            device=device)
        self.bn3 = BatchNorm(width, eps, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in (1, 2, 3):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return avg_pool(x, 2)


def _stages(module: nn.Module, layers: Sequence[int], width: int, eps: float,
            standard: bool, device) -> None:
    cin = width
    for li, depth in enumerate(layers, start=1):
        planes = width * 2 ** (li - 1)
        blocks = []
        for bi in range(depth):
            stride = 2 if (li > 1 and bi == 0) else 1
            blocks.append(Bottleneck(cin, planes, stride, bi == 0, eps,
                                     standard=standard, device=device))
            cin = planes * 4
        setattr(module, f"layer{li}", nn.ModuleList(blocks))


class ModifiedResNet(nn.Module):
    """The OpenAI-CLIP RN tower: [B, H, W, 3] → [B, output_dim]. As the
    registry's ``rn50-clip`` it is a model of its own (``encode_image``
    only, as the JAX package's entry)."""

    family = "clip"

    def __init__(self, cfg: ModifiedResNetConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.stem = Stem(cfg.width, cfg.bn_eps, device=device)
        _stages(self, cfg.layers, cfg.width, cfg.bn_eps, False, device)
        self.attnpool = AttentionPool(cfg.spatial, cfg.final_channels,
                                      cfg.heads, cfg.output_dim,
                                      device=device)

    def forward(self, x: torch.Tensor, *,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        x = self.stem(x.to(dtype))
        for li in range(1, len(self.cfg.layers) + 1):
            for blk in getattr(self, f"layer{li}"):
                x = blk(x)
        return self.attnpool(x)

    @property
    def config(self) -> ModifiedResNetConfig:
        return self.cfg

    def encode_image(self, pixels: torch.Tensor, *, normalize: bool = False,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """The forward in ``dtype`` (fp32 by default, whatever dtype the
        weights are stored in, as the JAX package's ``rn50-clip`` entry
        computes); unit fp32 rows with ``normalize``."""
        f = self(pixels.to(self.attnpool.pos_embed.device), dtype=dtype)
        return l2_normalize(f.float()) if normalize else f

    @classmethod
    @torch.no_grad()
    def init(cls, cfg: ModifiedResNetConfig, generator: torch.Generator, *,
             dtype: torch.dtype = torch.float32,
             device=None) -> "ModifiedResNet":
        """A tower drawn from ``generator`` (``init_weights``), its conv and
        linear weights stored in ``dtype``."""
        model = cls(cfg, device=device).init_weights(generator)
        cast_linear_weights(model, dtype)
        return model.eval()

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ModifiedResNet":
        """Draws the weights in place with the JAX package's ``init``
        statistics: conv weights normal with std fan_in^-0.5 (fan_in = I·k²),
        unit BatchNorms, linear weights std fan_in^-0.5 with zero biases,
        ``pos_embed`` normal / C^0.5. Returns the module."""
        for m in self.modules():
            if isinstance(m, (Conv2d, Linear)):
                w = m.weight
                w.normal_(0.0, w[0].numel() ** -0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        pe = self.attnpool.pos_embed
        pe.normal_(0.0, pe.shape[1] ** -0.5, generator=generator)
        return self


class ResNetTrunk(nn.Module):
    """The torchvision ResNet-50 trunk (KEP's ``res_ssl`` tower, the lunit
    SSL checkpoint): [B, H, W, 3] → the [B, H/32, W/32, 32·width] map.
    It has no init of its own: its weights come from a checkpoint
    (``convert_torchvision_resnet``)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 bn_eps: float = 1e-5, *, device=None):
        super().__init__()
        self.layers = tuple(layers)
        self.conv1 = Conv2d(3, width, 7, stride=2, padding=3, bias=False,
                            device=device)
        self.bn1 = BatchNorm(width, bn_eps, device=device)
        _stages(self, layers, width, bn_eps, True, device)

    @classmethod
    def for_state_dict(cls, sd: Mapping, device=None) -> "ResNetTrunk":
        """An empty trunk shaped for ``sd`` (its stage depths and width)."""
        layers = tuple(1 + max(int(k.split(".")[1]) for k in sd
                               if k.startswith(f"layer{li}."))
                       for li in range(1, 5))
        return cls(layers, sd["conv1.weight"].shape[0], device=device)

    def forward(self, x: torch.Tensor, *,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x.to(dtype))))
        x = max_pool(x, 3, 2, 1)
        for li in range(1, 5):
            for blk in getattr(self, f"layer{li}"):
                x = blk(x)
        return x


def resnet_trunk_pooled(trunk: ResNetTrunk, x: torch.Tensor,
                        **kw) -> torch.Tensor:
    """The trunk, then a global average pool → [B, 32·width] (KEP's
    ``AvgPool2d(7)`` on 224² inputs)."""
    return trunk(x, **kw).mean(dim=(1, 2))


# ---------------------------------------------------------------- converters


def _bn(sd: Mapping, src: str, dst: str, out: dict) -> None:
    for name in ("weight", "bias", "running_mean", "running_var"):
        out[f"{dst}.{name}"] = _tensor(sd[f"{src}.{name}"])


def _block(sd: Mapping, prefix: str, out: dict) -> None:
    for i in (1, 2, 3):
        key = f"{prefix}.conv{i}.weight"
        out[key] = _tensor(sd[key])
        _bn(sd, f"{prefix}.bn{i}", f"{prefix}.bn{i}", out)
    if f"{prefix}.downsample.0.weight" in sd:
        out[f"{prefix}.downsample.conv.weight"] = _tensor(
            sd[f"{prefix}.downsample.0.weight"])
        _bn(sd, f"{prefix}.downsample.1", f"{prefix}.downsample.bn", out)


def convert_openai_resnet(sd: Mapping, cfg: ModifiedResNetConfig) -> dict:
    """An OpenAI / open_clip ModifiedResNet state dict (the visual tower's
    keys, unprefixed) → the state dict of ``ModifiedResNet(cfg)``."""
    out: dict = {}
    for i in (1, 2, 3):
        out[f"stem.conv{i}.weight"] = _tensor(sd[f"conv{i}.weight"])
        _bn(sd, f"bn{i}", f"stem.bn{i}", out)
    ap = "attnpool"
    out[f"{ap}.pos_embed"] = _tensor(sd[f"{ap}.positional_embedding"])
    for ours in ("q", "k", "v", "c"):
        for leaf in ("weight", "bias"):
            out[f"{ap}.{ours}.{leaf}"] = _tensor(
                sd[f"{ap}.{ours}_proj.{leaf}"])
    for li, depth in enumerate(cfg.layers, start=1):
        for bi in range(depth):
            _block(sd, f"layer{li}.{bi}", out)
    return out


def convert_torchvision_resnet(sd: Mapping,
                               layers: Sequence[int] = (3, 4, 6, 3)) -> dict:
    """A torchvision resnet50 state dict (the trunk's keys; ``fc`` is
    ignored) → the state dict of ``ResNetTrunk(layers)``."""
    out = {"conv1.weight": _tensor(sd["conv1.weight"])}
    _bn(sd, "bn1", "bn1", out)
    for li, depth in enumerate(layers, start=1):
        for bi in range(depth):
            _block(sd, f"layer{li}.{bi}", out)
    return out
