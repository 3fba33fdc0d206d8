"""Swin Transformer image tower (counterpart of ``keep_tpu/models/swin.py``):
the ``swin_base_patch4_window7_224`` preset (linear 4×4 patch embed) and
the CTransPath family (a conv stem, the reference's model/ctran.py:23-31).

Window attention over w×w windows with a learned relative-position bias
table per head, shifted windows on every other block (−1e9 across the
seams of the rolled map), 2×2 patch merging between stages, a final
LayerNorm and a global average pool. As in timm and the JAX package, a
block does not shift once the window covers the whole feature map.

Attention is the plain form the JAX package computes (fp32 scores from
the values, softmax in fp32, p rounded to v's dtype, p·v summed in fp32):
its score-level bias has no place in the fused kernel, which takes key
masks only. Parameter names follow the JAX pytree (``patch_embed``,
``embed_norm``, ``stage{s}.blocks.{i}.attn.rel_bias``, ``stage{s}.merge``,
``stem.conv1`` ...).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from keep_tpu_torch.compat.torch_loader import _tensor
from keep_tpu_torch.models.resnet import BatchNorm
from keep_tpu_torch.ops.nn import Conv2d, LayerNorm, Linear, Mlp


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    img_size: int = 224
    embed_dim: int = 96
    depths: Sequence[int] = (2, 2, 6, 2)
    heads: Sequence[int] = (3, 6, 12, 24)
    window: int = 7
    mlp_ratio: float = 4.0
    ln_eps: float = 1e-5
    conv_stem: bool = True  # ctranspath variant
    num_features_mult: int = 8  # final dim = embed_dim * 8

    @property
    def num_features(self) -> int:
        return self.embed_dim * self.num_features_mult


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """[B, H, W, C] → [B·nH·nW, w, w, C]."""
    b, h, ww, c = x.shape
    x = x.reshape(b, h // w, w, ww // w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w, w, c)


def window_reverse(windows: torch.Tensor, w: int, h: int,
                   ww: int) -> torch.Tensor:
    b = windows.shape[0] // (h // w * ww // w)
    x = windows.reshape(b, h // w, ww // w, w, w, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, ww, -1)


@functools.lru_cache(maxsize=4)
def relative_position_index(w: int) -> np.ndarray:
    """[w², w²] indices into the (2w−1)² relative-bias table."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).astype(np.int64)


@functools.lru_cache(maxsize=16)
def shift_attn_mask(h: int, ww: int, w: int, shift: int) -> np.ndarray:
    """[nWindows, w², w²] additive mask: −1e9 between positions that come
    from different regions of the rolled map."""
    img = np.zeros((h, ww), np.int64)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    wins = window_partition(torch.from_numpy(img)[None, :, :, None],
                            w).reshape(-1, w * w).numpy()
    return np.where(wins[:, :, None] != wins[:, None, :], -1e9,
                    0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, c: int, heads: int, w: int, *, device=None):
        super().__init__()
        self.heads, self.w = heads, w
        self.qkv = Linear(c, 3 * c, device=device)
        self.proj = Linear(c, c, device=device)
        self.rel_bias = nn.Parameter(torch.zeros((2 * w - 1) ** 2, heads,
                                                 device=device))

    def forward(self, x: torch.Tensor,
                mask: torch.Tensor | None) -> torch.Tensor:
        """x [nW, w², C]; ``mask`` [nWindows of one image, w², w²]."""
        nw, n, c = x.shape
        h, dh = self.heads, c // self.heads
        q, k, v = self.qkv(x).reshape(nw, n, 3, h, dh).permute(2, 0, 3, 1, 4)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
            * dh ** -0.5
        idx = torch.from_numpy(relative_position_index(self.w).reshape(-1))
        bias = self.rel_bias[idx.to(x.device)].reshape(n, n, h)
        scores = scores + bias.permute(2, 0, 1).float()[None]
        if mask is not None:
            nm = mask.shape[0]
            scores = (scores.reshape(nw // nm, nm, h, n, n)
                      + mask[None, :, None]).reshape(nw, h, n, n)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.matmul(probs.float(), v.float()).to(v.dtype)
        return self.proj(out.transpose(1, 2).reshape(nw, n, c))


class SwinBlock(nn.Module):
    def __init__(self, c: int, heads: int, cfg: SwinConfig, *, device=None):
        super().__init__()
        self.w, self.eps = cfg.window, cfg.ln_eps
        self.norm1 = LayerNorm(c, cfg.ln_eps, device=device)
        self.attn = WindowAttention(c, heads, cfg.window, device=device)
        self.norm2 = LayerNorm(c, cfg.ln_eps, device=device)
        self.mlp = Mlp(c, int(c * cfg.mlp_ratio), device=device)

    def forward(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        b, h, ww, c = x.shape
        w = self.w
        y = self.norm1(x)
        mask = None
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = torch.from_numpy(shift_attn_mask(h, ww, w, shift)).to(
                x.device)
        wins = window_partition(y, w).reshape(-1, w * w, c)
        y = window_reverse(self.attn(wins, mask).reshape(-1, w, w, c), w, h,
                           ww)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y
        return x + self.mlp(self.norm2(x))


class PatchMerge(nn.Module):
    """2×2 neighbourhood concat → LayerNorm → linear 4C → 2C."""

    def __init__(self, c: int, eps: float, *, device=None):
        super().__init__()
        self.norm = LayerNorm(4 * c, eps, device=device)
        self.reduction = Linear(4 * c, 2 * c, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        return self.reduction(self.norm(x.reshape(b, h // 2, w // 2, 4 * c)))


class Stage(nn.Module):
    def __init__(self, c: int, si: int, cfg: SwinConfig, *, device=None):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(c, cfg.heads[si], cfg, device=device)
            for _ in range(cfg.depths[si]))
        self.merge = (PatchMerge(c, cfg.ln_eps, device=device)
                      if si < len(cfg.depths) - 1 else None)


class ConvStem(nn.Module):
    """CTransPath's stem: conv3×3 (3 → d/8, stride 2) + BN + ReLU,
    conv3×3 (d/8 → d/4, stride 2) + BN + ReLU, conv1×1 (d/4 → d) + bias."""

    def __init__(self, d: int, *, device=None):
        super().__init__()
        c1, c2 = d // 8, d // 4
        self.conv1 = Conv2d(3, c1, 3, stride=2, padding=1, bias=False,
                            device=device)
        self.bn1 = BatchNorm(c1, device=device)
        self.conv2 = Conv2d(c1, c2, 3, stride=2, padding=1, bias=False,
                            device=device)
        self.bn2 = BatchNorm(c2, device=device)
        self.conv3 = Conv2d(c2, d, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        return self.conv3(x)


class Swin(nn.Module):
    def __init__(self, cfg: SwinConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        if cfg.conv_stem:
            self.stem = ConvStem(d, device=device)
        else:
            self.patch_embed = Linear(48, d, device=device)
        self.embed_norm = LayerNorm(d, cfg.ln_eps, device=device)
        c = d
        for si in range(len(cfg.depths)):
            setattr(self, f"stage{si}", Stage(c, si, cfg, device=device))
            if si < len(cfg.depths) - 1:
                c *= 2
        self.norm = LayerNorm(c, cfg.ln_eps, device=device)

    def forward(self, pixels: torch.Tensor, *,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """[B, H, W, 3] → [B, num_features]: the final LayerNorm, then the
        mean over positions."""
        cfg = self.cfg
        x = pixels.to(dtype)
        if cfg.conv_stem:
            x = self.stem(x)
        else:
            b, h, w, c = x.shape
            x = x.reshape(b, h // 4, 4, w // 4, 4, c).permute(0, 1, 3, 2, 4, 5)
            x = self.patch_embed(x.reshape(b, h // 4, w // 4, 16 * c))
        x = self.embed_norm(x)
        for si in range(len(cfg.depths)):
            stage = getattr(self, f"stage{si}")
            for bi, blk in enumerate(stage.blocks):
                # no shift once the window covers the whole map (timm's
                # rule; every 224² preset's 7×7 last stage)
                shift = (cfg.window // 2 if bi % 2 else 0) if min(
                    x.shape[1], x.shape[2]) > cfg.window else 0
                x = blk(x, shift)
            if stage.merge is not None:
                x = stage.merge(x)
        return self.norm(x).mean(dim=(1, 2))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Swin":
        """The JAX package's ``init`` statistics: linear weights normal with
        std fan_in^-0.5 and zero biases, the relative-bias tables normal
        (.02), unit LayerNorms and BatchNorms, the conv stem's weights
        normal (.1) with a zero bias. Returns the module."""
        for m in self.modules():
            if isinstance(m, Linear):
                m.weight.normal_(0.0, m.weight.shape[1] ** -0.5,
                                 generator=generator)
                m.bias.zero_()
            elif isinstance(m, Conv2d):
                m.weight.normal_(0.0, 0.1, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (LayerNorm, BatchNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, WindowAttention):
                m.rel_bias.normal_(0.0, 0.02, generator=generator)
        return self


def convert_timm_swin(sd: Mapping, cfg: SwinConfig) -> dict:
    """timm ``swin_*_patch4_window7`` state dict (the linear patch-embed
    variant) → ``Swin(cfg)``'s. The 4×4 patch conv becomes a [D, 48]
    matmul weight in (ph, pw, c) order; the bias-free merge reduction gets
    a zero bias."""
    g = lambda k: _tensor(sd[k])  # noqa: E731
    conv = g("patch_embed.proj.weight")  # [D, 3, 4, 4]
    out = {"patch_embed.weight": conv.permute(0, 2, 3, 1).reshape(
               conv.shape[0], -1).contiguous(),
           "patch_embed.bias": g("patch_embed.proj.bias")}

    def copy(dst: str, src: str, bias: bool = True) -> None:
        out[f"{dst}.weight"] = g(f"{src}.weight")
        out[f"{dst}.bias"] = (g(f"{src}.bias") if bias else
                              torch.zeros(out[f"{dst}.weight"].shape[0]))

    copy("embed_norm", "patch_embed.norm")
    copy("norm", "norm")
    for si, depth in enumerate(cfg.depths):
        for bi in range(depth):
            src, dst = f"layers.{si}.blocks.{bi}", f"stage{si}.blocks.{bi}"
            for n in ("norm1", "attn.qkv", "attn.proj", "norm2", "mlp.fc1",
                      "mlp.fc2"):
                copy(f"{dst}.{n}", f"{src}.{n}")
            out[f"{dst}.attn.rel_bias"] = g(
                f"{src}.attn.relative_position_bias_table")
        if si < len(cfg.depths) - 1:
            copy(f"stage{si}.merge.norm", f"layers.{si}.downsample.norm")
            copy(f"stage{si}.merge.reduction",
                 f"layers.{si}.downsample.reduction", bias=False)
    return out
