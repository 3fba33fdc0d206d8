"""ViT with an MLP relative-position attention bias (counterpart of
``keep_tpu/models/vit_relpos.py``; timm's ``VisionTransformerRelPos``,
'cls' variant, the ``vit_relpos_medium_patch16_cls_224`` preset).

No absolute position embedding: each block's attention adds a per-head
bias b[h, i, j] that depends only on the grid offset between patch tokens
i and j, made by the block's small MLP (2 → hidden → heads, ReLU) over
log-scaled offsets (sign(Δ)·log1p(|Δ|)); the CLS token's row and column
of the bias are zero. Otherwise a plain pre-LN ViT (exact-GELU MLP, CLS
pooling, final LayerNorm) at a fixed image size.

Attention is the JAX package's plain form (fp32 scores, fp32 softmax, p
rounded to v's dtype, p·v summed in fp32): the bias is a full [H, S, S]
score bias, which the fused kernel does not take, and the JAX forward
ignores ``use_flash`` too. Parameter names follow its pytree
(``patch_embed``, ``cls_token``, ``blocks.{i}.attn.rel_pos.fc1``, ...).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from keep_tpu_torch.models.vit import patchify
from keep_tpu_torch.ops.nn import LayerNorm, Linear, Mlp


@dataclasses.dataclass(frozen=True)
class ViTRelPosConfig:
    img_size: int = 224
    patch_size: int = 16
    embed_dim: int = 512
    depth: int = 12
    num_heads: int = 8
    mlp_ratio: float = 4.0
    rel_pos_hidden: int = 256  # timm RelPosMlp hidden width (rel_pos_dim)
    ln_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def mlp_hidden(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)


def rel_log_coords(grid_h: int, grid_w: int, device=None) -> torch.Tensor:
    """[(2H−1)·(2W−1), 2] log-scaled offsets sign(Δ)·log1p(|Δ|) over every
    (Δrow, Δcol)."""
    dr = torch.arange(-(grid_h - 1), grid_h, dtype=torch.float32,
                      device=device)
    dc = torch.arange(-(grid_w - 1), grid_w, dtype=torch.float32,
                      device=device)
    coords = torch.stack(torch.meshgrid(dr, dc, indexing="ij"),
                         dim=-1).reshape(-1, 2)
    return torch.sign(coords) * torch.log1p(coords.abs())


def rel_index(grid_h: int, grid_w: int, device=None) -> torch.Tensor:
    """[N, N] index into the offset table for each (query, key) patch."""
    pos = torch.stack(torch.meshgrid(
        torch.arange(grid_h, device=device),
        torch.arange(grid_w, device=device), indexing="ij"),
        dim=-1).reshape(-1, 2)
    rel = pos[:, None, :] - pos[None, :, :]
    rel = rel + torch.tensor([grid_h - 1, grid_w - 1], device=device)
    return rel[..., 0] * (2 * grid_w - 1) + rel[..., 1]


class RelPosMlp(nn.Module):
    def __init__(self, hidden: int, heads: int, *, device=None):
        super().__init__()
        self.fc1 = Linear(2, hidden, device=device)
        self.fc2 = Linear(hidden, heads, device=device)

    def forward(self, grid_h: int, grid_w: int) -> torch.Tensor:
        """The [H, 1+N, 1+N] bias, in fp32: the table through the MLP
        (ReLU, as timm's RelPosMlp), gathered per pair, zero for CLS."""
        dev = self.fc1.weight.device
        table = self.fc2(F.relu(self.fc1(rel_log_coords(grid_h, grid_w,
                                                        dev))))
        bias = table[rel_index(grid_h, grid_w, dev)].permute(2, 0, 1)
        return F.pad(bias, (1, 0, 1, 0))


class Attention(nn.Module):
    def __init__(self, cfg: ViTRelPosConfig, *, device=None):
        super().__init__()
        d = cfg.embed_dim
        self.qkv = Linear(d, 3 * d, device=device)
        self.proj = Linear(d, d, device=device)
        self.rel_pos = RelPosMlp(cfg.rel_pos_hidden, cfg.num_heads,
                                 device=device)


class Block(nn.Module):
    def __init__(self, cfg: ViTRelPosConfig, *, device=None):
        super().__init__()
        d = cfg.embed_dim
        self.cfg = cfg
        self.norm1 = LayerNorm(d, cfg.ln_eps, device=device)
        self.attn = Attention(cfg, device=device)
        self.norm2 = LayerNorm(d, cfg.ln_eps, device=device)
        self.mlp = Mlp(d, cfg.mlp_hidden, device=device)

    def forward(self, x: torch.Tensor, gelu_approx: bool) -> torch.Tensor:
        b, s, d = x.shape
        cfg = self.cfg
        h, dh = cfg.num_heads, cfg.head_dim
        q, k, v = self.attn.qkv(self.norm1(x)).reshape(
            b, s, 3, h, dh).permute(2, 0, 3, 1, 4)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
            * dh ** -0.5
        scores = scores + self.attn.rel_pos(cfg.grid, cfg.grid).float()[None]
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.matmul(probs.float(), v.float()).to(x.dtype)
        x = x + self.attn.proj(out.transpose(1, 2).reshape(b, s, d))
        return x + self.mlp(self.norm2(x), gelu_approx=gelu_approx)


class ViTRelPos(nn.Module):
    def __init__(self, cfg: ViTRelPosConfig, *, device=None):
        super().__init__()
        d = cfg.embed_dim
        self.cfg = cfg
        self.patch_embed = Linear(cfg.patch_size ** 2 * 3, d, device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, device=device))
        self.blocks = nn.ModuleList(Block(cfg, device=device)
                                    for _ in range(cfg.depth))
        self.norm = LayerNorm(d, cfg.ln_eps, device=device)

    def forward(self, x: torch.Tensor, *, dtype: torch.dtype = torch.float32,
                gelu_approx: bool = False, use_flash: bool = False,
                **_ignored) -> torch.Tensor:
        """[B, H, W, 3] at the config's image size → [B, D] CLS features.
        ``use_flash`` is accepted and ignored: the score-level bias has no
        fused path (as in the JAX package)."""
        b, ih, iw, _ = x.shape
        cfg = self.cfg
        if (ih, iw) != (cfg.img_size, cfg.img_size):
            raise ValueError(
                f"relpos ViT is fixed at {cfg.img_size}px (got {(ih, iw)})")
        tokens = self.patch_embed(patchify(x.to(dtype), cfg.patch_size))
        cls = self.cls_token.to(dtype).expand(b, 1, cfg.embed_dim)
        tokens = torch.cat([cls, tokens], dim=1)
        for blk in self.blocks:
            tokens = blk(tokens, gelu_approx)
        return self.norm(tokens[:, 0])

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ViTRelPos":
        """The JAX package's ``init`` statistics: linear weights normal with
        std fan_in^-0.5, zero biases, unit LayerNorms, the CLS token
        truncated normal (±2σ, σ = .02). Returns the module."""
        for m in self.modules():
            if isinstance(m, Linear):
                m.weight.normal_(0.0, m.weight.shape[1] ** -0.5,
                                 generator=generator)
                m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        nn.init.trunc_normal_(self.cls_token, 0.0, 0.02, -0.04, 0.04,
                              generator=generator)
        return self
