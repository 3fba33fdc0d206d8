"""EVA02 image trunk (counterpart of ``keep_tpu/models/eva.py``; the
reference's ``EVA02-*`` presets, which delegate to timm).

The TrV block (arXiv 2303.11331 §2.2, timm's ``eva.py`` layout): separate
q / k / v projections, **k without a bias** (its product accumulated in
fp32 and rounded once, like q's and v's); 2D axial rotary embeddings on
the patch tokens' q and k (the CLS token passes through unrotated), on top
of a learned absolute pos embed; a LayerNorm on the attention output
before its projection; a SwiGLU MLP with a LayerNorm over its hidden
(sub-LN). Pre-LN blocks, final LayerNorm, CLS pooling, a linear head to
the CLIP width.

The E variant (EVA-02-CLIP's scaled EVA-01 recipe): fused qkv, a plain
exact-GELU MLP, **post-norm** blocks (x + norm(sublayer(x))) and no rope.

Attention is the JAX package's plain form (fp32 scores from the rotated
values, fp32 softmax, p rounded to v's dtype, p·v summed in fp32).
Parameter names follow its pytree (``blocks.{i}.attn.{q,k,v,proj,norm}``,
``blocks.{i}.mlp.{fc1_g,fc1_x,norm,fc2}``, ``head``, ...).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from keep_tpu_torch.models.vit import patchify, resample_pos_embed
from keep_tpu_torch.ops.nn import LayerNorm, Linear


@dataclasses.dataclass(frozen=True)
class EvaConfig:
    img_size: int = 224
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_hidden: int = 2048  # B: 2048, L: 2730 (int(1024·8/3)), E: 15360
    swiglu: bool = True
    scale_mlp: bool = True  # LayerNorm over the MLP hidden (sub-LN)
    scale_attn_inner: bool = True  # LayerNorm over attn out before proj
    qkv_fused: bool = False
    rope: bool = True
    rope_temperature: float = 100.0
    post_norm: bool = False  # E variant: x + norm(sublayer(x))
    ln_eps: float = 1e-6
    out_dim: int = 512  # the CLIP embed width (timm's num_classes head)

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size


# the reference's five EVA02 presets (model_configs/EVA02-*.json → timm)
EVA02_CONFIGS = {
    "EVA02-B-16": EvaConfig(patch_size=16, embed_dim=768, depth=12,
                            num_heads=12, mlp_hidden=2048, out_dim=512),
    "EVA02-L-14": EvaConfig(patch_size=14, embed_dim=1024, depth=24,
                            num_heads=16, mlp_hidden=2730, out_dim=768),
    "EVA02-L-14-336": EvaConfig(img_size=336, patch_size=14, embed_dim=1024,
                                depth=24, num_heads=16, mlp_hidden=2730,
                                out_dim=768),
    "EVA02-E-14": EvaConfig(patch_size=14, embed_dim=1792, depth=64,
                            num_heads=16, mlp_hidden=15360, swiglu=False,
                            scale_mlp=False, scale_attn_inner=False,
                            qkv_fused=True, rope=False, post_norm=True,
                            out_dim=1024),
    "EVA02-E-14-plus": EvaConfig(patch_size=14, embed_dim=1792, depth=64,
                                 num_heads=16, mlp_hidden=15360, swiglu=False,
                                 scale_mlp=False, scale_attn_inner=False,
                                 qkv_fused=True, rope=False, post_norm=True,
                                 out_dim=1024),
}


def rope_2d_angles(grid_h: int, grid_w: int, head_dim: int,
                   temperature: float = 100.0, device=None) -> torch.Tensor:
    """[N, head_dim / 2] rotation angles for the patch grid: the first
    head_dim / 4 slots rotate by the row, the others by the column, each
    axis on the ladder temperature^(−4j / head_dim)."""
    if head_dim % 4:
        raise ValueError(f"head_dim {head_dim} must be divisible by 4")
    bands = head_dim // 4
    inv_freq = temperature ** (-torch.arange(bands, dtype=torch.float32,
                                             device=device) * 4.0 / head_dim)
    rows = torch.arange(grid_h, dtype=torch.float32, device=device)
    cols = torch.arange(grid_w, dtype=torch.float32, device=device)
    ang_r = (rows[:, None] * inv_freq[None])[:, None].expand(grid_h, grid_w,
                                                             bands)
    ang_c = (cols[:, None] * inv_freq[None])[None].expand(grid_h, grid_w,
                                                          bands)
    return torch.cat([ang_r, ang_c], dim=-1).reshape(grid_h * grid_w,
                                                     head_dim // 2)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotates interleaved pairs of the last axis in fp32: x [..., N, D],
    angles [N, D / 2]; (x[2j], x[2j+1]) turns by angles[j]."""
    xf = x.float()
    pairs = xf.reshape(*xf.shape[:-1], -1, 2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = pairs[..., 0], pairs[..., 1]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(xf.shape).to(x.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: EvaConfig, *, device=None):
        super().__init__()
        d = cfg.embed_dim
        self.cfg = cfg
        if cfg.qkv_fused:
            self.qkv = Linear(d, 3 * d, device=device)
        else:
            self.q = Linear(d, d, device=device)
            self.k = Linear(d, d, bias=False, device=device)
            self.v = Linear(d, d, device=device)
        self.norm = (LayerNorm(d, cfg.ln_eps, device=device)
                     if cfg.scale_attn_inner else None)
        self.proj = Linear(d, d, device=device)

    def forward(self, x: torch.Tensor,
                angles: torch.Tensor | None) -> torch.Tensor:
        b, s, d = x.shape
        h, dh = self.cfg.num_heads, self.cfg.head_dim
        if self.cfg.qkv_fused:
            q, k, v = self.qkv(x).chunk(3, dim=-1)
        else:
            q, k, v = self.q(x), self.k(x), self.v(x)
        q, k, v = (t.reshape(b, s, h, dh).transpose(1, 2) for t in (q, k, v))
        if angles is not None:
            # patch tokens only: the CLS prefix passes through
            q = torch.cat([q[:, :, :1], apply_rope(q[:, :, 1:], angles)], 2)
            k = torch.cat([k[:, :, :1], apply_rope(k[:, :, 1:], angles)], 2)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
            * dh ** -0.5
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.matmul(probs.float(), v.float()).to(x.dtype)
        out = out.transpose(1, 2).reshape(b, s, d)
        if self.norm is not None:
            out = self.norm(out)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, cfg: EvaConfig, *, device=None):
        super().__init__()
        d, f = cfg.embed_dim, cfg.mlp_hidden
        self.swiglu = cfg.swiglu
        if cfg.swiglu:
            self.fc1_g = Linear(d, f, device=device)
            self.fc1_x = Linear(d, f, device=device)
        else:
            self.fc1 = Linear(d, f, device=device)
        self.norm = (LayerNorm(f, cfg.ln_eps, device=device)
                     if cfg.swiglu and cfg.scale_mlp else None)
        self.fc2 = Linear(f, d, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.swiglu:
            return self.fc2(F.gelu(self.fc1(x)))
        hidden = F.silu(self.fc1_g(x)) * self.fc1_x(x)
        if self.norm is not None:
            hidden = self.norm(hidden)
        return self.fc2(hidden)


class Block(nn.Module):
    def __init__(self, cfg: EvaConfig, *, device=None):
        super().__init__()
        self.post_norm = cfg.post_norm
        self.norm1 = LayerNorm(cfg.embed_dim, cfg.ln_eps, device=device)
        self.attn = Attention(cfg, device=device)
        self.norm2 = LayerNorm(cfg.embed_dim, cfg.ln_eps, device=device)
        self.mlp = Mlp(cfg, device=device)

    def forward(self, x: torch.Tensor,
                angles: torch.Tensor | None) -> torch.Tensor:
        if self.post_norm:
            x = x + self.norm1(self.attn(x, angles))
            return x + self.norm2(self.mlp(x))
        x = x + self.attn(self.norm1(x), angles)
        return x + self.mlp(self.norm2(x))


class Eva(nn.Module):
    def __init__(self, cfg: EvaConfig, *, device=None):
        super().__init__()
        d = cfg.embed_dim
        self.cfg = cfg
        self.patch_embed = Linear(cfg.patch_size ** 2 * 3, d, device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(
            1, 1 + cfg.grid * cfg.grid, d, device=device))
        self.blocks = nn.ModuleList(Block(cfg, device=device)
                                    for _ in range(cfg.depth))
        self.norm = LayerNorm(d, cfg.ln_eps, device=device)
        self.head = (Linear(d, cfg.out_dim, device=device)
                     if cfg.out_dim and cfg.out_dim != d else None)

    def forward(self, x: torch.Tensor, *, dtype: torch.dtype = torch.float32,
                **_ignored) -> torch.Tensor:
        """[B, H, W, 3] normalised pixels, any multiple of the patch (the
        pos embed resampled) → [B, out_dim] CLS features, unnormalised.
        Other keywords are ignored, as in the JAX package."""
        b, ih, iw, _ = x.shape
        cfg = self.cfg
        ps = cfg.patch_size
        if ih % ps or iw % ps:
            raise ValueError(f"image {(ih, iw)} not a multiple of patch {ps}")
        gh, gw = ih // ps, iw // ps
        tokens = self.patch_embed(patchify(x.to(dtype), ps))
        cls = self.cls_token.to(dtype).expand(b, 1, cfg.embed_dim)
        tokens = torch.cat([cls, tokens], dim=1)
        tokens = tokens + resample_pos_embed(self.pos_embed, (gh, gw),
                                             1).to(dtype)
        angles = (rope_2d_angles(gh, gw, cfg.head_dim, cfg.rope_temperature,
                                 tokens.device) if cfg.rope else None)
        for blk in self.blocks:
            tokens = blk(tokens, angles)
        pooled = self.norm(tokens[:, 0])
        return self.head(pooled) if self.head is not None else pooled

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Eva":
        """The JAX package's ``init`` statistics: linear weights normal with
        std fan_in^-0.5, zero biases, unit LayerNorms, the CLS token and
        pos embed truncated normal (±2σ, σ = .02). Returns the module."""
        for m in self.modules():
            if isinstance(m, Linear):
                m.weight.normal_(0.0, m.weight.shape[1] ** -0.5,
                                 generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for t in (self.cls_token, self.pos_embed):
            nn.init.trunc_normal_(t, 0.0, 0.02, -0.04, 0.04,
                                  generator=generator)
        return self
