"""ViT-L/16 image encoder (counterpart of ``keep_tpu/models/vit.py``).

timm ``vit_large_patch16_224`` semantics as the released KEEP model uses it:
patch embed as a reshape plus one matmul, CLS token, learned pos embed,
pre-LN blocks with LayerScale, final LayerNorm, CLS pooling. Pixels come in
NHWC, [B, H, W, 3], as in the JAX package.

Parameter names follow the JAX pytree (``patch_embed``, ``blocks.{i}.attn.qkv``,
``ls1``, ...); weights are torch-layout ``[out, in]``. The patch-embed weight
is ``[D, P·P·3]`` with the (ph, pw, c) flatten order of ``patchify``.

Training: fp32 master weights under a bf16 ``dtype`` (``linear`` casts each
weight on use), per-block remat with ``remat=True``; the int8 blocks and
``fuse_ln`` (LayerNorm fused into the qkv and fc1 matmuls,
``kernels.ln_matmul``) are inference-only.

Not ported yet: ``resample_pos_embed`` (image sizes other than the native
one raise), patch dropout, ``ln_stats`` and ``act_sharding``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from keep_tpu_torch.configs import ViTConfig
from keep_tpu_torch.kernels.flash_attention import attention_qkv_slab
from keep_tpu_torch.kernels.ln_matmul import ln_matmul
from keep_tpu_torch.kernels.qblock import quantized_attention_block
from keep_tpu_torch.kernels.qmlp import quantized_mlp_bsd
from keep_tpu_torch.ops.nn import (LayerNorm, Linear, Mlp, QLinear, gelu,
                                   mha_attention)


def patchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, H, W, C] → [B, H/P · W/P, P·P·C] patches, flattened (ph, pw, c).
    The embedding is then a plain matmul, which keeps cuDNN's TF32
    convolutions out of the fp32 path."""
    b, h, w, c = x.shape
    gh, gw = h // patch_size, w // patch_size
    x = x.reshape(b, gh, patch_size, gw, patch_size, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # [B, gh, gw, ph, pw, c]
    return x.reshape(b, gh * gw, patch_size * patch_size * c)


class Attention(nn.Module):
    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.qkv = Linear(dim, 3 * dim, device=device)
        self.proj = Linear(dim, dim, device=device)


class Block(nn.Module):
    """Pre-LN transformer block with optional LayerScale (``ls1``/``ls2``;
    ``fold_layerscale`` removes them)."""

    def __init__(self, cfg: ViTConfig, *, device=None):
        super().__init__()
        d = cfg.embed_dim
        self.cfg = cfg
        self.norm1 = LayerNorm(d, cfg.ln_eps, device=device)
        self.attn = Attention(d, device=device)
        self.norm2 = LayerNorm(d, cfg.ln_eps, device=device)
        self.mlp = Mlp(d, cfg.mlp_dim, device=device)
        if cfg.layerscale_init is not None:
            self.ls1 = nn.Parameter(torch.full((d,), cfg.layerscale_init,
                                               device=device))
            self.ls2 = nn.Parameter(torch.full((d,), cfg.layerscale_init,
                                               device=device))
        else:
            self.ls1 = self.ls2 = None

    def int8_megakernel(self) -> bool:
        """Whether the block can run the int8 megakernel path: all four
        linears quantized, LayerScale folded, GELU activation."""
        return (self.cfg.act == "gelu" and self.ls1 is None
                and all(isinstance(m, QLinear) for m in (
                    self.attn.qkv, self.attn.proj, self.mlp.fc1,
                    self.mlp.fc2)))

    def _ln_matmul(self, x: torch.Tensor, norm: LayerNorm,
                   lin: Linear) -> torch.Tensor:
        """``lin(norm(x))`` over x [B, S, D] as one fused ``ln_matmul``,
        [B·S, out] in x's dtype."""
        return ln_matmul(x.reshape(-1, x.shape[-1]), norm.weight, norm.bias,
                         lin.weight.to(x.dtype), lin.bias, eps=self.cfg.ln_eps,
                         out_dtype=x.dtype)

    def forward(self, x: torch.Tensor, *, use_flash: bool,
                gelu_approx: bool, fuse_ln: bool = False) -> torch.Tensor:
        """The block's branches in the JAX package's order: the int8
        megakernels; then, under ``fuse_ln`` with ``use_flash`` and a float
        qkv, LayerNorm fused into the qkv matmul (``ln_matmul``) feeding the
        slab attention; then the slab attention; then the plain path. The
        MLP half fuses norm2 into fc1 under ``fuse_ln`` with ``use_flash``
        and a float fc1."""
        b, s, d = x.shape
        h = self.cfg.num_heads
        gelu_act = self.cfg.act == "gelu"
        if use_flash and gelu_approx and self.int8_megakernel():
            # the whole attention sub-block (LN → int8 qkv → MHA → int8 proj
            # → + x), then the int8 MLP pair with its LN and residual fused
            x = quantized_attention_block(x, self.norm1, self.attn.qkv,
                                          self.attn.proj, num_heads=h,
                                          eps=self.cfg.ln_eps)
            m = self.mlp
            return quantized_mlp_bsd(
                x, m.fc1.weight_q, m.fc1.weight_scale, m.fc1.bias,
                m.fc2.weight_q, m.fc2.weight_scale, m.fc2.bias,
                out_dtype=x.dtype, ln_scale=self.norm2.weight,
                ln_bias=self.norm2.bias, eps=self.cfg.ln_eps, residual=True)
        if (fuse_ln and use_flash and gelu_act
                and not isinstance(self.attn.qkv, QLinear)):
            # norm1 computed as the qkv matmul stages x: the normalised
            # activations never reach device memory
            slab = self._ln_matmul(x, self.norm1, self.attn.qkv)
            attn = attention_qkv_slab(slab.view(b, s, 3 * d), num_heads=h)
        else:
            qkv = self.attn.qkv(self.norm1(x))  # [B, S, 3D]
            if use_flash:
                # the kernel slices heads out of the slab: no split, no
                # transpose
                attn = attention_qkv_slab(qkv, num_heads=h)
            else:
                q, k, v = qkv.reshape(b, s, 3, h, d // h).permute(2, 0, 3, 1,
                                                                  4)
                attn = mha_attention(q, k, v).transpose(1, 2).reshape(b, s, d)
        attn = self.attn.proj(attn)
        if self.ls1 is not None:
            attn = attn * self.ls1.to(attn.dtype)
        x = x + attn
        if (fuse_ln and use_flash and gelu_act
                and not isinstance(self.mlp.fc1, QLinear)):
            hdn = gelu(self._ln_matmul(x, self.norm2, self.mlp.fc1),
                       approximate=gelu_approx)
            y = self.mlp.fc2(hdn).view(b, s, d)
        else:
            y = self.mlp(self.norm2(x), gelu_approx=gelu_approx)
        if self.ls2 is not None:
            y = y * self.ls2.to(y.dtype)
        return x + y


class VisionTransformer(nn.Module):
    def __init__(self, cfg: ViTConfig, *, device=None):
        super().__init__()
        unsupported = {
            "num_prefix_tokens": cfg.num_prefix_tokens != 1,
            "pool": cfg.pool != "token",
            "act": cfg.act != "gelu",
            "fc_norm": cfg.fc_norm,
            "moe_experts": cfg.moe_experts != 0,
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError(
                f"ViTConfig fields {bad} are outside the ported KEEP ViT "
                f"(CLS token, token pooling, GELU, dense trunk)")
        d = cfg.embed_dim
        self.cfg = cfg
        self.patch_embed = Linear(cfg.patch_size * cfg.patch_size * 3, d,
                                  device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, device=device))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + cfg.num_patches, d, device=device))
        self.blocks = nn.ModuleList(
            Block(cfg, device=device) for _ in range(cfg.depth))
        self.norm = LayerNorm(d, cfg.ln_eps, device=device)

    def forward(self, x: torch.Tensor, *, dtype: torch.dtype = torch.float32,
                use_flash: bool = False, gelu_approx: bool = False,
                remat: bool = False, fuse_ln: bool = False) -> torch.Tensor:
        """[B, H, W, 3] normalised pixels → [B, D] CLS features.
        ``remat`` recomputes each block's activations in the backward
        (``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint``
        around the block). ``fuse_ln`` with ``use_flash`` fuses norm1 into
        the qkv matmul and norm2 into fc1 (``kernels.ln_matmul``; float
        blocks only, inference only), as the JAX package's ``fuse_ln``."""
        b, h, w, _ = x.shape
        cfg = self.cfg
        if (h, w) != (cfg.img_size, cfg.img_size):
            raise ValueError(
                f"image size {(h, w)} differs from the native "
                f"{cfg.img_size}; pos-embed resampling is not ported yet")
        x = x.to(dtype)
        tokens = self.patch_embed(patchify(x, cfg.patch_size))
        cls = self.cls_token.to(dtype).expand(b, 1, cfg.embed_dim)
        tokens = torch.cat([cls, tokens], dim=1) + self.pos_embed.to(dtype)
        for blk in self.blocks:
            if remat:
                tokens = checkpoint(blk, tokens, use_reentrant=False,
                                    use_flash=use_flash,
                                    gelu_approx=gelu_approx, fuse_ln=fuse_ln)
            else:
                tokens = blk(tokens, use_flash=use_flash,
                             gelu_approx=gelu_approx, fuse_ln=fuse_ln)
        # LayerNorm is per token, so normalising the pooled CLS row alone
        # equals the JAX package's norm-then-pool
        return self.norm(tokens[:, 0])


@torch.no_grad()
def fold_layerscale(vit: VisionTransformer) -> VisionTransformer:
    """Folds the LayerScale gammas into proj and fc2 in place,
    γ·(Wx + b) = (γ⊙W)x + γ⊙b, and removes them. Exact; returns ``vit``."""
    for blk in vit.blocks:
        if blk.ls1 is None:
            continue
        for lin, gamma in ((blk.attn.proj, blk.ls1), (blk.mlp.fc2, blk.ls2)):
            g = gamma.float()
            lin.weight.copy_(lin.weight.float() * g[:, None])
            lin.bias.copy_(lin.bias.float() * g)
        blk.ls1 = blk.ls2 = None
    return vit
