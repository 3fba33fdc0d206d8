"""ViT image encoder (counterpart of ``keep_tpu/models/vit.py``).

timm ``vit_large_patch16_224`` semantics as the released KEEP model uses it
(``dynamic_img_size=True``): patch embed as a reshape plus one matmul, CLS
token, learned pos embed (resampled bicubically for any other image size,
``resample_pos_embed``), pre-LN blocks with LayerScale, final LayerNorm,
CLS pooling. Pixels come in NHWC, [B, H, W, 3], as in the JAX package.

The OpenCLIP zoo's variants, as there: the OpenAI-CLIP ``ln_pre`` after the
pos embed (``ln_pre=True``); no CLS token (``num_prefix_tokens=0``); average
pooling (``pool="avg"``) or none (``pool="none"``: all tokens); timm's
gap-ViT ``fc_norm`` (the final LayerNorm after pooling); QuickGELU blocks
(``act="quick_gelu"``); any ``mlp_ratio``. Training-time patch dropout
keeps a random subset of patch tokens (``patch_dropout``).

Parameter names follow the JAX pytree (``patch_embed``, ``blocks.{i}.attn.qkv``,
``ls1``, ...); weights are torch-layout ``[out, in]``. The patch-embed weight
is ``[D, P·P·3]`` with the (ph, pw, c) flatten order of ``patchify``.

Training: fp32 master weights under a bf16 ``dtype`` (``linear`` casts each
weight on use), per-block remat with ``remat=True``; the int8 blocks and
``fuse_ln`` (LayerNorm fused into the qkv and fc1 matmuls,
``kernels.ln_matmul``) are inference-only.

Calibration: ``forward(..., ln_stats=True)`` also returns the per-layer
per-channel abs-max of the two LayerNorm outputs that feed qkv and fc1,
the inputs the int8 path quantizes per token (``quant.smooth_vit``).

Tensor and sequence parallelism (training over a process mesh): a block
split by ``parallel.tp.shard_model_`` (its ``tp``) runs its attention and
MLP pairs on this rank's heads and hidden slice; ``act_sharding``
(``parallel.sp.SeqParallel``) splits the residual stream along S between
the blocks. A config with ``moe_experts > 0`` is the Switch-MoE trunk,
``models.moe.MoEVisionTransformer``: this class refuses it rather than
build a dense trunk for it.
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
                                   ieee_fp32, mha_attention)
from keep_tpu_torch.ops.preprocess import torch_resize_weights


def patchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, H, W, C] → [B, H/P · W/P, P·P·C] patches, flattened (ph, pw, c).
    The embedding is then a plain matmul, which keeps cuDNN's TF32
    convolutions out of the fp32 path."""
    b, h, w, c = x.shape
    gh, gw = h // patch_size, w // patch_size
    x = x.reshape(b, gh, patch_size, gw, patch_size, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # [B, gh, gw, ph, pw, c]
    return x.reshape(b, gh * gw, patch_size * patch_size * c)


def resample_pos_embed(pos_embed: torch.Tensor, grid_hw: tuple[int, int],
                       num_prefix: int) -> torch.Tensor:
    """Bicubic pos-embed resample for another image size (timm
    ``resample_abs_pos_embed``; the reference's ``F.interpolate(mode=
    'bicubic', antialias=True, align_corners=False)``): the square grid of
    [1, prefix + N, D] to ``grid_hw``, as two separable fp32 weight
    products with PyTorch's antialiased bicubic kernel
    (``torch_resize_weights``), the prefix tokens kept. Returns
    ``pos_embed`` itself at its own grid."""
    n = pos_embed.shape[1] - num_prefix
    old = int(round(float(n) ** 0.5))
    gh, gw = grid_hw
    if (old, old) == (gh, gw):
        return pos_embed
    prefix = pos_embed[:, :num_prefix]
    grid = pos_embed[0, num_prefix:].reshape(old, old, -1).float()
    wh, ww = (torch.from_numpy(torch_resize_weights(old, g)).to(grid.device)
              for g in (gh, gw))
    with ieee_fp32():
        grid = torch.tensordot(wh, grid, dims=([1], [0]))  # [gh, old, D]
        grid = torch.einsum("co,hod->hcd", ww, grid)       # [gh, gw, D]
    grid = grid.reshape(1, gh * gw, -1).to(pos_embed.dtype)
    return torch.cat([prefix, grid], dim=1)


def patch_dropout_noise(batch: int, num_patches: int,
                        generator: torch.Generator,
                        device=None) -> torch.Tensor:
    """The uniform [B, N] noise whose ordering picks the kept patches."""
    return torch.rand(batch, num_patches, generator=generator, device=device)


def patch_dropout(tokens: torch.Tensor, noise: torch.Tensor,
                  keep_rate: float, num_prefix: int = 1) -> torch.Tensor:
    """Training-time patch dropout (the reference's PatchDropout,
    transformer.py:47-84): per sample, the prefix tokens and the
    max(1, floor(keep_rate·N)) patches of lowest ``noise`` [B, N], in that
    order. Returns [B, num_prefix + kept, D]."""
    if keep_rate >= 1.0:
        return tokens
    b, s, d = tokens.shape
    num_keep = max(1, int((s - num_prefix) * keep_rate))
    keep = torch.argsort(noise, dim=-1, stable=True)[:, :num_keep] + num_prefix
    kept = torch.gather(tokens, 1, keep[..., None].expand(-1, -1, d))
    return torch.cat([tokens[:, :num_prefix], kept], dim=1)


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
        self.mlp = Mlp(d, cfg.mlp_dim, act=cfg.act, device=device)
        if cfg.layerscale_init is not None:
            self.ls1 = nn.Parameter(torch.full((d,), cfg.layerscale_init,
                                               device=device))
            self.ls2 = nn.Parameter(torch.full((d,), cfg.layerscale_init,
                                               device=device))
        else:
            self.ls1 = self.ls2 = None
        # the tensor-parallel split of this block's pairs
        # (parallel.tp.shard_model_); None: the whole block on every rank
        self.tp = None

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

    def _forward_parallel(self, x: torch.Tensor, seq, *, use_flash: bool,
                          gelu_approx: bool) -> torch.Tensor:
        """The training forward under tensor parallelism (``self.tp``)
        and / or sequence parallelism (``seq``, this tower's
        ``parallel.sp.SeqShard``; ``x`` then holds this rank's rows)."""
        from keep_tpu_torch.parallel import tp as ptp

        attn = ptp.attention_pair(
            self.attn.qkv, self.attn.proj, self.norm1(x), self.cfg.num_heads,
            self.tp, seq, attend=attention_qkv_slab if use_flash else None)
        if self.ls1 is not None:
            attn = attn * self.ls1.to(attn.dtype)
        x = x + attn
        y = ptp.mlp_pair(self.mlp, self.norm2(x), self.tp, seq,
                         gelu_approx=gelu_approx)
        if self.ls2 is not None:
            y = y * self.ls2.to(y.dtype)
        return x + y

    def forward(self, x: torch.Tensor, *, use_flash: bool,
                gelu_approx: bool, fuse_ln: bool = False,
                collect_ln_stats: bool = False, seq=None):
        """The block's branches in the JAX package's order: the int8
        megakernels; then, under ``fuse_ln`` with ``use_flash`` and a float
        qkv, LayerNorm fused into the qkv matmul (``ln_matmul``) feeding the
        slab attention; then the slab attention; then the plain path. The
        MLP half fuses norm2 into fc1 under ``fuse_ln`` with ``use_flash``
        and a float fc1.

        ``collect_ln_stats`` (calibration) also returns the fp32 abs-max
        over batch and tokens of norm1's and norm2's outputs, {"qkv": [D],
        "fc1": [D]}; it needs float linears and no ``fuse_ln``."""
        if self.tp is not None or seq is not None:
            if fuse_ln or collect_ln_stats or isinstance(self.attn.qkv,
                                                         QLinear):
                raise ValueError("tensor / sequence parallelism is a "
                                 "training path: no fuse_ln, int8 or "
                                 "calibration")
            return self._forward_parallel(x, seq, use_flash=use_flash,
                                          gelu_approx=gelu_approx)
        b, s, d = x.shape
        h = self.cfg.num_heads
        gelu_act = self.cfg.act == "gelu"
        if collect_ln_stats and (fuse_ln
                                 or isinstance(self.attn.qkv, QLinear)):
            raise ValueError("LN-stats calibration needs the unfused fp path")
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
            ln1 = self.norm1(x)
            qkv = self.attn.qkv(ln1)  # [B, S, 3D]
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
            ln2 = self.norm2(x)
            y = self.mlp(ln2, gelu_approx=gelu_approx)
        if self.ls2 is not None:
            y = y * self.ls2.to(y.dtype)
        if collect_ln_stats:
            return x + y, {"qkv": ln1.float().abs().amax(dim=(0, 1)),
                           "fc1": ln2.float().abs().amax(dim=(0, 1))}
        return x + y


class VisionTransformer(nn.Module):
    """The image tower; ``ln_pre=True`` adds the OpenAI-CLIP LayerNorm after
    the pos embed (the JAX pytree's ``ln_pre`` leaf)."""

    def __init__(self, cfg: ViTConfig, *, ln_pre: bool = False,
                 device=None):
        super().__init__()
        if cfg.moe_experts != 0:
            raise ValueError(
                "ViTConfig.moe_experts > 0 is the Switch-MoE trunk: build "
                "keep_tpu_torch.models.moe.MoEVisionTransformer")
        d = cfg.embed_dim
        self.cfg = cfg
        self.patch_embed = Linear(cfg.patch_size * cfg.patch_size * 3, d,
                                  device=device)
        self.cls_token = (nn.Parameter(torch.zeros(1, 1, d, device=device))
                          if cfg.num_prefix_tokens >= 1 else None)
        self.pos_embed = nn.Parameter(torch.zeros(
            1, cfg.num_prefix_tokens + cfg.num_patches, d, device=device))
        self.ln_pre = (LayerNorm(d, cfg.ln_eps, device=device) if ln_pre
                       else None)
        self.blocks = nn.ModuleList(
            Block(cfg, device=device) for _ in range(cfg.depth))
        self.norm = LayerNorm(d, cfg.ln_eps, device=device)

    def forward(self, x: torch.Tensor, *, dtype: torch.dtype = torch.float32,
                use_flash: bool = False, gelu_approx: bool = False,
                remat: bool = False, fuse_ln: bool = False,
                patch_dropout_rate: float = 0.0,
                dropout_generator: torch.Generator | None = None,
                ln_stats: bool = False, act_sharding=None):
        """[B, H, W, 3] normalised pixels, any multiple of the patch size
        (the pos embed resampled to its grid) → [B, D] pooled features, or
        [B, S, D] tokens under ``pool="none"``.
        ``remat`` recomputes each block's activations in the backward
        (``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint``
        around the block). ``fuse_ln`` with ``use_flash`` fuses norm1 into
        the qkv matmul and norm2 into fc1 (``kernels.ln_matmul``; float
        GELU blocks only, inference only), as the JAX package's ``fuse_ln``.
        ``patch_dropout_rate > 0`` with a ``dropout_generator`` keeps a
        random 1 − rate of the patch tokens (``patch_dropout``); without a
        generator it is eval mode and keeps them all, as in the JAX package.
        ``ln_stats=True`` returns ``(features, {"qkv": [L, D], "fc1": [L,
        D]})``, each block's LayerNorm-output abs-max (the calibration pass
        of ``quant.smooth_vit``). ``act_sharding`` (a
        ``parallel.sp.SeqParallel``) splits the residual stream along S
        over its group between the blocks (Megatron-SP; training only)."""
        b = x.shape[0]
        cfg = self.cfg
        tokens = self.embed(x, dtype)
        if patch_dropout_rate > 0.0 and dropout_generator is not None:
            noise = patch_dropout_noise(
                b, tokens.shape[1] - cfg.num_prefix_tokens,
                dropout_generator, tokens.device)
            tokens = patch_dropout(tokens, noise, 1.0 - patch_dropout_rate,
                                   cfg.num_prefix_tokens)
        seq = None
        if act_sharding is not None:
            from keep_tpu_torch.parallel.sp import seq_shard

            seq = seq_shard(act_sharding, tokens.shape[1])
            tokens = seq.enter(tokens)
        stats = []
        for blk in self.blocks:
            kw = dict(use_flash=use_flash, gelu_approx=gelu_approx,
                      fuse_ln=fuse_ln, collect_ln_stats=ln_stats)
            if seq is not None:
                kw["seq"] = seq
            if remat:
                tokens = checkpoint(blk, tokens, use_reentrant=False, **kw)
            else:
                tokens = blk(tokens, **kw)
            if ln_stats:
                tokens, st = tokens
                stats.append(st)
        if seq is not None:
            tokens = seq.leave(tokens)
        pooled = self.pool(tokens)
        if ln_stats:
            return pooled, {k: torch.stack([st[k] for st in stats])
                            for k in ("qkv", "fc1")}
        return pooled

    def embed(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The stem: [B, H, W, 3] pixels → [B, S, D] tokens in ``dtype``
        (patchify, the CLS token, the pos embed resampled to the grid, and
        ``ln_pre``)."""
        b, h, w, _ = x.shape
        cfg = self.cfg
        ps = cfg.patch_size
        if h % ps or w % ps:
            raise ValueError(f"image size {(h, w)} not a multiple of "
                             f"patch_size {ps}")
        if cfg.num_prefix_tokens > 1:
            raise ValueError(
                f"num_prefix_tokens={cfg.num_prefix_tokens} unsupported (0 = "
                f"gap ViT, 1 = CLS); register tokens are not implemented")
        x = x.to(dtype)
        tokens = self.patch_embed(patchify(x, ps))
        if self.cls_token is not None:
            cls = self.cls_token.to(dtype).expand(b, 1, cfg.embed_dim)
            tokens = torch.cat([cls, tokens], dim=1)
        pos = resample_pos_embed(self.pos_embed, (h // ps, w // ps),
                                 cfg.num_prefix_tokens)
        tokens = tokens + pos.to(dtype)
        if self.ln_pre is not None:
            tokens = self.ln_pre(tokens)
        return tokens

    def pool(self, tokens: torch.Tensor) -> torch.Tensor:
        """The head: the trunk's [B, S, D] tokens → [B, D] pooled features
        (the final LayerNorm and the pool), or the normalised tokens under
        ``pool="none"``."""
        cfg = self.cfg
        if cfg.pool == "token" and not cfg.fc_norm:
            # LayerNorm is per token, so normalising the pooled CLS row
            # alone equals the JAX package's norm-then-pool
            return self.norm(tokens[:, 0])
        if not cfg.fc_norm:
            tokens = self.norm(tokens)
        if cfg.pool == "token":
            pooled = tokens[:, 0]
        elif cfg.pool == "avg":
            pooled = tokens[:, cfg.num_prefix_tokens:].mean(dim=1)
        else:
            pooled = tokens
        if cfg.fc_norm and cfg.pool in ("token", "avg"):
            # timm's gap-ViT order: pool first, then the LayerNorm
            pooled = self.norm(pooled)
        return pooled


@torch.no_grad()
def init_vit_weights(vit: VisionTransformer,
                     generator: torch.Generator) -> VisionTransformer:
    """Draws ``vit``'s weights in place from ``generator`` with the JAX
    package's ``vit.init`` statistics: linear weights normal with std
    fan_in^-0.5, zero biases, pos embed and CLS token truncated normal
    (±2σ, σ = .02), unit LayerNorms (``ln_pre`` too), LayerScale at
    ``layerscale_init``. Returns ``vit``."""
    for m in vit.modules():
        if isinstance(m, Linear):
            m.weight.normal_(0.0, m.weight.shape[1] ** -0.5,
                             generator=generator)
            m.bias.zero_()
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    for t in (vit.pos_embed, vit.cls_token):
        if t is not None:
            nn.init.trunc_normal_(t, 0.0, 0.02, -0.04, 0.04,
                                  generator=generator)
    for blk in vit.blocks:
        for gamma in (blk.ls1, blk.ls2):
            if gamma is not None:
                gamma.fill_(vit.cfg.layerscale_init)
    return vit


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
