"""The int8 attention sub-blocks of both towers.

Counterpart of ``keep_tpu/kernels/qblock.py``:

- ``quantized_attention_block`` (Pallas kernel at :79), the ViT pre-LN
  sub-block: x + proj(MHA(qkv(LN(x)))) with int8 qkv and proj;
- ``quantized_attention_block_postln`` (:182), the BERT post-LN sub-block:
  LN(x + out(MHA(qkv(x·pre_scale)))) with int8 qkv and out and an additive
  key mask.

The TPU kernel keeps one batch row's [S, D] stream, its [S, 3D] slab and an
fp32 [S, D] attention scratch in VMEM. Here the same math runs as five
kernels over the whole batch (``_kops``): ``quant_rows`` (with the LN or
``pre_scale`` in front) → ``int8_gemm`` writing the **bf16** slab →
``attention_qkv_slab`` with **fp32** output (the TPU scratch; on the card
its own ``wgmma`` body, whose sums the tensor cores take in another order
than the plain version, so the block is held to it at the JAX package's
tolerance between two routes through the same int8 weights) →
``quant_rows`` over full D rows → ``int8_gemm`` adding the raw residual x in
fp32; the post-LN form writes that sum in fp32 and ``ln_rows`` normalises
it, so the result is rounded once. The residual and the exit LN use the raw
x, never x·pre_scale. Dequant is ``acc·(a·s)``, as in the TPU kernel.

LayerScale must be folded into proj first (``models.vit.fold_layerscale``,
which ``KEEPModel.quantize`` runs).
"""

from __future__ import annotations

import torch

from keep_tpu_torch.kernels import _kops


def _block(ops: _kops.Ops, x, norm, qkv, proj, key_bias, *, num_heads, eps,
           post_ln):
    b, s, d = x.shape
    if tuple(qkv.weight_q.shape) != (3 * d, d) or tuple(
            proj.weight_q.shape) != (d, d):
        raise ValueError(f"qkv must be [{3 * d}, {d}] and the projection "
                         f"[{d}, {d}], got {tuple(qkv.weight_q.shape)} and "
                         f"{tuple(proj.weight_q.shape)}")
    x2 = x.contiguous().view(b * s, d)
    if post_ln:
        yq, a1 = ops.quant_rows(x2, pre_scale=qkv.pre_scale)
    else:
        yq, a1 = ops.quant_rows(x2, norm.weight, norm.bias, eps)
    slab = ops.int8_gemm(yq, a1, qkv.weight_q, qkv.weight_scale, qkv.bias,
                         order=_kops.DEQUANT_PAIRED, out_dtype=torch.bfloat16)
    attn = ops.attention(slab.view(b, s, 3 * d), key_bias,
                         num_heads=num_heads, out_dtype=torch.float32)
    aq, a2 = ops.quant_rows(attn.view(b * s, d))
    if post_ln:
        y = ops.int8_gemm(aq, a2, proj.weight_q, proj.weight_scale, proj.bias,
                          order=_kops.DEQUANT_PAIRED, residual=x2,
                          out_dtype=torch.float32)
        out = ops.ln_rows(y, norm.weight, norm.bias, eps, x.dtype)
    else:
        out = ops.int8_gemm(aq, a2, proj.weight_q, proj.weight_scale,
                            proj.bias, order=_kops.DEQUANT_PAIRED,
                            residual=x2, out_dtype=x.dtype)
    return out.view(b, s, d)


def quantized_attention_block_reference(x, norm1, qkv, proj, *, num_heads,
                                        eps):
    """The plain version of ``quantized_attention_block``."""
    return _block(_kops.PLAIN, x, norm1, qkv, proj, None, num_heads=num_heads,
                  eps=eps, post_ln=False)


def quantized_attention_block(x: torch.Tensor, norm1, qkv, proj, *,
                              num_heads: int, eps: float) -> torch.Tensor:
    """x [B, S, D] → x + proj(MHA(qkv(LN(x)))) with int8 qkv and proj.

    ``norm1``: the block's LayerNorm (``weight``, ``bias``); ``qkv`` and
    ``proj``: ``ops.nn.QLinear``s (LayerScale folded into proj)."""
    ops = _kops.ops_for(x)
    out = _block(ops, x, norm1, qkv, proj, None, num_heads=num_heads, eps=eps,
                 post_ln=False)
    if ops is _kops.KERNELS:
        _kops.count("quantized_attention_block")
    return out


def quantized_attention_block_postln_reference(x, key_bias, norm, qkv, out, *,
                                               num_heads, eps):
    """The plain version of ``quantized_attention_block_postln``."""
    return _block(_kops.PLAIN, x, norm, qkv, out, key_bias,
                  num_heads=num_heads, eps=eps, post_ln=True)


def quantized_attention_block_postln(x: torch.Tensor, key_bias: torch.Tensor,
                                     norm, qkv, out, *, num_heads: int,
                                     eps: float) -> torch.Tensor:
    """x [B, S, D] → LN(x + out(MHA(qkv(x)))) with int8 qkv and out: the
    BERT post-LN attention sub-block. ``key_bias`` [B, S] fp32 (0 valid,
    −1e9 padded) is added to the scores; ``norm`` is the sub-block's exit
    LayerNorm. A ``pre_scale`` on ``qkv`` (SmoothQuant) multiplies only the
    quantize input."""
    ops = _kops.ops_for(x)
    res = _block(ops, x, norm, qkv, out, key_bias, num_heads=num_heads,
                 eps=eps, post_ln=True)
    if ops is _kops.KERNELS:
        _kops.count("quantized_attention_block_postln")
    return res
