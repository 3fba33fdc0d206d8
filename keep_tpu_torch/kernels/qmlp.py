"""The int8 MLP pair: fc1 → tanh-GELU → fc2, W8A8 end to end.

Counterpart of ``keep_tpu/kernels/qmlp.py`` ``quantized_mlp_bsd`` (the
Pallas kernel at :227, over [B, S, D]), ``quantized_mlp`` (the Pallas
kernel at :97, over flat [M, D] rows) and ``qmlp_fused``:

  (pre-LN?) (·pre_scale1?) → quantize → int8 fc1 [D, F] → acc·(a·s) + bias
  → tanh-GELU → re-quantize over the full F row → int8 fc2 [F, D]
  → acc·(a·s) + bias → + x (``residual``) or LN(x + ·) (``post_ln``)

On the TPU the [rows·S, F] hidden never leaves VMEM. An H100 SM has 227 KB,
and the re-quantization needs the abs-max of a whole 4·D hidden row before
any of it can be quantized, so here the chain is four or five kernels
(``_kops``): ``quant_rows`` → ``int8_gemm`` (fc1 + GELU epilogue) writing
the hidden in **fp32** to device memory → ``quant_rows`` over full rows →
``int8_gemm`` (fc2 + residual) → ``ln_rows`` for the post-LN tail. The fp32
hidden keeps the TPU kernel's numerics (no bf16 round before the
re-quantization) at the cost of M·F·4 bytes written and read once (413 MB
for ViT-L at B=128). The post-LN sum ``x + ·`` stays fp32 between the GEMM
and the LN, which rounds once, as on the TPU.

``rows`` (batch rows per TPU program) is accepted and checked as on the
TPU; every step here is per token over the whole batch, so the result is
the same for every value.

The flat ``quantized_mlp`` is the same chain with no LayerNorm and no
residual, over [M, D] rows (the TPU kernel's 256-row tiles): every step is
per token, so it equals ``quantized_mlp_bsd`` on the same rows bit for bit.
``qmlp_fused`` takes it for inputs that are not 3-D, as the JAX package
does, and ``quantized_mlp_bsd`` for [B, S, D].
"""

from __future__ import annotations

import torch

from keep_tpu_torch.kernels import _kops


def _check(x, w1_q, w2_q, ln_scale, ln_bias, post_ln, rows):
    if x.dim() != 3:
        raise ValueError(f"quantized_mlp_bsd takes [B, S, D], got "
                         f"{tuple(x.shape)}")
    b, _, d = x.shape
    f = w1_q.shape[0]
    if tuple(w1_q.shape) != (f, d) or tuple(w2_q.shape) != (d, f):
        raise ValueError(f"fc1 must be [F, {d}] and fc2 [{d}, F], got "
                         f"{tuple(w1_q.shape)} and {tuple(w2_q.shape)}")
    if (ln_scale is None) != (ln_bias is None):
        raise ValueError("ln_scale and ln_bias go together")
    if post_ln and ln_scale is None:
        raise ValueError("post_ln=True needs ln_scale/ln_bias (the exit norm)")
    if rows < 1 or b % rows:
        raise ValueError(f"rows={rows} must be a positive divisor of "
                         f"batch {b}")


def _mlp(ops: _kops.Ops, x, w1_q, w1_scale, b1, w2_q, w2_scale, b2, out_dtype,
         ln_scale, ln_bias, eps, residual, post_ln, pre_scale1):
    """The chain over x [..., D] (every step per token); the output has x's
    shape."""
    d = x.shape[-1]
    x2 = x.contiguous().view(-1, d)
    pre_ln = ln_scale is not None and not post_ln
    xq, a1 = ops.quant_rows(x2, ln_scale if pre_ln else None,
                            ln_bias if pre_ln else None, eps,
                            pre_scale=pre_scale1)
    h = ops.int8_gemm(xq, a1, w1_q, w1_scale, b1,
                      order=_kops.DEQUANT_PAIRED, gelu=True,
                      out_dtype=torch.float32)
    hq, a2 = ops.quant_rows(h)
    if post_ln:
        y = ops.int8_gemm(hq, a2, w2_q, w2_scale, b2,
                          order=_kops.DEQUANT_PAIRED, residual=x2,
                          out_dtype=torch.float32)
        out = ops.ln_rows(y, ln_scale, ln_bias, eps, out_dtype)
    else:
        out = ops.int8_gemm(hq, a2, w2_q, w2_scale, b2,
                            order=_kops.DEQUANT_PAIRED,
                            residual=x2 if residual else None,
                            out_dtype=out_dtype)
    return out.view(x.shape)


def quantized_mlp_bsd_reference(x, w1_q, w1_scale, b1, w2_q, w2_scale, b2,
                                out_dtype=torch.bfloat16, ln_scale=None,
                                ln_bias=None, eps=1e-6, residual=False,
                                post_ln=False, rows=1, pre_scale1=None):
    """The plain version of ``quantized_mlp_bsd``."""
    _check(x, w1_q, w2_q, ln_scale, ln_bias, post_ln, rows)
    return _mlp(_kops.PLAIN, x, w1_q, w1_scale, b1, w2_q, w2_scale, b2,
                out_dtype, ln_scale, ln_bias, eps, residual, post_ln,
                pre_scale1)


def quantized_mlp_bsd(x: torch.Tensor,
                      w1_q: torch.Tensor, w1_scale: torch.Tensor,
                      b1: torch.Tensor,
                      w2_q: torch.Tensor, w2_scale: torch.Tensor,
                      b2: torch.Tensor,
                      out_dtype: torch.dtype = torch.bfloat16,
                      ln_scale: torch.Tensor | None = None,
                      ln_bias: torch.Tensor | None = None,
                      eps: float = 1e-6,
                      residual: bool = False,
                      post_ln: bool = False,
                      rows: int = 1,
                      pre_scale1: torch.Tensor | None = None) -> torch.Tensor:
    """x [B, S, D] × int8 fc1 ``w1_q`` [F, D] → tanh-GELU → int8 fc2
    ``w2_q`` [D, F] → [B, S, D] ``out_dtype``.

    ``w*_scale`` are per-output-channel dequant scales ([F] and [D]).
    ``ln_scale``/``ln_bias`` apply a pre-LayerNorm to the input;
    ``residual=True`` adds the raw input to the output (the pre-LN block's
    ``x + mlp(ln(x))``); ``post_ln=True`` instead computes the post-LN tail
    ``LN(x + mlp(x))`` with ``ln_scale``/``ln_bias`` as the exit norm.
    ``pre_scale1`` [D] (SmoothQuant 1/s) multiplies fc1's quantize input.
    ``rows`` must divide B and does not change the result."""
    _check(x, w1_q, w2_q, ln_scale, ln_bias, post_ln, rows)
    ops = _kops.ops_for(x)
    out = _mlp(ops, x, w1_q, w1_scale, b1, w2_q, w2_scale, b2, out_dtype,
               ln_scale, ln_bias, eps, residual, post_ln, pre_scale1)
    if ops is _kops.KERNELS:
        _kops.count("quantized_mlp_bsd")
    return out


def _check_flat(x, w1_q, w2_q):
    if x.dim() != 2:
        raise ValueError(f"quantized_mlp takes [M, D], got {tuple(x.shape)}")
    d = x.shape[1]
    f = w1_q.shape[0]
    if tuple(w1_q.shape) != (f, d) or tuple(w2_q.shape) != (d, f):
        raise ValueError(f"fc1 must be [F, {d}] and fc2 [{d}, F], got "
                         f"{tuple(w1_q.shape)} and {tuple(w2_q.shape)}")


def quantized_mlp_reference(x, w1_q, w1_scale, b1, w2_q, w2_scale, b2,
                            out_dtype=torch.bfloat16, pre_scale1=None):
    """The plain version of ``quantized_mlp``."""
    _check_flat(x, w1_q, w2_q)
    return _mlp(_kops.PLAIN, x, w1_q, w1_scale, b1, w2_q, w2_scale, b2,
                out_dtype, None, None, 1e-6, False, False, pre_scale1)


def quantized_mlp(x: torch.Tensor,
                  w1_q: torch.Tensor, w1_scale: torch.Tensor, b1: torch.Tensor,
                  w2_q: torch.Tensor, w2_scale: torch.Tensor, b2: torch.Tensor,
                  out_dtype: torch.dtype = torch.bfloat16,
                  pre_scale1: torch.Tensor | None = None) -> torch.Tensor:
    """x [M, D] × int8 fc1 ``w1_q`` [F, D] → tanh-GELU → int8 fc2 ``w2_q``
    [D, F] → [M, D] ``out_dtype``: per-row quantize (× ``pre_scale1`` [D],
    SmoothQuant 1/s, first), fc1 dequant acc·(a·s) + bias, GELU, re-quantize
    over the full F row, fc2 dequant + bias. ``w*_scale`` are the
    per-output-channel scales ([F] and [D]). Equals ``quantized_mlp_bsd`` on
    the same rows bit for bit. A CUDA tensor goes through the kernels
    (``_kops``), a CPU tensor through the plain versions."""
    _check_flat(x, w1_q, w2_q)
    ops = _kops.ops_for(x)
    out = _mlp(ops, x, w1_q, w1_scale, b1, w2_q, w2_scale, b2, out_dtype,
               None, None, 1e-6, False, False, pre_scale1)
    if ops is _kops.KERNELS:
        _kops.count("quantized_mlp")
    return out


def qmlp_fused(fc1, fc2, x: torch.Tensor) -> torch.Tensor:
    """MLP over [..., D] inputs through the int8 pair, as the JAX package's
    ``qmlp_fused``: [B, S, D] through ``quantized_mlp_bsd``, any other rank
    flattened to [M, D] rows through ``quantized_mlp`` and reshaped back.
    ``fc1`` and ``fc2`` are ``ops.nn.QLinear``s; fc1's SmoothQuant
    ``pre_scale`` rides into the quantize step. The output has x's dtype."""
    args = (fc1.weight_q, fc1.weight_scale, fc1.bias, fc2.weight_q,
            fc2.weight_scale, fc2.bias)
    if x.dim() == 3:
        return quantized_mlp_bsd(x, *args, out_dtype=x.dtype,
                                 pre_scale1=fc1.pre_scale)
    out = quantized_mlp(x.reshape(-1, x.shape[-1]), *args, out_dtype=x.dtype,
                        pre_scale1=fc1.pre_scale)
    return out.reshape(*x.shape[:-1], out.shape[-1])
