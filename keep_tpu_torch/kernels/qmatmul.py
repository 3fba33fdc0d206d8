"""W8A8 linear: per-row quantize → int8 dot → dequant (+ tanh-GELU).

Counterpart of ``keep_tpu/kernels/qmatmul.py``: ``quantized_matmul`` (the
Pallas kernel at :80, flat [M, K]), ``quantized_matmul_bsd`` (:151, over
[B, S, K]) and ``qlinear_fused``. The TPU kernel runs the whole chain on a
VMEM tile; here it is two kernels, ``quant_rows`` and ``int8_gemm``
(``_kops``), with the activation codes and row scales passing through device
memory between them (M·(K + 4) bytes).

The bsd form exists on the TPU to avoid a relayout of [B, 197, K]; a
contiguous CUDA tensor [B, S, K] already is [B·S, K], so both forms run the
same kernels and differ only in which launch they count.

Weights are in the torch layout: ``w_q`` int8 [N, K] with per-output-channel
scales ``w_scale`` [N] (the JAX package's ``kernel_q`` [K, N] transposed).
The dequant is ``acc·a·s`` left to right, as in the TPU kernel.
"""

from __future__ import annotations

import torch

from keep_tpu_torch.kernels import _kops


def _qmm(ops: _kops.Ops, x2: torch.Tensor, w_q, w_scale, bias, activation,
         out_dtype, pre_scale, block=None) -> torch.Tensor:
    if activation not in (None, "gelu_tanh"):
        raise ValueError(f"unknown activation {activation!r}; expected None "
                         f"or 'gelu_tanh'")
    xq, a = ops.quant_rows(x2, pre_scale=pre_scale)
    return ops.int8_gemm(xq, a, w_q, w_scale, bias, order=_kops.DEQUANT_LEFT,
                         gelu=activation == "gelu_tanh", out_dtype=out_dtype,
                         block=block)


def quantized_matmul_reference(x, w_q, w_scale, bias, activation=None,
                               out_dtype=torch.bfloat16, pre_scale=None):
    """The plain version of ``quantized_matmul``."""
    return _qmm(_kops.PLAIN, x, w_q, w_scale, bias, activation, out_dtype,
                pre_scale)


def quantized_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                     bias: torch.Tensor, activation: str | None = None,
                     out_dtype: torch.dtype = torch.bfloat16,
                     pre_scale: torch.Tensor | None = None) -> torch.Tensor:
    """x [M, K] (bf16/fp32) × int8 w_q [N, K] (+ scale [N], bias [N]) →
    [M, N] ``out_dtype``; optional fused tanh-GELU epilogue. ``pre_scale``
    [K] (SmoothQuant 1/s) multiplies the quantize input in-kernel."""
    if x.dim() != 2:
        raise ValueError(f"quantized_matmul takes [M, K], got {tuple(x.shape)}")
    return _qmm(_kops.ops_for(x), x.contiguous(), w_q, w_scale, bias,
                activation, out_dtype, pre_scale, block="quantized_matmul")


def quantized_matmul_bsd_reference(x, w_q, w_scale, bias, activation=None,
                                   out_dtype=torch.bfloat16, pre_scale=None):
    """The plain version of ``quantized_matmul_bsd``."""
    b, s, k = x.shape
    return _qmm(_kops.PLAIN, x.reshape(b * s, k), w_q, w_scale, bias,
                activation, out_dtype, pre_scale).reshape(b, s, -1)


def quantized_matmul_bsd(x: torch.Tensor, w_q: torch.Tensor,
                         w_scale: torch.Tensor, bias: torch.Tensor,
                         activation: str | None = None,
                         out_dtype: torch.dtype = torch.bfloat16,
                         pre_scale: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """``quantized_matmul`` over [B, S, K] activations → [B, S, N]."""
    if x.dim() != 3:
        raise ValueError(f"quantized_matmul_bsd takes [B, S, K], got "
                         f"{tuple(x.shape)}")
    b, s, k = x.shape
    out = _qmm(_kops.ops_for(x), x.contiguous().view(b * s, k), w_q, w_scale,
               bias, activation, out_dtype, pre_scale,
               block="quantized_matmul_bsd")
    return out.view(b, s, -1)


def qlinear_fused(lin, x: torch.Tensor,
                  activation: str | None = None) -> torch.Tensor:
    """Quantized linear over [..., K] inputs. ``lin`` carries ``weight_q``,
    ``weight_scale``, ``bias`` and an optional SmoothQuant ``pre_scale``
    (``ops.nn.QLinear``). 3-D inputs take the bsd form, others are flattened
    to [M, K]; the output has x's dtype."""
    args = (lin.weight_q, lin.weight_scale, lin.bias)
    kw = dict(activation=activation, out_dtype=x.dtype,
              pre_scale=lin.pre_scale)
    if x.dim() == 3:
        return quantized_matmul_bsd(x, *args, **kw)
    out = quantized_matmul(x.reshape(-1, x.shape[-1]), *args, **kw)
    return out.reshape(*x.shape[:-1], out.shape[-1])
