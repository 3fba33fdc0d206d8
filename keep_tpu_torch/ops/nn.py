"""Shared NN ops of the encoders (counterpart of ``keep_tpu/ops/nn.py``).

Conventions, as in the JAX package:
- Matmuls run in the activation dtype with fp32 accumulation; the bias is
  added in fp32 and the sum cast back to the activation dtype.
- LayerNorm and softmax always run in fp32.
- ``Linear`` keeps the torch layout, ``weight [out, in]``; the JAX package's
  ``kernel [in, out]`` is its transpose.
- ``QLinear`` is the W8A8 form (the JAX package's ``kernel_q`` leaves, made
  by ``keep_tpu_torch.quant``): it runs through ``kernels.qmatmul``, and
  ``Mlp`` takes the fused int8 pair when both of its linears are quantized
  and the GELU is the tanh form, as ``keep_tpu.ops.nn.mlp`` does.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch import nn


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """GELU: exact erf by default, the tanh form with ``approximate=True``."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


class _LinearRoundOnce(torch.autograd.Function):
    """x @ wᵀ + b for a bf16 (or other narrow) x, rounded once: the product
    of the narrow operands stays in fp32, the fp32 bias is added, and only
    the sum is cast to x's dtype, as ``keep_tpu.ops.nn.linear`` does with
    ``preferred_element_type=float32``: the product in fp32 (on the card
    cuBLAS's ``mm`` with ``out_dtype=float32``; on the CPU an fp32 product
    of the narrow values, each product exact in fp32), then one pass that
    adds the bias in fp32 and writes x's dtype. The backward is the one
    ``F.linear`` autograd gives for the narrow product: dx = dy·w and
    dw = dyᵀ·x in x's dtype (dw then cast to w's dtype), and db = dy summed
    in fp32."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        w = weight.to(x.dtype)
        x2 = x.reshape(-1, x.shape[-1])
        if x.is_cuda:
            acc = torch.mm(x2, w.t(), out_dtype=torch.float32)
        else:
            acc = F.linear(x2.float(), w.float())
        out = torch.empty(acc.shape, dtype=x.dtype, device=x.device)
        torch.add(acc, bias.float(), out=out)  # fp32 sum, one rounding
        ctx.save_for_backward(x, w)
        ctx.weight_dtype, ctx.bias_shape = weight.dtype, bias.shape
        return out.view(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = dy.matmul(w)
        if ctx.needs_input_grad[1]:
            dw = (dy.reshape(-1, dy.shape[-1]).t()
                  .matmul(x.reshape(-1, x.shape[-1]))).to(ctx.weight_dtype)
        if ctx.needs_input_grad[2]:
            db = dy.float().sum_to_size(ctx.bias_shape)
        return dx, dw, db


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None) -> torch.Tensor:
    """x @ weightᵀ in x's dtype with fp32 accumulation, + the fp32 bias,
    rounded once to x's dtype (``_LinearRoundOnce`` for a narrow x)."""
    if bias is None:
        return F.linear(x, weight.to(x.dtype))
    if x.dtype != torch.float32:
        return _LinearRoundOnce.apply(x, weight, bias)
    return F.linear(x, weight.to(x.dtype)) + bias.float()


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm in fp32 whatever the activation dtype; result in x's dtype."""
    y = F.layer_norm(x.float(), x.shape[-1:], weight.float(), bias.float(), eps)
    return y.to(x.dtype)


def mha_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  bias: torch.Tensor | None = None,
                  out_dtype: torch.dtype | None = None,
                  use_flash: bool = False) -> torch.Tensor:
    """Multi-head attention over [B, H, S, Dh].

    The plain path: scores are taken in fp32 from the input values (a
    bf16·bf16 product is exact in fp32), softmax runs in fp32, p is cast to
    v's dtype, and p·v is accumulated in fp32 before the cast to
    ``out_dtype`` (default: v's dtype). ``bias`` is any additive mask
    broadcastable to [B, H, S, S].

    ``use_flash=True`` routes to ``kernels.flash_attention.flash_attention``
    (the hand-written kernel on a CUDA tensor), as the JAX package routes to
    its Pallas kernel: it takes only [B, 1, 1, S] key masks, raises on full
    score-level biases, returns v's dtype and is inference-only."""
    if use_flash:
        # imported here: kernels.flash_attention imports this module
        from keep_tpu_torch.kernels.flash_attention import flash_attention

        if out_dtype is not None and out_dtype != v.dtype:
            raise ValueError("mha_attention(use_flash=True) returns v's dtype; "
                             "out_dtype is for the plain path")
        return flash_attention(q, k, v, bias=bias)
    scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(probs.float(), v.float())
    return out.to(v.dtype if out_dtype is None else out_dtype)


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """``F.normalize`` semantics, x / max(||x||, eps), computed in fp32."""
    return F.normalize(x.float(), dim=dim, eps=eps).to(x.dtype)


def tf32_state() -> tuple:
    """cuBLAS's fp32-matmul precision as PyTorch's two APIs hold it: (the
    legacy ``allow_tf32``, or None where reading it raises because only
    ``fp32_precision`` was set, and ``fp32_precision``)."""
    matmul = torch.backends.cuda.matmul
    try:
        legacy = matmul.allow_tf32
    except RuntimeError:
        legacy = None
    return legacy, matmul.fp32_precision


def restore_tf32(state: tuple) -> None:
    """Put back a ``tf32_state()``, in the API(s) it was set through."""
    legacy, precision = state
    if legacy is not None:
        torch.backends.cuda.matmul.allow_tf32 = legacy
    torch.backends.cuda.matmul.fp32_precision = precision


_ieee_lock = threading.Lock()
_ieee_depth = 0
_ieee_saved: tuple = ()


@contextlib.contextmanager
def ieee_fp32():
    """fp32 products at full fp32 precision, whatever the caller's TF32
    setting: the WSI sweep's fp32 einsums (scores, screening, the bicubic
    passes) feed strict thresholds and roundings, which TF32's 10-bit
    mantissa would move.

    The setting is process-global, so for the duration every thread's fp32
    products run at full precision. Nested and concurrent uses share one
    depth count: the first to enter saves the caller's setting and the
    last to leave restores it."""
    global _ieee_depth, _ieee_saved
    with _ieee_lock:
        if _ieee_depth == 0:
            _ieee_saved = tf32_state()
            # the legacy setter sets both APIs' state consistently
            torch.backends.cuda.matmul.allow_tf32 = False
        _ieee_depth += 1
    try:
        yield
    finally:
        with _ieee_lock:
            _ieee_depth -= 1
            if _ieee_depth == 0:
                restore_tf32(_ieee_saved)


class Linear(nn.Module):
    """A linear layer over ``linear``. Its parameters are created empty and
    filled from a state dict (``compat.torch_loader``)."""

    def __init__(self, in_features: int, out_features: int, *,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device))
        # the fp32 values a state dict brought into a narrower weight, kept
        # on the host for ``quantize_source``
        self.fp32_weight: torch.Tensor | None = None

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        w = state_dict.get(prefix + "weight")
        self.fp32_weight = (
            w.detach().to("cpu").contiguous()
            if isinstance(w, torch.Tensor) and w.dtype == torch.float32
            and self.weight.dtype != torch.float32 else None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def quantize_source(self) -> torch.Tensor:
        """The values to quantize this weight from, on its device: the fp32
        values it was loaded from when it stores them rounded to a narrower
        dtype and still holds exactly that rounding (the JAX package keeps
        fp32 parameters under any compute dtype and quantizes those), else
        the stored weight."""
        w = self.weight.detach()
        if self.fp32_weight is not None:
            w32 = self.fp32_weight.to(w.device)
            if torch.equal(w32.to(w.dtype), w):
                return w32
        return w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class QLinear(nn.Module):
    """W8A8 linear: int8 ``weight_q`` [out, in] with per-output-channel fp32
    ``weight_scale`` [out], fp32 ``bias`` [out], and an optional SmoothQuant
    ``pre_scale`` [in] that multiplies the activations before they are
    quantized per row. Inference only: all four are buffers. Built by
    ``keep_tpu_torch.quant.quantize_linear_weights``, or loaded from a
    state dict (``compat.torch_loader.from_jax_params``)."""

    def __init__(self, in_features: int, out_features: int, *, device=None):
        super().__init__()
        self.register_buffer("weight_q", torch.zeros(
            out_features, in_features, dtype=torch.int8, device=device))
        self.register_buffer("weight_scale",
                             torch.ones(out_features, device=device))
        self.register_buffer("bias", torch.zeros(out_features, device=device))
        self.register_buffer("pre_scale", None)

    @classmethod
    def from_quantized(cls, weight_q: torch.Tensor, weight_scale: torch.Tensor,
                       bias: torch.Tensor,
                       pre_scale: torch.Tensor | None = None) -> "QLinear":
        """A QLinear holding the given int8 weight, scales and bias."""
        out_features, in_features = weight_q.shape
        m = cls(in_features, out_features, device=weight_q.device)
        m.weight_q = weight_q.detach().to(torch.int8).contiguous()
        m.weight_scale = weight_scale.detach().float().contiguous()
        m.bias = bias.detach().float().contiguous()
        if pre_scale is not None:
            m.pre_scale = pre_scale.detach().float().contiguous()
        return m

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # the optional pre_scale buffer exists once a state dict brings one
        key = prefix + "pre_scale"
        if key in state_dict and self.pre_scale is None:
            self.pre_scale = torch.empty(state_dict[key].shape,
                                         device=self.weight_scale.device)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from keep_tpu_torch.kernels.qmatmul import qlinear_fused

        return qlinear_fused(self, x)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class Mlp(nn.Module):
    """fc1 → GELU → fc2 (timm ``Mlp`` / BERT intermediate + output).

    With the tanh GELU and a quantized fc1, the int8 kernels take over: the
    fused pair (``kernels.qmlp``) when fc2 is quantized too, else fc1 with
    the GELU in its epilogue (``kernels.qmatmul``)."""

    def __init__(self, dim: int, hidden: int, *, device=None):
        super().__init__()
        self.fc1 = Linear(dim, hidden, device=device)
        self.fc2 = Linear(hidden, dim, device=device)

    def forward(self, x: torch.Tensor, gelu_approx: bool = False) -> torch.Tensor:
        if gelu_approx and isinstance(self.fc1, QLinear):
            if isinstance(self.fc2, QLinear):
                from keep_tpu_torch.kernels.qmlp import qmlp_fused

                return qmlp_fused(self.fc1, self.fc2, x)
            from keep_tpu_torch.kernels.qmatmul import qlinear_fused

            return self.fc2(qlinear_fused(self.fc1, x, activation="gelu_tanh"))
        return self.fc2(gelu(self.fc1(x), approximate=gelu_approx))
