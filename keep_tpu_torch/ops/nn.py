"""Shared NN ops of the encoders (counterpart of ``keep_tpu/ops/nn.py``).

Conventions, as in the JAX package:
- Matmuls run in the activation dtype with fp32 accumulation; the bias is
  added in fp32 and the sum cast back to the activation dtype.
- LayerNorm and softmax always run in fp32.
- ``Linear`` keeps the torch layout, ``weight [out, in]``; the JAX package's
  ``kernel [in, out]`` is its transpose.

The int8 W8A8 branches (``kernel_q``) are not ported yet: an int8 weight
raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """GELU: exact erf by default, the tanh form with ``approximate=True``."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def _check_float_weight(weight: torch.Tensor) -> None:
    if not weight.is_floating_point():
        raise NotImplementedError(
            f"quantized ({weight.dtype}) linear weights are not supported by "
            f"the PyTorch port yet; serve the bf16 model")


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None) -> torch.Tensor:
    """x @ weightᵀ in x's dtype (fp32 accumulation), + fp32 bias, cast back."""
    _check_float_weight(weight)
    out = F.linear(x, weight.to(x.dtype))
    if bias is None:
        return out
    return (out.float() + bias.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm in fp32 whatever the activation dtype; result in x's dtype."""
    y = F.layer_norm(x.float(), x.shape[-1:], weight.float(), bias.float(), eps)
    return y.to(x.dtype)


def mha_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  bias: torch.Tensor | None = None) -> torch.Tensor:
    """Multi-head attention over [B, H, S, Dh], the plain (non-kernel) path.

    Scores are taken in fp32 from the input values (a bf16·bf16 product is
    exact in fp32), softmax runs in fp32, p is cast to v's dtype, and p·v is
    accumulated in fp32 before the cast back. ``bias`` is any additive mask
    broadcastable to [B, H, S, S]."""
    scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(v.dtype)


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """``F.normalize`` semantics, x / max(||x||, eps), computed in fp32."""
    return F.normalize(x.float(), dim=dim, eps=eps).to(x.dtype)


class Linear(nn.Module):
    """A linear layer over ``linear``. Its parameters are created empty and
    filled from a state dict (``compat.torch_loader``)."""

    def __init__(self, in_features: int, out_features: int, *,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class Mlp(nn.Module):
    """fc1 → GELU → fc2 (timm ``Mlp`` / BERT intermediate + output)."""

    def __init__(self, dim: int, hidden: int, *, device=None):
        super().__init__()
        self.fc1 = Linear(dim, hidden, device=device)
        self.fc2 = Linear(hidden, dim, device=device)

    def forward(self, x: torch.Tensor, gelu_approx: bool = False) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x), approximate=gelu_approx))
