"""Post-training int8 (W8A8) quantization for inference (counterpart of
``keep_tpu/quant.py``).

Scheme, as in the JAX package: per-output-channel abs-max int8 weights,
dynamic per-row (per-token) int8 activations, an fp32 dequant epilogue.
``quantize_linear_weights`` swaps every targeted ``ops.nn.Linear`` of a
module for an ``ops.nn.QLinear``; the models dispatch on that type, so the
int8 kernels run with no change to the forward code.

``quantize_kernel`` divides (``round(w / scale)``), as the JAX package's
does, so that the port's int8 codes and scales equal the JAX package's bit
for bit when both start from the same fp32 weights.

Not ported yet: SmoothQuant calibration (``ln_stats``, ``smooth_vit``,
``smooth_bert``), the MoE targets and the weight-only W8A16 marker. A JAX
tree that was already smoothed and quantized loads as it is
(``compat.torch_loader.from_jax_params``), its ``pre_scale`` leaves
included.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from keep_tpu_torch.ops.nn import Linear, QLinear

# module names whose Linear is quantized (the big matmuls); heads, poolers
# and embeddings stay in the float dtype
DEFAULT_TARGETS = ("qkv", "proj", "fc1", "fc2", "out", "patch_embed")


def quantize_kernel(weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp weight [N, K] (torch layout) → (int8 codes [N, K], fp32 scales
    [N]): per output channel, ``scale = max(amax, 1e-8) / 127`` and
    ``q = clip(round(w / scale), ±127)`` with round half to even. Both
    divisions are tensor by tensor, so that no backend turns them into a
    multiply by a reciprocal."""
    w = weight.float()
    amax = w.abs().amax(dim=-1, keepdim=True)  # over K
    scale = amax.clamp_min(1e-8) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(-1)


def _eligible(name: str, ancestors: tuple, targets: Sequence[str]) -> bool:
    # path-aware, as in the JAX package: ``proj`` is the attention output
    # projection only (parent ``attn``), and nothing under ``rel_pos`` is
    # touched; a projection head named ``proj`` stays in the float dtype
    if name not in targets or "rel_pos" in ancestors:
        return False
    parent = ancestors[-1] if ancestors else ""
    return name != "proj" or parent == "attn"


@torch.no_grad()
def quantize_linear_weights(model: nn.Module,
                            targets: Sequence[str] = DEFAULT_TARGETS
                            ) -> nn.Module:
    """Swaps, in place, every ``Linear`` named in ``targets`` (path-aware)
    for a ``QLinear`` quantized from its stored weight. Returns ``model``."""

    def visit(mod: nn.Module, ancestors: tuple) -> None:
        for name, child in mod.named_children():
            if isinstance(child, Linear) and _eligible(name, ancestors,
                                                       targets):
                q, s = quantize_kernel(child.weight)
                setattr(mod, name, QLinear.from_quantized(q, s, child.bias))
            else:
                visit(child, ancestors + (name,))

    visit(model, ())
    return model


def is_quantized(model: nn.Module) -> bool:
    """True if any submodule is a ``QLinear``: the tree already went through
    ``quantize_linear_weights``, and quantizing again would corrupt it."""
    return any(isinstance(m, QLinear) for m in model.modules())
