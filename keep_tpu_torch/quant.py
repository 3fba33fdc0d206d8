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

SmoothQuant calibration (Xiao et al., 2022): ``smooth_vit`` folds a
per-input-channel scale ``s`` into the ViT's LayerNorm → qkv / fc1 edges
(the LN affine divided by s, the weight's input columns multiplied by it);
``smooth_bert`` stores ``pre_scale = 1/s`` beside BERT's qkv and fc1
instead, since post-LN residuals forbid the fold. Both are exact in fp and
move activation outliers into the per-channel weight scales. They change
the modules they are given in place, computing in fp32 from each weight's
fp32 source values (``ops.nn.Linear.quantize_source``) and keeping the
smoothed fp32 values as that source; ``KEEPModel.quantize`` runs them on its
copy of the model. The statistics come from the towers' ``ln_stats``
forwards.

The Switch-MoE trunk (``models.moe``): ``MOE_TARGETS`` adds the experts'
``wi`` / ``wo`` (``ExpertLinear`` → ``QExpertLinear``, one scale per
(expert, column)); the router stays fp32. ``weight_only`` marks targets
W8A16 (the JAX ``w_only`` marker). ``smooth_moe`` folds the qkv edge as
``smooth_vit`` does and norm2's scale, shared by every expert, into both
the router and each expert's ``wi``, so that routing does not move.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from keep_tpu_torch.ops.nn import LayerNorm, Linear, QLinear, ieee_fp32

# module names whose Linear is quantized (the big matmuls); heads, poolers
# and embeddings stay in the float dtype
DEFAULT_TARGETS = ("qkv", "proj", "fc1", "fc2", "out", "patch_embed")
# the MoE experts carry the trunk's FLOPs; the router stays fp32 (its argmax
# places the tokens)
MOE_TARGETS = DEFAULT_TARGETS + ("wi", "wo")


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
    if name in ("wi", "wo") and parent != "moe":
        return False
    return name != "proj" or parent == "attn"


@torch.no_grad()
def quantize_linear_weights(model: nn.Module,
                            targets: Sequence[str] = DEFAULT_TARGETS,
                            weight_only: Sequence[str] = ()) -> nn.Module:
    """Swaps, in place, every ``Linear`` named in ``targets`` (path-aware)
    for a ``QLinear`` (an MoE ``ExpertLinear`` for a ``QExpertLinear``)
    quantized from its stored weight; expert linears named in
    ``weight_only`` become W8A16. Returns ``model``."""
    from keep_tpu_torch.models.moe import ExpertLinear, QExpertLinear

    def visit(mod: nn.Module, ancestors: tuple) -> None:
        for name, child in mod.named_children():
            if isinstance(child, Linear) and _eligible(name, ancestors,
                                                       targets):
                q, s = quantize_kernel(child.weight)
                if isinstance(child, ExpertLinear):
                    new = QExpertLinear.from_quantized(
                        q, s, child.bias, w_only=name in weight_only)
                elif name in weight_only:
                    raise ValueError(f"{name}: weight-only int8 is for the "
                                     f"MoE expert linears")
                else:
                    new = QLinear.from_quantized(q, s, child.bias,
                                                 child.pre_scale)
                setattr(mod, name, new)
            else:
                visit(child, ancestors + (name,))

    visit(model, ())
    return model


def is_quantized(model: nn.Module) -> bool:
    """True if any submodule is a ``QLinear`` or ``QExpertLinear``: the tree
    already went through ``quantize_linear_weights``, and quantizing again
    would corrupt it."""
    from keep_tpu_torch.models.moe import QExpertLinear

    return any(isinstance(m, (QLinear, QExpertLinear))
               for m in model.modules())


@torch.no_grad()
def quantization_error(fp_model: nn.Module, q_model: nn.Module) -> dict:
    """Largest relative weight reconstruction error of each quantized
    linear: for every ``Linear`` of ``fp_model`` whose module of the same
    name in ``q_model`` is a ``QLinear`` (or ``QExpertLinear``),
    max |w − q·scale| / max |w| over the weight as stored, in fp32 (over a
    zero weight: max |q·scale|), keyed by the module's dotted name."""
    from keep_tpu_torch.models.moe import QExpertLinear

    q_mods = dict(q_model.named_modules())
    out = {}
    for name, lin in fp_model.named_modules():
        q = q_mods.get(name)
        if not (isinstance(lin, Linear)
                and isinstance(q, (QLinear, QExpertLinear))):
            continue
        w = lin.weight.detach().float().cpu()
        r = q.weight_q.float().cpu() * q.weight_scale.float().cpu()[..., None]
        denom = float(w.abs().max()) or 1.0
        out[name] = float((w - r).abs().max()) / denom
    return out


def smooth_scales(act_amax, weight: torch.Tensor,
                  alpha: float = 0.5) -> torch.Tensor:
    """SmoothQuant's per-input-channel equalisation scale for a weight
    [N, K] (torch layout) and the activation abs-max [K] of its input:
    ``s = a^alpha / w^(1 - alpha)`` with ``w`` the weight's abs-max per
    input channel, normalised to geometric mean 1 and clipped to [1e-3,
    1e3]; degenerate statistics are floored at 1e-8. In fp32."""
    w = weight.float().abs().amax(dim=-2).clamp_min(1e-8)
    a = torch.as_tensor(act_amax, dtype=torch.float32,
                        device=w.device).clamp_min(1e-8)
    s = a.pow(alpha) / w.pow(1.0 - alpha)
    s = s / torch.exp(torch.log(s).mean(dim=-1, keepdim=True))
    return s.clamp(1e-3, 1e3)


@torch.no_grad()
def _fold_smooth(norm: LayerNorm, lin: Linear, act_amax,
                 alpha: float) -> None:
    """Divides the LayerNorm's affine by s and multiplies the linear's input
    columns by it: (LN(x)/s)·(s·W) = LN(x)·W exactly in real arithmetic,
    and the outliers move into W, where per-channel scales absorb them.
    The affine is computed in fp32 and rounded once to its dtype."""
    w32 = lin.quantize_source().float()
    s = smooth_scales(act_amax, w32, alpha)
    for p in (norm.weight, norm.bias):
        p.data = (p.data.float() / s).to(p.dtype)
    lin.set_source(w32 * s)


@torch.no_grad()
def _prescale_lin(lin: Linear, act_amax, alpha: float) -> None:
    """Smooths a linear with no affine op before it: its input columns are
    multiplied by s and ``pre_scale = 1/s`` multiplies the input before the
    product (inside the per-token quantize once quantized):
    (x/s)·(s·W) = x·W exactly in real arithmetic."""
    w32 = lin.quantize_source().float()
    s = smooth_scales(act_amax, w32, alpha)
    lin.set_source(w32 * s)
    lin.pre_scale = torch.ones_like(s) / s


def smooth_vit(vit: nn.Module, stats: dict, alpha: float = 0.5) -> nn.Module:
    """SmoothQuant at the ViT's two LayerNorm → linear edges (norm1 → qkv,
    norm2 → fc1), in place; ``stats`` from ``vit(..., ln_stats=True)``.
    The other two linears' inputs (the attention output, the GELU output)
    have no affine op before them to fold into. Returns ``vit``."""
    for i, blk in enumerate(vit.blocks):
        _fold_smooth(blk.norm1, blk.attn.qkv, stats["qkv"][i], alpha)
        _fold_smooth(blk.norm2, blk.mlp.fc1, stats["fc1"][i], alpha)
    return vit


def smooth_bert(bert: nn.Module, stats: dict, alpha: float = 0.5
                ) -> nn.Module:
    """SmoothQuant for the post-LN BERT tower's qkv and fc1, in the
    ``pre_scale`` form (their inputs also feed the residual stream, so a
    LayerNorm fold would change the model), in place; ``stats`` from
    ``bert(..., ln_stats=True)``. Returns ``bert``."""
    for i, blk in enumerate(bert.blocks):
        _prescale_lin(blk.attn.qkv, stats["qkv"][i], alpha)
        _prescale_lin(blk.mlp.fc1, stats["fc1"][i], alpha)
    return bert


@torch.no_grad()
def smooth_moe(vit: nn.Module, stats: dict, alpha: float = 0.5
               ) -> nn.Module:
    """SmoothQuant (the LayerNorm-fold form) for the Switch-MoE trunk, in
    place; ``stats`` from ``moe_ln_stats``. The qkv edge folds as in
    ``smooth_vit``. norm2's output feeds the router and every expert's
    ``wi``: one scale s per input channel, shared by the experts (against
    the abs-max over all experts' ``wi`` rows), divides norm2 and
    multiplies both consumers' input columns, so that the router's logits
    are the same in real arithmetic and no token changes expert. Returns
    ``vit``."""
    for i, blk in enumerate(vit.blocks):
        _fold_smooth(blk.norm1, blk.attn.qkv, stats["qkv"][i], alpha)
        wi, router = blk.moe.wi, blk.moe.router
        w32 = wi.quantize_source().float()  # [E, F, D]
        s = smooth_scales(stats["wi"][i], w32.reshape(-1, w32.shape[-1]),
                          alpha)
        for p in (blk.norm2.weight, blk.norm2.bias):
            p.data = (p.data.float() / s).to(p.dtype)
        wi.set_source(w32 * s)
        router.weight.data = (router.weight.float() * s).to(
            router.weight.dtype)
    return vit


@torch.no_grad()
def moe_ln_stats(vit: nn.Module, calib_pixels) -> dict:
    """The MoE trunk's LayerNorm-output statistics on ``calib_pixels``
    ({"qkv": [L, D], "wi": [L, D]}): an fp32 forward with full fp32
    products, as ``vit_ln_stats``."""
    with ieee_fp32():
        _, _, stats = vit(_on(vit, calib_pixels, torch.float32),
                          dtype=torch.float32, ln_stats=True)
    return stats


def calibrate_smooth_moe(vit: nn.Module, calib_pixels,
                         alpha: float = 0.5) -> nn.Module:
    """``moe_ln_stats`` on ``calib_pixels``, folded in by ``smooth_moe``."""
    return smooth_moe(vit, moe_ln_stats(vit, calib_pixels), alpha)


def smooth_quantize_moe_vit(vit: nn.Module, calib_pixels,
                            alpha: float = 0.5) -> nn.Module:
    """Calibrate → smooth → quantize the MoE trunk (experts included), in
    place. Returns ``vit``."""
    return quantize_linear_weights(
        calibrate_smooth_moe(vit, calib_pixels, alpha), MOE_TARGETS)


def _on(module: nn.Module, x, dtype=None) -> torch.Tensor:
    """``x`` as a tensor on ``module``'s device."""
    return torch.as_tensor(x, dtype=dtype).to(
        next(module.parameters()).device)


@torch.no_grad()
def vit_ln_stats(vit: nn.Module, calib_pixels) -> dict:
    """The ViT's LayerNorm-output statistics on ``calib_pixels`` [N, H, W,
    3] (normalised): an fp32 forward with plain attention and full fp32
    products (no TF32), as the JAX package calibrates."""
    with ieee_fp32():
        _, stats = vit(_on(vit, calib_pixels, torch.float32),
                       dtype=torch.float32, ln_stats=True)
    return stats


@torch.no_grad()
def bert_ln_stats(bert: nn.Module, input_ids, attention_mask=None) -> dict:
    """BERT's qkv- and fc1-input statistics on a token batch, pad positions
    masked out: an fp32 forward with plain attention, as ``vit_ln_stats``."""
    mask = (None if attention_mask is None
            else _on(bert, attention_mask, torch.long))
    with ieee_fp32():
        _, stats = bert(_on(bert, input_ids, torch.long), mask,
                        dtype=torch.float32, ln_stats=True)
    return stats


def smooth_quantize_vit(vit: nn.Module, calib_pixels,
                        alpha: float = 0.5) -> nn.Module:
    """Calibrate on ``calib_pixels`` → fold LayerScale → smooth → quantize
    the ViT, in place (the fold keeps the LN outputs, so it may follow the
    statistics; the int8 megakernels need it). Returns ``vit``."""
    from keep_tpu_torch.models.vit import fold_layerscale

    stats = vit_ln_stats(vit, calib_pixels)
    return quantize_linear_weights(
        smooth_vit(fold_layerscale(vit), stats, alpha))


def smooth_quantize_bert(bert: nn.Module, input_ids, attention_mask=None,
                         alpha: float = 0.5) -> nn.Module:
    """Calibrate on a token batch → smooth (``pre_scale`` form) → quantize
    the BERT tower, in place. Returns ``bert``."""
    stats = bert_ln_stats(bert, input_ids, attention_mask)
    return quantize_linear_weights(smooth_bert(bert, stats, alpha))
