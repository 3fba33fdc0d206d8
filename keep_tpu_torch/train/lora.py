"""LoRA adapters for parameter-efficient fine-tuning (counterpart of
``keep_tpu/train/lora.py``).

Rank-r factors train on the attention and MLP linears while the released
weights stay frozen: ``ΔW = (α/r)·A@B``, ~1% of ViT-L + BERT-base's
parameters at r = 8.

The adapters are a dict of named tensors keyed by the model's parameter
names. For each targeted linear ``<m>`` (an ``ops.nn.Linear``, ``weight
[out, in]``) they hold ``<m>.lora_a [in, r]``, drawn N(0, in^-1/2), and
``<m>.lora_b [r, out]``, zero, so that the merged model at step 0 is the
base exactly; plus a trainable copy of ``logit_scale``. ``a`` and ``b``
are the JAX package's factors as they are (its ``kernel [in, out]`` is the
transpose of ``weight``), so the merge is ``W' = W + (scale · a @ b)ᵀ``.

The model is not changed to train them: ``apply_lora`` returns the merged
tensors, and ``swapped`` puts them in the modules' parameter slots for the
span of a train step, forward and backward both (remat recomputes each
block in the backward, which must see the weights the forward saw), then
puts the parameters back. Gradients reach the adapters through the merge:
the backward takes each target's full-size dW', then da and db from it, as
XLA's autodiff of the JAX package's ``apply_lora`` does.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Mapping, Sequence

import torch
from torch import nn

DEFAULT_TARGETS = ("qkv", "proj", "out", "fc1", "fc2")


def adapted_modules(adapters: Mapping[str, torch.Tensor]) -> list[str]:
    """The names of the linears that ``adapters`` carry factors for."""
    return [k[: -len(".lora_a")] for k in adapters if k.endswith(".lora_a")]


@torch.no_grad()
def init_lora(params: Mapping[str, torch.Tensor], rank: int,
              targets: Sequence[str] = DEFAULT_TARGETS,
              generator: torch.Generator | None = None,
              dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """Adapters for every module named in ``targets`` whose ``weight`` is a
    matrix, on that weight's device: ``a`` from ``generator``, ``b`` = 0,
    and ``logit_scale`` copied. ``params`` is a model's named parameters or
    state dict. Raises if no target matches (a mistyped target list would
    otherwise train nothing)."""
    if rank <= 0:
        raise ValueError(f"rank must be positive, got {rank}")
    targets = tuple(targets)
    out: dict[str, torch.Tensor] = {}
    for name, w in params.items():
        module, _, leaf = name.rpartition(".")
        if (leaf != "weight" or w.ndim != 2
                or module.rpartition(".")[2] not in targets):
            continue
        n_out, d = w.shape
        a = torch.randn(d, rank, generator=generator, device=w.device)
        out[f"{module}.lora_a"] = (a * d ** -0.5).to(dtype)
        out[f"{module}.lora_b"] = torch.zeros(rank, n_out, dtype=dtype,
                                              device=w.device)
    if not out:
        raise ValueError(
            f"no module named {targets} with a weight matrix found in params")
    if "logit_scale" in params:
        out["logit_scale"] = params["logit_scale"].detach().clone()
    return out


def apply_lora(base: Mapping[str, torch.Tensor],
               adapters: Mapping[str, torch.Tensor],
               scale: float) -> dict[str, torch.Tensor]:
    """The merged tensors: each adapted ``weight`` becomes ``W + (scale ·
    a @ b)ᵀ`` in W's dtype, the adapters' ``logit_scale`` replaces base's,
    and every other entry is base's. ``scale`` is α / r."""
    out = dict(base)
    for module in adapted_modules(adapters):
        w = base[f"{module}.weight"]
        delta = (adapters[f"{module}.lora_a"]
                 @ adapters[f"{module}.lora_b"]) * scale
        out[f"{module}.weight"] = w + delta.t().to(w.dtype)
    if "logit_scale" in adapters:
        out["logit_scale"] = adapters["logit_scale"]
    return out


def merge_lora(base: Mapping[str, torch.Tensor],
               adapters: Mapping[str, torch.Tensor],
               scale: float) -> dict[str, torch.Tensor]:
    """``apply_lora`` under the name an export or a server looks for."""
    return apply_lora(base, adapters, scale)


@torch.no_grad()
def merge_into_model(model: nn.Module, adapters: Mapping[str, torch.Tensor],
                     scale: float) -> None:
    """Bakes ``adapters`` into ``model``'s float linears in place. Each sum
    is taken from the fp32 values the weight holds or was loaded from
    (``ops.nn.Linear.quantize_source``), kept as its fp32 values
    (``fp32_weight`` where the stored weight is narrower) and rounded once
    into the stored weight, so that ``quantize()`` afterwards quantizes the
    merged fp32 values, as the JAX package does. ``logit_scale`` is the
    adapters'."""
    from keep_tpu_torch.ops.nn import Linear

    modules = adapted_modules(adapters)
    linears = {m: model.get_submodule(m) for m in modules}
    bad = [m for m, lin in linears.items() if not isinstance(lin, Linear)]
    if bad:
        raise TypeError(f"LoRA merges into float linears; {bad[:3]} are "
                        f"not (merge before quantizing)")
    device = model.logit_scale.device
    ad = {k: v.to(device) for k, v in adapters.items()}
    base = {f"{m}.weight": lin.quantize_source().float()
            for m, lin in linears.items()}
    merged = apply_lora(base, ad, scale)
    for m, lin in linears.items():
        w32 = merged[f"{m}.weight"]
        narrow = lin.weight.dtype != torch.float32
        lin.weight.data = w32.to(lin.weight.dtype)
        lin.fp32_weight = w32.cpu() if narrow else None
    if "logit_scale" in ad:
        model.logit_scale.copy_(ad["logit_scale"])


@contextlib.contextmanager
def swapped(model: nn.Module,
            tensors: Mapping[str, torch.Tensor]) -> Iterator[nn.Module]:
    """``model`` with ``tensors`` in the slots of its parameters of the same
    names for the span of the block; the parameters themselves are not
    touched and are back in their slots afterwards. Keep the backward of
    a remat forward inside the block: it recomputes blocks from the
    slots."""
    saved = []
    try:
        for name, t in tensors.items():
            module, _, leaf = name.rpartition(".")
            owner = model.get_submodule(module)
            if leaf not in owner._parameters:
                raise KeyError(f"{name} is not a parameter of the model")
            saved.append((owner, leaf, owner._parameters[leaf]))
            owner._parameters[leaf] = t
        yield model
    finally:
        for owner, leaf, p in reversed(saved):
            owner._parameters[leaf] = p


def lora_param_count(adapters: Mapping[str, torch.Tensor]) -> tuple[int, int]:
    """(adapter values, of which a / b factors), for the log line."""
    total = sum(math.prod(t.shape) for t in adapters.values())
    ab = sum(math.prod(t.shape) for k, t in adapters.items()
             if k.endswith((".lora_a", ".lora_b")))
    return total, ab
