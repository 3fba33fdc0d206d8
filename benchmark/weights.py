"""Seeded fp32 weights of a KEEP configuration, in the released checkpoint's
layout (timm ViT keys under ``visual.``, the 2-layer visual head as
``visual_head.0`` / ``.2``, HF BERT keys under ``text.``).

The benchmark makes the weights itself and hands the same state dict to the
program (through its checkpoint loader) and to the reference, so that
neither side takes anything the other made. They are drawn on the device
from one ``torch.Generator`` in two calls (one normal draw for every
Gaussian leaf, one uniform draw for the LayerScale gammas), then cut into
leaves and scaled:

- matrices (linear and conv weights): normal, std fan_in^-0.5;
- LayerNorm gains: 1 + normal(0.1); LayerScale gammas: uniform [0.1, 0.5],
  so that every block moves the residual stream (timm's 1e-5 init leaves
  a random tower close to identity, and a wrong kernel would not show);
- biases, embeddings, the CLS token and the position table: normal(0.02).
"""

from __future__ import annotations

import math

import torch

# the published text length cap; released checkpoints store the scale in log
LOGIT_SCALE_INIT = 0.04


def released_shapes(model: dict) -> dict[str, tuple]:
    """Every key of a released KEEP state dict with its shape, from the
    configuration file's ``model`` group."""
    v, t = model["vision"], model["text"]
    d, p = v["embed_dim"], v["patch_size"]
    f = int(d * v["mlp_ratio"])
    n_patch = (v["img_size"] // p) ** 2
    shapes: dict[str, tuple] = {
        "visual.patch_embed.proj.weight": (d, 3, p, p),
        "visual.patch_embed.proj.bias": (d,),
        "visual.cls_token": (1, 1, d),
        "visual.pos_embed": (1, 1 + n_patch, d),
        "visual.norm.weight": (d,), "visual.norm.bias": (d,),
    }
    lin = {"attn.qkv": (3 * d, d), "attn.proj": (d, d), "mlp.fc1": (f, d),
           "mlp.fc2": (d, f)}
    for i in range(v["depth"]):
        b = f"visual.blocks.{i}"
        for n, shape in lin.items():
            shapes[f"{b}.{n}.weight"] = shape
            shapes[f"{b}.{n}.bias"] = shape[:1]
        for n in ("norm1", "norm2"):
            shapes[f"{b}.{n}.weight"] = shapes[f"{b}.{n}.bias"] = (d,)
        shapes[f"{b}.ls1.gamma"] = shapes[f"{b}.ls2.gamma"] = (d,)
    k = model["projection_dim"]
    shapes.update({"visual_head.0.weight": (k, d), "visual_head.0.bias": (k,),
                   "visual_head.2.weight": (k, k), "visual_head.2.bias": (k,)})
    h, ff = t["hidden_size"], t["intermediate_size"]
    e = "text.embeddings"
    shapes.update({
        f"{e}.word_embeddings.weight": (t["vocab_size"], h),
        f"{e}.position_embeddings.weight": (t["max_position_embeddings"], h),
        f"{e}.token_type_embeddings.weight": (t["type_vocab_size"], h),
        f"{e}.LayerNorm.weight": (h,), f"{e}.LayerNorm.bias": (h,),
        "text.pooler.dense.weight": (h, h), "text.pooler.dense.bias": (h,),
    })
    blk = {"attention.self.query": (h, h), "attention.self.key": (h, h),
           "attention.self.value": (h, h), "attention.output.dense": (h, h),
           "intermediate.dense": (ff, h), "output.dense": (h, ff)}
    for i in range(t["num_hidden_layers"]):
        b = f"text.encoder.layer.{i}"
        for n, shape in blk.items():
            shapes[f"{b}.{n}.weight"] = shape
            shapes[f"{b}.{n}.bias"] = shape[:1]
        for n in ("attention.output.LayerNorm", "output.LayerNorm"):
            shapes[f"{b}.{n}.weight"] = shapes[f"{b}.{n}.bias"] = (h,)
    return shapes


def _kind(key: str, shape: tuple) -> str:
    if key.endswith(".gamma"):
        return "gamma"
    if key.endswith(("norm.weight", "norm1.weight", "norm2.weight",
                     "LayerNorm.weight")):
        return "ln_gain"
    if len(shape) >= 2 and key.endswith(".weight") and "embeddings" not in key:
        return "matrix"
    return "small"


@torch.no_grad()
def make_state_dict(model: dict, seed: int, device) -> dict:
    """The seeded fp32 state dict of the configuration's ``model`` group on
    ``device``; the same seed gives the same values."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shapes = released_shapes(model)
    gauss = {k: s for k, s in shapes.items() if _kind(k, s) != "gamma"}
    gammas = {k: s for k, s in shapes.items() if _kind(k, s) == "gamma"}
    normal = torch.randn(sum(math.prod(s) for s in gauss.values()),
                         generator=gen, device=device)
    uniform = torch.rand(sum(math.prod(s) for s in gammas.values()),
                         generator=gen, device=device)
    out: dict[str, torch.Tensor] = {}
    at = 0
    for key, shape in gauss.items():
        n = math.prod(shape)
        t = normal[at: at + n].view(shape)
        at += n
        kind = _kind(key, shape)
        if kind == "matrix":
            t.mul_(math.prod(shape[1:]) ** -0.5)
        elif kind == "ln_gain":
            t.mul_(0.1).add_(1.0)
        else:
            t.mul_(0.02)
        out[key] = t
    at = 0
    for key, shape in gammas.items():
        n = math.prod(shape)
        out[key] = uniform[at: at + n].view(shape).mul_(0.4).add_(0.1)
        at += n
    out["logit_scale"] = torch.tensor(math.log(1.0 / LOGIT_SCALE_INIT),
                                      device=device)
    return out
