"""The port's KEEP weights back to the released checkpoint layout
(``config.json`` + ``pytorch_model.bin``), and the int8 deploy artifact
(counterpart of ``keep_tpu/compat/export.py``).

``to_keep_state_dict`` inverts ``compat.torch_loader.load_keep_state_dict``
bit for bit (timm ViT keys, HF BERT keys with q / k / v split back out of
the fused projection), so that a user of the reference, or of the JAX
package (``keep_tpu.models.keep.KEEPModel.from_pretrained``), loads weights
trained here.

``save_quantized`` writes the int8 model a serving process loads as it is
(``KEEPModel.from_pretrained``, ``serve --int8``): quantize once offline,
with SmoothQuant calibration data that a server does not have. The JAX
package's artifact is an Orbax checkpoint under ``quantized/``, which its
``from_pretrained`` takes whenever that directory exists; the port's lives
under ``QUANTIZED_SUBDIR`` beside it, so that one model directory can hold
both.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Mapping

import torch
from torch import nn

from keep_tpu_torch.configs import BertConfig, KEEPConfig, ViTConfig

QUANTIZED_SUBDIR = "quantized_torch"
QUANTIZED_FILE = "model.pt"
QUANTIZED_FORMAT = "keep_tpu_torch/int8-w8a8/1"


def _t(sd: Mapping, k: str) -> torch.Tensor:
    return sd[k].detach().to("cpu")


def vit_to_timm_state_dict(sd: Mapping, cfg: ViTConfig,
                           prefix: str = "visual.") -> dict:
    """The port's ``VisionTransformer`` entries under ``prefix`` → timm key
    layout: the ``[D, P·P·3]`` patch matmul back to the ``[D, 3, P, P]``
    conv, LayerScale gammas as ``ls{1,2}.gamma``."""
    g = lambda k: _t(sd, prefix + k)  # noqa: E731
    p, d = cfg.patch_size, cfg.embed_dim
    out = {"patch_embed.proj.weight": g("patch_embed.weight").reshape(
               d, p, p, 3).permute(0, 3, 1, 2).contiguous(),
           "patch_embed.proj.bias": g("patch_embed.bias"),
           "cls_token": g("cls_token"), "pos_embed": g("pos_embed")}
    for i in range(cfg.depth):
        b = f"blocks.{i}."
        for n in ("norm1", "attn.qkv", "attn.proj", "norm2", "mlp.fc1",
                  "mlp.fc2"):
            out[f"{b}{n}.weight"] = g(f"{b}{n}.weight")
            out[f"{b}{n}.bias"] = g(f"{b}{n}.bias")
        if prefix + b + "ls1" in sd:
            out[b + "ls1.gamma"] = g(b + "ls1")
            out[b + "ls2.gamma"] = g(b + "ls2")
    out["norm.weight"] = g("norm.weight")
    out["norm.bias"] = g("norm.bias")
    return out


def bert_to_hf_state_dict(sd: Mapping, cfg: BertConfig,
                          prefix: str = "text.") -> dict:
    """The port's ``BertModel`` entries under ``prefix`` → HF ``BertModel``
    key layout, the fused ``[3D, D]`` qkv split into query, key, value."""
    g = lambda k: _t(sd, prefix + k)  # noqa: E731
    e = "embeddings"
    out = {f"{e}.word_embeddings.weight": g(f"{e}.word"),
           f"{e}.position_embeddings.weight": g(f"{e}.position"),
           f"{e}.token_type_embeddings.weight": g(f"{e}.token_type"),
           f"{e}.LayerNorm.weight": g(f"{e}.norm.weight"),
           f"{e}.LayerNorm.bias": g(f"{e}.norm.bias")}
    names = {"attention.output.dense": "attn.out",
             "attention.output.LayerNorm": "attn.norm",
             "intermediate.dense": "mlp.fc1", "output.dense": "mlp.fc2",
             "output.LayerNorm": "norm"}
    for i in range(cfg.num_hidden_layers):
        src, dst = f"blocks.{i}.", f"encoder.layer.{i}."
        w = g(src + "attn.qkv.weight").chunk(3, dim=0)
        b = g(src + "attn.qkv.bias").chunk(3, dim=0)
        for j, n in enumerate(("query", "key", "value")):
            out[f"{dst}attention.self.{n}.weight"] = w[j].contiguous()
            out[f"{dst}attention.self.{n}.bias"] = b[j].contiguous()
        for theirs, ours in names.items():
            out[f"{dst}{theirs}.weight"] = g(f"{src}{ours}.weight")
            out[f"{dst}{theirs}.bias"] = g(f"{src}{ours}.bias")
    out["pooler.dense.weight"] = g("pooler.weight")
    out["pooler.dense.bias"] = g("pooler.bias")
    return out


def _model_state_dict(model: nn.Module) -> dict:
    """A float model's state dict with each linear weight as the fp32
    values it was loaded from, where a narrower stored dtype rounded them
    (``ops.nn.Linear.quantize_source``): what the released layout holds."""
    from keep_tpu_torch.ops.nn import Linear
    from keep_tpu_torch.quant import is_quantized

    if is_quantized(model):
        raise ValueError("a quantized model has no float weights to export; "
                         "write it with save_quantized")
    sd = dict(model.state_dict())
    for name, m in model.named_modules():
        if isinstance(m, Linear):
            sd[f"{name}.weight"] = m.quantize_source()
    return sd


def to_keep_state_dict(model_or_sd, cfg: KEEPConfig | None = None) -> dict:
    """A ``KEEPModel`` (or its state dict, with ``cfg``) → the released HF
    layout, the inverse of ``load_keep_state_dict``."""
    if isinstance(model_or_sd, nn.Module):
        cfg = cfg or model_or_sd.cfg
        sd = _model_state_dict(model_or_sd)
    else:
        sd = model_or_sd
        if cfg is None:
            raise ValueError("a state dict needs its KEEPConfig")
    if any(k.endswith("weight_q") for k in sd):
        raise ValueError("a quantized model has no float weights to export; "
                         "write it with save_quantized")
    out = {f"visual.{k}": v for k, v in
           vit_to_timm_state_dict(sd, cfg.vision).items()}
    for theirs, ours in (("visual_head.0", "visual_head.fc1"),
                         ("visual_head.2", "visual_head.fc2")):
        out[f"{theirs}.weight"] = _t(sd, f"{ours}.weight")
        out[f"{theirs}.bias"] = _t(sd, f"{ours}.bias")
    out.update({f"text.{k}": v for k, v in
                bert_to_hf_state_dict(sd, cfg.text).items()})
    out["logit_scale"] = _t(sd, "logit_scale")
    return out


def _config_dict(cfg: KEEPConfig) -> dict:
    return {
        "model_type": "keep",
        "projection_dim": cfg.projection_dim,
        "max_text_length": cfg.max_text_length,
        "vision_config": dataclasses.asdict(cfg.vision),
        "text_config": {
            "vocab_size": cfg.text.vocab_size,
            "hidden_size": cfg.text.hidden_size,
            "num_hidden_layers": cfg.text.num_hidden_layers,
            "num_attention_heads": cfg.text.num_attention_heads,
            "intermediate_size": cfg.text.intermediate_size,
            "max_position_embeddings": cfg.text.max_position_embeddings,
            "type_vocab_size": cfg.text.type_vocab_size,
            "layer_norm_eps": cfg.text.ln_eps,
            "pad_token_id": cfg.text.pad_token_id,
        },
    }


def _atomic(path: str, write) -> None:
    """Runs ``write(tmp_path)``, then renames the file into ``path``, so a
    reader never sees half a file."""
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    os.close(fd)
    try:
        write(tmp)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def _write_config(model_dir: str, cfg: KEEPConfig) -> None:
    def write(tmp):
        with open(tmp, "w") as f:
            json.dump(_config_dict(cfg), f, indent=2)

    _atomic(os.path.join(model_dir, "config.json"), write)


def save_pretrained(model_dir: str, model_or_sd,
                    cfg: KEEPConfig | None = None) -> None:
    """Write ``config.json`` + ``pytorch_model.bin`` (fp32) in the
    published layout, loadable by the reference, by the JAX package's
    ``KEEPModel.from_pretrained`` and by this package's."""
    cfg = cfg or model_or_sd.cfg
    sd = {k: v.float().contiguous()
          for k, v in to_keep_state_dict(model_or_sd, cfg).items()}
    os.makedirs(model_dir, exist_ok=True)
    _write_config(model_dir, cfg)
    _atomic(os.path.join(model_dir, "pytorch_model.bin"),
            lambda tmp: torch.save(sd, tmp))


def save_quantized(model_dir: str, model: nn.Module) -> None:
    """Write the int8 deploy artifact of a quantized ``KEEPModel``
    (``KEEPModel.quantize(...)``): ``config.json`` and
    ``QUANTIZED_SUBDIR/QUANTIZED_FILE``, one ``torch.save`` of the model's
    state dict with its dtypes kept (the int8 codes, the fp32 scales, the
    SmoothQuant ``pre_scale`` rows, the LayerScale folded into proj and
    fc2), its compute dtype and GELU form and the names of its int8
    linears. An MoE trunk's int8 experts (``QExpertLinear``: ``weight_q``
    [E, out, in], ``weight_scale``, ``bias``, and the W8A16 ``w_only``
    marker) are written with their names and form, its fp32 router in the
    state dict and its ``moe_*`` fields in the config, as the JAX package
    writes any quantized tree. The weights are about half the fp32
    ``pytorch_model.bin``."""
    from keep_tpu_torch.models.moe import QExpertLinear
    from keep_tpu_torch.ops.nn import QLinear
    from keep_tpu_torch.quant import is_quantized

    if not is_quantized(model):
        raise ValueError(
            "save_quantized expects an already-quantized model "
            "(KEEPModel.quantize(...)) — got unquantized linears")
    payload = {
        "format": QUANTIZED_FORMAT,
        "config": _config_dict(model.cfg),
        "dtype": str(model.dtype).removeprefix("torch."),
        "gelu_approx": model.gelu_approx,
        "quantized": sorted(n for n, m in model.named_modules()
                            if isinstance(m, QLinear)),
        # an MoE trunk's int8 experts and their form (W8A16 under w_only)
        "quantized_experts": {n: m.w_only for n, m in model.named_modules()
                              if isinstance(m, QExpertLinear)},
        # tensors to the host; an expert's extra state ({"w_only": ...}) as
        # it is
        "state_dict": {k: v.detach().to("cpu") if torch.is_tensor(v) else v
                       for k, v in model.state_dict().items()},
    }
    qdir = os.path.join(model_dir, QUANTIZED_SUBDIR)
    os.makedirs(qdir, exist_ok=True)
    _write_config(model_dir, model.cfg)
    _atomic(os.path.join(qdir, QUANTIZED_FILE),
            lambda tmp: torch.save(payload, tmp))


def load_quantized(model_dir: str, use_flash: bool = False,
                   device=None) -> nn.Module:
    """The model ``save_quantized`` wrote into ``model_dir``, on ``device``
    (the caller's, already checked), in the artifact's compute dtype and
    GELU form: the int8 linears (and an MoE trunk's int8 experts) rebuilt
    where the artifact names them, LayerScale folded (the dense trunk; the
    MoE trunk has none), then every tensor loaded as written."""
    from keep_tpu_torch.models.keep import KEEPModel
    from keep_tpu_torch.models.moe import QExpertLinear
    from keep_tpu_torch.models.vit import fold_layerscale
    from keep_tpu_torch.ops.nn import QLinear, cast_linear_weights

    with open(os.path.join(model_dir, QUANTIZED_SUBDIR, QUANTIZED_FILE),
              "rb") as f:
        payload = torch.load(f, map_location="cpu", weights_only=True)
    if payload.get("format") != QUANTIZED_FORMAT:
        raise ValueError(f"{model_dir}: not an int8 artifact of this "
                         f"package (format {payload.get('format')!r})")
    cfg = KEEPConfig.from_hf_dict(payload["config"])
    dtype = getattr(torch, payload["dtype"])
    model = KEEPModel(cfg, dtype=dtype, use_flash=use_flash,
                      gelu_approx=payload["gelu_approx"], device=device)
    if not model.moe:
        with torch.no_grad():
            fold_layerscale(model.visual)
    for name in payload["quantized"]:
        parent, _, leaf = name.rpartition(".")
        lin = model.get_submodule(name)
        setattr(model.get_submodule(parent), leaf, QLinear(
            lin.weight.shape[1], lin.weight.shape[0], device=device))
    for name, w_only in payload.get("quantized_experts", {}).items():
        parent, _, leaf = name.rpartition(".")
        e, n, k = model.get_submodule(name).weight.shape
        setattr(model.get_submodule(parent), leaf, QExpertLinear(
            e, k, n, w_only=w_only, device=device))
    cast_linear_weights(model, dtype)
    model.load_state_dict(payload["state_dict"], strict=True)
    return model.eval()
