"""Checkpoint layouts → the port's state dict (counterpart of
``keep_tpu/compat/torch_loader.py``).

- ``load_keep_state_dict``: the released KEEP layout (timm ``visual.*``,
  ``visual_head.{0,2}.*``, HF ``text.*``, ``logit_scale``) with the same
  quirks as the JAX converter: an unwrapped ``{'state_dict': ...}``, DDP
  ``module.`` prefixes stripped, ``position_ids`` buffers dropped. The patch
  conv becomes a ``[D, P·P·3]`` matmul weight in (ph, pw, c) order, and
  BERT's q/k/v are fused into one ``[3D, D]`` projection.
- ``from_jax_params``: the JAX package's parameter pytree (numpy leaves) →
  the port's state dict: ``kernel [in, out]`` → ``weight [out, in]``, LN
  ``scale`` → ``weight``, stacked ``[L, ...]`` block leaves unstacked. A
  quantized linear (a node with ``kernel_q``, from
  ``keep_tpu.quant.quantize_linear_weights``) maps to an ``ops.nn.QLinear``:
  ``kernel_q [in, out]`` → ``weight_q [out, in]``, its per-column ``scale``
  → ``weight_scale`` (not ``weight``: it is a dequant scale, not a LayerNorm
  gain), ``bias`` and a SmoothQuant ``pre_scale`` as they are.
- ``from_jax_lora``: the JAX package's LoRA adapter tree → the port's
  adapter dict (``<module>.lora_a`` / ``.lora_b`` per layer).
- ``random_keep_state_dict``: random weights in the released layout, drawn
  from a ``torch.Generator``, for tests and smoke runs.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch

from keep_tpu_torch.configs import KEEPConfig


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach()
    arr = np.asarray(v)
    if arr.dtype.name == "bfloat16":  # ml_dtypes arrays from JAX
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr))  # a writable copy


def _reject_quantized(keys) -> None:
    if any("kernel_q" in k for k in keys):
        raise ValueError(
            "the released checkpoint layout holds no int8 weights; load the "
            "fp checkpoint and quantize it (KEEPModel.quantize), or convert "
            "a quantized JAX tree with from_jax_params")

# leaves of a quantized linear node and their names in ops.nn.QLinear
_QUANTIZED_LEAVES = {"kernel_q": "weight_q", "scale": "weight_scale",
                     "bias": "bias", "pre_scale": "pre_scale"}


def normalize_state_dict(sd: Mapping) -> dict:
    """Unwraps a training ``{'state_dict': ...}`` dict, strips DDP
    ``module.`` prefixes and drops ``position_ids`` buffers."""
    if isinstance(sd, Mapping) and "state_dict" in sd and not hasattr(
            sd["state_dict"], "shape"):
        sd = sd["state_dict"]
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.endswith("position_ids"):
            continue
        out[k] = v
    return out


def load_keep_state_dict(sd: Mapping, cfg: KEEPConfig) -> dict:
    """Released KEEP state dict → ``KEEPModel`` state dict."""
    sd = normalize_state_dict(sd)
    _reject_quantized(sd)
    out = _timm_vit(sd, cfg, "visual.")
    for dst, src in (("visual_head.fc1", "visual_head.0"),
                     ("visual_head.fc2", "visual_head.2")):
        out[f"{dst}.weight"] = _tensor(sd[f"{src}.weight"])
        out[f"{dst}.bias"] = _tensor(sd[f"{src}.bias"])
    out.update(_hf_bert(sd, cfg, "text."))
    out["logit_scale"] = _tensor(sd["logit_scale"]).reshape(())
    return out


def load_timm_vit_state_dict(sd: Mapping, cfg: KEEPConfig) -> dict:
    """A timm ViT checkpoint (``patch_embed.proj.*``, ``blocks.*``, ...; a
    classifier head is ignored) → the ``visual.*`` entries of a ``KEEPModel``
    state dict: the pretrained image tower (train config
    ``model.pretrained_image``)."""
    sd = normalize_state_dict(sd)
    _reject_quantized(sd)
    return _timm_vit(sd, cfg, "")


def load_hf_bert_state_dict(sd: Mapping, cfg: KEEPConfig) -> dict:
    """An HF ``BertModel`` checkpoint → the ``text.*`` entries of a
    ``KEEPModel`` state dict: the pretrained text tower (train config
    ``model.pretrained_text``). A knowledge-BERT checkpoint's ``bert_model.``
    prefix is stripped."""
    sd = normalize_state_dict(sd)
    _reject_quantized(sd)
    if any(k.startswith("bert_model.") for k in sd):
        sd = {k[len("bert_model."):]: v for k, v in sd.items()
              if k.startswith("bert_model.")}
    return _hf_bert(sd, cfg, "")


def _timm_vit(sd: Mapping, cfg: KEEPConfig, src: str) -> dict:
    """timm ViT keys under ``src`` → the port's ``visual.*`` entries. The
    patch conv becomes a ``[D, P·P·3]`` matmul weight in (ph, pw, c) order."""
    def g(k: str) -> torch.Tensor:
        return _tensor(sd[src + k])

    out: dict[str, torch.Tensor] = {}

    def lin(name: str) -> None:
        out[f"visual.{name}.weight"] = g(f"{name}.weight")
        out[f"visual.{name}.bias"] = g(f"{name}.bias")

    conv = g("patch_embed.proj.weight")  # [D, 3, P, P]
    out["visual.patch_embed.weight"] = conv.permute(0, 2, 3, 1).reshape(
        conv.shape[0], -1)
    out["visual.patch_embed.bias"] = g("patch_embed.proj.bias")
    out["visual.cls_token"] = g("cls_token")
    out["visual.pos_embed"] = g("pos_embed")
    for i in range(cfg.vision.depth):
        p = f"blocks.{i}"
        for n in ("norm1", "attn.qkv", "attn.proj", "norm2", "mlp.fc1",
                  "mlp.fc2"):
            lin(f"{p}.{n}")
        if cfg.vision.layerscale_init is not None:
            out[f"visual.{p}.ls1"] = g(f"{p}.ls1.gamma")
            out[f"visual.{p}.ls2"] = g(f"{p}.ls2.gamma")
    lin("norm")
    return out


def _hf_bert(sd: Mapping, cfg: KEEPConfig, src: str) -> dict:
    """HF BERT keys under ``src`` → the port's ``text.*`` entries, with q/k/v
    fused into one ``[3D, D]`` projection."""
    def g(k: str) -> torch.Tensor:
        return _tensor(sd[src + k])

    out: dict[str, torch.Tensor] = {}

    def lin(dst: str, name: str) -> None:
        out[f"{dst}.weight"] = g(f"{name}.weight")
        out[f"{dst}.bias"] = g(f"{name}.bias")

    e = "embeddings"
    out[f"text.{e}.word"] = g(f"{e}.word_embeddings.weight")
    out[f"text.{e}.position"] = g(f"{e}.position_embeddings.weight")
    out[f"text.{e}.token_type"] = g(f"{e}.token_type_embeddings.weight")
    lin(f"text.{e}.norm", f"{e}.LayerNorm")
    for i in range(cfg.text.num_hidden_layers):
        layer, dst = f"encoder.layer.{i}", f"text.blocks.{i}"
        qkv = [f"{layer}.attention.self.{n}" for n in ("query", "key",
                                                       "value")]
        out[f"{dst}.attn.qkv.weight"] = torch.cat(
            [g(f"{n}.weight") for n in qkv], dim=0)
        out[f"{dst}.attn.qkv.bias"] = torch.cat(
            [g(f"{n}.bias") for n in qkv], dim=0)
        lin(f"{dst}.attn.out", f"{layer}.attention.output.dense")
        lin(f"{dst}.attn.norm", f"{layer}.attention.output.LayerNorm")
        lin(f"{dst}.mlp.fc1", f"{layer}.intermediate.dense")
        lin(f"{dst}.mlp.fc2", f"{layer}.output.dense")
        lin(f"{dst}.norm", f"{layer}.output.LayerNorm")
    lin("text.pooler", "pooler.dense")
    return out


def from_jax_params(params: Mapping, cfg: KEEPConfig) -> dict:
    """JAX KEEP parameter pytree (numpy or jax leaves) → ``KEEPModel``
    state dict."""
    depths = {"visual": cfg.vision.depth, "text": cfg.text.num_hidden_layers}
    out: dict[str, torch.Tensor] = {}

    def walk(node, path: tuple) -> None:
        if isinstance(node, Mapping) and "kernel_q" in node:
            for key, child in node.items():
                if key not in _QUANTIZED_LEAVES:
                    raise ValueError(f"{'.'.join(path)}: quantized linear leaf "
                                     f"{key!r} is not ported (W8A16 / MoE)")
                t = _tensor(child)
                if key == "kernel_q":
                    t = t.transpose(-1, -2).contiguous()
                out[".".join((*path, _QUANTIZED_LEAVES[key]))] = t
            return
        if isinstance(node, Mapping):
            if "pre_scale" in node:
                raise NotImplementedError(
                    f"{'.'.join(path)}: a smoothed linear that is not "
                    f"quantized (a pre_scale beside an fp kernel) is not "
                    f"ported; quantize the tree first")
            for key, child in node.items():
                if key == "blocks":
                    leaves = [np.asarray(x) for x in _leaves(child)]
                    n = leaves[0].shape[0]
                    if n != depths[path[0]]:
                        raise ValueError(
                            f"{path[0]} has {n} stacked layers, the config "
                            f"{depths[path[0]]}")
                    for i in range(n):
                        walk(_index(child, i), path + ("blocks", str(i)))
                else:
                    walk(child, path + (key,))
            return
        t = _tensor(node)
        *head, last = path
        if last == "kernel":
            t, last = t.transpose(-1, -2).contiguous(), "weight"
        elif last == "scale":
            last = "weight"
        out[".".join((*head, last))] = t

    walk(params, ())
    return out


def from_jax_lora(adapters: Mapping, cfg: KEEPConfig) -> dict:
    """The JAX package's LoRA adapter tree (``keep_tpu.train.lora``: stacked
    ``[L, D, r]`` / ``[L, r, N]`` factors ``a`` / ``b`` under ``blocks``,
    and ``logit_scale``) → the port's adapter dict
    (``keep_tpu_torch.train.lora``): ``<module>.lora_a [D, r]`` and
    ``<module>.lora_b [r, N]`` per layer, the factors as they are."""
    out = {}
    for name, t in from_jax_params(adapters, cfg).items():
        head, _, last = name.rpartition(".")
        out[f"{head}.lora_{last}" if last in ("a", "b") else name] = t
    return out


def to_jax_params(state_dict: Mapping, cfg: KEEPConfig) -> dict:
    """``KEEPModel`` state dict (float) → the JAX package's parameter pytree
    as nested dicts of fp32 numpy arrays, the inverse of ``from_jax_params``:
    a 2-D ``weight [out, in]`` → ``kernel [in, out]``, a 1-D ``weight`` (a
    LayerNorm gain) → ``scale``, and ``blocks.{i}.*`` stacked into ``[L, ...]``
    leaves. Quantized linears are refused."""
    depths = {"visual": cfg.vision.depth, "text": cfg.text.num_hidden_layers}
    out: dict = {}
    stacks: dict[tuple, dict[int, np.ndarray]] = {}

    def put(path, value) -> None:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value

    for name, t in state_dict.items():
        *head, last = name.split(".")
        if last in _QUANTIZED_LEAVES.values() and last != "bias":
            raise ValueError(f"{name}: quantized linears have no float "
                             f"kernel to convert")
        arr = t.detach().cpu().float().numpy()
        if last == "weight":
            if arr.ndim == 2:
                arr, last = np.ascontiguousarray(arr.T), "kernel"
            elif arr.ndim == 1:
                last = "scale"
        if "blocks" in head:
            k = head.index("blocks")
            key = (tuple(head[:k + 1]), tuple(head[k + 2:]) + (last,))
            stacks.setdefault(key, {})[int(head[k + 1])] = arr
        else:
            put((*head, last), arr)
    for (prefix, rest), layers in stacks.items():
        n = depths[prefix[0]]
        if sorted(layers) != list(range(n)):
            raise ValueError(f"{'.'.join(prefix + rest)}: layers "
                             f"{sorted(layers)}, the config has {n}")
        put(prefix + rest, np.stack([layers[i] for i in range(n)]))
    return out


def _leaves(node):
    if isinstance(node, Mapping):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node


def _index(node, i: int):
    if isinstance(node, Mapping):
        return {k: _index(v, i) for k, v in node.items()}
    return np.asarray(node)[i]


def load_state_dict_file(path: str) -> dict:
    """Reads ``.safetensors`` or a torch ``.bin``/``.pt`` weights file."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def released_keep_shapes(cfg: KEEPConfig) -> dict[str, tuple]:
    """Every key of a released KEEP state dict with its shape."""
    v, t = cfg.vision, cfg.text
    d, p, f = v.embed_dim, v.patch_size, v.mlp_dim
    shapes: dict[str, tuple] = {
        "visual.patch_embed.proj.weight": (d, 3, p, p),
        "visual.patch_embed.proj.bias": (d,),
        "visual.cls_token": (1, 1, d),
        "visual.pos_embed": (1, 1 + v.num_patches, d),
        "visual.norm.weight": (d,), "visual.norm.bias": (d,),
    }
    lin = {"attn.qkv": (3 * d, d), "attn.proj": (d, d), "mlp.fc1": (f, d),
           "mlp.fc2": (d, f)}
    for i in range(v.depth):
        b = f"visual.blocks.{i}"
        for n, shape in lin.items():
            shapes[f"{b}.{n}.weight"] = shape
            shapes[f"{b}.{n}.bias"] = shape[:1]
        for n in ("norm1", "norm2"):
            shapes[f"{b}.{n}.weight"] = shapes[f"{b}.{n}.bias"] = (d,)
        if v.layerscale_init is not None:
            shapes[f"{b}.ls1.gamma"] = shapes[f"{b}.ls2.gamma"] = (d,)
    k = cfg.projection_dim
    shapes.update({"visual_head.0.weight": (k, d), "visual_head.0.bias": (k,),
                   "visual_head.2.weight": (k, k), "visual_head.2.bias": (k,)})
    h, ff = t.hidden_size, t.intermediate_size
    e = "text.embeddings"
    shapes.update({
        f"{e}.word_embeddings.weight": (t.vocab_size, h),
        f"{e}.position_embeddings.weight": (t.max_position_embeddings, h),
        f"{e}.token_type_embeddings.weight": (t.type_vocab_size, h),
        f"{e}.LayerNorm.weight": (h,), f"{e}.LayerNorm.bias": (h,),
        "text.pooler.dense.weight": (h, h), "text.pooler.dense.bias": (h,),
    })
    blk = {"attention.self.query": (h, h), "attention.self.key": (h, h),
           "attention.self.value": (h, h), "attention.output.dense": (h, h),
           "intermediate.dense": (ff, h), "output.dense": (h, ff)}
    for i in range(t.num_hidden_layers):
        b = f"text.encoder.layer.{i}"
        for n, shape in blk.items():
            shapes[f"{b}.{n}.weight"] = shape
            shapes[f"{b}.{n}.bias"] = shape[:1]
        for n in ("attention.output.LayerNorm", "output.LayerNorm"):
            shapes[f"{b}.{n}.weight"] = shapes[f"{b}.{n}.bias"] = (h,)
    shapes["logit_scale"] = ()
    return shapes


@torch.no_grad()
def random_keep_state_dict(cfg: KEEPConfig, generator: torch.Generator,
                           device=None, *, keep_init: bool = False) -> dict:
    """A released-layout KEEP state dict of random fp32 weights.

    By default linear and conv weights are normal with std fan_in^-0.5,
    biases and embeddings normal(.02), LayerNorm gains 1 + normal(.1), and
    LayerScale gammas uniform in [0.1, 0.5], so that every block moves the
    residual stream (timm's 1e-5 init would leave the towers close to
    identity). ``keep_init=True`` draws instead with the statistics of the
    JAX package's ``keep.init``, on which its int8-vs-bf16 gate
    (``bench.py`` ``_int8_gate``) is measured: ViT and head weights std
    fan_in^-0.5, BERT weights and embeddings std .02, zero biases, unit
    LayerNorms, LayerScale gammas at ``layerscale_init``."""
    ln_gain = ("norm.weight", "norm1.weight", "norm2.weight",
               "LayerNorm.weight")
    ln_bias = ("norm.bias", "norm1.bias", "norm2.bias", "LayerNorm.bias")
    out = {}
    for key, shape in released_keep_shapes(cfg).items():
        if key == "logit_scale":
            out[key] = torch.tensor(math.log(1.0 / cfg.logit_scale_init),
                                    device=device)
            continue
        t = torch.empty(shape, device=device)
        matrix = (len(shape) >= 2 and key.endswith(".weight")
                  and "embeddings" not in key)
        fan_in_std = math.prod(shape[1:]) ** -0.5 if matrix else 0.0
        if not keep_init:
            if key.endswith(".gamma"):
                t.uniform_(0.1, 0.5, generator=generator)
            elif key.endswith(ln_gain):
                t.normal_(1.0, 0.1, generator=generator)
            elif matrix:
                t.normal_(0.0, fan_in_std, generator=generator)
            else:
                t.normal_(0.0, 0.02, generator=generator)
        elif key.endswith(".gamma"):
            t.fill_(cfg.vision.layerscale_init)
        elif key.endswith(ln_gain):
            t.fill_(1.0)
        elif key.endswith(ln_bias) or (key.endswith(".bias") and len(shape)
                                       == 1):
            t.zero_()
        elif matrix and not key.startswith("text."):
            t.normal_(0.0, fan_in_std, generator=generator)
        else:  # BERT weights and embeddings, pos / cls tokens
            t.normal_(0.0, 0.02, generator=generator)
        out[key] = t
    return out
