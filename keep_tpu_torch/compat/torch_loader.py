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
  gain), ``bias`` and a SmoothQuant ``pre_scale`` as they are. A
  ``pre_scale`` beside a float ``kernel`` (``keep_tpu.quant.smooth_bert``
  without quantization) loads into the float ``ops.nn.Linear``, which
  applies it as the JAX package's ``linear`` does.
- ``from_jax_clip_params``: the same for a JAX CLIP or OpenCLIP-preset
  pytree of the ViT family (``models.clip.CLIP``, ``presets.PresetModel``).
- ``from_jax_tree``: the walk under all of these, for any tower's pytree:
  conv kernels (HWIO, depthwise too) → [O, I, kh, kw], BatchNorm nodes →
  ``running_mean`` / ``running_var``, stacked ``blocks`` and lists of
  block dicts unstacked, each stack's count checked against the caller's.
- ``from_jax_preset_params`` / ``from_jax_kep_params`` /
  ``from_jax_coca_params`` / ``from_jax_pmc_params``: any preset's pytree
  (``presets.create_preset``, the CoCa entries too) and the KEP, CoCa and
  PMC-CLIP models' (``kep.init``, ``coca.init``, ``pmc_clip.init``), each
  stack counted by its own config.
- ``convert_timm_eva`` / ``convert_timm_vit_relpos``: timm EVA02 and relpos
  ViT checkpoints → the state dicts of ``models.eva.Eva`` and
  ``models.vit_relpos.ViTRelPos``.
- ``from_jax_lora``: the JAX package's LoRA adapter tree → the port's
  adapter dict (``<module>.lora_a`` / ``.lora_b`` per layer).
- ``random_keep_state_dict``: random weights in the released layout, drawn
  from a ``torch.Generator``, for tests and smoke runs.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping

import numpy as np
import torch

from keep_tpu_torch.configs import BertConfig, KEEPConfig


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
    out.update(_hf_bert(sd, cfg.text, "text."))
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
    return _hf_bert(sd, cfg.text, "")


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


def _hf_bert(sd: Mapping, cfg: BertConfig, src: str,
             dst_prefix: str = "text.") -> dict:
    """HF BERT keys under ``src`` → the port's ``BertModel`` entries under
    ``dst_prefix``, with q/k/v fused into one ``[3D, D]`` projection."""
    def g(k: str) -> torch.Tensor:
        return _tensor(sd[src + k])

    out: dict[str, torch.Tensor] = {}

    def lin(dst: str, name: str) -> None:
        out[f"{dst}.weight"] = g(f"{name}.weight")
        out[f"{dst}.bias"] = g(f"{name}.bias")

    e, t = "embeddings", dst_prefix
    out[f"{t}{e}.word"] = g(f"{e}.word_embeddings.weight")
    out[f"{t}{e}.position"] = g(f"{e}.position_embeddings.weight")
    out[f"{t}{e}.token_type"] = g(f"{e}.token_type_embeddings.weight")
    lin(f"{t}{e}.norm", f"{e}.LayerNorm")
    for i in range(cfg.num_hidden_layers):
        layer, dst = f"encoder.layer.{i}", f"{t}blocks.{i}"
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
    lin(f"{t}pooler", "pooler.dense")
    return out


def _patch_conv(sd: Mapping) -> dict:
    """A timm patch conv [D, 3, P, P] → ``patch_embed`` [D, P·P·3] in
    (ph, pw, c) order, with its bias."""
    conv = _tensor(sd["patch_embed.proj.weight"])
    return {"patch_embed.weight": conv.permute(0, 2, 3, 1).reshape(
                conv.shape[0], -1).contiguous(),
            "patch_embed.bias": _tensor(sd["patch_embed.proj.bias"])}


def convert_timm_eva(sd: Mapping, cfg) -> dict:
    """timm ``Eva`` state dict → the state dict of the port's
    ``models.eva.Eva(cfg)``. The TrV layout: split ``q_proj`` / ``k_proj``
    (no bias) / ``v_proj``, SwiGLU ``fc1_g`` / ``fc1_x`` with the hidden
    norm, the attention's inner norm. The E layout: fused ``qkv`` with
    ``q_bias`` / ``v_bias`` parameters (k's bias zero) or a ``qkv.bias``,
    plain ``fc1`` / ``fc2``. A ``head`` is kept when the checkpoint has
    one."""
    g = lambda k: _tensor(sd[k])  # noqa: E731
    d = cfg.embed_dim
    out = _patch_conv(sd)
    out.update({"cls_token": g("cls_token"), "pos_embed": g("pos_embed"),
                "norm.weight": g("norm.weight"), "norm.bias": g("norm.bias")})
    if "head.weight" in sd:
        out["head.weight"], out["head.bias"] = g("head.weight"), g("head.bias")
    for i in range(cfg.depth):
        src = f"blocks.{i}."

        def lin(dst: str, name: str, bias: bool = True) -> None:
            out[src + dst + ".weight"] = g(src + name + ".weight")
            if bias:
                out[src + dst + ".bias"] = g(src + name + ".bias")

        lin("norm1", "norm1")
        lin("norm2", "norm2")
        lin("attn.proj", "attn.proj")
        if cfg.qkv_fused:
            lin("attn.qkv", "attn.qkv", bias=False)
            out[src + "attn.qkv.bias"] = (
                g(src + "attn.qkv.bias") if src + "attn.qkv.bias" in sd
                else torch.cat([g(src + "attn.q_bias"), torch.zeros(d),
                                g(src + "attn.v_bias")]))
        else:
            lin("attn.q", "attn.q_proj")
            lin("attn.k", "attn.k_proj", bias=False)
            lin("attn.v", "attn.v_proj")
        if cfg.scale_attn_inner:
            lin("attn.norm", "attn.norm")
        names = (("fc1_g", "fc1_x", "fc2") if cfg.swiglu else ("fc1", "fc2"))
        if cfg.swiglu and cfg.scale_mlp:
            names += ("norm",)
        for n in names:
            lin(f"mlp.{n}", f"mlp.{n}")
    return out


def convert_timm_vit_relpos(sd: Mapping, cfg) -> dict:
    """timm ``VisionTransformerRelPos`` ('cls' variant) state dict → the
    state dict of the port's ``models.vit_relpos.ViTRelPos(cfg)``: each
    block's RelPosMlp at ``attn.rel_pos.mlp.fc{1,2}``, no absolute pos
    embed; a linear the checkpoint has without a bias (the presets'
    ``qkv_bias=False``) gets a zero one."""
    g = lambda k: _tensor(sd[k])  # noqa: E731
    out = _patch_conv(sd)
    out.update({"cls_token": g("cls_token"), "norm.weight": g("norm.weight"),
                "norm.bias": g("norm.bias")})
    for i in range(cfg.depth):
        src = f"blocks.{i}."
        for dst, name in (("norm1", "norm1"), ("norm2", "norm2"),
                          ("attn.qkv", "attn.qkv"), ("attn.proj", "attn.proj"),
                          ("attn.rel_pos.fc1", "attn.rel_pos.mlp.fc1"),
                          ("attn.rel_pos.fc2", "attn.rel_pos.mlp.fc2"),
                          ("mlp.fc1", "mlp.fc1"), ("mlp.fc2", "mlp.fc2")):
            w = g(src + name + ".weight")
            out[src + dst + ".weight"] = w
            out[src + dst + ".bias"] = (g(src + name + ".bias")
                                        if src + name + ".bias" in sd
                                        else torch.zeros(w.shape[0]))
    return out


def from_jax_params(params: Mapping, cfg: KEEPConfig) -> dict:
    """JAX KEEP parameter pytree (numpy or jax leaves) → ``KEEPModel``
    state dict."""
    depths = {"visual": cfg.vision.depth, "text": cfg.text.num_hidden_layers}
    return from_jax_tree(params, lambda path: depths[path[0]])


def from_jax_clip_params(params: Mapping, vision_depth: int,
                         text_depth: int) -> dict:
    """A JAX CLIP or OpenCLIP-preset parameter pytree (``keep_tpu.models.
    clip.init``, ``compat.openai.load_openai_clip``,
    ``presets.create_preset``: ``visual`` with ``ln_pre`` and ``proj``,
    ``visual_head``, ``text`` with the custom blocks' extras,
    ``logit_scale``) → the state dict of the port's ``models.clip.CLIP``
    or ``presets.PresetModel``. Linear kernels and LayerNorm scales map as
    in ``from_jax_params``; every other leaf (the embeddings, ``proj``,
    ``text_projection``, the head's matrices, ``logit_scale``,
    ``head_scale``) keeps its JAX layout and name."""
    depths = {"visual": vision_depth, "text": text_depth}
    return from_jax_tree(params, lambda path: depths[path[0]])


# a BatchNorm node of the JAX pytree and its leaves' names in the port
_BATCH_NORM = {"scale": "weight", "bias": "bias", "mean": "running_mean",
               "var": "running_var"}


def from_jax_tree(params: Mapping, count: Callable[[tuple], int | None]
                  ) -> dict:
    """A JAX parameter pytree (numpy or jax leaves) → the port's state dict.

    - a ``kernel`` [in, out] → ``weight`` [out, in]; a 4-D conv kernel
      (HWIO, depthwise [kh, kw, 1, C] too) → ``weight`` [O, I, kh, kw];
    - a LayerNorm / RMSNorm ``scale`` → ``weight``; a BatchNorm node
      (``scale``, ``bias``, ``mean``, ``var``) → ``weight``, ``bias``,
      ``running_mean``, ``running_var``;
    - a quantized linear (``kernel_q``) → an ``ops.nn.QLinear``'s leaves;
      a quantized expert stack (a 3-D ``kernel_q``) → a
      ``models.moe.QExpertLinear``'s, its extra state saying whether the
      JAX ``w_only`` marker (W8A16, ``quant.quantize_linear_weights``'s
      ``weight_only``) was there;
    - ``blocks`` stacked on a leading layer axis → ``blocks.{i}``, and a
      list of block dicts (ResNet stages, Swin blocks, ConvNeXt stages) →
      ``{i}``; ``count(path)`` gives the number each stack or list must
      hold (None: whatever it holds);
    - every other leaf keeps its name and layout."""
    out: dict[str, torch.Tensor] = {}

    def check(path: tuple, n: int) -> None:
        want = count(path)
        if want is not None and n != want:
            raise ValueError(f"{'.'.join(path)} has {n} stacked layers, the "
                             f"config {want}")

    def walk(node, path: tuple) -> None:
        if isinstance(node, Mapping) and "kernel_q" in node:
            experts = np.ndim(node["kernel_q"]) == 3
            if "w_only" in node and not experts:
                raise ValueError(f"{'.'.join(path)}: a dense W8A16 linear "
                                 f"(w_only on a 2-D kernel_q) is not ported; "
                                 f"the JAX package marks only MoE experts")
            for key, child in node.items():
                if key == "w_only":
                    continue
                if key not in _QUANTIZED_LEAVES:
                    raise ValueError(f"{'.'.join(path)}: quantized linear leaf "
                                     f"{key!r} is not ported")
                t = _tensor(child)
                if key == "kernel_q":
                    t = t.transpose(-1, -2).contiguous()
                out[".".join((*path, _QUANTIZED_LEAVES[key]))] = t
            if experts:  # a QExpertLinear: W8A8, or W8A16 under w_only
                out[".".join((*path, "_extra_state"))] = {
                    "w_only": "w_only" in node}
            return
        if isinstance(node, Mapping) and set(node) == set(_BATCH_NORM):
            for key, child in node.items():
                out[".".join((*path, _BATCH_NORM[key]))] = _tensor(child)
            return
        if isinstance(node, Mapping):
            for key, child in node.items():
                if key == "blocks" and isinstance(child, Mapping):
                    n = np.asarray(next(_leaves(child))).shape[0]
                    check(path + (key,), n)
                    for i in range(n):
                        walk(_index(child, i), path + ("blocks", str(i)))
                else:
                    walk(child, path + (key,))
            return
        if isinstance(node, (list, tuple)):
            check(path, len(node))
            for i, child in enumerate(node):
                walk(child, path + (str(i),))
            return
        t = _tensor(node)
        *head, last = path
        if last == "kernel":
            t = (t.permute(3, 2, 0, 1) if t.dim() == 4
                 else t.transpose(-1, -2)).contiguous()
            last = "weight"
        elif last == "scale":
            last = "weight"
        out[".".join((*head, last))] = t

    walk(params, ())
    return out


def _vision_stacks(kind: str, v) -> dict[tuple, int]:
    """The stacks of an image tower's pytree under ``visual``."""
    if kind == "rn":
        return {("visual", f"layer{li}"): n
                for li, n in enumerate(v.layers, start=1)}
    if kind == "convnext":
        out = {("visual", "stages"): len(v.depths)}
        out.update({("visual", "stages", str(s), "blocks"): n
                    for s, n in enumerate(v.depths)})
        return out
    if kind == "swin":
        return {("visual", f"stage{s}", "blocks"): n
                for s, n in enumerate(v.depths)}
    return {("visual", "blocks"): v.depth}


def _stack_count(stacks: dict[tuple, int | None]):
    def count(path: tuple) -> int | None:
        if path not in stacks:
            raise ValueError(f"{'.'.join(path)}: a stack the config does not "
                             f"have")
        return stacks[path]

    return count


def from_jax_preset_params(params: Mapping, resolved) -> dict:
    """A JAX ``presets.create_preset`` pytree → the state dict of the
    port's ``presets.PresetModel`` for the same resolved preset (any of the
    58 built, shrunk ones too). Each stack's count comes from the
    resolution's config of that stack (per ConvNeXt stage, per ResNet /
    Swin stage), the leaves map as in ``from_jax_tree``."""
    r = resolved
    if r.family == "coca":
        return from_jax_coca_params(params, r.text_cfg)
    stacks = _vision_stacks(r.vision_kind, r.vision_cfg)
    t = r.text_cfg
    if r.text_kind == "clip":
        stacks[("text", "blocks")] = t.layers
    elif r.text_kind == "path_bert":
        stacks[("text", "bert", "blocks")] = t.num_hidden_layers
    else:
        stacks[("text", "trunk", "blocks")] = (
            t.trunk.num_layers if t.arch == "mt5"
            else t.trunk.num_hidden_layers)
    return from_jax_tree(params, _stack_count(stacks))


def _as_list(stacked: Mapping) -> list:
    """A dict of leaves stacked on a leading layer axis → a list of the
    layers' dicts."""
    n = np.asarray(next(_leaves(stacked))).shape[0]
    return [_index(stacked, i) for i in range(n)]


def from_jax_coca_params(params: Mapping, cfg) -> dict:
    """A JAX ``coca.init`` pytree → the state dict of the port's
    ``models.coca.CoCa`` for the same ``CoCaConfig``: the decoder's stacked
    ``self_blocks`` / ``cross_blocks`` unstacked like ``blocks``, each
    stack counted by the config."""
    tree = dict(params)
    tree["decoder"] = {k: (_as_list(v) if k.endswith("_blocks") else v)
                       for k, v in params["decoder"].items()}
    stacks = {("visual", "blocks"): cfg.vision.depth,
              ("decoder", "self_blocks"): cfg.decoder_layers,
              ("decoder", "cross_blocks"): cfg.decoder_layers}
    if cfg.hf_text is not None:
        stacks[("text", "trunk", "blocks")] = \
            cfg.hf_text.trunk.num_hidden_layers
    else:
        stacks[("text", "blocks")] = cfg.text_layers
    return from_jax_tree(tree, _stack_count(stacks))


def from_jax_pmc_params(params: Mapping, cfg) -> dict:
    """A JAX ``pmc_clip.init`` pytree → the state dict of the port's
    ``models.pmc_clip.PMCCLIP``: the RN stages and the BERT and fusion
    stacks counted by the config."""
    tree = dict(params)
    tree["fusion"] = _as_list(params["fusion"])
    stacks = _vision_stacks("rn", cfg.vision)
    stacks[("text", "blocks")] = cfg.text.num_hidden_layers
    stacks[("fusion",)] = cfg.fusion_layers
    return from_jax_tree(tree, _stack_count(stacks))


def from_jax_kep_params(params: Mapping, cfg) -> dict:
    """A JAX ``kep.init`` pytree (``res_ssl`` with its trunk installed, or
    the empty placeholder) → the state dict of the port's
    ``models.kep.KEPModel``. The trunk's stage depths are its lists'."""
    kind = cfg.image_encoder
    if kind == "res_ssl":
        stacks = {("visual", f"layer{li}"): None for li in range(1, 5)}
    else:
        stacks = _vision_stacks("rn" if kind == "rn_clip" else "vit",
                                cfg.rn_config if kind == "rn_clip"
                                else cfg.vision)
    for tower in ("text", "knowledge"):
        stacks[(tower, "bert", "blocks")] = cfg.text.num_hidden_layers
    return from_jax_tree(params, _stack_count(stacks))


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
        if last in ("weight_q", "weight_scale"):
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
    """The array leaves of a JAX pytree; an empty tuple (the ``w_only``
    marker) holds none."""
    if isinstance(node, Mapping):
        for v in node.values():
            yield from _leaves(v)
    elif not (isinstance(node, tuple) and node == ()):
        yield node


def _index(node, i: int):
    if isinstance(node, Mapping):
        return {k: _index(v, i) for k, v in node.items()}
    if isinstance(node, tuple) and node == ():
        return node  # a structural marker, the same in every layer
    return np.asarray(node)[i]


def load_state_dict_file(path: str) -> dict:
    """Reads ``.safetensors`` or a torch ``.bin``/``.pt`` weights file."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def load_keep_checkpoint(path: str, cfg: KEEPConfig) -> dict:
    """A released KEEP weights file (``.bin`` / ``.pt`` / ``.safetensors``)
    → ``KEEPModel`` state dict (the JAX package's ``load_keep_checkpoint``
    gives its pytree)."""
    return load_keep_state_dict(load_state_dict_file(path), cfg)


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
