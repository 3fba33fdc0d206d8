"""Model factory: a name → a model (counterpart of ``keep_tpu/factory.py``).

``create_model(name)`` builds a registry entry (``keep``, the released
ViT-L/16 + BERT model; ``kep``, the knowledge-enhanced training model;
``clip-vit-b-16``, ``clip-vit-l-14``; ``rn50-clip``, the RN50 image tower
alone; ``coca``; ``pmc-clip``) or, for any other name, an OpenCLIP preset (``presets``). It returns an ``nn.Module``
whose ``encode_image`` / ``encode_text`` / ``forward`` are the surface of
the JAX package's ``ModelSpec`` closures and which carries ``family`` and
``config``. Weights are drawn on ``device`` (default: the card) from a
generator seeded with ``seed``, or loaded from a released checkpoint
(``pretrained=``, ``keep`` only: a local path, a name of the local registry
``compat.registry`` or a URL, through ``registry.fetch``). ``get_tokenizer``
takes the native C++ tokenizers when they build.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable

import torch
from torch import nn

from keep_tpu_torch import presets
from keep_tpu_torch.configs import KEEPConfig, ViTConfig
from keep_tpu_torch.presets import card_device


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    family: str  # 'keep' | 'kep' | 'clip' | 'coca' | 'pmc_clip'
    config: Any
    # (config, generator, dtype, device) → the model with drawn weights
    build: Callable[..., nn.Module]


_REGISTRY: dict[str, Callable[[], ModelSpec]] = {}


def register_model(name: str):
    def wrap(fn):
        _REGISTRY[name] = fn
        return fn

    return wrap


def list_models() -> list[str]:
    """The registry's names and the 62 presets', sorted."""
    return sorted(set(_REGISTRY) | set(presets.PRESETS))


def create_model(name: str, seed: int = 0, dtype: torch.dtype | None = None,
                 pretrained: str | None = None, device=None,
                 **overrides) -> nn.Module:
    """The model ``name``, in ``dtype`` (default fp32; the compute dtype,
    in which the linear weights are stored), on ``device`` (default: the
    card; raises without one unless ``device="cpu"``). ``overrides``
    replace top-level config fields of a registry entry.

    ``pretrained`` (``keep`` only): a released checkpoint, as the JAX
    package's factory takes it (``compat.registry.fetch``): a local path, a
    name of the local registry (``$KEEP_TPU_HOME``) or a URL (fetched into
    the cache and sha-checked). A directory brings ``config.json``, which
    ``overrides`` then amend, and ``pytorch_model.bin`` or
    ``model.safetensors``; a weights file is read with the default config.
    Names outside the registry resolve through the OpenCLIP preset
    inventory (``presets.create_preset``), which takes no overrides."""
    if pretrained is not None and name != "keep":
        raise NotImplementedError(
            "pretrained= loading is wired for the released 'keep' model; "
            "other families load tower checkpoints through "
            "keep_tpu_torch.compat converters")
    dtype = dtype or torch.float32
    if name not in _REGISTRY:
        if name in presets.PRESETS:
            if overrides:
                raise ValueError(
                    "config overrides are not supported for OpenCLIP "
                    "presets; use presets.resolve() and "
                    "presets.build_preset()")
            return presets.create_preset(name, seed=seed, dtype=dtype,
                                         device=device)
        raise KeyError(f"unknown model {name!r}; have {list_models()}")
    spec = _REGISTRY[name]()
    cfg = (dataclasses.replace(spec.config, **overrides) if overrides
           else spec.config)
    device = card_device(device)
    if pretrained is not None:
        return _load_keep(pretrained, cfg, overrides, dtype, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return spec.build(cfg, gen, dtype=dtype, device=device).eval()


def _load_keep(path: str, cfg: KEEPConfig, overrides: dict,
               dtype: torch.dtype, device: torch.device) -> nn.Module:
    from keep_tpu_torch.compat.registry import fetch
    from keep_tpu_torch.compat.torch_loader import (load_keep_state_dict,
                                                    load_state_dict_file)
    from keep_tpu_torch.models.keep import KEEPModel

    path = fetch(path)
    weights = path
    if os.path.isdir(path):
        cfg_json = os.path.join(path, "config.json")
        if os.path.exists(cfg_json):
            # the checkpoint's config first, the caller's overrides on top
            cfg = KEEPConfig.from_hf_json(cfg_json)
            if overrides:
                cfg = dataclasses.replace(cfg, **overrides)
        for fname in ("pytorch_model.bin", "model.safetensors"):
            weights = os.path.join(path, fname)
            if os.path.exists(weights):
                break
        else:
            raise FileNotFoundError(f"no weights file in {path}")
    model = KEEPModel(cfg, dtype=dtype, device=device)
    model.load_state_dict(load_keep_state_dict(load_state_dict_file(weights),
                                               cfg), strict=True)
    return model.eval()


# --------------------------------------------------------------------------


@register_model("keep")  # the released ViT-L/16 + BERT model
def _keep() -> ModelSpec:
    from keep_tpu_torch.models.keep import KEEPModel

    return ModelSpec(
        family="keep", config=KEEPConfig(),
        build=lambda cfg, gen, dtype, device: KEEPModel.init(
            cfg, gen, dtype=dtype, device=device))


@register_model("kep")  # the training-time knowledge-enhanced model
def _kep() -> ModelSpec:
    from keep_tpu_torch.models.kep import KEPConfig, KEPModel

    return ModelSpec(family="kep", config=KEPConfig(), build=KEPModel.init)


def _clip_spec(cfg) -> ModelSpec:
    from keep_tpu_torch.models.clip import CLIP

    return ModelSpec(family="clip", config=cfg, build=CLIP.init)


@register_model("clip-vit-b-16")
def _clip_b16() -> ModelSpec:
    from keep_tpu_torch.models.clip import CLIPConfig

    return _clip_spec(CLIPConfig(
        embed_dim=512,
        vision=ViTConfig(patch_size=16, embed_dim=768, depth=12, num_heads=12,
                         layerscale_init=None, ln_eps=1e-5)))


@register_model("clip-vit-l-14")
def _clip_l14() -> ModelSpec:
    from keep_tpu_torch.models.clip import CLIPConfig
    from keep_tpu_torch.models.text_transformer import TextTransformerConfig

    return _clip_spec(CLIPConfig(
        embed_dim=768,
        vision=ViTConfig(patch_size=14, img_size=224, embed_dim=1024, depth=24,
                         num_heads=16, layerscale_init=None, ln_eps=1e-5),
        text=TextTransformerConfig(width=768, heads=12, layers=12,
                                   output_dim=768)))


@register_model("rn50-clip")  # the RN50 image tower alone
def _rn50() -> ModelSpec:
    from keep_tpu_torch.models.resnet import (ModifiedResNet,
                                              ModifiedResNetConfig)

    return ModelSpec(family="clip", config=ModifiedResNetConfig(),
                     build=ModifiedResNet.init)


@register_model("coca")
def _coca() -> ModelSpec:
    from keep_tpu_torch.models.coca import CoCa, CoCaConfig

    return ModelSpec(family="coca", config=CoCaConfig(), build=CoCa.init)


@register_model("pmc-clip")
def _pmc() -> ModelSpec:
    from keep_tpu_torch.models.pmc_clip import PMCCLIP, PMCCLIPConfig

    return ModelSpec(family="pmc_clip", config=PMCCLIPConfig(),
                     build=PMCCLIP.init)


def get_tokenizer(kind: str, path: str, **kw):
    """Tokenizer factory (the JAX package's ``factory.get_tokenizer``):
    'bert' → WordPiece (a ``vocab.txt`` or a model directory), 'clip' →
    byte-level BPE (a merges file). The native C++ tokenizers
    (``text.fast_tokenizer``) are taken when their library builds; only a
    build-environment failure (no compiler, a library that does not load)
    gives the pure-Python tokenizer, and a bad vocabulary or keyword
    raises."""
    import os

    if kind == "bert":
        try:
            from keep_tpu_torch.text.fast_tokenizer import (
                FastWordPieceTokenizer)

            vocab = (path if path.endswith(".txt")
                     else os.path.join(path, "vocab.txt"))
            return FastWordPieceTokenizer(vocab, **kw)
        except (ImportError, OSError, RuntimeError):
            from keep_tpu_torch.text.tokenizer import WordPieceTokenizer

            if path.endswith(".txt"):
                return WordPieceTokenizer(path, **kw)
            return WordPieceTokenizer.from_pretrained(path, **kw)
    if kind == "clip":
        try:
            from keep_tpu_torch.text.fast_tokenizer import FastBPETokenizer

            return FastBPETokenizer(path, **kw)
        except (ImportError, OSError, RuntimeError):
            from keep_tpu_torch.text.bpe import BPETokenizer

            return BPETokenizer(path, **kw)
    raise ValueError(f"unknown tokenizer kind {kind!r} (want 'bert' or 'clip')")
