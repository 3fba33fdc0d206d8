"""Hub publishing surface (counterpart of ``keep_tpu/compat/hub.py``) —
the reference's ``push_to_hf_hub.py:40-193`` (save_for_hf /
save_config_for_hf / generate_readme / push_to_hf_hub) re-targeted for a
machine without network access. The files match the JAX package's name for
name; a state dict of torch tensors or numpy arrays is taken.

``push_to_hub`` writes the EXACT artifact layout the HF hub expects
(open_clip_config.json + weights + tokenizer files + generated README model
card) into a local hub tree (``<root>/<owner>/<name>/``) and registers it in
this package's ``compat.registry`` so ``resolve()`` finds it by name. Uploading that
directory with ``huggingface_hub.upload_folder`` from a networked machine is
the only remaining step — nothing here depends on network access.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np
import torch

HF_WEIGHTS_NAME = "open_clip_pytorch_model.bin"
HF_SAFE_WEIGHTS_NAME = "open_clip_model.safetensors"
HF_CONFIG_NAME = "open_clip_config.json"

# the eval transform's normalization (reference keep_inference.py:88-93)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def default_hub_root() -> str:
    return os.environ.get(
        "KEEP_HUB_ROOT",
        os.path.join(os.path.expanduser("~"), ".cache", "keep_tpu", "hub"))


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu").contiguous()
    return torch.from_numpy(np.array(v))


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array of its dtype (bf16 through ``ml_dtypes``,
    the JAX package's numpy bf16)."""
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def save_config_for_hub(config_path: str, model_config: Optional[dict],
                        preprocess_cfg: Optional[dict] = None) -> None:
    """``save_config_for_hf`` (push_to_hf_hub.py:38-54): model_cfg +
    preprocess_cfg in one json."""
    hf_config = {
        "model_cfg": model_config,
        "preprocess_cfg": preprocess_cfg
        or {"mean": list(IMAGENET_MEAN), "std": list(IMAGENET_STD)},
    }
    with open(config_path, "w") as f:
        json.dump(hf_config, f, indent=2)


def save_for_hub(
    save_directory: str,
    state_dict: dict,
    model_config: Optional[dict] = None,
    preprocess_cfg: Optional[dict] = None,
    tokenizer_files: Optional[list[str]] = None,
    skip_weights: bool = False,
    safe_serialization=False,  # False | True | 'both' (push_to_hf_hub.py:71-75)
) -> None:
    """``save_for_hf`` (push_to_hf_hub.py:57-81): weights + tokenizer +
    open_clip_config.json into one directory.

    ``state_dict`` is a flat name → tensor (or array) mapping (e.g. from
    ``compat.export.to_keep_state_dict``). Saved as torch ``.bin`` (and/or ``.safetensors`` per
    ``safe_serialization``) plus always ``weights.npz`` (framework-neutral)."""
    os.makedirs(save_directory, exist_ok=True)
    if not skip_weights:
        # each entry's dtype is kept (int buffers, bool masks, bf16), as
        # the JAX package keeps it; the torch files take float64 as float32
        raw = {k: _tensor(v) for k, v in state_dict.items()}
        np.savez(os.path.join(save_directory, "weights.npz"),
                 **{k: _numpy(t) for k, t in raw.items()})
        tensors = {k: t.float() if t.dtype == torch.float64 else t
                   for k, t in raw.items()}
        if safe_serialization in (True, "both"):
            from safetensors.torch import save_file

            save_file(tensors,
                      os.path.join(save_directory, HF_SAFE_WEIGHTS_NAME))
        if safe_serialization in (False, "both"):
            torch.save(tensors, os.path.join(save_directory,
                                             HF_WEIGHTS_NAME))
    for f in tokenizer_files or []:
        shutil.copy(f, os.path.join(save_directory, os.path.basename(f)))
    save_config_for_hub(os.path.join(save_directory, HF_CONFIG_NAME),
                        model_config, preprocess_cfg)


def generate_readme(model_card: dict, model_name: str) -> str:
    """The reference's model-card generator, format-identical
    (push_to_hf_hub.py:195-241)."""
    text = "---\n"
    text += "tags:\n- clip\n"
    text += "library_name: open_clip\n"
    text += "pipeline_tag: zero-shot-image-classification\n"
    text += f"license: {model_card.get('license', 'mit')}\n"
    if "details" in model_card and "Dataset" in model_card["details"]:
        text += "datasets:\n"
        text += f"- {model_card['details']['Dataset'].lower()}\n"
    text += "---\n"
    text += f"# Model card for {model_name}\n"
    if "description" in model_card:
        text += f"\n{model_card['description']}\n"
    if "details" in model_card:
        text += "\n## Model Details\n"
        for k, v in model_card["details"].items():
            if isinstance(v, (list, tuple)):
                text += f"- **{k}:**\n"
                for vi in v:
                    text += f"  - {vi}\n"
            elif isinstance(v, dict):
                text += f"- **{k}:**\n"
                for ki, vi in v.items():
                    text += f"  - {ki}: {vi}\n"
            else:
                text += f"- **{k}:** {v}\n"
    if "usage" in model_card:
        text += "\n## Model Usage\n" + model_card["usage"] + "\n"
    if "comparison" in model_card:
        text += "\n## Model Comparison\n" + model_card["comparison"] + "\n"
    if "citation" in model_card:
        text += "\n## Citation\n"
        cites = model_card["citation"]
        if not isinstance(cites, (list, tuple)):
            cites = [cites]
        for c in cites:
            text += f"```bibtex\n{c}\n```\n"
    return text


def push_to_hub(
    repo_id: str,
    state_dict: dict,
    model_config: Optional[dict] = None,
    preprocess_cfg: Optional[dict] = None,
    tokenizer_files: Optional[list[str]] = None,
    model_card: Optional[dict] = None,
    hub_root: Optional[str] = None,
    register: bool = True,
    safe_serialization="both",
) -> str:
    """``push_to_hf_hub`` (push_to_hf_hub.py:84-193) against a LOCAL hub
    tree (offline). Returns the repo directory. A README is generated
    only when absent, mirroring the reference's has_readme check.
    ``safe_serialization`` defaults to 'both' like the reference (.bin +
    .safetensors), so hub consumers without torch can load the repo."""
    if "/" not in repo_id:
        raise ValueError(f"repo_id must be 'owner/name', got {repo_id!r}")
    root = hub_root or default_hub_root()
    repo_dir = os.path.join(root, *repo_id.split("/"))
    os.makedirs(repo_dir, exist_ok=True)  # create_repo(exist_ok=True)

    save_for_hub(repo_dir, state_dict, model_config=model_config,
                 preprocess_cfg=preprocess_cfg,
                 tokenizer_files=tokenizer_files,
                 safe_serialization=safe_serialization)

    readme_path = os.path.join(repo_dir, "README.md")
    if not os.path.exists(readme_path):
        name = repo_id.split("/")[-1]
        with open(readme_path, "w") as f:
            f.write(generate_readme(model_card or {}, name))

    if register:
        from keep_tpu_torch.compat import registry

        registry.register(
            repo_id, repo_dir, source=f"local-hub:{repo_id}", kind="dir",
        )
    return repo_dir
