"""Training run configuration: one dataclass tree loaded from YAML or JSON
(counterpart of ``keep_tpu/train/config.py``, re-declared with the same
fields and defaults, so one file configures both packages).

``from_yaml`` reads a ``.json`` path with ``json`` (JSON is a subset of
YAML, so the JAX package's loader reads the same file) and anything else
with PyYAML, imported only then."""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

from keep_tpu_torch.configs import BertConfig, KEEPConfig, ViTConfig


@dataclasses.dataclass
class DatasetConfig:
    type: str = "json"  # 'json' | 'csv'
    train_data: str = ""
    val_data: str = ""
    img_dir: str = ""
    knowledge_file: str = ""
    label_cap: str = "both"
    zeroshot_cls: str = ""
    zeroshot_cls_imdir: str = ""
    zeroshot_cls_prompts: str = ""
    zeroshot_ret: str = ""
    zeroshot_ret_imdir: str = ""
    csv_img_key: str = "image_name"
    csv_caption_key: str = "caption"
    csv_separator: str = "|"
    vocab_path: str = ""  # a vocab.txt or a directory holding one
    tokenizer_type: str = "bert"  # 'bert' (WordPiece); 'clip' is not ported
    preload_data: bool = False  # decode every image into RAM up front


@dataclasses.dataclass
class DataloaderConfig:
    batch_size: int = 128
    caption_num: int = 32  # groups per batch
    text_drop: bool = True
    workers: int = 8


@dataclasses.dataclass
class SolverConfig:
    epochs: int = 10
    lr: float = 1e-5
    weight_decay: float = 0.2
    beta1: float = 0.9
    beta2: float = 0.98
    eps: float = 1e-6
    warmup: int = 200
    lr_scheduler: str = "cosine"  # 'cosine' | 'const' | 'const-cooldown'
    cooldown_steps: int = 0
    cooldown_power: float = 1.0
    cooldown_end_lr: float = 0.0
    grad_clip_norm: Optional[float] = 1.0
    mu_dtype: Optional[str] = None  # 'bfloat16': Adam's first moment in bf16
    accum_freq: int = 1
    zeroshot_frequency: int = 1
    val_frequency: int = 1
    freeze_visual_epochs: int = 1
    freeze_text_epochs: int = 1
    freeze_knowledge_epochs: int = 0
    lora_rank: int = 0  # > 0: LoRA fine-tuning (train/lora.py)
    lora_alpha: float = 16.0
    lora_targets: tuple = ("qkv", "proj", "out", "fc1", "fc2")
    # not ported yet: train.main raises when they ask for more than one
    # process or device
    fsdp: bool = False
    fsdp_min_size: int = 1 << 16
    tp: int = 1
    sp: bool = False
    ep: int = 1
    pp: int = 1


@dataclasses.dataclass
class ModelSection:
    precision: str = "amp_bf16"  # bf16 compute over fp32 master weights
    type: str = "hierarchy_metric"  # loss selector ('clip' for InfoNCE)
    loss_subtype: str = "lhp-hn"
    logit_scale: float = 0.04
    pretrained_image: str = ""  # timm ViT checkpoint
    pretrained_text: str = ""  # knowledge-BERT checkpoint
    use_flash: bool = True


@dataclasses.dataclass
class SaveConfig:
    output_dir: str = "./logs"
    experiment_name: str = ""
    save_frequency: int = 1
    delete_previous_checkpoint: bool = False
    async_checkpointing: bool = False  # write checkpoints in a thread
    resume: str = ""  # '' | 'latest' | an epoch number
    remote_sync: str = ""  # a directory or fsspec URL (train/sync.py)
    remote_sync_frequency: int = 300
    copy_codebase: bool = False
    wandb_project: str = ""


@dataclasses.dataclass
class TrainRunConfig:
    dataset: DatasetConfig = dataclasses.field(default_factory=DatasetConfig)
    dataloader: DataloaderConfig = dataclasses.field(
        default_factory=DataloaderConfig)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    model: ModelSection = dataclasses.field(default_factory=ModelSection)
    save: SaveConfig = dataclasses.field(default_factory=SaveConfig)
    keep: KEEPConfig = dataclasses.field(default_factory=KEEPConfig)
    seed: int = 0

    @classmethod
    def from_yaml(cls, path: str) -> "TrainRunConfig":
        with open(path) as f:
            if path.endswith(".json"):
                raw = json.load(f)
            else:
                import yaml

                raw = yaml.safe_load(f)
        return cls.from_dict(raw or {})

    @classmethod
    def from_dict(cls, raw: dict) -> "TrainRunConfig":
        def build(dc, d):
            names = {f.name for f in dataclasses.fields(dc)}
            kwargs = {}
            for k, v in (d or {}).items():
                k = k.lower()
                if k not in names:
                    raise KeyError(f"unknown config key {k} for {dc.__name__}")
                kwargs[k] = v
            return dc(**kwargs)

        raw = dict(raw)
        keep_raw = raw.pop("keep", None) or {}
        keep_cfg = KEEPConfig(
            vision=ViTConfig(**keep_raw.get("vision", {})),
            text=BertConfig(**keep_raw.get("text", {})),
            projection_dim=keep_raw.get("projection_dim", 768),
            max_text_length=keep_raw.get("max_text_length", 256),
        )
        return cls(
            dataset=build(DatasetConfig, raw.get("dataset")),
            dataloader=build(DataloaderConfig, raw.get("dataloader")),
            solver=build(SolverConfig, raw.get("solver")),
            model=build(ModelSection, raw.get("model")),
            save=build(SaveConfig, raw.get("save")),
            keep=keep_cfg,
            seed=raw.get("seed", 0),
        )
