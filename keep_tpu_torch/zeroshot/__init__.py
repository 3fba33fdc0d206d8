"""Zero-shot classifiers from prompt ensembles (counterpart of
``keep_tpu/zeroshot``); the OpenCLIP ImageNet classifier and its metadata
are ``zeroshot.openclip`` and ``zeroshot.imagenet_metadata``."""

from keep_tpu_torch.zeroshot.classifier import (  # noqa: F401
    build_classifier,
    build_classifiers_batched,
    encode_texts_bucketed,
    prompt_select,
    random_ensemble,
    rank_cls_scores,
)
