"""Slide-level and patch-level classification metrics and retrieval metrics
(counterpart of ``keep_tpu/metrics``)."""

from keep_tpu_torch.metrics.classification import (  # noqa: F401
    auroc,
    auroc_device,
    balanced_accuracy,
    classification_metrics,
    confusion_binary,
    dice_from_counts,
    matthews_corrcoef,
    roc_best_threshold,
    roc_curve,
    sensitivity_specificity,
    weighted_f1,
)
from keep_tpu_torch.metrics.retrieval import (  # noqa: F401
    clip_retrieval_metrics,
    retrieval_precision,
)
