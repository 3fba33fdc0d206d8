"""Retrieval metrics (counterpart of ``keep_tpu/metrics/retrieval.py``):
host numpy, the same sort calls as the JAX package, so that the same
features give the same numbers."""

from __future__ import annotations

import numpy as np


def retrieval_precision(y_target, y_predictions, ks=(10, 50)) -> dict:
    """p@k: the share of queries whose target id is in their top-k
    prediction list."""
    out = {f"p@{k}": 0.0 for k in ks}
    n = len(y_target)
    for t, preds in zip(y_target, y_predictions):
        for k in ks:
            if t in list(preds[:k]):
                out[f"p@{k}"] += 1.0
    return {k: v / n for k, v in out.items()}


def clip_retrieval_metrics(image_features: np.ndarray,
                           text_features: np.ndarray,
                           logit_scale: float = 1.0) -> dict:
    """R@1/5/10 and mean / median rank in both directions on paired
    features (row i of each is one pair)."""
    image_features = np.asarray(image_features)
    text_features = np.asarray(text_features)
    logits_per_image = logit_scale * image_features @ text_features.T
    metrics = {}
    n = logits_per_image.shape[0]
    ground_truth = np.arange(n)
    for name, logits in (
        ("image_to_text", logits_per_image),
        ("text_to_image", logits_per_image.T),
    ):
        ranking = np.argsort(-logits, axis=1)
        preds = np.argmax(ranking == ground_truth[:, None], axis=1)
        metrics[f"{name}_mean_rank"] = float(preds.mean() + 1)
        metrics[f"{name}_median_rank"] = float(np.floor(np.median(preds)) + 1)
        for k in (1, 5, 10):
            metrics[f"{name}_R@{k}"] = float(np.mean(preds < k))
    return metrics
