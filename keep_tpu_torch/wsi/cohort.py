"""Cohort-level zero-shot WSI evaluation: the batch ``run()`` loops of the
reference drivers (WSI_evaluation/detection_utils.py:12-36,
segment_utils.py:16-42, subtyping_utils.py:12-35 + the zeroshot_*_WSI.py
mains), producing slide-level metrics over a dataset (counterpart of
``keep_tpu/wsi/cohort.py``).

Each slide's features go to ``device`` (default: the classifier's), where
its pipeline runs; the next slide is read on a background thread meanwhile
(``utils.prefetch.Prefetcher``).
"""

from __future__ import annotations

import json
import logging
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from keep_tpu_torch.metrics import (
    auroc,
    balanced_accuracy,
    sensitivity_specificity,
)
from keep_tpu_torch.utils.prefetch import Prefetcher
from keep_tpu_torch.wsi.pipelines import (
    zero_shot_detection,
    zero_shot_segment,
    zero_shot_subtyping,
)


def load_kidrare_labels(path: str, tumor_name: Optional[str] = None) -> tuple[dict, dict]:
    """KidRare label JSON → (slide→label, label_map), deriving the task from
    the file (WSI_evaluation/kidrare_label/*.json ship two shapes):

    - binary detection ('Normal' + one tumor label, e.g. Nephroblastoma):
      label_map = {'Normal': 0, <tumor>: 1};
    - multi-subtype (no 'Normal', e.g. the Medulloblastoma variants):
      label_map = {subtype: index} in sorted order — pair with
      ``add_normal=True`` in the subtyping pipeline, which appends the
      excluded Normal class.
    """
    with open(path) as f:
        slides = json.load(f)
    values = sorted(set(slides.values()))
    if "Normal" in values:
        others = [v for v in values if v != "Normal"]
        if tumor_name is not None:
            if tumor_name not in others:
                # a typo'd tumor name must not silently score against a
                # different positive class
                raise ValueError(
                    f"tumor_name {tumor_name!r} not among {others} in {path}")
            tumor = tumor_name
        else:
            if len(others) != 1:
                raise ValueError(
                    f"ambiguous tumor label among {others} in {path}")
            tumor = others[0]
        label_map = {"Normal": 0, tumor: 1}
    else:
        label_map = {v: i for i, v in enumerate(values)}
    return slides, label_map


def _on(features, classifier, device) -> torch.Tensor:
    """One slide's features on ``device`` (default: the classifier's)."""
    if device is None:
        device = torch.as_tensor(classifier).device
    return torch.as_tensor(features).to(device)


def detection_cohort(
    classifier,
    dataset: Iterable[dict],
    patch_size: int = 256,
    overlap: bool = False,
    threshold: float = 0.5,
    slide_threshold: float = 0.5,
    device=None,
) -> dict:
    """Per-slide tumor probability → cohort AUROC + sens/spec.

    ``threshold`` is the PER-PATCH tumor cutoff (the reference's fixed 0.5
    on the softmax, detection_utils.py:88-100); ``slide_threshold`` is the
    slide-level sens/spec operating point (the reference's 0.5,
    detection_utils.py:76-86). They are independent knobs — the old single
    threshold silently moved both."""
    probs, labels, per_slide = [], [], {}
    for item in Prefetcher(dataset):
        p = zero_shot_detection(
            classifier, _on(item["features"], classifier, device),
            item["coords"],
            patch_size=patch_size, overlap=overlap, threshold=threshold,
        )
        probs.append(p)
        labels.append(int(item["label"]))
        per_slide[item["slide_id"]] = p
        logging.info("detection %s: tumor_prob=%.4f label=%s",
                     item["slide_id"], p, item["label"])
    probs_a, labels_a = np.asarray(probs), np.asarray(labels)
    out = {"per_slide": per_slide, "n": len(probs)}
    if len(np.unique(labels_a)) == 2:
        out["auroc"] = auroc(labels_a, probs_a)
        sens, spec = sensitivity_specificity(
            labels_a, (probs_a > slide_threshold).astype(int))
        out["sensitivity"], out["specificity"] = sens, spec
    return out


def segmentation_cohort(
    classifier,
    dataset: Iterable[dict],
    mask_provider: Callable[[str], object],
    patch_size: int = 224,
    overlap: bool = True,
    device=None,
) -> dict:
    """Per-slide (AUROC, Dice) → cohort means (segmentation driver,
    zeroshot_segmentation_WSI.py:69-71). ``mask_provider(slide_id)`` returns
    an in-memory level-0 mask array or a mask path."""
    aucs, dices, per_slide = [], [], {}
    for item in Prefetcher(dataset):
        mask = mask_provider(item["slide_id"])
        kw = {"mask_path": mask} if isinstance(mask, str) else {"mask": mask}
        auc, dice = zero_shot_segment(
            classifier, _on(item["features"], classifier, device),
            item["coords"],
            patch_size=patch_size, overlap=overlap, **kw,
        )
        aucs.append(auc)
        dices.append(dice)
        per_slide[item["slide_id"]] = {"auroc": auc, "dice": dice}
        logging.info("segment %s: auroc=%.4f dice=%.4f", item["slide_id"], auc, dice)
    return {
        "mean_auroc": float(np.mean(aucs)),
        "mean_dice": float(np.mean(dices)),
        "per_slide": per_slide,
        "n": len(aucs),
    }


def subtyping_cohort(
    classifier,
    dataset: Iterable[dict],
    patch_size: int = 256,
    overlap: bool = True,
    exclude_last_class: bool = True,
    device=None,
) -> dict:
    """Per-slide predicted subtype → balanced accuracy (subtyping driver,
    zeroshot_subtyping_WSI.py:61-84; the classifier carries an appended
    Normal class excluded from the slide-level argmax)."""
    preds, labels, per_slide = [], [], {}
    for item in Prefetcher(dataset):
        label_pred, fractions = zero_shot_subtyping(
            classifier, _on(item["features"], classifier, device),
            item["coords"],
            patch_size=patch_size, overlap=overlap,
            exclude_last_class=exclude_last_class,
        )
        preds.append(label_pred)
        labels.append(int(item["label"]))
        per_slide[item["slide_id"]] = {
            "pred": label_pred, "fractions": fractions.tolist()
        }
        logging.info("subtype %s: pred=%d label=%s", item["slide_id"],
                     label_pred, item["label"])
    return {
        "balanced_accuracy": balanced_accuracy(labels, preds),
        "per_slide": per_slide,
        "n": len(preds),
    }
