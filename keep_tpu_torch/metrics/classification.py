"""Classification metrics with sklearn's semantics, without sklearn
(counterpart of ``keep_tpu/metrics/classification.py``).

The reference's metric surface (training/path_open_clip/
zeroshot_metrics.py:20-72, WSI_evaluation/segment_utils.py:91-152,
detection_utils.py:76-86): AUROC, the ROC best threshold (Youden), Dice,
balanced accuracy, weighted F1 / precision / recall, MCC and sens / spec /
ppv / npv. Host numpy versions for slide-level sets, and a torch AUROC
(``auroc_device``) for the 10K–100K patch axis, on the scores' device.
"""

from __future__ import annotations

import numpy as np
import torch


# --------------------------------------------------------------------------
# ROC / AUROC
# --------------------------------------------------------------------------


def _binary_clf_curve(y_true: np.ndarray, y_score: np.ndarray):
    """Cumulative TP/FP at each distinct descending score (sklearn internals)."""
    y_true = np.asarray(y_true).astype(np.float64)
    y_score = np.asarray(y_score).astype(np.float64)
    order = np.argsort(-y_score, kind="stable")
    y_true, y_score = y_true[order], y_score[order]
    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    return fps, tps, y_score[threshold_idxs]


def roc_curve(y_true: np.ndarray, y_score: np.ndarray):
    """(fpr, tpr, thresholds), sklearn semantics incl. the prepended
    (0, 0, inf) point. No drop_intermediate (superset of sklearn's points;
    Youden argmax lands on the same vertex)."""
    fps, tps, thresholds = _binary_clf_curve(y_true, y_score)
    tps = np.r_[0, tps]
    fps = np.r_[0, fps]
    thresholds = np.r_[np.inf, thresholds]
    if fps[-1] <= 0 or tps[-1] <= 0:
        raise ValueError("roc_curve needs both classes present")
    return fps / fps[-1], tps / tps[-1], thresholds


_trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy<2 fallback


def auroc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    fpr, tpr, _ = roc_curve(y_true, y_score)
    return float(_trapezoid(tpr, fpr))


def roc_best_threshold(y_true: np.ndarray, y_score: np.ndarray) -> tuple[float, float]:
    """(auroc, threshold at max tpr−fpr) — the reference's segmentation
    operating point (segment_utils.py:113-119)."""
    fpr, tpr, thresholds = roc_curve(y_true, y_score)
    best = int(np.argmax(tpr - fpr))
    return float(_trapezoid(tpr, fpr)), float(thresholds[best])


def auroc_device(y_true, y_score) -> torch.Tensor:
    """AUROC on the scores' device via average ranks (Mann–Whitney with tie
    correction), for the patch axis of a slide; equals ``auroc`` to float
    tolerance. Tensors stay on their device; numpy inputs go to the CPU."""
    y_score = torch.as_tensor(y_score).to(torch.float32).ravel()
    y_true = torch.as_tensor(y_true, device=y_score.device).to(
        torch.float32).ravel()
    n = y_score.shape[0]
    order = torch.argsort(y_score, stable=True)
    sorted_scores = y_score[order]
    ranks_sorted = torch.arange(1, n + 1, dtype=torch.float32,
                                device=y_score.device)
    # average ranks across ties: segment by distinct sorted score
    is_new = torch.ones(n, dtype=torch.bool, device=y_score.device)
    is_new[1:] = sorted_scores[1:] != sorted_scores[:-1]
    seg_id = torch.cumsum(is_new.long(), 0) - 1
    seg_sum = torch.zeros(n, dtype=torch.float32,
                          device=y_score.device).index_add_(0, seg_id,
                                                            ranks_sorted)
    seg_cnt = torch.zeros(n, dtype=torch.float32,
                          device=y_score.device).index_add_(
        0, seg_id, torch.ones_like(ranks_sorted))
    avg_rank_sorted = (seg_sum / seg_cnt.clamp_min(1.0))[seg_id]
    ranks = torch.empty_like(avg_rank_sorted)
    ranks[order] = avg_rank_sorted
    n_pos = y_true.sum()
    n_neg = n - n_pos
    rank_sum_pos = (ranks * y_true).sum()
    u = rank_sum_pos - n_pos * (n_pos + 1) / 2.0
    return u / (n_pos * n_neg).clamp_min(1.0)


# --------------------------------------------------------------------------
# Confusion-based metrics
# --------------------------------------------------------------------------


def confusion_binary(y_true, y_pred) -> tuple[int, int, int, int]:
    # literal ==1/==0 comparisons like the reference (zeroshot_metrics.py:36-45):
    # non-numeric labels simply yield zero counts (sens/spec become nan)
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    t1, t0 = (y_true == 1), (y_true == 0)
    p1, p0 = (y_pred == 1), (y_pred == 0)
    tp = int(np.sum(t1 & p1))
    tn = int(np.sum(t0 & p0))
    fp = int(np.sum(t0 & p1))
    fn = int(np.sum(t1 & p0))
    return tp, fp, tn, fn


def sensitivity_specificity(y_true, y_pred) -> tuple[float, float]:
    """(detection_utils.py:76-86). A cohort missing one class yields nan
    for that side (matching the comment above), not ZeroDivisionError."""
    tp, fp, tn, fn = confusion_binary(y_true, y_pred)
    sens = tp / float(tp + fn) if (tp + fn) else float("nan")
    spec = tn / float(tn + fp) if (tn + fp) else float("nan")
    return sens, spec


def balanced_accuracy(y_true, y_pred) -> float:
    """Mean per-class recall over classes present in y_true (sklearn)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    recalls = []
    for c in np.unique(y_true):
        m = y_true == c
        recalls.append(np.mean(y_pred[m] == c))
    return float(np.mean(recalls))


def _prf_per_class(y_true, y_pred, labels):
    precision, recall, f1, support = [], [], [], []
    for c in labels:
        tp = np.sum((y_pred == c) & (y_true == c))
        p = tp / max(np.sum(y_pred == c), 1e-12)
        r = tp / max(np.sum(y_true == c), 1e-12)
        f = 0.0 if (p + r) == 0 else 2 * p * r / (p + r)
        precision.append(p)
        recall.append(r)
        f1.append(f)
        support.append(np.sum(y_true == c))
    return map(np.asarray, (precision, recall, f1, support))


def weighted_f1(y_true, y_pred) -> float:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    labels = np.unique(np.r_[y_true, y_pred])
    _, _, f1, support = _prf_per_class(y_true, y_pred, labels)
    if support.sum() == 0:
        return 0.0
    return float(np.average(f1, weights=np.maximum(support, 0)))


def matthews_corrcoef(y_true, y_pred) -> float:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    labels = np.unique(np.r_[y_true, y_pred])
    k = len(labels)
    lut = {c: i for i, c in enumerate(labels)}
    cm = np.zeros((k, k), np.float64)
    for t, p in zip(y_true, y_pred):
        cm[lut[t], lut[p]] += 1
    t_sum = cm.sum(axis=1)
    p_sum = cm.sum(axis=0)
    n = cm.sum()
    cov_tp = np.trace(cm) * n - t_sum @ p_sum
    cov_tt = n**2 - t_sum @ t_sum
    cov_pp = n**2 - p_sum @ p_sum
    denom = np.sqrt(cov_tt * cov_pp)
    return float(cov_tp / denom) if denom else 0.0


def classification_metrics(y_true, y_pred, y_pred_proba=None) -> dict:
    """The reference's full metric dict (zeroshot_metrics.py:20-72),
    weighted averaging."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    labels = np.unique(np.r_[y_true, y_pred])
    precision, recall, f1, support = _prf_per_class(y_true, y_pred, labels)
    w = np.maximum(support, 0)
    tp, fp, tn, fn = confusion_binary(y_true, y_pred)

    def safe(n, d):
        return float(n / d) if d else float("nan")

    if y_pred_proba is None or len(np.unique(y_true)) != 2:
        # multiclass AND degenerate single-class cohorts both yield nan
        # (roc_curve needs exactly two classes)
        auc_v = float("nan")
    else:
        auc_v = auroc(y_true, y_pred_proba)
    return {
        "Accuracy": float(np.mean(y_true == y_pred)),
        "AUC": auc_v,
        "WF1": float(np.average(f1, weights=w)),
        "precision": float(np.average(precision, weights=w)),
        "recall": float(np.average(recall, weights=w)),
        "mcc": matthews_corrcoef(y_true, y_pred),
        "tp": tp, "fp": fp, "tn": tn, "fn": fn,
        "sensitivity": safe(tp, tp + fn),
        "specificity": safe(tn, tn + fp),
        "ppv": safe(tp, tp + fp),
        "npv": safe(tn, tn + fn),
        "hitrate": safe(tp + tn, tp + tn + fp + fn),
        "instances": len(y_true),
    }


# --------------------------------------------------------------------------
# Dice (WSI segmentation, segment_utils.py:122-152 semantics)
# --------------------------------------------------------------------------


def dice_from_counts(intersection: float, mask_sum: float, pred_sum: float) -> float:
    denom = mask_sum + pred_sum
    if denom == 0:
        return 1.0
    return 2.0 * intersection / denom
