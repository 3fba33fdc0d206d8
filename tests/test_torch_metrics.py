"""The port's classification metrics (keep_tpu_torch.metrics) against
sklearn, as tests/test_metrics.py holds the JAX package's, and against the
JAX package on the same inputs: host metrics exactly, the device AUROC at
float tolerance."""

import numpy as np
import pytest
import sklearn.metrics as skm
import torch

from keep_tpu.metrics import classification as jm
from keep_tpu_torch.metrics import (
    auroc,
    auroc_device,
    balanced_accuracy,
    classification_metrics,
    roc_best_threshold,
    sensitivity_specificity,
    weighted_f1,
)
from keep_tpu_torch.metrics import classification as tm
from keep_tpu_torch.metrics.classification import matthews_corrcoef


@pytest.mark.parametrize("n", [50, 999])
def test_auroc_matches_sklearn(n, rng):
    y = rng.integers(0, 2, n)
    y[0], y[1] = 0, 1
    s = rng.random(n)
    assert abs(auroc(y, s) - skm.roc_auc_score(y, s)) < 1e-10
    # with heavy ties
    s_t = np.round(s, 1)
    assert abs(auroc(y, s_t) - skm.roc_auc_score(y, s_t)) < 1e-10
    assert abs(float(auroc_device(y, s_t)) - skm.roc_auc_score(y, s_t)) < 1e-5


@pytest.mark.parametrize("n", [50, 999])
def test_auroc_device_matches_jax(n, rng):
    """Average ranks with ties on both sides: the port's torch AUROC equals
    the JAX one to float tolerance, on tensors it keeps on their device."""
    y = rng.integers(0, 2, n)
    y[0], y[1] = 0, 1
    s = np.round(rng.random(n), 1).astype(np.float32)
    got = auroc_device(torch.from_numpy(y), torch.from_numpy(s))
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert abs(float(got) - float(jm.auroc_device(y, s))) < 1e-6


def test_best_threshold_matches_sklearn(rng):
    y = rng.integers(0, 2, 500)
    y[:2] = [0, 1]
    s = np.round(rng.random(500), 2)
    fpr, tpr, thr = skm.roc_curve(y, s)
    ref_thd = thr[np.argmax(tpr - fpr)]
    auc_v, thd = roc_best_threshold(y, s)
    assert abs(auc_v - skm.roc_auc_score(y, s)) < 1e-10
    ours = (s > thd).astype(int) if np.isfinite(thd) else np.zeros_like(y)
    refs = (s > ref_thd).astype(int) if np.isfinite(ref_thd) else np.zeros_like(y)
    assert (ours == refs).all() or abs(thd - ref_thd) < 1e-12


def test_classification_metrics_match_sklearn(rng):
    y = rng.integers(0, 3, 300)
    p = rng.integers(0, 3, 300)
    got = classification_metrics(y, p)
    assert abs(got["WF1"] - skm.f1_score(y, p, average="weighted")) < 1e-10
    assert abs(got["precision"] - skm.precision_score(y, p, average="weighted")) < 1e-10
    assert abs(got["recall"] - skm.recall_score(y, p, average="weighted")) < 1e-10
    assert abs(got["mcc"] - skm.matthews_corrcoef(y, p)) < 1e-10
    assert abs(got["Accuracy"] - skm.accuracy_score(y, p)) < 1e-10
    assert abs(weighted_f1(y, p) - skm.f1_score(y, p, average="weighted")) < 1e-10
    assert abs(matthews_corrcoef(y, p) - skm.matthews_corrcoef(y, p)) < 1e-10


def test_binary_metrics(rng):
    y = rng.integers(0, 2, 200)
    p = rng.integers(0, 2, 200)
    sens, spec = sensitivity_specificity(y, p)
    cm = skm.confusion_matrix(y, p)
    assert abs(sens - cm[1, 1] / cm[1].sum()) < 1e-12
    assert abs(spec - cm[0, 0] / cm[0].sum()) < 1e-12
    assert abs(
        balanced_accuracy(y, p) - skm.balanced_accuracy_score(y, p)
    ) < 1e-12


def test_degenerate_cohorts_yield_nan_not_crash():
    m = classification_metrics([1, 1, 1], [1, 0, 1],
                               y_pred_proba=[0.9, 0.2, 0.8])
    assert np.isnan(m["AUC"])
    sens, spec = sensitivity_specificity([1, 1, 1, 1], [1, 0, 1, 1])
    assert sens == 0.75 and np.isnan(spec)
    sens2, spec2 = sensitivity_specificity(["a", "b"], ["a", "b"])
    assert np.isnan(sens2) and np.isnan(spec2)


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b)
    else:
        assert a == b


@pytest.mark.parametrize("name", [
    "roc_curve", "auroc", "roc_best_threshold", "confusion_binary",
    "sensitivity_specificity", "balanced_accuracy", "weighted_f1",
    "matthews_corrcoef", "classification_metrics"])
def test_host_metrics_equal_jax(name, rng):
    """The host metrics are the JAX package's, value for value."""
    y = rng.integers(0, 2, 400)
    s = np.round(rng.random(400), 2)
    p = (s > 0.5).astype(int)
    args = {"roc_curve": (y, s), "auroc": (y, s), "roc_best_threshold": (y, s)}
    a = args.get(name, (y, p))
    _same(getattr(tm, name)(*a), getattr(jm, name)(*a))
    if name == "classification_metrics":
        _same(tm.classification_metrics(y, p, s),
              jm.classification_metrics(y, p, s))


@pytest.mark.parametrize("counts", [(0, 0, 0), (3, 10, 4), (7.5, 8, 9)])
def test_dice_from_counts_equals_jax(counts):
    assert tm.dice_from_counts(*counts) == jm.dice_from_counts(*counts)
