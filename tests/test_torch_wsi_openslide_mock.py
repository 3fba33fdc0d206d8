"""The port's slide-file segmentation ground truth through OpenSlide
(``keep_tpu_torch.wsi.pipelines._openslide_gt``), driven by a fake OpenSlide
put in ``sys.modules`` (OpenSlide is not installed), against the JAX
package's on the same fake slide and the in-memory mask path: twins of
``tests/test_wsi_openslide_mock.py``."""

import numpy as np
import pytest

from keep_tpu.wsi import pipelines as jpipe
from keep_tpu_torch.wsi.pipelines import (_openslide_gt,
                                          patch_labels_from_mask,
                                          zero_shot_segment)
from tests.test_wsi_openslide_mock import PS, _install, _mask_and_coords
from tests.test_wsi_openslide_mock import _FakeSlide


def test_gt_matches_integral_image_path(monkeypatch):
    mask, coords = _mask_and_coords(np.random.default_rng(0))
    _install(monkeypatch,
             {"/fake/slide.tif": _FakeSlide(mask, [1.0, 4.0, 16.0, 64.0])})
    gt, lowres, mag = _openslide_gt("/fake/slide.tif", coords, PS)
    np.testing.assert_array_equal(gt, patch_labels_from_mask(mask, coords,
                                                             PS))
    assert 0 < gt.sum() < len(gt)
    assert mag == 16
    np.testing.assert_array_equal(lowres, mask[::16, ::16])
    jgt, jlow, jmag = jpipe._openslide_gt("/fake/slide.tif", coords, PS)
    np.testing.assert_array_equal(gt, jgt)
    np.testing.assert_array_equal(lowres, jlow)
    assert mag == jmag


def test_level_selection_picks_nearest_to_16(monkeypatch):
    mask, coords = _mask_and_coords(np.random.default_rng(0))
    _install(monkeypatch, {"/fake/s17.tif": _FakeSlide(mask,
                                                       [1.0, 4.0, 17.0])})
    _, lowres, mag = _openslide_gt("/fake/s17.tif", coords, PS)
    assert mag == 17 == jpipe._openslide_gt("/fake/s17.tif", coords, PS)[2]
    assert lowres.shape == (2240 // 17, 2240 // 17)


def test_zero_shot_segment_mask_path_agrees_with_in_memory(monkeypatch):
    """mask_path (fake OpenSlide) against the mask array on the same
    slide, and against the JAX package's mask_path run: the same AUROC
    and Dice."""
    rng = np.random.default_rng(1)
    mask, coords = _mask_and_coords(rng)
    _install(monkeypatch,
             {"/fake/slide.tif": _FakeSlide(mask, [1.0, 4.0, 16.0, 64.0])})
    gt = patch_labels_from_mask(mask, coords, PS)
    d = 16
    w_tumor, w_norm = rng.standard_normal(d), rng.standard_normal(d)
    feats = np.stack([(w_tumor if g else w_norm)
                      + 0.8 * rng.standard_normal(d) for g in gt]
                     ).astype(np.float32)
    cls = np.stack([w_norm, w_tumor], axis=1).astype(np.float32)
    cls /= np.linalg.norm(cls, axis=0, keepdims=True)
    auc_a, dice_a = zero_shot_segment(cls, feats, coords, mask=mask,
                                      patch_size=PS)
    auc_b, dice_b = zero_shot_segment(cls, feats, coords,
                                      mask_path="/fake/slide.tif",
                                      patch_size=PS)
    auc_j, dice_j = jpipe.zero_shot_segment(cls, feats, coords,
                                            mask_path="/fake/slide.tif",
                                            patch_size=PS)
    assert auc_a == pytest.approx(auc_b, abs=1e-9)
    assert dice_a == pytest.approx(dice_b, abs=1e-9)
    assert auc_b == pytest.approx(auc_j, abs=1e-9)
    assert dice_b == pytest.approx(dice_j, abs=1e-9)
    assert 0.5 < auc_a <= 1.0 and 0.0 < dice_a <= 1.0


def test_missing_openslide_raises_helpfully(monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "openslide", None)
    with pytest.raises(ImportError, match="mask"):
        _openslide_gt("/nope.tif", np.zeros((1, 2), np.int64), PS)
