"""The port's WSI sweep (keep_tpu_torch.wsi, .io) against the same
dict-based oracle as tests/test_wsi.py, against the JAX package on the same
inputs (probabilities 1e-6, decisions, metrics and heatmaps exactly, fp32
features 2e-5) and against the frozen reference bundle
tests/golden/wsi_rules.npz."""

import json
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keep_tpu import configs as jcfgs
from keep_tpu.io import tiles as jtiles
from keep_tpu.models import keep as jkeep
from keep_tpu.utils.golden import load_bundle
from keep_tpu.wsi import cohort as jcohort
from keep_tpu.wsi import extract as jextract
from keep_tpu.wsi import grid as jgrid
from keep_tpu.wsi import pipelines as jpipe
from keep_tpu_torch import configs
from keep_tpu_torch.compat.torch_loader import from_jax_params
from keep_tpu_torch.io import tiles as ttiles
from keep_tpu_torch.io.h5 import WSIDataset, read_h5_slide
from keep_tpu_torch.models.keep import KEEPModel
from keep_tpu_torch.ops.nn import ieee_fp32, restore_tf32, tf32_state
from keep_tpu_torch.wsi import cohort as tcohort
from keep_tpu_torch.wsi import extract as textract
from keep_tpu_torch.wsi import pipelines as tpipe
from keep_tpu_torch.wsi.grid import CoordGrid, heatmap_image, refine_grid
from keep_tpu_torch.wsi.pipelines import (dice_at_lowres,
                                          patch_labels_from_mask,
                                          refined_tumor_probs, score_tiles,
                                          zero_shot_detection,
                                          zero_shot_segment,
                                          zero_shot_subtyping)
from tests.test_wsi import make_slide, oracle_refine

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "wsi_rules.npz")


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---- twins of tests/test_wsi.py ---------------------------------------------


def test_grid_roundtrip(rng):
    coords, feats = make_slide(rng)
    grid = CoordGrid.from_coords(coords, 256)
    vals = rng.standard_normal((len(coords), 3), dtype=np.float32)
    g, occ = grid.scatter(_t(vals))
    back = grid.gather(g).numpy()
    np.testing.assert_array_equal(back, vals[grid.keep])
    assert occ.sum() == grid.num_patches


def test_refine_matches_oracle(rng):
    ps = 224
    coords, feats = make_slide(rng, n=300, ps=ps)
    probs = rng.random((len(coords), 4), dtype=np.float32)
    grid = CoordGrid.from_coords(coords, ps)
    g, occ = grid.scatter(_t(probs))
    got = grid.gather(refine_grid(g, occ)).numpy()
    ref, order = oracle_refine(probs, [tuple(c) for c in coords], ps, overlap=True)
    assert [tuple(c) for c in grid.kept_coords(coords)] == order
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_misaligned_coords_rejected():
    with pytest.raises(ValueError, match="uniform patch_size grid"):
        CoordGrid.from_coords(np.array([[0, 0], [100, 0]]), 256)


def test_empty_coords_clear_error():
    with pytest.raises(ValueError, match="empty coords"):
        CoordGrid.from_coords(np.zeros((0, 2), np.int64), 256)


def test_offset_aligned_coords_ok():
    g = CoordGrid.from_coords(np.array([[13, 13], [269, 13]]), 256)
    assert (g.rows, g.cols) == (1, 2)


def test_heatmap_image_paints_blocks():
    vals = np.array([[0.5, 1.0], [0.0, 2.0]], np.float32)  # 2 clips to 1
    occ = np.array([[1.0, 1.0], [0.0, 1.0]], np.float32)
    img = heatmap_image(vals, occ, patch_size=256, downsample=16)
    assert img.shape == (32, 32) and img.dtype == np.uint8
    assert (img[:16, :16] == 128).all()
    assert (img[:16, 16:] == 255).all()
    assert (img[16:, :16] == 0).all()
    assert (img[16:, 16:] == 255).all()


def test_tumor_heatmap_end_to_end(rng):
    ps = 224
    coords, feats = make_slide(rng, n=60, ps=ps)
    cls = rng.standard_normal((feats.shape[1], 2)).astype(np.float32)
    hm = tpipe.tumor_heatmap(cls, _t(feats), coords, patch_size=ps)
    grid = CoordGrid.from_coords(coords, ps)
    cell = ps // 16
    assert hm.shape == (grid.rows * cell, grid.cols * cell)
    assert hm.dtype == np.uint8
    _, occ = grid.scatter(torch.zeros(len(coords), 1))
    empty = np.kron(occ.numpy() == 0, np.ones((cell, cell), bool))
    assert (hm[empty] == 0).all()
    probs = refined_tumor_probs(cls, _t(feats), grid, overlap=True).numpy()
    r = (grid.cell_index // grid.cols) * cell
    c = (grid.cell_index % grid.cols) * cell
    np.testing.assert_array_equal(
        hm[r, c], np.round(np.clip(probs, 0, 1) * 255).astype(np.uint8))


def test_subtype_class_map(rng):
    ps = 256
    coords, feats = make_slide(rng, n=50, ps=ps)
    cls = rng.standard_normal((feats.shape[1], 4)).astype(np.float32)
    cm = tpipe.subtype_class_map(cls, _t(feats), coords, patch_size=ps)
    grid = CoordGrid.from_coords(coords, ps)
    cell = ps // 16
    assert cm.shape == (grid.rows * cell, grid.cols * cell)
    assert cm.dtype == np.uint8
    vals = np.unique(cm)
    assert vals.min() >= 0 and vals.max() <= 4
    g, occ = grid.scatter(score_tiles(cls, _t(feats)))
    want = (torch.argmax(refine_grid(g, occ), -1).numpy() + 1) * (
        occ.numpy() > 0)
    r = (grid.cell_index // grid.cols) * cell
    c = (grid.cell_index % grid.cols) * cell
    rr, cc = grid.cell_index // grid.cols, grid.cell_index % grid.cols
    np.testing.assert_array_equal(cm[r, c], want[rr, cc].astype(np.uint8))


def test_score_tiles_softmax_scale(rng):
    feats = rng.standard_normal((50, 16), dtype=np.float32)
    cls = rng.standard_normal((16, 2), dtype=np.float32)
    cls /= np.linalg.norm(cls, axis=0, keepdims=True)
    probs = score_tiles(_t(cls), _t(feats)).numpy()
    f = feats / np.linalg.norm(feats, axis=1, keepdims=True)
    logits = f @ cls * 10
    ref = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    np.testing.assert_allclose(probs, ref, atol=1e-5)
    np.testing.assert_allclose(probs.sum(1), 1.0, atol=1e-5)


def test_detection_matches_oracle(rng):
    ps = 256
    coords, feats = make_slide(rng, n=200, ps=ps)
    cls = rng.standard_normal((32, 2), dtype=np.float32)
    prob = zero_shot_detection(_t(cls), _t(feats), coords, patch_size=ps,
                               overlap=False)
    probs = score_tiles(_t(cls), _t(feats)).numpy()
    refined, _ = oracle_refine(probs, [tuple(c) for c in coords], ps,
                               overlap=False)
    assert prob == pytest.approx(np.mean(refined[:, 1] > 0.5), abs=1e-6)


def test_subtyping_matches_oracle(rng):
    ps = 256
    coords, feats = make_slide(rng, n=250, ps=ps)
    n_classes = 4  # 3 subtypes + the appended Normal
    cls = rng.standard_normal((32, n_classes), dtype=np.float32)
    label, fractions = zero_shot_subtyping(_t(cls), _t(feats), coords,
                                           patch_size=ps)
    probs = score_tiles(_t(cls), _t(feats)).numpy()
    refined, _ = oracle_refine(probs, [tuple(c) for c in coords], ps,
                               overlap=True)
    preds = refined.argmax(1)
    ref_frac = np.array([(preds == i).mean() for i in range(n_classes)])
    np.testing.assert_allclose(fractions, ref_frac, atol=1e-6)
    assert label == int(np.argmax(ref_frac[:-1]))
    assert fractions.sum() == pytest.approx(1.0, abs=1e-6)


def test_patch_labels_from_mask():
    ps = 4
    mask = np.zeros((16, 16), np.uint8)
    mask[0:4, 0:4] = 1
    mask[0:4, 4:6] = 1
    mask[4:8, 0:3] = 1
    coords = np.array([[0, 0], [4, 0], [0, 4], [8, 8]])
    np.testing.assert_array_equal(patch_labels_from_mask(mask, coords, ps),
                                  [1, 0, 1, 0])


def _segmentation_slide(rng, side=10, ps=224):
    coords = np.array([(c * ps, r * ps) for r in range(side)
                       for c in range(side)], np.int64)
    tumor = (coords[:, 0] < 5 * ps).astype(np.float32)  # left half tumor
    d = np.zeros(32, np.float32)
    d[0] = 1.0
    feats = (np.outer(2 * tumor - 1, d)
             + 0.1 * rng.standard_normal((len(coords), 32))).astype(np.float32)
    cls = np.stack([-d, d], axis=1)
    mask = np.zeros((side * ps, side * ps), np.uint8)
    mask[:, : 5 * ps] = 255
    return coords, feats, cls, mask


def test_segmentation_end_to_end(rng):
    coords, feats, cls, mask = _segmentation_slide(rng)
    auc, dice = zero_shot_segment(_t(cls), _t(feats), coords, mask=mask,
                                  patch_size=224)
    assert auc > 0.99
    assert dice > 0.85


def test_dice_painting_counts():
    ps, mag = 32, 16
    mask_lowres = np.zeros((8, 8), np.uint8)
    mask_lowres[0:2, 0:2] = 255
    coords = np.array([[0, 0], [32, 32]])
    assert dice_at_lowres(np.array([0.9, 0.1]), coords, mask_lowres, mag, ps,
                          threshold=0.5) == pytest.approx(1.0)
    assert dice_at_lowres(np.array([0.9, 0.9]), coords, mask_lowres, mag, ps,
                          threshold=0.5) == pytest.approx(2 * 4 / (4 + 8))


def test_probability_heatmap(rng):
    ps = 224
    coords, feats = make_slide(rng, n=120, ps=ps, dup=0)
    cls = rng.standard_normal((32, 2), dtype=np.float32)
    heat, occ = tpipe.probability_heatmap(_t(cls), _t(feats), coords,
                                          patch_size=ps)
    assert heat.shape == occ.shape
    assert occ.sum() == 120
    assert (heat[occ == 0] == 0).all()
    assert (heat[occ == 1] >= 0).all() and (heat[occ == 1] <= 1).all()


def test_mask_path_without_openslide_names_the_item(rng, monkeypatch):
    """A slide-file mask needs OpenSlide; without it the port raises and
    names the ROADMAP item of the native reader, and reads nothing else."""
    import builtins

    real = builtins.__import__

    def no_openslide(name, *a, **kw):
        if name == "openslide":
            raise ImportError("no openslide")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_openslide)
    coords, feats, cls, _ = _segmentation_slide(rng)
    with pytest.raises(NotImplementedError, match="item 13"):
        zero_shot_segment(_t(cls), _t(feats), coords,
                          mask_path="slide_mask.tif", patch_size=224)


def test_cut_tiles_empty_slide():
    blank = np.full((256, 256, 3), 255, np.uint8)
    tiles, coords = ttiles.cut_tiles(blank, patch_size=64)
    assert tiles.shape == (0, 64, 64, 3) and coords.shape == (0, 2)


def test_wsidataset_respects_dataframe_order(tmp_path, rng):
    import pandas as pd

    d = tmp_path / "src"
    (d / "h5_files").mkdir(parents=True)
    for sid in ("s0", "s1", "s2"):
        with h5py.File(str(d / "h5_files" / f"{sid}.h5"), "w") as f:
            f.create_dataset(
                "features", data=rng.standard_normal((4, 8)).astype(np.float32))
            f.create_dataset("coords", data=np.zeros((4, 2), np.int64))
    df = pd.DataFrame({"slide_id": ["s0", "s1", "s2"],
                       "Diagnosis": ["Normal", "Tumor", "Tumor"]})
    ds = WSIDataset(df[df.Diagnosis == "Tumor"], str(d),
                    label_map={"Normal": 0, "Tumor": 1})
    assert len(ds) == 2
    assert ds[0]["slide_id"] == "s1" and ds[1]["slide_id"] == "s2"
    assert ds[0]["label"] == 1


def test_wsidataset_pt_files(tmp_path, rng):
    """The ``pt_files`` branch loads with ``map_location="cpu"``."""
    import pandas as pd

    (tmp_path / "pt_files").mkdir()
    feats = rng.standard_normal((5, 8)).astype(np.float32)
    torch.save(torch.from_numpy(feats), tmp_path / "pt_files" / "a.pt")
    ds = WSIDataset(pd.DataFrame({"slide_id": ["a"], "Diagnosis": [0]}),
                    str(tmp_path), use_h5=False)
    item = ds[0]
    np.testing.assert_array_equal(item["features"], feats)
    assert item["coords"].shape == (5, 2)


def test_kidrare_typod_tumor_name_raises(tmp_path):
    p = tmp_path / "labels.json"
    p.write_text(json.dumps({"a": "Normal", "b": "Hepatoblastoma",
                             "c": "Nephroblastoma"}))
    with pytest.raises(ValueError, match="not among"):
        tcohort.load_kidrare_labels(str(p), "Nephroblastma")
    slides, lm = tcohort.load_kidrare_labels(str(p), "Nephroblastoma")
    assert lm == {"Normal": 0, "Nephroblastoma": 1}
    assert (slides, lm) == jcohort.load_kidrare_labels(str(p), "Nephroblastoma")


# ---- the TF32 guard of the sweep's fp32 products ----------------------------


@pytest.fixture
def tf32_restored():
    saved = tf32_state()
    yield torch.backends.cuda.matmul
    restore_tf32(saved)


@pytest.mark.parametrize("api,value", [("allow_tf32", True),
                                       ("allow_tf32", False),
                                       ("fp32_precision", "tf32"),
                                       ("fp32_precision", "ieee")])
def test_ieee_fp32_restores_the_callers_setting(api, value, tf32_restored):
    """Inside, TF32 is off in both APIs; on exit the caller's setting is
    back in the API the caller used, also where only ``fp32_precision``
    was set and reading ``allow_tf32`` raises."""
    m = tf32_restored
    m.allow_tf32 = False
    setattr(m, api, value)
    before = tf32_state()
    with ieee_fp32():
        assert tf32_state() == (False, "ieee")
        with ieee_fp32():
            assert tf32_state() == (False, "ieee")
        assert tf32_state() == (False, "ieee")
    assert tf32_state() == before


def test_ieee_fp32_holds_across_threads(tf32_restored):
    """Overlapping uses in two threads: the first to enter leaves first,
    and TF32 stays off for the other until it leaves too; then the
    caller's setting is back."""
    import threading

    m = tf32_restored
    m.allow_tf32 = True
    entered, look = threading.Event(), threading.Event()
    seen = []

    def other():
        with ieee_fp32():
            entered.set()
            look.wait(10)
            seen.append(tf32_state())

    with ieee_fp32():
        t = threading.Thread(target=other)
        t.start()
        assert entered.wait(10)
    look.set()  # the first has left; the other is still inside
    t.join(10)
    assert seen == [(False, "ieee")]
    assert tf32_state() == (True, "tf32")


# ---- against the JAX package on the same inputs ----------------------------


@pytest.mark.parametrize("n_classes", [2, 4])
def test_score_tiles_equal_jax(n_classes, rng):
    coords, feats = make_slide(rng, n=300)
    cls = rng.standard_normal((32, n_classes), dtype=np.float32)
    got = score_tiles(_t(cls), _t(feats)).numpy()
    ref = np.asarray(jpipe.score_tiles(jnp.asarray(cls), jnp.asarray(feats)))
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_grid_equals_jax(rng):
    coords, _ = make_slide(rng, n=300, ps=224)
    a = CoordGrid.from_coords(coords, 224)
    b = jgrid.CoordGrid.from_coords(coords, 224)
    assert (a.rows, a.cols, a.origin, a.patch_size) == (
        b.rows, b.cols, b.origin, b.patch_size)
    np.testing.assert_array_equal(a.cell_index, b.cell_index)
    np.testing.assert_array_equal(a.keep, b.keep)
    vals = rng.random((len(coords), 3), dtype=np.float32)
    g, occ = a.scatter(_t(vals))
    jg, jocc = b.scatter(jnp.asarray(vals))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    np.testing.assert_allclose(refine_grid(g, occ).numpy(),
                               np.asarray(jgrid.refine_grid(jg, jocc)),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_detection_equals_jax(overlap, threshold, rng):
    coords, feats = make_slide(rng, n=250)
    cls = rng.standard_normal((32, 2), dtype=np.float32)
    kw = dict(patch_size=256, overlap=overlap, threshold=threshold)
    assert zero_shot_detection(_t(cls), _t(feats), coords, **kw) == \
        jpipe.zero_shot_detection(jnp.asarray(cls), jnp.asarray(feats),
                                  coords, **kw)


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("n_classes", [3, 4])
def test_subtyping_equals_jax(overlap, n_classes, rng):
    coords, feats = make_slide(rng, n=250)
    cls = rng.standard_normal((32, n_classes), dtype=np.float32)
    label, frac = zero_shot_subtyping(_t(cls), _t(feats), coords,
                                      patch_size=256, overlap=overlap)
    jlabel, jfrac = jpipe.zero_shot_subtyping(
        jnp.asarray(cls), jnp.asarray(feats), coords, patch_size=256,
        overlap=overlap)
    assert label == jlabel
    np.testing.assert_array_equal(frac, jfrac)


@pytest.mark.parametrize("overlap", [False, True])
def test_segmentation_equals_jax(overlap, rng):
    coords, feats, cls, mask = _segmentation_slide(rng)
    feats = feats + 0.3 * rng.standard_normal(feats.shape).astype(np.float32)
    got = zero_shot_segment(_t(cls), _t(feats), coords, mask=mask,
                            patch_size=224, overlap=overlap)
    ref = jpipe.zero_shot_segment(jnp.asarray(cls), jnp.asarray(feats),
                                  coords, mask=mask, patch_size=224,
                                  overlap=overlap)
    assert got == ref


@pytest.mark.parametrize("fn", ["tumor_heatmap", "subtype_class_map"])
@pytest.mark.parametrize("overlap", [False, True])
def test_heatmaps_equal_jax(fn, overlap, rng):
    coords, feats = make_slide(rng, n=90, ps=224)
    cls = rng.standard_normal((32, 3), dtype=np.float32)
    got = getattr(tpipe, fn)(_t(cls), _t(feats), coords, patch_size=224,
                             overlap=overlap)
    ref = getattr(jpipe, fn)(jnp.asarray(cls), jnp.asarray(feats), coords,
                             patch_size=224, overlap=overlap)
    np.testing.assert_array_equal(got, ref)


def test_probability_heatmap_equals_jax(rng):
    coords, feats = make_slide(rng, n=90, ps=224)
    cls = rng.standard_normal((32, 2), dtype=np.float32)
    heat, occ = tpipe.probability_heatmap(_t(cls), _t(feats), coords)
    jheat, jocc = jpipe.probability_heatmap(jnp.asarray(cls),
                                            jnp.asarray(feats), coords)
    np.testing.assert_allclose(heat, jheat, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(occ, jocc)


def test_patch_labels_and_dice_equal_jax(rng):
    mask = (rng.random((640, 640)) < 0.4).astype(np.uint8)
    coords = np.array([(c * 32, r * 32) for r in range(20)
                       for c in range(20)], np.int64)
    np.testing.assert_array_equal(
        patch_labels_from_mask(mask, coords, 32),
        jpipe.patch_labels_from_mask(mask, coords, 32))
    probs = rng.random(len(coords))
    lowres = mask[::16, ::16] * 255
    assert dice_at_lowres(probs, coords, lowres, 16, 32, 0.5) == \
        jpipe.dice_at_lowres(probs, coords, lowres, 16, 32, 0.5)


def test_tiles_equal_jax(rng):
    ps = 32
    slide = np.full((8 * ps, 8 * ps, 3), 250, np.uint8)
    slide[ps: 5 * ps, 2 * ps: 7 * ps] = [200, 120, 160]
    slide[6 * ps:, :3 * ps] = rng.integers(0, 256, (2 * ps, 3 * ps, 3))
    np.testing.assert_array_equal(ttiles.tissue_mask(slide),
                                  jtiles.tissue_mask(slide))
    for frac in (0.25, 0.5):
        for a, b in zip(ttiles.cut_tiles(slide, ps, frac),
                        jtiles.cut_tiles(slide, ps, frac)):
            np.testing.assert_array_equal(a, b)


def test_cohorts_equal_jax(rng):
    """The cohort loops over three slides: the same JSON as the JAX
    package's, the features moved to the classifier's device."""
    slides = []
    for i, label in enumerate((0, 1, 1)):
        coords, feats = make_slide(rng, n=80, ps=224)
        slides.append({"slide_id": f"s{i}", "features": feats,
                       "coords": coords, "label": label})
    cls2 = rng.standard_normal((32, 2), dtype=np.float32)
    cls4 = rng.standard_normal((32, 4), dtype=np.float32)
    mask = (rng.random((4000, 4000)) < 0.5).astype(np.uint8)
    provider = lambda sid: mask  # noqa: E731
    for name, cls, args in (("detection_cohort", cls2, ()),
                            ("subtyping_cohort", cls4, ()),
                            ("segmentation_cohort", cls2, (provider,))):
        got = getattr(tcohort, name)(_t(cls), iter(slides), *args,
                                     patch_size=224)
        ref = getattr(jcohort, name)(jnp.asarray(cls), iter(slides), *args,
                                     patch_size=224)
        assert json.dumps(got, default=float, sort_keys=True) == \
            json.dumps(ref, default=float, sort_keys=True), name


# ---- the frozen reference bundle --------------------------------------------


@pytest.fixture(scope="module")
def wsi_bundle():
    return load_bundle(GOLDEN)


def test_detection_matches_frozen_reference(wsi_bundle):
    for name, case in sorted(wsi_bundle["detection"].items()):
        got = zero_shot_detection(
            _t(case["cls"]), _t(case["feats"]), case["coords"],
            patch_size=int(case["ps"]), overlap=bool(case["overlap"]))
        assert got == pytest.approx(float(case["ref_tumor_prob"]),
                                    abs=1e-6), name


def test_segment_refine_matches_frozen_reference(wsi_bundle):
    for name, case in sorted(wsi_bundle["segment_refine"].items()):
        ps = int(case["ps"])
        grid = CoordGrid.from_coords(case["coords"], ps)
        got = refined_tumor_probs(_t(case["cls"]), _t(case["feats"]), grid,
                                  overlap=bool(case["overlap"])).numpy()
        ref = {tuple(xy): v for xy, v in
               zip(case["ref_coords"], case["ref_probs"])}
        kept = grid.kept_coords(case["coords"])
        assert len(got) == len(ref), name
        for (x, y), v in zip(kept, got):
            assert v == pytest.approx(ref[(x, y)], abs=1e-5), name


def test_subtyping_matches_frozen_reference(wsi_bundle):
    for name, case in sorted(wsi_bundle["subtyping"].items()):
        label, fractions = zero_shot_subtyping(
            _t(case["cls"]), _t(case["feats"]), case["coords"],
            patch_size=int(case["ps"]), overlap=bool(case["overlap"]))
        assert label == int(case["ref_label"]), name
        np.testing.assert_allclose(fractions, case["ref_fractions"],
                                   atol=1e-6, err_msg=name)


# ---- feature extraction on a tiny KEEP --------------------------------------

VISION = dict(img_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=2)
TEXT = dict(vocab_size=32, hidden_size=32, num_hidden_layers=1,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=32)
JCFG = jcfgs.KEEPConfig(vision=jcfgs.ViTConfig(**VISION),
                        text=jcfgs.BertConfig(**TEXT), projection_dim=32)
CFG = configs.KEEPConfig(vision=configs.ViTConfig(**VISION),
                         text=configs.BertConfig(**TEXT), projection_dim=32)


@pytest.fixture(scope="module")
def models():
    params = jkeep.init(jax.random.PRNGKey(0), JCFG)
    port = KEEPModel(CFG)
    port.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                         CFG))
    return port.eval(), jkeep.KEEPModel(params=params, cfg=JCFG)


def test_extract_features_roundtrip(models, rng, tmp_path):
    """Tiles → h5 → detection on a tiny model, the twin of test_wsi's, and
    its features against the JAX package's at 2e-5."""
    port, jmodel = models
    tiles = rng.integers(0, 255, (11, 32, 32, 3), dtype=np.uint8)
    feats = textract.extract_features(port, tiles, batch_size=4)
    assert feats.shape == (11, 32) and feats.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(feats, axis=1), 1.0, atol=1e-4)
    np.testing.assert_allclose(
        feats, jextract.extract_features(jmodel, tiles, batch_size=4),
        atol=2e-5, rtol=2e-5)
    # tail padding must not alter real rows
    np.testing.assert_allclose(
        feats, textract.extract_features(port, tiles, batch_size=16),
        atol=1e-5)
    for depth in (1, 3, 7):  # depth reorders fetches, never values
        np.testing.assert_array_equal(
            feats, textract.extract_features(port, tiles, batch_size=4,
                                             pipeline_depth=depth))
    with pytest.raises(ValueError, match="pipeline_depth"):
        textract.extract_features(port, tiles, batch_size=4, pipeline_depth=0)
    coords = np.array([(i * 256, 0) for i in range(11)], np.int64)
    path = str(tmp_path / "slide.h5")
    textract.extract_to_h5(port, tiles, coords, path, batch_size=4)
    f2, c2 = read_h5_slide(path)
    np.testing.assert_array_equal(f2, feats)
    np.testing.assert_array_equal(c2, coords)
    cls = rng.standard_normal((32, 2), dtype=np.float32)
    assert 0.0 <= zero_shot_detection(_t(cls), _t(f2), c2) <= 1.0


def test_extract_features_rechunks_oversize_iterable(models, rng):
    port, _ = models
    tiles = rng.integers(0, 255, (13, 32, 32, 3), dtype=np.uint8)
    ref = textract.extract_features(port, tiles, batch_size=4)
    got = textract.extract_features(port, iter([tiles[:9], tiles[9:]]),
                                    batch_size=4)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_extract_features_empty_and_mesh(models):
    port, _ = models
    out = textract.extract_features(port, iter([]), batch_size=4)
    assert out.shape == (0, CFG.projection_dim) and out.dtype == np.float32
    with pytest.raises(NotImplementedError, match="item 10"):
        textract.extract_features(port, np.zeros((2, 32, 32, 3), np.uint8),
                                  mesh=object())


def test_extract_with_resize_matches_jax(models, rng):
    """The bicubic path (64² tiles → 32²): the JAX package's features at
    2e-5 where the two resizes give the same pixels."""
    port, jmodel = models
    tiles = rng.integers(0, 255, (6, 64, 64, 3), dtype=np.uint8)
    cfg = configs.PreprocessConfig(size=32)
    got = textract.extract_features(port, tiles, batch_size=4, resize=True,
                                    preprocess_cfg=cfg)
    ref = jextract.extract_features(jmodel, tiles, batch_size=4, resize=True,
                                    preprocess_cfg=jcfgs.PreprocessConfig(
                                        size=32))
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


def test_tile_cutting_and_full_loop(models, rng):
    """Raw synthetic slide → tissue tiles → features → detection, the port
    against the JAX package at every step."""
    port, jmodel = models
    ps = 32
    slide = np.full((8 * ps, 8 * ps, 3), 250, np.uint8)
    slide[ps: 5 * ps, 2 * ps: 7 * ps] = [200, 120, 160]
    slide[ps: 5 * ps, 2 * ps: 7 * ps] += rng.integers(
        0, 40, (4 * ps, 5 * ps, 3)).astype(np.uint8)
    mask = ttiles.tissue_mask(slide)
    assert mask[3 * ps, 4 * ps] and not mask[0, 0]
    tiles, coords = ttiles.cut_tiles(slide, patch_size=ps, tissue_fraction=0.5)
    assert len(tiles) == 4 * 5
    assert (coords % ps == 0).all()
    feats = textract.extract_features(port, tiles, batch_size=8)
    jfeats = jextract.extract_features(jmodel, tiles, batch_size=8)
    np.testing.assert_allclose(feats, jfeats, atol=2e-5, rtol=2e-5)
    cls = rng.standard_normal((32, 2), dtype=np.float32)
    prob = zero_shot_detection(_t(cls), _t(feats), coords, patch_size=ps)
    assert 0.0 <= prob <= 1.0
