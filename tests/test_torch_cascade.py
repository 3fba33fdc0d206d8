"""The port's coarse-to-fine cascade (``keep_tpu_torch.wsi.cascade``)
against the JAX package's on the same pyramid, weights (fp32) and
classifier: the same refined set and counts, probabilities at 2e-5 (1e-4
where tiles go through the two packages' bicubics, which differ by one
8-bit step on up to 1% of the values); and the port's own exact limit
(margin 0.5 equals its plain sweep) and error legs. Twins of
``tests/test_cascade.py``."""

import jax
import numpy as np
import pytest

from keep_tpu import configs as jcfgs
from keep_tpu.io.tiles import iter_wsi_tiles as jiter_wsi_tiles
from keep_tpu.io.wsi import open_slide as jopen_slide
from keep_tpu.models import keep as jkeep
from keep_tpu.wsi import cascade as jcascade
from keep_tpu.wsi.extract import extract_features as jextract
from keep_tpu_torch import configs
from keep_tpu_torch.compat.torch_loader import from_jax_params
from keep_tpu_torch.io.tiles import iter_wsi_tiles, tissue_coords
from keep_tpu_torch.io.wsi import open_slide, write_pyramid
from keep_tpu_torch.models.keep import KEEPModel
from keep_tpu_torch.wsi.cascade import cascade_detect
from keep_tpu_torch.wsi.extract import extract_features
from keep_tpu_torch.wsi.pipelines import score_tiles

PS = 32  # tile size == the tiny model's img_size


def _cfgs(img_size, patch_size):
    # no LayerScale: at its 1e-5 init the blocks barely move the stream,
    # the CLS token never sees the tile and every probability sits within
    # 1e-6 of 0.5, where the refined set would hang on exact ties
    v = dict(img_size=img_size, patch_size=patch_size, embed_dim=32,
             depth=2, num_heads=2, layerscale_init=None)
    t = dict(vocab_size=32, hidden_size=32, num_hidden_layers=1,
             num_attention_heads=2, intermediate_size=64,
             max_position_embeddings=32)
    return (jcfgs.KEEPConfig(vision=jcfgs.ViTConfig(**v),
                             text=jcfgs.BertConfig(**t), projection_dim=32),
            configs.KEEPConfig(vision=configs.ViTConfig(**v),
                               text=configs.BertConfig(**t),
                               projection_dim=32))


def _models(img_size, patch_size):
    jcfg, cfg = _cfgs(img_size, patch_size)
    params = jkeep.init(jax.random.PRNGKey(0), jcfg)
    port = KEEPModel(cfg)
    port.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                         cfg))
    return jkeep.KEEPModel(params=params, cfg=jcfg), port.eval()


@pytest.fixture(scope="module")
def models():
    return _models(PS, 16)


@pytest.fixture(scope="module")
def slide_path(tmp_path_factory):
    """1024² pyramid (levels 1/2/4 at min_size 256) of pink tissue-like
    texture with a distinct dark region."""
    g = np.random.default_rng(3)
    side = 1024
    yy, xx = np.mgrid[0:side, 0:side]
    base = np.stack([np.full((side, side), 210.0),
                     np.full((side, side), 140.0),
                     np.full((side, side), 180.0)], -1)
    base[(xx > side // 2) & (yy > side // 3)] = [120.0, 60.0, 100.0]
    slide = np.clip(base + g.normal(0, 12, base.shape), 0,
                    255).astype(np.uint8)
    p = tmp_path_factory.mktemp("cascade") / "slide.tif"
    write_pyramid(str(p), slide, tile=128, compression="none", min_size=256)
    return str(p)


@pytest.fixture(scope="module")
def classifier(models, slide_path):
    """Prototypes from the brightest and darkest tiles, through the JAX
    package's encoder (test_cascade.py's classifier): both packages get
    this one matrix."""
    tiles = np.concatenate([t for t, _ in jiter_wsi_tiles(
        slide_path, patch_size=PS, tissue_fraction=0.1, chunk=64)])
    feats = jextract(models[0], tiles, batch_size=16)
    lum = tiles.mean(axis=(1, 2, 3))
    protos = np.stack([feats[np.argmax(lum)], feats[np.argmin(lum)]], axis=1)
    return protos / np.linalg.norm(protos, axis=0, keepdims=True)


def full_sweep(model, slide_path, classifier, ps=PS, resize=False):
    parts = list(iter_wsi_tiles(slide_path, patch_size=ps,
                                tissue_fraction=0.25, chunk=64))
    tiles = np.concatenate([t for t, _ in parts])
    coords = np.concatenate([c for _, c in parts])
    feats = extract_features(model, tiles, batch_size=16, resize=resize)
    return score_tiles(classifier, feats).numpy(), coords


def _both(models, slide_path, classifier, atol=2e-5, **kw):
    jres = jcascade.cascade_detect(models[0], slide_path, classifier,
                                   batch_size=16, **kw)
    res = cascade_detect(models[1], slide_path, classifier, batch_size=16,
                         **kw)
    np.testing.assert_array_equal(res.coords, jres.coords)
    np.testing.assert_array_equal(res.refined, jres.refined)
    for k in ("n_coarse", "n_fine_encoded", "n_fine_total", "coarse_level",
              "downsample"):
        assert getattr(res, k) == getattr(jres, k), k
    np.testing.assert_allclose(res.probs, jres.probs, atol=atol, rtol=atol)
    # a tile this close to the threshold may be called either way by two
    # summation orders: the slide's fraction may move by those tiles only
    near = np.abs(jres.probs[:, 1] - 0.5) <= atol
    assert (abs(res.tumor_prob - jres.tumor_prob)
            <= near.sum() / max(1, len(near)) + 1e-12)
    assert ((res.probs[~near, 1] > 0.5) == (jres.probs[~near, 1] > 0.5)).all()
    return res, jres


@pytest.mark.parametrize("tissue_fraction", [0.1, 0.25, 0.9])
def test_tissue_coords_equal_jax_candidate_grid(slide_path, tissue_fraction):
    """``io.tiles.tissue_coords``, the one coordinate pass that
    ``iter_wsi_tiles`` and the cascade both read, against the JAX
    cascade's ``_candidate_grid`` on the same pyramid."""
    with open_slide(slide_path) as r, jopen_slide(slide_path) as jr:
        got = tissue_coords(r, PS, tissue_fraction)
        want = jcascade._candidate_grid(jr, PS, tissue_fraction)
    assert got.dtype == np.int64 and got.shape[1:] == (2,)
    assert len(got) > 0
    np.testing.assert_array_equal(got, want)


def test_full_refine_limit_equals_plain_sweep(models, slide_path,
                                              classifier):
    """margin >= 0.5 refines every parent: the port's plain sweep's grid,
    probabilities and decision, and the JAX package's cascade."""
    res, _ = _both(models, slide_path, classifier, patch_size=PS,
                   coarse_downsample=4, margin=0.5)
    probs, coords = full_sweep(models[1], slide_path, classifier)
    np.testing.assert_array_equal(res.coords, coords)
    assert res.refined.all()
    assert res.n_fine_encoded == res.n_fine_total == len(coords)
    np.testing.assert_allclose(res.probs, probs, atol=1e-5)
    assert res.tumor_prob == pytest.approx(float((probs[:, 1] > 0.5).mean()),
                                           abs=1e-6)
    assert res.encode_fraction > 1.0


def test_margin_zero_trusts_coarse(models, slide_path, classifier):
    res, _ = _both(models, slide_path, classifier, patch_size=PS,
                   coarse_downsample=4, margin=0.0)
    assert res.n_fine_encoded <= res.n_coarse
    assert res.encode_fraction < 0.2
    parent = res.coords // (res.downsample * PS)
    for p in np.unique(parent, axis=0):
        block = res.probs[(parent == p).all(axis=1) & ~res.refined]
        if len(block):
            assert np.ptp(block[:, 1]) == 0.0


def test_partial_refine_mechanics(models, slide_path, classifier):
    """At a working margin: refined tiles carry the plain sweep's level-0
    probabilities, the others inherit; the JAX package refines the same
    tiles."""
    res, _ = _both(models, slide_path, classifier, patch_size=PS,
                   coarse_downsample=4, margin=0.15)
    probs, coords = full_sweep(models[1], slide_path, classifier)
    np.testing.assert_array_equal(res.coords, coords)
    if res.refined.any():
        np.testing.assert_allclose(res.probs[res.refined],
                                   probs[res.refined], atol=1e-5)
    assert 0.0 <= res.tumor_prob <= 1.0
    assert res.encode_fraction <= 1.0 + res.n_coarse / res.n_fine_total
    agree = (res.probs[:, 1] > 0.5) == (probs[:, 1] > 0.5)
    assert agree[res.refined].all()


def test_error_legs(models, classifier, tmp_path):
    g = np.random.default_rng(0)
    flat = np.clip(200 + g.normal(0, 10, (256, 256, 3)), 0,
                   255).astype(np.uint8)
    p = str(tmp_path / "flat.tif")
    write_pyramid(p, flat, tile=128, compression="none", min_size=256)
    with pytest.raises(ValueError, match="no coarse level"):
        cascade_detect(models[1], p, classifier, patch_size=PS,
                       coarse_downsample=4)
    with pytest.raises(ValueError, match="margin"):
        cascade_detect(models[1], p, classifier, patch_size=PS, margin=-0.1)


def test_resize_parity_with_full_sweep(slide_path):
    """resize=True at patch_size != img_size (the CLI's contract: larger
    tiles resized to the tower's input; here 64-pixel tiles to a 224-pixel
    tower, the size the port's ViT runs at): the exact limit equals the
    port's plain sweep through the same resize, and the JAX cascade."""
    models = _models(224, 32)
    ps2 = 64
    tiles = np.concatenate([t for t, _ in jiter_wsi_tiles(
        slide_path, patch_size=ps2, tissue_fraction=0.1, chunk=64)])
    feats = jextract(models[0], tiles, batch_size=16, resize=True)
    lum = tiles.mean(axis=(1, 2, 3))
    cls = np.stack([feats[np.argmax(lum)], feats[np.argmin(lum)]], axis=1)
    cls /= np.linalg.norm(cls, axis=0, keepdims=True)
    # the two packages' bicubics differ by one 8-bit step on up to 1% of
    # the values (tests/test_torch_preprocess.py::test_matches_jax), which
    # moves these probabilities by up to ~4e-5: held at 1e-4 here
    res, _ = _both(models, slide_path, cls, atol=1e-4, patch_size=ps2,
                   coarse_downsample=4, margin=0.5, resize=True)
    probs, coords = full_sweep(models[1], slide_path, cls, ps=ps2,
                               resize=True)
    np.testing.assert_array_equal(res.coords, coords)
    assert res.refined.all()
    np.testing.assert_allclose(res.probs, probs, atol=1e-5)
