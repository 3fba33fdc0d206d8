"""The port's pyramidal-TIFF reader / writer (``keep_tpu_torch.io.wsi`` over
the native libtiff module that ``keep_tpu_torch.io._native`` builds) and
what reads pyramids (``io.tiles.iter_wsi_tiles``,
``wsi.extract.extract_wsi_to_h5``, the segmentation mask path), held against
numpy ground truth and against the JAX package's reader on the same files:
twins of ``tests/test_wsi_reader.py``. Files are written by the repo's own
writer and, as an independent producer, by PIL."""

import numpy as np
import pytest
import torch

from keep_tpu.io import wsi as jwsi
from keep_tpu_torch.io.wsi import WSIReader, open_slide, write_pyramid


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(7)


@pytest.fixture(scope="module")
def level0(rng):
    # odd, non-tile-aligned dims on purpose
    return rng.integers(0, 256, (531, 777, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def pyramid_path(tmp_path_factory, level0):
    p = tmp_path_factory.mktemp("wsi") / "pyr.tif"
    write_pyramid(str(p), level0, tile=64, compression="deflate", min_size=64)
    return str(p)


def _box2(img):
    """The writer's 2x2 box filter (edge-clamped odd dims, round-half-up)."""
    h, w = img.shape[:2]
    ph, pw = (h + 1) // 2 * 2, (w + 1) // 2 * 2
    pad = np.pad(img, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
    s = pad.astype(np.uint32).reshape(ph // 2, 2, pw // 2, 2, 3).sum((1, 3))
    return ((s + 2) // 4).astype(np.uint8)


def _same_as_jax(path, backend, reads):
    """Each (location, level, size) read equal between the port's reader and
    the JAX package's on ``path``, and the level geometry too."""
    with WSIReader(path, backend=backend) as s, \
            jwsi.WSIReader(path, backend=backend) as j:
        assert s.backend == j.backend == backend
        assert s.level_dimensions == j.level_dimensions
        assert s.level_downsamples == j.level_downsamples
        for loc, level, size in reads:
            np.testing.assert_array_equal(s.read_region(loc, level, size),
                                          j.read_region(loc, level, size))


def test_levels_and_dims(pyramid_path, level0, tmp_path):
    with WSIReader(pyramid_path) as s:
        assert s.backend == "native"
        assert s.dimensions == (777, 531)
        assert s.level_dimensions[0] == (777, 531)
        assert s.level_dimensions[1] == (389, 266)
        for i in range(1, s.level_count):
            assert s.level_downsamples[i] == pytest.approx(2.0**i, rel=0.05)
        assert s.level_dimensions[-1][0] <= 64 or s.level_dimensions[-1][1] <= 64
    # the JAX package's writer gives the same file, byte for byte
    other = tmp_path / "j.tif"
    jwsi.write_pyramid(str(other), level0, tile=64, compression="deflate",
                       min_size=64)
    assert other.read_bytes() == open(pyramid_path, "rb").read()


def test_full_level_reads_are_exact(pyramid_path, level0):
    with WSIReader(pyramid_path) as s:
        got = s.read_region((0, 0), 0, s.level_dimensions[0])
        np.testing.assert_array_equal(got, level0)
        got1 = s.read_region((0, 0), 1, s.level_dimensions[1])
        np.testing.assert_array_equal(got1, _box2(level0))
        dims = s.level_dimensions
    _same_as_jax(pyramid_path, "native",
                 [((0, 0), i, dims[i]) for i in range(len(dims))])


def test_window_reads_match_numpy(pyramid_path, level0):
    windows = [(0, 0, 64, 64), (63, 1, 65, 130), (700, 500, 77, 31),
               (128, 256, 256, 256)]
    with WSIReader(pyramid_path) as s:
        for (x, y, w, h) in windows:
            got = s.read_region((x, y), 0, (w, h))
            np.testing.assert_array_equal(got, level0[y:y + h, x:x + w])
    _same_as_jax(pyramid_path, "native",
                 [((x, y), 0, (w, h)) for x, y, w, h in windows])


def test_out_of_bounds_zero_fill(pyramid_path, level0):
    with WSIReader(pyramid_path) as s:
        got = s.read_region((750, 520), 0, (64, 64))
        ref = np.zeros((64, 64, 3), np.uint8)
        ref[:11, :27] = level0[520:, 750:]
        np.testing.assert_array_equal(got, ref)
        got = s.read_region((-10, -5), 0, (32, 32))
        ref = np.zeros((32, 32, 3), np.uint8)
        ref[5:, 10:] = level0[:27, :22]
        np.testing.assert_array_equal(got, ref)
        assert not s.read_region((10_000, 10_000), 0, (16, 16)).any()


def test_level0_coordinate_semantics(pyramid_path, level0):
    """read_region's location is in level-0 coords at any level (the
    OpenSlide contract)."""
    with WSIReader(pyramid_path) as s:
        got = s.read_region((100, 60), 1, (50, 40))
        np.testing.assert_array_equal(got, _box2(level0)[30:70, 50:100])
    _same_as_jax(pyramid_path, "native", [((100, 60), 1, (50, 40)),
                                          ((101, 61), 2, (33, 17))])


def test_best_level_and_thumbnail(pyramid_path):
    with WSIReader(pyramid_path) as s, jwsi.WSIReader(pyramid_path) as j:
        assert s.best_level_for_downsample(1) == 0
        assert s.best_level_for_downsample(2) == 1
        assert s.best_level_for_downsample(16) == min(4, s.level_count - 1)
        for d in (1, 3, 5.5, 16, 100):
            assert (s.best_level_for_downsample(d)
                    == j.best_level_for_downsample(d))
        th = s.get_thumbnail((100, 100))
        assert th.shape[0] <= 100 and th.shape[1] <= 100
        assert th.ndim == 3 and th.shape[2] == 3
        np.testing.assert_array_equal(th, j.get_thumbnail((100, 100)))


def test_jpeg_pyramid_close_to_source(tmp_path):
    yy, xx = np.mgrid[0:240, 0:320]
    img = np.stack([yy % 256, xx % 256, (yy + xx) % 256], -1).astype(np.uint8)
    p = tmp_path / "jp.tif"
    write_pyramid(str(p), img, tile=64, compression="jpeg", quality=95,
                  min_size=64)
    with WSIReader(str(p)) as s:
        got = s.read_region((0, 0), 0, (320, 240))
        assert np.mean(np.abs(got.astype(int) - img.astype(int))) < 3.0
    _same_as_jax(str(p), "native", [((0, 0), 0, (320, 240)),
                                    ((0, 0), 1, (160, 120))])


def test_pil_written_stripped_tiff_native_and_fallback(tmp_path, rng):
    """A PIL-written (stripped, single-level) TIFF reads identically
    through the native strip path and the PIL fallback."""
    from PIL import Image

    img = rng.integers(0, 256, (123, 217, 3), dtype=np.uint8)
    p = tmp_path / "strip.tif"
    Image.fromarray(img).save(p)
    for backend in ("native", "pil"):
        with WSIReader(str(p), backend=backend) as s:
            assert s.backend == backend and s.level_count == 1
            np.testing.assert_array_equal(
                s.read_region((0, 0), 0, (217, 123)), img)
            np.testing.assert_array_equal(
                s.read_region((30, 17), 0, (64, 100)), img[17:117, 30:94])
        _same_as_jax(str(p), backend, [((30, 17), 0, (64, 100))])


def test_pil_multipage_pyramid_both_backends(tmp_path, rng):
    """A pyramid PIL writes as a multi-page stripped TIFF (levels 1, 4 and
    16 times down, as ``chip_smoke.py`` writes its slide) reads the same
    through both backends, with the levels' own pixels."""
    from PIL import Image

    base = rng.integers(0, 256, (512, 640, 3), dtype=np.uint8)
    levels = [Image.fromarray(base)]
    levels += [levels[0].resize((640 // d, 512 // d)) for d in (4, 16)]
    p = tmp_path / "pil_pyramid.tif"
    levels[0].save(p, save_all=True, append_images=levels[1:])
    reads = [((0, 0), 0, (640, 512)), ((64, 32), 1, (100, 60)),
             ((0, 0), 2, (40, 32))]
    out = {}
    for backend in ("native", "pil"):
        with WSIReader(str(p), backend=backend) as s:
            assert s.level_dimensions == [(640, 512), (160, 128), (40, 32)]
            out[backend] = [s.read_region(*r) for r in reads]
        _same_as_jax(str(p), backend, reads)
    for a, b, lvl in zip(out["native"], out["pil"], (0, 1, 2)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(out["pil"][0], base)
    np.testing.assert_array_equal(out["pil"][2], np.asarray(levels[2]))


def test_pil_backend_on_pyramid_matches_native(pyramid_path, level0):
    with WSIReader(pyramid_path, backend="pil") as s:
        assert s.level_count >= 4
        np.testing.assert_array_equal(
            s.read_region((0, 0), 0, (777, 531)), level0)
        np.testing.assert_array_equal(
            s.read_region((100, 60), 1, (50, 40)), _box2(level0)[30:70, 50:100])
    _same_as_jax(pyramid_path, "pil", [((100, 60), 1, (50, 40))])


def test_open_slide_helper_and_errors(pyramid_path, tmp_path):
    s = open_slide(pyramid_path)
    assert s.level_count >= 4 and s.backend == "native"
    s.close()
    with pytest.raises(OSError):
        WSIReader(str(tmp_path / "nope.tif"), backend="native")
    with pytest.raises(ValueError):
        WSIReader(pyramid_path, backend="martian")
    bad = tmp_path / "not_a_tiff.tif"
    bad.write_bytes(b"hello world, definitely not TIFF")
    with pytest.raises(Exception):
        open_slide(str(bad))


def test_open_slide_falls_back_to_pil_without_the_native_library(
        pyramid_path, level0, monkeypatch):
    """Where the native library cannot be built (no libtiff headers), the
    route is the JAX package's: native fails, OpenSlide is absent, PIL
    reads the file; the build's error is kept and raised by a native
    open."""
    import sys

    from keep_tpu_torch.io import wsi

    monkeypatch.setattr(wsi, "_lib", None)
    monkeypatch.setattr(wsi, "_lib_failed", True)
    monkeypatch.setattr(wsi, "_lib_error", "tiffio.h: No such file")
    monkeypatch.setitem(sys.modules, "openslide", None)
    with open_slide(pyramid_path) as s:
        assert s.backend == "pil"
        np.testing.assert_array_equal(
            s.read_region((0, 0), 0, (777, 531)), level0)
    with pytest.raises(OSError, match="native libtiff cannot open") as e:
        WSIReader(pyramid_path, backend="native")
    assert "tiffio.h" in str(e.value.__cause__)


def test_svs_stripped_thumbnail_page_not_a_level(tmp_path, level0):
    """Aperio layout: [tiled full-res, STRIPPED thumbnail, tiled reduced
    levels]. The stripped page is not a level, on either backend."""
    from PIL import Image

    from keep_tpu_torch.io.wsi import append_stripped_page

    p = tmp_path / "aperio_like.tif"
    write_pyramid(str(p), level0, tile=64, min_size=64)
    with WSIReader(str(p)) as s:
        dims_before = list(s.level_dimensions)
    thumb = _box2(_box2(level0))
    append_stripped_page(str(p), thumb)
    for backend in ("native", "pil"):
        with WSIReader(str(p), backend=backend) as s:
            assert s.level_dimensions == dims_before, backend
        _same_as_jax(str(p), backend, [((0, 0), 1, (64, 64))])
    flat = tmp_path / "flat.tif"
    Image.fromarray(thumb).save(flat)
    with WSIReader(str(flat)) as s:
        assert s.level_count == 1


class _ToyModel(torch.nn.Module):
    """``extract_features``' model surface: ``cfg.projection_dim``, a
    parameter that says the device, ``encode_image``."""

    class cfg:
        projection_dim = 3

    def __init__(self):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(1))

    def encode_image(self, pixels):
        return pixels.mean(dim=(1, 2))  # [B, 3] "features"


def test_empty_slide_keeps_feature_width():
    """A no-tissue slide gives (0, projection_dim) features, not (0, 0)."""
    from keep_tpu_torch.wsi.extract import extract_features

    model = _ToyModel()
    model.cfg = type("cfg", (), {"projection_dim": 7})
    assert extract_features(model, iter(()), batch_size=4).shape == (0, 7)


def test_write_pyramid_validates(tmp_path):
    with pytest.raises(ValueError):
        write_pyramid(str(tmp_path / "x.tif"), np.zeros((4, 4), np.uint8))
    with pytest.raises(OSError):
        write_pyramid(str(tmp_path / "x.tif"),
                      np.zeros((4, 4, 3), np.uint8), tile=50)  # not %16


def _tissue_image(rng, h=600, w=800):
    """White background + a saturated tissue blob covering known tiles."""
    img = np.full((h, w, 3), 250, np.uint8)
    region = img[100:400, 200:600]
    region[:] = [180, 60, 120]
    region += rng.integers(0, 20, region.shape, dtype=np.uint8)
    return img


def _stream(module, path, **kw):
    chunks = list(module.iter_wsi_tiles(str(path), **kw))
    return (np.concatenate([t for t, _ in chunks]),
            np.concatenate([c for _, c in chunks]), len(chunks))


def test_iter_wsi_tiles_matches_cut_tiles(tmp_path, rng):
    """Streamed tiles equal the source windows, cover every fully interior
    tissue tile, and equal the JAX package's stream chunk for chunk."""
    from keep_tpu.io import tiles as jtiles
    from keep_tpu_torch.io import tiles

    img = _tissue_image(rng)
    p = tmp_path / "tissue.tif"
    write_pyramid(str(p), img, tile=64, min_size=128)
    kw = dict(patch_size=64, tissue_fraction=0.5, chunk=32)
    got, coords, n = _stream(tiles, p, **kw)
    for t, (x, y) in zip(got, coords):
        np.testing.assert_array_equal(t, img[y:y + 64, x:x + 64])
    _, ref_coords = tiles.cut_tiles(img, patch_size=64, tissue_fraction=0.99)
    have = {tuple(c) for c in coords.tolist()}
    assert all(tuple(c) in have for c in ref_coords.tolist())
    jt, jc, jn = _stream(jtiles, p, **kw)
    assert n == jn
    np.testing.assert_array_equal(coords, jc)
    np.testing.assert_array_equal(got, jt)


def test_iter_wsi_tiles_level1(tmp_path, rng):
    from keep_tpu.io import tiles as jtiles
    from keep_tpu_torch.io import tiles

    img = _tissue_image(rng)
    p = tmp_path / "tissue1.tif"
    write_pyramid(str(p), img, tile=64, min_size=128)
    kw = dict(patch_size=64, tissue_fraction=0.5, chunk=1000, level=1)
    got, coords, n = _stream(tiles, p, **kw)
    assert n == 1
    lvl1 = _box2(img)
    for t, (x, y) in zip(got, coords):
        np.testing.assert_array_equal(t, lvl1[y:y + 64, x:x + 64])
    jt, jc, _ = _stream(jtiles, p, **kw)
    np.testing.assert_array_equal(coords, jc)
    np.testing.assert_array_equal(got, jt)


def test_read_regions_batched_threaded(pyramid_path, rng):
    """read_regions == N read_region calls on every thread count and level,
    on both backends, and == the JAX package's."""
    locs = np.stack([rng.integers(-16, 760, 12),
                     rng.integers(-16, 520, 12)], axis=1).astype(np.int64)
    with WSIReader(pyramid_path) as s, jwsi.WSIReader(pyramid_path) as j:
        ref = np.stack([s.read_region(loc, 0, (96, 80)) for loc in locs])
        for threads in (1, 4, 16):
            got = s.read_regions(locs, 0, (96, 80), threads=threads)
            np.testing.assert_array_equal(got, ref)
        ref1 = np.stack([s.read_region(loc, 1, (40, 40)) for loc in locs])
        np.testing.assert_array_equal(s.read_regions(locs, 1, (40, 40)), ref1)
        np.testing.assert_array_equal(j.read_regions(locs, 1, (40, 40)), ref1)
        assert s.read_regions(np.zeros((0, 2)), 0, (8, 8)).shape == (0, 8, 8, 3)
    with WSIReader(pyramid_path, backend="pil") as s:
        np.testing.assert_array_equal(s.read_regions(locs, 0, (96, 80)), ref)


def test_segmentation_mask_path_native_fallback(tmp_path):
    """``zero_shot_segment(mask_path=...)`` without OpenSlide: the reader's
    ground truth equals the JAX package's and the in-memory mask's."""
    from keep_tpu.wsi import pipelines as jpipe
    from keep_tpu_torch.wsi.pipelines import _mask_path_gt, _tiffwsi_gt

    mask = np.zeros((1024, 1024), np.uint8)
    mask[0:512, 0:768] = 255
    p = tmp_path / "mask.tif"
    write_pyramid(str(p), np.repeat(mask[..., None], 3, axis=2), tile=64,
                  min_size=32)
    coords = np.array([[0, 0], [512, 0], [768, 0], [0, 512], [512, 512]],
                      np.int64)
    gt, lowres, mag = _mask_path_gt(str(p), coords, 256)
    np.testing.assert_array_equal(gt, [1, 1, 0, 0, 0])
    assert mag == 16 and lowres.shape == (64, 64)
    assert (lowres > 0).mean() == pytest.approx(0.375, abs=0.01)
    gt2, lowres2, mag2 = _tiffwsi_gt(str(p), coords, 256)
    np.testing.assert_array_equal(gt, gt2)
    np.testing.assert_array_equal(lowres, lowres2)
    jgt, jlow, jmag = jpipe._tiffwsi_gt(str(p), coords, 256)
    np.testing.assert_array_equal(gt, jgt)
    np.testing.assert_array_equal(lowres, jlow)
    assert mag == mag2 == jmag


def test_mask_path_grey_is_pils(tmp_path, rng):
    """The reader route's grey conversion is PIL's ``convert("L")`` bit for
    bit, so edge pixels binarise as on the OpenSlide route."""
    from PIL import Image

    from keep_tpu_torch.wsi.pipelines import _to_gray

    rgb = rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        _to_gray(rgb), np.asarray(Image.fromarray(rgb).convert("L")))


def test_extract_wsi_to_h5_streams(tmp_path, rng):
    """Pyramid → streamed tiles → features h5: the features equal the
    in-memory extraction of the same tiles, the coords the stream's and
    the JAX package's."""
    import h5py

    from keep_tpu.io import tiles as jtiles
    from keep_tpu_torch.io.tiles import iter_wsi_tiles
    from keep_tpu_torch.wsi.extract import extract_features, extract_wsi_to_h5

    img = _tissue_image(rng, h=320, w=320)
    p = tmp_path / "slide.tif"
    write_pyramid(str(p), img, tile=64, min_size=64)
    out = tmp_path / "feat.h5"
    n = extract_wsi_to_h5(_ToyModel(), str(p), str(out), patch_size=64,
                          tissue_fraction=0.5, batch_size=8)
    with h5py.File(out) as f:
        feats, coords = f["features"][:], f["coords"][:]
    assert n == len(coords) == len(feats) and n > 0
    chunks = list(iter_wsi_tiles(str(p), patch_size=64, tissue_fraction=0.5,
                                 chunk=8))
    tiles = np.concatenate([t for t, _ in chunks])
    ref = extract_features(_ToyModel(), tiles, batch_size=8)
    np.testing.assert_allclose(feats, ref, rtol=1e-6)
    np.testing.assert_array_equal(coords,
                                  np.concatenate([c for _, c in chunks]))
    _, jc, _ = _stream(jtiles, p, patch_size=64, tissue_fraction=0.5, chunk=8)
    np.testing.assert_array_equal(coords, jc)


def test_thumbnail_level_pick_respects_request_size(tmp_path, rng):
    """On a 4x-spaced pyramid the thumbnail comes from the smallest level
    still >= the request, as the JAX package's does."""
    from PIL import Image

    base = rng.integers(0, 256, (300, 400, 3), dtype=np.uint8)
    p = tmp_path / "sparse.tif"
    im0 = Image.fromarray(base)
    im0.save(str(p), save_all=True, append_images=[im0.resize((100, 75))])
    with WSIReader(str(p)) as s, jwsi.WSIReader(str(p)) as j:
        assert s.level_count == 2
        th = s.get_thumbnail((200, 150))
        assert th.shape[:2] == (150, 200), th.shape
        want = np.asarray(Image.fromarray(base).resize(
            (200, 150), Image.Resampling.BICUBIC))
        assert np.mean(np.abs(th.astype(int) - want.astype(int))) < 30
        np.testing.assert_array_equal(th, j.get_thumbnail((200, 150)))
        assert s.get_thumbnail((10000, 10000)).shape[:2] == (300, 400)


def test_closed_reader_raises_clearly(pyramid_path):
    s = WSIReader(pyramid_path)
    s.read_region((0, 0), 0, (4, 4))
    s.close()
    assert s.backend == "native"
    with pytest.raises(ValueError, match="closed"):
        s.read_region((0, 0), 0, (4, 4))


def test_reader_and_writer_error_branches(tmp_path):
    from keep_tpu_torch.io.wsi import append_stripped_page

    junk = tmp_path / "junk.tif"
    junk.write_bytes(b"this is not a tiff at all")
    with pytest.raises(OSError, match="native libtiff cannot open"):
        WSIReader(str(junk), backend="native")
    gray = np.zeros((32, 32), np.uint8)
    with pytest.raises(ValueError, match=r"\[H, W, 3\]"):
        append_stripped_page(str(tmp_path / "x.tif"), gray)
    with pytest.raises(ValueError):
        write_pyramid(str(tmp_path / "y.tif"), gray, tile=16)
    with pytest.raises(OSError):
        append_stripped_page(str(tmp_path / "no_dir" / "z.tif"),
                             np.zeros((32, 32, 3), np.uint8))
