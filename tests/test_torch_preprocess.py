"""The port's bicubic ``preprocess`` against PIL (the reference transform
runs on PIL images), as tests/test_preprocess.py holds the JAX package's,
and against the JAX ``preprocess`` on the same uint8 images: the resample
weights exactly, the pixels within one 8-bit step before normalisation
(both round half to even between the passes, so a sum that lands within
float noise of a .5 may round the other way), with the share of differing
pixels bounded."""

import importlib

import numpy as np
import pytest
import torch
from PIL import Image

from keep_tpu_torch.configs import PreprocessConfig
from keep_tpu_torch.ops import preprocess as tpre
from keep_tpu_torch.ops.preprocess import (preprocess, resize_weights,
                                           resized_output_size)

CFG = PreprocessConfig()
# keep_tpu.ops re-exports the function under the module's name
jpre = importlib.import_module("keep_tpu.ops.preprocess")
PIL_BOUND = 1.5 / 255.0 / min(CFG.std)  # tests/test_preprocess.py:44-45


def pil_reference(img_u8: np.ndarray, size=224, crop=224) -> np.ndarray:
    """torchvision Resize(224, BICUBIC) + CenterCrop(224) + ToTensor +
    Normalize replicated with PIL and numpy."""
    im = Image.fromarray(img_u8)
    h, w = img_u8.shape[:2]
    oh, ow = resized_output_size(h, w, size)
    im = im.resize((ow, oh), Image.BICUBIC)
    top = int(round((oh - crop) / 2.0))
    left = int(round((ow - crop) / 2.0))
    im = im.crop((left, top, left + crop, top + crop))
    x = np.asarray(im, np.float32) / 255.0
    return (x - np.array(CFG.mean)) / np.array(CFG.std)


def _pixels(x: np.ndarray, cfg=CFG) -> np.ndarray:
    """Normalised values back to the 0..255 scale."""
    return (x * np.array(cfg.std) + np.array(cfg.mean)) * 255.0


@pytest.mark.parametrize(
    "shape",
    [(448, 448), (512, 384), (300, 500), (224, 224), (1000, 250)],
    ids=str,
)
def test_matches_pil(shape, rng):
    img = rng.integers(0, 256, size=(*shape, 3), dtype=np.uint8)
    ref = pil_reference(img)
    got = preprocess(img, CFG)[0].numpy()
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) < PIL_BOUND


def test_upscale_matches_pil(rng):
    img = rng.integers(0, 256, size=(160, 120, 3), dtype=np.uint8)
    ref = pil_reference(img)
    got = preprocess(img, CFG)[0].numpy()
    assert np.max(np.abs(got - ref)) < PIL_BOUND


def test_float_path_close(rng):
    """The pure-float path stays within the 8-bit quantization envelope."""
    img = rng.integers(0, 256, size=(448, 448, 3), dtype=np.uint8)
    q = preprocess(img, CFG, pil_quantize=True)[0].numpy()
    f = preprocess(img, CFG, pil_quantize=False)[0].numpy()
    assert np.max(np.abs(q - f)) < 5.0 / 255.0 / min(CFG.std)


def test_batched(rng):
    imgs = rng.integers(0, 256, size=(4, 448, 448, 3), dtype=np.uint8)
    out = preprocess(torch.from_numpy(imgs), CFG)
    assert out.shape == (4, 224, 224, 3) and out.dtype == torch.float32
    single = preprocess(imgs[0], CFG)[0]
    torch.testing.assert_close(out[0], single, atol=1e-6, rtol=0)


def test_resize_weights_row_stochastic():
    for n_in, n_out in [(448, 224), (224, 224), (100, 224), (999, 224)]:
        w = resize_weights(n_in, n_out)
        np.testing.assert_allclose(w.sum(axis=1), 1.0, atol=1e-5)


def test_identity_resize(rng):
    img = rng.integers(0, 256, size=(224, 224, 3), dtype=np.uint8)
    got = preprocess(img, CFG)[0].numpy()
    ref = (img.astype(np.float32) / 255.0 - np.array(CFG.mean)) / np.array(CFG.std)
    assert np.max(np.abs(got - ref)) < 1e-4


@pytest.mark.parametrize("target", [240, 256, 288, 320, 336, 448])
def test_matches_pil_at_preset_sizes(target, rng):
    img = rng.integers(0, 256, size=(500, 470, 3), dtype=np.uint8)
    cfg = PreprocessConfig(size=target)
    got = preprocess(img, cfg)[0].numpy()
    ref = pil_reference(img, size=target, crop=target)
    assert got.shape == (target, target, 3)
    assert np.abs(got - ref).max() <= 1.5 / 255 / 0.225 + 1e-6


@pytest.mark.parametrize("h,w,size,crop", [
    (256, 256, 224, 224), (448, 448, 224, 224), (300, 500, 224, 224),
    (160, 120, 224, 224), (96, 80, 40, 32), (1000, 250, 224, 224)])
def test_resize_matrices_equal_jax(h, w, size, crop):
    """The weights are the JAX package's, bit for bit (the same numpy)."""
    for a, b in zip(tpre._resize_crop_matrices(h, w, size, crop),
                    jpre._resize_crop_matrices(h, w, size, crop)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tpre.resize_weights(h, 224),
                                  jpre.torch_resize_weights(h, 224))
    np.testing.assert_array_equal(tpre._cubic_filter(np.linspace(-3, 3, 61)),
                                  jpre._cubic_filter(np.linspace(-3, 3, 61)))


@pytest.mark.parametrize("shape,pil_quantize", [
    ((8, 256, 256), True), ((8, 256, 256), False), ((2, 448, 448), True),
    ((3, 300, 500), True), ((2, 160, 120), True)], ids=str)
def test_matches_jax(shape, pil_quantize, rng):
    """The WSI tile resize (256 → 224) and the published transform against
    the JAX ``preprocess``: ≤ 1/255 per pixel before normalisation, and at
    most 1% of the values one 8-bit step apart."""
    imgs = rng.integers(0, 256, size=(*shape, 3), dtype=np.uint8)
    ref = np.asarray(jpre.preprocess(imgs, CFG, pil_quantize=pil_quantize))
    got = preprocess(torch.from_numpy(imgs), CFG,
                     pil_quantize=pil_quantize).numpy()
    assert got.shape == ref.shape
    diff = np.abs(_pixels(got) - _pixels(ref))
    assert diff.max() <= 1.0 + 1e-3, diff.max()
    if pil_quantize:
        assert (diff > 0.5).mean() <= 0.01, (diff > 0.5).mean()
    else:
        assert diff.max() < 1e-3


def test_weight_cache_is_per_device():
    tpre._device_matrices.cache_clear()
    a = tpre._device_matrices(256, 256, 224, 224, torch.device("cpu"))
    b = tpre._device_matrices(256, 256, 224, 224, torch.device("cpu"))
    assert a[0] is b[0] and a[1] is b[1]
    assert a[0].shape == (224, 256) and a[0].dtype == torch.float32
