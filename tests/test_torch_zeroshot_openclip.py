"""The port's OpenCLIP zero-shot classifier builder and ImageNet eval
(``keep_tpu_torch.zeroshot.openclip``) and its ImageNet metadata: twins of
``tests/test_zeroshot_openclip.py``, and the JAX package's results on the
same toy encoder (fp32, 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keep_tpu.zeroshot import imagenet_metadata as jmeta
from keep_tpu.zeroshot import openclip as jopenclip
from keep_tpu_torch.zeroshot import openclip
from keep_tpu_torch.zeroshot.imagenet_metadata import (
    IMAGENET_CLASSNAMES, OPENAI_IMAGENET_TEMPLATES, SIMPLE_IMAGENET_TEMPLATES,
    imagenet_classifier_texts)
from tests.test_zeroshot_openclip import _toy_encode, _ToyTokenizer


def test_builder_matches_reference_math_and_jax(rng):
    """Normalise → template mean → renormalise → transpose, class batches
    concatenated (the reference's zero_shot_classifier.py:52-60), and the
    JAX package's builder on the same encoder."""
    W = rng.standard_normal((97, 16), dtype=np.float32)
    encode, tok = _toy_encode(W), _ToyTokenizer()
    classnames = ["cat", "dog", "lung tumor", "normal tissue", "melanoma"]
    templates = ["a photo of a {}.", "an image of {}.", "{}"]
    got = openclip.build_zero_shot_classifier(encode, tok, classnames,
                                              templates,
                                              num_classes_per_batch=2)
    assert isinstance(got, torch.Tensor) and got.shape == (16, 5)
    embs = []
    for c in classnames:
        texts = [t.format(c) for t in templates]
        e = encode(tok(texts)["input_ids"], tok(texts)["attention_mask"])
        e = e / np.linalg.norm(e, axis=-1, keepdims=True)
        m = e.mean(axis=0)
        embs.append(m / np.linalg.norm(m))
    np.testing.assert_allclose(got.numpy(), np.stack(embs, axis=1),
                               atol=1e-5)
    ref = np.asarray(jopenclip.build_zero_shot_classifier(
        encode, tok, classnames, templates, num_classes_per_batch=2))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=1e-6)


def test_callable_templates(rng):
    W = rng.standard_normal((97, 8), dtype=np.float32)
    fmt = openclip.build_zero_shot_classifier(
        _toy_encode(W), _ToyTokenizer(), ["a b", "c"], ["x {} y", "{}"],
        num_classes_per_batch=4)
    fn = openclip.build_zero_shot_classifier(
        _toy_encode(W), _ToyTokenizer(), ["a b", "c"],
        [lambda c: f"x {c} y", lambda c: c], num_classes_per_batch=4)
    torch.testing.assert_close(fmt, fn, rtol=0, atol=0)
    with pytest.raises(ValueError):
        openclip.build_zero_shot_classifier(_toy_encode(W), _ToyTokenizer(),
                                            [], ["{}"])


def test_imagenet_metadata_consumable():
    assert IMAGENET_CLASSNAMES == jmeta.IMAGENET_CLASSNAMES
    assert OPENAI_IMAGENET_TEMPLATES == jmeta.OPENAI_IMAGENET_TEMPLATES
    assert SIMPLE_IMAGENET_TEMPLATES == jmeta.SIMPLE_IMAGENET_TEMPLATES
    assert len(IMAGENET_CLASSNAMES) == 1000
    assert len(OPENAI_IMAGENET_TEMPLATES) == 80
    assert len(SIMPLE_IMAGENET_TEMPLATES) == 7
    assert "goldfish" in OPENAI_IMAGENET_TEMPLATES[0].format("goldfish")
    assert imagenet_classifier_texts(SIMPLE_IMAGENET_TEMPLATES) == \
        jmeta.imagenet_classifier_texts(jmeta.SIMPLE_IMAGENET_TEMPLATES)


def test_imagenet_classifier_small_slice(rng):
    """A 25-class ImageNet slice with the 80 OpenAI templates through the
    fixed-shape batches: unit columns, the JAX package's weights."""
    W = rng.standard_normal((97, 8), dtype=np.float32)
    cls = openclip.build_zero_shot_classifier(
        _toy_encode(W), _ToyTokenizer(), IMAGENET_CLASSNAMES[:25],
        OPENAI_IMAGENET_TEMPLATES, num_classes_per_batch=10)
    assert cls.shape == (8, 25)
    np.testing.assert_allclose(cls.norm(dim=0).numpy(), 1.0, atol=1e-5)
    ref = np.asarray(jopenclip.build_zero_shot_classifier(
        _toy_encode(W), _ToyTokenizer(), IMAGENET_CLASSNAMES[:25],
        OPENAI_IMAGENET_TEMPLATES, num_classes_per_batch=10))
    np.testing.assert_allclose(cls.numpy(), ref, atol=1e-6, rtol=1e-6)


def test_topk_accuracy_and_eval(rng):
    logits = torch.tensor([[9.0, 1.0, 0.0], [0.0, 1.0, 5.0], [3.0, 2.0, 1.0]])
    target = torch.tensor([0, 1, 2])
    a1, a2 = openclip.accuracy(logits, target, topk=(1, 2))
    assert a1 == pytest.approx(1 / 3) and a2 == pytest.approx(2 / 3)
    cls = torch.eye(4)[:, :3]
    feats = np.eye(4, dtype=np.float32)[:3]
    batches = [(feats[:2], np.asarray([0, 1])), (feats[2:], np.asarray([2]))]
    out = openclip.zero_shot_eval_imagenet(lambda x: x, cls, batches)
    assert out["imagenet-zeroshot-val-top1"] == 1.0
    assert out["imagenet-zeroshot-val-top5"] == 1.0
    # random logits with ties, against the JAX package's stable ranking
    lg = rng.integers(0, 4, (64, 12)).astype(np.float32)
    tg = rng.integers(0, 12, 64)
    assert openclip.accuracy(torch.from_numpy(lg), torch.from_numpy(tg),
                             topk=(1, 5)) == jopenclip.accuracy(
        jnp.asarray(lg), jnp.asarray(tg), topk=(1, 5))
    x = rng.standard_normal((10, 6)).astype(np.float32)
    c = rng.standard_normal((6, 12)).astype(np.float32)
    b = [(x[:7], tg[:7]), (x[7:], tg[7:10])]
    assert openclip.zero_shot_eval_imagenet(
        lambda p: p, torch.from_numpy(c), b) == pytest.approx(
        jopenclip.zero_shot_eval_imagenet(lambda p: p, jnp.asarray(c), b))
