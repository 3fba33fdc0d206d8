"""The port's CLIP BPE tokenizer (``keep_tpu_torch.text.bpe``) against the
JAX package's and transformers' ``CLIPTokenizer`` on the same merges
(twins of ``tests/test_models_extra.py``'s BPE tests): the port's token
ids equal ``keep_tpu.text.bpe``'s."""

import numpy as np
import pytest

from keep_tpu.text.bpe import BPETokenizer as JBPE
from keep_tpu_torch.text.bpe import BPETokenizer, bytes_to_unicode
from tests.test_models_extra import make_clip_bpe_fixture

TEXTS = ["hello world", "lower", "Hello, WORLD!", "held low", "",
         "an h&e image of lung adenocarcinoma.", "the 3 worlds' 12 cells",
         "tumour — naïve café &amp; <b>", "a photo of a {}.".format("goldfish")]


def test_bytes_to_unicode_is_the_jax_table():
    from keep_tpu.text.bpe import bytes_to_unicode as j

    assert bytes_to_unicode() == j()


def test_bpe_matches_transformers_and_jax(tmp_path):
    from transformers import CLIPTokenizer

    vocab_path, merges_path = make_clip_bpe_fixture(tmp_path)
    ours = BPETokenizer(merges_path, context_length=16)
    jax_tok = JBPE(merges_path, context_length=16)
    hf = CLIPTokenizer(vocab_path, merges_path)
    for text in TEXTS[:5]:
        assert ours.encode(text) == hf(text, add_special_tokens=False)[
            "input_ids"], text
    for text in TEXTS:
        assert ours.encode(text) == jax_tok.encode(text), text
    batch = ours(TEXTS, context_length=16)
    assert batch.shape == (len(TEXTS), 16) and batch.dtype == np.int32
    np.testing.assert_array_equal(batch, jax_tok(TEXTS, context_length=16))
    assert batch[0, 0] == ours.sot and ours.eot in batch[0]


@pytest.mark.parametrize("ctx", [4, 6, 77])
def test_bpe_truncation_keeps_eot(tmp_path, ctx):
    _, merges_path = make_clip_bpe_fixture(tmp_path)
    tok = BPETokenizer(merges_path, context_length=ctx)
    out = tok("hello world hello world hello world")
    assert out.shape == (1, ctx)
    np.testing.assert_array_equal(
        out, JBPE(merges_path, context_length=ctx)(
            "hello world hello world hello world"))
    if ctx <= 6:
        assert out[0, -1] == tok.eot


def test_bpe_decode_roundtrip(tmp_path):
    _, merges_path = make_clip_bpe_fixture(tmp_path)
    tok = BPETokenizer(merges_path)
    ids = tok.encode("hello world")
    assert tok.decode(ids).strip() == "hello world"
    assert tok.decode(ids) == JBPE(merges_path).decode(ids)


def test_gzip_merges_and_header(tmp_path):
    """A gzip'd merges file with its '#version' header (OpenCLIP's
    bpe_simple_vocab_16e6.txt.gz form) builds the same vocabulary as the
    plain file in both packages."""
    import gzip

    _, merges_path = make_clip_bpe_fixture(tmp_path)
    gz = tmp_path / "merges.txt.gz"
    with open(merges_path, "rb") as f, gzip.open(gz, "wb") as g:
        g.write(f.read())
    a, b = BPETokenizer(str(gz)), BPETokenizer(merges_path)
    assert a.encoder == b.encoder == JBPE(str(gz)).encoder
    np.testing.assert_array_equal(a(TEXTS), b(TEXTS))
