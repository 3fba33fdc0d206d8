"""The port's WordPiece tokenizer against the frozen transformers outputs in
tests/golden/tokenizer.npz and against the JAX package's tokenizer."""

import os

import numpy as np
import pytest

from keep_tpu.text.tokenizer import WordPieceTokenizer as JTokenizer
from keep_tpu.utils.golden import load_bundle, unpack_strings
from keep_tpu_torch.text.tokenizer import WordPieceTokenizer

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "tokenizer.npz")
TEXTS = [
    "an H&E image of breast invasive carcinoma.",
    "Malignant melanoma (skin cancer), grade 3; unknown",
    "  weird   spacing\tand\ncontrol\x00chars� here ",
    "café naïve — em-dash and accents",
    "中文 mixed with english",
    "",
    "a" * 250,
]


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    b = load_bundle(GOLDEN)
    vf = tmp_path_factory.mktemp("tok") / "vocab.txt"
    vf.write_text("\n".join(unpack_strings(b["vocab"])) + "\n")
    return b, str(vf)


def test_tokenize_matches_frozen_hf(golden):
    b, vocab = golden
    tok = WordPieceTokenizer(vocab, lower_case=True)
    texts = unpack_strings(b["texts"])
    expected = [t.split("\x1f") if t else [] for t in
                unpack_strings(b["tokens_joined"])]
    for text, want in zip(texts, expected):
        assert tok.tokenize(text) == want, repr(text)


def test_encode_contract_matches_frozen_hf(golden):
    b, vocab = golden
    enc = WordPieceTokenizer(vocab)(unpack_strings(b["texts"]),
                                    max_length=256)
    assert enc["input_ids"].dtype == np.int32
    np.testing.assert_array_equal(enc["input_ids"], b["enc"]["input_ids"])
    np.testing.assert_array_equal(enc["attention_mask"],
                                  b["enc"]["attention_mask"])


@pytest.mark.parametrize("text", TEXTS, ids=range(len(TEXTS)))
def test_matches_jax_tokenizer(golden, text):
    _, vocab = golden
    ours, theirs = WordPieceTokenizer(vocab), JTokenizer(vocab)
    assert ours.tokenize(text) == theirs.tokenize(text)
    a, b = ours([text], max_length=32), theirs([text], max_length=32)
    for k in ("input_ids", "attention_mask", "token_type_ids"):
        np.testing.assert_array_equal(a[k], b[k])
    ids = ours.encode(text, max_length=32)
    assert ours.decode(ids) == theirs.decode(ids)
