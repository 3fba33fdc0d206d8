"""The port's native tokenizers (``keep_tpu_torch.text.fast_tokenizer``,
built from ``native/wordpiece.cpp`` and ``native/bpe.cpp`` alone) against
the port's pure-Python tokenizers and the JAX package's native ones
(twins of ``tests/test_fast_tokenizer.py``): ids and masks equal, on the
frozen HF bundle ``tests/golden/tokenizer.npz``, on the routed inputs and
on a seeded fuzz."""

import gzip
import pathlib

import numpy as np
import pytest

from keep_tpu.text import fast_tokenizer as jfast
from keep_tpu_torch import factory
from keep_tpu_torch.io import _native
from keep_tpu_torch.text import fast_tokenizer as fast
from keep_tpu_torch.text.bpe import BPETokenizer
from keep_tpu_torch.text.tokenizer import WordPieceTokenizer
from keep_tpu_torch.utils.golden import load_bundle, unpack_strings
from tests.test_fast_tokenizer import BPE_TEXTS, MERGES, TEXTS, VOCAB

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden" / "tokenizer.npz"


def _write(path: pathlib.Path, lines: list) -> str:
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def wordpiece(tmp_path_factory):
    vocab = _write(tmp_path_factory.mktemp("wp") / "vocab.txt", VOCAB)
    return (fast.FastWordPieceTokenizer(vocab), WordPieceTokenizer(vocab),
            jfast.FastWordPieceTokenizer(vocab))


@pytest.fixture(scope="module")
def bpe(tmp_path_factory):
    merges = _write(tmp_path_factory.mktemp("bpe") / "merges.txt",
                    ["#version: 0.2"] + MERGES)
    return (fast.FastBPETokenizer(merges), BPETokenizer(merges),
            jfast.FastBPETokenizer(merges))


def _same_enc(*encs) -> None:
    for e in encs[1:]:
        for k in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(np.asarray(e[k]),
                                          np.asarray(encs[0][k]))


def test_library_holds_the_tokenizers_alone():
    """The tokenizer library is its own build (no image library linked),
    so it builds where libtiff's headers are missing; the full native
    library is not needed."""
    lib = pathlib.Path(_native.build_tokenizers())
    assert lib.parent == _native.BUILD_DIR
    assert lib.name.startswith("libkeep_tokenizers_")
    assert [p.name for p in _native._tokenizer_sources()] == [
        "wordpiece.cpp", "bpe.cpp"]
    assert _native.build_tokenizers() == str(lib)


def test_tokenizer_build_writes_nothing_under_native(tmp_path, monkeypatch):
    before = sorted(p.name for p in _native.NATIVE_DIR.iterdir())
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    lib = pathlib.Path(_native.build_tokenizers())
    assert [p.name for p in lib.parent.iterdir()] == [lib.name]
    assert sorted(p.name for p in _native.NATIVE_DIR.iterdir()) == before


@pytest.mark.parametrize("max_length", [16, 32, 256])
def test_wordpiece_matches_python_and_jax(wordpiece, max_length):
    f, py, jf = wordpiece
    texts = TEXTS + ["an [MASK] image", "an\x00image", "a\x7fb",
                     "breast invasive carcinoma " * 50]
    _same_enc(f(texts, max_length=max_length), py(texts,
                                                   max_length=max_length),
              jf(texts, max_length=max_length))


def test_wordpiece_golden_bundle(tmp_path):
    """The frozen ``transformers.BertTokenizer`` outputs, through the native
    path (the bundle's control-char and unicode cases take the Python
    route)."""
    b = load_bundle(str(GOLDEN))
    vocab = _write(tmp_path / "vocab.txt", unpack_strings(b["vocab"]))
    texts = unpack_strings(b["texts"])
    enc = fast.FastWordPieceTokenizer(vocab)(texts, max_length=256)
    np.testing.assert_array_equal(enc["input_ids"], b["enc"]["input_ids"])
    np.testing.assert_array_equal(enc["attention_mask"],
                                  b["enc"]["attention_mask"])


def test_wordpiece_fuzz(wordpiece):
    f, py, jf = wordpiece
    rng = np.random.default_rng(0)
    words = VOCAB[5:] + ["adenomas", "Carcinoma", "X", "tumour", "!!", "é"]
    texts = [" ".join(rng.choice(words, int(rng.integers(0, 30))))
             for _ in range(200)]
    _same_enc(f(texts, max_length=48), py(texts, max_length=48),
              jf(texts, max_length=48))


def test_wordpiece_guards_and_delegation(wordpiece):
    f, py, _ = wordpiece
    with pytest.raises(ValueError, match="max_length"):
        f(["an image"], max_length=1)
    assert f.tokenize("an adenocarcinoma") == py.tokenize("an adenocarcinoma")
    assert f.vocab == py.vocab
    ids = f.encode("an image", 8)
    assert ids == py.encode("an image", 8)
    assert f.decode(ids) == py.decode(ids)


def test_bpe_matches_python_and_jax(bpe):
    f, py, jf = bpe
    texts = BPE_TEXTS + ["a\x1cb", "a\x00b", "hello\x07world",
                         "hello\x7fworld"]
    got = f(texts)
    np.testing.assert_array_equal(got, py(texts))
    np.testing.assert_array_equal(got, jf(texts))
    assert (got >= 0).all()


def test_bpe_fuzz_and_truncation(bpe):
    f, py, jf = bpe
    rng = np.random.default_rng(1)
    alphabet = list("helowrdancigt HELOWRD 0123456789.,!?'-()[]/:;") + [
        "'s", "'t", "'ll", "'re", " ", "  "]
    texts = ["".join(rng.choice(alphabet) for _ in range(
        int(rng.integers(0, 60)))) for _ in range(300)]
    got = f(texts, context_length=32)
    np.testing.assert_array_equal(got, py(texts, context_length=32))
    np.testing.assert_array_equal(got, jf(texts, context_length=32))
    long = f(["hello world " * 40], context_length=8)
    assert long[0, -1] == py.eot
    np.testing.assert_array_equal(long, py(["hello world " * 40],
                                           context_length=8))


def test_bpe_gz_merges_and_openclip_cap(tmp_path):
    gz = tmp_path / "merges.txt.gz"
    with gzip.open(gz, "wt") as fh:
        fh.write("#version: 0.2\n" + "\n".join(MERGES) + "\n")
    tok = fast.FastBPETokenizer(str(gz), context_length=16)
    np.testing.assert_array_equal(tok(["hello world"]),
                                  tok.python(["hello world"], 16))
    # open_clip slices merges[1:49152-256-2+1]: more lines must not reach
    # the native ranks either
    cap = 49152 - 256 - 2
    lines = ["#version: 0.2"] + [f"a{i} b{i}" for i in range(cap + 50)]
    big = _write(tmp_path / "big.txt", lines)
    tok = fast.FastBPETokenizer(big)
    texts = [f"a{cap + 10}b{cap + 10} a{cap - 1}b{cap - 1}"]
    np.testing.assert_array_equal(tok(texts), tok.python(texts))
    assert len(tok.python.bpe_ranks) == cap


def test_factory_takes_the_native_tokenizers(tmp_path):
    vocab = _write(tmp_path / "vocab.txt", VOCAB)
    assert isinstance(factory.get_tokenizer("bert", vocab),
                      fast.FastWordPieceTokenizer)
    assert isinstance(factory.get_tokenizer("bert", str(tmp_path)),
                      fast.FastWordPieceTokenizer)
    merges = _write(tmp_path / "merges.txt", ["#version: 0.2"] + MERGES)
    assert isinstance(factory.get_tokenizer("clip", merges),
                      fast.FastBPETokenizer)
    # a bad vocabulary or keyword raises; it does not change tokenizers
    with pytest.raises(FileNotFoundError):
        factory.get_tokenizer("bert", str(tmp_path / "missing.txt"))
    with pytest.raises(TypeError):
        factory.get_tokenizer("bert", vocab, no_such_kwarg=1)


def test_factory_falls_back_only_when_the_build_fails(tmp_path, monkeypatch):
    """No compiler → the pure-Python tokenizer, with the same ids."""
    vocab = _write(tmp_path / "vocab.txt", VOCAB)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    tok = factory.get_tokenizer("bert", vocab)
    assert type(tok) is WordPieceTokenizer
    _same_enc(tok(TEXTS, max_length=32),
              WordPieceTokenizer(vocab)(TEXTS, max_length=32))
