"""ctypes bindings for the native C++ tokenizers (counterpart of
``keep_tpu/text/fast_tokenizer.py``): ``FastWordPieceTokenizer`` over
``native/wordpiece.cpp`` and ``FastBPETokenizer`` over ``native/bpe.cpp``.

The C++ path handles ASCII text (the entirety of the shipped prompt /
caption corpora); a string the C++ scanner would not reproduce bit for bit
routes to the pure-Python tokenizer (``_PY_ONLY``), so outputs are
identical everywhere. The library holds the two tokenizer sources alone
(``io._native.build_tokenizers``: no image library is linked, so it builds
where libtiff / libjpeg / libpng are missing), compiled on first use into
``keep_tpu_torch/io/build/``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Sequence

import numpy as np

from keep_tpu_torch.text.tokenizer import WordPieceTokenizer


def _library() -> ctypes.CDLL:
    from keep_tpu_torch.io._native import build_tokenizers

    return ctypes.CDLL(build_tokenizers())


def _load_lib():
    lib = _library()
    lib.wp_create.restype = ctypes.c_void_p
    lib.wp_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.wp_free.argtypes = [ctypes.c_void_p]
    lib.wp_vocab_size.argtypes = [ctypes.c_void_p]
    lib.wp_vocab_size.restype = ctypes.c_int
    lib.wp_encode_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


class FastWordPieceTokenizer:
    """Drop-in for ``WordPieceTokenizer.__call__`` with the native fast path."""

    # route to Python when the C scanner would diverge: non-ASCII, NUL
    # (C-string truncation), control chars incl. DEL (Python's _clean drops
    # category Cc), and '[' — whitespace-delimited never_split specials
    # like '[MASK]' must stay whole, which the C punctuation splitter
    # doesn't know about
    _PY_ONLY = set("[\x00\x7f") | {
        chr(c) for c in range(0x20) if chr(c) not in "\t\n\r\x0b\x0c"
    }

    @classmethod
    def _fast_ok(cls, text: str) -> bool:
        return text.isascii() and not (cls._PY_ONLY & set(text))

    def __init__(self, vocab_path: str, lower_case: bool = True):
        self.python = WordPieceTokenizer(vocab_path, lower_case=lower_case)
        self.lib = _load_lib()
        self.handle = self.lib.wp_create(vocab_path.encode(), int(lower_case))
        if not self.handle:
            raise RuntimeError(f"native tokenizer failed to load {vocab_path}")

    def __del__(self):
        if getattr(self, "handle", None) and getattr(self, "lib", None):
            self.lib.wp_free(self.handle)
            self.handle = None

    def __call__(
        self, texts: str | Sequence[str], max_length: int = 256,
        padding: str = "max_length",
    ) -> dict[str, np.ndarray]:
        if isinstance(texts, str):
            texts = [texts]
        if max_length < 2:
            raise ValueError(f"max_length must be >= 2 ([CLS]+[SEP]); "
                             f"got {max_length}")
        ok = self._fast_ok
        ascii_idx = [i for i, t in enumerate(texts) if ok(t)]
        other_idx = [i for i in range(len(texts)) if not ok(texts[i])]

        ids = np.zeros((len(texts), max_length), np.int32)
        mask = np.zeros((len(texts), max_length), np.int32)

        if ascii_idx:
            subset = [texts[i] for i in ascii_idx]
            buf_ids = np.zeros((len(subset), max_length), np.int32)
            buf_mask = np.zeros((len(subset), max_length), np.int32)
            arr = (ctypes.c_char_p * len(subset))(
                *[t.encode("ascii") for t in subset]
            )
            self.lib.wp_encode_batch(
                self.handle, arr, len(subset), max_length,
                buf_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                buf_mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
            ids[ascii_idx] = buf_ids
            mask[ascii_idx] = buf_mask

        if other_idx:
            enc = self.python([texts[i] for i in other_idx], max_length=max_length)
            ids[other_idx] = enc["input_ids"]
            mask[other_idx] = enc["attention_mask"]

        return {
            "input_ids": ids,
            "attention_mask": mask,
            "token_type_ids": np.zeros_like(ids),
        }

    # delegate the rest of the API to the Python implementation
    def tokenize(self, text: str):
        return self.python.tokenize(text)

    def encode(self, text: str, max_length: int = 256):
        return self.python.encode(text, max_length)

    def decode(self, ids, skip_special: bool = True):
        return self.python.decode(ids, skip_special)

    @property
    def vocab(self):
        return self.python.vocab


def _load_bpe_lib():
    lib = _library()
    lib.bpe_create.restype = ctypes.c_void_p
    lib.bpe_create.argtypes = [ctypes.c_char_p]
    lib.bpe_free.argtypes = [ctypes.c_void_p]
    lib.bpe_vocab_size.argtypes = [ctypes.c_void_p]
    lib.bpe_vocab_size.restype = ctypes.c_int
    lib.bpe_encode_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


class FastBPETokenizer:
    """Drop-in for ``BPETokenizer.__call__`` with the native C++ fast path.

    Texts the C++ scanner cannot reproduce bit-for-bit route to the Python
    ``BPETokenizer``: non-ASCII bytes (the \\p{L}/\\p{N} regex classes and
    byte-level BPE over multi-byte UTF-8), '&' (``basic_clean``'s
    html.unescape), and '<' (the literal <|startoftext|>/<|endoftext|>
    special-token alternatives). The shipped prompt/caption corpora are
    entirely ASCII, so the fast path covers them wholesale.
    """

    def __init__(self, merges_path: str, context_length: int = 77):
        from keep_tpu_torch.text.bpe import BPETokenizer

        self.python = BPETokenizer(merges_path, context_length=context_length)
        self.context_length = context_length
        self.lib = _load_bpe_lib()

        path = merges_path
        self._tmp = None
        if merges_path.endswith(".gz"):
            import gzip
            import tempfile

            self._tmp = tempfile.NamedTemporaryFile(
                mode="wb", suffix=".txt", delete=False
            )
            with gzip.open(merges_path, "rb") as f:
                self._tmp.write(f.read())
            self._tmp.close()
            path = self._tmp.name
        self.handle = self.lib.bpe_create(path.encode())
        if not self.handle:
            raise RuntimeError(f"native BPE failed to load {merges_path}")

    def __del__(self):
        if getattr(self, "handle", None) and getattr(self, "lib", None):
            self.lib.bpe_free(self.handle)
            self.handle = None
        tmp = getattr(self, "_tmp", None)
        if tmp is not None:
            try:
                os.unlink(tmp.name)
            except OSError:
                pass

    # chars the C scanner treats differently from Python: non-ASCII (regex
    # \p classes + multi-byte BPE), '&' (html.unescape), '<' (literal
    # special tokens), NUL (C string truncation), control chars outside
    # \t\n\r\v\f (Python's \s matches \x1c-\x1f; the C is_space doesn't),
    # and DEL (byte_encoder maps 0x7f to a multi-byte symbol the C's raw
    # bytes miss — it produced id -1 on the fast path)
    _PY_ONLY = set("&<\x00\x7f") | {
        chr(c) for c in range(0x20) if chr(c) not in "\t\n\r\x0b\x0c"
    }

    @classmethod
    def _fast_ok(cls, text: str) -> bool:
        return text.isascii() and not (cls._PY_ONLY & set(text))

    def __call__(
        self, texts: str | Sequence[str], context_length: int | None = None
    ) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        ctx = context_length or self.context_length
        out = np.zeros((len(texts), ctx), np.int32)

        fast_idx = [i for i, t in enumerate(texts) if self._fast_ok(t)]
        other_idx = [i for i in range(len(texts)) if not self._fast_ok(texts[i])]

        if fast_idx:
            subset = [texts[i] for i in fast_idx]
            buf = np.zeros((len(subset), ctx), np.int32)
            arr = (ctypes.c_char_p * len(subset))(
                *[t.encode("ascii") for t in subset]
            )
            self.lib.bpe_encode_batch(
                self.handle, arr, len(subset), ctx,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
            out[fast_idx] = buf
        if other_idx:
            out[other_idx] = self.python(
                [texts[i] for i in other_idx], context_length=ctx
            )
        return out

    # delegate the rest of the API to the Python implementation
    def encode(self, text: str):
        return self.python.encode(text)

    def decode(self, ids):
        return self.python.decode(ids)
