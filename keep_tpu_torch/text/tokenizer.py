"""WordPiece tokenizer: the HF BERT tokenizer contract, dependency-free
(counterpart of ``keep_tpu/text/tokenizer.py``; pure Python and numpy).

1. text cleanup (drop control chars, normalize whitespace),
2. CJK character isolation,
3. per-token lowercasing + NFD accent stripping (when ``lower_case``),
4. punctuation splitting,
5. greedy longest-match WordPiece with ``##`` continuations,
6. [CLS] ... [SEP] framing, truncation, fixed-length padding.

The output is int32 numpy arrays; the server copies them to the device.
The native C++ fast path is ``text.fast_tokenizer.FastWordPieceTokenizer``
(``native/wordpiece.cpp``), which ``factory.get_tokenizer`` takes where its
library builds, with this tokenizer as its reference.
"""

from __future__ import annotations

import unicodedata
from typing import Iterable, Sequence

import numpy as np

_MAX_CHARS_PER_WORD = 100


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        (0x4E00 <= cp <= 0x9FFF)
        or (0x3400 <= cp <= 0x4DBF)
        or (0x20000 <= cp <= 0x2A6DF)
        or (0x2A700 <= cp <= 0x2B73F)
        or (0x2B740 <= cp <= 0x2B81F)
        or (0x2B820 <= cp <= 0x2CEAF)
        or (0xF900 <= cp <= 0xFAFF)
        or (0x2F800 <= cp <= 0x2FA1F)
    )


class WordPieceTokenizer:
    def __init__(
        self,
        vocab: dict[str, int] | str,
        lower_case: bool = True,
        unk_token: str = "[UNK]",
        cls_token: str = "[CLS]",
        sep_token: str = "[SEP]",
        pad_token: str = "[PAD]",
        mask_token: str = "[MASK]",
    ):
        if isinstance(vocab, str):
            vocab = load_vocab(vocab)
        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.lower_case = lower_case
        self.unk_token = unk_token
        self.cls_id = vocab[cls_token]
        self.sep_id = vocab[sep_token]
        self.pad_id = vocab[pad_token]
        self.unk_id = vocab[unk_token]
        self.never_split = {unk_token, cls_token, sep_token, pad_token, mask_token}

    # ---- basic tokenization -------------------------------------------------

    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _space_cjk(self, text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.extend((" ", ch, " "))
            else:
                out.append(ch)
        return "".join(out)

    def _strip_accents(self, text: str) -> str:
        return "".join(
            ch for ch in unicodedata.normalize("NFD", text)
            if unicodedata.category(ch) != "Mn"
        )

    def _split_punct(self, token: str) -> list[str]:
        if token in self.never_split:
            return [token]
        pieces, cur = [], []
        for ch in token:
            if _is_punctuation(ch):
                if cur:
                    pieces.append("".join(cur))
                    cur = []
                pieces.append(ch)
            else:
                cur.append(ch)
        if cur:
            pieces.append("".join(cur))
        return pieces

    def basic_tokenize(self, text: str) -> list[str]:
        text = self._space_cjk(self._clean(text))
        out = []
        for token in text.split():
            if token in self.never_split:
                out.append(token)
                continue
            if self.lower_case:
                token = self._strip_accents(token.lower())
            out.extend(self._split_punct(token))
        return [t for t in out if t]

    # ---- wordpiece ----------------------------------------------------------

    def wordpiece(self, word: str) -> list[str]:
        if len(word) > _MAX_CHARS_PER_WORD:
            return [self.unk_token]
        pieces = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> list[str]:
        out = []
        for token in self.basic_tokenize(text):
            if token in self.never_split:
                out.append(token)
            else:
                out.extend(self.wordpiece(token))
        return out

    # ---- encoding -----------------------------------------------------------

    def encode(self, text: str, max_length: int = 256) -> list[int]:
        ids = [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]
        ids = ids[: max_length - 2]  # truncation=True reserves [CLS]/[SEP]
        return [self.cls_id] + ids + [self.sep_id]

    def __call__(
        self,
        texts: str | Sequence[str],
        max_length: int = 256,
        padding: str = "max_length",
    ) -> dict[str, np.ndarray]:
        """HF-call contract: returns input_ids / attention_mask / token_type_ids
        as [B, max_length] int32 numpy arrays."""
        if isinstance(texts, str):
            texts = [texts]
        encoded = [self.encode(t, max_length) for t in texts]
        if padding == "max_length":
            width = max_length
        else:  # 'longest'; empty input → empty [0, max_length] arrays
            width = max((len(e) for e in encoded), default=max_length)
        ids = np.full((len(encoded), width), self.pad_id, np.int32)
        mask = np.zeros((len(encoded), width), np.int32)
        for i, e in enumerate(encoded):
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        return {
            "input_ids": ids,
            "attention_mask": mask,
            "token_type_ids": np.zeros_like(ids),
        }

    def decode(self, ids: Iterable[int], skip_special: bool = True) -> str:
        toks = []
        special = {self.cls_id, self.sep_id, self.pad_id}
        for i in ids:
            if skip_special and int(i) in special:
                continue
            toks.append(self.inv_vocab.get(int(i), self.unk_token))
        text = " ".join(toks).replace(" ##", "")
        return text

    @classmethod
    def from_pretrained(cls, model_dir: str, lower_case: bool = True):
        import os

        return cls(os.path.join(model_dir, "vocab.txt"), lower_case=lower_case)


def load_vocab(path: str) -> dict[str, int]:
    vocab = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            token = line.rstrip("\n")
            if token:
                vocab[token] = i
    return vocab
