"""A plain WordPiece tokenizer (BERT's uncased scheme), for the reference side
of the serving check: lower-casing, a split on whitespace and punctuation,
greedy longest-match-first pieces with the ``##`` prefix inside a word,
[UNK] for a word that no pieces cover, then [CLS] ... [SEP], truncation to
``max_length`` and padding with [PAD]."""

from __future__ import annotations

import unicodedata


class WordPiece:
    def __init__(self, vocab_path: str, max_chars: int = 100):
        with open(vocab_path, encoding="utf-8") as f:
            self.vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}
        self.max_chars = max_chars

    @staticmethod
    def _words(text: str) -> list[str]:
        out, cur = [], []
        for ch in unicodedata.normalize("NFD", text.lower()):
            if unicodedata.category(ch) == "Mn":
                continue
            if ch.isspace():
                if cur:
                    out.append("".join(cur))
                    cur = []
            elif unicodedata.category(ch).startswith("P"):
                if cur:
                    out.append("".join(cur))
                    cur = []
                out.append(ch)
            else:
                cur.append(ch)
        if cur:
            out.append("".join(cur))
        return out

    def _pieces(self, word: str) -> list[str]:
        if len(word) > self.max_chars:
            return ["[UNK]"]
        out, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                piece = word[start:end] if start == 0 else "##" + word[start:end]
                if piece in self.vocab:
                    out.append(piece)
                    break
                end -= 1
            else:
                return ["[UNK]"]
            start = end
        return out

    def encode(self, text: str, max_length: int) -> tuple[list, list]:
        """(ids, mask), each ``max_length`` long."""
        ids = [self.vocab[p] for w in self._words(text) for p in self._pieces(w)]
        ids = ([self.vocab["[CLS]"]] + ids[: max_length - 2]
               + [self.vocab["[SEP]"]])
        pad = max_length - len(ids)
        return ids + [self.vocab["[PAD]"]] * pad, [1] * len(ids) + [0] * pad
