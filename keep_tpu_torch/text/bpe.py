"""CLIP byte-pair-encoding tokenizer (counterpart of
``keep_tpu/text/bpe.py``; pure Python and numpy): OpenCLIP's
``SimpleTokenizer`` / ``tokenize()`` contract (reference
training/path_open_clip/tokenizer.py:159-214), byte-level BPE, lowercased,
with <start_of_text>/<end_of_text> framing at ``context_length`` (77 by
default); a truncated text keeps its EOT last.

The merges file (OpenCLIP's ``bpe_simple_vocab_16e6.txt.gz``, or any plain
merges file) is external data: pass its path.
"""

from __future__ import annotations

import gzip
import html
import re
from functools import lru_cache
from typing import Sequence

import numpy as np


@lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """Reversible byte↔unicode mapping (GPT-2/CLIP byte-level BPE)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def basic_clean(text: str) -> str:
    try:
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        pass
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class BPETokenizer:
    """CLIP SimpleTokenizer: byte-level BPE, lowercased, with the CLIP word
    regex; encodes to fixed context_length with SOT/EOT framing."""

    def __init__(self, merges_path: str, context_length: int = 77):
        try:
            import regex

            self.pat = regex.compile(
                r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
                regex.IGNORECASE,
            )
        except ImportError:  # stdlib approximation
            self.pat = re.compile(
                r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
                re.IGNORECASE,
            )
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        opener = gzip.open if merges_path.endswith(".gz") else open
        with opener(merges_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        # open_clip slices [1:49152-256-2+1] (tokenizer.py:76): the stock
        # bpe_simple_vocab_16e6 file carries ~262K merge lines but only the
        # first 48,894 participate — ingesting them all would grow the
        # vocab past every preset's 49,408 embedding table. Accept plain
        # (shorter, headerless) merges files too.
        if merges and merges[0].startswith("#"):
            merges = merges[1:]
        merges = [tuple(m.split()) for m in merges if m and len(m.split()) == 2]
        merges = merges[: 49152 - 256 - 2]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))

        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.decoder = {i: v for v, i in self.encoder.items()}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self.context_length = context_length
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        bpe_tokens: list[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in self.pat.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(
                self.encoder[t] for t in self.bpe(token).split(" ")
            )
        return bpe_tokens

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(self, texts: str | Sequence[str],
                 context_length: int | None = None) -> np.ndarray:
        """OpenCLIP ``tokenize()`` contract: [B, context_length] int32, SOT +
        tokens + EOT, truncated keeping EOT last (tokenizer.py:159-188)."""
        if isinstance(texts, str):
            texts = [texts]
        ctx = context_length or self.context_length
        out = np.zeros((len(texts), ctx), np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot] + self.encode(text) + [self.eot]
            if len(ids) > ctx:
                ids = ids[:ctx]
                ids[-1] = self.eot
            out[i, : len(ids)] = ids
        return out
