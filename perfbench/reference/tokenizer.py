"""A BERT WordPiece tokenizer over a vocabulary file (Devlin et al. 2019;
the Chinese-CLIP framing of cn_clip/clip/utils.py::tokenize): lowercase,
CJK quotes to ASCII, whitespace and punctuation split, every CJK character
a word of its own, greedy longest-match WordPiece with ``##``
continuations ([UNK] for a word that does not split), then ``[CLS]`` + at
most ``context - 2`` ids + ``[SEP]``, zero-padded.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Sequence

import numpy as np


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


class WordPiece:
    def __init__(self, vocab_file: str):
        with open(vocab_file, encoding="utf-8") as f:
            self.vocab: Dict[str, int] = {line.rstrip("\r\n"): i for i, line in enumerate(f)}

    def _words(self, text: str) -> List[str]:
        text = text.lower().replace("“", '"').replace("”", '"')
        text = unicodedata.normalize("NFD", text)
        text = "".join(c for c in text if unicodedata.category(c) != "Mn")
        out, cur = [], []
        for ch in text:
            cp = ord(ch)
            if ch.isspace() or cp == 0 or cp == 0xFFFD or unicodedata.category(ch) in ("Cc", "Cf"):
                if ch.isspace() and cur:
                    out.append("".join(cur))
                    cur = []
                continue
            if _is_cjk(cp) or _is_punct(ch):
                if cur:
                    out.append("".join(cur))
                    cur = []
                out.append(ch)
            else:
                cur.append(ch)
        if cur:
            out.append("".join(cur))
        return out

    def _pieces(self, word: str) -> List[int]:
        if len(word) > 200:
            return [self.vocab["[UNK]"]]
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                piece = ("##" if start else "") + word[start:end]
                if piece in self.vocab:
                    ids.append(self.vocab[piece])
                    break
                end -= 1
            else:
                return [self.vocab["[UNK]"]]
            start = end
        return ids

    def encode(self, text: str) -> List[int]:
        return [i for word in self._words(text) for i in self._pieces(word)]

    def tokenize(self, texts: Sequence[str], context: int) -> np.ndarray:
        out = np.zeros((len(texts), context), np.int64)
        for r, text in enumerate(texts):
            ids = [self.vocab["[CLS]"]] + self.encode(text)[:context - 2] + [self.vocab["[SEP]"]]
            out[r, :len(ids)] = ids
        return out
