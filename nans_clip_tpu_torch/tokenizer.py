"""Chinese BERT WordPiece tokenizer (pure host-side Python).

Counterpart of ``nans_clip_tpu/tokenizer.py``: basic tokenization (unicode
cleanup, CJK character isolation, lower-casing + accent stripping,
punctuation splitting) followed by greedy longest-match WordPiece with the
``##`` continuation prefix, framed as ``[CLS] ids [SEP]`` and zero-padded.
The vocabulary is read in place from ``nans_clip_tpu/assets/vocab.txt``.

Parity anchors: reference ``bert_tokenizer.py:166-396`` and
``cn_clip/clip/utils.py:145-172``.
"""

from __future__ import annotations

import os
import unicodedata
from functools import lru_cache
from typing import Iterable, List, Sequence, Union

import numpy as np

__all__ = ["Tokenizer", "tokenize", "get_tokenizer", "DEFAULT_VOCAB"]

DEFAULT_VOCAB = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "nans_clip_tpu", "assets", "vocab.txt")

# Unicode ranges of the CJK Unified Ideograph blocks; characters inside are
# treated as standalone tokens (reference bert_tokenizer.py:288-321).
_CJK_RANGES = (
    (0x4E00, 0x9FFF),
    (0x3400, 0x4DBF),
    (0x20000, 0x2A6DF),
    (0x2A700, 0x2B73F),
    (0x2B740, 0x2B81F),
    (0x2B820, 0x2CEAF),
    (0xF900, 0xFAFF),
    (0x2F800, 0x2FA1F),
)


def _is_cjk(cp: int) -> bool:
    for lo, hi in _CJK_RANGES:
        if lo <= cp <= hi:
            return True
    return False


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    # ASCII symbol ranges count as punctuation even when unicode disagrees
    # (e.g. "$", "^", "`") — mirrors Google BERT behaviour.
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _clean_and_isolate_cjk(text: str) -> str:
    """Drop control chars, normalize whitespace, and pad CJK chars with spaces."""
    out: List[str] = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_whitespace(ch):
            out.append(" ")
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    return "".join(out)


def _strip_accents(token: str) -> str:
    return "".join(c for c in unicodedata.normalize("NFD", token) if unicodedata.category(c) != "Mn")


def _split_punct(token: str) -> List[str]:
    pieces: List[str] = []
    fresh = True
    for ch in token:
        if _is_punct(ch):
            pieces.append(ch)
            fresh = True
        else:
            if fresh:
                pieces.append(ch)
            else:
                pieces[-1] += ch
            fresh = False
    return pieces


def load_vocab(vocab_file: str) -> dict:
    vocab: dict = {}
    with open(vocab_file, "r", encoding="utf-8") as f:
        for idx, line in enumerate(f):
            # full strip like the reference (bert_tokenizer.load_vocab): a
            # CRLF vocab.txt must not leave '\r' on every token. The google
            # vocab's U+2028 entry (id 343) strips to '' — the reference
            # inserts it anyway (no emptiness guard), keeping every id
            # aligned and the size at 21128; so do we.
            vocab[line.strip()] = idx
    return vocab


class Tokenizer:
    """End-to-end BERT WordPiece tokenizer.

    ``tokenize(text)`` returns sub-token strings; ``encode`` maps straight to
    ids. Matches reference ``FullTokenizer`` output token-for-token.
    """

    def __init__(self, vocab_file: str = DEFAULT_VOCAB, do_lower_case: bool = True,
                 unk_token: str = "[UNK]", max_chars_per_word: int = 200):
        self.vocab = load_vocab(vocab_file)
        self.inv_vocab = {v: k for k, v in self.vocab.items()}
        self.do_lower_case = do_lower_case
        self.unk_token = unk_token
        self.max_chars_per_word = max_chars_per_word

    # -- basic tokenization -------------------------------------------------
    def _basic_tokenize(self, text: str) -> List[str]:
        if isinstance(text, bytes):
            text = text.decode("utf-8", "ignore")
        text = _clean_and_isolate_cjk(text)
        words: List[str] = []
        for token in text.split():
            if self.do_lower_case:
                token = _strip_accents(token.lower())
            words.extend(_split_punct(token))
        return [w for w in " ".join(words).split() if w]

    # -- wordpiece ----------------------------------------------------------
    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        subs: List[str] = []
        start = 0
        n = len(word)
        while start < n:
            end = n
            piece = None
            while start < end:
                cand = word[start:end]
                if start > 0:
                    cand = "##" + cand
                if cand in self.vocab:
                    piece = cand
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            subs.append(piece)
            start = end
        return subs

    # -- public API ---------------------------------------------------------
    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self._basic_tokenize(text):
            out.extend(self._wordpiece(word))
        return out

    def convert_tokens_to_ids(self, tokens: Iterable[str]) -> List[int]:
        return [self.vocab[t] for t in tokens]

    def convert_ids_to_tokens(self, ids: Iterable[int]) -> List[str]:
        return [self.inv_vocab[i] for i in ids]

    def encode(self, text: str) -> List[int]:
        return self.convert_tokens_to_ids(self.tokenize(text))

    def vocab_size(self) -> int:
        return len(self.vocab)

    @property
    def cls_id(self) -> int:
        return self.vocab["[CLS]"]

    @property
    def sep_id(self) -> int:
        return self.vocab["[SEP]"]

    @property
    def pad_id(self) -> int:
        return self.vocab["[PAD]"]


@lru_cache()
def get_tokenizer(vocab_file: str = DEFAULT_VOCAB) -> Tokenizer:
    return Tokenizer(vocab_file)


def tokenize(texts: Union[str, Sequence[str]], context_length: int = 52,
             tokenizer: Tokenizer | None = None) -> np.ndarray:
    """Tokenize into a fixed ``[N, context_length]`` int32 id matrix.

    Framing matches reference ``clip/utils.py:158-172``: ``[CLS]`` + at most
    ``context_length - 2`` wordpiece ids + ``[SEP]``, zero ([PAD]) padded.
    Returns a numpy array; ``torch.from_numpy`` it for the encoders.
    """
    if isinstance(texts, str):
        texts = [texts]
    tok = tokenizer or get_tokenizer()
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        ids = [tok.cls_id] + tok.encode(text)[: context_length - 2] + [tok.sep_id]
        result[i, : len(ids)] = ids
    return result
