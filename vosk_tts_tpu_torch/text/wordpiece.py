"""A pure-Python BERT WordPiece tokenizer.

Reproduces ``tokenizers.BertWordPieceTokenizer(vocab, unk_token="[UNK]",
lowercase=True)`` (what the JAX package's ``bert.WordPieceTokenizer``
wraps) without the ``tokenizers`` package:

1. special tokens of the vocabulary ([PAD], [UNK], [CLS], [SEP], [MASK])
   written literally in the raw text are matched first and kept whole;
2. normalizer: clean the text (drop NUL, U+FFFD and control characters,
   map whitespace to " "), pad CJK ideographs with spaces, strip accents
   (NFD, then drop the non-spacing marks: "ё" -> "е", "й" -> "и"), lowercase;
3. pre-tokenizer: split on whitespace, then isolate every punctuation
   character (ASCII punctuation or Unicode category P*);
4. greedy longest-match WordPiece with the "##" continuation prefix; a
   word longer than 100 characters, or with a piece not in the vocabulary,
   becomes [UNK];
5. [CLS] ... [SEP] around the sequence, type ids 0, attention mask 1.
"""

from __future__ import annotations

import re
import unicodedata
from dataclasses import dataclass

SPECIAL_TOKENS = ("[UNK]", "[SEP]", "[CLS]", "[PAD]", "[MASK]")
UNK = "[UNK]"
MAX_WORD_CHARS = 100
PREFIX = "##"

# CJK ideograph blocks padded with spaces by the BERT normalizer
_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
        (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))
_ASCII_PUNCT = frozenset('!"#$%&\'()*+,-./:;<=>?@[\\]^_`{|}~')


@dataclass
class Encoding:
    ids: list
    tokens: list
    attention_mask: list
    type_ids: list


def _is_whitespace(c: str) -> bool:
    return c in "\t\n\r" or c.isspace()


def _is_control(c: str) -> bool:
    return c not in "\t\n\r" and unicodedata.category(c).startswith("C")


def _is_cjk(c: str) -> bool:
    o = ord(c)
    return any(lo <= o <= hi for lo, hi in _CJK)


def _is_punct(c: str) -> bool:
    return c in _ASCII_PUNCT or unicodedata.category(c).startswith("P")


def normalize(text: str) -> str:
    out = []
    for c in text:
        if c == "\0" or c == "\ufffd" or _is_control(c):
            continue
        c = " " if _is_whitespace(c) else c
        out.append(f" {c} " if _is_cjk(c) else c)
    text = "".join(c for c in unicodedata.normalize("NFD", "".join(out))
                   if unicodedata.category(c) != "Mn")
    return text.lower()


def pre_tokenize(text: str) -> list:
    words = []
    for chunk in text.split():
        cur = []
        for c in chunk:
            if _is_punct(c):
                if cur:
                    words.append("".join(cur))
                    cur = []
                words.append(c)
            else:
                cur.append(c)
        if cur:
            words.append("".join(cur))
    return words


class WordPieceTokenizer:
    """``encode(text)`` -> :class:`Encoding` (ids, tokens, attention_mask,
    type_ids), as the ``tokenizers`` package's lowercasing BERT WordPiece
    tokenizer with unknown token [UNK]."""

    def __init__(self, vocab_path):
        self.vocab: dict = {}
        with open(vocab_path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab.setdefault(line.rstrip(), i)
        for tok in ("[CLS]", "[SEP]", UNK):
            if tok not in self.vocab:
                raise ValueError(f"{tok} not found in the vocabulary")
        specials = [t for t in SPECIAL_TOKENS if t in self.vocab]
        self._special = re.compile("(" + "|".join(re.escape(t) for t in specials) + ")")

    def _wordpiece(self, word: str) -> list:
        if len(word) > MAX_WORD_CHARS:
            return [UNK]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                sub = word[start:end] if start == 0 else PREFIX + word[start:end]
                if sub in self.vocab:
                    pieces.append(sub)
                    break
                end -= 1
            if end == start:
                return [UNK]
            start = end
        return pieces

    def tokenize(self, text: str) -> list:
        tokens = []
        for part in self._special.split(text):
            if part in self.vocab and part in SPECIAL_TOKENS:
                tokens.append(part)
                continue
            for word in pre_tokenize(normalize(part)):
                tokens += self._wordpiece(word)
        return tokens

    def encode(self, text: str) -> Encoding:
        tokens = ["[CLS]", *self.tokenize(text), "[SEP]"]
        n = len(tokens)
        return Encoding(ids=[self.vocab[t] for t in tokens], tokens=tokens,
                        attention_mask=[1] * n, type_ids=[0] * n)
