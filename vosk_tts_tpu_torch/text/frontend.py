"""Text -> phoneme-id stream for plain VITS2 bundles.

The port's own copy of ``load_dictionary`` and ``g2p_plain`` from
``vosk_tts_tpu/text/frontend.py``, unchanged in behaviour (the tests hold
the two against each other). The multistream encoders join with the
StableTTS slice.
"""

from __future__ import annotations

import re

from .g2p import convert

_WORD_SPLIT = re.compile(r'([,.?!;:"() ])')


def load_dictionary(path) -> dict:
    """Pronunciation dictionary: keep the max-probability entry per word.
    Lines: word prob phones..."""
    dic, probs = {}, {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            items = line.split(maxsplit=2)
            if len(items) < 3:
                continue
            prob = float(items[1])
            if probs.get(items[0], 0) < prob:
                dic[items[0]] = items[2]
                probs[items[0]] = prob
    return dic


def word_phones(word: str, dic: dict) -> list:
    """Dictionary lookup with rule-based fallback."""
    if word in dic:
        return dic[word].split()
    return convert(word).split()


def _phoneme_walk(text: str, dic: dict):
    """^ ... $, punctuation kept as symbols, words expanded via
    dictionary/G2P. Yields (symbol, word_index) where word_index tracks
    word positions (spaces don't advance it)."""
    phonemes = [("^", 0)]
    word_index = 1
    for word in _WORD_SPLIT.split(text.lower()):
        if word == "":
            continue
        if _WORD_SPLIT.match(word) or word == "-":
            phonemes.append((word, word_index))
        else:
            for p in word_phones(word, dic):
                phonemes.append((p, word_index))
        if word != " ":
            word_index += 1
    phonemes.append(("$", -1))
    return phonemes


def g2p_plain(text: str, dic: dict, id_map: dict, embeddings=None, *, blank: bool = True):
    """Phone ids (+ per-phone embedding rows), optionally interspersed with
    blank id 0."""
    phonemes = _phoneme_walk(text, dic)
    ids = [id_map[p] for p, _ in phonemes]
    embs = [embeddings[w] for _, w in phonemes] if embeddings is not None else None
    if not blank:
        return ids, embs
    out_ids = [ids[0]]
    out_embs = [embs[0]] if embs is not None else None
    for i in range(1, len(ids)):
        out_ids += [0, ids[i]]
        if embs is not None:
            out_embs += [embs[i], embs[i]]
    return out_ids, out_embs
