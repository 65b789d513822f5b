"""Text -> phoneme-id streams (plain VITS2 ids, multistream 5-tuples).

The port's own copy of ``load_dictionary``, ``g2p_plain``,
``add_word_positions`` and ``g2p_multistream`` from
``vosk_tts_tpu/text/frontend.py``, unchanged in behaviour (the tests hold
the two against each other).

The multistream encoding produces one 5-tuple per phone:
  (phone_id, current_punctuation, inside_quotes, most_recent_punctuation,
   most_recent_sentence_punctuation)
with word-position suffixes (_B/_I/_E/_S) on phones, plus per-phone BERT
vectors and optional extra pause durations (``_`` -> 20 frames).
"""

from __future__ import annotations

import re

from .g2p import convert

_WORD_SPLIT = re.compile(r'([,.?!;:"() ])')
_MS_SPLIT = re.compile(r'(\.\.\.|- |[ ,.?!;:"()])')
_MS_SPLIT_PAUSES = re.compile(r'(\.\.\.|- |[ ,.?!;:"()_])')


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


def add_word_positions(phones: list) -> list:
    """Kaldi-style suffixes: single -> _S, first -> _B, last -> _E, else _I."""
    if len(phones) == 1:
        return [phones[0] + "_S"]
    return [p + ("_B" if i == 0 else "_E" if i == len(phones) - 1 else "_I") for i, p in enumerate(phones)]


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


def g2p_multistream(
    text: str,
    dic: dict,
    id_map: dict,
    bert_embeddings=None,
    *,
    word_pos: bool = True,
    pause_markers: bool = False,
    aligned: bool = False,
):
    """Returns (stream_tuples, per-phone bert rows or None, extra durations
    or None). ``pause_markers`` enables the '_' pause symbol handling of
    multistream_v3. ``aligned`` switches the word expansion to pre-aligned
    underscore-joined phones (same walk, words already phonemized).
    """
    splitter = _MS_SPLIT_PAUSES if pause_markers else _MS_SPLIT
    text = text.replace("\n", " ")
    text = text.replace(" -", "- ")  # unify dash with other punctuation

    phonemes = [("^", [], 0, 0)]  # (symbol, punctuation list, in_quote, bert word)
    in_quote = 0
    cur_punc: list = []
    bert_word = 1

    for word in splitter.split(text.lower()):
        if word == "":
            continue
        if word == '"':
            in_quote = 0 if in_quote else 1
            continue
        if word in ("- ", "-"):
            cur_punc.append("-")
            continue
        if splitter.match(word) and word != " ":
            cur_punc.append(word)
            continue
        if word == " ":
            phonemes.append((" ", cur_punc, in_quote, bert_word))
            cur_punc = []
            continue
        phones = word.split("_") if aligned else word_phones(word, dic)
        if word_pos:
            phones = add_word_positions(phones)
        for p in phones:
            phonemes.append((p, [], in_quote, bert_word))
        cur_punc = []
        bert_word += 1

    phonemes.append((" ", cur_punc, in_quote, bert_word))
    phonemes.append(("$", [], 0, bert_word))

    # right-to-left pass filling the "last punctuation" context streams
    last_punc = " "
    last_sentence_punc = " "
    tuples, embs, extras = [], [], []
    for sym, punc, quote, widx in reversed(phonemes):
        for marker in ("...", ".", "!", "?", "-"):
            if marker in punc:
                last_sentence_punc = marker
                break
        extras.append(20.0 if (pause_markers and "_" in punc) else 0.0)
        if punc:
            last_punc = punc[0]
        cur = punc[0] if punc else "_"
        tuples.append((id_map[sym], id_map[cur], quote, id_map[last_punc], id_map[last_sentence_punc]))
        if bert_embeddings is not None:
            embs.append(bert_embeddings[widx])
    tuples.reverse()
    embs.reverse()
    extras.reverse()
    return (
        tuples,
        embs if bert_embeddings is not None else None,
        extras if pause_markers else None,
    )
