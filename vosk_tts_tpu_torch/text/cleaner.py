"""GPT-SoVITS text cleaner: language dispatch + the 351-symbol table.

The port's own copy of ``vosk_tts_tpu/text/cleaner.py`` (the port imports
nothing from the JAX package); behaviour is identical. It re-implements
GPT-SoVITS's text/{cleaner.py, symbols.py, russian.py, english.py}. The
vosk fork dispatches only ``en`` and ``ru`` (cleaner.py:6: zh/ja are
commented out); the symbol TABLE still carries the Chinese/Japanese
entries so ids stay checkpoint-compatible. The table is rebuilt from its
linguistic constants.
"""

from __future__ import annotations

import re

from .en_g2p import EnglishG2P, arpa_symbols
from .en_g2p import text_normalize as en_text_normalize
from .g2p import convert
from .symbols import PHONES

# chinese pinyin components (symbols.py:9-35 c, :36-... v bases x tones 1-5)
_ZH_C = ("AA", "EE", "OO", "b", "c", "ch", "d", "f", "g", "h", "j", "k", "l",
         "m", "n", "p", "q", "r", "s", "sh", "t", "w", "x", "y", "z", "zh")
_ZH_V_BASES = ("E", "En", "a", "ai", "an", "ang", "ao", "e", "ei", "en",
               "eng", "er", "i", "i0", "ia", "ian", "iang", "iao", "ie", "in",
               "ing", "iong", "ir", "iu", "o", "ong", "ou", "u", "ua", "uai",
               "uan", "uang", "ui", "un", "uo", "v", "van", "ve", "vn")
_JA = ("I", "N", "U", "a", "b", "by", "ch", "cl", "d", "dy", "e", "f", "g",
       "gy", "h", "hy", "i", "j", "k", "ky", "m", "my", "n", "ny", "o", "p",
       "py", "r", "ry", "s", "sh", "t", "ts", "u", "v", "w", "y", "z")
_PUNCTUATION = (" ", "!", "?", "…", ",", ".", "-", ":", '"', "(", ")", ";")
_PU_EXTRA = ("SP", "SP2", "SP3", "UNK")
_PAD = "_"


def gpt_sovits_symbols() -> list:
    """symbols.py:149-150: sorted(set([pad] + c + v + ja + pu + arpa + ru))."""
    v = [f"{b}{t}" for b in _ZH_V_BASES for t in range(1, 6)]
    table = ([_PAD] + list(_ZH_C) + v + list(_JA) + list(_PUNCTUATION)
             + list(_PU_EXTRA) + sorted(arpa_symbols()) + list(PHONES))
    return sorted(set(table))


def gpt_sovits_symbol_map() -> dict:
    return {s: i for i, s in enumerate(gpt_sovits_symbols())}


def cleaned_text_to_sequence(phones: list) -> list:
    m = gpt_sovits_symbol_map()
    return [m[p] for p in phones]


def ru_g2p(text: str, dic: dict | None = None) -> list:
    """russian.py:129-141: word walk, dictionary lookup, rule fallback."""
    dic = dic or {}
    pattern = r'([,.?!;:"() ])'
    phones = []
    for word in re.split(pattern, text.lower()):
        if word == "":
            continue
        if re.match(pattern, word) or word == "-":
            phones.append(word)
        elif word in dic:
            phones.extend(dic[word].split())
        else:
            phones.extend(convert(word).split())
    return phones


class Cleaner:
    """clean_text language dispatch (cleaner.py:13-31). Unknown languages
    fall back to english over a single space, as the reference does."""

    def __init__(self, ru_dict: dict | None = None,
                 en_dict_dir: str | None = None, en_extra: dict | None = None):
        self.ru_dict = ru_dict or {}
        self.en = EnglishG2P(en_dict_dir, extra_dict=en_extra)
        self._symbols = set(gpt_sovits_symbols())

    def clean_text(self, text: str, language: str):
        """Returns (phones, word2ph=None, norm_text)."""
        if language not in ("en", "ru"):
            language, text = "en", " "
        if language == "ru":
            norm = text.lower()
            phones = ru_g2p(norm, self.ru_dict)
        else:
            norm = en_text_normalize(text)
            phones = self.en(norm)
        phones = [p if p in self._symbols else "UNK" for p in phones]
        return phones, None, norm

    def to_ids(self, phones: list) -> list:
        return cleaned_text_to_sequence(phones)
