"""English G2P for the GPT-SoVITS cloner frontend.

The port's own copy of ``vosk_tts_tpu/text/en_g2p.py`` (the port imports
nothing from the JAX package); behaviour is identical. It re-implements
GPT-SoVITS's text/english.py: CMU pronouncing dictionary lookup
(cmudict.rep main table from line 57, cmudict-fast.rep supplement,
engdict-hot.rep overrides) with the reference's OOV fallbacks:

  * words of <= 3 letters are spelled letter by letter (english.py:228-230);
  * possessive ``<word>'s`` -> phones of the word + Z (english.py:232-236);
  * lone "a" reads EY1 not AH0 (english.py:221);
  * longer OOV words resolve through a fallback ladder standing in for the
    reference's g2p_en neural net + wordsegment: inflected dictionary bases
    (poseurs = poseur + Z), greedy compound segmentation, dictionary
    tail-graft, then the trained neural letter-to-sound model
    (text/neural_g2p.py, artifact text/g2p_en_lstm.npz; off with
    ``VOSK_TTS_NEURAL_G2P=0``) with a rule engine behind it. Dictionary
    words (the overwhelming majority at inference) are exact.

The dictionary files are DATA shipped with a model bundle (like the Russian
``dictionary``); pass their directory explicitly.
"""

from __future__ import annotations

import os
import re

ARPA_VOWELS = ("AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY",
               "IH", "IY", "OW", "OY", "UH", "UW")
ARPA_CONSONANTS = ("B", "CH", "D", "DH", "F", "G", "HH", "JH", "K", "L", "M",
                   "N", "NG", "P", "R", "S", "SH", "T", "TH", "V", "W", "Y",
                   "Z", "ZH")


def arpa_symbols() -> set:
    """The 71-symbol ARPA set of english.py:17-88 (stressed vowels + the two
    bare variants the reference keeps + consonants)."""
    out = {v + s for v in ARPA_VOWELS for s in ("0", "1", "2")}
    out.update({"ER", "IH"})
    out.update(ARPA_CONSONANTS)
    return out


def read_cmu_dict(dict_dir: str) -> dict:
    """english.py read_dict_new(): cmudict.rep main table (from line 57,
    double-space separated), cmudict-fast.rep fill-ins, engdict-hot.rep
    overrides."""
    g2p_dict: dict = {}
    main = os.path.join(dict_dir, "cmudict.rep")
    if os.path.exists(main):
        with open(main, encoding="utf-8", errors="ignore") as f:
            for line_index, line in enumerate(f, start=1):
                if line_index < 57:
                    continue
                parts = line.strip().split("  ")
                if len(parts) >= 2:
                    g2p_dict[parts[0].lower()] = parts[1].split(" ")
    fast = os.path.join(dict_dir, "cmudict-fast.rep")
    if os.path.exists(fast):
        with open(fast, encoding="utf-8", errors="ignore") as f:
            for line in f:
                items = line.strip().split(" ")
                if len(items) >= 2 and items[0].lower() not in g2p_dict:
                    g2p_dict[items[0].lower()] = items[1:]
    hot = os.path.join(dict_dir, "engdict-hot.rep")
    if os.path.exists(hot):
        with open(hot, encoding="utf-8", errors="ignore") as f:
            for line in f:
                items = line.strip().split(" ")
                if len(items) >= 2:
                    g2p_dict[items[0].lower()] = items[1:]
    return g2p_dict


def text_normalize(text: str) -> str:
    """english.py:193-206 punctuation unification."""
    rep_map = {
        "[;:：，；]": ",",
        '["’]': "'",
        "。": ".",
        "！": "!",
        "？": "?",
    }
    for p, r in rep_map.items():
        text = re.sub(p, r, text)
    return text


# ---------------------------------------------------------------------------
# Rule-based letter-to-sound for long OOV words — the stand-in for the
# reference's g2p_en neural model (english.py:256), behind the trained
# neural model of text/neural_g2p.py. Three layers, in the spirit of the
# classic NRL/Elovitz text-to-sound rules:
#   1. productive suffix morphology (-tion, -ing, -ed with voicing, ...);
#   2. longest-match context rules (soft c/g, magic-e, r-controlled vowels,
#      vowel digraphs, silent kn-/wr-/-mb, doubled consonants);
#   3. stress: exactly one primary stress on the first vowel, 0 elsewhere —
#      matching g2p_en's output alphabet (stressed ARPA).
# Dictionary words (the overwhelming majority at inference) are exact; this
# path only shapes coined/rare words.
# ---------------------------------------------------------------------------

_VOWELS_SET = set("aeiouy")
_VOICELESS = {"P", "T", "K", "F", "TH", "S", "SH", "CH", "HH"}
_SIBILANTS = {"S", "Z", "SH", "ZH", "CH", "JH"}
_ARPA_VOWEL_BASES = set(ARPA_VOWELS)

# short and long (magic-e / open) readings of single vowel letters
_SHORT = {"a": "AE", "e": "EH", "i": "IH", "o": "AA", "u": "AH", "y": "IH"}
_LONG = {"a": "EY", "e": "IY", "i": "AY", "o": "OW", "u": "UW", "y": "AY"}

# longest-match grapheme rules; "V" entries are vowel bases (stress added
# later). Order within a length class matters only where patterns overlap.
_CLUSTERS = [
    ("tsch", ["CH"]),  # German -tsch (petsch, kutsch — CMU reads CH)
    ("eaux", ["OW"]), ("eau", ["OW"]),  # French (jarreau, thibodeaux)
    ("eigh", ["EY"]), ("augh", ["AO"]), ("ough", ["AO"]),
    ("tch", ["CH"]), ("dge", ["JH"]), ("igh", ["AY"]),
    ("ch", ["CH"]), ("sh", ["SH"]), ("th", ["TH"]), ("ph", ["F"]),
    ("ck", ["K"]), ("ng", ["NG"]), ("qu", ["K", "W"]), ("wh", ["W"]),
    ("ee", ["IY"]), ("ea", ["IY"]), ("ai", ["EY"]), ("ay", ["EY"]),
    ("oa", ["OW"]), ("oo", ["UW"]), ("ou", ["AW"]), ("oi", ["OY"]),
    ("oy", ["OY"]), ("au", ["AO"]), ("aw", ["AO"]), ("ew", ["UW"]),
    ("ue", ["UW"]), ("ui", ["UW"]), ("ei", ["AY"]), ("ey", ["EY"]),
    ("ie", ["IY"]), ("eu", ["UW"]), ("ior", ["IY", "ER"]),
    ("ar", ["AA", "R"]), ("or", ["AO", "R"]), ("er", ["ER"]),
    ("ir", ["ER"]), ("ur", ["ER"]),
]

_CONS = {
    "b": ["B"], "d": ["D"], "f": ["F"], "h": ["HH"], "j": ["JH"],
    "k": ["K"], "l": ["L"], "m": ["M"], "n": ["N"], "p": ["P"],
    "q": ["K"], "r": ["R"], "t": ["T"], "v": ["V"], "w": ["W"],
    "z": ["Z"],
}

# (suffix, phones, min stem length) — first match wins (order: longer /
# more specific first). Inflectional -s/-ed strip first in letter_to_sound,
# then ONE derivational layer from this table (so "restorations" resolves
# as restor+ation+s, the round-3 engine's biggest error class).
_SUFFIXES = [
    ("ization", ["IH0", "Z", "EY1", "SH", "AH0", "N"], 3),
    ("ational", ["EY1", "SH", "AH0", "N", "AH0", "L"], 3),
    ("ability", ["AH0", "B", "IH1", "L", "IH0", "T", "IY0"], 3),
    ("ography", ["AA1", "G", "R", "AH0", "F", "IY0"], 2),
    ("ically", ["IH0", "K", "L", "IY0"], 3),
    ("ology", ["AA1", "L", "AH0", "JH", "IY0"], 2),
    ("owski", ["AO1", "F", "S", "K", "IY0"], 2),  # CMU's Slavic-name reading
    ("ella", ["EH1", "L", "AH0"], 2),   # Romance-name endings, CMU readings
    ("etti", ["EH1", "T", "IY0"], 2),
    ("ini", ["IY1", "N", "IY0"], 2),
    ("ino", ["IY1", "N", "OW0"], 2),
    ("ano", ["AA1", "N", "OW0"], 2),
    ("ian", ["IY0", "AH0", "N"], 3),
    ("ation", ["EY1", "SH", "AH0", "N"], 2),
    ("asion", ["EY1", "ZH", "AH0", "N"], 2),
    ("ision", ["IH1", "ZH", "AH0", "N"], 2),
    ("osion", ["OW1", "ZH", "AH0", "N"], 2),
    ("usion", ["UW1", "ZH", "AH0", "N"], 2),
    ("ative", ["AH0", "T", "IH0", "V"], 3),
    ("cious", ["SH", "AH0", "S"], 3),
    ("tious", ["SH", "AH0", "S"], 3),
    ("ator", ["EY2", "T", "ER0"], 2),
    ("cial", ["SH", "AH0", "L"], 3),
    ("tial", ["SH", "AH0", "L"], 3),
    ("cian", ["SH", "AH0", "N"], 3),
    ("ally", ["AH0", "L", "IY0"], 3),
    ("tion", ["SH", "AH0", "N"], 2),
    ("sion", ["SH", "AH0", "N"], 2),
    ("ture", ["CH", "ER0"], 2),
    ("ment", ["M", "AH0", "N", "T"], 3),
    ("ness", ["N", "AH0", "S"], 3),
    ("less", ["L", "AH0", "S"], 3),
    ("able", ["AH0", "B", "AH0", "L"], 3),
    ("ible", ["IH0", "B", "AH0", "L"], 3),
    ("eer", ["IH1", "R"], 3),
    ("ese", ["IY1", "Z"], 3),
    ("ful", ["F", "AH0", "L"], 3),
    ("ify", ["IH0", "F", "AY2"], 2),
    ("ing", ["IH0", "NG"], 3),
    ("ish", ["IH0", "SH"], 3),
    ("ism", ["IH0", "Z", "AH0", "M"], 3),
    ("ist", ["IH0", "S", "T"], 3),
    ("ity", ["IH0", "T", "IY0"], 3),
    ("ize", ["AY2", "Z"], 3),
    ("ous", ["AH0", "S"], 3),
    ("age", ["IH0", "JH"], 3),
    ("est", ["AH0", "S", "T"], 3),
    ("ers", ["ER0", "Z"], 3),
    ("ly", ["L", "IY0"], 3),
    ("er", ["ER0"], 3),
    ("le", ["AH0", "L"], 3),  # -ble/-dle/-gle...
]


def _is_vowel(ch: str) -> bool:
    return ch in _VOWELS_SET


# productive prefixes with their (usually unstressed) CMU readings; phones
# carry explicit stress digits — the stem's first vowel keeps the primary.
# Longest match wins; the remainder must keep >= 3 letters incl. a vowel.
_PREFIXES = [
    ("mc", ["M", "AH0", "K"]),
    ("counter", ["K", "AW2", "N", "T", "ER0"]),
    ("under", ["AH2", "N", "D", "ER0"]),
    ("inter", ["IH2", "N", "T", "ER0"]),
    ("super", ["S", "UW2", "P", "ER0"]),
    ("micro", ["M", "AY2", "K", "R", "OW0"]),
    ("multi", ["M", "AH2", "L", "T", "IY0"]),
    ("trans", ["T", "R", "AE2", "N", "S"]),
    ("anti", ["AE2", "N", "T", "IY0"]),
    ("auto", ["AO2", "T", "OW0"]),
    ("over", ["OW2", "V", "ER0"]),
    ("semi", ["S", "EH2", "M", "IY0"]),
    ("fore", ["F", "AO2", "R"]),
    ("out", ["AW2", "T"]),
    ("dis", ["D", "IH0", "S"]),
    ("mis", ["M", "IH0", "S"]),
    ("non", ["N", "AA2", "N"]),
    ("pre", ["P", "R", "IY0"]),
    ("pro", ["P", "R", "AH0"]),
    ("sub", ["S", "AH0", "B"]),
    ("com", ["K", "AH0", "M"]),
    ("con", ["K", "AH0", "N"]),
    ("mid", ["M", "IH2", "D"]),
    ("re", ["R", "IY0"]),
    ("de", ["D", "IH0"]),
    ("be", ["B", "IH0"]),
    ("un", ["AH0", "N"]),
    ("em", ["IH0", "M"]),
    ("en", ["IH0", "N"]),
]


def _strip_prefix(stem: str):
    """(prefix_phones, rest) or (None, stem). The prefix only strips when
    the rest still looks like a word (>= 3 letters with a vowel) and does
    not start with the same letter the prefix ended with doubled weirdness
    handled by the scan."""
    for pre, phs in _PREFIXES:
        if stem.startswith(pre) and len(stem) - len(pre) >= 3:
            rest = stem[len(pre):]
            if any(_is_vowel(c) for c in rest):
                return list(phs), rest
    return None, stem


#: consonants after which long "u" keeps its glide in AmE (music, cute,
#: few, huge) — alveolars drop it (tune, duke, news) and l/r never take it
_Y_ONSETS = {"M", "P", "B", "F", "V", "K", "G", "HH"}


def _long_u(out: list) -> list:
    prev = out[-1] if out else None
    return ["Y", "UW"] if prev is None or prev in _Y_ONSETS else ["UW"]


def _core_scan(word: str, *, word_final: bool = True) -> list:
    """Grapheme scan -> ARPA bases (vowels WITHOUT stress digits).
    word_final=False for suffix-stripped stems (end-of-word silent-letter
    rules like -mb must not fire mid-word: shi[mb]le keeps its B)."""
    out, i, n = [], 0, len(word)
    emitted_vowel = False
    while i < n:
        ch = word[i]
        # word-initial silent clusters
        if i == 0:
            for pat, phs in (("kn", ["N"]), ("wr", ["R"]), ("ps", ["S"]),
                             ("gn", ["N"]), ("pn", ["N"]), ("mn", ["N"])):
                if word.startswith(pat):
                    out.extend(phs)
                    i = 2
                    break
            else:
                if word.startswith("exh") and n > 3:  # exhaust: silent h
                    out.extend(["IH", "G", "Z"])
                    i = 3
                elif (word.startswith("ex") and n > 2
                        and _is_vowel(word[2])):  # exam: voiced G Z
                    out.extend(["IH", "G", "Z"])
                    i = 2
                elif ch == "x":  # xylo- reads Z word-initially
                    out.append("Z")
                    i = 1
                elif ch == "y":  # consonantal y
                    out.append("Y")
                    i = 1
            if i > 0:
                continue
        # doubled consonants collapse
        if not _is_vowel(ch) and i + 1 < n and word[i + 1] == ch:
            i += 1
            continue
        # silent -mb at word end
        if word_final and word.startswith("mb", i) and i + 2 == n:
            out.append("M")
            break
        # "sch" reads SH: CMU is names-heavy and German/Slavic names dominate
        # its sch- words (schnelle, schaab, schook); the S-K words (school,
        # scheme, schedule...) are dictionary-served (round-5 error analysis:
        # -sch was a worst class at S K)
        if word.startswith("sch", i):
            out.append("SH")
            i += 3
            continue
        # Greek/technical "ch" before a consonant reads K (chrome, techn-)
        if word.startswith("ch", i) and i + 2 < n and not _is_vowel(word[i + 2]):
            out.append("K")
            i += 2
            continue
        # silent "gh" after a vowel at word end (haigh, pugh)
        if (word_final and word.startswith("gh", i) and i + 2 == n
                and emitted_vowel):
            break
        # final "-oux" reads UW (French names: richoux, thureaux-style)
        if word_final and word.startswith("oux", i) and i + 3 == n:
            out.append("UW")
            break
        # final "-oh" reads OW (itoh, yohe-type names); and a silent "h"
        # between a vowel and "r"/word-end (duhr, fahr)
        if word.startswith("oh", i) and i + 2 >= n:
            out.append("OW")
            i += 2
            continue
        if (ch == "h" and emitted_vowel
                and (i + 1 == n or word[i + 1] == "r")):
            i += 1
            continue
        # velar assimilation: n before k
        if ch == "n" and i + 1 < n and word[i + 1] == "k":
            out.append("NG")
            i += 1
            continue
        # word-final -sm is syllabic: Z AH M (chasm, spasm)
        if word.startswith("sm", i) and i + 2 == n and emitted_vowel:
            out.extend(["Z", "AH", "M"])
            break
        # unstressed word-final -or reads ER (doctor, erector)
        if (word.startswith("or", i) and i + 2 == n and emitted_vowel):
            out.append("ER")
            break
        # longest-match clusters (with a couple of positional exceptions)
        hit = None
        for pat, phs in _CLUSTERS:
            if word.startswith(pat, i):
                if pat == "ow" and i + 2 < n:
                    continue  # mid-word "ow" falls through to o + w
                hit = (pat, phs)
                break
        if word.startswith("ow", i) and i + 2 >= n:
            hit = ("ow", ["OW"])
        if hit is not None:
            pat, phs = hit
            out.extend(phs)
            emitted_vowel = emitted_vowel or any(p in _ARPA_VOWEL_BASES for p in phs)
            i += len(pat)
            continue
        if ch == "c":
            out.append("S" if i + 1 < n and word[i + 1] in "eiy" else "K")
            i += 1
            continue
        if ch == "g":
            out.append("JH" if i + 1 < n and word[i + 1] in "eiy" else "G")
            i += 1
            continue
        if ch == "x":
            out.extend(["K", "S"])
            i += 1
            continue
        if ch == "s":
            # intervocalic s voices only before a WEAK vowel (closet, visit,
            # result-style); CMU keeps S in most name-like a/o contexts
            intervocalic = (0 < i < n - 1 and _is_vowel(word[i - 1])
                            and word[i + 1] in "ei")
            out.append("Z" if intervocalic else "S")
            i += 1
            continue
        if not _is_vowel(ch):
            out.extend(_CONS.get(ch, []))
            i += 1
            continue
        # ---- single vowel letter ----
        last = i == n - 1
        if last:
            # open word-final vowels; final -i reads IY (maserati, the CMU
            # loan/name reading, not AY). A stem-final vowel before a
            # stripped suffix is an open syllable and reads long (na+ture,
            # trubi+ous); repair-added magic-e stays silent either way.
            if word_final:
                final = {"a": "AH", "e": None, "i": "IY", "o": "OW",
                         "u": "UW", "y": "IY"}[ch]
            else:
                final = {"a": "EY", "e": None, "i": "IY", "o": "OW",
                         "u": None, "y": "IY"}[ch]
                if ch == "u":
                    out.extend(_long_u(out))
                    emitted_vowel = True
            if ch == "e" and not emitted_vowel:
                final = "IY"  # no other vowel: "the"-like, read it
            if final:
                out.append(final)
                emitted_vowel = True
            i += 1
            continue
        # magic-e: V + single consonant + final e
        if (i + 2 < n and i + 2 == n - 1 and word[i + 2] == "e"
                and not _is_vowel(word[i + 1]) and word[i + 1] != "r"):
            out.extend(_long_u(out) if ch == "u" else [_LONG[ch]])
            emitted_vowel = True
            i += 1
            continue
        # open syllable heuristic: vowel directly followed by another
        # syllable's vowel ("ia", "io" hiatus) — glide the first
        if _is_vowel(word[i + 1]) and word[i + 1] != ch:
            out.extend(["IY"] if ch == "i" else  # -ious/-ia/-io hiatus
                       _long_u(out) if ch == "u" else
                       [_LONG[ch]] if ch in "ao" else [_SHORT[ch]])
            emitted_vowel = True
            i += 1
            continue
        # open-syllable long o/u: single consonant then a vowel (bonus,
        # music); a/e/i lean short in that position so they stay short.
        # 'o' only in the first (stressed) syllable — later open o's are
        # usually reduced (molina, productively), 'u' keeps quality anywhere
        if (ch in "ou" and i + 2 < n and not _is_vowel(word[i + 1])
                and word[i + 1] != "r" and _is_vowel(word[i + 2])
                and (ch == "u" or not emitted_vowel)):
            out.extend(_long_u(out) if ch == "u" else [_LONG[ch]])
            emitted_vowel = True
            i += 1
            continue
        out.append(_SHORT[ch])
        emitted_vowel = True
        i += 1
    return out


def _assign_stress(bases: list, *, has_primary: bool = False) -> list:
    """First undigited vowel gets 1 (or 2 when a suffix already owns the
    primary), the rest get 0 — g2p_en's stressed-ARPA output alphabet.
    Unstressed a/o reduce to schwa (the round-3 engine's single biggest
    error class: 500+ AE/AA -> AH substitutions per 3k words vs CMUdict);
    AA before R keeps its quality (unstressed 'ar')."""
    out, first = [], True
    for p in bases:
        if p in _ARPA_VOWEL_BASES:
            if first:
                out.append(p + ("2" if has_primary else "1"))
                first = False
            else:
                out.append(p + "0")
        else:
            out.append(p)
    for idx, p in enumerate(out):
        if p in ("AE0", "EH0"):
            out[idx] = "AH0"
        elif p == "AA0" and (idx + 1 >= len(out) or out[idx + 1] != "R"):
            out[idx] = "AH0"
    return out


def _strip_suffix(word: str):
    """(stem, suffix_phones) or (word, None); applies the consonant-doubling
    convention: 'mapping' -> map (short), 'maping' -> map+e (long)."""
    for suf, phs, min_stem in _SUFFIXES:
        if word.endswith(suf) and len(word) - len(suf) >= min_stem:
            stem = word[: -len(suf)]
            if suf == "le" and (_is_vowel(stem[-1]) or stem[-1] == "l"):
                # vowel+le is magic-e (trousdale), not -ble/-dle; l+le is
                # -lle = plain L + silent e (schnelle) — the core scan's
                # doubled-consonant collapse reads it right
                continue
            if suf[0] in "aeiouy" and len(stem) >= 2:
                if stem[-1] == stem[-2] and not _is_vowel(stem[-1]):
                    stem = stem[:-1]  # doubled consonant: short vowel stays
                elif (not _is_vowel(stem[-1]) and _is_vowel(stem[-2])
                      and (len(stem) < 3 or not _is_vowel(stem[-3]))):
                    stem = stem + "e"  # restore the magic-e the suffix ate
            return stem, list(phs), "table"
    # -ed / -es / -s with voicing assimilation (sentinel phones resolved in
    # _voice_assimilate). The 'e' of -es belongs to the suffix only after
    # sibilant letters (boxes, wishes); otherwise it's the stem's magic-e
    # (makes = make+s). -ied/-ies: the y reads with the suffix (studied =
    # stud + IY D).
    if word.endswith("ied") and len(word) >= 5:
        return word[:-3], ["IY0", "D"], "infl"
    if word.endswith("ies") and len(word) >= 5:
        return word[:-3], ["IY0", "Z"], "infl"
    if word.endswith("ed") and len(word) >= 5 and not _is_vowel(word[-3]):
        stem = word[:-2]
        if stem[-1] == stem[-2] and not _is_vowel(stem[-1]):
            stem = stem[:-1]
        elif _is_vowel(stem[-2]) and (len(stem) < 3 or not _is_vowel(stem[-3])):
            stem = stem + "e"
        return stem, ["D"], "infl"
    if (word.endswith("es") and len(word) >= 5
            and (word[-3] in "sxz" or word.endswith(("ches", "shes")))):
        return word[:-2], ["Z"], "infl"
    if word.endswith("s") and len(word) >= 4 and word[-2] not in "su":
        return word[:-1], ["Z"], "infl"
    return word, None, None


def letter_to_sound(word: str) -> list:
    """Rule-based LTS for OOV words: up to two suffix layers (inflectional
    over derivational: restor+ation+s), context rules, single primary
    stress. Output phones are stressed ARPA (g2p_en alphabet)."""
    word = "".join(ch for ch in word.lower() if ch.isalpha())
    if not word:
        return []
    chain: list = []
    stem = word
    for _ in range(2):
        s2, suffix, kind = _strip_suffix(stem)
        if suffix is None:
            break
        chain.insert(0, suffix)
        stem = s2
        if kind == "table":
            break  # only inflections stack OUTSIDE a derivational suffix
    prefix_phones, stem = _strip_prefix(stem)
    bases = _core_scan(stem, word_final=not chain)
    has_primary = any(p[-1] == "1" for suf in chain
                      for p in suf if p[-1].isdigit())
    phones = _assign_stress(bases, has_primary=has_primary)
    if prefix_phones is not None:
        phones = prefix_phones + phones
    for suf in chain:
        phones = phones + _voice_assimilate(phones, suf)
    # guarantee exactly one primary stress (stem may be vowel-less)
    if not any(p.endswith("1") for p in phones):
        for want in ("2", "0"):
            for idx, p in enumerate(phones):
                if p.endswith(want):
                    phones[idx] = p[:-1] + "1"
                    break
            else:
                continue
            break
    return phones


def _voice_assimilate(stem_phones: list, suffix: list) -> list:
    """-ed and -s/-es agree in voicing with the stem's final phone."""
    last = stem_phones[-1] if stem_phones else ""
    base = last.rstrip("012")
    if suffix == ["D"]:  # set by callers for 'ed' (see _SUFFIXES note)
        if base in ("T", "D"):
            return ["IH0", "D"]
        return ["T"] if base in _VOICELESS else ["D"]
    if suffix == ["Z"]:
        if base in _SIBILANTS:
            return ["IH0", "Z"]
        return ["S"] if base in _VOICELESS else ["Z"]
    return suffix


class EnglishG2P:
    """Dictionary-first English G2P (the en_G2p class, english.py:209-245)."""

    def __init__(self, dict_dir: str | None = None, extra_dict: dict | None = None):
        self.cmu = read_cmu_dict(dict_dir) if dict_dir else {}
        if extra_dict:
            self.cmu.update({k.lower(): list(v) for k, v in extra_dict.items()})
        # reference removes a few wrong-reading abbreviations (english.py:218)
        for word in ("ae", "ai", "ar", "ios", "hud", "os"):
            self.cmu.pop(word, None)
        # lone "a" reads EY1 (english.py:221)
        self.cmu["a"] = ["EY1"]
        self._arpa = arpa_symbols()

    #: spelled letter names (used when a bundle ships no cmudict letters;
    #: also breaks the spell-out recursion for single characters)
    LETTER_NAMES = {
        "a": ["EY1"], "b": ["B", "IY1"], "c": ["S", "IY1"], "d": ["D", "IY1"],
        "e": ["IY1"], "f": ["EH1", "F"], "g": ["JH", "IY1"],
        "h": ["EY1", "CH"], "i": ["AY1"], "j": ["JH", "EY1"],
        "k": ["K", "EY1"], "l": ["EH1", "L"], "m": ["EH1", "M"],
        "n": ["EH1", "N"], "o": ["OW1"], "p": ["P", "IY1"],
        "q": ["K", "Y", "UW1"], "r": ["AA1", "R"], "s": ["EH1", "S"],
        "t": ["T", "IY1"], "u": ["Y", "UW1"], "v": ["V", "IY1"],
        "w": ["D", "AH1", "B", "AH0", "L", "Y", "UW0"],
        "x": ["EH1", "K", "S"], "y": ["W", "AY1"], "z": ["Z", "IY1"],
    }

    # ------------------------------------------------------------------
    def word_phones(self, word: str) -> list:
        word = word.lower()
        if word in self.cmu:
            return list(self.cmu[word])
        if len(word) == 1:  # letter names terminate the spell-out recursion
            return list(self.LETTER_NAMES.get(word, []))
        return self.predict(word)

    def predict(self, word: str) -> list:
        # short OOV: spell letter by letter (english.py:228-230)
        if len(word) <= 3:
            return [ph for w in word for ph in self.word_phones(w)]
        # possessive (english.py:232-236)
        m = re.match(r"^([a-z]+)('s)$", word)
        if m:
            return self.word_phones(m.group(1)) + ["Z"]
        inf = self._inflected(word)
        if inf is not None:
            return inf
        seg = self._segment(word)
        if seg is not None:
            return seg
        graft = self._tail_graft(word)
        if graft is not None:
            return graft
        return self._letter_to_sound(word)

    def _inflected(self, word: str) -> list | None:
        """OOV inflections over a dictionary base (poseurs = poseur + Z,
        deviating = deviate + IH0 NG, planned = plan + D): exact base phones
        plus the regular ending with -s/-ed voicing assimilation. This is
        where the reference's wordsegment+g2p_en pipeline gets most of its
        real-text wins (english.py:256); measured on held-out CMU words it
        alone removes ~2.5 points of PER."""
        cands = []
        if word.endswith("ies") and len(word) > 4:
            cands.append((word[:-3] + "y", ["Z"]))
        if word.endswith("ied") and len(word) > 4:
            cands.append((word[:-3] + "y", ["D"]))
        if word.endswith("es"):
            cands += [(word[:-2], ["Z"]), (word[:-1], ["Z"])]
        elif word.endswith("s") and not word.endswith("ss"):
            cands.append((word[:-1], ["Z"]))
        if word.endswith("ed"):
            cands += [(word[:-2], ["D"]), (word[:-1], ["D"])]
            if len(word) > 4 and word[-3] == word[-4]:
                cands.append((word[:-3], ["D"]))  # planned -> plan
        if word.endswith("ing") and len(word) > 5:
            cands += [(word[:-3], ["IH0", "NG"]), (word[:-3] + "e", ["IH0", "NG"])]
            if len(word) > 6 and word[-4] == word[-5]:
                cands.append((word[:-4], ["IH0", "NG"]))  # running -> run
        if word.endswith("ly") and len(word) > 4:
            cands.append((word[:-2], ["L", "IY0"]))
        if word.endswith("ier") and len(word) > 5:
            cands.append((word[:-3] + "y", ["ER0"]))
        if word.endswith("iest") and len(word) > 6:
            cands.append((word[:-4] + "y", ["AH0", "S", "T"]))
        for base, suf in cands:
            if base in self.cmu:
                phones = list(self.cmu[base])
                if suf in (["Z"], ["D"]):
                    return phones + _voice_assimilate(phones, suf)
                return phones + suf
        return None

    def _tail_graft(self, word: str) -> list | None:
        """Longest dictionary TAIL (>= 5 letters) + rule-LTS head, for
        name-like OOVs (weisenbach = weisen~ + bach). The tail's primary
        stress demotes to secondary."""
        n = len(word)
        if n < 8:
            return None
        for blen in range(n - 3, 4, -1):
            b, a = word[n - blen:], word[: n - blen]
            if b in self.cmu and any(_is_vowel(c) for c in a):
                head = self._letter_to_sound(a)
                tail = [p[:-1] + "2" if p.endswith("1") else p
                        for p in self.cmu[b]]
                return head + tail
        return None

    def _segment(self, word: str) -> list | None:
        """Greedy two-part dictionary segmentation for OOV compounds
        (snowboardings, crossfires) — the reference reaches the same cases
        through wordsegment (english.py:256). Both parts must be dictionary
        words of >= 3 letters; the most balanced split wins; the second
        part's primary stress demotes to secondary (CMU compound shape)."""
        n = len(word)
        if n < 8:
            return None
        best = None
        # parts must be >= 4 letters: 3-letter dictionary "words" are mostly
        # spelled acronyms (acc, ati) and tails like "red" that shadow plain
        # inflections (anchored != ancho + red)
        for cut in range(4, n - 3):
            a, b = word[:cut], word[cut:]
            if a in self.cmu and b in self.cmu:
                score = min(cut, n - cut)
                if best is None or score > best[0]:
                    best = (score, a, b)
        if best is None:
            return None
        _, a, b = best
        second = [p[:-1] + "2" if p.endswith("1") else p for p in self.cmu[b]]
        return list(self.cmu[a]) + second

    def _letter_to_sound(self, word: str) -> list:
        """Last-resort OOV reading: the trained neural seq2seq (the
        reference's g2p_en model family, trained from scratch on the local
        CMUdict — text/neural_g2p.py, artifact text/g2p_en_lstm.npz) when
        its artifact is present, else the rule engine."""
        nn = self._neural()
        if nn is not None:
            phones = nn.predict(word)
            # guardrails: valid phones and at least one vowel, else rules
            if (phones and all(p in self._arpa for p in phones)
                    and any(p[-1].isdigit() for p in phones)):
                return phones
        return letter_to_sound(word)

    _NEURAL_CACHE: dict = {}

    def _neural(self):
        if os.environ.get("VOSK_TTS_NEURAL_G2P", "1") == "0":
            return None
        if "model" not in self._NEURAL_CACHE:
            path = os.path.join(os.path.dirname(__file__), "g2p_en_lstm.npz")
            model = None
            if os.path.exists(path):
                try:
                    from .neural_g2p import NeuralG2P

                    model = NeuralG2P(path)
                except Exception:
                    model = None
            self._NEURAL_CACHE["model"] = model
        return self._NEURAL_CACHE["model"]

    # ------------------------------------------------------------------
    def __call__(self, text: str) -> list:
        """english.py g2p(): phones for a text span, punctuation kept, phones
        outside the ARPA set dropped with ' -> - (replace_phs)."""
        out = []
        for token in re.split(r"([,.?!;:\"() \-])", text.lower()):
            if token == "" or token == " ":
                continue
            if re.match(r"[,.?!;:\"()\-]", token):
                out.append(token)
                continue
            for ph in self.word_phones(token):
                if ph in self._arpa:
                    out.append(ph)
                elif ph == "'":
                    out.append("-")
        return out
