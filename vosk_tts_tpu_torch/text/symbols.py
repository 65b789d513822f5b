"""Russian phone set and the phoneme-id maps.

The port's own copy of ``vosk_tts_tpu/text/symbols.py``:

  * plain 62-symbol map: 14 specials + 48 phones, used by the VITS2 text
    modes;
  * multistream 207-symbol map: 15 specials (adds "...") + 48 phones x 4
    word-position suffixes (_I, _S, _B, _E), used by multistream_v1/v2/v3.
"""

# paired (hard/soft) consonants -> latin; soft variant appends "j"
PAIRED_CONSONANTS = ["b", "v", "g", "d", "z", "k", "l", "m", "n", "p", "r", "s", "t", "f", "h"]
UNPAIRED_CONSONANTS = ["zh", "c", "ch", "sh", "sch", "j"]
VOWELS = ["a", "e", "i", "o", "u", "y"]  # each with stress suffix 0/1

#: all 48 phones, sorted exactly like the reference tables
PHONES = sorted(
    [v + s for v in VOWELS for s in ("0", "1")]
    + PAIRED_CONSONANTS
    + [c + "j" for c in PAIRED_CONSONANTS]
    + UNPAIRED_CONSONANTS
)

#: specials in table order (blank, BOS, EOS, punctuation)
BASE_SYMBOLS = ["_", "^", "$", " ", "!", '"', "(", ")", ",", "-", ".", ":", ";", "?"]

WORD_POSITIONS = ["_I", "_S", "_B", "_E"]


def plain_symbol_map() -> dict:
    """62-symbol map: symbol -> id."""
    table = BASE_SYMBOLS + PHONES
    return {s: i for i, s in enumerate(table)}


def multistream_symbol_map() -> dict:
    """207-symbol map with word-position suffixes and the "..." token."""
    specials = BASE_SYMBOLS[:11] + ["..."] + BASE_SYMBOLS[11:]
    table = list(specials)
    for ph in PHONES:
        table += [ph + pos for pos in WORD_POSITIONS]
    return {s: i for i, s in enumerate(table)}
