"""Russian phone set and the plain 62-symbol phoneme-id map.

The port's own copy of the plain map of ``vosk_tts_tpu/text/symbols.py``:
14 specials + 48 phones, used by the VITS2 text modes. The multistream map
joins with the StableTTS slice.
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


def plain_symbol_map() -> dict:
    """62-symbol map: symbol -> id."""
    table = BASE_SYMBOLS + PHONES
    return {s: i for i, s in enumerate(table)}
