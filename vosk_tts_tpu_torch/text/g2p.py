"""Rule-based Russian grapheme-to-phoneme conversion.

The port's own copy of ``vosk_tts_tpu/text/g2p.py`` (the port imports
nothing from the JAX package). Behaviour is identical: stress marks via
'+', consonant palatalization before soft vowels, vowel latinization with
stress digits and j-insertion at syllable starts.
"""

from __future__ import annotations

# soft vowels that palatalize a preceding paired consonant
_SOFTENING = set("яёюиье")
# contexts after which я/ю/е/ё gain a leading 'j' glide
_SYLLABLE_START = set("#ъьаяоёуюэеиы-")
_IOTATED = set("яюеё")
# symbols removed from the final phone string
_DROPPED = {"#", "+", "-", "ь", "ъ"}

_PAIRED = {
    "б": "b", "в": "v", "г": "g", "Г": "g", "д": "d", "з": "z", "к": "k",
    "л": "l", "м": "m", "н": "n", "п": "p", "р": "r", "с": "s", "т": "t",
    "ф": "f", "х": "h",
}
_UNPAIRED = {"ж": "zh", "ц": "c", "ч": "ch", "ш": "sh", "щ": "sch", "й": "j"}
_VOWELS = {
    "а": "a", "я": "a", "у": "u", "ю": "u", "о": "o", "ё": "o",
    "э": "e", "е": "e", "и": "i", "ы": "y",
}


def convert(stressword: str) -> str:
    """'абстр+акцию' -> 'a0 b s t r a1 k c i0 j u0'."""
    raw = "#" + stressword + "#"

    # fold '+' marks into per-character stress flags
    chars: list[str] = []
    stress: list[int] = []
    pending = 0
    for ch in raw:
        if ch == "+":
            pending = 1
        else:
            chars.append(ch)
            stress.append(pending)
            pending = 0

    out: list[str] = []
    prev = None  # symbol as seen after palatalization
    last = len(chars) - 1
    for i, ch in enumerate(chars):
        # palatalization (skips the final sentinel)
        sym = ch
        if i < last:
            if ch in _PAIRED:
                sym = _PAIRED[ch] + ("j" if chars[i + 1] in _SOFTENING else "")
            elif ch in _UNPAIRED:
                sym = _UNPAIRED[ch]

        # glide insertion + vowel latinization
        if prev in _SYLLABLE_START and ch in _IOTATED:
            out.append("j")
        if ch in _VOWELS:
            out.append(_VOWELS[ch] + str(stress[i]))
        else:
            out.append(sym)
        prev = sym

    return " ".join(p for p in out if p not in _DROPPED)
