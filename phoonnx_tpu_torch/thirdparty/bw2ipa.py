"""Buckwalter (mantoq-style) -> IPA (reference: phoonnx/thirdparty/bw2ipa.py).

Handles the mantoq tokenizer's ``_dbl_`` marker: after a vowel it denotes
length (ː), after a consonant gemination (the consonant is doubled).
"""

from typing import Dict

# single Buckwalter character -> IPA
CHAR_MAP: Dict[str, str] = {
    "a": "a", "A": "aː", "b": "b", "c": "x", "d": "d", "D": "dˤ", "e": "e",
    "E": "ʕ", "f": "f", "g": "ɣ", "h": "h", "H": "ħ", "i": "i", "I": "iː",
    "j": "ʒ", "k": "k", "l": "l", "m": "m", "n": "n", "p": "p", "q": "q",
    "r": "r", "R": "r", "s": "s", "S": "sˤ", "t": "t", "T": "tˤ", "u": "u",
    "U": "uː", "v": "v", "w": "w", "x": "x", "y": "j", "z": "z", "Z": "ðˤ",
    "'": "ʔ", "<": "ʔ", "o": "o", "-": " ", "*": "ð", "$": "ʃ",
}

_VOWELS = {"a", "i", "u", "aː", "iː", "uː"}
_DBL = "_dbl_"


def translate(buckwalter_text: str) -> str:
    """Buckwalter token string -> IPA string."""
    out = []
    i = 0
    n = len(buckwalter_text)
    while i < n:
        if buckwalter_text[i:i + len(_DBL)] == _DBL:
            if out and out[-1] in _VOWELS:
                out.append("ː")
            elif out:
                out.append(out[-1])
            i += len(_DBL)
            continue
        two = buckwalter_text[i:i + 2]
        if two in CHAR_MAP:
            out.append(CHAR_MAP[two])
            i += 2
            continue
        char = buckwalter_text[i]
        out.append(CHAR_MAP.get(char, char))
        i += 1
    return "".join(out)
