"""Arabic G2P: text -> Buckwalter-style phoneme tokens (mantoq pipeline).

Capability rebuild of phoonnx/thirdparty/mantoq: punctuation folding,
number verbalization, the MSA phonetisation rule cascade
(:mod:`phoonnx_tpu_torch.thirdparty.mantoq.phonetise`, golden-tested against the
reference), vowel simplification, and tokenization with ``_dbl_``
(gemination) and ``_+_`` (word separator) markers, consumable by
:mod:`phoonnx_tpu_torch.thirdparty.bw2ipa`.
"""

import re
from typing import Dict, List, Tuple

from phoonnx_tpu_torch.thirdparty.mantoq.num2words import (
    arabic_num2words,
    num2words,
)
from phoonnx_tpu_torch.thirdparty.mantoq.phonetise import (
    arabic_to_buckwalter,
    buckwalter_to_arabic,
    process_utterance,
)

PADDING_TOKEN = "_pad_"
EOS_TOKEN = "_eos_"
DOUBLING_TOKEN = "_dbl_"
SEPARATOR_TOKEN = "_+_"
WORD_SEP = SEPARATOR_TOKEN

# Arabic punctuation / quotes / brackets folded to ASCII equivalents
_AR_PUNCS = str.maketrans("،؟؛", ",?;")
_QUOTES = str.maketrans("“”„«»", '"' * 5)
_BRACKETS = str.maketrans("[]{}", "()()")

_VOWEL_SIMPLIFY: Dict[str, str] = {
    "aa": "aa", "AA": "aa", "uu0": "uu", "uu1": "uu", "UU0": "uu",
    "UU1": "uu", "ii0": "ii", "ii1": "ii", "II0": "ii", "II1": "ii",
    "a": "a", "A": "a", "u0": "u", "u1": "u", "U0": "u", "U1": "u",
    "i0": "i", "i1": "i", "I0": "i", "I1": "i",
}
# Exact reference inventory (tokenization.py:5-26): bare "uu"/"ii" are NOT
# in it, so post-simplification long u/i tokenize as short + _dbl_ (a
# reference quirk that checkpoints were trained with).
_RAW_VOWELS = {
    "aa", "AA", "uu0", "uu1", "UU0", "UU1", "ii0", "ii1", "II0", "II1",
    "a", "A", "u0", "u1", "U0", "U1", "i0", "i1", "I0", "I1",
}


def simplify_phonemes(phonemes: str) -> str:
    for src, dst in _VOWEL_SIMPLIFY.items():
        phonemes = phonemes.replace(src, dst)
    return phonemes


def phonemes_to_tokens(phonemes: str, append_space: bool = False
                       ) -> List[str]:
    """'ph ph + ph' string -> token list with _dbl_/_+_ markers."""
    tokens = phonemes.replace("sil", "").replace("+", SEPARATOR_TOKEN).split()
    i = 0
    while i < len(tokens):
        tok = tokens[i]
        if (len(tok) == 2 and tok not in _RAW_VOWELS
                and tok[0] == tok[1]):
            tokens[i] = tok[0]
            tokens.insert(i + 1, DOUBLING_TOKEN)
        if tokens[i] in _VOWEL_SIMPLIFY:
            tokens[i] = _VOWEL_SIMPLIFY[tokens[i]]
        i += 1
    if append_space:
        tokens.append(SEPARATOR_TOKEN)
    tokens.append(EOS_TOKEN)
    return tokens


def normalize(text: str) -> str:
    text = text.translate(_AR_PUNCS).translate(_QUOTES).translate(_BRACKETS)
    return re.sub(r"\s+", " ", text).strip()


def arabic_to_phonemes(text: str) -> str:
    return process_utterance(arabic_to_buckwalter(text))


def g2p(text: str, process_numbers: bool = True,
        append_eos: bool = False) -> Tuple[str, List[str]]:
    """Arabic text -> (normalized_text, phoneme token list).

    Matches the reference surface (thirdparty/mantoq/__init__.py:24-39):
    tokens use ``_+_`` between words and ``_dbl_`` for gemination; the
    trailing EOS token is dropped unless requested.
    """
    text = normalize(text)
    if process_numbers:
        text = num2words(text)
    normalized_text = text
    phones = arabic_to_phonemes(text)
    phones = simplify_phonemes(phones)
    tokens = phonemes_to_tokens(phones)
    if not append_eos:
        tokens = tokens[:-1]
    return normalized_text, tokens


__all__ = [
    "g2p", "arabic_to_buckwalter", "buckwalter_to_arabic",
    "arabic_to_phonemes", "simplify_phonemes", "phonemes_to_tokens",
    "num2words", "DOUBLING_TOKEN", "SEPARATOR_TOKEN", "EOS_TOKEN",
    "WORD_SEP",
]
