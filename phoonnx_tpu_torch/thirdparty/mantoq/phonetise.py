"""Modern Standard Arabic phonetisation rules (Buckwalter-based).

Functional rebuild of the rule set used by mantoq (originally Nawar
Halabi's Arabic-Phonetiser, CC BY-NC 4.0; the reference vendors it at
phoonnx/thirdparty/mantoq/buck/phonetise_buckwalter.py). Golden-tested
against the reference implementation for identical output.

Pipeline: Arabic script -> Buckwalter -> per-word rule cascade (emphatic
context tracking, sun-letter lam omission, shadda doubling, waw/ya
vowel-vs-consonant disambiguation, ta-marbuta, hamza forms, vowel
shortening) -> first pronunciation of the generated possibilities.
"""

import re
from typing import Dict, List, Union

# ---------------------------------------------------------------------------
# Script <-> Buckwalter transliteration (data)
# ---------------------------------------------------------------------------

ARABIC_TO_BUCKWALTER: Dict[str, str] = {
    "ب": "b", "ذ": "*", "ط": "T", "م": "m",
    "ت": "t", "ر": "r", "ظ": "Z", "ن": "n",
    "ث": "^", "ز": "z", "ع": "E", "ه": "h",
    "ج": "j", "س": "s", "غ": "g", "ح": "H",
    "ق": "q", "ف": "f", "خ": "x", "ص": "S",
    "ش": "$", "د": "d", "ض": "D", "ك": "k",
    "أ": ">", "ء": "'", "ئ": "}", "ؤ": "&",
    "إ": "<", "آ": "|", "ا": "A", "ى": "Y",
    "ة": "p", "ي": "y", "ل": "l", "و": "w",
    "ً": "F", "ٌ": "N", "ٍ": "K", "َ": "a",
    "ُ": "u", "ِ": "i", "ّ": "~", "ْ": "o",
}

BUCKWALTER_TO_ARABIC = {v: k for k, v in ARABIC_TO_BUCKWALTER.items()}


def arabic_to_buckwalter(text: str) -> str:
    return "".join(ARABIC_TO_BUCKWALTER.get(c, c) for c in text)


def buckwalter_to_arabic(text: str) -> str:
    return "".join(BUCKWALTER_TO_ARABIC.get(c, c) for c in text)


# ---------------------------------------------------------------------------
# Phone inventories (data)
# ---------------------------------------------------------------------------

UNAMBIGUOUS_CONSONANTS: Dict[str, str] = {
    "b": "b", "*": "*", "T": "T", "m": "m", "t": "t", "r": "r", "Z": "Z",
    "n": "n", "^": "^", "z": "z", "E": "E", "h": "h", "j": "j", "s": "s",
    "g": "g", "H": "H", "q": "q", "f": "f", "x": "x", "S": "S", "$": "$",
    "d": "d", "D": "D", "k": "k",
    ">": "<", "'": "<", "}": "<", "&": "<", "<": "<",
}

AMBIGUOUS_CONSONANTS = {"l": ["l", ""], "w": "w", "y": "y", "p": ["t", ""]}
MADDA = {"|": [["<", "aa"], ["<", "AA"]]}

VOWELS: Dict[str, list] = {
    "A": [["aa", ""], ["AA", ""]],
    "Y": [["aa", ""], ["AA", ""]],
    "w": [["uu0", "uu1"], ["UU0", "UU1"]],
    "y": [["ii0", "ii1"], ["II0", "II1"]],
    "a": ["a", "A"],
    "u": [["u0", "u1"], ["U0", "U1"]],
    "i": [["i0", "i1"], ["I0", "I1"]],
}

DIACRITICS = ["o", "a", "u", "i", "F", "N", "K", "~"]
DIACRITICS_NO_SHADDA = ["o", "a", "u", "i", "F", "N", "K"]
EMPHATICS = ["D", "S", "T", "Z", "g", "x", "q"]
FORWARD_EMPHATICS = ["g", "x"]
CONSONANTS = [">", "<", "}", "&", "'", "b", "t", "^", "j", "H", "x", "d",
              "*", "r", "z", "s", "$", "S", "D", "T", "Z", "E", "g", "f",
              "q", "k", "l", "m", "n", "h", "|"]
PUNCTUATION = [".", ",", "?", "!"]

# Irregular fixed pronunciations (keyed by the word's consonant skeleton)
FIXED_WORDS: Dict[str, Union[str, List[str]]] = {
    "h*A": ["h aa * aa", "h aa * a"],
    "h*h": ["h aa * i0 h i0", "h aa * i1 h"],
    "h*An": ["h aa * aa n i0", "h aa * aa n"],
    "h&lA'": ["h aa < u0 l aa < i0", "h aa < u0 l aa <"],
    "*lk": ["* aa l i0 k a", "* aa l i0 k"],
    "k*lk": ["k a * aa l i0 k a", "k a * aa l i1 k"],
    "*lkm": "* aa l i0 k u1 m",
    ">wl}k": ["< u0 l aa < i0 k a", "< u0 l aa < i1 k"],
    "Th": "T aa h a",
    "lkn": ["l aa k i0 nn a", "l aa k i1 n"],
    "lknh": "l aa k i0 nn a h u0",
    "lknhm": "l aa k i0 nn a h u1 m",
    "lknk": ["l aa k i0 nn a k a", "l aa k i0 nn a k i0"],
    "lknkm": "l aa k i0 nn a k u1 m",
    "lknkmA": "l aa k i0 nn a k u0 m aa",
    "lknnA": "l aa k i0 nn a n aa",
    "AlrHmn": ["rr a H m aa n i0", "rr a H m aa n"],
    "Allh": ["ll aa h i0", "ll aa h", "ll AA h u0", "ll AA h a", "ll AA h",
             "ll A"],
    "h*yn": ["h aa * a y n i0", "h aa * a y n"],
    "nt": "n i1 t",
    "fydyw": "v i0 d y uu1",
    "lndn": "l A n d u1 n",
}


def _fixed_word_pronunciations(word: str) -> List[List[str]]:
    """Irregular-word lookup keyed by consonant skeleton + final letter."""
    last = word[-1] if word else ""
    if last == "a":
        accepted = ["a", "A"]
    elif last == "A":
        accepted = ["aa"]
    elif last == "u":
        accepted = ["u0"]
    elif last == "i":
        accepted = ["i0"]
    elif last in UNAMBIGUOUS_CONSONANTS:
        accepted = [UNAMBIGUOUS_CONSONANTS[last]]
    else:
        accepted = last

    skeleton = re.sub(r"[^h*Ahn\'>wl}kmyTtfd]", "", word)
    entry = FIXED_WORDS.get(skeleton)
    if entry is None:
        return []
    if isinstance(entry, list):
        return [
            p.split(" ") for p in entry if p.split(" ")[-1] in accepted
        ]
    return [entry.split(" ")]


def preprocess_utterance(utterance: str) -> List[str]:
    """Orthographic normalisation before the rule cascade."""
    u = utterance
    u = u.replace("AF", "F").replace("ـ", "").replace("o", "")
    u = u.replace("aA", "A").replace("aY", "Y").replace(" A", " ")
    u = u.replace("F", "an").replace("N", "un").replace("K", "in")
    u = u.replace("|", ">A")
    u = u.replace("i~", "~i").replace("a~", "~a").replace("u~", "~u")
    # hamza forms imply their short vowel when it is not written
    u = re.sub(r"Ai", "<i", u)
    u = re.sub(r"Aa", ">a", u)
    u = re.sub(r"Au", ">u", u)
    u = re.sub(r"^>([^auAw])", ">a\\1", u)
    u = re.sub(r" >([^auAw ])", " >a\\1", u)
    u = re.sub(r"<([^i])", "<i\\1", u)
    u = re.sub(r"(\S)(\.|\?|,|!)", "\\1 \\2", u)
    return u.split(" ")


def _phones_for_word(word: str) -> List[Union[str, List[str]]]:
    """The MSA rule cascade over one padded word ('bb' + word + 'ee')."""
    emphatic = False
    padded = "bb" + word + "ee"
    phones: List[Union[str, List[str]]] = []

    for idx in range(2, len(padded) - 2):
        cur = padded[idx]
        nxt, nxt2 = padded[idx + 1], padded[idx + 2]
        prev, prev2 = padded[idx - 1], padded[idx - 2]

        # emphatic-context tracking
        if cur in CONSONANTS + ["w", "y"] and cur not in EMPHATICS + ["r"]:
            emphatic = False
        if cur in EMPHATICS:
            emphatic = True
        if nxt in EMPHATICS and nxt not in FORWARD_EMPHATICS:
            emphatic = True
        e = 1 if emphatic else 0

        if cur in UNAMBIGUOUS_CONSONANTS:
            phones.append(UNAMBIGUOUS_CONSONANTS[cur])

        if cur == "l":
            # sun-letter assimilation: lam omitted before a shadda
            sun = (nxt not in DIACRITICS and nxt not in VOWELS
                   and nxt2 == "~")
            phones.append(AMBIGUOUS_CONSONANTS["l"][1 if sun else 0])

        if cur == "~" and prev not in ["w", "y"] and phones:
            phones[-1] += phones[-1]  # shadda doubles the previous phone

        if cur == "|":
            phones.append(MADDA["|"][e])

        if cur == "p":  # ta marbuta: /t/ only when vowelled
            phones.append(
                AMBIGUOUS_CONSONANTS["p"][0 if nxt in DIACRITICS else 1]
            )

        if cur in VOWELS:
            if cur in ("w", "y"):
                is_consonantal = (
                    nxt in DIACRITICS_NO_SHADDA + ["A", "Y"]
                    or (nxt in ["w", "y"]
                        and nxt2 not in DIACRITICS + ["A", "w", "y"])
                    or (prev in DIACRITICS_NO_SHADDA
                        and nxt in CONSONANTS + ["e"])
                )
                if is_consonantal:
                    long_after_short = (
                        (cur == "w" and prev == "u"
                         and nxt not in ["a", "i", "A", "Y"])
                        or (cur == "y" and prev == "i"
                            and nxt not in ["a", "u", "A", "Y"])
                    )
                    if long_after_short:
                        phones.append(VOWELS[cur][e][0])
                    elif nxt == "A" and cur == "w" and nxt2 == "e":
                        phones.append(
                            [AMBIGUOUS_CONSONANTS[cur], VOWELS[cur][0][0]]
                        )
                    else:
                        phones.append(AMBIGUOUS_CONSONANTS[cur])
                elif nxt == "~":
                    if (prev == "a"
                            or (cur == "w" and prev in ["i", "y"])
                            or (cur == "y" and prev in ["w", "u"])):
                        phones += [AMBIGUOUS_CONSONANTS[cur],
                                   AMBIGUOUS_CONSONANTS[cur]]
                    else:
                        phones += [VOWELS[cur][0][0],
                                   AMBIGUOUS_CONSONANTS[cur]]
                else:  # word-final waw/ya may shorten
                    if prev in CONSONANTS + ["u", "i"] and nxt == "e":
                        phones.append(
                            [VOWELS[cur][e][0], VOWELS[cur][e][0][1:]]
                        )
                    else:
                        phones.append(VOWELS[cur][e][0])

            if cur in ("u", "i"):
                mild = ((nxt in UNAMBIGUOUS_CONSONANTS or nxt == "l")
                        and nxt2 == "e" and len(padded) > 7)
                phones.append(VOWELS[cur][e][1 if mild else 0])

            if cur in ("a", "A", "Y"):
                if cur == "A" and prev in ["w", "k"] and prev2 == "b":
                    phones.append(["a", VOWELS[cur][0][0]])
                elif cur == "A" and prev in ["u", "i"]:
                    pass  # silent alif after a short vowel
                elif cur == "A" and prev == "w" and nxt == "e":
                    # waw al-jama'a: trailing alif optional
                    phones.append([VOWELS[cur][0][0], VOWELS[cur][0][1]])
                elif cur in ("A", "Y") and nxt == "e":
                    phones.append([VOWELS[cur][e][0], VOWELS["a"][e]])
                else:
                    phones.append(VOWELS[cur][e][0])

    return phones


def _expand_pronunciations(phones) -> List[List[str]]:
    """Expand option-lists into every concrete pronunciation."""
    possibilities = 1
    for phone in phones:
        if isinstance(phone, list):
            possibilities *= len(phone)

    pronunciations: List[List[str]] = []
    for i in range(possibilities):
        current: List[str] = []
        iterations = 1
        for phone in phones:
            if isinstance(phone, list):
                pick = phone[(i // iterations) % len(phone)]
                if pick != "":
                    current.append(pick)
                iterations *= len(phone)
            elif phone != "":
                current.append(phone)
        pronunciations.append(current)
    return pronunciations


def _cleanup(pronunciation: List[str]) -> List[str]:
    """Merge duplicate consecutive vowels / glides (house-keeping pass)."""
    prev = ""
    to_delete: List[int] = []
    for i, letter in enumerate(pronunciation):
        if (letter in ["aa", "uu0", "ii0", "AA", "UU0", "II0"]
                and prev.lower() == letter[1:].lower()):
            to_delete.append(i - 1)
            pronunciation[i] = pronunciation[i - 1][0] + pronunciation[i - 1]
        if letter in ["u0", "i0"] and prev.lower() == letter.lower():
            to_delete.append(i - 1)
            pronunciation[i] = pronunciation[i - 1]
        if letter in ["y", "w"] and prev == letter:
            pronunciation[i - 1] += pronunciation[i - 1]
            to_delete.append(i)
        prev = letter
    for i in reversed(to_delete):
        del pronunciation[i]
    return pronunciation


def process_word(word: str):
    if word in PUNCTUATION:
        return word
    pronunciations = _fixed_word_pronunciations(word)
    pronunciations.extend(_expand_pronunciations(_phones_for_word(word)))
    return _cleanup(pronunciations[0])


def process_utterance(utterance: str) -> str:
    """Buckwalter utterance -> 'ph ph + ph ph' phoneme string."""
    words = preprocess_utterance(utterance)
    phonemes: List = []
    for word in words:
        if word in ["-", "sil"]:
            phonemes.append(["sil"])
            continue
        result = process_word(word)
        if result in PUNCTUATION and phonemes:
            phonemes[-1] += result
        else:
            phonemes.append(result)
    return " + ".join(" ".join(p for p in phones) for phones in phonemes)
