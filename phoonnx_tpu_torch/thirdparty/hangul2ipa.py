"""Hangul -> IPA via Korean phonological rules.

Capability rebuild of phoonnx/thirdparty/hangul2ipa.py (stannam/hangul_to_ipa):
syllables decompose into jamo, a cascade of phonological rules applies
(palatalization, aspiration, assimilation, tensification, coda-cluster
simplification, coda neutralization, intersonorant h-deletion, optional
non-coronalization), then jamo map to IPA symbols with intersonorant
voicing and l/ɾ alternation. Rule data ships as CSV tables in
``ko_tables/`` (interchange data shared with the reference).
"""

import csv
import os
import re
from functools import lru_cache
from typing import Dict, List, Tuple

_TABLES_DIR = os.path.join(os.path.dirname(__file__), "ko_tables")

GA_CODE = 44032
ONSET_SPAN = 588
CODA_SPAN = 28

ONSET_LIST = ('ㄱ', 'ㄲ', 'ㄴ', 'ㄷ', 'ㄸ', 'ㄹ', 'ㅁ', 'ㅂ', 'ㅃ', 'ㅅ', 'ㅆ',
              'ㅇ', 'ㅈ', 'ㅉ', 'ㅊ', 'ㅋ', 'ㅌ', 'ㅍ', 'ㅎ')
VOWEL_LIST = ('ㅏ', 'ㅐ', 'ㅑ', 'ㅒ', 'ㅓ', 'ㅔ', 'ㅕ', 'ㅖ', 'ㅗ', 'ㅘ', 'ㅙ',
              'ㅚ', 'ㅛ', 'ㅜ', 'ㅝ', 'ㅞ', 'ㅟ', 'ㅠ', 'ㅡ', 'ㅢ', 'ㅣ')
CODA_LIST = ('', 'ㄱ', 'ㄲ', 'ㄳ', 'ㄴ', 'ㄵ', 'ㄶ', 'ㄷ', 'ㄹ', 'ㄺ', 'ㄻ',
             'ㄼ', 'ㄽ', 'ㄾ', 'ㄿ', 'ㅀ', 'ㅁ', 'ㅂ', 'ㅄ', 'ㅅ', 'ㅆ', 'ㅇ',
             'ㅈ', 'ㅊ', 'ㅋ', 'ㅌ', 'ㅍ', 'ㅎ')

C_SONORANT_JAMO = ('ㄴ', 'ㄹ', 'ㅇ', 'ㅁ')


@lru_cache(maxsize=8)
def _load_table(name: str) -> Dict[str, Tuple[str, ...]]:
    path = os.path.join(_TABLES_DIR, f"{name}.csv")
    columns: Dict[str, List[str]] = {}
    with open(path, encoding="utf-8") as f:
        for row in csv.DictReader(f):
            for header, value in row.items():
                columns.setdefault(header, []).append(value)
    return {k: tuple(v) for k, v in columns.items()}


def _sub_table(name: str, text: str) -> str:
    table = _load_table(name)
    for src, dst in zip(table["_from"], table["_to"]):
        text = text.replace(src, dst)
    return text


@lru_cache(maxsize=1)
def _inventories():
    ipa = _load_table("ipa")
    consonants = tuple(ipa["C"][:-2])  # strip the '#'/'$' sentinel rows
    vowels = tuple(ipa["V"])
    obstruents = tuple(set(consonants) - set(C_SONORANT_JAMO))
    sonorants = vowels + C_SONORANT_JAMO
    return consonants, vowels, obstruents, sonorants


@lru_cache(maxsize=1)
def _ipa_inventories():
    """Transcribed (IPA-symbol) sonorant/vowel inventories — computed
    once, not per word (the _inter_v/_alternate_lr hot path re-ran ~25
    _transcribe lookups per helper per word)."""
    _, vowels, _, sonorants = _inventories()
    ipa_sonorants = tuple("".join(_transcribe(s)) for s in sonorants)
    ipa_vowels = tuple("".join(_transcribe(v)) for v in vowels)
    return ipa_sonorants, ipa_vowels


def hangul_to_jamos(hangul: str) -> List[str]:
    out = []
    for letter in hangul:
        code = ord(letter)
        if GA_CODE <= code <= 55203:
            offset = code - GA_CODE
            onset = offset // ONSET_SPAN
            vowel = (offset % ONSET_SPAN) // CODA_SPAN
            coda = offset % CODA_SPAN
            out.append(ONSET_LIST[onset] + VOWEL_LIST[vowel] + CODA_LIST[coda])
        else:
            out.append(letter)
    return out


def _separate_double_coda(syllables: List[str]) -> List[str]:
    table = _load_table("double_coda")
    out = []
    for syllable in syllables:
        if len(syllable) >= 3 and syllable[2] in table["_double"]:
            idx = table["_double"].index(syllable[2])
            out.append(syllable[:2] + table["_separated"][idx])
        else:
            out.append(syllable)
    return out


def to_jamo(hangul: str) -> str:
    """Hangul -> jamo string; separates double codas, drops empty onsets."""
    cleaned = re.sub(r"[^가-힣ㄱ-ㅎㅏ-ㅣ]", "", hangul)
    syllables = _separate_double_coda(hangul_to_jamos(cleaned))
    return "".join(
        syl[1:] if syl and syl[0] == "ㅇ" else syl for syl in syllables
    )


def _mark_cv(jamo: str) -> str:
    consonants, vowels, _, _ = _inventories()
    out = ""
    for j in jamo:
        if j in vowels:
            out += "V"
        elif j in consonants:
            out += "C"
    return out


# ---------------------------------------------------------------------------
# Phonological rules
# ---------------------------------------------------------------------------

_PALATAL = {"ㄷ": "ㅈ", "ㅌ": "ㅊ"}


def _palatalize(hangul: str) -> str:
    syllables = [to_jamo(s) for s in hangul]
    for i in range(len(syllables) - 1):
        nxt = syllables[i + 1]
        if nxt and nxt[0] == "ㅣ" and syllables[i]:
            last = syllables[i][-1]
            syllables[i] = syllables[i][:-1] + _PALATAL.get(last, last)
    return "".join(syllables)


def _neutralize(jamo: str) -> str:
    cv = _mark_cv(jamo)
    table = _load_table("neutralization")
    out = list(jamo)
    for i, j in enumerate(out):
        if i == len(out) - 1 or (i + 1 < len(cv) and cv[i + 1] == "C"):
            if j in table["_from"]:
                out[i] = table["_to"][table["_from"].index(j)]
    return "".join(out)


def _delete_h(jamo: str) -> str:
    _, _, _, sonorants = _inventories()
    locations = [m.start() for m in re.finditer("(?=ㅎ)", jamo)]
    for loc in reversed(locations):
        if loc == 0 or loc == len(jamo) - 1:
            continue
        if jamo[loc - 1] in sonorants and jamo[loc + 1] in sonorants:
            jamo = jamo[:loc] + jamo[loc + 1:]
    return jamo


def _simplify_coda(jamo: str) -> str:
    table = _load_table("double_coda")

    def simplify_at(text: str, loc: int) -> str:
        double = text[loc + 1:loc + 3]
        if double in table["_separated"]:
            idx = table["_separated"].index(double)
            return text[:loc + 1] + table["_to"][idx] + text[loc + 3:]
        return text

    while True:
        cv = _mark_cv(jamo)
        locs = [m.start() for m in re.finditer("(?=VCCC)", cv)]
        if not locs:
            break
        jamo = simplify_at(jamo, locs[0])

    cv = _mark_cv(jamo)
    final_cc = [m.start() for m in re.finditer("(?=CC$)", cv)]
    if final_cc:
        jamo = simplify_at(jamo, final_cc[0] - 1)
    return jamo


def _non_coronalize(jamo: str) -> str:
    velars = "ㄱㅋㄲ"
    bilabials = "ㅂㅍㅃㅁ"
    out = list(jamo)
    for i in range(1, len(jamo) - 1):
        if jamo[i] not in "ㅁㄴ":
            continue
        nxt = jamo[i + 1]
        if nxt in velars:
            out[i] = "ㅇ"
        elif nxt in bilabials:
            out[i] = "ㅁ"
    return "".join(out)


def _transcribe(jamos: str) -> List[str]:
    ipa = _load_table("ipa")
    out = []
    for j in jamos:
        if j in ipa["V"]:
            out.append(ipa["VSymbol"][ipa["V"].index(j)])
        elif j in ipa["C"]:
            out.append(ipa["CSymbol"][ipa["C"].index(j)])
    return out


_VOICING = {"p": "b", "t": "d", "k": "ɡ", "tɕ": "dʑ"}


def _inter_v(symbols: List[str]) -> List[str]:
    ipa_sonorants, _ = _ipa_inventories()
    out = list(symbols)
    for i in range(1, len(symbols) - 1):
        if symbols[i] not in _VOICING:
            continue
        if symbols[i - 1] in ipa_sonorants:
            if symbols[i + 1] in ipa_sonorants:
                out[i] = _VOICING[symbols[i]]
            elif symbols[i + 1] == "ɕ":
                out[i] = _VOICING[symbols[i]]
                out[i + 1] = "ʑ"
    return out


def _alternate_lr(symbols: List[str]) -> List[str]:
    _, ipa_vowels = _ipa_inventories()
    out = list(symbols)
    for i in range(1, len(symbols) - 1):
        if symbols[i] == "l" and symbols[i - 1] in ipa_vowels \
                and symbols[i + 1] in ipa_vowels:
            out[i] = "ɾ"
    return out


# ---------------------------------------------------------------------------
# Hanja -> hangul (reference hangul2ipa.py:210-293, 639-655): Korean text
# routinely mixes in 漢字; without this the to_jamo cleanup regex silently
# DELETED those syllables from the synthesized speech.
# ---------------------------------------------------------------------------

_HIGHV_DIPHTHONGS = ("ㅑ", "ㅕ", "ㅖ", "ㅛ", "ㅠ", "ㅣ")


@lru_cache(maxsize=1)
def _jajeon() -> dict:
    """hanja -> hangul reading, from ko_tables/hanja.tsv (keys stored as
    U+XXXX code points in the file)."""
    jajeon = {}
    path = os.path.join(_TABLES_DIR, "hanja.tsv")
    with open(path, newline="", encoding="utf-8") as f:
        for row in csv.reader(f, delimiter="\t"):
            if len(row) < 2:
                continue
            jajeon[chr(int(row[0].strip("U+"), 16))] = row[1]
    return jajeon


def _is_han(ch: str) -> bool:
    code = ord(ch)
    return (0x3400 <= code <= 0x4DBF or 0x4E00 <= code <= 0x9FFF
            or 0xF900 <= code <= 0xFAFF or 0x20000 <= code <= 0x2A6DF)


def _jamo_to_syllable(jamos: str) -> str:
    onset = ONSET_LIST.index(jamos[0])
    vowel = VOWEL_LIST.index(jamos[1])
    coda = CODA_LIST.index(jamos[2]) if len(jamos) > 2 else 0
    return chr(GA_CODE + onset * ONSET_SPAN + vowel * CODA_SPAN + coda)


def _initial_rule(char: str) -> str:
    """Word-initial 두음법칙: ㄹ -> ㄴ, and ㄴ before a high vowel/
    diphthong -> ㅇ (reference hangul2ipa.py:243-263)."""
    jamos = "".join(hangul_to_jamos(char))
    if len(jamos) < 2:
        return char
    onset, nucleus = jamos[0], jamos[1]
    changed = False
    if onset == "ㄹ":
        onset, changed = "ㄴ", True
    if onset == "ㄴ" and nucleus in _HIGHV_DIPHTHONGS:
        onset, changed = "ㅇ", True
    if not changed:
        return char
    return _jamo_to_syllable(onset + nucleus + jamos[2:])


def sanitize(word: str) -> str:
    """Convert hanja to their hangul readings (incl. the 不-pronunciation
    rules and the word-initial rule) and drop inner spaces."""
    word = word.replace(" ", "")
    hanja_idx = [i for i, ch in enumerate(word) if _is_han(ch)]
    if not hanja_idx:
        return word
    jajeon = _jajeon()
    chars = list(word)
    for i in hanja_idx:
        if chars[i] == "不" and i < len(chars) - 1:
            if chars[i + 1] == "實":  # special case: 不實 = 부실
                chars[i], chars[i + 1] = "부", "실"
                continue
            # 不 is 부 [pu] before an alveolar ㄷ/ㅈ, 불 otherwise
            chars[i + 1] = jajeon.get(chars[i + 1], chars[i + 1])
            nxt = "".join(hangul_to_jamos(chars[i + 1]))
            chars[i] = "부" if (nxt and nxt[0] in ("ㄷ", "ㅈ")) else "불"
            continue
        chars[i] = jajeon.get(chars[i], chars[i])
        if i == 0:
            chars[i] = _initial_rule(chars[i])
    return "".join(chars)


def convert_word(hangul: str, rules: str = "pastcnhovr") -> str:
    """One word of hangul -> IPA string."""
    if not hangul:
        return ""
    _, _, obstruents, _ = _inventories()

    hangul = sanitize(hangul)
    jamo = to_jamo(hangul)
    jamo = _simplify_coda(jamo)

    if "p" in rules and ("ㄷㅣ" in jamo or "ㅌㅣ" in jamo):
        jamo = _palatalize(hangul)
    if "a" in rules and "ㅎ" in jamo:
        jamo = _sub_table("aspiration", jamo)
    if "s" in rules:
        jamo = _sub_table("assimilation", jamo)
    if "t" in rules and any(j in jamo for j in obstruents):
        jamo = _sub_table("tensification", jamo)
    if "c" in rules:
        jamo = _simplify_coda(jamo)
    if "n" in rules:
        jamo = _neutralize(jamo)
    if "h" in rules and "ㅎ" in jamo[1:-1]:
        jamo = _delete_h(jamo)
    if "o" in rules:
        jamo = _non_coronalize(jamo)

    symbols = _transcribe(jamo)
    if "v" in rules:
        symbols = _inter_v(symbols)
    if "r" in rules and "l" in symbols:
        symbols = _alternate_lr(symbols)
    return "".join(symbols)


def hangul2ipa(input_text: str) -> str:
    """Space-separated hangul words -> space-separated IPA."""
    return " ".join(convert_word(w) for w in input_text.split())
