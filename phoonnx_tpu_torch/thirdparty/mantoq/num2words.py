"""Arabic number verbalization with diacritics (tashkeel).

Token-identical rebuild of the mantoq number pipeline
(reference: phoonnx/thirdparty/mantoq/num2words.py:8-37 over
pyarabic/number.py:92-197,604-728): every ``\\d+`` run in the text is
spelled with pyarabic's block decomposition (units/tens/hundreds tables
plus thousand/million/milliard scale words), then each spelled word is
vocalized through the BIO number-phrase detector and the per-word case
rules (compound-numeral nasb before "عشر/عشرة", raf3 for "…ون" endings,
conjunction prefixes). The word-form vocabulary lives in
``ar_number_words.json`` — pure linguistic data (Arabic number words and
their case-vocalized variants); the algorithm below is an independent
implementation of the observed reference behavior.
"""

import json
import os
import re
from typing import Dict, List

_DATA_PATH = os.path.join(os.path.dirname(__file__), "ar_number_words.json")
with open(_DATA_PATH, encoding="utf-8") as _f:
    _D = json.load(_f)

_IND: Dict[str, object] = _D["individuals"]
_SCALES: Dict[str, Dict[str, str]] = _D["complications"]
_NUMBER_WORDS: Dict[str, int] = _D["number_words"]
_VOC: Dict[str, Dict[str, str]] = _D["vocalized"]
_TEN_MASC = set(_D["ten_masc_units"])
_TEN_FEM = set(_D["ten_fem_units"])
_NASEB = set(_D["naseb_words"])
_JAR = set(_D["jar_words"])
_RAFE3 = set(_D["rafe3_words"])

ZERO = "صفر"
_DECIMAL_SEP = "فاصلة"
_WAW = "و"
# fatha/damma/kasra (+tanwin), sukun, shadda — pyarabic TASHKEEL set
_TASHKEEL_RE = re.compile("[ً-ْ]")
# prefixes that may precede a number word (waw/fa conjunctions, lam/ba/kaf)
_PREFIXES = ("و", "ف", "ل", "ب", "ك")
_JAR_PREFIXES = ("ل", "ب", "ك")
# words excluded from single-word vocalization: they collide with
# fraction nouns (خُمس vs خمس…) — reference number.py:308-321
_AMBIGUOUS_ALONE = {
    "عشر", "خمس", "سبع", "تسع", "خمسا", "سبعا", "تسعا", "عشرا",
    "ألفين", "عشرة", "صفر", "ألف",
}
# compound-teen lead words that only count as numbers before عشر/عشرة
_TEEN_LEADS = {"أحد", "إحدى", "اثنا", "اثني", "اثنتي", "اثنتا"}

_DIGIT_RUN = re.compile(r"\d+")
_PERCENT_PLAIN = "بالمئة"
_PERCENT_VOCALIZED = "بِالْمِئَة"
# collapse spaces around punctuation runs (pyarabic araby.fix_spaces)
_PUNCT_SPACING = re.compile(r"\s*([?؟!.,،:]+(?:\s+[?؟!.,،:]+)*)\s*")
# Eastern-Arabic and Persian digits → Western
_DIGIT_FOLD = {ord(c): str(i) for i, c in enumerate("٠١٢٣٤٥٦٧٨٩")}
_DIGIT_FOLD.update({ord(c): str(i) for i, c in enumerate("۰۱۲۳۴۵۶۷۸۹")})


def strip_tashkeel(text: str) -> str:
    return _TASHKEEL_RE.sub("", text)


def _table_form(entry, key: str) -> str:
    return entry[key] if isinstance(entry, dict) else entry


def _spell_block(n: int, feminine: int = 1, case: int = 1) -> str:
    """Spell 0..999 (one 3-digit block). Word order: hundreds, then
    ones-before-tens ("واحد و عشرون")."""
    fem, fmt = str(feminine), str(case)
    parts: List[str] = []
    if n > 99:
        parts.append(_table_form(_IND[str(n // 100 * 100)], fmt))
        n %= 100
    if n in (2, 12):
        parts.append(_IND[str(n)][fem][fmt])
    elif n < 20:
        parts.append(_IND[str(n)][fem])
    else:
        ones, tens = n % 10, n // 10 * 10
        if ones == 2:
            parts.append(_IND["2"][fem][fmt])
        elif ones:
            parts.append(_IND[str(ones)][fem])
        parts.append(_table_form(_IND[str(tens)], fmt))
    return f" {_WAW} ".join(p for p in parts if p)


def _spell_integer(digits: str, case: int = 1) -> str:
    """Digit string -> plain (unvocalized) Arabic words."""
    try:
        value = int(digits)
    except ValueError:
        value = 0
    if value <= 0:
        return ZERO
    blocks: List[str] = []
    while len(digits) > 3:
        blocks.append(digits[-3:])
        digits = digits[:-3]
    blocks.append(digits)
    items: List[str] = []
    for i in range(len(blocks) - 1, -1, -1):
        n = int(blocks[i])
        text = _spell_block(n)
        if not text:
            continue
        if i != 0:
            scale = _SCALES[str(i)]
            if n == 1:
                text = scale["4"]
            elif n == 2:
                text = scale[str(case)]
            elif 2 < n < 11:
                text = f"{text} {scale['3']}"
            else:
                text = f"{text} {scale['4']}"
        items.append(text)
    return f" {_WAW} ".join(items)


def number2text(anumber) -> str:
    """Number (or digit string, possibly with a decimal point) -> plain
    Arabic words; decimal parts joined with "فاصلة"."""
    if isinstance(anumber, (int, float)):
        anumber = str(anumber)
    elif isinstance(anumber, str):
        try:
            float(anumber)
        except ValueError:
            return ZERO
    else:
        return ZERO
    parts = anumber.split(".")
    spelled = _spell_integer(parts[0])
    if len(parts) > 1:
        spelled += f" {_DECIMAL_SEP} " + _spell_integer(parts[1])
    return spelled


def _strip_prefix(word_nm: str, in_phrase: bool) -> str:
    """Lookup key for a possibly-prefixed number word."""
    if word_nm and not in_phrase and word_nm != "واحد" \
            and word_nm[0] in _PREFIXES:
        return word_nm[1:]
    if word_nm != "واحد" and word_nm.startswith(_WAW):
        return word_nm[1:]
    return word_nm


def _tag_number_words(words: List[str]) -> List[str]:
    """BIO tags (DB/DI/O) over a word list, marking number phrases."""
    tags: List[str] = []
    in_phrase = False
    for i, word in enumerate(words):
        nxt = strip_tashkeel(words[i + 1]) if i + 1 < len(words) else None
        key = _strip_prefix(strip_tashkeel(word), in_phrase)
        is_num = key in _NUMBER_WORDS or key.isnumeric()
        if is_num and (key not in _TEEN_LEADS or nxt in ("عشر", "عشرة")):
            tags.append("DI" if in_phrase else "DB")
            in_phrase = True
        else:
            tags.append("O")
            in_phrase = False
    return tags


def _context_tag(word: str) -> str:
    """Grammatical case imposed by the word preceding a number phrase."""
    word = strip_tashkeel(word)
    if word in _NASEB:
        return "منصوب"
    if word in _JAR:
        return "مجرور"
    if word in _RAFE3:
        return "مرفوع"
    return ""


def vocalize_number(words: List[str], syn_tags: str = "") -> List[str]:
    """Vocalize one number phrase (list of plain number words)."""
    if len(words) == 1:
        word = words[0]
        key = strip_tashkeel(word)
        if key != "واحد" and key.startswith(_WAW):
            key = key[1:]
        if key in _NUMBER_WORDS and key not in _AMBIGUOUS_ALONE:
            return [_VOC[key]["i"]]
        return [word]

    # phrase-level case: "…ون/…ان" endings are raf3, "…ين" ambiguous
    tags = syn_tags
    for i, word in enumerate(words):
        word_nm = strip_tashkeel(word)
        key = _strip_prefix(word_nm, in_phrase=i != 0)
        if key in _NUMBER_WORDS:
            if word_nm.endswith("ين"):
                tags += "مجهول"
            elif word_nm.endswith("ان") or word_nm.endswith("ون"):
                tags += "مرفوع"

    out: List[str] = []
    prev_key = ""
    for i, word in enumerate(words):
        nxt = words[i + 1] if i + 1 < len(words) else ""
        key, prefix = word, ""
        if word and word != "واحد" and word[0] in _PREFIXES:
            key = word[1:]
            prefix = word[0] + ("ِ" if word[0] in _JAR_PREFIXES else "َ")
        forms = _VOC.get(key)
        if forms is None:
            out.append(prefix + key)
            prev_key = key
            continue
        two = "2" if nxt.startswith(_WAW) else ""
        if forms["s"] == "*":
            voc = prefix + forms["i"]
        elif nxt in ("عشر", "عشرة"):
            # compound numeral: unit is mabni on nasb
            voc = prefix + forms["n"]
        elif key == "عشر" and prev_key in _TEN_MASC:
            voc = "عَشَرَ"
        elif key == "عشرة" and prev_key in _TEN_FEM:
            voc = "عَشْرَةَ"
        elif "مرفوع" in tags:
            voc = prefix + forms["r" + two]
        elif "مجهول" in tags:
            voc = prefix + forms["i"]
        elif "مجرور" in tags:
            voc = prefix + forms["j" + two]
        elif "منصوب" in tags:
            voc = prefix + forms["n" + two]
        else:
            voc = prefix + forms["i"]
        out.append(voc)
        prev_key = key
    return out


def pre_tashkeel_number(words: List[str]) -> List[str]:
    """Vocalize every number phrase inside a word list."""
    tags = _tag_number_words(words)
    out: List[str] = []
    chunk: List[str] = []
    previous = ""
    context = ""
    for word, tag in zip(words, tags):
        if tag in ("DB", "DI"):
            chunk.append(word)
        else:
            if chunk:
                context = _context_tag(previous)
                out.extend(vocalize_number(chunk, context))
                chunk = []
            out.append(word)
            previous = word
    if chunk:
        out.extend(vocalize_number(chunk, context))
    return out


def _fold_digits(text: str) -> str:
    return text.translate(_DIGIT_FOLD)


def _fix_spaces(text: str) -> str:
    text = _PUNCT_SPACING.sub(
        lambda m: m.group(1).replace(" ", "") + " ", text)
    return text.strip()


def _spell_match(m: "re.Match", apply_tashkeel: bool) -> str:
    digits = m.group(0)
    if len(digits) > 12:
        # beyond milliards the scale table ends (the reference raises
        # KeyError here, mantoq/pyarabic/number.py:141-152); IDs and
        # phone numbers this long are read digit-by-digit anyway
        words = " ".join(_spell_block(int(d)) for d in digits)
    else:
        words = number2text(digits)
    if apply_tashkeel:
        return " ".join(pre_tashkeel_number(words.split(" ")))
    return words


def num2words(text: str, handle_percent: bool = True,
              apply_tashkeel: bool = True) -> str:
    """Spell every digit run in `text` as (optionally vocalized) Arabic
    words; decimal points are left as punctuation between the two runs,
    exactly like the reference (mantoq/num2words.py:8 uses ``\\d+``)."""
    text = _fold_digits(text)
    out = _DIGIT_RUN.sub(lambda m: _spell_match(m, apply_tashkeel), text)
    if handle_percent:
        rep = _PERCENT_VOCALIZED if apply_tashkeel else _PERCENT_PLAIN
        out = out.replace("%", f" {rep}")
    return _fix_spaces(out)


def arabic_num2words(number: str) -> str:
    """Digit string -> vocalized Arabic words (back-compat wrapper)."""
    return num2words(number)
