"""Korean grapheme-to-phone rule engine (capability match for KoG2P).

Rebuild of phoonnx/thirdparty/kog2p (scarletcho/KoG2P): hangul syllables
are decomposed arithmetically into romanized phones, a regex rulebook
(``rulebook.txt``, shipped data) is applied to a fixpoint, and the result
maps back to hangul jamo for downstream hangul2ipa conversion.
"""

import os
import re
from functools import lru_cache
from typing import List, Tuple

_RULEBOOK = os.path.join(os.path.dirname(__file__), "rulebook.txt")

# Romanization inventories (Korean Spontaneous Speech corpus conventions)
ONSETS = ['k0', 'kk', 'nn', 't0', 'tt', 'rr', 'mm', 'p0', 'pp',
          's0', 'ss', 'oh', 'c0', 'cc', 'ch', 'kh', 'th', 'ph', 'h0']
NUCLEI = ['aa', 'qq', 'ya', 'yq', 'vv', 'ee', 'yv', 'ye', 'oo', 'wa',
          'wq', 'wo', 'yo', 'uu', 'wv', 'we', 'wi', 'yu', 'xx', 'xi', 'ii']
CODAS = ['', 'kf', 'kk', 'ks', 'nf', 'nc', 'nh', 'tf',
         'll', 'lk', 'lm', 'lb', 'ls', 'lt', 'lp', 'lh',
         'mf', 'pf', 'ps', 's0', 'ss', 'oh', 'c0', 'ch',
         'kh', 'th', 'ph', 'h0']

KOG2P_TO_HANGUL = {
    # onsets
    'p0': 'ㅂ', 'ph': 'ㅍ', 'pp': 'ㅃ', 't0': 'ㄷ', 'th': 'ㅌ', 'tt': 'ㄸ',
    'k0': 'ㄱ', 'kh': 'ㅋ', 'kk': 'ㄲ', 's0': 'ㅅ', 'ss': 'ㅆ', 'h0': 'ㅎ',
    'c0': 'ㅈ', 'ch': 'ㅊ', 'cc': 'ㅉ', 'mm': 'ㅁ', 'nn': 'ㄴ', 'rr': 'ㄹ',
    # codas
    'pf': 'ㅂ', 'tf': 'ㄷ', 'kf': 'ㄱ', 'mf': 'ㅁ', 'nf': 'ㄴ', 'ng': 'ㅇ',
    'll': 'ㄹ', 'ks': 'ㄱㅅ', 'nc': 'ㄴㅈ', 'nh': 'ㄴㅎ', 'lk': 'ㄹㄱ',
    'lm': 'ㄹㅁ', 'lb': 'ㄹㅂ', 'ls': 'ㄹㅅ', 'lt': 'ㄹㅌ', 'lp': 'ㄹㅍ',
    'lh': 'ㄹㅎ', 'ps': 'ㅂㅅ',
    # monophthongs
    'ii': 'ㅣ', 'ee': 'ㅔ', 'qq': 'ㅐ', 'aa': 'ㅏ', 'xx': 'ㅡ', 'vv': 'ㅓ',
    'uu': 'ㅜ', 'oo': 'ㅗ',
    # diphthongs
    'ye': 'ㅖ', 'yq': 'ㅒ', 'ya': 'ㅑ', 'yv': 'ㅕ', 'yu': 'ㅠ', 'yo': 'ㅛ',
    'wi': 'ㅟ', 'wo': 'ㅚ', 'wq': 'ㅙ', 'we': 'ㅞ', 'wa': 'ㅘ', 'wv': 'ㅝ',
    'xi': 'ㅢ',
}

_HANGUL_BASE = 44032
_HANGUL_END = 55203


@lru_cache(maxsize=4)
def read_rules(rulebook: str) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    rule_in: List[str] = []
    rule_out: List[str] = []
    with open(rulebook, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            parts = line.split("\t")
            rule_in.append(parts[0])
            rule_out.append(parts[1] if len(parts) > 1 and parts[1] else "")
    return tuple(rule_in), tuple(rule_out)


def graph2phone(graphs: str) -> str:
    """Hangul -> romanized phone string with '-' syllable delimiters."""
    phones = ""
    for ch in graphs:
        code = ord(ch)
        if code == 32:
            phones += "#"
        elif _HANGUL_BASE <= code <= _HANGUL_END:
            offset = code - _HANGUL_BASE
            onset = ONSETS[offset // 588]
            nucleus = NUCLEI[(offset % 588) // 28]
            coda = CODAS[offset % 28]
            phones += "-" + onset + nucleus + coda
        # non-hangul characters are dropped (same as the reference)
        phones = re.sub("-(oh)", "-", phones)

    # silent onset ㅇ deletion / velar-nasal coda handling
    phones = re.sub("^oh", "", phones)
    phones = re.sub("-(oh)", "", phones)
    phones = re.sub("oh-", "ng-", phones)
    phones = re.sub("oh([# ]|$)", r"ng", phones)

    phones = re.sub(r"(\W+)\-", r"\1", phones)
    phones = re.sub(r"\W+$", "", phones)
    phones = re.sub(r"^\-", "", phones)
    return phones


def _add_phone_boundaries(phones: str) -> str:
    """Comma after every two-letter phone so rules see token boundaries."""
    out = ""
    pos = 0
    while pos + 2 <= len(phones):
        if phones[pos] == "-":
            out += phones[pos]
            pos += 1
        elif phones[pos] == " ":
            pos += 1
        elif phones[pos] == "#":
            out += phones[pos]
            pos += 1
        out += phones[pos:pos + 2] + ","
        pos += 2
    return out


def _apply_rules(phones: str, rule_in, rule_out) -> str:
    for pattern, replacement in zip(rule_in, rule_out):
        phones = re.sub(pattern, replacement, phones)
    return phones


def graph2prono(graphs: str, rule_in, rule_out) -> str:
    """Graphemes -> pronunciation phones, applying rules to a fixpoint."""
    prono = _apply_rules(
        _add_phone_boundaries(graph2phone(graphs)), rule_in, rule_out
    )
    prono = re.sub(",", " ", prono)
    prono = re.sub(" $", "", prono)
    prono = re.sub("#", "-", prono)
    prono = re.sub("-+", "-", prono)

    while True:
        prono_new = _apply_rules(
            re.sub(" ", ",", prono + ","), rule_in, rule_out
        )
        prono_new = re.sub(",", " ", prono_new)
        prono_new = re.sub(" $", "", prono_new)
        if re.sub("-", "", prono) == re.sub("-", "", prono_new):
            return re.sub("-", "", prono_new)
        prono = prono_new


def runKoG2P(graph: str, rulebook: str = None) -> str:
    """Korean text -> pronounced hangul-jamo string (word separated)."""
    rule_in, rule_out = read_rules(rulebook or _RULEBOOK)
    words = []
    for word in graph.split():
        phones = graph2prono(word, rule_in, rule_out).split()
        words.append("".join(KOG2P_TO_HANGUL[p] for p in phones))
    return " ".join(words)
