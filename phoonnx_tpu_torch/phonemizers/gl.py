"""Galician phonemizer via the cotovia TTS front-end binary.

Reference: phoonnx/phonemizers/gl.py. cotovia remains a host subprocess
(bundled C binary in the reference); its SAMPA-like output maps to IPA via
a substitution table, then a set of punctuation-normalisation regexes from
the official sabela inference script.
"""

import os
import platform
import re
import subprocess
from typing import Optional

from phoonnx_tpu_torch.config import Alphabet
from phoonnx_tpu_torch.phonemizers.base import BasePhonemizer


class CotoviaError(Exception):
    pass


# cotovia phoneme -> IPA (gl.py:15-63)
COTOVIA2IPA = {
    "pau": " ",
    "a": "a", "E": "ɛ", "e": "e", "i": "i", "j": "j", "O": "ɔ", "o": "o",
    "u": "u", "w": "w",
    "p": "p", "b": "b", "B": "β", "t": "t", "d": "d", "D": "ð", "k": "k",
    "g": "g", "G": "ɣ", "f": "f", "T": "θ", "s": "s", "S": "ʃ", "tS": "tʃ",
    "m": "m", "n": "n", "J": "ɲ", "N": "ŋ", "l": "l", "Z": "ʎ", "jj": "ʎ",
    "L": "ʎ", "r": "ɾ", "rr": "r", "X": "x",
}

_COTOVIA_PATTERN = re.compile("|".join(
    re.escape(k) for k in sorted(COTOVIA2IPA, key=len, reverse=True)))


def cotovia2ipa(text: str) -> str:
    """SINGLE-PASS longest-match substitution: sequential str.replace
    corrupted the trill — 'rr' mapped to IPA 'r' first, which the later
    'r'->'ɾ' pass rewrote to a tap, collapsing minimal pairs like
    caro/carro (divergence fix: the reference has the same cascade bug).
    """
    return _COTOVIA_PATTERN.sub(lambda m: COTOVIA2IPA[m.group(0)], text)


class CotoviaPhonemizer(BasePhonemizer):
    """Subprocess wrapper around the cotovia binary (gl.py:66-183)."""

    def __init__(self, cotovia_bin_path: Optional[str] = None,
                 alphabet: Alphabet = Alphabet.IPA):
        self.cotovia_bin = cotovia_bin_path or self.find_cotovia()
        if not os.path.exists(self.cotovia_bin):
            raise FileNotFoundError(
                f"Cotovia binary not found at {self.cotovia_bin}; install "
                "cotovia or provide the path"
            )
        super().__init__(alphabet)

    @classmethod
    def get_lang(cls, target_lang: str) -> str:
        return cls.match_lang(target_lang, ["gl-ES"])

    @staticmethod
    def find_cotovia() -> str:
        import shutil

        which = shutil.which("cotovia")  # no subprocess, no crash when
        # the external 'which' binary itself is absent
        if which and os.path.isfile(which):
            return which
        bundled = os.path.join(
            os.path.dirname(os.path.dirname(__file__)),
            "thirdparty", "cotovia", f"cotovia_{platform.machine()}",
        )
        if os.path.isfile(bundled):
            return bundled
        if os.path.isfile("/usr/bin/cotovia"):
            return "/usr/bin/cotovia"
        return "cotovia"

    def phonemize_string(self, text: str, lang: str) -> str:
        self.get_lang(lang)
        # Input goes in as utf-8 (like the reference's `echo | cotovia`);
        # cotovia answers in latin-1 (the reference pipes through iconv).
        try:
            proc = subprocess.run(
                [self.cotovia_bin, "-t", "-n", "-S"],
                input=text.encode("utf-8"),
                capture_output=True, check=True,
            )
        except subprocess.CalledProcessError as exc:
            raise CotoviaError(
                f"cotovia failed ({exc.returncode}): "
                f"{exc.stderr.decode('iso-8859-1', 'replace')}") from None
        out = proc.stdout.decode("iso-8859-1").strip()

        # Punctuation fixes from the official inference script (gl.py:146-179)
        out = re.sub(r" ·", r"...", out)
        out = re.sub(r"\s+([.,!?;:)\]])", r"\1", out)
        out = re.sub(r"([\(\[¡¿])\s+", r"\1", out)
        out = re.sub(r'"\s*([^"]*?)\s*"', r'"\1"', out)
        out = re.sub(r"-\s*([^-]*?)\s*-", r"-\1-", out)
        out = re.sub(r"[¿¡]", r"", out)
        out = re.sub(r"\s+", r" ", out)
        out = re.sub(r"(\d+)\s*-\s*(\d+)", r"\1 \2", out)
        # the reference writes r"\1, \\2, " (gl.py:173,179) — a literal
        # backslash+'2' that deletes the captured clause and injects '\2'
        # into the phoneme stream; the intended group reference is \2
        out = re.sub(r"(\w+)\s+-([^-]*?)-\s+([^-]*?)", r"\1, \2, ", out)
        out = re.sub(r"(\w+[!\?]?)\s+-\s*", r"\1, ", out)
        out = re.sub(r"(\w+)\s*\(\s*([^\(\)]*?)\s*\)", r"\1, \2,", out)

        if self.alphabet == Alphabet.IPA:
            return cotovia2ipa(out)
        return out
