"""Phonemizer framework: text -> phoneme strings grouped by sentence.

Rebuild of the reference front-end contract (phoonnx/phonemizers/base.py):
``phonemize()`` = normalize -> sentence/clause chunking -> strip punctuation
-> per-chunk ``phonemize_string`` -> espeak language-switch flag removal,
grouped per sentence. Host-side string work; the diacritizers' models
run on :attr:`BasePhonemizer.device`.

Documented divergences from the reference:

* ``phonemize("")`` returns ``[]`` (the reference returns a raw tuple list
  of the wrong type, base.py:60-61).
"""

import abc
import re
import string
import unicodedata
from typing import List, Literal, Optional, Tuple

from phoonnx_tpu_torch.config import Alphabet
from phoonnx_tpu_torch.langtags import match_lang as _match_lang
from phoonnx_tpu_torch.sentences import sentence_tokenize
# importable from here for parity with the reference's base.py namespace
# (instances are still created lazily via the properties below)
from phoonnx_tpu_torch.thirdparty.phonikud import PhonikudDiacritizer  # noqa: F401
from phoonnx_tpu_torch.thirdparty.tashkeel import TashkeelDiacritizer  # noqa: F401
from phoonnx_tpu_torch.util import normalize

# (substring, terminator, end_of_sentence)
TextChunks = List[Tuple[str, str, bool]]
RawPhonemizedChunks = List[Tuple[str, str, bool]]
PhonemizedChunks = List[List[str]]

_LANG_SWITCH_FLAG = re.compile(r"\([^)]+\)")
_PUNCT_PATTERN = re.compile(r"[" + re.escape(string.punctuation) + r"]")


class BasePhonemizer(metaclass=abc.ABCMeta):
    # where the front end's models run (the ByT5 G2P, the tashkeel and
    # phonikud diacritizers): None means the GPU, as every entry point of
    # the port; TTSVoice.load sets it to the voice's device
    device = None

    def __init__(self, alphabet: Alphabet = Alphabet.UNICODE,
                 taskeen_threshold: Optional[float] = 0.8):
        self.alphabet = alphabet
        self.taskeen_threshold = taskeen_threshold  # arabic only
        self._tashkeel = None
        self._phonikud = None

    @property
    def phonikud(self):
        if self._phonikud is None:
            from phoonnx_tpu_torch.thirdparty.phonikud import PhonikudDiacritizer

            self._phonikud = PhonikudDiacritizer(device=self.device)
        return self._phonikud

    @property
    def tashkeel(self):
        if self._tashkeel is None:
            from phoonnx_tpu_torch.thirdparty.tashkeel import TashkeelDiacritizer

            self._tashkeel = TashkeelDiacritizer(device=self.device)
        return self._tashkeel

    @abc.abstractmethod
    def phonemize_string(self, text: str, lang: str) -> str:
        """Phonemize one chunk of (already normalized) text."""
        raise NotImplementedError

    def phonemize_to_list(self, text: str, lang: str) -> List[str]:
        return list(self.phonemize_string(text, lang))

    def add_diacritics(self, text: str, lang: str) -> str:
        """Hebrew nikud / Arabic tashkeel restoration (base.py:51-56)."""
        if lang.startswith("he"):
            return self.phonikud.diacritize(text)
        if lang.startswith("ar"):
            return self.tashkeel.diacritize(text, self.taskeen_threshold)
        return text

    def phonemize(self, text: str, lang: str) -> PhonemizedChunks:
        if not text:
            return []
        results: RawPhonemizedChunks = []
        text = normalize(text, lang)
        for chunk, punct, eos in self.chunk_text(text):
            phoneme_str = self.phonemize_string(
                self.remove_punctuation(chunk), lang
            )
            # deliberately True (matching reference base.py:66): every
            # clause chunk becomes its own synthesis group, so the engine
            # sees short prosodic units — chunk_text's eos flag is kept
            # for callers that want true sentence grouping
            results.append((phoneme_str, punct, True))
        return self._process_phones(results)

    @staticmethod
    def _process_phones(raw_phones: RawPhonemizedChunks) -> PhonemizedChunks:
        """Group chunk phoneme strings into per-sentence character lists."""
        all_phonemes: PhonemizedChunks = []
        sentence_phonemes: List[str] = []
        for phonemes_str, _terminator, end_of_sentence in raw_phones:
            # Strip espeak-style (lang) switch flags around foreign words.
            phonemes_str = _LANG_SWITCH_FLAG.sub("", phonemes_str)
            sentence_phonemes.extend(list(phonemes_str))
            if end_of_sentence:
                all_phonemes.append(sentence_phonemes)
                sentence_phonemes = []
        if sentence_phonemes:
            all_phonemes.append(sentence_phonemes)
        return all_phonemes

    @staticmethod
    def match_lang(target_lang: str, valid_langs: List[str]) -> str:
        """Closest supported language or ValueError (base.py:86-122)."""
        return _match_lang(target_lang, valid_langs)

    @staticmethod
    def remove_punctuation(text: str) -> str:
        return _PUNCT_PATTERN.sub("", text).strip()

    @staticmethod
    def chunk_text(text: str, delimiters: Optional[List[str]] = None
                   ) -> TextChunks:
        """Sentence + clause chunking (base.py:135-167).

        Sentences come from the sentence tokenizer; each is further split on
        clause delimiters so the synthesizer sees short prosodic units.
        """
        if not text:
            return [("", "", True)]

        delimiters = delimiters or [", ", ":", ";", "...", "|"]
        delimiter_pattern = "|".join(re.escape(d) for d in delimiters)

        results: TextChunks = []
        for sentence in sentence_tokenize(text):
            default_punct = (
                sentence[-1]
                if sentence and sentence[-1] in string.punctuation
                else "."
            )
            parts = re.split(f"({delimiter_pattern})", sentence)
            for i in range(0, len(parts), 2):
                terminator = parts[i + 1] if i + 1 < len(parts) else default_punct
                is_last = i + 2 >= len(parts)
                results.append((parts[i].strip(), terminator.strip(), is_last))
        return results


class RawPhonemes(BasePhonemizer):
    """Identity: the input text already is phonemes (base.py:173-177)."""

    def phonemize_string(self, text: str, lang: str) -> str:
        return text


class GraphemePhonemizer(BasePhonemizer):
    """Characters-as-phonemes with light cleanup (base.py:180-208)."""

    # public name matches the reference class attribute (base.py:187)
    whitespace_re = re.compile(r"\s+")
    _drop = re.compile(r"[\<\>\(\)\[\]\"]+")

    def phonemize_string(self, text: str, lang: str) -> str:
        text = text.lower()
        text = text.replace(";", ",").replace("-", " ").replace(":", ",")
        text = self._drop.sub("", text)
        return self.whitespace_re.sub(" ", text).strip()


class UnicodeCodepointPhonemizer(BasePhonemizer):
    """Phonemes = unicode codepoints after normalization (base.py:211-222)."""

    def __init__(self, form: Literal["NFC", "NFD", "NFKC", "NFKD"] = "NFD"):
        super().__init__(Alphabet.UNICODE)
        self.form = form

    def phonemize_string(self, text: str, lang: str) -> str:
        return unicodedata.normalize(self.form, text)
