"""Mirandese phonemizer (reference: phoonnx/phonemizers/mwl.py)."""

from phoonnx_tpu_torch.config import Alphabet
from phoonnx_tpu_torch.phonemizers.base import BasePhonemizer


class MirandesePhonemizer(BasePhonemizer):
    """mwl_phonemizer CRF model for Mirandese."""

    _LANGS = ["mwl"]

    def __init__(self):
        super().__init__(Alphabet.IPA)
        from mwl_phonemizer import CRFOrthoCorrector

        self.pho = CRFOrthoCorrector()

    @classmethod
    def get_lang(cls, target_lang: str) -> str:
        return cls.match_lang(target_lang, cls._LANGS)

    def phonemize_string(self, text: str, lang: str) -> str:
        self.get_lang(lang)
        return self.pho.phonemize_sentence(text)
