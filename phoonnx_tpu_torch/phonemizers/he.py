"""Hebrew phonemizer (reference: phoonnx/phonemizers/he.py)."""

from phoonnx_tpu_torch.config import Alphabet
from phoonnx_tpu_torch.phonemizers.base import BasePhonemizer


class PhonikudPhonemizer(BasePhonemizer):
    """phonikud G2P for diacritized Hebrew."""

    def __init__(self):
        from phonikud import phonemize

        self.g2p = phonemize
        super().__init__(Alphabet.IPA)

    @classmethod
    def get_lang(cls, target_lang: str) -> str:
        return cls.match_lang(target_lang, ["he"])

    def phonemize_string(self, text: str, lang: str = "he") -> str:
        self.get_lang(lang)
        return self.g2p(text)
