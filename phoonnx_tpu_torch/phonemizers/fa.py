"""Persian phonemizer (reference: phoonnx/phonemizers/fa.py)."""

from phoonnx_tpu_torch.config import Alphabet
from phoonnx_tpu_torch.phonemizers.base import BasePhonemizer


class PersianPhonemizer(BasePhonemizer):
    """de-mh/persian_phonemizer (IPA or ERAAB output)."""

    def __init__(self, alphabet: Alphabet = Alphabet.IPA):
        assert alphabet in (Alphabet.ERAAB, Alphabet.IPA)
        from persian_phonemizer import Phonemizer

        self.g2p = Phonemizer("IPA" if alphabet == Alphabet.IPA else "eraab")
        super().__init__(alphabet)

    @classmethod
    def get_lang(cls, target_lang: str) -> str:
        return cls.match_lang(target_lang, ["fa"])

    def phonemize_string(self, text: str, lang: str = "fa") -> str:
        self.get_lang(lang)
        return self.g2p.phonemize(text)
