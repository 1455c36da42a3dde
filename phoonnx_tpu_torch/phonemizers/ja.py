"""Japanese phonemizers (reference: phoonnx/phonemizers/ja.py)."""

from phoonnx_tpu_torch.config import Alphabet
from phoonnx_tpu_torch.phonemizers.base import BasePhonemizer


class OpenJTaklPhonemizer(BasePhonemizer):
    """pyopenjtalk g2p (kana or romaji)."""

    def __init__(self, alphabet: Alphabet = Alphabet.KANA):
        # default must satisfy the accepted set (the reference defaults to
        # IPA and then asserts HEPBURN/KANA — its no-arg constructor
        # always crashes)
        assert alphabet in (Alphabet.HEPBURN, Alphabet.KANA)
        import pyopenjtalk

        self.g2p = pyopenjtalk.g2p
        super().__init__(alphabet)

    @classmethod
    def get_lang(cls, target_lang: str) -> str:
        return cls.match_lang(target_lang, ["ja"])

    def phonemize_string(self, text: str, lang: str = "ja") -> str:
        self.get_lang(lang)
        return self.g2p(text, kana=self.alphabet == Alphabet.KANA)


class CutletPhonemizer(BasePhonemizer):
    """cutlet romanization (hepburn/kunrei/nihon)."""

    def __init__(self, alphabet: Alphabet = Alphabet.HEPBURN,
                 use_foreign_spelling: bool = False):
        assert alphabet in (Alphabet.HEPBURN, Alphabet.KUNREI, Alphabet.NIHON)
        import cutlet

        self.g2p = cutlet.Cutlet(alphabet)
        self.g2p.use_foreign_spelling = use_foreign_spelling
        super().__init__(alphabet)

    @classmethod
    def get_lang(cls, target_lang: str) -> str:
        return cls.match_lang(target_lang, ["ja"])

    def phonemize_string(self, text: str, lang: str = "ja") -> str:
        self.get_lang(lang)
        return self.g2p.romaji(text)


class PyKakasiPhonemizer(BasePhonemizer):
    """pykakasi conversion (kana/hira/hepburn)."""

    def __init__(self, alphabet: Alphabet = Alphabet.HEPBURN):
        assert alphabet in (Alphabet.HEPBURN, Alphabet.KANA, Alphabet.HIRA)
        import pykakasi

        self.g2p = pykakasi.kakasi()
        super().__init__(alphabet)

    @classmethod
    def get_lang(cls, target_lang: str) -> str:
        return cls.match_lang(target_lang, ["ja"])

    def phonemize_string(self, text: str, lang: str = "ja") -> str:
        self.get_lang(lang)
        return " ".join(
            item[self.alphabet] for item in self.g2p.convert(text)
        )
