"""Korean phonemizers (reference: phoonnx/phonemizers/ko.py)."""

from phoonnx_tpu_torch.config import Alphabet
from phoonnx_tpu_torch.phonemizers.base import BasePhonemizer
from phoonnx_tpu_torch.thirdparty.hangul2ipa import hangul2ipa


class G2PKPhonemizer(BasePhonemizer):
    """g2pk pronunciation rules -> Hangul (or IPA via hangul2ipa)."""

    def __init__(self, descriptive: bool = True, group_vowels: bool = True,
                 to_syl: bool = True, alphabet: Alphabet = Alphabet.IPA):
        assert alphabet in (Alphabet.IPA, Alphabet.HANGUL)
        from g2pk import G2p

        self.g2p = G2p()
        self.descriptive = descriptive
        self.group_vowels = group_vowels
        self.to_syl = to_syl
        super().__init__(alphabet)

    @classmethod
    def get_lang(cls, target_lang: str) -> str:
        return cls.match_lang(target_lang, ["ko"])

    def phonemize_string(self, text: str, lang: str = "ko") -> str:
        self.get_lang(lang)
        pronounced = self.g2p(
            text, descriptive=self.descriptive,
            group_vowels=self.group_vowels, to_syl=self.to_syl,
        )
        if self.alphabet == Alphabet.IPA:
            return hangul2ipa(pronounced)
        return pronounced


class KoG2PPhonemizer(BasePhonemizer):
    """Bundled KoG2P rulebook engine (scarletcho/KoG2P)."""

    def __init__(self, alphabet: Alphabet = Alphabet.IPA):
        assert alphabet in (Alphabet.IPA, Alphabet.HANGUL)
        from phoonnx_tpu_torch.thirdparty.kog2p import runKoG2P

        self.g2p = runKoG2P
        super().__init__(alphabet)

    @classmethod
    def get_lang(cls, target_lang: str) -> str:
        return cls.match_lang(target_lang, ["ko"])

    def phonemize_string(self, text: str, lang: str = "ko") -> str:
        self.get_lang(lang)
        pronounced = self.g2p(text)
        if self.alphabet == Alphabet.IPA:
            return hangul2ipa(pronounced)
        return pronounced
