"""Vietnamese phonemizer (reference: phoonnx/phonemizers/vi.py)."""

from phoonnx_tpu_torch.config import Alphabet
from phoonnx_tpu_torch.phonemizers.base import BasePhonemizer


class VIPhonemePhonemizer(BasePhonemizer):
    """v-nhandt21/Viphoneme vi2IPA."""

    def __init__(self):
        from viphoneme import vi2IPA

        self.g2p = vi2IPA
        super().__init__(Alphabet.IPA)

    @classmethod
    def get_lang(cls, target_lang: str) -> str:
        return cls.match_lang(target_lang, ["vi"])

    def phonemize_string(self, text: str, lang: str = "vi") -> str:
        self.get_lang(lang)
        return self.g2p(text)
