"""Arabic phonemizer (reference: phoonnx/phonemizers/ar.py)."""

from phoonnx_tpu_torch.config import Alphabet
from phoonnx_tpu_torch.phonemizers.base import BasePhonemizer
from phoonnx_tpu_torch.thirdparty.bw2ipa import translate as bw2ipa
from phoonnx_tpu_torch.thirdparty.mantoq import g2p as mantoq_g2p


class MantoqPhonemizer(BasePhonemizer):
    """Bundled mantoq G2P: Arabic text -> Buckwalter tokens (-> IPA)."""

    def __init__(self, alphabet: Alphabet = Alphabet.BUCKWALTER):
        if alphabet not in (Alphabet.IPA, Alphabet.BUCKWALTER):
            raise ValueError("unsupported alphabet")
        super().__init__(alphabet)

    @classmethod
    def get_lang(cls, target_lang: str) -> str:
        return cls.match_lang(target_lang, ["ar"])

    def phonemize_string(self, text: str, lang: str = "ar") -> str:
        self.get_lang(lang)
        _normalized, phonemes = mantoq_g2p(text)
        phoneme_str = "".join(phonemes).replace("_+_", " ")
        if self.alphabet == Alphabet.IPA:
            return bw2ipa(phoneme_str)
        return phoneme_str
