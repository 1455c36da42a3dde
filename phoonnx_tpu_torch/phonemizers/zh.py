"""Chinese phonemizers (reference: phoonnx/phonemizers/zh.py)."""

import abc
from typing import List

from phoonnx_tpu_torch.config import Alphabet
from phoonnx_tpu_torch.phonemizers.base import BasePhonemizer
from phoonnx_tpu_torch.thirdparty.zh_num import num2str


class JiebaPhonemizer(BasePhonemizer):
    """Word segmentation only — hanzi pass through with spaces."""

    def __init__(self):
        super().__init__(Alphabet.HANZI)

    @classmethod
    def get_lang(cls, target_lang: str) -> str:
        return cls.match_lang(target_lang, ["zh"])

    def phonemize_string(self, text: str, lang: str = "zh") -> str:
        import jieba

        self.get_lang(lang)
        words = [
            num2str(w) if w.isdigit() else w
            for w in jieba.cut(text, cut_all=False)
        ]
        return " ".join(words)


class BaseChinesePinyinPhonemizer(BasePhonemizer):
    """Shared pinyin pipeline: segment -> pinyin -> (optional) IPA + tone
    arrows (zh.py:53-169)."""

    def __init__(self, alphabet: Alphabet = Alphabet.PINYIN,
                 jieba: bool = True, retone: bool = True):
        assert alphabet in (Alphabet.PINYIN, Alphabet.IPA)
        super().__init__(alphabet)
        self.jieba = jieba
        self.retone = retone
        from pinyin_to_ipa import pinyin_to_ipa

        self.pinyin_to_ipa = pinyin_to_ipa

    @classmethod
    def get_lang(cls, target_lang: str) -> str:
        return cls.match_lang(target_lang, ["zh"])

    @staticmethod
    def _retone(p: str) -> str:
        """Replace tone-contour letters with arrow marks (zh.py:91-99)."""
        p = p.replace("˧˩˧", "↓")   # third tone
        p = p.replace("˧˥", "↗")    # second tone
        p = p.replace("˥˩", "↘")    # fourth tone
        p = p.replace("˥", "→")     # first tone
        p = p.replace(chr(635) + chr(809), "ɨ").replace(
            chr(633) + chr(809), "ɨ"
        )
        assert chr(809) not in p, p
        return p

    def to_ipa(self, phones: List[str]) -> List[str]:
        ipa_phones: List[str] = []
        for p in phones:
            if p == " ":
                ipa_phones.append(" ")
                continue
            pho_str = ""
            for syllable in p.split():
                try:
                    # pinyin_to_ipa returns an ordered set of candidate
                    # pronunciations, each a tuple of IPA symbols — join
                    # the full first candidate. (The reference takes
                    # [0][0], keeping only the first symbol and dropping
                    # vowel + tone contour; its own _retone tone-mark
                    # substitutions presuppose the full syllable.)
                    pho = "".join(self.pinyin_to_ipa(syllable.strip())[0])
                    if self.retone:
                        pho = self._retone(pho)
                    pho_str += pho
                except Exception:
                    pass
            ipa_phones.append(pho_str)
        return ipa_phones

    def phonemize_to_list(self, text: str, lang: str) -> List[str]:
        self.get_lang(lang)
        phones: List[str] = []
        if self.jieba:
            import jieba

            for chunk in jieba.cut(text, cut_all=False):
                if chunk.isdigit():
                    chunk = num2str(chunk)
                phones += self.get_pinyin(chunk)
                phones += [" "]
        else:
            phones = self.get_pinyin(text)
        if self.alphabet == Alphabet.IPA:
            phones = self.to_ipa(phones)
        return phones

    def phonemize_string(self, text: str, lang: str = "zh") -> str:
        return "".join(self.phonemize_to_list(text, lang))

    @abc.abstractmethod
    def get_pinyin(self, text: str) -> List[str]:
        raise NotImplementedError


class G2pCPhonemizer(BaseChinesePinyinPhonemizer):
    """g2pc CRF G2P."""

    def __init__(self, alphabet: Alphabet = Alphabet.PINYIN,
                 jieba: bool = True):
        from g2pc import G2pC

        self.g2p = G2pC()
        super().__init__(alphabet, jieba)

    def get_pinyin(self, text: str) -> List[str]:
        return [entry[3] for entry in self.g2p(text)]


class G2pMPhonemizer(BaseChinesePinyinPhonemizer):
    """kakaobrain/g2pM neural G2P."""

    def __init__(self, alphabet: Alphabet = Alphabet.PINYIN,
                 tone: bool = True, char_split: bool = False,
                 jieba: bool = True):
        from g2pM import G2pM

        self.g2p = G2pM()
        self.tone = tone
        self.char_split = char_split
        super().__init__(alphabet, jieba)

    def get_pinyin(self, text: str) -> List[str]:
        return self.g2p(text, tone=self.tone, char_split=self.char_split)


class XpinyinPhonemizer(BaseChinesePinyinPhonemizer):
    """xpinyin lookup-based pinyin."""

    def __init__(self, alphabet: Alphabet = Alphabet.PINYIN,
                 tone_marks: str = "numbers", jieba: bool = True):
        from xpinyin import Pinyin

        self.g2p = Pinyin()
        self.tone_marks = tone_marks
        super().__init__(alphabet, jieba)

    def get_pinyin(self, text: str) -> List[str]:
        return self.g2p.get_pinyin(text, tone_marks=self.tone_marks).split("-")


class PypinyinPhonemizer(BaseChinesePinyinPhonemizer):
    """pypinyin pinyin generator."""

    def __init__(self, alphabet: Alphabet = Alphabet.PINYIN,
                 jieba: bool = True):
        from pypinyin import pinyin

        self.g2p = pinyin
        super().__init__(alphabet, jieba)

    def get_pinyin(self, text: str) -> List[str]:
        return [p[0] for p in self.g2p(text)]
