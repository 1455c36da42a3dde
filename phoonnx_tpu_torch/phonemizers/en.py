"""English phonemizers (reference: phoonnx/phonemizers/en.py)."""

import logging
import os
from typing import Optional

from phoonnx_tpu_torch.config import Alphabet
from phoonnx_tpu_torch.phonemizers.base import BasePhonemizer
from phoonnx_tpu_torch.thirdparty.arpa2ipa import arpa_to_ipa_lookup

LOG = logging.getLogger(__name__)


class DeepPhonemizer(BasePhonemizer):
    """spring-media/DeepPhonemizer transformer G2P (en/de; en.py:10-85)."""

    MODELS = {
        "latin_ipa_forward.pt":
            "https://public-asai-dl-models.s3.eu-central-1.amazonaws.com/"
            "DeepPhonemizer/latin_ipa_forward.pt",
        "en_us_cmudict_ipa_forward.pt":
            "https://public-asai-dl-models.s3.eu-central-1.amazonaws.com/"
            "DeepPhonemizer/en_us_cmudict_ipa_forward.pt",
        "en_us_cmudict_forward.pt":
            "https://public-asai-dl-models.s3.eu-central-1.amazonaws.com/"
            "DeepPhonemizer/en_us_cmudict_forward.pt",
    }

    def __init__(self, model: Optional[str] = None):
        model = model or "latin_ipa_forward.pt"
        import dp
        import torch
        from dp.phonemizer import Phonemizer

        torch.serialization.add_safe_globals([
            dp.preprocessing.text.Preprocessor,
            dp.preprocessing.text.LanguageTokenizer,
            dp.preprocessing.text.SequenceTokenizer,
        ])
        super().__init__(
            Alphabet.IPA if "ipa" in model else Alphabet.ARPA
        )
        if not os.path.isfile(model):
            cached = os.path.join(
                os.path.expanduser("~/.local/share/deepphonemizer"), model
            )
            if not os.path.isfile(cached):
                url = self.MODELS.get(model)
                if url is None:
                    raise FileNotFoundError(
                        f"DeepPhonemizer model {model} not found and not "
                        f"a known downloadable checkpoint "
                        f"({sorted(self.MODELS)})"
                    )
                # auto-download known checkpoints on first use, like the
                # reference (en.py:35-52)
                os.makedirs(os.path.dirname(cached), exist_ok=True)
                import urllib.request

                LOG.info("downloading DeepPhonemizer model from %s", url)
                tmp = cached + ".part"
                try:
                    with urllib.request.urlopen(url, timeout=60) as resp, \
                            open(tmp, "wb") as f:
                        while True:
                            chunk = resp.read(1 << 20)
                            if not chunk:
                                break
                            f.write(chunk)
                    os.replace(tmp, cached)
                except Exception as exc:
                    if os.path.exists(tmp):
                        os.remove(tmp)
                    raise IOError(
                        f"failed to download DeepPhonemizer model from "
                        f"{url}: {exc} — place the file at {cached} "
                        "manually") from exc
            model = cached
        self.phonemizer = Phonemizer.from_checkpoint(model)

    @classmethod
    def get_lang(cls, target_lang: str) -> str:
        return cls.match_lang(target_lang, ["de", "en_us"])

    def phonemize_string(self, text: str, lang: str) -> str:
        return self.phonemizer(text, self.get_lang(lang))


class OpenPhonemizer(BasePhonemizer):
    """NeuralVox/OpenPhonemizer (en; en.py:88-136)."""

    def __init__(self):
        import dp
        import torch
        from openphonemizer import OpenPhonemizer as _OpenPhonemizer

        torch.serialization.add_safe_globals([
            dp.preprocessing.text.Preprocessor,
            dp.preprocessing.text.LanguageTokenizer,
            dp.preprocessing.text.SequenceTokenizer,
        ])
        self.phonemizer = _OpenPhonemizer()
        super().__init__(Alphabet.IPA)

    @classmethod
    def get_lang(cls, target_lang: str) -> str:
        return cls.match_lang(target_lang, ["en"])

    def phonemize_string(self, text: str, lang: str) -> str:
        self.get_lang(lang)
        return self.phonemizer(text)


class G2PEnPhonemizer(BasePhonemizer):
    """Kyubyong/g2p ARPA phonemizer, optionally mapped to IPA
    (en.py:139-187)."""

    def __init__(self, alphabet: Alphabet = Alphabet.IPA):
        assert alphabet in (Alphabet.IPA, Alphabet.ARPA)
        import nltk

        nltk.download("averaged_perceptron_tagger_eng")
        nltk.download("cmudict")
        from g2p_en import G2p

        self.g2p = G2p()
        super().__init__(alphabet)

    @classmethod
    def get_lang(cls, target_lang: str) -> str:
        return cls.match_lang(target_lang, ["en"])

    def phonemize_string(self, text: str, lang: str) -> str:
        self.get_lang(lang)
        arpa = self.g2p(text)  # g2p_en returns a token list
        if self.alphabet == Alphabet.ARPA:
            # phonemize_string must return a str — the raw list crashes
            # _process_phones' regex pass downstream
            return " ".join(arpa)
        return "".join(arpa_to_ipa_lookup.get(p, p) for p in arpa)
