"""Multilingual phonemizers: espeak, ByT5/Charsiu (on the GPU), gruut,
goruut, epitran, misaki, transphone.

Port of ``phoonnx_tpu/phonemizers/mul.py`` (a rebuild of
phoonnx/phonemizers/mul.py), verbatim but for where ``ByT5Phonemizer``
builds its engine. External G2P libraries are optional imports; the
espeak and cotovia engines remain host subprocesses (CPU string work,
bit-identical requirement). The ByT5/Charsiu neural G2P runs on the
phonemizer's ``device`` via :mod:`phoonnx_tpu_torch.models.byt5` instead
of an onnxruntime decode loop.
"""

import json
import logging
import os
import subprocess
from typing import Dict, List, Optional

from phoonnx_tpu_torch.config import Alphabet
from phoonnx_tpu_torch.phonemizers.base import BasePhonemizer

LOG = logging.getLogger(__name__)


class EspeakError(Exception):
    pass


class EspeakPhonemizer(BasePhonemizer):
    """IPA phonemization via the espeak-ng CLI (mul.py:291-382).

    Host subprocess — espeak-ng is a C binary; keeping it external preserves
    bit-identical phoneme strings with the reference.
    """

    ESPEAK_LANGS = [
        'es-419', 'ca', 'qya', 'ga', 'et', 'ky', 'io', 'fa-latn', 'en-gb',
        'fo', 'haw', 'kl', 'ta', 'ml', 'gd', 'sd', 'es', 'hy', 'ur', 'ro',
        'hi', 'or', 'ti', 'ca-va', 'om', 'tr', 'pa', 'smj', 'mk', 'bg', 'cv',
        'fr', 'fi', 'en-gb-x-rp', 'ru', 'mt', 'an', 'mr', 'pap', 'vi', 'id',
        'fr-be', 'ltg', 'my', 'nl', 'shn', 'ba', 'az', 'cmn', 'da', 'as',
        'sw', 'piqd', 'en-us', 'hr', 'it', 'ug', 'th', 'mi', 'cy', 'ru-lv',
        'ia', 'tt', 'hu', 'xex', 'te', 'ne', 'eu', 'ja', 'bpy', 'hak', 'cs',
        'en-gb-scotland', 'hyw', 'uk', 'pt', 'bn', 'mto', 'yue', 'be', 'gu',
        'sv', 'sl', 'cmn-latn-pinyin', 'lfn', 'lv', 'fa', 'sjn', 'nog', 'ms',
        'vi-vn-x-central', 'lt', 'kn', 'he', 'qu', 'ca-ba', 'quc', 'nb',
        'sk', 'tn', 'py', 'si', 'de', 'ar', 'en-gb-x-gbcwmd', 'bs', 'qdb',
        'sq', 'sr', 'tk', 'en-029', 'ht', 'ru-cl', 'af', 'pt-br', 'fr-ch',
        'ka', 'en-gb-x-gbclan', 'ko', 'is', 'ca-nw', 'gn', 'kok', 'la',
        'lb', 'am', 'kk', 'ku', 'kaa', 'jbo', 'eo', 'uz', 'nci',
        'vi-vn-x-south', 'el', 'pl', 'grc',
    ]

    def __init__(self):
        super().__init__(Alphabet.IPA)

    @classmethod
    def get_lang(cls, target_lang: str) -> str:
        if target_lang.lower() == "en-gb":
            return "en-gb-x-rp"  # RP accent, as the reference picks
        if target_lang in cls.ESPEAK_LANGS:
            return target_lang
        if target_lang.lower().split("-")[0] in cls.ESPEAK_LANGS:
            return target_lang.lower().split("-")[0]
        return cls.match_lang(target_lang, cls.ESPEAK_LANGS)

    @staticmethod
    def _run(args: List[str], input_text: Optional[str] = None) -> str:
        command = ["espeak-ng"] + args
        try:
            proc = subprocess.run(
                command, input=input_text, capture_output=True, text=True,
                check=True, encoding="utf-8", errors="replace",
            )
            return proc.stdout.strip()
        except FileNotFoundError:
            raise EspeakError(
                "espeak-ng command not found; install espeak-ng and ensure "
                "it is on PATH"
            ) from None
        except subprocess.CalledProcessError as exc:
            raise EspeakError(
                f"espeak-ng failed ({exc.returncode}): {exc.stderr}"
            ) from None

    def phonemize_string(self, text: str, lang: str) -> str:
        lang = self.get_lang(lang)
        return self._run(["-q", "-x", "--ipa", "-v", lang], input_text=text)


class ByT5Phonemizer(BasePhonemizer):
    """Byte-level T5 G2P on the phonemizer's ``device`` (mul.py:21-236).

    The reference re-runs the entire ONNX decoder per generated token
    (mul.py:201-230, up to 512 session.run calls per chunk). The port
    runs a greedy decode with KV caching instead — see
    phoonnx_tpu_torch/models/byt5.py.
    """

    BYT5_LANGS = [
        'ca-ES', 'cy-GB', 'da-DK', 'de-DE', 'en-GB', 'en-US', 'es-ES',
        'et-EE', 'eu-ES', 'fa-IR', 'fr-FR', 'ga-IE', 'hr-HR', 'hu-HU',
        'id-ID', 'is-IS', 'it-IT', 'ja-JP', 'ko-KR', 'nb-NO', 'nl-NL',
        'pl-PL', 'pt-BR', 'pt-PT', 'qu-PE', 'ro-RO', 'sr-RS', 'sv-SE',
        'tr-TR', 'yue-CN', 'zh-CN',
    ]

    DEFAULT_MODEL = "OpenVoiceOS/g2p-mbyt5-12l-ipa-childes-espeak-onnx"

    def __init__(self, model: Optional[str] = None,
                 tokenizer_config: Optional[str] = None,
                 dtype: Optional[str] = None):
        """dtype: "bfloat16" halves G2P decode HBM traffic (the decode is
        weight-bandwidth bound; logits still argmax in f32). Defaults to
        the PHOONNX_G2P_DTYPE env var, else float32."""
        super().__init__(Alphabet.IPA)
        self.model_path = self._resolve_model(model)
        self.tokenizer_config = tokenizer_config
        self.dtype = dtype or os.environ.get("PHOONNX_G2P_DTYPE",
                                             "float32")
        self._engine = None
        self._special_tokens: Dict[str, int] = {}
        if tokenizer_config and os.path.exists(tokenizer_config):
            with open(tokenizer_config, "r", encoding="utf-8") as f:
                self._special_tokens = json.load(f).get(
                    "added_tokens_decoder", {}
                )

    # model name -> checkpoint URL (reference mul.py:25-29); downloads go
    # to ~/.local/share/phoonnx like the reference
    MODEL2URL = {
        "OpenVoiceOS/g2p-mbyt5-12l-ipa-childes-espeak-onnx":
            "https://huggingface.co/OpenVoiceOS/"
            "g2p-mbyt5-12l-ipa-childes-espeak-onnx/resolve/main/"
            "fdemelo_g2p-mbyt5-12l-ipa-childes-espeak.onnx",
    }

    @classmethod
    def _resolve_model(cls, model: Optional[str]) -> Optional[str]:
        model = model or cls.DEFAULT_MODEL  # subclass defaults apply
        if os.path.exists(model):
            return model
        data_path = os.path.expanduser("~/.local/share/phoonnx")
        candidate = os.path.join(data_path, model)
        if os.path.isdir(candidate):
            for name in os.listdir(candidate):
                if name.endswith(".onnx"):
                    return os.path.join(candidate, name)
            # empty cache dir (e.g. an interrupted download): fall through
            # to the model NAME so the engine property can re-download
        elif os.path.exists(candidate):
            return candidate
        return model  # resolved lazily; engine load reports a clear error

    @classmethod
    def _download_model(cls, model: str) -> str:
        """Fetch a known checkpoint to the local data dir (the reference
        auto-downloads on first use, mul.py:69-81)."""
        url = cls.MODEL2URL[model]
        base = os.path.join(os.path.expanduser("~/.local/share/phoonnx"),
                            model)
        os.makedirs(base, exist_ok=True)
        target = os.path.join(base, url.rsplit("/", 1)[-1])
        if os.path.exists(target):
            return target
        import urllib.request

        LOG.info("downloading ByT5 G2P model from %s", url)
        tmp = target + ".part"
        try:
            with urllib.request.urlopen(url, timeout=60) as resp, \
                    open(tmp, "wb") as f:
                while True:
                    chunk = resp.read(1 << 20)
                    if not chunk:
                        break
                    f.write(chunk)
            os.replace(tmp, target)
        except Exception as exc:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise IOError(
                f"failed to download ByT5 G2P model from {url}: {exc} — "
                f"download it manually and pass model=<path>"
            ) from exc
        return target

    @property
    def engine(self):
        if self._engine is None:
            from phoonnx_tpu_torch.models.byt5 import ByT5Engine

            model_path = self.model_path
            if (model_path is not None and not os.path.exists(model_path)
                    and model_path in self.MODEL2URL):
                model_path = self._download_model(model_path)
                self.model_path = model_path
            self._engine = ByT5Engine.from_onnx(model_path,
                                                dtype=self.dtype,
                                                device=self.device)
        return self._engine

    @classmethod
    def get_lang(cls, target_lang: str) -> str:
        return cls.match_lang(target_lang, cls.BYT5_LANGS)

    @staticmethod
    def encode_text(text: str, lang: str) -> List[int]:
        """Byte-level ids: utf-8 bytes of '<lang>: text' shifted by 3
        (pad/eos/unk occupy 0..2), mul.py:147-165."""
        encoded = f"<{lang}>: {text}".encode("utf-8")
        return [b + 3 for b in encoded]

    def decode_phones(self, token_ids: List[int]) -> str:
        """ids -> utf-8 phoneme string (ids-3), skipping special tokens."""
        phone_bytes = [
            bytes([token - 3]) for token in token_ids
            if 3 <= token < 259 and str(token) not in self._special_tokens
        ]
        return b"".join(phone_bytes).decode("utf-8", errors="ignore")

    def phonemize_string(self, text: str, lang: str) -> str:
        if not text.strip():
            return ""
        lang = self.get_lang(lang)
        ids = self.encode_text(text, lang)
        generated = self.engine.greedy_decode(ids)
        return self.decode_phones(generated)


class CharsiuPhonemizer(ByT5Phonemizer):
    """CharsiuG2P variant of ByT5; decodes word-by-word because the model
    cannot handle whitespace (mul.py:239-288)."""

    DEFAULT_MODEL = (
        "Jarbas/charsiu_g2p_multilingual_byT5_tiny_16_layers_100_onnx"
    )
    MODEL2URL = {
        DEFAULT_MODEL:
            "https://huggingface.co/Jarbas/"
            "charsiu_g2p_multilingual_byT5_tiny_16_layers_100_onnx/"
            "resolve/main/"
            "charsiu_g2p_multilingual_byT5_tiny_16_layers_100.onnx",
    }

    CHARSIU_LANGS = [
        'ady', 'afr', 'sqi', 'amh', 'ara', 'arg', 'arm-e', 'arm-w', 'aze',
        'bak', 'eus', 'bel', 'ben', 'bos', 'bul', 'bur', 'cat', 'yue',
        'zho-t', 'zho-s', 'min', 'cze', 'dan', 'dut', 'eng-uk', 'eng-us',
        'epo', 'est', 'fin', 'fra', 'fra-qu', 'gla', 'geo', 'ger', 'gre',
        'grc', 'grn', 'guj', 'hin', 'hun', 'ido', 'ind', 'ina', 'ita',
        'jam', 'jpn', 'kaz', 'khm', 'kor', 'kur', 'lat-clas', 'lat-eccl',
        'lit', 'ltz', 'mac', 'mlt', 'tts', 'nob', 'ori', 'pap', 'fas',
        'pol', 'por-po', 'por-bz', 'ron', 'rus', 'san', 'srp', 'hbs-latn',
        'hbs-cyrl', 'snd', 'slo', 'slv', 'spa', 'spa-latin', 'spa-me',
        'swa', 'swe', 'tgl', 'tam', 'tat', 'tha', 'tur', 'tuk', 'ukr',
        'vie-n', 'vie-c', 'vie-s', 'wel-nw', 'wel-sw', 'ice', 'ang', 'gle',
        'enm', 'syc', 'glg', 'sme', 'egy',
    ]

    @classmethod
    def get_lang(cls, target_lang: str) -> str:
        return cls.match_lang(target_lang, cls.CHARSIU_LANGS)

    def phonemize_string(self, text: str, lang: str) -> str:
        if not text.strip():
            return ""
        lang = self.get_lang(lang)
        words = text.split()
        # all words decode as one batched device program
        batch = [ByT5Phonemizer.encode_text(w, lang) for w in words]
        results = self.engine.greedy_decode_batch(batch)
        return " ".join(self.decode_phones(ids) for ids in results)


class GruutPhonemizer(BasePhonemizer):
    """gruut-library IPA phonemizer (mul.py:385-436)."""

    GRUUT_LANGS = ["en", "ar", "ca", "cs", "de", "es", "fa", "fr", "it",
                   "lb", "nl", "pt", "ru", "sv", "sw"]

    def __init__(self):
        super().__init__(Alphabet.IPA)

    @classmethod
    def get_lang(cls, target_lang: str) -> str:
        return cls.match_lang(target_lang, cls.GRUUT_LANGS)

    def phonemize_string(self, text: str, lang: str) -> str:
        import gruut

        lang = self.get_lang(lang)
        out = ""
        for sentence in gruut.sentences(text, lang=lang):
            sent_phonemes = [w.phonemes for w in sentence if w.phonemes]
            if sentence and not sent_phonemes:
                raise RuntimeError(f"did you install gruut[{lang}] ?")
            if sentence.text.endswith("?"):
                sent_phonemes[-1] = ["?"]
            elif sentence.text.endswith("!"):
                sent_phonemes[-1] = ["!"]
            elif sentence.text.endswith(".") or sent_phonemes[-1] == ["‖"]:
                sent_phonemes[-1] = ["."]
            if sent_phonemes:
                out += " ".join("".join(w) for w in sent_phonemes) + " "
        return out.strip()


class GoruutPhonemizer(BasePhonemizer):
    """pygoruut IPA phonemizer with an optional remote API (mul.py:439-617).

    goruut addresses languages by English name; the ISO639 map and the
    non-standard variant names mirror the reference inventory."""

    GORUUT_LANGS_NON_STD = [
        'BengaliDhaka', 'BengaliRahr', 'MalayArab', 'VietnameseCentral',
        'VietnameseSouthern', 'EnglishAmerican', 'EnglishBritish',
        'NahuatlClassical', 'Hebrew2', 'Hebrew3', 'MinnanTawianese',
        'MinnanHokkien', 'MinnanTawianese2', 'MinnanHokkien2',
    ]
    ISO639 = {
        "af": "Afrikaans",
        "am": "Amharic",
        "ar": "Arabic",
        "az": "Azerbaijani",
        "be": "Belarusian",
        "bn": "Bengali",
        "my": "Burmese",
        "ceb": "Cebuano",
        "ce": "Chechen",
        "zh": "ChineseMandarin",
        "cs": "Czech",
        "da": "Danish",
        "nl": "Dutch",
        "dz": "Dzongkha",
        "en": "English",
        "eo": "Esperanto",
        "fa": "Farsi",
        "fi": "Finnish",
        "fr": "French",
        "de": "German",
        "el": "Greek",
        "gu": "Gujarati",
        "ha": "Hausa",
        "he": "Hebrew",
        "hi": "Hindi",
        "hu": "Hungarian",
        "is": "Icelandic",
        "id": "Indonesian",
        "tts": "Isan",
        "it": "Italian",
        "jam": "Jamaican",
        "ja": "Japanese",
        "jv": "Javanese",
        "kk": "Kazakh",
        "ko": "Korean",
        "lb": "Luxembourgish",
        "mk": "Macedonian",
        "ml": "Malayalam",
        "ms": "MalayLatin",
        "mt": "Maltese",
        "mr": "Marathi",
        "mn": "Mongolian",
        "ne": "Nepali",
        "no": "Norwegian",
        "ps": "Pashto",
        "pl": "Polish",
        "pt": "Portuguese",
        "pa": "Punjabi",
        "ro": "Romanian",
        "ru": "Russian",
        "sk": "Slovak",
        "es": "Spanish",
        "sw": "Swahili",
        "sv": "Swedish",
        "ta": "Tamil",
        "te": "Telugu",
        "th": "Thai",
        "bo": "Tibetan",
        "tr": "Turkish",
        "uk": "Ukrainian",
        "ur": "Urdu",
        "ug": "Uyghur",
        "vi": "VietnameseNorthern",
        "zu": "Zulu",
        "hy": "Armenian",
        "eu": "Basque",
        "bg": "Bulgarian",
        "ca": "Catalan",
        "ny": "Chichewa",
        "hr": "Croatian",
        "et": "Estonian",
        "gl": "Galician",
        "ka": "Georgian",
        "km": "KhmerCentral",
        "lo": "Lao",
        "lv": "Latvian",
        "lt": "Lithuanian",
        "sr": "Serbian",
        "tl": "Tagalog",
        "yo": "Yoruba",
        "sq": "Albanian",
        "an": "Aragonese",
        "as": "Assamese",
        "ba": "Bashkir",
        "bpy": "BishnupriyaManipuri",
        "bs": "Bosnian",
        "chr": "Cherokee",
        "cu": "Chuvash",
        "gla": "GaelicScottish",
        "gle": "GaelicIrish",
        "kl": "Greenlandic",
        "gn": "Guarani",
        "ht": "HaitianCreole",
        "haw": "Hawaiian",
        "io": "Ido",
        "ia": "Interlingua",
        "kn": "Kannada",
        "quc": "Kiche",
        "kok": "Konkani",
        "ku": "Kurdish",
        "ky": "Kyrgyz",
        "qdb": "LangBelta",
        "ltg": "Latgalian",
        "la": "LatinClassical",
        "lat": "LatinEcclesiastical",
        "lfn": "LinguaFrancaNova",
        "jbo": "Lojban",
        "smj": "LuleSaami",
        "mi": "Maori",
        "nah": "NahuatlCentral",
        "nci": "NahuatlMecayapan",
        "ncz": "NahuatlTetelcingo",
        "nog": "Nogai",
        "om": "Oromo",
        "pap": "Papiamento",
        "qu": "Quechua",
        "qya": "Quenya",
        "tn": "Setswana",
        "shn": "ShanTaiYai",
        "sjn": "Sindarin",
        "sd": "Sindhi",
        "si": "Sinhala",
        "sl": "Slovenian",
        "tt": "Tatar",
        "tk": "Turkmen",
        "uz": "Uzbek",
        "cyw": "WelshNorth",
        "cys": "WelshSouth",
        "yue": "Cantonese",
    }

    def __init__(self, remote_url: Optional[str] = None):
        super().__init__(Alphabet.IPA)
        from pygoruut.pygoruut import Pygoruut

        if remote_url is not None:
            self.pygoruut = Pygoruut(api=remote_url)
        else:
            self.pygoruut = Pygoruut()

    @classmethod
    def get_lang(cls, target_lang: str) -> str:
        if target_lang in cls.GORUUT_LANGS_NON_STD:
            return target_lang
        if target_lang.lower() == "en-us":
            return "EnglishAmerican"
        if target_lang.lower() in ("en-gb", "en-uk"):
            return "EnglishBritish"
        lang = cls.match_lang(target_lang, list(cls.ISO639))
        return cls.ISO639[lang]

    def phonemize_string(self, text: str, lang: str) -> str:
        lang = self.get_lang(lang)
        return str(self.pygoruut.phonemize(language=lang, sentence=text))


class EpitranPhonemizer(BasePhonemizer):
    """epitran transliteration-based phonemizer (mul.py:620-672)."""

    # the installed epitran build's inventory, transcribed from the
    # reference VERBATIM (mul.py:623-642) — a trimmed list broke 73
    # reference-supported languages (fin/hrv/lav/kat/khm/uig/...)
    # and silently resolved Cantonese ('yue') to Mandarin
    EPITRAN_LANGS = [
        'hsn-Latn', 'ful-Latn', 'jpn-Ktkn-red', 'tel-Telu', 'nld-Latn',
        'aze-Latn', 'amh-Ethi-pp', 'msa-Latn', 'spa-Latn-eu', 'ori-Orya',
        'bxk-Latn', 'spa-Latn', 'kir-Cyrl', 'lij-Latn', 'kin-Latn',
        'ces-Latn', 'sin-Sinh', 'urd-Arab', 'vie-Latn', 'gan-Latn',
        'fra-Latn', 'nan-Latn', 'kaz-Latn', 'swe-Latn', 'jpn-Ktkn',
        'tam-Taml', 'sag-Latn', 'csb-Latn', 'pii-latn_Holopainen2019',
        'yue-Latn', 'got-Latn', 'tur-Latn', 'aar-Latn', 'jav-Latn',
        'ita-Latn', 'sna-Latn', 'ilo-Latn', 'tam-Taml-red', 'kmr-Latn-red',
        'uzb-Cyrl', 'amh-Ethi', 'mya-Mymr', 'aii-Syrc', 'lit-Latn',
        'kmr-Latn', 'hat-Latn-bab', 'ltc-Latn-bax', 'Goth2Latn', 'quy-Latn',
        'hau-Latn', 'ood-Latn-alv', 'vie-Latn-so', 'run-Latn', 'orm-Latn',
        'ind-Latn', 'kir-Latn', 'mal-Mlym', 'ben-Beng-red', 'hun-Latn',
        'uew', 'sqi-Latn', 'jpn-Hrgn', 'deu-Latn-np', 'xho-Latn',
        'fra-Latn-rev', 'fra-Latn-np', 'kaz-Cyrl-bab', 'jpn-Hrgn-red',
        'Latn2Goth', 'glg-Latn', 'uig-Arab', 'amh-Ethi-red', 'zul-Latn',
        'hin-Deva', 'uzb-Latn', 'tir-Ethi-red', 'kaz-Cyrl', 'mlt-Latn',
        'deu-Latn-nar', 'est-Latn', 'eng-Latn', 'pii-latn_Wiktionary',
        'ckb-Arab', 'nya-Latn', 'mon-Cyrl-bab', 'fra-Latn-p', 'ood-Latn-sax',
        'ukr-Cyrl', 'tgl-Latn-red', 'lsm-Latn', 'kor-Hang', 'lav-Latn',
        'generic-Latn', 'tur-Latn-red', 'srp-Latn', 'tir-Ethi', 'kbd-Cyrl',
        'hrv-Latn', 'srp-Cyrl', 'tpi-Latn', 'khm-Khmr', 'jam-Latn',
        'ben-Beng-east', 'por-Latn', 'cmn-Latn', 'cat-Latn', 'tha-Thai',
        'ara-Arab', 'ben-Beng', 'fin-Latn', 'hmn-Latn', 'lez-Cyrl',
        'fas-Arab', 'lao-Laoo-prereform', 'mar-Deva', 'yor-Latn', 'ron-Latn',
        'tgl-Latn', 'lao-Laoo', 'deu-Latn', 'pan-Guru', 'tuk-Latn',
        'tir-Ethi-pp', 'rus-Cyrl', 'swa-Latn-red', 'ceb-Latn', 'wuu-Latn',
        'hak-Latn', 'mri-Latn', 'epo-Latn', 'pol-Latn', 'tur-Latn-bab',
        'kat-Geor', 'tgk-Cyrl', 'aze-Cyrl', 'vie-Latn-ce', 'swa-Latn',
        'tuk-Cyrl', 'vie-Latn-no', 'nan-Latn-tl', 'zha-Latn', 'cjy-Latn',
        'ava-Cyrl', 'som-Latn', 'kir-Arab'
    ]

    def __init__(self):
        super().__init__(Alphabet.IPA)
        self._cache = {}

    @classmethod
    def get_lang(cls, target_lang: str) -> str:
        # proper tag matching (ISO 639-3 + script aware): a bare string
        # prefix scan resolves 'ja' to 'jav-Latn' (Javanese) and 'es' to
        # 'est-Latn' (Estonian) — wrong languages, no error
        return cls.match_lang(target_lang, cls.EPITRAN_LANGS)

    def phonemize_string(self, text: str, lang: str) -> str:
        import epitran

        lang = self.get_lang(lang)
        if lang not in self._cache:
            self._cache[lang] = epitran.Epitran(lang)
        return self._cache[lang].transliterate(text)


class MisakiPhonemizer(BasePhonemizer):
    """misaki G2P (kokoro's phonemizer; mul.py:675-740)."""

    MISAKI_LANGS = ["en-US", "en-GB", "ko", "ja", "vi", "zh"]

    def __init__(self):
        super().__init__(Alphabet.IPA)
        self._g2p = {}

    @classmethod
    def get_lang(cls, target_lang: str) -> str:
        return cls.match_lang(target_lang, cls.MISAKI_LANGS)

    def _get_g2p(self, lang: str):
        if lang not in self._g2p:
            if lang.startswith("en"):
                from misaki import en

                self._g2p[lang] = en.G2P(british="GB" in lang)
            elif lang == "ja":
                from misaki import ja

                self._g2p[lang] = ja.JAG2P()
            elif lang == "ko":
                from misaki import ko

                self._g2p[lang] = ko.KOG2P()
            elif lang == "vi":
                from misaki import vi

                self._g2p[lang] = vi.VIG2P()
            elif lang == "zh":
                from misaki import zh

                self._g2p[lang] = zh.ZHG2P()
        return self._g2p[lang]

    def phonemize_string(self, text: str, lang: str) -> str:
        lang = self.get_lang(lang)
        phonemes, _tokens = self._get_g2p(lang)(text)
        return phonemes


class TransphonePhonemizer(BasePhonemizer):
    """transphone zero-shot G2P (mul.py:743-1352).

    The reference hardcodes transphone's 7546-language Glottolog inventory;
    we query the installed library instead and fall back to accepting the
    base tag (transphone's read_tokenizer resolves unknown tags itself).
    """

    def __init__(self):
        super().__init__(Alphabet.IPA)
        self._models = {}

    def get_lang(self, target_lang: str) -> str:
        return target_lang.split("-")[0].lower()

    def phonemize_string(self, text: str, lang: str) -> str:
        # one tokenizer PER LANGUAGE (reference mul.py:1344-1352):
        # read_tokenizer takes the language id — a single shared
        # tokenizer would phonemize every language with the same
        # phonology, and tokenize's second positional parameter is
        # use_space, NOT the language
        from transphone import read_tokenizer

        lang = self.get_lang(lang)
        pho = self._models.get(lang)
        if pho is None:
            self._models[lang] = pho = read_tokenizer(lang)
        return "".join(
            p if p != "<SPACE>" else " "
            for p in pho.tokenize(text, use_space=True)
        ).strip()
