"""Voice configuration parsing and model-format auto-detection.

TPU-native rebuild of the reference config layer (phoonnx/config.py). Parses a
voice ``config.json`` and unifies the piper / mimic3 / coqui-VITS / cotovia /
phoonnx formats into one :class:`VoiceConfig`. This file format is the
interchange contract with existing checkpoints and must stay byte-compatible
(reference: phoonnx/config.py:218-358).
"""

import json
import logging
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, Mapping, Optional, Sequence

from phoonnx_tpu_torch.phoneme_ids import (
    DEFAULT_BLANK_TOKEN,
    DEFAULT_BLANK_WORD_TOKEN,
    DEFAULT_BOS_TOKEN,
    DEFAULT_EOS_TOKEN,
    DEFAULT_PAD_TOKEN,
    BlankBetween,
    load_phoneme_ids,
)

LOG = logging.getLogger(__name__)

DEFAULT_NOISE_SCALE = 0.667
DEFAULT_LENGTH_SCALE = 1.0
DEFAULT_NOISE_W_SCALE = 0.8


class Alphabet(str, Enum):
    """Phoneme alphabet of a voice (reference: phoonnx/config.py:20-36)."""

    UNICODE = "unicode"
    IPA = "ipa"
    ARPA = "arpa"  # en
    SAMPA = "sampa"
    XSAMPA = "x-sampa"
    HANGUL = "hangul"  # ko
    KANA = "kana"  # ja
    HIRA = "hira"  # ja
    HEPBURN = "hepburn"  # ja romanization
    KUNREI = "kunrei"  # ja romanization
    NIHON = "nihon"  # ja romanization
    PINYIN = "pinyin"  # zh
    ERAAB = "eraab"  # fa
    COTOVIA = "cotovia"  # gl
    HANZI = "hanzi"  # zh
    BUCKWALTER = "buckwalter"  # ar


class PhonemeType(str, Enum):
    """G2P engine selector (reference: phoonnx/config.py:40-73)."""

    RAW = "raw"
    UNICODE = "unicode"
    GRAPHEMES = "graphemes"

    MISAKI = "misaki"
    ESPEAK = "espeak"
    GRUUT = "gruut"
    GORUUT = "goruut"
    EPITRAN = "epitran"
    BYT5 = "byt5"
    CHARSIU = "charsiu"
    TRANSPHONE = "transphone"
    MIRANDESE = "mwl_phonemizer"

    DEEPPHONEMIZER = "deepphonemizer"  # en
    OPENPHONEMIZER = "openphonemizer"  # en
    G2PEN = "g2pen"  # en

    G2PFA = "g2pfa"
    OPENJTALK = "openjtalk"  # ja
    CUTLET = "cutlet"  # ja
    PYKAKASI = "pykakasi"  # ja
    COTOVIA = "cotovia"  # gl
    PHONIKUD = "phonikud"  # he
    MANTOQ = "mantoq"  # ar
    VIPHONEME = "viphoneme"  # vi
    G2PK = "g2pk"  # ko
    KOG2PK = "kog2p"  # ko
    G2PC = "g2pc"  # zh
    G2PM = "g2pm"  # zh
    PYPINYIN = "pypinyin"  # zh
    XPINYIN = "xpinyin"  # zh
    JIEBA = "jieba"  # zh (word segmentation only)


_PHONEME_TYPE_VALUES = {pt.value for pt in PhonemeType}


@dataclass
class VoiceConfig:
    """Unified TTS model configuration (reference: phoonnx/config.py:76-126)."""

    num_symbols: int
    num_speakers: int
    num_langs: int
    sample_rate: int
    lang_code: Optional[str]
    phoneme_id_map: Optional[Mapping[str, Sequence[int]]]
    phoneme_type: PhonemeType
    alphabet: Optional[Alphabet]
    phonemizer_model: Optional[str]
    speaker_id_map: Mapping[str, int] = field(default_factory=dict)
    lang_id_map: Mapping[str, int] = field(default_factory=dict)

    # Inference scales
    length_scale: float = DEFAULT_LENGTH_SCALE
    noise_scale: float = DEFAULT_NOISE_SCALE
    noise_w_scale: float = DEFAULT_NOISE_W_SCALE

    # Tokenization settings
    blank_at_start: bool = True
    blank_at_end: bool = True
    include_whitespace: Optional[bool] = True
    pad_token: Optional[str] = DEFAULT_PAD_TOKEN
    blank_token: Optional[str] = DEFAULT_PAD_TOKEN
    bos_token: Optional[str] = DEFAULT_BOS_TOKEN
    eos_token: Optional[str] = DEFAULT_EOS_TOKEN
    word_sep_token: Optional[str] = DEFAULT_BLANK_WORD_TOKEN
    blank_between: BlankBetween = BlankBetween.TOKENS_AND_WORDS

    def __post_init__(self) -> None:
        self.lang_code = self.lang_code or "und"

    # ------------------------------------------------------------------
    # Format sniffers
    # ------------------------------------------------------------------

    @staticmethod
    def is_mimic3(config: Dict[str, Any]) -> bool:
        """Mimic3 configs carry a string ``phonemizer`` plus a ``phonemes``
        dict (reference: phoonnx/config.py:131-154)."""
        phonemizer = config.get("phonemizer")
        if not isinstance(phonemizer, str):
            return False
        if not isinstance(config.get("phonemes"), dict):
            return False
        return phonemizer in ("symbols", "gruut", "espeak", "epitran")

    @staticmethod
    def is_piper(config: Dict[str, Any]) -> bool:
        """Piper configs have ``piper_version`` or a text/espeak
        ``phoneme_type`` plus ``phoneme_id_map`` (reference:
        phoonnx/config.py:156-174)."""
        if "piper_version" in config:
            return True
        phoneme_type = config.get("phoneme_type")
        if not isinstance(phoneme_type, str):
            return False
        if not isinstance(config.get("phoneme_id_map"), dict):
            return False
        return phoneme_type in ("text", "espeak")

    @staticmethod
    def is_coqui_vits(config: Dict[str, Any]) -> bool:
        """Coqui configs have a ``characters`` section produced by a known
        characters class (reference: phoonnx/config.py:176-187)."""
        characters = config.get("characters")
        if not isinstance(characters, dict):
            return False
        return characters.get("characters_class", "") in (
            "TTS.tts.models.vits.VitsCharacters",
            "TTS.tts.utils.text.characters.Graphemes",
        )

    @staticmethod
    def is_phoonnx(config: Dict[str, Any]) -> bool:
        """Phoonnx configs have a known ``phoneme_type`` plus ``lang_code``
        (reference: phoonnx/config.py:189-204)."""
        phoneme_type = config.get("phoneme_type")
        if not isinstance(phoneme_type, str):
            return False
        if "lang_code" not in config:
            return False
        return phoneme_type in _PHONEME_TYPE_VALUES

    @staticmethod
    def is_cotovia(config: Dict[str, Any]) -> bool:
        """Cotovia voices look like coqui AND phoonnx simultaneously with an
        explicit cotovia phoneme type (reference: phoonnx/config.py:206-216)."""
        if not VoiceConfig.is_coqui_vits(config) or not VoiceConfig.is_phoonnx(config):
            return False
        return config["phoneme_type"] == PhonemeType.COTOVIA.value

    # ------------------------------------------------------------------
    # Parsing
    # ------------------------------------------------------------------

    @staticmethod
    def from_dict(
        config: Dict[str, Any],
        phonemes_txt: Optional[str] = None,
        lang_code: Optional[str] = None,
        phoneme_type_str: Optional[str] = None,
    ) -> "VoiceConfig":
        """Parse a voice config dict, auto-detecting its source format.

        Follows the reference parse order exactly (phoonnx/config.py:218-358):
        optional external phoneme table, then piper -> mimic3 -> coqui
        sniffing, each branch fixing up tokens/alphabet/phoneme map in its
        format-specific way.
        """
        blank_type = BlankBetween.TOKENS_AND_WORDS
        lang_code = lang_code or config.get("lang_code")
        phoneme_type_str = phoneme_type_str or config.get("phoneme_type")
        phoneme_id_map = config.get("phoneme_id_map")
        alphabet = config.get("alphabet")

        if phonemes_txt:
            if phonemes_txt.endswith(".txt"):
                # mimic3-style external phoneme table (or runtime override)
                with open(phonemes_txt, "r", encoding="utf-8") as ids_file:
                    phoneme_id_map = load_phoneme_ids(ids_file)
            elif phonemes_txt.endswith(".json"):
                with open(phonemes_txt, encoding="utf-8") as ids_file:
                    phoneme_id_map = json.load(ids_file)

        if VoiceConfig.is_piper(config):
            lang_code = lang_code or (
                config.get("language", {}).get("code")
                or config.get("espeak", {}).get("voice")
            )
            # explicit caller override wins (the reference reassigns from
            # the config here, silently discarding load()'s override)
            phoneme_type_str = phoneme_type_str or PhonemeType.ESPEAK.value
            if phoneme_type_str == "text":
                phoneme_type_str = PhonemeType.UNICODE.value
                alphabet = Alphabet.UNICODE
            else:
                alphabet = Alphabet.IPA

            # Token symbols are fixed in piper exports.
            config["pad"] = DEFAULT_PAD_TOKEN
            config["blank"] = DEFAULT_BLANK_TOKEN
            config["bos"] = DEFAULT_BOS_TOKEN
            config["eos"] = DEFAULT_EOS_TOKEN

        elif VoiceConfig.is_mimic3(config):
            if not phonemes_txt:
                raise ValueError(
                    "mimic3 models require an external phonemes.txt file "
                    "in addition to the config"
                )
            lang_code = lang_code or config.get("text_language")
            phoneme_type_str = (
                phoneme_type_str
                or config.get("phonemizer", PhonemeType.GRUUT.value)
            )
            phoneme_cfg = config.get("phonemes", {})
            blank_type = BlankBetween(
                phoneme_cfg.get("blank_between", "tokens_and_words")
            )
            config.update(phoneme_cfg)

            if phoneme_type_str == "symbols":
                # "symbols" voices are grapheme models; the map came from
                # phonemes_txt above.
                phoneme_type_str = PhonemeType.GRAPHEMES.value
                alphabet = Alphabet.UNICODE
            else:
                alphabet = Alphabet.IPA

        elif VoiceConfig.is_coqui_vits(config):
            if VoiceConfig.is_cotovia(config):
                phoneme_type_str = PhonemeType.COTOVIA.value
                alphabet = Alphabet.COTOVIA
            else:
                phoneme_type_str = PhonemeType.GRAPHEMES.value
                alphabet = Alphabet.UNICODE

            # Coqui rarely records a (correct) language; take the dataset one.
            datasets = config.get("datasets", [])
            if datasets and not lang_code:
                lang_code = datasets[0].get("language")

            characters_config = config.get("characters", {})
            if config.get("add_blank", True):
                blank_type = BlankBetween.TOKENS
                characters_config["blank"] = characters_config.get("blank") or "<BLNK>"
            config.update(characters_config)

            characters = characters_config.get("characters")
            punctuations = characters_config.get("punctuations")

            if not config.get("enable_eos_bos_chars", True):
                config["bos"] = config["eos"] = None

            # Vocabulary order per the original coqui Graphemes class:
            # [PAD, PUNCTUATIONS, CHARACTERS, BLANK]
            vocab_list = []
            if characters_config.get("pad") is not None:
                vocab_list.append(characters_config["pad"])
            if punctuations:
                vocab_list.extend(list(punctuations))
            if characters:
                vocab_list.extend(list(characters))
            if characters_config.get("blank") is not None:
                vocab_list.append(characters_config["blank"])

            phoneme_id_map = {char: idx for idx, char in enumerate(vocab_list)}

            # the built vocab NEVER contains bos/eos (coqui's Graphemes
            # defaults enable_eos_bos_chars=False; the reference also
            # leaves them out of vocab_list, config.py:310-314) — but
            # when the flag is absent the tokens stayed set, so
            # phonemes_to_ids emitted the out-of-range id len(map) at
            # every utterance edge (divergence fix: the reference
            # inherits this crash)
            for tok_key in ("bos", "eos"):
                if config.get(tok_key) and \
                        config[tok_key] not in phoneme_id_map:
                    config[tok_key] = None

        elif VoiceConfig.is_phoonnx(config):
            # Voices trained by the phoonnx/phoonnx_tpu pipeline: training
            # ids are built with the default specials (reference
            # preprocess.py:29-34 + phonemes_to_ids defaults at :599), but
            # the written config.json carries no pad/blank/bos/eos keys.
            # The reference then loads non-espeak voices with token=None —
            # dropping bos/eos/blank at inference, a train/infer
            # tokenization mismatch we fix rather than replicate. Explicit
            # keys (written by our preprocess) still win.
            config.setdefault("pad", DEFAULT_PAD_TOKEN)
            config.setdefault("blank", DEFAULT_BLANK_TOKEN)
            config.setdefault("bos", DEFAULT_BOS_TOKEN)
            config.setdefault("eos", DEFAULT_EOS_TOKEN)

        phoneme_type = PhonemeType(phoneme_type_str)
        LOG.debug("phonemizer: %s", phoneme_type)
        inference = config.get("inference", {})

        # decided on the EFFECTIVE phoneme table (external phonemes.txt /
        # coqui vocab included) — the reference keys this off the raw
        # config only (config.py:334), so mimic3/coqui voices whose space
        # symbol lives outside config["phoneme_id_map"] silently drop
        # whitespace ids at inference
        characters = config.get("characters")
        include_whitespace = (
            (isinstance(characters, str) and " " in characters)
            or bool(phoneme_id_map and " " in phoneme_id_map)
        )
        return VoiceConfig(
            num_langs=config.get("num_langs", 1),
            num_symbols=config.get("num_symbols", 256),
            num_speakers=config.get("num_speakers", 1),
            sample_rate=config.get("audio", {}).get("sample_rate", 16000),
            noise_scale=inference.get("noise_scale", DEFAULT_NOISE_SCALE),
            length_scale=inference.get("length_scale", DEFAULT_LENGTH_SCALE),
            noise_w_scale=inference.get("noise_w", DEFAULT_NOISE_W_SCALE),
            lang_code=lang_code,
            alphabet=alphabet,
            phonemizer_model=config.get("phonemizer_model"),
            phoneme_id_map=phoneme_id_map,
            phoneme_type=phoneme_type,
            speaker_id_map=config.get("speaker_id_map", {}),
            blank_between=blank_type,
            include_whitespace=include_whitespace,
            blank_at_start=config.get("blank_at_start", True),
            blank_at_end=config.get("blank_at_end", True),
            pad_token=config.get("pad"),
            blank_token=config.get("blank"),
            bos_token=config.get("bos"),
            eos_token=config.get("eos"),
            word_sep_token=config.get("word_sep_token") or config.get("blank_word", " "),
        )


@dataclass
class SynthesisConfig:
    """Runtime synthesis knobs (reference: phoonnx/config.py:361-389)."""

    speaker_id: Optional[int] = None
    lang_id: Optional[int] = None
    length_scale: Optional[float] = None
    noise_scale: Optional[float] = None
    noise_w_scale: Optional[float] = None
    normalize_audio: bool = True
    volume: float = 1.0
    enable_phonetic_spellings: bool = True
    add_diacritics: bool = True
    seed: Optional[int] = None
    """PRNG seed for the stochastic synthesis paths (TPU build extension;
    the reference relies on global torch/onnxruntime RNG state instead)."""


def get_phonemizer(
    phoneme_type: PhonemeType,
    alphabet: Alphabet = Alphabet.IPA,
    model: Optional[str] = None,
) -> "Phonemizer":
    """Instantiate the phonemizer for a voice (reference: config.py:392-465)."""
    from phoonnx_tpu_torch import phonemizers as P

    factories = {
        PhonemeType.ESPEAK: lambda: P.EspeakPhonemizer(),
        PhonemeType.BYT5: lambda: P.ByT5Phonemizer(model),
        PhonemeType.CHARSIU: lambda: P.CharsiuPhonemizer(model),
        PhonemeType.GRUUT: lambda: P.GruutPhonemizer(),
        PhonemeType.GORUUT: lambda: P.GoruutPhonemizer(),
        PhonemeType.EPITRAN: lambda: P.EpitranPhonemizer(),
        PhonemeType.MISAKI: lambda: P.MisakiPhonemizer(),
        PhonemeType.TRANSPHONE: lambda: P.TransphonePhonemizer(),
        PhonemeType.MIRANDESE: lambda: P.MirandesePhonemizer(),
        PhonemeType.DEEPPHONEMIZER: lambda: P.DeepPhonemizer(model),
        PhonemeType.OPENPHONEMIZER: lambda: P.OpenPhonemizer(),
        PhonemeType.G2PEN: lambda: P.G2PEnPhonemizer(alphabet=alphabet),
        PhonemeType.OPENJTALK: lambda: P.OpenJTaklPhonemizer(alphabet=alphabet),
        PhonemeType.PYKAKASI: lambda: P.PyKakasiPhonemizer(alphabet=alphabet),
        PhonemeType.CUTLET: lambda: P.CutletPhonemizer(alphabet=alphabet),
        PhonemeType.G2PFA: lambda: P.PersianPhonemizer(alphabet=alphabet),
        PhonemeType.PHONIKUD: lambda: P.PhonikudPhonemizer(),
        PhonemeType.MANTOQ: lambda: P.MantoqPhonemizer(),
        PhonemeType.VIPHONEME: lambda: P.VIPhonemePhonemizer(),
        PhonemeType.KOG2PK: lambda: P.KoG2PPhonemizer(alphabet=alphabet),
        PhonemeType.G2PK: lambda: P.G2PKPhonemizer(alphabet=alphabet),
        PhonemeType.PYPINYIN: lambda: P.PypinyinPhonemizer(alphabet=alphabet),
        PhonemeType.XPINYIN: lambda: P.XpinyinPhonemizer(alphabet=alphabet),
        PhonemeType.JIEBA: lambda: P.JiebaPhonemizer(),
        PhonemeType.G2PC: lambda: P.G2pCPhonemizer(alphabet=alphabet),
        PhonemeType.G2PM: lambda: P.G2pMPhonemizer(alphabet=alphabet),
        PhonemeType.COTOVIA: lambda: P.CotoviaPhonemizer(),
        PhonemeType.UNICODE: lambda: P.UnicodeCodepointPhonemizer(),
        PhonemeType.GRAPHEMES: lambda: P.GraphemePhonemizer(),
        PhonemeType.RAW: lambda: P.RawPhonemes(),
    }
    try:
        factory = factories[phoneme_type]
    except KeyError:
        raise ValueError("invalid phonemizer") from None
    # call OUTSIDE the try: a KeyError raised inside a phonemizer
    # constructor (missing G2P data-table entry etc.) must surface as
    # itself, not masked as "invalid phonemizer" with the chain cut
    return factory()
