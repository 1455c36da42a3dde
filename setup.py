#!/usr/bin/env python3
"""Package setup for phoonnx_tpu."""

from pathlib import Path

from setuptools import find_packages, setup

version = {}
exec((Path(__file__).parent / "phoonnx_tpu" / "version.py").read_text(),
     version)

# Per-language optional G2P extras, mirroring the reference's
# requirements/<lang>.txt surface (reference setup.py:73-77): install
# `phoonnx_tpu[<lang>]` to pull the third-party phonemizer backends for
# that language. Languages not listed here are served by the built-in
# self-contained phonemizers (espeak subprocess, byt5/charsiu on TPU,
# mantoq, kog2p/hangul2ipa, cotovia, grapheme/unicode fallbacks).
_GRUUT = "gruut[{}]>=2.3.0,<3.0"
_LANG_EXTRAS = {
    "ar": [_GRUUT.format("ar"), "epitran"],
    "ca": [_GRUUT.format("ca"), "epitran"],
    "cs": [_GRUUT.format("cs"), "epitran"],
    "de": [_GRUUT.format("de"), "epitran"],
    "en": ["epitran", _GRUUT.format("en"), "misaki[en]"],
    "es": [_GRUUT.format("es"), "epitran"],
    "fa": ["persian_phonemizer", _GRUUT.format("fa"), "epitran"],
    "fr": [_GRUUT.format("fr"), "epitran"],
    "he": ["phonikud_onnx", "phonikud"],
    "it": [_GRUUT.format("it"), "epitran"],
    "ja": ["pyopenjtalk", "pykakasi", "cutlet", "unidic-lite",
           "misaki[ja]"],
    "ko": ["g2pk", "epitran", "misaki[ko]"],
    "lb": [_GRUUT.format("lb")],
    "mwl": ["mwl_phonemizer"],
    "nl": [_GRUUT.format("nl")],
    "pt": [_GRUUT.format("pt"), "epitran"],
    "ru": [_GRUUT.format("ru"), "epitran"],
    "sv": [_GRUUT.format("sv"), "epitran"],
    "sw": [_GRUUT.format("sw"), "epitran"],
    "vi": ["misaki[vi]", "epitran", "viphoneme", "underthesea",
           "eng_to_ipa", "vinorm"],
    "zh": ["g2pM", "misaki[zh]", "epitran", "pypinyin", "xpinyin",
           "pinyin_to_ipa", "jieba", "cn2an"],
}
# the long tail of languages reachable through epitran transliteration
_EPITRAN_ONLY = (
    "aa aii am av az bn ceb cjy ckb csb eo et eu ff fi fil gan gl got ha "
    "hak hi hmn hr hsn hu id ilo jam jv ka kbd kk km ku ky lez lij lo lsm "
    "lt luy lv mi ml mr ms mt my nan ny om or pa pl quy rn ro rw sg si sn "
    "so sq sr ta te tg th ti tk tpi tr uew ug uk ur uz wuu xh yo yue za zu"
).split()
_LANG_EXTRAS.update({lang: ["epitran"] for lang in _EPITRAN_ONLY})

setup(
    name="phoonnx_tpu",
    version=version["__version__"],
    description="TPU-native multilingual text-to-speech (JAX/XLA/Pallas)",
    long_description=(Path(__file__).parent / "README.md").read_text(),
    long_description_content_type="text/markdown",
    packages=find_packages(include=["phoonnx_tpu", "phoonnx_tpu.*",
                                    "phoonnx_tpu_torch",
                                    "phoonnx_tpu_torch.*"]),
    package_data={
        "phoonnx_tpu": [
            "_ipa_table.json",
            "locale/*/phonetic_spellings.txt",
            "thirdparty/_arpa2ipa.json",
            "thirdparty/ko_tables/*",
            "thirdparty/kog2p/rulebook.txt",
            "thirdparty/tashkeel/*.json",
            "thirdparty/mantoq/ar_number_words.json",
            "native/*.cpp",
        ],
        "phoonnx_tpu_torch": [
            "_ipa_table.json",
            "locale/*/phonetic_spellings.txt",
            "thirdparty/_arpa2ipa.json",
            "thirdparty/ko_tables/*",
            "thirdparty/kog2p/rulebook.txt",
            "thirdparty/tashkeel/*.json",
            "thirdparty/mantoq/ar_number_words.json",
            "csrc/*.cu",
            "csrc/*.cuh",
        ],
    },
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "scipy",
        "click",
        "optax",
    ],
    extras_require={
        "train": ["einops"],
        "dev": ["pytest"],
        **_LANG_EXTRAS,
    },
    entry_points={
        "console_scripts": [
            "phoonnx-tpu-synthesize = phoonnx_tpu.synthesize:main",
            "phoonnx-tpu-preprocess = phoonnx_tpu.train.preprocess:main",
            "phoonnx-tpu-train = phoonnx_tpu.train.trainer:main",
            "phoonnx-tpu-export = phoonnx_tpu.train.export:main",
            "phoonnx-tpu-serve = phoonnx_tpu.serve:main",
            "phoonnx-tpu-convert = phoonnx_tpu.convert:main",
            "phoonnx-tpu-quantize = phoonnx_tpu.quantize:main",
        ],
    },
)
