"""Phonemizer registry (reference: phoonnx/phonemizers/__init__.py)."""

from typing import Union

from phoonnx_tpu_torch.phonemizers.base import (
    BasePhonemizer,
    GraphemePhonemizer,
    PhonemizedChunks,
    RawPhonemes,
    RawPhonemizedChunks,
    TextChunks,
    UnicodeCodepointPhonemizer,
)
from phoonnx_tpu_torch.phonemizers.mul import (
    ByT5Phonemizer,
    CharsiuPhonemizer,
    EspeakError,
    EspeakPhonemizer,
    EpitranPhonemizer,
    GoruutPhonemizer,
    GruutPhonemizer,
    MisakiPhonemizer,
    TransphonePhonemizer,
)
from phoonnx_tpu_torch.phonemizers.en import (
    DeepPhonemizer,
    G2PEnPhonemizer,
    OpenPhonemizer,
)
from phoonnx_tpu_torch.phonemizers.ar import MantoqPhonemizer
from phoonnx_tpu_torch.phonemizers.he import PhonikudPhonemizer
from phoonnx_tpu_torch.phonemizers.fa import PersianPhonemizer
from phoonnx_tpu_torch.phonemizers.vi import VIPhonemePhonemizer
from phoonnx_tpu_torch.phonemizers.ja import (
    CutletPhonemizer,
    OpenJTaklPhonemizer,
    PyKakasiPhonemizer,
)
from phoonnx_tpu_torch.phonemizers.ko import G2PKPhonemizer, KoG2PPhonemizer
from phoonnx_tpu_torch.phonemizers.zh import (
    BaseChinesePinyinPhonemizer,
    G2pCPhonemizer,
    G2pMPhonemizer,
    JiebaPhonemizer,
    PypinyinPhonemizer,
    XpinyinPhonemizer,
)
from phoonnx_tpu_torch.phonemizers.gl import CotoviaPhonemizer
from phoonnx_tpu_torch.phonemizers.mwl import MirandesePhonemizer

Phonemizer = Union[
    BasePhonemizer,
    RawPhonemes,
    GraphemePhonemizer,
    UnicodeCodepointPhonemizer,
    EspeakPhonemizer,
    ByT5Phonemizer,
    CharsiuPhonemizer,
    GruutPhonemizer,
    GoruutPhonemizer,
    EpitranPhonemizer,
    MisakiPhonemizer,
    TransphonePhonemizer,
    DeepPhonemizer,
    OpenPhonemizer,
    G2PEnPhonemizer,
    MantoqPhonemizer,
    PhonikudPhonemizer,
    PersianPhonemizer,
    VIPhonemePhonemizer,
    OpenJTaklPhonemizer,
    CutletPhonemizer,
    PyKakasiPhonemizer,
    G2PKPhonemizer,
    KoG2PPhonemizer,
    JiebaPhonemizer,
    G2pCPhonemizer,
    G2pMPhonemizer,
    PypinyinPhonemizer,
    XpinyinPhonemizer,
    CotoviaPhonemizer,
    MirandesePhonemizer,
]

__all__ = [
    "BasePhonemizer", "PhonemizedChunks", "Phonemizer",
    "RawPhonemes", "GraphemePhonemizer", "UnicodeCodepointPhonemizer",
    "EspeakPhonemizer", "EspeakError", "ByT5Phonemizer", "CharsiuPhonemizer",
    "GruutPhonemizer", "GoruutPhonemizer", "EpitranPhonemizer",
    "MisakiPhonemizer", "TransphonePhonemizer", "DeepPhonemizer",
    "OpenPhonemizer", "G2PEnPhonemizer", "MantoqPhonemizer",
    "PhonikudPhonemizer", "PersianPhonemizer", "VIPhonemePhonemizer",
    "OpenJTaklPhonemizer", "CutletPhonemizer", "PyKakasiPhonemizer",
    "G2PKPhonemizer", "KoG2PPhonemizer", "JiebaPhonemizer",
    "G2pCPhonemizer", "G2pMPhonemizer", "PypinyinPhonemizer",
    "XpinyinPhonemizer", "CotoviaPhonemizer", "MirandesePhonemizer",
    "BaseChinesePinyinPhonemizer",
]
