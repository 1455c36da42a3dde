"""The port's bundled G2P front ends against the JAX package's, on the CPU.

``MantoqPhonemizer`` (Arabic, IPA and Buckwalter) and ``KoG2PPhonemizer``
(Korean, IPA and Hangul) are verbatim copies: the same strings and the
same ids over a list with digits and hanja. ``get_phonemizer`` builds the
same class, or raises the same exception type, as JAX for every
``PhonemeType`` (a wrapper whose package is absent raises at
construction in both). The ByT5 and Charsiu phonemizers decode a micro
G2P checkpoint (initializers only) on the CPU as JAX's do. A micro voice
of each bundled front end synthesizes JAX's audio within 1e-3 at zero
noise: text -> G2P -> ids -> ``VitsEngine``.
"""

import json
import sys
import types

import numpy as np
import pytest
import torch

from phoonnx_tpu import config as jax_config
from phoonnx_tpu.phoneme_ids import phonemes_to_ids as jax_ids
from phoonnx_tpu.phonemizers import ar as jax_ar
from phoonnx_tpu.phonemizers import ko as jax_ko
from phoonnx_tpu_torch import config
from phoonnx_tpu_torch.models.vits.load import params_to_flat
from phoonnx_tpu_torch.models.vits.model import VitsHParams, random_params
from phoonnx_tpu_torch.onnx.writer import write_onnx
from phoonnx_tpu_torch.phoneme_ids import phonemes_to_ids
from phoonnx_tpu_torch.phonemizers import ar, ko

from tests.test_torch_train_forward import one_torch_thread  # noqa: F401

WAVE_TOL = 1e-3  # the port's path bound (ARCHITECTURE.md:86-89)
ARABIC = ["مرحبا بالعالم", "كتب الولد 12 درسا", "العدد ٣٤",
          "ذهب الطالب إلى المدرسة في الساعة 7", "مَرْحَبًا"]
KOREAN = ["안녕하세요", "韓國 사람", "不實한 不動産", "李舜臣 장군",
          "오늘은 2024년"]


@pytest.mark.parametrize("alphabet", ["ipa", "buckwalter"])
@pytest.mark.parametrize("text", ARABIC)
def test_mantoq_equals_jax(text, alphabet):
    want = jax_ar.MantoqPhonemizer(jax_config.Alphabet(alphabet))
    got = ar.MantoqPhonemizer(config.Alphabet(alphabet))
    s = got.phonemize_string(text, "ar")
    assert s and s == want.phonemize_string(text, "ar")
    assert phonemes_to_ids(list(s)) == jax_ids(list(s))
    assert got.phonemize(text, "ar") == want.phonemize(text, "ar")


@pytest.mark.parametrize("alphabet", ["ipa", "hangul"])
@pytest.mark.parametrize("text", KOREAN)
def test_kog2p_equals_jax(text, alphabet):
    want = jax_ko.KoG2PPhonemizer(jax_config.Alphabet(alphabet))
    got = ko.KoG2PPhonemizer(config.Alphabet(alphabet))
    s = got.phonemize_string(text, "ko")
    assert s and s == want.phonemize_string(text, "ko")
    assert phonemes_to_ids(list(s)) == jax_ids(list(s))
    assert got.phonemize(text, "ko") == want.phonemize(text, "ko")


def _built(get, kind, alphabet):
    try:
        return type(get(kind, alphabet)).__name__
    except Exception as exc:  # the JAX package's exception, to compare
        return type(exc)


@pytest.mark.parametrize("kind", [t.value for t in config.PhonemeType])
def test_get_phonemizer_matches_jax(kind, monkeypatch):
    # G2PEnPhonemizer fetches nltk data at construction: never here (a
    # stand-in module, which also spares importing nltk)
    monkeypatch.setitem(sys.modules, "nltk", types.SimpleNamespace(
        download=lambda *a, **k: False))
    for alphabet in ("ipa", "hangul"):
        want = _built(jax_config.get_phonemizer, kind,
                      jax_config.Alphabet(alphabet))
        got = _built(config.get_phonemizer, kind, config.Alphabet(alphabet))
        assert got == want, (kind, alphabet)


def test_unknown_phonemizer_raises():
    with pytest.raises(ValueError, match="invalid phonemizer"):
        config.get_phonemizer("no-such-phonemizer")


@pytest.fixture(scope="module")
def g2p_model(tmp_path_factory):
    """A micro ByT5 checkpoint: HF-named initializers in an ONNX file."""
    from phoonnx_tpu_torch.models import byt5

    cfg = byt5.T5Config(vocab_size=384, d_model=32, d_kv=16, d_ff=64,
                        num_heads=2, num_encoder_layers=2,
                        num_decoder_layers=2)
    named = byt5.random_flat(cfg, 3)
    # random weights emit bytes that are rarely valid UTF-8: the rows of
    # the ASCII letters' tokens (byte + 3) and of EOS scaled, the decodes
    # spell letters and end at different lengths
    letters = [ord(c) + 3 for c in "abcdefghijklmnopqrstuvwxyz"]
    named["lm_head.weight"][letters] *= 3.0
    named["lm_head.weight"][cfg.eos_id] *= 3.0
    path = tmp_path_factory.mktemp("g2p") / "g2p.onnx"
    write_onnx(str(path), named)
    return str(path)


@pytest.mark.parametrize("kind,lang,text", [
    ("byt5", "en-US", "hello world"),
    ("charsiu", "eng-us", "the quick brown fox"),
])
def test_byt5_phonemizers_equal_jax(g2p_model, kind, lang, text):
    want = jax_config.get_phonemizer(kind, jax_config.Alphabet.IPA, g2p_model)
    got = config.get_phonemizer(kind, config.Alphabet.IPA, g2p_model)
    got.device = "cpu"
    assert got.phonemize_string(text, lang) == \
        want.phonemize_string(text, lang)
    assert str(got.engine.device) == "cpu"


def write_text_voice(tmp_path, phoneme_type, lang, texts,
                     phonemizer_model=None):
    """A micro voice of ``phoneme_type`` and ``lang`` (the port's random
    weights, the flow's post layers non-zero) whose id map covers the
    JAX front end's output on ``texts``. Returns (model, config) paths."""
    hp = VitsHParams.preset("micro")
    params = random_params(hp, torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(6)
    for flow in params["flow"]["flows"]:  # a zero post is the identity
        for key in ("weight", "bias"):
            flow["post"][key] = 0.3 * torch.randn(flow["post"][key].shape,
                                                  generator=gen)
    model_path = tmp_path / "voice.onnx"
    write_onnx(str(model_path), params_to_flat(params),
               metadata={"model_type": "vits",
                         "sample_rate": str(hp.sample_rate)},
               inputs=["input", "input_lengths", "scales"],
               outputs=["output"])
    front = jax_config.get_phonemizer(jax_config.PhonemeType(phoneme_type),
                                      jax_config.Alphabet.IPA,
                                      phonemizer_model)
    chars = sorted({c for text in texts
                    for sent in front.phonemize(text, lang) for c in sent})
    id_map = {"_": 0, "^": 1, "$": 2, " ": 3}
    for c in chars:
        id_map.setdefault(c, len(id_map))
    config_path = tmp_path / "voice.onnx.json"
    config_path.write_text(json.dumps({
        "phoneme_type": phoneme_type, "lang_code": lang, "alphabet": "ipa",
        "phoneme_id_map": id_map, "num_symbols": len(id_map),
        "num_speakers": 1, "audio": {"sample_rate": hp.sample_rate},
        "phonemizer_model": phonemizer_model,
        "inference": {"noise_scale": 0.667, "length_scale": 1.0,
                      "noise_w": 0.8},
    }), encoding="utf-8")
    return model_path, config_path


def ids_equal_jax(voice, config_path, texts):
    """The port voice's ids against the JAX voice front end's (the JAX
    ``TTSVoice`` of the same config, no engine), text by text."""
    from phoonnx_tpu import TTSVoice as JaxVoice

    cfg = jax_config.VoiceConfig.from_dict(
        json.loads(config_path.read_text(encoding="utf-8")))
    jax_voice = JaxVoice(engine=None, config=cfg)
    for text in texts:
        want = [jax_voice.phonemes_to_ids(p)
                for p in jax_voice.phonemize(text)]
        got = [voice.phonemes_to_ids(p) for p in voice.phonemize(text)]
        assert got == want and len(got[0]) > 4, text


@pytest.fixture(scope="module")
def jax_engine(tmp_path_factory):
    """The JAX engine over the micro weights every voice here shares (one
    engine, so the voices' tests share its compiled programs). The JAX
    weight import starts from a ``random_params`` tree that the file
    overwrites leaf by leaf; its eager draws compile ~80 programs (~22 s,
    once a process), so a zero tree of the same structure
    (``jax.eval_shape``, nothing compiled) takes its place, and a strict
    import first shows that the file fills every leaf."""
    import jax

    from phoonnx_tpu import TTSVoice as JaxVoice
    from phoonnx_tpu.models.vits import load as jax_load
    from phoonnx_tpu.onnx.reader import read_onnx as jax_read

    draw = jax_load.random_params

    def skeleton(key, hp):
        shapes = jax.eval_shape(lambda k: draw(k, hp), key)
        return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)

    files = write_text_voice(tmp_path_factory.mktemp("jax_voice"), "raw",
                             "en", [])
    named = jax_read(str(files[0])).initializers
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_load, "random_params", skeleton)
        jax_load.params_from_flat(named, jax_load.infer_hparams_from_flat(
            named, sample_rate=16000), strict=True)
        return JaxVoice.load(*map(str, files)).engine


def voice_pair_audio(tmp_path, jax_engine, phoneme_type, lang, texts,
                     phonemizer_model=None):
    """A micro voice loaded by the port on the CPU and the JAX voice of its
    config over the same weights: equal ids and, at zero noise,
    ``synthesize``'s audio within WAVE_TOL."""
    from phoonnx_tpu import TTSVoice as JaxVoice
    from phoonnx_tpu_torch import SynthesisConfig, TTSVoice

    files = write_text_voice(tmp_path, phoneme_type, lang, texts,
                             phonemizer_model)
    voice = TTSVoice.load(*map(str, files), device="cpu")
    assert str(voice.phonemizer.device) == "cpu"
    ids_equal_jax(voice, files[1], texts)
    jax_voice = JaxVoice(engine=jax_engine, config=jax_config.VoiceConfig
                         .from_dict(json.loads(files[1].read_text(
                             encoding="utf-8"))))
    for i, text in enumerate(texts):
        kw = dict(noise_scale=0.0, noise_w_scale=0.0, normalize_audio=False,
                  seed=i)
        want = [c.audio_float_array for c in jax_voice.synthesize(
            text, jax_config.SynthesisConfig(**kw))]
        got = [c.audio_float_array for c in voice.synthesize(
            text, SynthesisConfig(**kw))]
        assert [len(a) for a in got] == [len(a) for a in want] and got
        for a, b in zip(got, want):
            assert np.abs(a - b).max() < WAVE_TOL
    return voice


def test_mantoq_voice_synthesizes_as_jax(tmp_path, jax_engine):
    voice = voice_pair_audio(tmp_path, jax_engine, "mantoq", "ar",
                             ARABIC[1:2])
    assert type(voice.phonemizer).__name__ == "MantoqPhonemizer"


@pytest.fixture()
def no_phonikud_model(monkeypatch, tmp_path):
    """No phonikud model under HOME, and its download returns False on
    both sides (it is never attempted)."""
    from phoonnx_tpu.thirdparty import phonikud as jax_phonikud
    from phoonnx_tpu_torch.thirdparty import phonikud

    monkeypatch.setenv("HOME", str(tmp_path))
    for cls in (jax_phonikud.PhonikudDiacritizer,
                phonikud.PhonikudDiacritizer):
        monkeypatch.setattr(cls, "_download", lambda self: False)


def test_arabic_grapheme_voice_synthesizes_as_jax(tmp_path, jax_engine,
                                                 no_phonikud_model):
    """A GRAPHEMES micro voice of lang_code "ar": ``add_diacritics`` runs
    (the tashkeel model is absent, so the text is unchanged, as in JAX)
    and the audio equals JAX's within 1e-3. The port refused it before
    the diacritizers were ported. (71 ids: the mantoq sentence's text
    bucket.)"""
    voice_pair_audio(tmp_path, jax_engine, "graphemes", "ar", ARABIC[3:4])


@pytest.mark.parametrize("kind,lang,text,model", [
    ("kog2p", "ko", KOREAN[1], None),
    ("byt5", "en-US", "good morning", "g2p"),
])
def test_voice_front_end_ids_equal_jax(request, tmp_path, kind, lang, text,
                                       model):
    """KoG2P and ByT5 voices loaded on the CPU: the G2P runs on the
    voice's device, the ids equal the JAX front end's, the audio is
    finite and whole frames."""
    from phoonnx_tpu_torch import SynthesisConfig, TTSVoice

    model = request.getfixturevalue("g2p_model") if model else None
    files = write_text_voice(tmp_path, kind, lang, [text], model)
    voice = TTSVoice.load(*map(str, files), device="cpu")
    ids_equal_jax(voice, files[1], [text])
    if kind == "byt5":
        assert str(voice.phonemizer.engine.device) == "cpu"
    audio = np.concatenate([c.audio_float_array for c in voice.synthesize(
        text, SynthesisConfig(seed=1))])
    assert np.isfinite(audio).all() and len(audio) % 16 == 0
