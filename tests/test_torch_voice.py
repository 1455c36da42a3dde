"""The port's ``TTSVoice`` on a voice written by the JAX package, on the CPU.

The voice is written as tests/test_voice_e2e.py writes one: JAX
``random_params`` -> ``params_to_flat`` -> ``write_onnx`` plus a RAW-phoneme
``config.json``. The port loads it with ``device="cpu"`` (its plain
PyTorch path) and must tokenize exactly as the JAX voice does, write a
valid 16-bit WAV, and decode a padded batch as it decodes each utterance
alone.
"""

import dataclasses
import io
import json
import wave

import numpy as np
import jax
import pytest
import torch

from phoonnx_tpu.models.vits.load import params_to_flat
from phoonnx_tpu.models.vits.model import random_params
from phoonnx_tpu.onnx.writer import write_onnx
from phoonnx_tpu_torch import SynthesisConfig, TTSVoice

from tests.test_voice_e2e import SMALL_HP

# Batch vs single decode of one utterance: the same weights, the same
# noise, a different padded length. Convs and the masked attention sum the
# same terms; measured max-abs difference ~1e-7.
BATCH_TOL = 1e-5


def _config(id_map):
    return {
        "phoneme_type": "raw",
        "lang_code": "en",
        "alphabet": "ipa",
        "phoneme_id_map": id_map,
        "num_symbols": len(id_map),
        "num_speakers": 1,
        "audio": {"sample_rate": 22050},
        "inference": {"noise_scale": 0.667, "length_scale": 1.0,
                      "noise_w": 0.8},
    }


@pytest.fixture(scope="module")
def voice_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_voice")
    flat = params_to_flat(random_params(jax.random.PRNGKey(0), SMALL_HP))
    model_path = tmp / "model.onnx"
    write_onnx(str(model_path), {k: np.asarray(v) for k, v in flat.items()},
               metadata={"model_type": "vits", "sample_rate": "22050"},
               inputs=["input", "input_lengths", "scales"],
               outputs=["output"])
    id_map = {"_": 0, "^": 1, "$": 2, " ": 3}
    id_map.update({c: i + 4 for i, c in enumerate("abcdefghijklmnop")})
    config_path = tmp / "model.onnx.json"
    config_path.write_text(json.dumps(_config(id_map)), encoding="utf-8")
    return model_path, config_path


@pytest.fixture(scope="module")
def voice(voice_files):
    return TTSVoice.load(*map(str, voice_files), device="cpu")


def test_load_reads_the_voice(voice):
    hp = voice.engine.hp
    assert voice.config.sample_rate == 22050
    assert (hp.hidden_channels, hp.upsample_rates, hp.resblock) == (
        SMALL_HP.hidden_channels, SMALL_HP.upsample_rates, SMALL_HP.resblock)
    assert str(voice.engine.device) == "cpu"
    # the kernels' specs are attached at engine init
    params = voice.engine.params
    assert "fused" in params["enc_p"]["encoder"]
    assert "fused_rev" in params["flow"]
    assert len(params["dec"]["fused_stages"]) == len(SMALL_HP.upsample_rates)


@pytest.fixture(scope="module")
def jax_voice(voice_files):
    from phoonnx_tpu import TTSVoice as JaxVoice

    return JaxVoice.load(*map(str, voice_files))


@pytest.mark.parametrize("text", ["[[abc def]]", "[[a]] [[ponm lk]]",
                                  "[[h a l o]]"])
def test_phoneme_ids_equal_jax_voice(jax_voice, voice, text):
    want = [jax_voice.phonemes_to_ids(p) for p in jax_voice.phonemize(text)]
    got = [voice.phonemes_to_ids(p) for p in voice.phonemize(text)]
    assert got == want and got


def test_synthesize_wav_writes_16bit_wav(voice):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as wav_file:
        voice.synthesize_wav("[[abc def]]", wav_file, SynthesisConfig(seed=12))
    buf.seek(0)
    with wave.open(buf, "rb") as wav_file:
        assert wav_file.getframerate() == 22050
        assert wav_file.getnchannels() == 1
        assert wav_file.getsampwidth() == 2
        n = wav_file.getnframes()
        pcm = np.frombuffer(wav_file.readframes(n), np.int16)
    assert n > 0 and n % SMALL_HP.total_upsample == 0
    assert np.abs(pcm).max() > 0


def test_same_seed_same_audio(voice):
    cfg = SynthesisConfig(seed=7)
    a = voice.phoneme_ids_to_audio([1, 0, 4, 5, 6, 0, 2], cfg)
    b = voice.phoneme_ids_to_audio([1, 0, 4, 5, 6, 0, 2], cfg)
    np.testing.assert_array_equal(a, b)
    assert len(a) % SMALL_HP.total_upsample == 0


def test_padded_batch_equals_single_decodes(voice):
    engine = voice.engine
    batch = [[1, 0, 4, 5, 6, 0, 2], [1, 7, 2], [1, 0, 8, 9, 10, 11, 12, 0, 2],
             [1, 13, 14, 2]]
    audio, frames = engine.synthesize_batch(batch, seed=40)
    hop = engine.hp.total_upsample
    # padded to the frame bucket of the longest member, as the JAX engine
    assert audio.shape == (4, engine._frame_bucket_clamped(max(frames)) * hop)
    for i, ids in enumerate(batch):
        # utterance i of a batch draws its noise from seed + i
        single = engine.synthesize_ids(ids, seed=40 + i)
        assert len(single) == frames[i] * hop
        np.testing.assert_allclose(audio[i, :frames[i] * hop], single,
                                   atol=BATCH_TOL, rtol=0)


def test_voice_synthesize_batch(voice):
    outs = voice.synthesize_batch(["[[abc]]", "[[de fg]]", "[[]]"],
                                  SynthesisConfig(seed=3))
    assert len(outs) == 3
    assert all(o.ndim == 1 and len(o) > 0 for o in outs[:2])
    assert len(outs[2]) == 0
    assert all(np.abs(o).max() <= 1.0 for o in outs[:2])


def test_frame_cap_truncates_with_warning(voice, caplog):
    engine = voice.engine
    buckets = engine.frame_buckets
    engine.frame_buckets = (8,)  # the cap is the largest frame bucket
    try:
        assert engine.max_frames == 8
        with caplog.at_level("WARNING"):
            audio = engine.synthesize_ids([1, 4, 5, 6, 7, 8, 2], seed=0,
                                          length_scale=4.0)
    finally:
        engine.frame_buckets = buckets
    assert len(audio) == 8 * engine.hp.total_upsample
    assert "truncated" in caplog.text


def test_speaker_id_range_is_checked(voice):
    engine = voice.engine
    hp = engine.hp
    try:
        engine.hp = dataclasses.replace(hp, n_speakers=2)
        with pytest.raises(ValueError, match="out of range"):
            engine._check_speakers([2])
    finally:
        engine.hp = hp


def test_foreign_weights_raise_naming_the_roadmap(tmp_path, voice_files):
    """Weights in no known layout route to the ONNX graph engine on the
    voice's device; this voice's graph is empty (no nodes, no outputs), so
    synthesizing from it raises naming that."""
    from phoonnx_tpu_torch.infer.onnx_engine import OnnxFallbackEngine

    model_path = tmp_path / "foreign.onnx"
    write_onnx(str(model_path),
               {"some.other.graph.weight": np.zeros((4, 4), np.float32)},
               metadata={"model_type": "vits"})
    config_path = voice_files[1]
    voice = TTSVoice.load(str(model_path), str(config_path), device="cpu")
    assert isinstance(voice.engine, OnnxFallbackEngine)
    assert voice.engine.runner.device == torch.device("cpu")
    with pytest.raises(ValueError, match="declares no outputs"):
        voice.phoneme_ids_to_audio([1, 4, 5, 2])


def test_other_dtypes_are_refused(voice_files):
    """float32 and bfloat16 load (tests/test_torch_bf16.py holds bf16);
    another dtype is refused, naming the two."""
    voice = TTSVoice.load(*map(str, voice_files), dtype="bfloat16",
                          device="cpu")
    assert voice.engine.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="float32"):
        TTSVoice.load(*map(str, voice_files), dtype="float16", device="cpu")
