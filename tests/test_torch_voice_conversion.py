"""Voice conversion in the port against the JAX package, on the CPU.

``model.voice_conversion`` (posterior encoder and forward flow with the
source speaker, the reverse flow, kernel B's function, and the decoder,
kernel C's, with the target) against the JAX function on the same weights
and the same injected noise; ``VitsEngine.voice_conversion`` and
``TTSVoice.voice_conversion`` against the model function and the JAX
engine's output length, with their speaker checks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoonnx_tpu.infer.engine import VitsEngine as JaxEngine
from phoonnx_tpu.models.vits import model as jax_model
from phoonnx_tpu_torch import TTSVoice
from phoonnx_tpu_torch.infer import VitsEngine
from phoonnx_tpu_torch.models.vits import model as port_model
from phoonnx_tpu_torch.models.vits.model import VitsHParams
from phoonnx_tpu_torch.ops import noise
from phoonnx_tpu_torch.ops.stft import spectrogram

from tests.test_torch_cli import write_port_voice
from tests.test_torch_infer import port_params, randomize_flow_post
from tests.test_torch_train_forward import one_torch_thread  # noqa: F401
from tests.test_voice_e2e import SMALL_HP

# the end-to-end waveform bound (ARCHITECTURE.md:86-89); the measured
# difference in test_model_voice_conversion_matches_jax is 4.8e-7, both
# sides f32 on the CPU
WAVE_TOL = 1e-3

_j_vc = jax.jit(jax_model.voice_conversion, static_argnums=(1,))


@pytest.fixture(scope="module")
def models():
    hp = dataclasses.replace(SMALL_HP, n_speakers=3, gin_channels=16)
    jp = randomize_flow_post(jax_model.random_params(jax.random.PRNGKey(5),
                                                     hp))
    tp, thp = port_params(jp, hp)
    return jp, hp, VitsEngine(tp, thp, frame_buckets=(64, 128),
                              device="cpu")


def _tone(n, seed=0):
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(2 * np.pi * 200 * np.arange(n) / 22050)
            + 0.02 * rng.standard_normal(n)).astype(np.float32)


def test_model_voice_conversion_matches_jax(models):
    jp, hp, eng = models
    rng = np.random.default_rng(1)
    t = 64
    spec = np.abs(rng.standard_normal((2, t, hp.spec_channels))).astype(
        np.float32)
    lengths = np.asarray([64, 41], np.int32)
    spec[1, 41:] = 0.0
    noise = rng.standard_normal((2, t, hp.inter_channels)).astype(np.float32)
    sid_src, sid_tgt = np.asarray([0, 2], np.int32), np.asarray([2, 1],
                                                               np.int32)
    want, want_mask = _j_vc(jp, hp, jnp.asarray(spec), jnp.asarray(lengths),
                            jnp.asarray(sid_src), jnp.asarray(sid_tgt),
                            noise=jnp.asarray(noise))
    got, mask = port_model.voice_conversion(
        eng.params, eng.hp, *[torch.from_numpy(a) for a in (
            spec, lengths, sid_src, sid_tgt)], noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    up = hp.total_upsample
    assert got.shape == want.shape == (2, t * up)
    for i, n in enumerate(lengths):
        err = np.abs(got[i, :n * up].numpy() - np.asarray(want)[i, :n * up])
        assert err.max() < WAVE_TOL, (i, err.max())


def test_model_voice_conversion_needs_speakers_and_noise(models):
    _, _, eng = models
    spec = torch.zeros(1, 8, eng.hp.spec_channels)
    args = (spec, torch.tensor([8], dtype=torch.int32), torch.tensor([0]),
            torch.tensor([1]))
    with pytest.raises(ValueError, match="generator"):
        port_model.voice_conversion(eng.params, eng.hp, *args)
    single = dataclasses.replace(eng.hp, n_speakers=1)
    with pytest.raises(ValueError, match="multi-speaker"):
        port_model.voice_conversion(eng.params, single, *args,
                                    noise=torch.zeros(1, 8, 32))


def test_engine_voice_conversion_trims_and_checks(models):
    """The engine pads the spectrogram to its frame bucket, draws its noise
    from the seed, and trims to frames x hop: equal to the model function
    on the exact-length spectrogram, and as long as the JAX engine's
    output."""
    jp, hp, eng = models
    audio = _tone(30 * hp.total_upsample + 100)
    out = eng.voice_conversion(audio, 0, 2, seed=4)
    n_fft = (hp.spec_channels - 1) * 2
    spec = spectrogram(torch.from_numpy(audio)[None], n_fft,
                       hp.total_upsample, n_fft)
    n = spec.shape[1]
    prior = noise.normal_plain(4, 1, n, hp.inter_channels, noise.PRIOR)
    want, _ = port_model.voice_conversion(
        eng.params, eng.hp, spec, torch.tensor([n], dtype=torch.int32),
        torch.tensor([0]), torch.tensor([2]), noise=prior)
    assert out.dtype == np.float32 and len(out) == n * hp.total_upsample
    np.testing.assert_allclose(out, want[0].numpy(), atol=1e-5, rtol=0)
    jax_out = JaxEngine(jp, hp, frame_buckets=(64, 128)).voice_conversion(
        audio, 0, 2, seed=4)
    assert len(jax_out) == len(out)
    with pytest.raises(ValueError, match="out of range"):
        eng.voice_conversion(audio, 0, 3)
    with pytest.raises(ValueError, match="out of range"):
        eng.voice_conversion(audio, -1, 1)


def test_voice_conversion_through_the_voice(tmp_path):
    hp = dataclasses.replace(VitsHParams.preset("micro", n_vocab=20),
                             n_speakers=3, gin_channels=16)
    path = write_port_voice(tmp_path / "ms.onnx", hp, 3)
    voice = TTSVoice.load(str(path), device="cpu")
    audio = _tone(4000)
    out = voice.voice_conversion(audio, 1, 0, seed=2)
    np.testing.assert_array_equal(
        out, voice.engine.voice_conversion(audio, 1, 0, seed=2))
    assert len(out) % hp.total_upsample == 0
    assert abs(len(out) - len(audio)) <= hp.total_upsample
    assert np.isfinite(out).all() and np.abs(out).max() > 0
    with pytest.raises(ValueError, match="out of range"):
        voice.voice_conversion(audio, 0, 3)


def test_single_speaker_voice_raises(tmp_path):
    path = write_port_voice(tmp_path / "one.onnx",
                            VitsHParams.preset("micro", n_vocab=20), 4)
    voice = TTSVoice.load(str(path), device="cpu")
    with pytest.raises(ValueError, match="multi-speaker"):
        voice.voice_conversion(_tone(2000), 0, 0)
