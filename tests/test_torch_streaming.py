"""The port's streaming decode: chunked output equals the monolithic decode.

The port's counterparts of tests/test_streaming.py, on the CPU (the plain
versions of the kernels). ``VitsEngine.synthesize_ids_streaming`` decodes
the latent frames in overlapping windows; with the same seed the
concatenated stream must equal ``synthesize_ids``. The latent buffer is
the utterance's frame bucket, as in the JAX engine, and the final chunk's
offset clamp fires when the last chunk's window would overrun it; each
multi-chunk case checks that the windowed loop really ran. The chunk
arithmetic itself is held to the JAX engine's decode-chunk program on the
same latents (the two engines draw their noise differently).
"""

import json
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from phoonnx_tpu.infer.engine import VitsEngine as JaxEngine
from phoonnx_tpu.models.vits.model import VitsHParams as JaxHParams
from phoonnx_tpu_torch import SynthesisConfig, TTSVoice
from phoonnx_tpu_torch.infer import VitsEngine
from phoonnx_tpu_torch.models.vits.load import params_to_flat
from phoonnx_tpu_torch.models.vits.model import VitsHParams, random_params
from phoonnx_tpu_torch.onnx.writer import write_onnx

from tests.test_torch_infer import port_hparams
from tests.test_torch_istft import detached
from tests.test_torch_train_forward import make_models
from tests.test_torch_train_forward import one_torch_thread  # noqa: F401

# the bound of tests/test_streaming.py: the windows' convs sum the same
# terms as the monolithic decode's, at other positions of the buffer
STREAM_TOL = 2e-5

IDS = [1, 5, 9, 3, 7, 2, 8, 4, 6, 1, 5, 9, 2, 7] * 3

ISTFT = dict(decoder_type="istft", upsample_rates=(4,),
             upsample_kernel_sizes=(8,), istft_n_fft=16)


def _engine(hp, seed=0):
    return VitsEngine(random_params(hp, torch.Generator().manual_seed(seed)),
                      hp, device="cpu")


def _stream_vs_full(eng, ids, chunk, overlap, seed=42):
    """The stream and the monolithic decode of ``ids``; returns
    (chunks, frames)."""
    full = eng.synthesize_ids(ids, seed=seed)
    chunks = list(eng.synthesize_ids_streaming(
        ids, chunk_frames=chunk, overlap_frames=overlap, seed=seed))
    stream = np.concatenate(chunks)
    assert stream.shape == full.shape
    np.testing.assert_allclose(stream, full, atol=STREAM_TOL, rtol=0)
    return chunks, len(full) // eng.hp.total_upsample


@pytest.mark.parametrize("quality,overrides,chunk,overlap", [
    # micro decoder receptive field ~7 latent frames; overlap 8 covers it
    ("micro", {}, 8, 8),
    # x-low carries the full medium HiFi-GAN decoder (upsample (8, 8, 4),
    # dilations up to 12): the deepest field the overlap must cover
    ("x-low", {}, 8, 16),
    ("micro", dict(ISTFT, istft_hop=4), 8, 10),
    # multi-band: the PQMF synthesis is one stride-N transposed conv
    ("micro", dict(ISTFT, istft_hop=2, istft_bands=2), 8, 12),
], ids=["micro", "x-low", "istft", "mb-istft"])
def test_streaming_matches_monolithic(quality, overrides, chunk, overlap):
    hp = VitsHParams.preset(quality, **overrides)
    chunks, frames = _stream_vs_full(_engine(hp), IDS, chunk, overlap)
    # the windowed loop ran: more frames than the first window holds
    assert frames > chunk + 2 * overlap
    assert len(chunks) == math.ceil(frames / chunk)


def test_streaming_final_chunk_clamp():
    """A partial final chunk: its window is clamped to the buffer's end and
    its kept-span offset with it, with a matching emission skip (the
    unclamped arithmetic re-emits earlier audio). Frame buckets 8 apart
    keep the buffer close to the utterance, so a chunk size that leaves
    more than two chunks reaches the clamp."""
    hp = VitsHParams.preset("micro")
    eng = VitsEngine(random_params(hp, torch.Generator().manual_seed(0)), hp,
                     frame_buckets=tuple(range(8, 4097, 8)), device="cpu")
    n = len(eng.synthesize_ids(IDS, seed=42)) // eng.hp.total_upsample
    total = eng._frame_bucket_clamped(n)
    overlap = 8
    trigger = None
    for chunk in range(overlap + 1, n - 2 * overlap):
        window = chunk + 2 * overlap
        i = math.ceil(n / chunk) - 1
        start = min(max(i * chunk - overlap, 0), total - window)
        if i * chunk - start > window - chunk:
            trigger = chunk
            break
    assert trigger is not None, f"no chunk size triggers the clamp for n={n}"
    chunks, _ = _stream_vs_full(eng, IDS, trigger, overlap)
    assert len(chunks) == math.ceil(n / trigger) > 2


def test_streaming_single_chunk_short_utterance():
    eng = _engine(VitsHParams.preset("micro"))
    full = eng.synthesize_ids([1, 2], seed=7)
    chunks = list(eng.synthesize_ids_streaming(
        [1, 2], chunk_frames=4096, overlap_frames=32, seed=7))
    assert len(chunks) == 1
    np.testing.assert_allclose(chunks[0], full, atol=STREAM_TOL, rtol=0)


@pytest.mark.parametrize("family", ["hifigan", "mb-istft"])
def test_decode_chunk_matches_jax_program(family):
    """The port's ``_decode_chunk`` against the JAX engine's
    ``_get_decode_chunk`` program on the same latents and positions:
    interior windows, the buffer's last window, and windows that reach
    past the utterance's end, compared on the utterance's span."""
    overrides = {} if family == "hifigan" else dict(
        ISTFT, istft_hop=2, istft_bands=2)
    jhp = JaxHParams.preset("micro", n_vocab=40, **overrides)
    jg, _, tg, _, _ = make_models(jhp)
    jax_eng = JaxEngine(jg, jhp, text_buckets=(16,), frame_buckets=(64,))
    eng = VitsEngine(detached(tg), port_hparams(jhp), device="cpu")
    total, chunk, overlap = 64, 8, 8
    window = chunk + 2 * overlap
    program = jax_eng._get_decode_chunk(1, total, chunk, overlap)
    params = jax_eng._params_for_frames(window)
    z = (np.random.default_rng(3).standard_normal(
        (1, total, jhp.inter_channels)) * 0.5).astype(np.float32)
    for start, offset, y_len in ((0, 0, 64), (16, 8, 64), (40, 16, 64),
                                 (20, 8, 37), (24, 8, 37)):
        want = np.asarray(program(
            params, jnp.asarray(z), jnp.asarray(start, jnp.int32),
            jnp.asarray(offset, jnp.int32), jnp.asarray(y_len, jnp.int32),
            None))
        got = eng._decode_chunk(torch.from_numpy(z), start, offset, y_len,
                                None, window, chunk).numpy()
        up = jhp.total_upsample
        assert got.shape == want.shape == (1, chunk * up)
        # past the utterance the port's decoder writes zeros (kernel C's
        # mask) and the JAX XLA path does not; the engine never emits it
        keep = (min(y_len - start, offset + chunk) - offset) * up
        assert keep > 0
        np.testing.assert_allclose(got[:, :keep], want[:, :keep], atol=1e-5,
                                   rtol=1e-5,
                                   err_msg=str((start, offset, y_len)))


@pytest.fixture(scope="module")
def voice(tmp_path_factory):
    """A micro voice written with the port's own ONNX writer."""
    tmp = tmp_path_factory.mktemp("torch_stream_voice")
    hp = VitsHParams.preset("micro", n_vocab=20)
    flat = params_to_flat(random_params(hp, torch.Generator().manual_seed(1)))
    model_path = tmp / "model.onnx"
    write_onnx(str(model_path), flat,
               metadata={"model_type": "vits", "sample_rate": "16000"},
               inputs=["input", "input_lengths", "scales"],
               outputs=["output"])
    id_map = {"_": 0, "^": 1, "$": 2, " ": 3}
    id_map.update({c: i + 4 for i, c in enumerate("abcdefghijklmnop")})
    config = {
        "phoneme_type": "raw", "lang_code": "en", "alphabet": "ipa",
        "phoneme_id_map": id_map, "num_symbols": len(id_map),
        "num_speakers": 1, "audio": {"sample_rate": 16000},
        "inference": {"noise_scale": 0.667, "length_scale": 1.0,
                      "noise_w": 0.8},
    }
    config_path = tmp / "model.onnx.json"
    config_path.write_text(json.dumps(config), encoding="utf-8")
    return TTSVoice.load(str(model_path), str(config_path), device="cpu")


def test_voice_stream_equals_synthesize(voice):
    text = "abcde fghij klmno pabcd efghi jklmn"
    cfg = SynthesisConfig(seed=11, normalize_audio=False, volume=0.8)
    whole = [c.audio_float_array for c in voice.synthesize(text, cfg)]
    parts = [c.audio_float_array for c in voice.synthesize_streaming(
        text, cfg, chunk_frames=8, overlap_frames=8)]
    assert len(whole) == 1 and len(parts) > 2
    assert all(p.dtype == np.float32 for p in parts)
    np.testing.assert_allclose(np.concatenate(parts), whole[0],
                               atol=STREAM_TOL, rtol=0)


def test_streaming_multi_speaker_matches_monolithic():
    """A multi-speaker voice: the speaker embedding from the first-chunk
    program conditions the latents and every window's decode."""
    hp = VitsHParams.preset("micro", n_speakers=3, gin_channels=16)
    eng = _engine(hp, seed=4)
    full = eng.synthesize_ids(IDS, speaker_id=2, seed=9)
    chunks = list(eng.synthesize_ids_streaming(
        IDS, chunk_frames=8, overlap_frames=8, speaker_id=2, seed=9))
    np.testing.assert_allclose(np.concatenate(chunks), full,
                               atol=STREAM_TOL, rtol=0)
    assert len(chunks) > 2
    other = eng.synthesize_ids(IDS, speaker_id=0, seed=9)
    assert other.shape != full.shape or np.abs(other - full).max() > 1e-3
