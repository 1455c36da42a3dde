"""Foreign ONNX voices on the port's graph engine, held against the JAX package.

The counterparts of tests/test_onnx_fallback.py, on the CPU
(``device="cpu"``): a micro voice whose executable VITS graph has every
initializer renamed (``chip_smoke.write_foreign_voice``, the port's own
``vits_graph`` exporter over the port's random parameters) cannot be
imported by name, so ``TTSVoice.load`` runs it on
``OnnxFallbackEngine``. Its seeded audio is held against the JAX
package's ``OnnxExecutor`` reseeded and run on the same bucket-padded
feeds, which is what the JAX engine returns for a seeded call. The same
holds for an int8-QDQ export. The server and the synthesize CLI serve
such a voice too.
"""

import io
import json
import os
import wave

import numpy as np
import pytest
import torch

from phoonnx_tpu.onnx.executor import OnnxExecutor as JaxExecutor
from phoonnx_tpu.onnx.reader import read_onnx as jax_read_onnx

import chip_smoke
from phoonnx_tpu_torch import SynthesisConfig, TTSVoice
from phoonnx_tpu_torch.infer.onnx_engine import (
    OnnxFallbackEngine,
    _bucket_len,
    _HpShim,
)
from phoonnx_tpu_torch.models.vits.model import VitsHParams, random_params
from phoonnx_tpu_torch.onnx.reader import read_onnx

from tests.test_torch_train_forward import one_torch_thread  # noqa: F401

IDS = [1, 5, 9, 3, 7, 2, 11, 4]
SCALES = (0.667, 1.0, 0.8)
# the port's graph on the CPU's torch against the JAX package's numpy
# interpreter (jax.lax convs): measured 2.5e-7 to 3.3e-7 of the peak
# (float32 and int8 QDQ, seeds 3 and 11); JAX holds its own runner to
# 5e-3 of the peak
JAX_TOL = 1e-6


@pytest.fixture(scope="module")
def voices(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_foreign")
    hp = VitsHParams.preset("micro")
    params = random_params(hp, torch.Generator().manual_seed(0))
    return {
        "float32": chip_smoke.write_foreign_voice(torch, params, hp, tmp),
        "int8": chip_smoke.write_foreign_voice(torch, params, hp, tmp,
                                               "foreign_q8", quantize=True),
    }


@pytest.fixture(scope="module")
def voice(voices):
    return TTSVoice.load(*map(str, voices["float32"]), device="cpu")


def jax_reference(model_path, ids, seed):
    """What the JAX engine returns for a seeded call: its interpreter,
    reseeded, on the ids padded to the engine's bucket."""
    n = len(ids)
    feeds = {"input": np.asarray([ids + [0] * (_bucket_len(n) - n)],
                                 np.int64),
             "input_lengths": np.asarray([n], np.int64),
             "scales": np.asarray(SCALES, np.float32)}
    executor = JaxExecutor(jax_read_onnx(str(model_path)))
    executor.reseed(seed)
    return np.asarray(executor.run(feeds)[0], np.float32).reshape(-1)


@pytest.mark.parametrize("kind", ["float32", "int8"])
def test_foreign_voice_routes_to_the_graph_engine(voices, kind, caplog):
    with caplog.at_level("WARNING"):
        voice = TTSVoice.load(*map(str, voices[kind]), device="cpu")
    assert isinstance(voice.engine, OnnxFallbackEngine)
    assert voice.engine.runner.device == torch.device("cpu")
    assert voice.engine.compiled_batching is False
    assert any("falling back" in r.getMessage() for r in caplog.records)
    audio = voice.phoneme_ids_to_audio(IDS, SynthesisConfig(seed=1))
    assert audio.ndim == 1 and len(audio) > 0 and np.abs(audio).max() > 0


@pytest.mark.parametrize("kind", ["float32", "int8"])
def test_seeded_audio_matches_the_jax_engine(voices, kind):
    voice = TTSVoice.load(*map(str, voices[kind]), device="cpu")
    for seed in (3, 11):
        got = voice.engine.synthesize_ids(IDS, *SCALES, seed=seed)
        want = jax_reference(voices[kind][0], IDS, seed)
        assert got.shape == want.shape
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= JAX_TOL, (kind, seed, err)


def test_runner_keeps_floats_and_data_on_the_device(voice):
    """Host values are small integers (shape arithmetic); the one read
    of a device value is the frame count (``Range``)."""
    engine = voice.engine
    engine.synthesize_ids(IDS, seed=0)
    stats = engine.runner.last_run
    assert stats.nodes == len(engine.runner.model.nodes)
    assert stats.outputs["cpu"] > 10 * stats.outputs["host"]
    for op, name, dtype, numel in stats.host_outputs:
        assert np.dtype(dtype).kind in "biu" and numel <= 8, (op, name)
    assert dict(stats.reads) == {"Range": 1}
    assert "RandomNormalLike" not in stats.host_nodes


def test_batch_items_equal_single_calls(voice):
    engine = voice.engine
    batch = [IDS[:4], IDS, IDS[2:7]]
    audio, lengths = engine.synthesize_batch(batch, seed=5)
    for i, ids in enumerate(batch):
        solo = engine.synthesize_ids(ids, seed=5 + i)
        assert lengths[i] == len(solo)
        np.testing.assert_array_equal(audio[i, :lengths[i]], solo)
        assert not audio[i, lengths[i]:].any()


def test_stream_equals_monolithic(voice):
    cfg = SynthesisConfig(normalize_audio=False, seed=7)
    mono = np.concatenate([c.audio_float_array
                           for c in voice.synthesize("[[abc def]]", cfg)])
    streamed = list(voice.synthesize_streaming("[[abc def]]", cfg,
                                               chunk_frames=1))
    assert len(streamed) > 1
    np.testing.assert_array_equal(
        np.concatenate([c.audio_float_array for c in streamed]), mono)


def test_seeds_repeat_and_differ(voice):
    engine = voice.engine
    a = engine.synthesize_ids(IDS, seed=42)
    np.testing.assert_array_equal(a, engine.synthesize_ids(IDS, seed=42))
    c = engine.synthesize_ids(IDS, seed=43)
    assert len(a) != len(c) or np.abs(a - c).max() > 1e-4


def test_interpreter_agrees_with_the_runner(voices):
    """``compile=False`` (the port's numpy interpreter) against the
    runner on the same feeds: 16 ids fill their bucket, so neither
    pads."""
    model = read_onnx(str(voices["float32"][0]))
    ids = (IDS * 2)[:16]
    assert _bucket_len(len(ids)) == len(ids)
    runner = OnnxFallbackEngine(model, 16000, device="cpu")
    interp = OnnxFallbackEngine(model, 16000, compile=False, device="cpu")
    assert interp.runner is None
    a = runner.synthesize_ids(ids, seed=9)
    b = interp.synthesize_ids(ids, seed=9)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= JAX_TOL * np.abs(b).max()


def test_warmup_runs_one_request(voices):
    engine = OnnxFallbackEngine(read_onnx(str(voices["float32"][0])), 16000,
                                device="cpu")
    assert engine.runner.last_run is None
    engine.warmup(batch_sizes=(1, 2))
    assert engine.runner.last_run.nodes == len(engine.runner.model.nodes)


def test_runner_error_raises(voice, monkeypatch):
    """No silent degrade to the interpreter: the runner's error surfaces,
    and the engine keeps its runner."""
    engine = voice.engine

    def boom(*a, **k):
        raise RuntimeError("device fault")

    monkeypatch.setattr(engine.runner, "run", boom)
    with pytest.raises(RuntimeError, match="device fault"):
        engine.synthesize_ids(IDS, seed=0)
    assert engine.runner is not None


def test_unknown_op_raises_through_the_engine(tmp_path):
    from phoonnx_tpu_torch.onnx.writer import write_onnx

    path = tmp_path / "odd.onnx"
    write_onnx(str(path), {}, inputs=["input", "input_lengths", "scales"],
               outputs=["output"],
               nodes=[("NoSuchOp", ["scales"], ["output"], {})])
    engine = OnnxFallbackEngine(read_onnx(str(path)), 16000, device="cpu")
    with pytest.raises(NotImplementedError, match="NoSuchOp"):
        engine.synthesize_ids(IDS, seed=0)


def test_no_path_hides_the_device(voices, monkeypatch):
    """compile=False with CUDA raises; the JAX engine's environment
    switch does nothing; without a GPU a foreign voice loads only with
    device='cpu'."""
    model = read_onnx(str(voices["float32"][0]))
    monkeypatch.setenv("PHOONNX_ONNX_FALLBACK_COMPILE", "0")
    assert OnnxFallbackEngine(model, 16000, device="cpu").runner is not None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TTSVoice.load(*map(str, voices["float32"]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OnnxFallbackEngine(model, 16000)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="compile=False"):
        OnnxFallbackEngine(model, 16000, compile=False, device="cuda")
    assert os.environ["PHOONNX_ONNX_FALLBACK_COMPILE"] == "0"


def test_streaming_chunk_size_scales_with_sample_rate():
    """Chunk pacing is time-consistent across voices (a frame is hop 256
    at 22.05 kHz, scaled to the voice's rate)."""

    class _Probe(OnnxFallbackEngine):
        def __init__(self, sample_rate):
            self.hp = _HpShim(sample_rate)

        def _run_one(self, *a, **k):
            return np.zeros(100000, np.float32)

    chunks_22k = list(_Probe(22050).synthesize_ids_streaming(
        [1], chunk_frames=128))
    assert len(chunks_22k[0]) == 128 * 256
    chunks_16k = list(_Probe(16000).synthesize_ids_streaming(
        [1], chunk_frames=128))
    assert len(chunks_16k[0]) == 128 * round(16000 * 256 / 22050)


# -- serving and the CLI ----------------------------------------------------


def _pcm(wav_bytes):
    with wave.open(io.BytesIO(wav_bytes), "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def test_server_over_a_foreign_voice(voice, caplog):
    """Two devices asked, one served, with the JAX server's warning; a
    sentence past the native engine's largest text bucket is not refused;
    a seeded request equals the engine's direct output within one int16
    step, and the engine gets no pad lanes."""
    import http.client

    from phoonnx_tpu_torch.serve import DynamicBatcher, TTSServer

    with caplog.at_level("WARNING"):
        srv = TTSServer(voice, port=0, max_batch=4, max_wait_ms=5.0,
                        devices=["cpu", "cpu"])
    assert isinstance(srv.batcher, DynamicBatcher)
    assert any("non-replicable" in r.getMessage() for r in caplog.records)
    calls = []
    engine = voice.engine
    real = engine.synthesize_batch

    def spy(batch_ids, **kw):
        calls.append(len(batch_ids))
        return real(batch_ids, **kw)

    engine.synthesize_batch = spy
    srv.start()
    try:
        long_text = "[[" + " ".join(["abcd"] * 240) + "]]"
        assert len(voice.phonemes_to_ids(voice.phonemize(long_text)[0])) \
            > 1024
        assert srv._prepare(voice, long_text, SynthesisConfig())
        host, port = srv.address
        texts = ["[[abc def]]", "[[gh ij]]"]
        conn = http.client.HTTPConnection(host, port, timeout=120)
        conn.request("POST", "/synthesize", body=json.dumps(
            {"text": " ".join(texts).replace("]] [[", ". "), "seed": 4}),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        assert resp.status == 200, data
        got = _pcm(data)
    finally:
        srv.stop()
        engine.synthesize_batch = real
    ids = [voice.phonemes_to_ids(ph) for ph in voice.phonemize(
        " ".join(texts).replace("]] [[", ". ")) if ph]
    want = voice.engine.synthesize_batch(ids, seed=4)
    audio = np.concatenate([want[0][i, :n] for i, n in enumerate(want[1])])
    ref = np.clip(audio * 32767.0, -32767.0, 32767.0).astype(np.int16)
    assert got.shape == ref.shape
    assert np.abs(got.astype(np.int32) - ref).max() <= 1
    assert calls == [len(ids)]


def test_synthesize_cli_on_a_foreign_voice(voices, tmp_path):
    from phoonnx_tpu_torch.synthesize import main

    out = tmp_path / "foreign.wav"
    main(["-m", str(voices["float32"][0]), "-o", str(out), "-t",
          "[[abc def]]", "--device", "cpu", "--seed", "1"])
    with wave.open(str(out), "rb") as f:
        assert f.getnframes() > 0
        assert f.getframerate() == 16000
