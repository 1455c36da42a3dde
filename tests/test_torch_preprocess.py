"""The port's preprocessing against the JAX package's, on the CPU.

The corpus is the six 16 kHz tone WAVs of
``tests/test_train_pipeline.py:18-41`` plus one 22050 Hz stereo int16 file
with silence around its tone (mono mixing, resampling and trimming). Both
packages' ``run_preprocess`` run on it (graphemes / unicode, one worker,
n_fft 128, hop 16, win 128; the port with ``device="cpu"``, the plain
PyTorch STFT), each once a module (JAX's worker as a thread of the test
process, its code unchanged):

* ``dataset.jsonl`` is equal but for the cache directory (the cache file
  names are the same sha256 keys), ``config.json`` is equal;
* the trimmed audio is bit-equal: load, resample, the energy VAD and the
  trim are the same numpy and scipy code in both;
* the spectrograms agree within 1e-5 of their largest value (the STFT is
  float32 in both frameworks, summed in other orders).

The Silero path runs the fake VAD graph of ``tests/test_vad_model.py:22``
(built here with the port's ONNX writer) on the port's graph runner and on
JAX's numpy interpreter: equal trim points. A VAD model that cannot run
raises, and ``device`` defaults to the card and raises without one.
"""

import json
import math
import queue
import threading
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from phoonnx_tpu_torch.onnx.writer import write_onnx
from phoonnx_tpu_torch.train import audio as port_audio
from phoonnx_tpu_torch.train import preprocess as port_preprocess

SPEC_TOL = 1e-5
CHUNK = 480
KW = dict(language="en", phoneme_type="graphemes", alphabet="unicode",
          sample_rate=16000, max_workers=1, single_speaker=True, n_fft=128,
          hop_length=16, win_length=128)


def write_wav(path: Path, audio: np.ndarray, sr: int) -> None:
    """int16 WAV; ``audio`` [N] or [N, channels] in [-1, 1]."""
    pcm = (np.clip(audio, -1, 1) * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1 if pcm.ndim == 1 else pcm.shape[1])
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    wav_dir = root / "wavs"
    wav_dir.mkdir()
    texts = ["hello world", "testing one two", "the quick brown fox",
             "jumped over", "a lazy dog", "goodbye now"]
    sr = 16000
    rng = np.random.default_rng(0)
    lines = []
    for i, text in enumerate(texts):
        t = np.arange(int(sr * 0.5)) / sr
        freq = 150 + 40 * i
        audio = (0.4 * np.sin(2 * math.pi * freq * t)
                 + 0.05 * rng.standard_normal(len(t))).astype(np.float32)
        write_wav(wav_dir / f"utt{i}.wav", audio, sr)
        lines.append(f"utt{i}|{text}")
    # 22050 Hz stereo: 0.3 s of faint noise, 0.6 s of tone, 0.3 s of noise
    sr = 22050
    n = int(0.3 * sr)
    t = np.arange(2 * n) / sr
    tone = 0.5 * np.sin(2 * math.pi * 220 * t)
    mono = np.concatenate([np.zeros(n), tone, np.zeros(n)])
    mono += 0.002 * rng.standard_normal(len(mono))
    stereo = np.stack([mono, 0.5 * mono], axis=1)
    write_wav(wav_dir / "stereo.wav", stereo, sr)
    lines.append("stereo|a stereo file")
    (root / "metadata.csv").write_text("\n".join(lines), encoding="utf-8")
    return root


class _ThreadContext:
    """A stand-in for ``multiprocessing.get_context("spawn")`` whose
    workers are threads of this process: JAX's own ``run_preprocess`` and
    worker code, without a spawned JAX process's ~5 s of imports."""

    JoinableQueue = queue.Queue
    Queue = queue.Queue

    class Process(threading.Thread):
        exitcode = None

        def __init__(self, target, args, daemon):
            super().__init__(target=target, args=args, daemon=daemon)


@pytest.fixture(scope="module")
def jax_out(corpus, tmp_path_factory):
    from phoonnx_tpu.train import preprocess as jax_preprocess

    out = tmp_path_factory.mktemp("jax") / "data" / "ds"
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_preprocess.multiprocessing, "get_context",
                      lambda method: _ThreadContext)
        jax_preprocess.run_preprocess(input_dir=str(corpus),
                                      output_dir=str(out), **KW)
    return out


@pytest.fixture(scope="module")
def port_out(corpus, tmp_path_factory):
    out = tmp_path_factory.mktemp("port") / "data" / "ds"
    port_preprocess.run_preprocess(input_dir=str(corpus), output_dir=str(out),
                                   device="cpu", **KW)
    return out


def rows(out: Path):
    return [json.loads(line) for line in
            (out / "dataset.jsonl").read_text(encoding="utf-8").splitlines()]


def test_outputs_equal_jax(jax_out, port_out):
    assert json.loads((port_out / "config.json").read_text()) == json.loads(
        (jax_out / "config.json").read_text())
    ours, theirs = rows(port_out), rows(jax_out)
    assert len(ours) == len(theirs) == 7
    worst = 0.0
    for a, b in zip(ours, theirs):
        for key in ("audio_norm_path", "audio_spec_path"):
            pa, pb = Path(a.pop(key)), Path(b.pop(key))
            assert pa.name == pb.name and pa.parent == port_out / "cache" / \
                "16000" and pb.parent == jax_out / "cache" / "16000"
            got, want = np.load(pa), np.load(pb)
            assert got.dtype == want.dtype == np.float32
            assert got.shape == want.shape, key
            if key == "audio_norm_path":
                np.testing.assert_array_equal(got, want)
            else:
                err = float(np.abs(got - want).max() / np.abs(want).max())
                worst = max(worst, err)
                assert err <= SPEC_TOL, (pa.name, err)
        assert a == b
    # the stereo file was mixed, resampled and trimmed
    stereo = [r for r in ours if r["audio_path"].endswith("stereo.wav")][0]
    assert stereo["phoneme_ids"]
    print(f"spectrograms: worst max-abs / peak {worst:.2e}")


def test_stereo_file_is_trimmed_and_resampled(port_out):
    row = [r for r in rows(port_out) if r["audio_path"].endswith(
        "stereo.wav")][0]
    trimmed = np.load(row["audio_norm_path"])
    # 1.2 s at 22050 Hz -> 19200 samples at 16 kHz; the noise around the
    # tone is cut but for the VAD's two chunks of context a side
    assert 0.6 * 16000 <= len(trimmed) < 19200
    spec = np.load(row["audio_spec_path"])
    assert spec.shape == ((len(trimmed) - 16) // 16 + 1, 65)


def test_cli_reuses_the_cache(corpus, port_out, tmp_path):
    """The argparse CLI on the CPU, into the same cache directory: every
    file is a cache hit, and the dataset is the same."""
    out = tmp_path / "data" / "ds"
    port_preprocess.main([
        "-i", str(corpus), "-o", str(out), "-l", "en", "--phoneme-type",
        "graphemes", "--alphabet", "unicode", "--sample-rate", "16000",
        "--max-workers", "1", "--single-speaker", "--n-fft", "128",
        "--hop-length", "16", "--win-length", "128", "--cache-dir",
        str(port_out / "cache" / "16000"), "--device", "cpu"])
    assert rows(out) == rows(port_out)


@pytest.fixture(scope="module")
def fake_vad_model(tmp_path_factory):
    """tests/test_vad_model.py's graph: prob = 20 * mean(|chunk|)."""
    path = tmp_path_factory.mktemp("vad") / "silero_vad.onnx"
    write_onnx(
        str(path),
        initializers={"gain": np.asarray(20.0, np.float32)},
        inputs=["input", "sr", "h", "c"],
        outputs=["prob", "h_out", "c_out"],
        nodes=[
            ("Abs", ["input"], ["absin"]),
            ("ReduceMean", ["absin"], ["mean"]),
            ("Mul", ["mean", "gain"], ["prob"]),
            ("Identity", ["h"], ["h_out"]),
            ("Identity", ["c"], ["c_out"]),
        ],
    )
    return path


def speech_like(n_lead, n_speech, n_trail, seed):
    """tests/test_vad_model.py's speech-shaped burst between noise."""
    rng = np.random.default_rng(seed)
    audio = 0.01 * rng.standard_normal(
        (n_lead + n_speech + n_trail) * CHUNK).astype(np.float32)
    t = np.arange(n_speech * CHUNK) / 16000.0
    env = 0.55 + 0.45 * np.sin(2 * np.pi * 3.0 * t + 0.7)
    voiced = (np.sin(2 * np.pi * 180 * t) + 0.5 * np.sin(2 * np.pi * 360 * t)
              + 0.25 * np.sin(2 * np.pi * 720 * t))
    s0 = n_lead * CHUNK
    audio[s0:s0 + n_speech * CHUNK] += (0.3 * env * voiced).astype(np.float32)
    return audio


def test_silero_trim_points_equal_jax(fake_vad_model, corpus, monkeypatch):
    """JAX's detector on its numpy interpreter (``PHOONNX_AUX_COMPILE=0``,
    the JAX package's own opt-out: the same graph, no compile)."""
    from phoonnx_tpu.train.audio import SileroVoiceActivityDetector as Jax
    from phoonnx_tpu.train.audio import trim_silence as jax_trim

    monkeypatch.setenv("PHOONNX_AUX_COMPILE", "0")
    ours = port_audio.SileroVoiceActivityDetector(str(fake_vad_model),
                                                  device="cpu")
    theirs = Jax(str(fake_vad_model))
    assert ours._executor is not None and theirs._executor is not None
    signals = [speech_like(8, 25, 8, 1), np.zeros(CHUNK * 4, np.float32),
               port_audio.read_for_cache(str(corpus / "wavs" / "stereo.wav"),
                                         16000)[0]]
    trims = []
    for audio in signals:
        got = port_audio.trim_silence(audio, ours)
        assert got == jax_trim(audio, theirs)
        trims.append(got)
    assert trims[0] != (0, len(signals[0])) and trims[1] == (0, CHUNK * 4)
    assert trims[2] != (0, len(signals[2]))


def test_preprocess_trims_with_the_silero_model(fake_vad_model, corpus,
                                                tmp_path, monkeypatch):
    """PHOONNX_VAD_MODEL reaches the port's detector: the stereo file's
    trimmed audio is the 16 kHz stream cut at the model's trim points."""
    monkeypatch.setenv("PHOONNX_VAD_MODEL", str(fake_vad_model))
    out = tmp_path / "data" / "ds"
    port_preprocess.run_preprocess(input_dir=str(corpus), output_dir=str(out),
                                   device="cpu", **KW)
    row = [r for r in rows(out) if r["audio_path"].endswith("stereo.wav")][0]
    audio_16k, _ = port_audio.read_for_cache(row["audio_path"], 16000)
    start, end = port_audio.trim_silence(
        audio_16k, port_audio.SileroVoiceActivityDetector(device="cpu"))
    np.testing.assert_array_equal(np.load(row["audio_norm_path"]),
                                  np.clip(audio_16k[start:end], -1, 1))


def test_a_vad_model_that_cannot_run_raises(corpus, tmp_path, monkeypatch):
    """No energy or interpreter fallback: a model whose graph reads an
    input the detector does not feed raises from the detector and from
    the preprocessor, and a file that is no model raises at build."""
    broken = tmp_path / "broken.onnx"
    write_onnx(str(broken), initializers={},
               inputs=["input", "sr", "h", "c", "missing"],
               outputs=["prob"],
               nodes=[("Add", ["input", "missing"], ["prob"])])
    detector = port_audio.SileroVoiceActivityDetector(str(broken),
                                                      device="cpu")
    with pytest.raises(Exception):
        detector.speech_probs(speech_like(2, 4, 2, 0))
    monkeypatch.setenv("PHOONNX_VAD_MODEL", str(broken))
    with pytest.raises(RuntimeError, match="stereo.wav|utt0.wav"):
        port_preprocess.run_preprocess(
            input_dir=str(corpus), output_dir=str(tmp_path / "o" / "ds"),
            device="cpu", **KW)
    garbage = tmp_path / "garbage.onnx"
    garbage.write_bytes(b"not a model")
    with pytest.raises(Exception):
        port_audio.SileroVoiceActivityDetector(str(garbage), device="cpu")


def test_device_defaults_to_the_card(corpus, tmp_path, monkeypatch,
                                     fake_vad_model):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_preprocess.run_preprocess(
            input_dir=str(corpus), output_dir=str(tmp_path / "d" / "ds"),
            **KW)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_preprocess.main(["-i", str(corpus), "-o", str(tmp_path / "e"),
                              "-l", "en", "--phoneme-type", "graphemes"])
    # the detector's model and the cache's spectrogram too
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_audio.SileroVoiceActivityDetector(str(fake_vad_model))
    wav = sorted((corpus / "wavs").glob("*.wav"))[0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_audio.cache_norm_audio(str(wav), str(tmp_path / "c"), 16000,
                                    n_fft=128, hop_length=16, win_length=128)
