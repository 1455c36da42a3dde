"""Audio preprocessing: load, resample, silence trim, cached spectrograms.

PyTorch port of ``phoonnx_tpu/train/audio.py`` (reference
phoonnx_train/norm_audio): sha256-keyed cache of the trimmed waveform and
its linear spectrogram (n_fft 1024, hop 256, win 1024, center=False —
norm_audio/__init__.py:21-92). WAV I/O and resampling use scipy on the
host; caches are .npy (the dataset loader also reads the reference's .pt
caches). The spectrogram is the port's ``ops/stft.spectrogram`` on a
torch device.

Silence trimming mirrors the reference shape (16 kHz stream, 480-sample
chunks, keep 2 chunks of context — norm_audio/trim.py:8-54) with a
Silero-VAD ONNX model when one resolves, run on
:class:`~phoonnx_tpu_torch.onnx.torch_lowering.TorchGraphRunner` on the
detector's device, and an energy detector when none does.

The cache is written in two parts so that a preprocessing run can keep
its worker processes to host work: :func:`read_for_cache` loads and
resamples a file (host), :func:`write_cache` trims it, takes its
spectrogram on the device and saves both. :func:`cache_norm_audio` does
both in one process.
"""

import hashlib
import logging
import os
from typing import Optional, Tuple

import numpy as np

LOG = logging.getLogger(__name__)

_VAD_SAMPLE_RATE = 16000
_CHUNK = 480
_THRESHOLD = 0.2
_KEEP_CHUNKS_BEFORE = 2
_KEEP_CHUNKS_AFTER = 2


def load_wav(path: str) -> Tuple[int, np.ndarray]:
    """Read a WAV file to float32 mono in [-1, 1]."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    else:
        audio = data.astype(np.float32)
    if audio.ndim > 1:
        audio = audio.mean(axis=1)
    return sr, audio


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return audio
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(orig_sr, target_sr)
    return resample_poly(audio, target_sr // g, orig_sr // g).astype(
        np.float32
    )


def _energy_speech_probs(audio_16k: np.ndarray) -> np.ndarray:
    """Per-chunk speech probability from adaptive RMS energy."""
    n_chunks = len(audio_16k) // _CHUNK
    if n_chunks == 0:
        return np.ones(1, np.float32)
    chunks = audio_16k[: n_chunks * _CHUNK].reshape(n_chunks, _CHUNK)
    rms = np.sqrt(np.mean(np.square(chunks), axis=1))
    noise_floor = np.percentile(rms, 10)
    peak = np.percentile(rms, 95)
    if peak <= noise_floor + 1e-8:
        return np.ones(n_chunks, np.float32)
    return np.clip((rms - noise_floor) / (peak - noise_floor), 0, 1)


def _resolve_vad_model(model_path: Optional[str] = None) -> Optional[str]:
    """Locate a Silero-VAD ONNX model: explicit path, PHOONNX_VAD_MODEL,
    the package data dir, then the user cache dir (where the reference
    bundles/downloads its copy). None -> energy VAD. Without this
    resolution the Silero path was unreachable in the real pipeline —
    nothing ever passed model_path."""
    if not model_path:
        model_path = os.environ.get("PHOONNX_VAD_MODEL")
    if model_path:
        return model_path
    candidates = (
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "..", "data", "silero_vad.onnx"),
        os.path.expanduser("~/.local/share/phoonnx/silero_vad.onnx"),
    )
    for cand in candidates:
        if os.path.exists(cand):
            return cand
    return None


class SileroVoiceActivityDetector:
    """Silero VAD when its ONNX model is available; energy VAD otherwise.

    The model runs on a ``TorchGraphRunner`` on ``device`` (None means the
    GPU, and raises without one; ``"cpu"`` is the caller's choice). Not
    ported, deliberately: the JAX detector's two degrades, to the energy
    VAD when the model cannot be built and to the numpy interpreter when
    the compiled runner fails at run time. A model that fails to build or
    to run raises.
    """

    def __init__(self, model_path: Optional[str] = None, device=None):
        model_path = _resolve_vad_model(model_path)
        self.model_path = model_path
        self._executor = None
        if model_path and os.path.exists(model_path):
            from phoonnx_tpu_torch.onnx.aux_compile import compiled_runner
            from phoonnx_tpu_torch.onnx.reader import read_onnx

            # fixed [1, chunk] signature, one run per chunk (the reference
            # runs silero through onnxruntime)
            self._executor = compiled_runner(read_onnx(model_path),
                                             device=device,
                                             matmul_precision="highest")

    def speech_probs(self, audio_16k: np.ndarray) -> np.ndarray:
        if self._executor is None:
            return _energy_speech_probs(audio_16k)
        return self._speech_probs_model(audio_16k)

    def _speech_probs_model(self, audio_16k: np.ndarray) -> np.ndarray:
        n_chunks = len(audio_16k) // _CHUNK
        probs = np.zeros(max(n_chunks, 1), np.float32)
        h = np.zeros((2, 1, 64), np.float32)
        c = np.zeros((2, 1, 64), np.float32)
        for i in range(n_chunks):
            chunk = audio_16k[i * _CHUNK:(i + 1) * _CHUNK]
            out = self._executor.run({
                "input": chunk[None, :].astype(np.float32),
                "sr": np.asarray(_VAD_SAMPLE_RATE, np.int64),
                "h": h, "c": c,
            })
            probs[i] = float(np.asarray(out[0]).reshape(-1)[0])
            if len(out) >= 3:
                h, c = np.asarray(out[1]), np.asarray(out[2])
        return probs


def trim_silence(
    audio_16k: np.ndarray,
    detector: Optional[SileroVoiceActivityDetector] = None,
    threshold: float = _THRESHOLD,
) -> Tuple[int, int]:
    """Return (start_sample, end_sample) of speech in the 16k stream."""
    detector = detector or SileroVoiceActivityDetector()
    probs = detector.speech_probs(audio_16k)
    speech = probs >= threshold
    if not speech.any():
        return 0, len(audio_16k)
    first = int(np.argmax(speech))
    last = int(len(speech) - 1 - np.argmax(speech[::-1]))
    start = max(0, first - _KEEP_CHUNKS_BEFORE) * _CHUNK
    end = min(len(speech), last + 1 + _KEEP_CHUNKS_AFTER) * _CHUNK
    return start, end


def cache_paths(audio_path: str, cache_dir: str, target_sr: int,
                n_fft: int = 1024, hop_length: int = 256,
                win_length: int = 1024) -> Tuple[str, str]:
    """(audio_norm_path, audio_spec_path) of a source file's cache: the
    JAX package's key, so either package reuses the other's caches."""
    # the key must carry every parameter the cached arrays depend on:
    # a path-only key (the reference's scheme) silently serves stale
    # caches when --sample-rate/--n-fft/... change between runs
    key = f"{audio_path}|{target_sr}|{n_fft}|{hop_length}|{win_length}"
    digest = hashlib.sha256(key.encode()).hexdigest()
    norm_path = os.path.join(cache_dir, f"{digest}.npy")
    spec_path = os.path.join(cache_dir, f"{digest}.spec.npy")
    return norm_path, spec_path


def read_for_cache(audio_path: str, target_sr: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Host half of the cache: (16 kHz stream for the VAD, the audio at
    ``target_sr``), both float32 mono."""
    sr, audio = load_wav(audio_path)
    return (resample(audio, sr, _VAD_SAMPLE_RATE),
            resample(audio, sr, target_sr))


def write_cache(audio_16k: np.ndarray, audio_target: np.ndarray,
                norm_path: str, spec_path: str, target_sr: int,
                n_fft: int = 1024, hop_length: int = 256,
                win_length: int = 1024,
                detector: Optional[SileroVoiceActivityDetector] = None,
                device=None) -> None:
    """Device half of the cache: trim ``audio_target`` at the speech the
    VAD finds in ``audio_16k``, take its spectrogram on ``device`` (None
    means the GPU) and save both."""
    import torch

    from phoonnx_tpu_torch.infer.engine import resolve_device
    from phoonnx_tpu_torch.ops.stft import spectrogram

    dev = resolve_device(device)
    start16, end16 = trim_silence(audio_16k, detector)

    # map the 16k trim points into the target-rate stream
    scale = target_sr / _VAD_SAMPLE_RATE
    start = int(start16 * scale)
    end = int(end16 * scale)
    trimmed = np.clip(audio_target[start:end], -1.0, 1.0).astype(np.float32)
    if len(trimmed) < hop_length:
        trimmed = np.pad(trimmed, (0, hop_length - len(trimmed)))

    with torch.no_grad():
        spec = spectrogram(torch.from_numpy(trimmed)[None].to(dev), n_fft,
                           hop_length, win_length)[0].cpu().numpy()  # [T, F]

    np.save(norm_path, trimmed)
    np.save(spec_path, spec)


def cache_norm_audio(
    audio_path: str,
    cache_dir: str,
    target_sr: int,
    n_fft: int = 1024,
    hop_length: int = 256,
    win_length: int = 1024,
    detector: Optional[SileroVoiceActivityDetector] = None,
    device=None,
) -> Tuple[str, str]:
    """Trim + cache waveform (.npy) and linear spectrogram (.spec.npy).

    Returns (audio_norm_path, audio_spec_path); reuses existing caches
    (sha256 of the source path and the parameters,
    norm_audio/__init__.py:21-92). The spectrogram runs on ``device``
    (None means the GPU).
    """
    os.makedirs(cache_dir, exist_ok=True)
    norm_path, spec_path = cache_paths(audio_path, cache_dir, target_sr,
                                       n_fft, hop_length, win_length)
    if os.path.exists(norm_path) and os.path.exists(spec_path):
        return norm_path, spec_path
    write_cache(*read_for_cache(audio_path, target_sr), norm_path,
                spec_path, target_sr, n_fft, hop_length, win_length,
                detector, device)
    return norm_path, spec_path
