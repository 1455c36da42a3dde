"""STFT spectrogram and mel filterbank, matching the reference recipe.

PyTorch port of ``phoonnx_tpu/ops/stft.py`` (reference:
phoonnx_train/vits/mel_processing.py:40-139): reflect-pad (n_fft - hop)/2,
periodic Hann, center=False, magnitude sqrt(re^2 + im^2 + 1e-6), librosa
slaney mel filterbank, log compression clipped at 1e-5. Layout is
channel-last ``[B, T, F]``, as in the JAX package.
"""

import math
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def hann_window(win_size: int) -> np.ndarray:
    """Periodic Hann, identical to torch.hann_window(win_size)."""
    n = np.arange(win_size)
    return (0.5 - 0.5 * np.cos(2.0 * math.pi * n / win_size)).astype(np.float32)


def spectrogram(y: Tensor, n_fft: int, hop_size: int, win_size: int) -> Tensor:
    """Linear magnitude spectrogram.

    y: [B, N] waveform in [-1, 1]. Returns [B, T_frames, n_fft//2 + 1]
    (channel-last; the reference returns [B, F, T]).
    """
    pad = (n_fft - hop_size) // 2
    y = F.pad(y[:, None, :], (pad, pad), mode="reflect")[:, 0, :]
    frames = y.unfold(1, n_fft, hop_size)  # [B, T, n_fft]

    window = torch.from_numpy(hann_window(win_size)).to(y.device, y.dtype)
    if win_size < n_fft:
        lpad = (n_fft - win_size) // 2
        window = F.pad(window, (lpad, n_fft - win_size - lpad))
    spec = torch.fft.rfft(frames * window, dim=-1)
    return torch.sqrt(torch.square(spec.real) + torch.square(spec.imag)
                      + 1e-6)


@lru_cache(maxsize=8)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: Optional[float]) -> np.ndarray:
    """Slaney-style mel filterbank [n_mels, n_fft//2+1].

    Same construction as librosa.filters.mel defaults (htk=False,
    norm='slaney'), which the reference uses (mel_processing.py:84-87).
    """
    if fmax is None:
        fmax = sr / 2.0

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        f_sp = 200.0 / 3
        mels = f / f_sp
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = math.log(6.4) / 27.0
        return np.where(
            f >= min_log_hz,
            min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
            mels,
        )

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        f_sp = 200.0 / 3
        freqs = f_sp * m
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = math.log(6.4) / 27.0
        return np.where(
            m >= min_log_mel,
            min_log_hz * np.exp(logstep * (m - min_log_mel)),
            freqs,
        )

    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sr / 2.0, n_freqs)
    mel_pts = mel_to_hz(
        np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    )

    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))

    # slaney normalisation: constant energy per band
    enorm = 2.0 / (mel_pts[2:n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def spec_to_mel(spec: Tensor, sr: int, n_fft: int, n_mels: int,
                fmin: float = 0.0, fmax: Optional[float] = None) -> Tensor:
    """Linear spec [B, T, F] -> log-mel [B, T, M]."""
    basis = torch.from_numpy(
        mel_filterbank(sr, n_fft, n_mels, fmin, fmax)).to(spec.device)
    mel = torch.matmul(spec, basis.T)
    return torch.log(torch.clamp(mel, min=1e-5))


def mel_spectrogram(y: Tensor, n_fft: int, n_mels: int, sr: int,
                    hop_size: int, win_size: int, fmin: float = 0.0,
                    fmax: Optional[float] = None) -> Tensor:
    """Waveform [B, N] -> log-mel [B, T, M] (mel_processing.py:93-139)."""
    spec = spectrogram(y, n_fft, hop_size, win_size)
    return spec_to_mel(spec, sr, n_fft, n_mels, fmin, fmax)
