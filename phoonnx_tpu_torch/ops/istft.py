"""Inverse STFT with overlap-add.

PyTorch port of ``phoonnx_tpu/ops/istft.py``, used by the iSTFT decoders
(models/vits/istft_decoder.py): (magnitude, phase) frames become windowed
time frames by a real inverse DFT, and the overlap-add is a transposed
convolution with a diagonal, window-scaled kernel.

The inverse DFT is written as one real product, ``[Re X, Im X] @ basis``
with a ``[2F, n_fft]`` cos/sin basis, in place of ``torch.fft.irfft``. The
decoder's phase head leaves the DC and Nyquist bins with non-zero
imaginary parts; numpy's and JAX's ``irfft`` ignore them, and the basis
does the same by construction (its sin rows for those bins are 0), so no
FFT library's handling of such input is relied on, on the CPU or the GPU.
"""

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from phoonnx_tpu_torch.ops.stft import hann_window

Tensor = torch.Tensor


@lru_cache(maxsize=8)
def _ola_kernel(win_size: int) -> np.ndarray:
    """[I=win, O=1, K=win] kernel with kernel[i, 0, i] = window[i]."""
    window = hann_window(win_size)
    kernel = np.zeros((win_size, 1, win_size), np.float32)
    kernel[np.arange(win_size), 0, np.arange(win_size)] = window
    return kernel


@lru_cache(maxsize=8)
def _irfft_basis(n_fft: int) -> np.ndarray:
    """[2F, n_fft] real inverse-DFT basis, F = n_fft // 2 + 1: the first F
    rows take the real parts, the last F the imaginary parts, so
    ``frames = [re, im] @ basis`` is ``irfft(re + i im, n=n_fft)`` with the
    DC and Nyquist imaginary parts dropped, as numpy's irfft drops them."""
    n_freqs = n_fft // 2 + 1
    k = np.arange(n_freqs, dtype=np.float64)[:, None]
    n = np.arange(n_fft, dtype=np.float64)[None, :]
    # bins 1..F-2 stand for themselves and their conjugate mirror
    weight = np.full((n_freqs, 1), 2.0)
    weight[0] = 1.0
    if n_fft % 2 == 0:
        weight[-1] = 1.0
    angle = 2.0 * math.pi * k * n / n_fft
    cos = weight * np.cos(angle) / n_fft
    sin = -weight * np.sin(angle) / n_fft
    sin[0] = 0.0
    if n_fft % 2 == 0:
        sin[-1] = 0.0
    return np.concatenate([cos, sin]).astype(np.float32)


@lru_cache(maxsize=16)
def _constants(n_fft: int, device: torch.device, dtype: torch.dtype):
    """(inverse-DFT basis, overlap-add kernel, window) on ``device``,
    copied there once a (n_fft, device, dtype): a copy from host memory
    per call would stall the host behind the card's queue. Built outside
    inference mode so that training can differentiate through them."""
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(a).to(device, dtype)
                     for a in (_irfft_basis(n_fft), _ola_kernel(n_fft),
                               hann_window(n_fft)))


def _overlap_add(frames: Tensor, kernel: Tensor, hop: int) -> Tensor:
    """Frames [B, T, win] -> [B, (T - 1) * hop + win]: each frame times
    the window, added at its hop offset."""
    return F.conv_transpose1d(frames.transpose(1, 2), kernel,
                              stride=hop)[:, 0]


def istft(magnitude: Tensor, phase: Tensor, n_fft: int, hop: int,
          win_size: int, frame_lengths: Tensor = None) -> Tensor:
    """(mag, phase) [B, T, F=n_fft//2+1] -> waveform [B, T * hop].

    Matches torch.istft with a periodic Hann window and center=True
    cropping of n_fft//2 samples on both ends, with the window envelope
    computed exactly (see the JAX package's ``istft`` for the length
    contract: the decoders pad one silent frame so T frames give T*hop
    samples). Only ``win_size == n_fft`` is supported.

    frame_lengths: optional [B] valid frame counts. The envelope then sums
    only the first ``frame_lengths[b]`` frames' windows, so a padded
    inversion (padded magnitudes zeroed by the caller) equals inverting
    exactly that many frames.
    """
    if win_size != n_fft:
        raise NotImplementedError(
            f"istft requires win_size == n_fft (got {win_size} != "
            f"{n_fft}); in-repo exports always satisfy this")
    dev, dtype = magnitude.device, magnitude.dtype
    basis, kernel, window = _constants(n_fft, dev, dtype)
    spec = torch.cat([magnitude * torch.cos(phase),
                      magnitude * torch.sin(phase)], dim=-1)
    frames = torch.matmul(spec, basis)  # [B, T, n_fft]
    audio = _overlap_add(frames, kernel, hop)

    # window envelope: the overlap-add of window^2 (the kernel multiplies
    # by the window once, so feed plain window frames)
    t_frames = frames.shape[1]
    if frame_lengths is None:
        env_frames = window.expand(1, t_frames, win_size)
    else:
        keep = (torch.arange(t_frames, device=dev)[None, :]
                < frame_lengths.to(dev)[:, None]).to(dtype)
        env_frames = window * keep[..., None]
    envelope = _overlap_add(env_frames, kernel, hop)
    audio = audio / torch.clamp(envelope, min=1e-9)

    # center crop (torch.istft center=True semantics)
    pad = n_fft // 2
    return audio[:, pad:pad + (t_frames - 1) * hop + win_size - 2 * pad][
        :, :t_frames * hop]
