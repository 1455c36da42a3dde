"""Pseudo-QMF filter bank (analysis + synthesis) for multi-band vocoding.

PyTorch port of ``phoonnx_tpu/ops/pqmf.py``, used by the multi-band
iSTFT decoder (arXiv:2210.15975 §2.2): the network predicts N subband
spectra, each is inverted with a small iSTFT, and the synthesis bank
upsamples and recombines them into the full-rate waveform with one
stride-N transposed convolution.

Cosine-modulated near-perfect-reconstruction design (Nguyen 1994, as in
ParallelWaveGAN/MB-MelGAN): prototype lowpass = Kaiser-windowed sinc at
cutoff ~pi/2N, bands g_k[n] = 2 h[n] cos((2k+1) pi/2N (n - L/2) +
(-1)^k pi/4).
"""

import math
from functools import lru_cache
from typing import Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def prototype_filter(taps: int = 62, cutoff_ratio: float = 0.142,
                     beta: float = 9.0) -> np.ndarray:
    """Kaiser-windowed sinc prototype lowpass, length taps+1."""
    n = np.arange(taps + 1, dtype=np.float64)
    m = n - taps / 2.0
    h_ideal = np.where(
        m == 0.0, cutoff_ratio,
        np.sin(np.pi * cutoff_ratio * m) / (np.pi * m + 1e-38),
    )
    return (h_ideal * np.kaiser(taps + 1, beta)).astype(np.float64)


def pqmf_filters(n_bands: int, taps: int = 62,
                 cutoff_ratio: float = None,
                 beta: float = 9.0) -> Tuple[np.ndarray, np.ndarray]:
    """(analysis [bands, L], synthesis [bands, L]) float32 filters."""
    if cutoff_ratio is None:
        # cutoffs grid-optimized for minimal reconstruction error at
        # taps=62 / beta=9 (N=4 lands on ParallelWaveGAN's 0.142);
        # reconstruction max error ~2-5e-3 on unit-variance noise
        cutoff_ratio = {2: 0.2668, 4: 0.1418, 8: 0.0793}.get(
            n_bands, 0.568 / n_bands)
    h = prototype_filter(taps, cutoff_ratio, beta)
    length = taps + 1
    n = np.arange(length, dtype=np.float64)
    analysis = np.zeros((n_bands, length), np.float64)
    synthesis = np.zeros((n_bands, length), np.float64)
    for k in range(n_bands):
        arg = ((2 * k + 1) * math.pi / (2 * n_bands) * (n - taps / 2.0))
        phase = (-1) ** k * math.pi / 4.0
        analysis[k] = 2.0 * h * np.cos(arg + phase)
        synthesis[k] = 2.0 * h * np.cos(arg - phase)
    return analysis.astype(np.float32), synthesis.astype(np.float32)


def pqmf_analysis(x: Tensor, analysis: np.ndarray, n_bands: int) -> Tensor:
    """[B, N] waveform -> [B, ceil(N/bands), bands] subbands (critically
    sampled).

    Correlates with each band filter under full-left (causal) padding,
    then decimates by n_bands: the phase that makes the synthesis bank's
    alias terms cancel. Total analysis+synthesis delay is taps//2 samples.
    """
    length = analysis.shape[1]
    w = torch.from_numpy(analysis).to(x.device, x.dtype)[:, None, :]
    y = F.conv1d(F.pad(x[:, None, :], (length - 1, 0)), w, stride=n_bands)
    return y.transpose(1, 2)  # [B, T/N, bands]


def _transposed_kernel(synthesis: np.ndarray, device: torch.device,
                       dtype: torch.dtype) -> Tensor:
    """[bands, L] synthesis filters -> the [I=bands, O=1, L] kernel of the
    transposed convolution, reversed (see :func:`pqmf_synthesis`)."""
    return torch.from_numpy(np.ascontiguousarray(synthesis[:, ::-1])).to(
        device, dtype)[:, None, :]


@lru_cache(maxsize=16)
def synthesis_kernel(n_bands: int, device: torch.device,
                     dtype: torch.dtype) -> Tensor:
    """``pqmf_filters(n_bands)``'s synthesis bank as the transposed-conv
    kernel :func:`pqmf_synthesis` takes, on ``device``: built and copied
    once a (bands, device, dtype), so a decode makes no copy from host
    memory. Built outside inference mode so that training can
    differentiate through it."""
    with torch.inference_mode(False):
        return _transposed_kernel(pqmf_filters(n_bands)[1], device, dtype)


def pqmf_synthesis(subbands: Tensor, synthesis: Union[np.ndarray, Tensor],
                   n_bands: int) -> Tensor:
    """[B, T, bands] subbands -> [B, T*bands] waveform.

    synthesis: the [bands, L] synthesis filters, or their kernel from
    :func:`synthesis_kernel` already on the subbands' device.

    Expand-by-N, band filter and sum, as ONE stride-N transposed
    convolution (translation-invariant, so the engine's chunked streaming
    decode works unchanged). The JAX package writes it as a correlation of
    the N-dilated input with the filters as given (``lax`` does not flip a
    kernel); a transposed convolution flips its kernel, so it is fed the
    filters reversed. The JAX padding (``length // 2`` before, ``length +
    N - 2 - length // 2`` after) becomes the crop ``length - 1 -
    length // 2`` on both ends and ``output_padding`` for the rest of the
    right end, so the output is exactly T*bands samples.
    """
    if isinstance(synthesis, np.ndarray):
        synthesis = _transposed_kernel(synthesis, subbands.device,
                                       subbands.dtype)
    length = synthesis.shape[-1]
    pad_lo = length // 2
    crop = length - 1 - pad_lo
    extra = n_bands + length - 2 - 2 * pad_lo
    if not 0 <= extra < n_bands:
        raise ValueError(f"a {length}-tap filter bank of {n_bands} bands "
                         "has no transposed-conv form here")
    y = F.conv_transpose1d(subbands.transpose(1, 2), synthesis,
                           stride=n_bands, padding=crop,
                           output_padding=extra)
    return y[:, 0] * n_bands  # [B, T*bands]
