"""The port's STFT / mel ops against the JAX package's, on the CPU.

Both sides frame, window and FFT in float32 (XLA's FFT against
PocketFFT). An FFT's rounding error scales with the frame's energy, not
with each bin, so a spectrum is held to 1e-5 of its peak (measured: 3.7e-6
abs on a bin of 0.23 at n_fft 1024, peak ~40); the log-mels, where an
absolute error is a relative one, to 1e-5. The filterbank is a numpy copy
and must be identical.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from phoonnx_tpu.ops import stft as jax_stft
from phoonnx_tpu_torch.ops import stft

RTOL = 1e-5

# (n_fft, hop, win, sr, n_mels): the micro preset, a narrow window, medium
CONFIGS = [(128, 16, 128, 16000, 20), (256, 64, 192, 22050, 40),
           (1024, 256, 1024, 22050, 80)]


def _audio(seed, n=4096, b=2):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    tone = 0.3 * np.sin(2 * np.pi * (200 + 50 * rng.random((b, 1))) * t)
    return (tone + 0.05 * rng.standard_normal((b, n))).astype(np.float32)


@pytest.mark.parametrize("n_fft,hop,win,sr,n_mels", CONFIGS)
def test_spectrogram_and_mel_match_jax(n_fft, hop, win, sr, n_mels):
    y = _audio(n_fft)
    want = np.asarray(jax_stft.spectrogram(jnp.asarray(y), n_fft, hop, win))
    got = stft.spectrogram(torch.from_numpy(y), n_fft, hop, win).numpy()
    assert got.shape == want.shape == (2, 1 + (4096 - hop) // hop,
                                       n_fft // 2 + 1)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())

    want_mel = np.asarray(jax_stft.spec_to_mel(jnp.asarray(want), sr, n_fft,
                                               n_mels))
    got_mel = stft.spec_to_mel(torch.from_numpy(want.copy()), sr, n_fft,
                               n_mels).numpy()
    np.testing.assert_allclose(got_mel, want_mel, rtol=RTOL, atol=1e-5)

    want_full = np.asarray(jax_stft.mel_spectrogram(
        jnp.asarray(y), n_fft, n_mels, sr, hop, win))
    got_full = stft.mel_spectrogram(torch.from_numpy(y), n_fft, n_mels, sr,
                                    hop, win).numpy()
    np.testing.assert_allclose(got_full, want_full, rtol=RTOL, atol=1e-5)


def test_filterbank_and_window_copies_equal():
    for n_fft, _, win, sr, n_mels in CONFIGS:
        np.testing.assert_array_equal(
            stft.mel_filterbank(sr, n_fft, n_mels, 0.0, None),
            jax_stft.mel_filterbank(sr, n_fft, n_mels, 0.0, None))
        np.testing.assert_array_equal(stft.hann_window(win),
                                      jax_stft.hann_window(win))


def test_spectrogram_is_differentiable():
    y = torch.from_numpy(_audio(1, n=1024, b=1)).requires_grad_(True)
    mel = stft.mel_spectrogram(y, 128, 20, 16000, 16, 128)
    mel.sum().backward()
    assert torch.isfinite(y.grad).all() and y.grad.abs().max() > 0
