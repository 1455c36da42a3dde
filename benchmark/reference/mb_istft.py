"""Plain PyTorch reference of MB-iSTFT-VITS synthesis, and its comparison.

The text encoder, the durations and the flow are :mod:`reference.vits`'s.
The decoder is written here from the paper (Kawamura et al., "Lightweight
and High-Fidelity End-to-End Text-to-Speech with Multi-Band Generation and
Inverse Short-Time Fourier Transform", ICASSP 2023, arXiv:2210.15975) and
its code (``models.py`` Multiband_iSTFT_Generator, ``stft.py``,
``pqmf.py``): conv_pre; per upsampling stage a leaky ReLU 0.1, the
transposed conv and the mean of the stage's resblocks; then a leaky ReLU
0.01, the magnitude and phase heads (``exp`` and ``pi * sin``), a per-band
inverse STFT (inverse DFT, Hann window, overlap-add, centre crop) and the
PQMF synthesis bank. The inverse DFT and the PQMF filters are designed
here; nothing is taken from the program under test.

The program departs from the published code in four places, each mirrored
here where it applies (``configs/mb-istft-vits.json`` ``departures``):
one silent spectral frame appended (the published code reflection-pads
one frame at the start of the heads' input); the magnitude head clamped
to [-12, 6] before ``exp``; two heads, ``conv_mag`` and ``conv_phase``,
in place of one ``subband_conv_post`` split band by band into halves (the
same function); the PQMF prototype at cutoff 0.1418 in place of 0.142.

The comparison (:func:`judge`) is :mod:`reference.compare`'s, at this
decoder's hop (``prod(upsample_rates) * istft_hop * istft_bands`` samples
a frame), and it also gives the reference's peak: a run's check is the
widest gap in 16-bit steps over that peak (:attr:`Verdict.gap_per_peak`,
the gap of the voice scaled to peak at full scale). The heads' ``exp``
makes a random voice's loudness depend on its seed (peaks of 0.27-2.77
over 40 seeds on an H100), and a float32 gap and a TF32 one both grow
with it, so that no count of 16-bit steps lies above every float32 gap
and below every TF32 one; over the peak they part (``PERF.md`` §2).
:func:`hop`, :func:`judge` and :func:`control_pcm` stand where
``compare``'s do. Every float computes in float32; the caller decides
whether cuBLAS and cuDNN may use TF32 (``vits.precision``).
"""

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from reference import compare, vits

Tensor = torch.Tensor

# the heads' leaky ReLU (the default slope of torch's F.leaky_relu, which
# the published generator calls without one)
HEAD_LRELU = 0.01
# the program's clamp of the magnitude head before exp (a departure)
MAG_CLAMP = (-12.0, 6.0)
# ParallelWaveGAN's PQMF: taps and Kaiser beta; the prototype's cutoff is
# the program's 0.1418 (a departure from ParallelWaveGAN's 0.142)
PQMF_TAPS = 62
PQMF_BETA = 9.0
PQMF_CUTOFF = 0.1418

pcm16 = compare.pcm16


@dataclass
class Verdict:
    frames_ok: bool  # the served length is one the reference can give
    gap_lsb: int  # widest sample gap in 16-bit steps (0 if not frames_ok)
    ties: int  # durations within compare.TIE of a boundary
    peak: float = 0.0  # the reference's largest |sample| (full scale 1.0)

    @property
    def gap_per_peak(self) -> float:
        """The gap over the reference's peak (at least one 16-bit step)."""
        return self.gap_lsb / max(self.peak, 1.0 / 32767.0)


def hop(cfg: dict) -> int:
    """Output samples a latent frame."""
    return (int(np.prod(cfg["upsample_rates"])) * cfg["istft_hop"]
            * cfg["istft_bands"])


# -- the decoder's stages -----------------------------------------------------


def _resblock1(w: vits.Weights, prefix: str, x: Tensor,
               dilations) -> Tensor:
    for n, d in enumerate(dilations):
        t = vits.conv1d(w, f"{prefix}.convs1.{n}",
                        F.leaky_relu(x, vits.LRELU), dilation=d)
        x = x + vits.conv1d(w, f"{prefix}.convs2.{n}",
                            F.leaky_relu(t, vits.LRELU))
    return x


def _resblock2(w: vits.Weights, prefix: str, x: Tensor,
               dilations) -> Tensor:
    for n, d in enumerate(dilations):
        x = x + vits.conv1d(w, f"{prefix}.convs.{n}",
                            F.leaky_relu(x, vits.LRELU), dilation=d)
    return x


def stages(w: vits.Weights, cfg: dict, z: Tensor) -> Tensor:
    """conv_pre and the upsampling stages: z [1, C, T] -> [1, ch, T *
    prod(rates)]."""
    block = _resblock1 if cfg["resblock"] == "1" else _resblock2
    kernels = cfg["resblock_kernel_sizes"]
    x = vits.conv1d(w, "dec.conv_pre", z)
    for i, (rate, k) in enumerate(zip(cfg["upsample_rates"],
                                      cfg["upsample_kernel_sizes"])):
        x = F.leaky_relu(x, vits.LRELU)
        p = f"dec.ups.{i}"
        x = F.conv_transpose1d(x, w.conv(p), w.bias(p), stride=rate,
                               padding=(k - rate) // 2)
        acc = 0
        for j, dils in enumerate(cfg["resblock_dilation_sizes"]):
            acc = acc + block(w, f"dec.resblocks.{i * len(kernels) + j}", x,
                              dils)
        x = acc / len(kernels)
    return x


# -- the heads ----------------------------------------------------------------


def heads(w: vits.Weights, cfg: dict, x: Tensor):
    """(magnitude, phase), each [bands, n_fft // 2 + 1, T + 1]: the heads'
    channels are (band, bin) in that order, and the program's silent
    frame is appended (magnitude 0)."""
    x = F.leaky_relu(x, HEAD_LRELU)
    log_mag = vits.conv1d(w, "dec.conv_mag", x)[0]
    phase = math.pi * torch.sin(vits.conv1d(w, "dec.conv_phase", x)[0])
    mag = torch.exp(torch.clamp(log_mag, *MAG_CLAMP))
    bands = cfg["istft_bands"]
    shape = (bands, cfg["istft_n_fft"] // 2 + 1, x.shape[-1])
    return (F.pad(mag.reshape(shape), (0, 1)),
            F.pad(phase.reshape(shape), (0, 1)))


# -- the inverse STFT ---------------------------------------------------------


def hann(n: int, device) -> Tensor:
    """The periodic Hann window (torch.hann_window's default)."""
    k = torch.arange(n, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(2 * math.pi * k / n)).float()


def inverse_dft(mag: Tensor, phase: Tensor, n_fft: int) -> Tensor:
    """Frames [bands, n_fft, T] of the one-sided spectra (mag, phase)
    [bands, n_fft // 2 + 1, T]: the Hermitian spectrum of n_fft bins (bins
    above n_fft / 2 the conjugates of those below; the DC and Nyquist bins'
    imaginary parts dropped, as a real inverse FFT drops them) through the
    real and imaginary parts of exp(2 pi i k n / n_fft) / n_fft."""
    re, im = mag * torch.cos(phase), mag * torch.sin(phase)
    im = im.clone()
    im[:, 0] = 0
    im[:, n_fft // 2] = 0
    mirror = torch.arange(n_fft // 2 - 1, 0, -1, device=mag.device)
    re = torch.cat([re, re[:, mirror]], dim=1)
    im = torch.cat([im, -im[:, mirror]], dim=1)
    k = torch.arange(n_fft, dtype=torch.float64, device=mag.device)
    angle = 2 * math.pi * k[:, None] * k[None, :] / n_fft  # [k, n]
    cos = (torch.cos(angle) / n_fft).float()
    sin = (torch.sin(angle) / n_fft).float()
    # x[n] = sum_k Re(X_k e^{2 pi i k n / N}) / N
    return (torch.einsum("bkt,kn->bnt", re, cos)
            - torch.einsum("bkt,kn->bnt", im, sin))


def istft(mag: Tensor, phase: Tensor, n_fft: int, hop_size: int) -> Tensor:
    """[bands, n_fft // 2 + 1, T] -> [bands, (T - 1) * hop_size]: torch.istft
    with a periodic Hann window of n_fft and center=True, written out:
    each frame times the window, overlap-added at its hop (``F.fold``),
    over the overlap-add of the squared window, then n_fft / 2 samples
    cropped at the start."""
    frames = inverse_dft(mag, phase, n_fft)
    window = hann(n_fft, mag.device)
    t = frames.shape[-1]
    length = (t - 1) * hop_size + n_fft

    def ola(cols: Tensor) -> Tensor:  # [B, n_fft, T] -> [B, length]
        return F.fold(cols, (1, length), (1, n_fft),
                      stride=(1, hop_size))[:, 0, 0]

    audio = ola(frames * window[None, :, None])
    envelope = ola((window * window)[None, :, None].expand(1, n_fft, t))
    audio = audio / torch.where(envelope > 1e-11, envelope,
                                torch.ones_like(envelope))
    start = n_fft // 2
    return audio[:, start:start + (t - 1) * hop_size]


# -- the PQMF synthesis bank ------------------------------------------------


def pqmf_synthesis_filters(bands: int, device=None) -> Tensor:
    """[bands, taps + 1] float32: a Kaiser-windowed sinc prototype h at the
    cutoff, cosine-modulated, g_k[n] = 2 h[n] cos((2k + 1) pi / (2 bands)
    (n - taps / 2) - (-1)^k pi / 4) (ParallelWaveGAN's ``PQMF``)."""
    taps = PQMF_TAPS
    n = torch.arange(taps + 1, dtype=torch.float64)
    m = n - taps / 2
    wc = math.pi * PQMF_CUTOFF
    safe = torch.where(m == 0, torch.ones_like(m), m)
    ideal = torch.where(m == 0, torch.full_like(m, PQMF_CUTOFF),
                        torch.sin(wc * safe) / (math.pi * safe))
    proto = ideal * torch.kaiser_window(taps + 1, periodic=False,
                                        beta=PQMF_BETA, dtype=torch.float64)
    k = torch.arange(bands, dtype=torch.float64)[:, None]
    sign = torch.where(k % 2 == 0, 1.0, -1.0)
    g = 2 * proto[None] * torch.cos((2 * k + 1) * math.pi / (2 * bands) * m
                                    - sign * math.pi / 4)
    return g.float().to(device)


def pqmf_synthesis(sub: Tensor) -> Tensor:
    """[bands, N] subbands -> [N * bands] waveform: each band upsampled by
    zero insertion and scaled by the band count, padded by taps / 2 on
    both sides and correlated with its synthesis filter, the bands summed
    (ParallelWaveGAN's ``PQMF.synthesis``)."""
    bands, n = sub.shape
    up = torch.zeros(bands, n * bands, dtype=sub.dtype, device=sub.device)
    up[:, ::bands] = sub * bands
    g = pqmf_synthesis_filters(bands, sub.device)
    y = F.conv1d(F.pad(up[None], (PQMF_TAPS // 2, PQMF_TAPS // 2)), g[None])
    return y[0, 0]


def decoder(w: vits.Weights, cfg: dict, z: Tensor) -> Tensor:
    """z [1, C, T] -> audio [T * hop(cfg)]."""
    mag, phase = heads(w, cfg, stages(w, cfg, z))
    sub = istft(mag, phase, cfg["istft_n_fft"], cfg["istft_hop"])
    return pqmf_synthesis(sub)


# -- synthesis and its comparison ---------------------------------------------


def synthesize(w: vits.Weights, cfg: dict, ids: Sequence[int],
               length_scale: float, frames: Tensor = None) -> Tensor:
    """One utterance at noise_scale 0 and noise_w 0: audio [N] float32.
    ``frames`` [T] overrides the durations (``vits.synthesize``'s)."""
    dev = w["enc_p.emb.weight"].device
    x, m_p, _ = vits.text_encoder(w, cfg, torch.tensor([list(ids)],
                                                       device=dev))
    if frames is None:
        logw = vits.log_durations(w, x, torch.zeros_like(x[:, :2]))[0, 0]
        frames = vits.durations(logw, length_scale)
    reps = frames.long().clamp(min=0)
    z_p = torch.repeat_interleave(m_p[0], reps, dim=1)[None]
    if z_p.shape[-1] == 0:
        z_p = m_p[:, :, :1] * 0
    return decoder(w, cfg, vits.flow_reverse(w, z_p))


def judge(w: vits.Weights, cfg: dict, ids: Sequence[int],
          length_scale: float, served: np.ndarray) -> Verdict:
    """``compare.judge`` for this decoder: the served int16 samples'
    length must be one the reference can give (near ties of a duration
    either way, ``compare.candidates``), then the widest gap in 16-bit
    steps from the reference's audio, in float32 with TF32 off, and that
    audio's peak (of the candidate nearest the served audio)."""
    dev = w["enc_p.emb.weight"].device
    h = hop(cfg)
    with torch.no_grad(), vits.precision(False):
        w_scaled = torch.exp(vits.log_w(w, cfg, ids, dev)) * length_scale
        if len(served) % h:
            return Verdict(False, 0, 0)
        cands, ties = compare.candidates(w_scaled.cpu(), len(served) // h)
        best = None
        for frames in cands:
            audio = synthesize(w, cfg, ids, length_scale,
                               frames=frames.to(dev)).cpu().numpy()
            gap = int(np.abs(pcm16(audio).astype(np.int32)
                             - served.astype(np.int32)).max())
            if best is None or gap < best[0]:
                best = (gap, float(np.abs(audio).max()))
    if best is None:
        return Verdict(False, 0, ties)
    return Verdict(True, best[0], ties, best[1])


def control_pcm(w: vits.Weights, cfg: dict, ids: Sequence[int],
                length_scale: float) -> np.ndarray:
    """The control's WAV: this reference with TF32 allowed in cuBLAS and
    cuDNN, the nearest precision below the configuration's float32."""
    with torch.no_grad(), vits.precision(True):
        return pcm16(synthesize(w, cfg, ids, length_scale).cpu().numpy())
