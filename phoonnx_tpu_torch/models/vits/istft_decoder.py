"""iSTFT decoder: a lighter alternative to the HiFi-GAN vocoder.

PyTorch port of ``phoonnx_tpu/models/vits/istft_decoder.py`` (the
iSTFT-VITS direction, arXiv:2210.15975): the last transposed-conv
upsampling stages are replaced by predicting a complex spectrogram and
inverting it with an iSTFT; with ``istft_bands > 1`` (MB-iSTFT) each band
is inverted separately and a PQMF synthesis bank recombines them.

Each upsampling stage's resblock group runs through kernel C
(``fused_stage``) with no tail: the spectral heads, the iSTFT and the PQMF
bank are plain PyTorch ops, as they are XLA ops outside any Pallas kernel
in the JAX package.
"""

import math
from typing import Optional, Sequence

import torch

from phoonnx_tpu_torch.models.vits import fused_stage, hifigan, modules, nn
from phoonnx_tpu_torch.ops.istft import istft
from phoonnx_tpu_torch.ops.pqmf import pqmf_synthesis, synthesis_kernel

Tensor = torch.Tensor


def init_istft_generator(generator, initial_channel: int, resblock: str,
                         resblock_kernel_sizes: Sequence[int],
                         resblock_dilation_sizes,
                         upsample_rates: Sequence[int],
                         upsample_initial_channel: int,
                         upsample_kernel_sizes: Sequence[int],
                         istft_n_fft: int = 16,
                         istft_hop: int = 4,
                         istft_bands: int = 1,
                         gin_channels: int = 0):
    """The HiFi-GAN stages with ``conv_post`` replaced by the magnitude and
    phase heads, each of ``bands * (n_fft/2 + 1)`` channels; the flat
    names are the JAX package's (``dec.conv_mag``, ``dec.conv_phase``)."""
    params = hifigan.init_generator(
        generator, initial_channel, resblock, resblock_kernel_sizes,
        resblock_dilation_sizes, upsample_rates, upsample_initial_channel,
        upsample_kernel_sizes, gin_channels=gin_channels)
    params.pop("conv_post")
    final_ch = upsample_initial_channel // (2 ** len(upsample_rates))
    n_freqs = (istft_n_fft // 2 + 1) * istft_bands
    params["conv_mag"] = nn.init_conv(generator, n_freqs, final_ch, 7)
    params["conv_phase"] = nn.init_conv(generator, n_freqs, final_ch, 7)
    params["istft_n_fft"] = int(istft_n_fft)
    params["istft_hop"] = int(istft_hop)
    params["istft_bands"] = int(istft_bands)
    return params


def build_stage_specs(params) -> tuple:
    """Kernel C specs, one per upsampling stage, none with a tail."""
    nk = params["num_kernels"]
    return tuple(
        fused_stage.build_group_spec(
            params["resblocks"][i * nk:(i + 1) * nk], modules.LRELU_SLOPE)
        for i in range(len(params["ups"])))


def _spectral_heads(params, x: Tensor):
    """Leaky ReLU 0.01, then (magnitude, phase) [B, T, bands * F]."""
    x = nn.leaky_relu(x, 0.01)
    magnitude = torch.exp(torch.clamp(
        nn.apply_conv(params["conv_mag"], x, padding=3), -12.0, 6.0))
    phase = math.pi * torch.sin(nn.apply_conv(params["conv_phase"], x,
                                              padding=3))
    return magnitude, phase


def _to_audio(params, magnitude: Tensor, phase: Tensor,
              istft_lengths: Optional[Tensor]) -> Tensor:
    """Spectral frames -> waveform: pad one silent frame so T frames give
    exactly T * hop samples a band, then the iSTFT, and with bands the
    fold into the batch, the per-band iSTFT and the PQMF synthesis bank."""
    n_fft, hop = params["istft_n_fft"], params["istft_hop"]
    magnitude = torch.nn.functional.pad(magnitude, (0, 0, 0, 1))
    phase = torch.nn.functional.pad(phase, (0, 0, 0, 1))
    n_bands = int(params.get("istft_bands", 1))
    if n_bands == 1:
        return istft(magnitude, phase, n_fft, hop, n_fft,
                     frame_lengths=istft_lengths)

    b, t_up = magnitude.shape[:2]
    n_freqs = n_fft // 2 + 1

    def fold(spec):
        spec = spec.reshape(b, t_up, n_bands, n_freqs)
        return spec.transpose(1, 2).reshape(b * n_bands, t_up, n_freqs)

    band_lengths = (None if istft_lengths is None
                    else istft_lengths[:, None].expand(b, n_bands)
                    .reshape(-1))
    sub = istft(fold(magnitude), fold(phase), n_fft, hop, n_fft,
                frame_lengths=band_lengths)
    if band_lengths is not None:
        # the exact-length decode's iSTFT crop ends at (frames - 1) * hop
        # and drops the last windows' overlap spill; the padded buffer
        # keeps that spill inside its larger crop, and the centred PQMF
        # filter would read it back into the valid tail: zero it
        keep = (torch.arange(sub.shape[-1], device=sub.device)[None, :]
                < ((band_lengths - 1) * hop)[:, None])
        sub = sub * keep.to(sub.dtype)
    sub = sub.reshape(b, n_bands, sub.shape[-1])
    return pqmf_synthesis(sub.transpose(1, 2),
                          synthesis_kernel(n_bands, sub.device, sub.dtype),
                          n_bands)


def istft_generator(params, x: Tensor, g: Optional[Tensor] = None,
                    frame_lengths: Optional[Tensor] = None) -> Tensor:
    """Latent frames [B, T, C] -> waveform [B, T * prod(rates) * hop *
    bands].

    The stages are ``hifigan.upsample_stages`` with the no-tail specs of
    :func:`build_stage_specs` (on the GPU a missing spec raises).

    frame_lengths: optional [B] true frame counts. When given, the stages
    mask to the valid span as there, the spectra past it are zeroed and
    the iSTFT envelope counts exactly the exact-length decode's frames, so
    a padded decode equals the exact-length decode on the valid span.
    """
    x, valid, cum_up = hifigan.upsample_stages(params, x, g, frame_lengths,
                                               build_stage_specs)
    magnitude, phase = _spectral_heads(params, x)
    istft_lengths = None
    if frame_lengths is not None:
        # the overlap-add would bleed padded frames' spectra (exp(bias) is
        # not 0) into the valid tail: zero them, and count exactly the
        # exact-length decode's frames (its silent pad frame included) in
        # the envelope
        tail_mask = nn.sequence_mask(valid * cum_up, x.shape[1])[
            ..., None].to(magnitude.dtype)
        magnitude = magnitude * tail_mask
        phase = phase * tail_mask
        istft_lengths = valid * cum_up + 1
    return _to_audio(params, magnitude, phase, istft_lengths)


def istft_generator_train(params, x: Tensor,
                          g: Optional[Tensor] = None) -> Tensor:
    """The decoder the training step differentiates, in plain PyTorch ops:
    latent frames [B, T, C] -> waveform.

    The JAX semantics, not a fallback: the JAX training forward decodes a
    segment of whole frames with no frame lengths through the XLA path of
    ``istft_generator`` (no padding to mask, no kernel), and kernel C has
    no backward (see ``hifigan.generator_train``).
    """
    magnitude, phase = _spectral_heads(
        params, hifigan.upsample_stages_train(params, x, g))
    return _to_audio(params, magnitude, phase, None)
