"""Full VITS synthesizer: hyperparameters, init, training forward,
synthesis.

PyTorch port of ``phoonnx_tpu/models/vits/model.py`` (reference
SynthesizerTrn, phoonnx_train/vits/models.py:522-732, and the quality
presets of phoonnx_train/vits/lightning.py:26-57 / train.py:106-120).

The stochastic inputs (the duration predictor's noise, the prior noise;
in training the posterior noise, the SDP's e_q and the segment offsets)
can be injected as tensors, so a run is reproducible and verifiable
against the JAX package; otherwise they are drawn from an explicit
``torch.Generator``, as are the training dropout masks.
"""

import math
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple

import torch

from reference.vitstrain import (duration, encoder, hifigan, nn,
                                posterior)
from reference.vitstrain import mas

Tensor = torch.Tensor


@dataclass(frozen=True)
class VitsHParams:
    n_vocab: int = 256
    spec_channels: int = 513  # filter_length // 2 + 1
    segment_size: int = 32  # frames (8192 samples / hop 256)
    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    p_dropout: float = 0.1
    resblock: str = "2"
    resblock_kernel_sizes: Tuple[int, ...] = (3, 5, 7)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 2), (2, 6), (3, 12),
    )
    upsample_rates: Tuple[int, ...] = (8, 8, 4)
    upsample_initial_channel: int = 256
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 8)
    n_speakers: int = 1
    gin_channels: int = 0
    use_sdp: bool = True
    # decoder family: "hifigan" (reference) or "istft" (spectral heads +
    # inverse STFT, models/vits/istft_decoder.py)
    decoder_type: str = "hifigan"
    istft_n_fft: int = 16
    istft_hop: int = 4
    istft_bands: int = 1
    # audio
    sample_rate: int = 22050
    filter_length: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    mel_channels: int = 80

    @property
    def total_upsample(self) -> int:
        out = 1
        for rate in self.upsample_rates:
            out *= rate
        if self.decoder_type == "istft":
            out *= self.istft_hop * self.istft_bands
        return out

    @staticmethod
    def preset(quality: str = "medium", **overrides) -> "VitsHParams":
        """'x-low' | 'medium' | 'high' presets (train.py:106-120), plus a
        'micro' preset for smoke tests and CI."""
        hp = VitsHParams()
        if quality == "micro":
            hp = replace(
                hp,
                spec_channels=65,
                segment_size=16,
                inter_channels=32,
                hidden_channels=32,
                filter_channels=64,
                n_layers=1,
                resblock_kernel_sizes=(3,),
                resblock_dilation_sizes=((1, 2),),
                upsample_rates=(4, 4),
                upsample_initial_channel=32,
                upsample_kernel_sizes=(8, 8),
                filter_length=128,
                hop_length=16,
                win_length=128,
                mel_channels=20,
                sample_rate=16000,
            )
        elif quality == "x-low":
            hp = replace(hp, hidden_channels=96, inter_channels=96,
                         filter_channels=384)
        elif quality == "medium-istft":
            hp = replace(
                hp,
                decoder_type="istft",
                upsample_rates=(8, 8),
                upsample_kernel_sizes=(16, 16),
                istft_n_fft=16,
                istft_hop=4,
            )
        elif quality == "medium-mb-istft":
            hp = replace(
                hp,
                decoder_type="istft",
                upsample_rates=(4, 4),
                upsample_kernel_sizes=(8, 8),
                istft_n_fft=16,
                istft_hop=4,
                istft_bands=4,
            )
        elif quality == "high":
            hp = replace(
                hp,
                resblock="1",
                resblock_kernel_sizes=(3, 7, 11),
                resblock_dilation_sizes=((1, 3, 5), (1, 3, 5), (1, 3, 5)),
                upsample_rates=(8, 8, 2, 2),
                upsample_initial_channel=512,
                upsample_kernel_sizes=(16, 16, 4, 4),
            )
        elif quality != "medium":
            raise ValueError(f"unknown quality preset: {quality}")
        if overrides:
            hp = replace(hp, **overrides)
        return hp


def _init_decoder(generator: torch.Generator, hp: VitsHParams):
    return hifigan.init_generator(
        generator, hp.inter_channels, hp.resblock, hp.resblock_kernel_sizes,
        hp.resblock_dilation_sizes, hp.upsample_rates,
        hp.upsample_initial_channel, hp.upsample_kernel_sizes,
        gin_channels=hp.gin_channels)


def random_params(hp: VitsHParams,
                  generator: Optional[torch.Generator] = None
                  ) -> Dict[str, Any]:
    """Random initialization with the reference init schemes, on the CPU.

    The tree and its flat names (``load.params_to_flat``) are those of the
    JAX package's ``random_params``; the values are not.
    """
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params: Dict[str, Any] = {
        "enc_p": encoder.init_text_encoder(
            generator, hp.n_vocab, hp.inter_channels, hp.hidden_channels,
            hp.filter_channels, hp.n_heads, hp.n_layers, hp.kernel_size),
        "dec": _init_decoder(generator, hp),
        "enc_q": posterior.init_posterior_encoder(
            generator, hp.spec_channels, hp.inter_channels,
            hp.hidden_channels, 5, 1, 16, gin_channels=hp.gin_channels),
        "flow": posterior.init_residual_coupling_block(
            generator, hp.inter_channels, hp.hidden_channels, 5, 1, 4,
            gin_channels=hp.gin_channels),
    }
    if hp.use_sdp:
        params["dp"] = duration.init_stochastic_duration_predictor(
            generator, hp.hidden_channels, 192, 3, 4,
            gin_channels=hp.gin_channels)
    else:
        params["dp"] = duration.init_duration_predictor(
            generator, hp.hidden_channels, 256, 3,
            gin_channels=hp.gin_channels)
    if hp.n_speakers > 1:
        params["emb_g"] = {"weight": torch.randn(
            (hp.n_speakers, hp.gin_channels), generator=generator)}
    return params


def params_to_device(tree: Any, device) -> Any:
    """Copy of a parameter tree with every tensor moved to ``device``."""
    if isinstance(tree, dict):
        return {k: params_to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_to_device(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def _speaker_embedding(params, hp: VitsHParams, sid: Optional[Tensor],
                       batch: int, device) -> Optional[Tensor]:
    if hp.n_speakers <= 1:
        return None
    if sid is None:
        sid = torch.zeros((batch,), dtype=torch.int64, device=device)
    return nn.embedding(params["emb_g"], sid.long())[:, None, :]  # [B, 1, G]


def _draw(generator: Optional[torch.Generator], shape, dtype, device,
          what: str, uniform: bool = False) -> Tensor:
    if generator is None:
        raise ValueError(f"pass generator= or inject {what}")
    sample = torch.rand if uniform else torch.randn
    noise = nn.draw(sample, shape, generator, dtype=dtype,
                    device=generator.device)
    return noise.to(device)


def train_forward(params, hp: VitsHParams, x_ids: Tensor, x_lengths: Tensor,
                  spec: Tensor, spec_lengths: Tensor,
                  sid: Optional[Tensor] = None, deterministic: bool = False,
                  generator: Optional[torch.Generator] = None,
                  post_noise: Optional[Tensor] = None,
                  e_q: Optional[Tensor] = None,
                  slice_u: Optional[Tensor] = None,
                  token_count: Optional[Tensor] = None) -> Dict[str, Tensor]:
    """Training forward pass (models.py:617-679).

    x_ids [B, T_x]; spec [B, T_y, C_spec]; lengths [B]. Returns the sliced
    waveform, the duration loss, the alignment and the latents the KL
    loss needs, under the JAX package's keys.

    Noise may be injected: ``post_noise`` [B, T_y, inter_channels],
    ``e_q`` [B, T_x, 2] (the SDP's posterior sample) and ``slice_u`` [B]
    (uniform in [0, 1), scaled to the segment offsets); what is not
    injected, and every dropout mask, is drawn from ``generator``.

    ``token_count``: the duration loss's denominator; None is this
    batch's token count, ``sum(x_mask)``. Under data parallelism the step
    passes the global batch's count over the number of ranks.

    Like the JAX training forward, every module runs in plain PyTorch ops
    except the alignment search (kernel D on the card): the encoder stack,
    the forward flow and the decoder are the differentiable plain
    versions, so no tensor of this path reaches kernels A, B or C, which
    have no backward.
    """
    b, t_x = x_ids.shape
    t_y = spec.shape[1]
    seg = hp.segment_size
    dev = spec.device
    drop = dict(generator=generator, deterministic=deterministic)

    x_mask = nn.sequence_mask(x_lengths, t_x)[..., None].to(spec.dtype)
    y_mask = nn.sequence_mask(spec_lengths, t_y)[..., None].to(spec.dtype)

    x, m_p, logs_p = encoder.text_encoder_train(
        params["enc_p"], x_ids, x_mask, p_dropout=hp.p_dropout, **drop)
    g = _speaker_embedding(params, hp, sid, b, dev)

    if post_noise is None:
        post_noise = _draw(generator, (b, t_y, hp.inter_channels),
                           spec.dtype, dev, "post_noise")
    z, m_q, logs_q = posterior.posterior_encoder(
        params["enc_q"], spec, y_mask, post_noise.to(dev, spec.dtype), g=g)
    z_p = posterior.coupling_flow_plain(params["flow"], z, y_mask, g=g)

    # MAS alignment, without gradients (models.py:628-650); the products
    # are left to torch.matmul as the JAX package leaves them to XLA
    with torch.no_grad():
        s_p_sq_r = torch.exp(-2.0 * logs_p)  # [B, T_x, C]
        neg_cent1 = torch.sum(-0.5 * math.log(2.0 * math.pi) - logs_p,
                              dim=-1)[:, None, :]  # [B, 1, T_x]
        neg_cent2 = torch.einsum("byc,bxc->byx", -0.5 * torch.square(z_p),
                                 s_p_sq_r)
        neg_cent3 = torch.einsum("byc,bxc->byx", z_p, m_p * s_p_sq_r)
        neg_cent4 = torch.sum(-0.5 * torch.square(m_p) * s_p_sq_r,
                              dim=-1)[:, None, :]
        neg_cent = neg_cent1 + neg_cent2 + neg_cent3 + neg_cent4
        attn_mask = y_mask * x_mask.transpose(1, 2)  # [B, T_y, T_x]
        attn = mas.maximum_path(neg_cent, attn_mask)

    w = torch.sum(attn, dim=1)[..., None]  # [B, T_x, 1] durations
    tokens = torch.sum(x_mask.float()) if token_count is None else token_count
    if hp.use_sdp:
        if e_q is None:
            e_q = _draw(generator, (b, t_x, 2), spec.dtype, dev, "e_q")
        l_length = duration.sdp_nll(
            params["dp"], x, x_mask, w, e_q.to(dev, spec.dtype), g=g,
            p_dropout=0.5, **drop)
        # exact token count, the quotient in f32 as JAX promotes it
        l_length = l_length.float() / tokens
    else:
        logw_ = torch.log(w + 1e-6) * x_mask
        logw = duration.duration_predictor(params["dp"], x, x_mask, g=g,
                                           p_dropout=0.5, **drop)
        l_length = (torch.sum(torch.square(logw - logw_), dim=(1, 2)).float()
                    / tokens)

    # expand the prior over the alignment: [B, T_y, T_x] @ [B, T_x, C]
    m_p_exp = torch.matmul(attn, m_p)
    logs_p_exp = torch.matmul(attn, logs_p)

    # random segment slice for the vocoder (commons.py:47-63)
    if slice_u is None:
        slice_u = _draw(generator, (b,), torch.float32, dev, "slice_u",
                        uniform=True)
    max_start = torch.clamp(spec_lengths - seg + 1, min=1)
    starts = (slice_u.to(dev, torch.float32) * max_start).to(torch.int32)
    z_slice = _slice_segments(z, starts, seg)
    o = hifigan.generator_train(params["dec"], z_slice, g=g)

    return {
        "audio": o,
        "l_length": l_length,
        "attn": attn,
        "ids_slice": starts,
        "x_mask": x_mask,
        "y_mask": y_mask,
        "z": z,
        "z_p": z_p,
        "m_p": m_p_exp,
        "logs_p": logs_p_exp,
        "m_q": m_q,
        "logs_q": logs_q,
    }


def _slice_segments(x: Tensor, starts: Tensor, segment_size: int) -> Tensor:
    """Gather fixed-size segments at per-batch offsets; x [B, T, C]."""
    idx = starts.long()[:, None] + torch.arange(segment_size,
                                                device=x.device)[None, :]
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def slice_audio_segments(y: Tensor, starts: Tensor, segment_samples: int,
                         hop: int) -> Tensor:
    """Slice waveform segments aligned with frame slices; y [B, N]."""
    idx = (starts.long() * hop)[:, None] + torch.arange(
        segment_samples, device=y.device)[None, :]
    return torch.gather(y, 1, idx)


