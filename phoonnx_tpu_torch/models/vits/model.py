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

from phoonnx_tpu_torch.models.vits import (duration, encoder, hifigan,
                                           istft_decoder, nn, posterior)
from phoonnx_tpu_torch.ops import mas

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
    """The configured decoder family's parameters (the JAX package's
    ``_init_decoder``)."""
    common = (generator, hp.inter_channels, hp.resblock,
              hp.resblock_kernel_sizes, hp.resblock_dilation_sizes,
              hp.upsample_rates, hp.upsample_initial_channel,
              hp.upsample_kernel_sizes)
    if hp.decoder_type == "istft":
        return istft_decoder.init_istft_generator(
            *common, istft_n_fft=hp.istft_n_fft, istft_hop=hp.istft_hop,
            istft_bands=hp.istft_bands, gin_channels=hp.gin_channels)
    return hifigan.init_generator(*common, gin_channels=hp.gin_channels)


def _decoder(dec_params):
    """(serving generator, training generator, kernel C specs function) of
    the decoder family that ``dec_params`` holds: the iSTFT decoder's
    spectral heads (``conv_mag``) stand where HiFi-GAN has ``conv_post``."""
    if "conv_mag" in dec_params:
        return (istft_decoder.istft_generator,
                istft_decoder.istft_generator_train,
                istft_decoder.build_stage_specs)
    return (hifigan.generator, hifigan.generator_train,
            hifigan.build_stage_specs)


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


def attach_fused_specs(params):
    """Params view with the kernel specs attached: kernel A's stacked
    encoder weights (``enc_p.encoder.fused``), kernel B's stacked reverse
    flow (``flow.fused_rev``) and kernel C's per-stage resblock groups
    (``dec.fused_stages``, of the HiFi-GAN or the iSTFT decoder). The
    specs are built from the tensors where they lie, so attach after
    moving the parameters to their device.
    Idempotent: a subtree that already carries its spec is kept."""
    from phoonnx_tpu_torch.models.vits import fused_encoder, fused_flow

    out = dict(params)
    if "fused" not in params["enc_p"]["encoder"]:
        spec = fused_encoder.build_spec(params["enc_p"]["encoder"])
        if spec is None:
            raise ValueError("text encoder layout is not the uniform VITS "
                             "stack kernel A computes")
        out["enc_p"] = dict(params["enc_p"],
                            encoder=dict(params["enc_p"]["encoder"],
                                         fused=spec))
    if "fused_rev" not in params["flow"]:
        spec = fused_flow.build_spec(params["flow"])
        if spec is None:
            raise ValueError("coupling flow layout is not the uniform VITS "
                             "stack kernel B computes")
        out["flow"] = dict(params["flow"], fused_rev=spec)
    if "fused_stages" not in params["dec"]:
        _, _, build_specs = _decoder(params["dec"])
        out["dec"] = dict(params["dec"],
                          fused_stages=build_specs(params["dec"]))
    return out


def detach_fused_specs(params):
    """Params view without the kernel specs :func:`attach_fused_specs`
    adds (they hold views of the weights beside them): what to move to
    another device before attaching them there anew."""
    out = dict(params)
    out["enc_p"] = dict(params["enc_p"], encoder={
        k: v for k, v in params["enc_p"]["encoder"].items() if k != "fused"})
    out["flow"] = {k: v for k, v in params["flow"].items()
                   if k != "fused_rev"}
    out["dec"] = {k: v for k, v in params["dec"].items()
                  if k != "fused_stages"}
    return out


def decode_audio(params, hp: VitsHParams, z: Tensor,
                 g: Optional[Tensor] = None,
                 frame_lengths: Optional[Tensor] = None) -> Tensor:
    """Latent frames -> waveform via the configured decoder family.

    frame_lengths: [B] true frame counts when z is padded; the decoder
    re-zeroes padded time positions so the valid span equals decoding the
    exact-length latents (the reference slices z before ``dec``,
    models.py:721).
    """
    generator, _, _ = _decoder(params["dec"])
    return generator(params["dec"], z, g=g, frame_lengths=frame_lengths)


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
    _, generator_train, _ = _decoder(params["dec"])
    o = generator_train(params["dec"], z_slice, g=g)

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


def voice_conversion(params, hp: VitsHParams, spec: Tensor,
                     spec_lengths: Tensor, sid_src: Tensor, sid_tgt: Tensor,
                     noise: Optional[Tensor] = None,
                     generator: Optional[torch.Generator] = None):
    """Convert an utterance between speakers (models.py:724-732).

    spec [B, T, C_spec] -> (waveform [B, T * total_upsample] in the target
    speaker's voice, y_mask [B, T, 1]); needs a multi-speaker model (the
    posterior encoder's weights). The posterior encoder and the forward
    flow run with the source speaker, the reverse flow (kernel B) and the
    decoder (kernel C) with the target. ``noise`` [B, T, inter_channels]
    can be injected; otherwise it is drawn from ``generator``.
    """
    if hp.n_speakers <= 1:
        raise ValueError("voice conversion requires a multi-speaker model")
    b, t_y = spec.shape[:2]
    y_mask = nn.sequence_mask(spec_lengths, t_y)[..., None].to(spec.dtype)
    g_src = nn.embedding(params["emb_g"], sid_src.long())[:, None, :]
    g_tgt = nn.embedding(params["emb_g"], sid_tgt.long())[:, None, :]
    if noise is None:
        noise = _draw(generator, (b, t_y, hp.inter_channels), spec.dtype,
                      spec.device, "noise")
    z, _, _ = posterior.posterior_encoder(
        params["enc_q"], spec, y_mask,
        noise.to(device=spec.device, dtype=spec.dtype), g=g_src)
    z_p = posterior.coupling_flow(params["flow"], z, y_mask, g=g_src)
    z_hat = posterior.coupling_flow(params["flow"], z_p, y_mask, g=g_tgt,
                                    reverse=True)
    audio = decode_audio(params, hp, z_hat * y_mask, g=g_tgt,
                         frame_lengths=spec_lengths)
    return audio, y_mask


def expand_prior(m_p: Tensor, logs_p: Tensor, w_ceil: Tensor,
                 y_mask: Tensor, max_frames: int):
    """Expand (m_p, logs_p) [B, T_x, C] to frames [B, T_y, C] by gather.

    Frame y belongs to the first text position whose cumulative duration
    exceeds it, so its index is #(cum <= y): the rows of the reference's
    einsum(one-hot path, m_p) (models.py:663-665) without building the
    one-hot path.
    """
    t_x = m_p.shape[1]
    cum = torch.cumsum(w_ceil, dim=-1)  # [B, T_x] f32, exact below 2**24
    frames = torch.arange(max_frames, dtype=torch.float32,
                          device=m_p.device)
    idx = torch.sum(cum[:, None, :] <= frames[None, :, None], dim=-1)
    idx = torch.clamp(idx, max=t_x - 1)[..., None].expand(
        -1, -1, m_p.shape[-1])
    m_p_exp = torch.gather(m_p, 1, idx) * y_mask
    logs_p_exp = torch.gather(logs_p, 1, idx) * y_mask
    return m_p_exp, logs_p_exp


def _log_durations(params, hp: VitsHParams, x: Tensor, x_mask: Tensor,
                   noise_w, g: Optional[Tensor], dp_noise: Optional[Tensor],
                   generator: Optional[torch.Generator]) -> Tensor:
    """logw [B, T_x, 1] of the duration predictor, in the encoder's dtype."""
    b, t_x = x.shape[:2]
    dtype = x.dtype
    if hp.use_sdp:
        if dp_noise is None:
            dp_noise = _draw(generator, (b, t_x, 2), dtype, x.device,
                             "dp_noise")
        logw = duration.sdp_reverse(
            params["dp"], x, x_mask,
            dp_noise.to(device=x.device, dtype=dtype)
            * torch.as_tensor(noise_w, dtype=dtype), g=g)
    else:
        logw = duration.duration_predictor(params["dp"], x, x_mask, g=g)
    return logw


def _durations(params, hp: VitsHParams, x: Tensor, x_mask: Tensor,
               length_scale, noise_w, g: Optional[Tensor],
               dp_noise: Optional[Tensor],
               generator: Optional[torch.Generator]) -> Tensor:
    """w_ceil [B, T_x]: frames per text position, counted in f32."""
    logw = _log_durations(params, hp, x, x_mask, noise_w, g, dp_noise,
                          generator)
    # duration arithmetic in f32 (a half type cannot count frames exactly)
    w = torch.exp(logw.float()) * x_mask.float() * length_scale
    return torch.ceil(w)[..., 0]


def _frame_lengths(w_ceil: Tensor, max_frames: int) -> Tensor:
    y_lengths = torch.clamp(torch.sum(w_ceil, dim=-1), min=1.0).to(
        torch.int32)
    return torch.clamp(y_lengths, max=max_frames)


def infer(params, hp: VitsHParams, x_ids: Tensor, x_lengths: Tensor,
          max_frames: int, noise_scale, length_scale, noise_w,
          sid: Optional[Tensor] = None,
          generator: Optional[torch.Generator] = None,
          dp_noise: Optional[Tensor] = None,
          prior_noise: Optional[Tensor] = None):
    """Inference (models.py:681-722) with a frame budget ``max_frames``.

    Returns (audio [B, max_frames * total_upsample], y_lengths int32 [B],
    attn [B, max_frames, T_x]). Noise can be injected (``dp_noise``
    [B, T_x, 2], ``prior_noise`` [B, max_frames, C]); otherwise it is
    drawn from ``generator``. The scales are floats or 0-d tensors: the
    engine passes 0-d tensors on the device, which a CUDA graph reads at
    every replay, where a float would be baked into the capture.
    """
    b, t_x = x_ids.shape
    dtype = params["enc_p"]["emb"]["weight"].dtype
    x_mask = nn.sequence_mask(x_lengths, t_x)[..., None].to(dtype)
    x, m_p, logs_p = encoder.text_encoder(params["enc_p"], x_ids, x_mask)
    g = _speaker_embedding(params, hp, sid, b, x.device)
    w_ceil = _durations(params, hp, x, x_mask, length_scale, noise_w, g,
                        dp_noise, generator)
    y_lengths = _frame_lengths(w_ceil, max_frames)
    y_mask = nn.sequence_mask(y_lengths, max_frames)[..., None].to(dtype)
    attn_mask = y_mask * x_mask.transpose(1, 2)  # [B, T_y, T_x]
    attn = nn.generate_path(w_ceil, attn_mask)
    z = _latents(params, m_p, logs_p, w_ceil, y_mask, max_frames,
                 noise_scale, g, prior_noise, generator)
    audio = decode_audio(params, hp, z, g=g, frame_lengths=y_lengths)
    return audio, y_lengths, attn


def _latents(params, m_p, logs_p, w_ceil, y_mask, max_frames, noise_scale,
             g, prior_noise, generator) -> Tensor:
    dtype = m_p.dtype
    m_p_exp, logs_p_exp = expand_prior(m_p, logs_p, w_ceil, y_mask,
                                       max_frames)
    if prior_noise is None:
        prior_noise = _draw(generator, m_p_exp.shape, dtype, m_p.device,
                            "prior_noise")
    z_p = m_p_exp + prior_noise.to(device=m_p.device, dtype=dtype) \
        * torch.exp(logs_p_exp) * torch.as_tensor(noise_scale, dtype=dtype)
    z = posterior.coupling_flow(params["flow"], z_p, y_mask, g=g,
                                reverse=True)
    return z * y_mask


def infer_durations(params, hp: VitsHParams, x_ids: Tensor,
                    x_lengths: Tensor, length_scale, noise_w,
                    sid: Optional[Tensor] = None,
                    dp_noise: Optional[Tensor] = None,
                    generator: Optional[torch.Generator] = None):
    """Phase 1 of two-phase synthesis: encoder + durations only.

    Returns (m_p, logs_p, w_ceil, x_mask, g); the host picks the frame
    budget from sum(w_ceil) and runs phase 2 (:func:`infer_decode`).
    """
    b, t_x = x_ids.shape
    dtype = params["enc_p"]["emb"]["weight"].dtype
    x_mask = nn.sequence_mask(x_lengths, t_x)[..., None].to(dtype)
    x, m_p, logs_p = encoder.text_encoder(params["enc_p"], x_ids, x_mask)
    g = _speaker_embedding(params, hp, sid, b, x.device)
    w_ceil = _durations(params, hp, x, x_mask, length_scale, noise_w, g,
                        dp_noise, generator)
    return m_p, logs_p, w_ceil, x_mask, g


def infer_log_durations(params, hp: VitsHParams, x_ids: Tensor,
                        x_lengths: Tensor, noise_w,
                        sid: Optional[Tensor] = None,
                        dp_noise: Optional[Tensor] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> Tensor:
    """The log-durations [B, T_x] that :func:`infer_durations` scales by
    ``length_scale`` and rounds up to frames, in float32, 0 past each
    length."""
    b, t_x = x_ids.shape
    dtype = params["enc_p"]["emb"]["weight"].dtype
    x_mask = nn.sequence_mask(x_lengths, t_x)[..., None].to(dtype)
    x, _, _ = encoder.text_encoder(params["enc_p"], x_ids, x_mask)
    g = _speaker_embedding(params, hp, sid, b, x.device)
    logw = _log_durations(params, hp, x, x_mask, noise_w, g, dp_noise,
                          generator)
    return (logw.float() * x_mask.float())[..., 0]


def infer_latents(params, hp: VitsHParams, m_p: Tensor, logs_p: Tensor,
                  w_ceil: Tensor, x_mask: Tensor, max_frames: int,
                  noise_scale, g: Optional[Tensor] = None,
                  prior_noise: Optional[Tensor] = None,
                  generator: Optional[torch.Generator] = None):
    """Expand the prior to ``max_frames`` and reverse the flow.

    Returns (z * y_mask [B, max_frames, C], y_lengths int32 [B]).
    """
    y_lengths = _frame_lengths(w_ceil, max_frames)
    y_mask = nn.sequence_mask(y_lengths, max_frames)[..., None].to(
        m_p.dtype)
    z = _latents(params, m_p, logs_p, w_ceil, y_mask, max_frames,
                 noise_scale, g, prior_noise, generator)
    return z, y_lengths


def infer_decode(params, hp: VitsHParams, m_p: Tensor, logs_p: Tensor,
                 w_ceil: Tensor, x_mask: Tensor, max_frames: int,
                 noise_scale, g: Optional[Tensor] = None,
                 prior_noise: Optional[Tensor] = None,
                 generator: Optional[torch.Generator] = None):
    """Phase 2: expand the prior, reverse the flow, vocode."""
    z, y_lengths = infer_latents(
        params, hp, m_p, logs_p, w_ceil, x_mask, max_frames, noise_scale,
        g=g, prior_noise=prior_noise, generator=generator)
    audio = decode_audio(params, hp, z, g=g, frame_lengths=y_lengths)
    return audio, y_lengths
