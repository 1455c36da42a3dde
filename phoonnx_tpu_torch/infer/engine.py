"""VITS synthesis engine on a PyTorch device (the GPU unless asked otherwise).

PyTorch port of ``phoonnx_tpu/infer/engine.py``. Synthesis runs in two
phases: phase 1 (text encoder + duration predictor) gives the frame count
of every utterance, the host reads it, and phase 2 (prior expansion +
inverse flow + HiFi-GAN) decodes at the batch's longest frame count.
PyTorch runs eagerly, so a batch is padded to its longest member rather
than to compile buckets. The frame cap of the JAX engine (its largest
frame bucket, 4096) stays, with its truncation warning.

Noise is drawn per utterance from a ``torch.Generator`` seeded with
``seed + i`` for the batch's i-th utterance, first the duration noise
[T_x, 2] and then the prior noise [frames, C]. An utterance therefore gets
the same noise alone as inside a batch, and the padded batch decode equals
the single decode on the valid span.

Streaming (``synthesize_ids_streaming``) decodes the latent frames in
overlapping windows. The decoders are translation-invariant conv stacks,
so with the same seed the concatenated stream equals ``synthesize_ids``.
"""

import logging
import math
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from phoonnx_tpu_torch.models.vits import model as vits_model
from phoonnx_tpu_torch.models.vits.model import VitsHParams

LOG = logging.getLogger(__name__)

# the JAX engine's largest frame bucket: longer predictions are truncated
MAX_FRAMES = 4096

# right context (frames) the inverse coupling flow reads past any output
# frame: 4 couplings x WN(4 layers, k=5, d=1) x (5-1)/2. Latents computed
# on a prefix with this much extra context equal the whole utterance's
# latents on the prefix's first frames.
FLOW_CONTEXT = 32


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. Without one this raises: entry points never
    drop to the CPU unless the caller asks for it (``device="cpu"``)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "phoonnx_tpu_torch runs on a CUDA GPU by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        # the port's contract is float32: no TF32 in cuBLAS or cuDNN
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


class VitsEngine:
    """Two-phase VITS synthesis on one device."""

    def __init__(self, params, hp: VitsHParams, dtype: str = "float32",
                 device=None):
        if dtype != "float32":
            raise ValueError(
                f"dtype {dtype!r}: phoonnx_tpu_torch computes in float32 only "
                "so far (ROADMAP.md, port queue: 'bf16')")
        self.hp = hp
        self.device = resolve_device(device)
        self.max_frames = MAX_FRAMES
        self.params = vits_model.attach_fused_specs(
            vits_model.params_to_device(params, self.device))

    def _check_speakers(self, speaker_ids) -> None:
        """An out-of-range id would index another speaker's embedding."""
        n = self.hp.n_speakers
        if n <= 1:
            return  # single-speaker graphs ignore sid (reference behavior)
        for sid in speaker_ids:
            if not 0 <= int(sid) < n:
                raise ValueError(
                    f"speaker_id {sid} out of range: voice has {n} "
                    f"speakers (0..{n - 1})")

    def _frame_budget(self, frames: int) -> int:
        """The batch's frame count, capped with a truncation warning (the
        JAX engine's largest-bucket clamp): length_scale is request
        controlled, so an over-long prediction must degrade, not fail."""
        if frames > self.max_frames:
            LOG.warning(
                "predicted %d frames exceed the largest frame bucket %d "
                "— audio will be truncated", frames, self.max_frames)
            return self.max_frames
        return max(frames, 1)

    def synthesize_ids(
        self,
        phoneme_ids: Sequence[int],
        noise_scale: float = 0.667,
        length_scale: float = 1.0,
        noise_w: float = 0.8,
        speaker_id: int = 0,
        seed: Optional[int] = None,
        lang_id: Optional[int] = None,
    ) -> np.ndarray:
        """One utterance -> float32 waveform (trimmed to its true length).
        ``lang_id`` is accepted for API parity and unused: the VITS graph
        has no language conditioning."""
        audio, lengths = self.synthesize_batch(
            [phoneme_ids], noise_scale=noise_scale,
            length_scale=length_scale, noise_w=noise_w,
            speaker_ids=[speaker_id], seed=seed)
        return audio[0][: lengths[0] * self.hp.total_upsample]

    def _decode_chunk(self, z: torch.Tensor, start: int, offset: int,
                      y_len: int, g: Optional[torch.Tensor], window: int,
                      chunk: int) -> torch.Tensor:
        """Decode the latent window ``z[:, start:start + window]`` and keep
        its frames ``[offset, offset + chunk)``, as audio samples.

        With at least the decoder's receptive field of context on each
        side of the kept span (or the utterance's true edge), the kept
        audio equals the monolithic decode there. The window lies inside
        the latent buffer and is never zero-padded: zero latent frames are
        not the convs' own zero padding, since biases propagate through
        the stack. Frames past the utterance (``y_len``) are masked by the
        decoder's ``frame_lengths`` contract.
        """
        up = self.hp.total_upsample
        zc = z[:, start:start + window]
        valid = torch.full((z.shape[0],), min(max(y_len - start, 0), window),
                           dtype=torch.int32, device=z.device)
        audio = vits_model.decode_audio(self.params, self.hp, zc, g=g,
                                        frame_lengths=valid)
        return audio[:, offset * up:(offset + chunk) * up]

    @torch.inference_mode()
    def synthesize_ids_streaming(
        self,
        phoneme_ids: Sequence[int],
        chunk_frames: int = 128,
        overlap_frames: int = 32,
        noise_scale: float = 0.667,
        length_scale: float = 1.0,
        noise_w: float = 0.8,
        speaker_id: int = 0,
        seed: Optional[int] = None,
        lang_id: Optional[int] = None,
    ) -> Iterator[np.ndarray]:
        """Yield one utterance's float32 waveform in chunks of
        ``chunk_frames`` latent frames as the decoder produces them.
        ``lang_id`` is accepted for API parity and unused.

        For the time to the first audio, the durations are read by the
        host, then only a prefix of the latents (the first window and
        ``FLOW_CONTEXT`` frames of the flow's right context) goes through
        the flow before the first window is decoded. The remaining chunks
        decode windows of the whole utterance's latents with
        ``overlap_frames`` frames of context on each side (32 covers every
        preset's decoder). The noise is drawn as :meth:`synthesize_batch`
        draws it, and the prefix's prior noise is a slice of the same
        draw, so with the same ``seed`` the concatenated stream equals
        :meth:`synthesize_ids`.
        """
        self._check_speakers((speaker_id,))
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31 - 1))
        dev = self.device
        hp = self.hp
        up = hp.total_upsample
        chunk = max(1, chunk_frames)
        overlap = max(0, overlap_frames)
        window = chunk + 2 * overlap

        gen = torch.Generator().manual_seed(seed)
        ids = torch.as_tensor([list(phoneme_ids)], dtype=torch.int64)
        lengths = torch.tensor([len(phoneme_ids)], dtype=torch.int32)
        dp_noise = torch.randn((len(phoneme_ids), 2), generator=gen)[None]
        sid = torch.tensor([speaker_id], dtype=torch.int64, device=dev)
        m_p, logs_p, w_ceil, x_mask, g = vits_model.infer_durations(
            self.params, hp, ids.to(dev), lengths.to(dev), length_scale,
            noise_w, sid=sid, dp_noise=dp_noise.to(dev))
        # host decision: the frame count from the predicted durations
        n_frames = self._frame_budget(
            int(torch.clamp(torch.sum(w_ceil, dim=-1), min=1.0)[0]))
        prior = torch.randn((n_frames, hp.inter_channels),
                            generator=gen)[None].to(dev)

        # first audio: the flow over the prefix only, then the first window
        n_pre = min(window + FLOW_CONTEXT, n_frames)
        z_pre, _ = vits_model.infer_latents(
            self.params, hp, m_p, logs_p, w_ceil, x_mask, n_pre, noise_scale,
            g=g, prior_noise=prior[:, :n_pre])
        first_window = min(window, n_pre)
        audio = self._decode_chunk(z_pre, 0, 0, n_frames, g, first_window,
                                   first_window)
        wav = audio[0].float().cpu().numpy()
        yield wav[:min(chunk, n_frames) * up]
        if n_frames <= window:
            # the first window held the whole utterance
            if n_frames > chunk:
                yield wav[chunk * up:n_frames * up]
            return

        z, _ = vits_model.infer_latents(
            self.params, hp, m_p, logs_p, w_ceil, x_mask, n_frames,
            noise_scale, g=g, prior_noise=prior)
        in_flight = []
        for i in range(1, math.ceil(n_frames / chunk)):
            # the window stays inside the latent buffer, so the kept span
            # has >= overlap frames of true context (or the utterance's
            # edge) on each side
            start = min(max(i * chunk - overlap, 0), n_frames - window)
            offset = i * chunk - start
            # a final chunk whose nominal span overruns the buffer keeps
            # the buffer's last `chunk` frames instead and skips, when
            # emitted, what earlier chunks already gave
            skip = 0
            if offset > window - chunk:
                offset = window - chunk
                skip = (i * chunk - (start + offset)) * up
            in_flight.append((self._decode_chunk(
                z, start, offset, n_frames, g, window, chunk), skip))
        emitted = chunk * up
        total = n_frames * up
        for audio, skip in in_flight:
            wav = audio[0].float().cpu().numpy()
            take = min(len(wav) - skip, total - emitted)
            if take <= 0:
                break
            emitted += take
            yield wav[skip:skip + take]

    @torch.inference_mode()
    def synthesize_batch(
        self,
        batch_ids: Sequence[Sequence[int]],
        noise_scale: float = 0.667,
        length_scale: float = 1.0,
        noise_w: float = 0.8,
        speaker_ids: Optional[Sequence[int]] = None,
        seed: Optional[int] = None,
        lang_id: Optional[int] = None,
    ) -> Tuple[np.ndarray, List[int]]:
        """Batched synthesis padded to the longest member. ``lang_id`` is
        accepted for API parity and unused.

        Returns (waveforms [B, frames * total_upsample] float32, the true
        frame count of each utterance).
        """
        batch = len(batch_ids)
        if speaker_ids is not None:
            self._check_speakers(speaker_ids)
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31 - 1 - batch))
        dev = self.device
        hp = self.hp
        t_x = max(len(ids) for ids in batch_ids)
        ids = torch.zeros((batch, t_x), dtype=torch.int64)
        lengths = torch.zeros((batch,), dtype=torch.int32)
        gens = [torch.Generator().manual_seed(seed + i) for i in range(batch)]
        dp_noise = torch.zeros((batch, t_x, 2))
        for i, utt in enumerate(batch_ids):
            ids[i, :len(utt)] = torch.as_tensor(list(utt), dtype=torch.int64)
            lengths[i] = len(utt)
            dp_noise[i, :len(utt)] = torch.randn((len(utt), 2),
                                                 generator=gens[i])
        sid = None
        if speaker_ids is not None:
            sid = torch.as_tensor(list(speaker_ids), dtype=torch.int64,
                                  device=dev)

        m_p, logs_p, w_ceil, x_mask, g = vits_model.infer_durations(
            self.params, hp, ids.to(dev), lengths.to(dev), length_scale,
            noise_w, sid=sid, dp_noise=dp_noise.to(dev))

        # host decision: the frame budget from the predicted durations
        frames = [int(n) for n in torch.clamp(
            torch.sum(w_ceil, dim=-1), min=1.0).cpu()]
        budget = self._frame_budget(max(frames))
        prior_noise = torch.zeros((batch, budget, hp.inter_channels))
        for i, n in enumerate(frames):
            n = min(n, budget)
            prior_noise[i, :n] = torch.randn((n, hp.inter_channels),
                                             generator=gens[i])

        audio, y_lengths = vits_model.infer_decode(
            self.params, hp, m_p, logs_p, w_ceil, x_mask, budget,
            noise_scale, g=g, prior_noise=prior_noise.to(dev))
        return (audio.float().cpu().numpy(),
                [int(n) for n in y_lengths.cpu()])
