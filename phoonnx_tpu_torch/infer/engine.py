"""VITS synthesis engine on a PyTorch device (the GPU unless asked otherwise).

PyTorch port of ``phoonnx_tpu/infer/engine.py``. Variable-length synthesis
is dispatched over static shape buckets, as in the JAX engine:

* phase 1 (text encoder + duration predictor) per (batch, text bucket);
* phase 2 (prior expansion + inverse flow + decoder) per (batch, text
  bucket, frame bucket), the frame bucket chosen on the host from the
  predicted durations;
* ``mode="fused"``: the whole pipeline per (batch, text bucket) with a
  frame budget of ``frames_per_token`` frames a text-bucket slot, rounded
  to a frame bucket, and no host read between the phases;
* streaming: one program for the first audio (durations, the latents of
  a prefix, the first window), then the latents at the frame bucket and
  one decode-chunk program for every window, its position an input;
* voice conversion per frame bucket.

Each program is a method that takes tensors only (``_phase1``,
``_phase2``, ``_fused``, ``_latents``, ``_first_chunk``,
``_decode_chunk``, ``_vc``). On the CPU the engine calls it directly. On
CUDA each program key is captured once as a CUDA graph and then replayed
(``graphs.py``): there is no eager path on the card. The buckets are the
graph keys. A replay returns fresh tensors, and the engine's replays run
one at a time on its own stream, so threads may share an engine and
streams of one key may interleave. A padded decode equals the
exact-length decode on the valid span (kernel C masks every stage to
it), so the padding changes no valid sample.

Noise is drawn on the engine's device, one launch of the counter-based
noise kernel a draw (``ops/noise.py``, Philox4x32-10 and Box-Muller in
float32): the batch's i-th utterance is keyed by ``seed + i``, its
duration noise [T_x, 2] by tag ``noise.DURATION`` and its prior noise
[frames, C] by ``noise.PRIOR``. Each value depends only on the key, the
tag and its (row, channel), so an utterance gets the same noise alone as
inside a batch, and a draw of n rows is the first n rows of a longer
draw: fused mode (which draws its whole frame budget before the frame
count is known) and streaming (which draws the first window's prefix
first) get the prior rows that two-phase synthesis draws, and with the
same seed every mode gives the same audio. Both dtypes of one seed draw
the same noise (bfloat16 is the float32 draw rounded once). The CPU
engine draws the same function in plain PyTorch. Seeded audio differs
from that of releases that drew from per-utterance ``torch.Generator``s
on the host.
"""

import contextlib
import logging
import math
import threading
from functools import partial
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from phoonnx_tpu_torch import observability
from phoonnx_tpu_torch.infer.graphs import Graphs
from phoonnx_tpu_torch.models.vits import model as vits_model
from phoonnx_tpu_torch.models.vits import nn
from phoonnx_tpu_torch.models.vits.model import VitsHParams
from phoonnx_tpu_torch.ops import noise
from phoonnx_tpu_torch.ops.stft import spectrogram

LOG = logging.getLogger(__name__)

DEFAULT_TEXT_BUCKETS = (32, 64, 128, 256, 512, 1024)
DEFAULT_FRAME_BUCKETS = (64, 128, 256, 384, 512, 768, 1024, 1536, 2048,
                         3072, 4096)

# right context (frames) the inverse coupling flow reads past any output
# frame: 4 couplings x WN(4 layers, k=5, d=1) x (5-1)/2. Latents computed
# on a prefix with this much extra context equal the whole utterance's
# latents on the prefix's first frames.
FLOW_CONTEXT = 32

# the matmul precisions the JAX CLIs offer, under the names torch uses
# (torch.set_float32_matmul_precision); None is "default"
MATMUL_PRECISIONS = (None, "default", "high", "highest")

# one lock for the process-wide TF32 flags: every scope and every write
# of them holds it
_PREC_LOCK = threading.RLock()

# the engine's dtypes: float32, and bfloat16 as the JAX engine serves
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

PCM16_SCALE = 32767.0


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
        # outside a "high" scope; the lock waits for any scope another
        # thread holds, which restores the flags when it ends
        with _PREC_LOCK:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
    return device


def check_precision(name: Optional[str]) -> Optional[str]:
    """``name`` if it is one of :data:`MATMUL_PRECISIONS`, else raise."""
    if name not in MATMUL_PRECISIONS:
        raise ValueError(f"matmul_precision {name!r}: None, 'default', "
                         "'high' or 'highest'")
    return name


@contextlib.contextmanager
def _prec_scope(name: Optional[str]):
    """An engine's matmul precision around the eager run (or the capture)
    of one of its programs, as the JAX engine's ``_prec_scope`` is around
    its traces. ``"high"`` allows TF32 in cuBLAS and cuDNN, the library
    products; ``None``, ``"default"`` and ``"highest"`` keep both off, the
    port's float32 contract. The hand-written kernels keep their own
    arithmetic under every value. Per engine, not per process: the scope
    holds one process-wide lock while it runs and restores both flags on
    exit, so an engine of one precision never runs under another's flags
    (a default engine enters it too). A CUDA graph replays the kernels it
    captured, so a replay needs no scope."""
    allow = check_precision(name) == "high"
    with _PREC_LOCK:
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = allow
        torch.backends.cudnn.allow_tf32 = allow
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one; a CUDA device without an index is the
    current one."""
    def index(d):
        if d.type == "cuda" and d.index is None:
            return torch.cuda.current_device()
        return d.index
    return a.type == b.type and index(a) == index(b)


def _bucket_for(value: int, buckets: Sequence[int]) -> int:
    for bucket in buckets:
        if value <= bucket:
            return bucket
    raise ValueError(f"length {value} exceeds largest bucket {buckets[-1]}")


def to_pcm16(audio: torch.Tensor) -> torch.Tensor:
    """Clip to 16-bit PCM and truncate toward zero, as the JAX engine's
    ``_to_pcm16`` (``astype(int16)``) does, but in float32 whatever the
    audio's type: the JAX engine scales bf16 audio in bf16, where samples
    above 0.5 come in steps of up to 128."""
    return torch.clamp(audio.float() * PCM16_SCALE, -PCM16_SCALE,
                       PCM16_SCALE).to(torch.int16)


def _audio_np(audio: np.ndarray) -> np.ndarray:
    if audio.dtype == np.int16:
        return audio.astype(np.float32) / PCM16_SCALE
    return audio.astype(np.float32, copy=False)


class VitsEngine:
    """VITS synthesis over static shape buckets, as CUDA graphs on the
    GPU."""

    # batched synthesis runs as ONE device program whose key includes the
    # lane count (the serving batcher pads lanes to power-of-two buckets
    # because of this)
    compiled_batching = True

    def __init__(
        self,
        params,
        hp: VitsHParams,
        text_buckets: Sequence[int] = DEFAULT_TEXT_BUCKETS,
        frame_buckets: Sequence[int] = DEFAULT_FRAME_BUCKETS,
        dtype: str = "float32",
        mode: str = "two_phase",
        frames_per_token: int = 12,
        fetch_pcm16: bool = False,
        device=None,
        matmul_precision: Optional[str] = None,
    ):
        """mode: ``"two_phase"`` (default) predicts the durations, reads
        the frame count on the host and decodes at the tightest frame
        bucket; ``"fused"`` runs one program per call with a frame budget
        of ``frames_per_token * text_bucket`` rounded to a frame bucket,
        and no host read before the audio is fetched.

        fetch_pcm16: quantise the audio to int16 on the device before the
        fetch (half the bytes; the WAV output is 16-bit anyway); the host
        converts back to float32 in [-1, 1].

        dtype: ``"float32"`` or ``"bfloat16"``. In bfloat16 every floating
        parameter is cast (as the JAX engine's ``cast_floating``), the
        scales and the noise reach the programs in bfloat16 (the noise is
        the float32 draw rounded once, so both dtypes of one seed draw the
        same noise), durations and frame counts stay float32 and int32,
        and the kernels take bfloat16 tensors.

        matmul_precision: ``None``/``"default"``, ``"high"`` or
        ``"highest"``, the JAX engine's values; another raises. ``"high"``
        allows TF32 in the library products (cuBLAS, cuDNN) of this
        engine's programs, the others keep them float32; kernels A, B and
        C compute as they always do (f32, C in 3xTF32). The setting is
        scoped to this engine (:func:`_prec_scope`); on the CPU it changes
        nothing.
        """
        if dtype not in DTYPES:
            raise ValueError(
                f"dtype {dtype!r}: 'float32' or 'bfloat16'")
        self.matmul_precision = check_precision(matmul_precision)
        if mode not in ("two_phase", "fused"):
            raise ValueError(f"mode {mode!r}: 'two_phase' or 'fused'")
        self.hp = hp
        self.text_buckets = tuple(text_buckets)
        self.frame_buckets = tuple(frame_buckets)
        self.mode = mode
        self.frames_per_token = frames_per_token
        self.fetch_pcm16 = fetch_pcm16
        self.device = resolve_device(device)
        self.dtype_str = dtype
        self.dtype = DTYPES[dtype]
        self.params = vits_model.attach_fused_specs(nn.cast_floating(
            vits_model.params_to_device(params, self.device), self.dtype))
        self.graphs = Graphs(self.device, self.matmul_precision) \
            if self.device.type == "cuda" else None
        # the args of the decoding spans (engine.phase2, engine.fused): the
        # decoder's family and its bands (1 but for a multi-band iSTFT)
        self._decoder_args = {
            "decoder": hp.decoder_type,
            "bands": hp.istft_bands if hp.decoder_type == "istft" else 1}

    @property
    def max_frames(self) -> int:
        """The largest frame bucket: longer predictions are truncated."""
        return self.frame_buckets[-1]

    def replicate(self, devices) -> List["VitsEngine"]:
        """One engine per device, sharing this engine's configuration.

        Element 0 is this engine when it already sits on ``devices[0]``
        (no weight copy); every other device gets a new engine holding
        its own copy of the parameters (without the kernel specs, which
        the new engine builds on its device) and its own graphs, with
        their pool, lock and stream. Serving
        fans requests out across them (``serve.BatcherPool``).
        """
        out = []
        for i, dev in enumerate(devices):
            dev = torch.device(dev)
            if i == 0 and _same_device(dev, self.device):
                out.append(self)
                continue
            out.append(VitsEngine(
                vits_model.detach_fused_specs(self.params), self.hp,
                text_buckets=self.text_buckets,
                frame_buckets=self.frame_buckets, dtype=self.dtype_str,
                mode=self.mode, frames_per_token=self.frames_per_token,
                fetch_pcm16=self.fetch_pcm16, device=dev,
                matmul_precision=self.matmul_precision))
        return out

    # -- programs: tensors in, tensors out ---------------------------------

    def _sid(self, sid: torch.Tensor) -> Optional[torch.Tensor]:
        return sid if self.hp.n_speakers > 1 else None

    def _phase1(self, ids, lengths, sid, scales, dp_noise):
        """Encoder + durations. ``scales`` [3] is (noise_scale,
        length_scale, noise_w). Returns (m_p, logs_p, w_ceil, x_mask, g,
        frames), ``frames`` the int32 [B] frame counts (at least 1) the
        host reads to choose the frame bucket."""
        m_p, logs_p, w_ceil, x_mask, g = vits_model.infer_durations(
            self.params, self.hp, ids, lengths, scales[1], scales[2],
            sid=self._sid(sid), dp_noise=dp_noise)
        frames = torch.clamp(torch.sum(w_ceil, dim=-1), min=1.0).to(
            torch.int32)
        return m_p, logs_p, w_ceil, x_mask, g, frames

    def _phase2(self, m_p, logs_p, w_ceil, x_mask, g, scales, prior_noise,
                max_frames: int, pcm16: bool = False):
        """Prior expansion + inverse flow + decoder at ``max_frames``.
        Returns (audio [B, max_frames * upsample], y_lengths int32 [B])."""
        audio, y_lengths = vits_model.infer_decode(
            self.params, self.hp, m_p, logs_p, w_ceil, x_mask, max_frames,
            scales[0], g=g, prior_noise=prior_noise)
        return (to_pcm16(audio) if pcm16 else audio), y_lengths

    def _fused(self, ids, lengths, sid, scales, dp_noise, prior_noise,
               max_frames: int, pcm16: bool = False):
        """The whole pipeline in one program (``model.infer`` without the
        alignment matrix): (audio, y_lengths)."""
        m_p, logs_p, w_ceil, x_mask, g, _ = self._phase1(
            ids, lengths, sid, scales, dp_noise)
        return self._phase2(m_p, logs_p, w_ceil, x_mask, g, scales,
                            prior_noise, max_frames, pcm16)

    def _latents(self, m_p, logs_p, w_ceil, x_mask, g, scales, prior_noise,
                 max_frames: int):
        """(z [B, max_frames, C] masked, y_lengths int32 [B])."""
        return vits_model.infer_latents(
            self.params, self.hp, m_p, logs_p, w_ceil, x_mask, max_frames,
            scales[0], g=g, prior_noise=prior_noise)

    def _first_chunk(self, ids, lengths, sid, scales, dp_noise, prior_noise,
                     window: int, pcm16: bool = False):
        """Time to the first audio in one program: encoder, durations, the
        latents of a prefix of ``prior_noise.shape[1]`` frames (the first
        window and ``FLOW_CONTEXT`` frames of the flow's right context)
        and the decode of the first window. Returns (audio [1, window *
        upsample], m_p, logs_p, w_ceil, x_mask, g, frames)."""
        m_p, logs_p, w_ceil, x_mask, g, frames = self._phase1(
            ids, lengths, sid, scales, dp_noise)
        z_pre, y_pre = self._latents(m_p, logs_p, w_ceil, x_mask, g, scales,
                                     prior_noise, prior_noise.shape[1])
        audio = vits_model.decode_audio(
            self.params, self.hp, z_pre[:, :window].contiguous(), g=g,
            frame_lengths=torch.clamp(y_pre, max=window))
        return ((to_pcm16(audio) if pcm16 else audio), m_p, logs_p, w_ceil,
                x_mask, g, frames)

    def _decode_chunk(self, z: torch.Tensor, start, offset, y_len,
                      g: Optional[torch.Tensor], window: int, chunk: int,
                      pcm16: bool = False) -> torch.Tensor:
        """Decode the latent window ``z[:, start:start + window]`` and keep
        its frames ``[offset, offset + chunk)``, as audio samples.

        ``start``, ``offset`` and ``y_len`` (the utterance's frame count)
        are ints or 0-d integer tensors; on the card they are inputs of
        the graph, so one graph serves every window of a latent buffer:
        the window and the kept span are gathered by index on the device
        (the JAX program's ``dynamic_slice_in_dim``).

        With at least the decoder's receptive field of context on each
        side of the kept span (or the utterance's true edge), the kept
        audio equals the monolithic decode there. The window lies inside
        the latent buffer; frames past the utterance are masked by the
        decoder's ``frame_lengths`` contract.
        """
        up = self.hp.total_upsample
        dev = z.device
        start = torch.as_tensor(start, device=dev)
        zc = torch.index_select(z, 1, start + torch.arange(window,
                                                           device=dev))
        valid = torch.clamp(torch.as_tensor(y_len, device=dev) - start, 0,
                            window).to(torch.int32).expand(z.shape[0])
        audio = vits_model.decode_audio(self.params, self.hp, zc, g=g,
                                        frame_lengths=valid.contiguous())
        keep = (torch.as_tensor(offset, device=dev) * up
                + torch.arange(chunk * up, device=dev))
        audio = torch.index_select(audio, 1, keep)
        return to_pcm16(audio) if pcm16 else audio

    def _vc(self, spec, lengths, sid_src, sid_tgt, noise,
            pcm16: bool = False) -> torch.Tensor:
        audio, _ = vits_model.voice_conversion(
            self.params, self.hp, spec, lengths, sid_src, sid_tgt,
            noise=noise)
        return to_pcm16(audio) if pcm16 else audio

    # -- dispatch ----------------------------------------------------------

    def _run(self, key: tuple, fn, *args):
        """``fn(*args)``: directly on the CPU (in the engine's precision
        scope), through the key's CUDA graph on the card (fresh outputs
        either way; the graph's capture is in the scope)."""
        if self.graphs is None:
            with _prec_scope(self.matmul_precision):
                return fn(*args)
        return self.graphs.run(key, fn, args)

    def _fetch(self, *tensors) -> List[np.ndarray]:
        """Tensors -> numpy, every device copy started before one wait."""
        return [self._ready(c) for c in [self._copy_out(t) for t in tensors]]

    @staticmethod
    def _copy_out(t: torch.Tensor):
        """Start the copy of ``t`` to the host: (host tensor, the event
        that marks it done, or None on the CPU)."""
        if not t.is_cuda:
            return t, None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(t.device))
        return host, done

    @staticmethod
    def _ready(copy) -> np.ndarray:
        host, done = copy
        if done is not None:
            done.synchronize()
        # bf16 audio crosses in bf16 and becomes float32 here (exactly)
        return (host.float() if host.dtype == torch.bfloat16
                else host).numpy()

    def _scales(self, noise_scale, length_scale, noise_w) -> torch.Tensor:
        """The programs' ``scales`` input, in the engine's dtype: inputs of
        the graph, never baked into it."""
        return torch.tensor([noise_scale, length_scale, noise_w],
                            dtype=self.dtype)

    def _batch_inputs(self, batch_ids, speaker_ids, seed: int):
        """Inputs of a batch padded to its text bucket: on the host, ids
        int64 [B, t_bucket], lengths int32 [B] and sid int64 [B]; dp_noise
        [B, t_bucket, 2] drawn on the engine's device (rows past each
        utterance 0); and the utterances' seeds, ``range(seed, seed +
        B)``."""
        batch = len(batch_ids)
        t_bucket = _bucket_for(max(len(u) for u in batch_ids),
                               self.text_buckets)
        ids = torch.zeros((batch, t_bucket), dtype=torch.int64)
        lengths = torch.zeros((batch,), dtype=torch.int32)
        for i, utt in enumerate(batch_ids):
            ids[i, :len(utt)] = torch.as_tensor(list(utt), dtype=torch.int64)
            lengths[i] = len(utt)
        sid = torch.zeros((batch,), dtype=torch.int64)
        if speaker_ids is not None:
            sid[:] = torch.as_tensor(list(speaker_ids), dtype=torch.int64)
        seeds = range(seed, seed + batch)
        dp_noise = noise.normal(seed, batch, t_bucket, 2, noise.DURATION,
                                self.device, lengths, self.dtype)
        return ids, lengths, sid, dp_noise, seeds

    def _prior(self, seeds: range, frames, rows: int) -> torch.Tensor:
        """[B, rows, C] prior noise on the engine's device for the
        utterances of ``seeds`` (consecutive): utterance i's first
        min(frames[i], rows) rows, the rest 0 (masked). ``frames``: None
        (every row), the int32 frame counts on the device (phase 1's), or
        ints."""
        return noise.normal(seeds.start, len(seeds), rows,
                            self.hp.inter_channels, noise.PRIOR, self.device,
                            frames, self.dtype)

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

    def _frame_bucket_clamped(self, frames: int) -> int:
        """Frame bucket for a predicted length; clamps to the largest
        bucket with a truncation warning instead of raising:
        length_scale is request controlled, so an over-long prediction
        must degrade, not fail."""
        if frames > self.frame_buckets[-1]:
            LOG.warning(
                "predicted %d frames exceed the largest frame bucket %d "
                "— audio will be truncated", frames, self.frame_buckets[-1])
            return self.frame_buckets[-1]
        return _bucket_for(max(frames, 1), self.frame_buckets)

    def _fused_bucket(self, t_bucket: int) -> int:
        """Fused mode's frame budget: from the text *bucket*, so each
        (batch, text bucket) pair has one program."""
        budget = t_bucket * self.frames_per_token
        return _bucket_for(min(budget, self.frame_buckets[-1]),
                           self.frame_buckets)

    # -- public API --------------------------------------------------------

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
        """Batched synthesis padded to the batch's buckets. ``lang_id`` is
        accepted for API parity and unused.

        Returns (waveforms [B, frame_bucket * total_upsample] float32, the
        frame count of each utterance).
        """
        batch = len(batch_ids)
        if speaker_ids is not None:
            self._check_speakers(speaker_ids)
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31 - 1 - batch))
        with observability.span("engine.inputs"):
            ids, lengths, sid, dp_noise, seeds = self._batch_inputs(
                batch_ids, speaker_ids, seed)
            scales = self._scales(noise_scale, length_scale, noise_w)
        t_bucket = ids.shape[1]

        if self.mode == "fused":
            f_bucket = self._fused_bucket(t_bucket)
            with observability.span("engine.prior"):
                prior = self._prior(seeds, None, f_bucket)
            with observability.span("engine.fused", **self._decoder_args):
                out = self._run(
                    ("fused", batch, t_bucket, f_bucket),
                    partial(self._fused, max_frames=f_bucket,
                            pcm16=self.fetch_pcm16),
                    ids, lengths, sid, scales, dp_noise, prior)
            with observability.span("engine.fetch"):
                audio, y_lengths = self._fetch(*out)
            frame_lengths = [int(n) for n in y_lengths]
            if any(n >= f_bucket for n in frame_lengths):
                LOG.warning(
                    "frame budget %d reached — audio may be truncated; "
                    "raise frames_per_token or use mode='two_phase'",
                    f_bucket)
            return _audio_np(audio), frame_lengths

        with observability.span("engine.phase1"):
            m_p, logs_p, w_ceil, x_mask, g, frames = self._run(
                ("phase1", batch, t_bucket), self._phase1, ids, lengths,
                sid, scales, dp_noise)
        # host decision: the frame bucket from the predicted durations
        with observability.span("engine.frames"):
            n_frames, = self._fetch(frames)
        f_bucket = self._frame_bucket_clamped(int(n_frames.max()))
        with observability.span("engine.prior"):
            prior = self._prior(seeds, frames, f_bucket)
        with observability.span("engine.phase2", **self._decoder_args):
            out = self._run(
                ("phase2", batch, t_bucket, f_bucket),
                partial(self._phase2, max_frames=f_bucket,
                        pcm16=self.fetch_pcm16),
                m_p, logs_p, w_ceil, x_mask, g, scales, prior)
        with observability.span("engine.fetch"):
            audio, y_lengths = self._fetch(*out)
        return _audio_np(audio), [int(n) for n in y_lengths]

    @torch.inference_mode()
    def synthesize_many(
        self,
        utterances: Sequence[Sequence[int]],
        noise_scale: float = 0.667,
        length_scale: float = 1.0,
        noise_w: float = 0.8,
        speaker_id: int = 0,
        seed: Optional[int] = None,
    ) -> List[np.ndarray]:
        """Pipelined synthesis of many utterances: each goes through the
        fused program with seed ``seed + i``, and the copy of its outputs
        to the host starts before the next utterance's inputs are made;
        the host waits only when it reads the results, in order. Device
        work, copies and the host's staging of the next utterance
        overlap."""
        self._check_speakers((speaker_id,))
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31 - 1 - len(utterances)))
        scales = self._scales(noise_scale, length_scale, noise_w)
        in_flight = []
        for i, utt in enumerate(utterances):
            ids, lengths, sid, dp_noise, seeds = self._batch_inputs(
                [utt], [speaker_id], seed + i)
            t_bucket = ids.shape[1]
            f_bucket = self._fused_bucket(t_bucket)
            prior = self._prior(seeds, None, f_bucket)
            audio, y_lengths = self._run(
                ("fused", 1, t_bucket, f_bucket),
                partial(self._fused, max_frames=f_bucket,
                        pcm16=self.fetch_pcm16),
                ids, lengths, sid, scales, dp_noise, prior)
            in_flight.append((self._copy_out(audio),
                              self._copy_out(y_lengths)))

        outputs: List[np.ndarray] = []
        up = self.hp.total_upsample
        for audio, y_lengths in in_flight:
            wav = _audio_np(self._ready(audio))[0]
            n_frames = int(self._ready(y_lengths)[0])
            if n_frames * up >= len(wav):
                LOG.warning(
                    "frame budget %d reached — audio may be truncated; "
                    "raise frames_per_token or use mode='two_phase'",
                    len(wav) // up)
            outputs.append(wav[:n_frames * up])
        return outputs

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

        The first audio takes one program (``_first_chunk``): the
        durations, the flow over a prefix of the latents (the first window
        and ``FLOW_CONTEXT`` frames of its right context) and the first
        window's decode, with no host read before it. Its prior noise is
        the first rows of the utterance's draw (``ops/noise.py``). Then
        the host reads the frame count, the latents are computed at the
        frame bucket, and one decode-chunk program decodes the remaining
        windows with ``overlap_frames`` frames of context on each side (32
        covers every preset's decoder), the copies of their audio to the
        host started together. With the same ``seed`` the concatenated
        stream equals :meth:`synthesize_ids`. The first chunk's state is
        its own (fresh tensors, as every program returns), so other
        streams may run between its chunks.
        """
        self._check_speakers((speaker_id,))
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31 - 1))
        hp = self.hp
        up = hp.total_upsample
        chunk = max(1, chunk_frames)
        overlap = max(0, overlap_frames)
        window = chunk + 2 * overlap

        ids, lengths, sid, dp_noise, seeds = self._batch_inputs(
            [phoneme_ids], [speaker_id], seed)
        t_bucket = ids.shape[1]
        scales = self._scales(noise_scale, length_scale, noise_w)
        prior_pre = self._prior(seeds, None, window + FLOW_CONTEXT)
        audio, m_p, logs_p, w_ceil, x_mask, g, frames = self._run(
            ("first_chunk", t_bucket, chunk, overlap),
            partial(self._first_chunk, window=window,
                    pcm16=self.fetch_pcm16),
            ids, lengths, sid, scales, dp_noise, prior_pre)
        wav, frames = self._fetch(audio, frames)
        wav = _audio_np(wav)[0]
        f_bucket = self._frame_bucket_clamped(int(frames[0]))
        n_frames = min(int(frames[0]), f_bucket)
        yield wav[:min(chunk, n_frames) * up]
        if n_frames <= window:
            # the first window held the whole utterance
            if n_frames > chunk:
                yield wav[chunk * up:n_frames * up]
            return

        prior = self._prior(seeds, [n_frames], f_bucket)
        z, _ = self._run(("latents", 1, t_bucket, f_bucket),
                         partial(self._latents, max_frames=f_bucket),
                         m_p, logs_p, w_ceil, x_mask, g, scales, prior)
        decode = partial(self._decode_chunk, window=window, chunk=chunk,
                         pcm16=self.fetch_pcm16)
        y_len = torch.tensor(n_frames)
        in_flight = []
        for i in range(1, math.ceil(n_frames / chunk)):
            # the window stays inside the latent buffer, so the kept span
            # has >= overlap frames of context (or the utterance's edge)
            # on each side
            start = min(max(i * chunk - overlap, 0), f_bucket - window)
            offset = i * chunk - start
            # a final chunk whose nominal span overruns the buffer keeps
            # the buffer's last `chunk` frames instead and skips, when
            # emitted, what earlier chunks already gave
            skip = 0
            if offset > window - chunk:
                offset = window - chunk
                skip = (i * chunk - (start + offset)) * up
            audio = self._run(("decode_chunk", 1, f_bucket, chunk, overlap),
                              decode, z, torch.tensor(start),
                              torch.tensor(offset), y_len, g)
            in_flight.append((self._copy_out(audio), skip))
        emitted = chunk * up
        total = n_frames * up
        for copy, skip in in_flight:
            wav = _audio_np(self._ready(copy))[0]
            take = min(len(wav) - skip, total - emitted)
            if take <= 0:
                break
            emitted += take
            yield wav[skip:skip + take]

    @torch.inference_mode()
    def voice_conversion(
        self,
        audio: np.ndarray,
        sid_src: int,
        sid_tgt: int,
        seed: Optional[int] = None,
    ) -> np.ndarray:
        """Convert an utterance between speakers (models.py:724-732).

        audio: float32 waveform [N] at the model sample rate. Requires a
        multi-speaker voice. The spectrogram is computed on the engine's
        device, before the program as the JAX engine does, with the STFT
        geometry of the model itself (the posterior encoder takes
        filter_length // 2 + 1 bins at one frame per decoder upsample
        period), and padded to its frame bucket. Returns the converted
        waveform trimmed to the true length.
        """
        if self.hp.n_speakers <= 1:
            raise ValueError("voice conversion requires a multi-speaker "
                             "model")
        self._check_speakers((sid_src, sid_tgt))
        hp = self.hp
        n_fft = (hp.spec_channels - 1) * 2
        hop = hp.total_upsample
        wav = torch.as_tensor(np.asarray(audio, np.float32))[None, :]
        with _prec_scope(self.matmul_precision):
            spec = spectrogram(wav.to(self.device), n_fft, hop,
                               n_fft)  # [1, T, C]
        n_frames = spec.shape[1]
        f_bucket = _bucket_for(n_frames, self.frame_buckets)
        spec = torch.nn.functional.pad(
            spec, (0, 0, 0, f_bucket - n_frames)).to(self.dtype)
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31 - 1))
        prior = self._prior(range(seed, seed + 1), [n_frames], f_bucket)
        out, = self._fetch(self._run(
            ("vc", 1, f_bucket), partial(self._vc, pcm16=self.fetch_pcm16),
            spec, torch.tensor([n_frames], dtype=torch.int32),
            torch.tensor([sid_src]), torch.tensor([sid_tgt]), prior))
        return _audio_np(out)[0, :n_frames * hop]

    def warmup(self, batch_sizes: Sequence[int] = (1,),
               text_buckets: Optional[Sequence[int]] = None) -> None:
        """Run (and on the card, capture) the programs of the given grid:
        one request of full-length rows per (batch size, text bucket)."""
        for batch in batch_sizes:
            for t_bucket in (text_buckets or self.text_buckets[:3]):
                # full-length rows: shorter ids re-bucket to the
                # smallest bucket and nothing else gets captured
                self.synthesize_batch([[1] * t_bucket] * batch, seed=0)
