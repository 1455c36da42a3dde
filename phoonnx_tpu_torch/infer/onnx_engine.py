"""Fallback engine: run a foreign ONNX voice graph on the device.

PyTorch port of ``phoonnx_tpu/infer/onnx_engine.py``. The fast path
(:class:`~phoonnx_tpu_torch.infer.engine.VitsEngine`) imports weights by
name into the VITS parameter tree; that covers voices exported by this
framework, piper, and the reference trainer. Voices whose graphs are NOT
that layout (coqui-VITS exports, mimic3 models, anything else the
reference would hand to onnxruntime, reference voice.py:167) run their
own ONNX graph here, op by op on the device
(:class:`~phoonnx_tpu_torch.onnx.torch_lowering.TorchGraphRunner`).

Feed contract matches the reference call (voice.py:350-377): ``input``
[1, T] int64, ``input_lengths`` [1] int64, ``scales`` [3] float32
(noise, length, noise_w), plus ``sid``/``langid`` [1] int64 when the
graph declares them.

Phoneme ids are padded to the JAX engine's length buckets
(:func:`_bucket_len`) where it pads them: on the runner, when the graph
declares ``input_lengths`` (masked semantics). In PyTorch the padding
buys no compiled-program reuse; it is kept because a graph's noise draws
take their shapes from the padded input, so a seeded request draws the
noise the JAX engine draws and gives its audio.

Deliberate differences from the JAX engine:

* **No silent degrade.** The JAX engine switches to the numpy interpreter
  for good when its runner fails. This one raises, on every device.
* **No environment variable.** ``PHOONNX_ONNX_FALLBACK_COMPILE`` is not
  ported: it would move a voice asked for on the card onto the host.
  ``compile=False`` (the numpy interpreter) is the caller's explicit
  choice, and only with ``device="cpu"``.
* **Eager execution.** There are no plan or segment statistics
  (``plan_stats``, ``has_plan``), and a seeded call needs no discarded
  planning pass. ``runner.last_run`` gives the latest run's placement.
* **``warmup`` runs one request** on the runner (the device libraries'
  handles and algorithm choices); the JAX engine's does nothing.
"""

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from phoonnx_tpu_torch.infer.engine import resolve_device
from phoonnx_tpu_torch.onnx.executor import OnnxExecutor
from phoonnx_tpu_torch.onnx.reader import OnnxModel
from phoonnx_tpu_torch.onnx.torch_lowering import TorchGraphRunner

# phoneme-length buckets: fine-grained at short sentence lengths,
# multiples of 128 beyond (same spirit as the native engine's buckets)
_ID_BUCKETS = (16, 32, 48, 64, 96, 128, 192, 256, 384, 512)


def _bucket_len(n: int) -> int:
    for b in _ID_BUCKETS:
        if n <= b:
            return b
    return -(-n // 128) * 128


class _HpShim:
    """Minimal hparams surface TTSVoice uses (lengths are in samples)."""

    total_upsample = 1

    def __init__(self, sample_rate: int):
        self.sample_rate = sample_rate


class OnnxFallbackEngine:
    """Architecture-agnostic voice execution: the voice's ONNX graph, op
    by op on a torch device."""

    # synthesize_batch runs rows SEQUENTIALLY (one graph execution per
    # row): lane-count padding would synthesize real extra utterances,
    # so the serving batcher must not pad
    compiled_batching = False

    def __init__(self, model: OnnxModel, sample_rate: int,
                 compile: bool = True, pad_id: int = 0, device=None):
        """device: None means the GPU (raises without one); ``"cpu"``
        runs the graph on the host's torch. compile: run the graph through
        :class:`TorchGraphRunner` on ``device``; ``False`` runs the numpy
        interpreter instead, which is accepted only with ``device="cpu"``.
        """
        self.device = resolve_device(device)
        if not compile and self.device.type != "cpu":
            raise ValueError(
                "compile=False runs the numpy interpreter on the host; it "
                f"is accepted only with device='cpu', not {self.device}")
        self.executor = OnnxExecutor(model)
        self.input_names = set(model.inputs)
        self.output_name = model.outputs[0] if model.outputs else None
        self.hp = _HpShim(sample_rate)
        self.pad_id = pad_id
        self.runner = (TorchGraphRunner(model, device=self.device)
                       if compile else None)
        # padding ids is only sound when the graph masks by lengths
        self._bucket = "input_lengths" in self.input_names
        # a seeded call reseeds the RNG its draws then consume: one call
        # at a time
        self._lock = threading.Lock()

    def _reseed(self, seed: int) -> None:
        """Reseed the Random*-node RNG on every execution path: the
        graph-internal noise then repeats for a repeated seed (the
        reference's onnxruntime path cannot do this)."""
        self.executor.reseed(seed)
        if self.runner is not None:
            self.runner.executor.reseed(seed)

    def _run_one(self, ids: Sequence[int], noise_scale: float,
                 length_scale: float, noise_w: float,
                 speaker_id: int, lang_id: Optional[int],
                 seed: Optional[int] = None) -> np.ndarray:
        ids = list(ids)
        true_len = len(ids)
        padded = ids
        if self.runner is not None and self._bucket:
            padded = ids + [self.pad_id] * (_bucket_len(true_len) - true_len)
        feeds = {
            "input": np.asarray([padded], np.int64),
            "input_lengths": np.asarray([true_len], np.int64),
            "scales": np.asarray([noise_scale, length_scale, noise_w],
                                 np.float32),
            "sid": np.asarray([speaker_id], np.int64),
            "langid": np.asarray([lang_id or 0], np.int64),
        }
        # the reference filters feeds to the graph's declared inputs
        # (voice.py:369-372); unknown extras would be rejected
        feeds = {k: v for k, v in feeds.items() if k in self.input_names}
        missing = self.input_names - feeds.keys()
        if missing:
            # fail loudly: unfed inputs would surface as an opaque error
            # deep in an op handler, or as silent zeros for ops that
            # treat None as optional (LSTM/GRU initial state)
            raise ValueError(
                f"graph requires inputs {sorted(missing)} that this "
                "engine does not provide (expected a piper/phoonnx-style "
                "input/input_lengths/scales[/sid/langid] signature)"
            )
        if self.output_name is None:
            raise ValueError("the voice's ONNX graph declares no outputs: "
                             "there is no audio to synthesize")
        run = (self.runner.run if self.runner is not None
               else self.executor.run)
        with self._lock:
            if seed is not None:
                self._reseed(int(seed))
            audio = run(feeds, outputs=[self.output_name])[0]
        return np.asarray(audio, np.float32).reshape(-1)  # [1, 1, T] -> [T]

    # -- VitsEngine-compatible surface --------------------------------

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
        return self._run_one(phoneme_ids, noise_scale, length_scale,
                             noise_w, speaker_id, lang_id, seed=seed)

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
        """Sequential execution; returns (padded [B, L], sample lengths).

        ``total_upsample`` is 1 for this engine, so the returned lengths
        are already sample counts (TTSVoice multiplies by upsample).
        """
        wavs = []
        for i, ids in enumerate(batch_ids):
            # per-item seed fold keeps item i's audio independent of how
            # many items precede it in the batch
            item_seed = None if seed is None else int(seed) + i
            sid = speaker_ids[i] if speaker_ids is not None else 0
            wavs.append(self._run_one(ids, noise_scale, length_scale,
                                      noise_w, sid, lang_id,
                                      seed=item_seed))
        lengths = [len(w) for w in wavs]
        out = np.zeros((len(wavs), max(lengths) if lengths else 0),
                       np.float32)
        for i, w in enumerate(wavs):
            out[i, : len(w)] = w
        return out, lengths

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
    ):
        """Yield the utterance in fixed-size sample chunks.

        The graph is a foreign black box, so its decoder cannot be
        windowed as the native engine's is: the utterance is synthesized
        whole and emitted in ``chunk_frames``-equivalent chunks. A frame
        here is the native contract's duration (hop 256 at 22.05 kHz,
        about 11.6 ms) at this voice's sample rate, so chunk pacing is
        time-consistent across voices. Across sentences the caller
        (``TTSVoice.synthesize_streaming``) still pipelines.
        ``overlap_frames`` is accepted for signature parity and unused:
        chunks are exact slices, so the concatenated stream equals
        :meth:`synthesize_ids` bit for bit.
        """
        del overlap_frames
        audio = self._run_one(phoneme_ids, noise_scale, length_scale,
                              noise_w, speaker_id, lang_id, seed=seed)
        samples_per_frame = max(1, round(self.hp.sample_rate * 256 / 22050))
        step = max(1, int(chunk_frames)) * samples_per_frame
        for off in range(0, len(audio), step):
            yield audio[off:off + step]

    def warmup(self, *args, **kwargs) -> None:
        """One seeded request of the smallest id bucket on the runner:
        the device libraries' first-call costs are paid before traffic.
        ``args`` (the native engine's batch sizes and buckets) are
        accepted and unused: rows run one at a time."""
        if self.runner is not None:
            self.synthesize_ids([self.pad_id + 1] * _ID_BUCKETS[0], seed=0)
