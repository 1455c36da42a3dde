"""Dataset loading + bucketed batching for VITS training.

Reads the same ``dataset.jsonl`` contract as the reference
(phoonnx_train/vits/dataset.py:47-134: phoneme_ids, audio_norm_path,
audio_spec_path, optional speaker_id/text). Cached tensors may be ``.npy``
(this pipeline) or torch ``.pt`` (reference caches — loaded via torch when
available).

Batching is TPU-aware: instead of padding to the per-batch max (a new XLA
program per batch), utterances are sorted by spectrogram length and padded
to a small grid of static bucket shapes, so the training step compiles a
handful of times per run.
"""

import json
import logging
import random
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

LOG = logging.getLogger(__name__)


@dataclass
class Utterance:
    phoneme_ids: List[int]
    audio_norm_path: Path
    audio_spec_path: Path
    speaker_id: Optional[int] = None
    text: Optional[str] = None


def load_utterance(line: str) -> Utterance:
    utt = json.loads(line)
    if not utt.get("phoneme_ids"):
        raise ValueError(f"invalid utterance line - phoneme_ids not set")
    return Utterance(
        phoneme_ids=utt["phoneme_ids"],
        audio_norm_path=Path(utt["audio_norm_path"]),
        audio_spec_path=Path(utt["audio_spec_path"]),
        speaker_id=utt.get("speaker_id"),
        text=utt.get("text"),
    )


def load_dataset(
    dataset_paths: Sequence[Union[str, Path]],
    max_phoneme_ids: Optional[int] = None,
) -> List[Utterance]:
    utterances: List[Utterance] = []
    skipped = 0
    for path in dataset_paths:
        with open(path, "r", encoding="utf-8") as f:
            for line_idx, line in enumerate(f):
                line = line.strip()
                if not line:
                    continue
                try:
                    utt = load_utterance(line)
                except Exception:
                    LOG.exception("Error on line %s of %s", line_idx + 1, path)
                    continue
                if max_phoneme_ids is not None and \
                        len(utt.phoneme_ids) > max_phoneme_ids:
                    skipped += 1
                    continue
                utterances.append(utt)
    if skipped:
        LOG.warning("Skipped %s utterance(s)", skipped)
    if not utterances:
        raise ValueError("No utterances loaded")
    return utterances


def _load_array(path: Path) -> np.ndarray:
    """Load a cached tensor: .npy native or .pt (reference caches)."""
    suffix = path.suffix
    if suffix == ".npy":
        return np.load(path)
    # reference caches are torch-saved tensors
    import torch

    tensor = torch.load(path, map_location="cpu", weights_only=True)
    return tensor.numpy()


def _round_up(value: int, multiple: int) -> int:
    return ((value + multiple - 1) // multiple) * multiple


class BucketedLoader:
    """Shuffled, length-bucketed batch iterator.

    Yields dict batches matching phoonnx_tpu_torch.train.step.train_step:
    phoneme_ids [B, T_x] i32, phoneme_lengths, spec [B, T_y, C] f32,
    spec_lengths, audio [B, N] f32 (N = T_y*hop, >= segment samples),
    optional sid.
    """

    def __init__(
        self,
        utterances: Sequence[Utterance],
        batch_size: int,
        segment_size_frames: int,
        hop_length: int,
        is_multispeaker: bool = False,
        phoneme_pad_multiple: int = 32,
        spec_pad_multiple: int = 64,
        seed: int = 1234,
        drop_last: bool = False,
        spec_channels: Optional[int] = None,
    ):
        self.utterances = list(utterances)
        self.batch_size = batch_size
        self.segment_frames = segment_size_frames
        self.hop = hop_length
        self.is_multispeaker = is_multispeaker
        self.phoneme_pad = phoneme_pad_multiple
        self.spec_pad = spec_pad_multiple
        self.seed = seed
        self.rng = random.Random(seed)
        self.drop_last = drop_last
        self.spec_channels = spec_channels

    def __len__(self) -> int:
        if self.drop_last:
            return len(self.utterances) // self.batch_size
        return (len(self.utterances) + self.batch_size - 1) // self.batch_size

    def epoch(self, prefetch: int = 0,
              epoch_index: Optional[int] = None
              ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield collated batches; ``prefetch`` > 0 runs the np.load +
        collate work in a background thread (bounded queue) so host IO
        overlaps the device step that JAX dispatched asynchronously.

        ``epoch_index`` derives the shuffle from (seed, epoch) instead of
        the loader's stateful rng, making batch order a pure function of
        the epoch number — required for checkpoint-resume
        bit-equivalence: a run restored at epoch N sees exactly the
        batches the uninterrupted run would have (Lightning's
        seed_everything + epoch-seeded sampler semantics).
        """
        order = list(range(len(self.utterances)))
        if epoch_index is None:
            self.rng.shuffle(order)
        else:
            random.Random(self.seed * 1_000_003 + epoch_index).shuffle(order)
        # sort within shuffled windows so batches have similar lengths
        window = self.batch_size * 16
        for start in range(0, len(order), window):
            chunk = order[start:start + window]
            chunk.sort(key=lambda i: len(self.utterances[i].phoneme_ids))
            order[start:start + window] = chunk

        def batches() -> Iterator[Dict[str, np.ndarray]]:
            for start in range(0, len(order), self.batch_size):
                indices = order[start:start + self.batch_size]
                if len(indices) < self.batch_size:
                    if self.drop_last:
                        continue
                    # repeat entries so batch shape stays static
                    indices = (indices * self.batch_size)[: self.batch_size]
                yield self.collate([self.utterances[i] for i in indices])

        if prefetch <= 0:
            yield from batches()
            return

        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        sentinel = object()
        abandoned = threading.Event()

        def _put(item) -> bool:
            # bounded put that notices an abandoned consumer — otherwise
            # the producer would sleep on a full queue forever (pinning a
            # collated batch) when the training loop raises mid-epoch
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer() -> None:
            try:
                for batch in batches():
                    if not _put(batch):
                        return
                _put(sentinel)
            except BaseException as exc:  # surface in the consumer
                _put(exc)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
            thread.join()
        finally:
            abandoned.set()

    def _orient_spec(self, spec: np.ndarray) -> np.ndarray:
        """Return the spectrogram as [T, C].

        Native caches are stored channel-last [T, F] (train/audio.py:168);
        reference ``.spec.pt`` caches are channel-first [F, T]
        (norm_audio/__init__.py:82-89). Orientation is decided against the
        known channel count — a min/max-shape heuristic would flip any
        native clip shorter than F frames (~6 s at 22.05 kHz / hop 256).
        """
        channels = self.spec_channels
        if channels is not None:
            if spec.shape[1] == channels:
                return spec
            if spec.shape[0] == channels:
                return spec.T
            raise ValueError(
                f"spectrogram cache shape {spec.shape} matches neither "
                f"[T, {channels}] nor [{channels}, T]"
            )
        # channel count unknown: FFT bins are 2^k + 1 (513, 257, ...)
        def _pow2p1(n: int) -> bool:
            return n >= 3 and (n - 1) & (n - 2) == 0

        if _pow2p1(spec.shape[0]) and not _pow2p1(spec.shape[1]):
            return spec.T
        return spec

    def collate(self, batch: Sequence[Utterance]) -> Dict[str, np.ndarray]:
        n = len(batch)
        specs = []
        audios = []
        for utt in batch:
            spec = _load_array(utt.audio_spec_path)
            if spec.ndim == 2:
                spec = self._orient_spec(spec)
            audio = _load_array(utt.audio_norm_path).reshape(-1)
            specs.append(spec.astype(np.float32))
            audios.append(audio.astype(np.float32))

        max_phonemes = _round_up(
            max(len(u.phoneme_ids) for u in batch), self.phoneme_pad
        )
        max_spec = _round_up(
            max(max(s.shape[0] for s in specs), self.segment_frames),
            self.spec_pad,
        )
        n_mels = specs[0].shape[1]
        max_audio = max_spec * self.hop

        phoneme_ids = np.zeros((n, max_phonemes), np.int32)
        phoneme_lengths = np.zeros((n,), np.int32)
        spec = np.zeros((n, max_spec, n_mels), np.float32)
        spec_lengths = np.zeros((n,), np.int32)
        audio = np.zeros((n, max_audio), np.float32)
        sid = np.zeros((n,), np.int32)

        for i, utt in enumerate(batch):
            ids = utt.phoneme_ids
            phoneme_ids[i, : len(ids)] = ids
            phoneme_lengths[i] = len(ids)
            s = specs[i][:max_spec]
            spec[i, : s.shape[0]] = s
            spec_lengths[i] = s.shape[0]
            a = audios[i][:max_audio]
            audio[i, : len(a)] = a
            if utt.speaker_id is not None:
                sid[i] = utt.speaker_id

        out = {
            "phoneme_ids": phoneme_ids,
            "phoneme_lengths": phoneme_lengths,
            "spec": spec,
            "spec_lengths": spec_lengths,
            "audio": audio,
        }
        if self.is_multispeaker:
            out["sid"] = sid
        return out


