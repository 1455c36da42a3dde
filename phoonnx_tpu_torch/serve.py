"""Production TTS serving: dynamic batching over the engine's CUDA graphs.

PyTorch port of ``phoonnx_tpu/serve.py``. The reference has no serving
layer (phoonnx is a library; one onnxruntime call per sentence). On the
GPU, serving throughput comes from batching: one ``synthesize_batch`` of
16 lanes replays the same graphs as one of a single lane, so the server's
job is to coalesce concurrent requests into full device batches without
adding latency for the single-stream case.

Design:

* request handler threads do the host-side work (normalize -> phonemize
  -> ids) in parallel, then submit to the :class:`DynamicBatcher`;
* one dispatcher thread drains the queue: it waits at most
  ``max_wait_ms`` for the batch to fill to ``max_batch`` utterances,
  groups submissions by synthesis scales (a batch shares one set of
  scale scalars; speaker ids vary per row), and runs ONE
  ``engine.synthesize_batch`` per group, except explicitly seeded
  requests, which run solo so their audio is reproducible regardless of
  what they would have batched with;
* responses: WAV bytes, or chunked raw PCM16 (``"stream": true``) fed
  by the engine's chunked-decode path for sub-utterance latency.

Everything is stdlib (http.server / threading / queue), no framework.

Where this differs from ``phoonnx_tpu/serve.py``, and why:

* **Seeded groups keep their order.** The JAX batcher length-sorts every
  group before chunking it (``ADVICE.md:5``). This engine draws lane i's
  noise from ``seed + i``, so sorting a seeded request's sentences would
  give each sentence another sentence's noise, and its audio would
  depend on its sentence lengths. A seeded submission is dispatched in
  its own order, and one longer than ``max_batch`` continues its seed
  from chunk to chunk, so it equals the engine's batch of all its
  sentences; unseeded groups are still length-sorted, as in JAX.
* **The timeout message** speaks of this engine's cold cost: the first
  call at a new (program, batch, buckets) key runs eagerly and then
  captures a CUDA graph (``infer/graphs.py``). There are no XLA compiles.
* **The CLI flags.** ``--no-compile-cache`` is gone (no XLA programs;
  graphs are captured per process, the nvcc builds persist in
  ``build/``); ``--bf16`` serves in bfloat16, as the JAX server does;
  ``--precision`` other than ``default`` raises the engine's error;
  ``--device`` (default ``cuda``)
  is added, as in the port's other CLIs, and ``--device cpu`` serves the
  plain PyTorch path.
* **The listen backlog** is 1024 connections, not socketserver's 5:
  with 5, dozens of clients connecting at once had connections reset
  (64 client threads, ``chip_smoke.py``'s load).
* **Devices** are ``torch.device`` values: ``devices`` (an int, ``"all"``
  or a list) names CUDA devices counted by ``torch.cuda.device_count()``,
  and each replica is a :meth:`VitsEngine.replicate` engine with its own
  parameters, graphs, lock and stream. A voice whose engine cannot
  replicate (the ONNX graph engine of a foreign voice) is served on its
  one device with a warning, as the JAX server does; its text has no
  bucket limit.
"""

import collections
import io
import itertools
import json
import logging
import math
import queue
import threading
import time
import wave
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from phoonnx_tpu_torch import observability
from phoonnx_tpu_torch.config import SynthesisConfig

LOG = logging.getLogger(__name__)


@dataclass
class _Submission:
    """One utterance's sentences, awaiting a batch slot."""
    sentence_ids: List[List[int]]
    scales: Tuple[float, float, float]  # (noise, length, noise_w)
    speaker_id: int
    seed: Optional[int]
    request_id: int = 0
    # the start of its batcher.queue span (observability.stamp)
    queued: Optional[tuple] = None
    event: threading.Event = field(default_factory=threading.Event)
    audio: Optional[np.ndarray] = None
    error: Optional[Exception] = None

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self.event.wait(timeout):
            raise TimeoutError(
                "synthesis timed out — if the server just started this is "
                "usually the dispatcher's first call at a new (program, "
                "batch, buckets) key, which runs the program eagerly and "
                "then captures its CUDA graph (43-80 ms a key on an H100); "
                "start with --warmup or raise --request-timeout")
        if self.error is not None:
            raise self.error
        return self.audio


# DynamicBatcher.stats: submissions, groups (one _synthesize_group each),
# dispatches (engine calls; a group of more lanes than max_batch makes
# several), their real and pad lanes, the frames of the real lanes, the
# frames decoded (lanes x the frame bucket, pad lanes included) and the
# output samples decoded (the dispatches' audio, pad included), and the
# graphs its engine has captured (``Graphs.captures``). ``batches``, the
# JAX package's name for ``groups``, is reported beside it.
COUNTERS = ("requests", "groups", "dispatches", "lanes", "pad_lanes",
            "frames_real", "frames_decoded", "samples_decoded",
            "graph_captures")


class DynamicBatcher:
    """Coalesce concurrent synthesis submissions into device batches."""

    def __init__(self, engine, max_batch: int = 16,
                 max_wait_ms: float = 10.0, autostart: bool = True):
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self._queue: "queue.Queue[_Submission]" = queue.Queue()
        self._stop = threading.Event()
        self._stats = dict.fromkeys(COUNTERS, 0)
        self._stats["max_batch_seen"] = 0
        self._request_ids = itertools.count()
        self._group_ids = itertools.count()
        # '+=' on a dict entry is a non-atomic read-modify-write; submit()
        # runs on every HTTP handler thread concurrently
        self._stats_lock = threading.Lock()
        self._thread = None
        if autostart:
            self.start()

    @property
    def stats(self) -> Dict[str, Any]:
        """A copy of the counters (``COUNTERS``, ``max_batch_seen``,
        ``batches``)."""
        with self._stats_lock:
            stats = dict(self._stats)
        graphs = getattr(self.engine, "graphs", None)
        stats["graph_captures"] = graphs.captures if graphs else 0
        stats["batches"] = stats["groups"]
        return stats

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="phoonnx-batcher")
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        # release any handler threads still parked on queued submissions
        # (they would otherwise sleep out their full wait timeout)
        while True:
            try:
                sub = self._queue.get_nowait()
            except queue.Empty:
                break
            if not sub.event.is_set():
                sub.error = RuntimeError("server shutting down")
                sub.event.set()

    def submit(self, sentence_ids: List[List[int]],
               scales: Tuple[float, float, float],
               speaker_id: int = 0,
               seed: Optional[int] = None) -> _Submission:
        sub = _Submission(sentence_ids, scales, speaker_id, seed,
                          request_id=next(self._request_ids))
        if self._stop.is_set():
            # racing stop(): fail fast instead of enqueueing into a
            # drained queue where no dispatcher will ever set the event
            # (the handler would sleep out its full request timeout)
            sub.error = RuntimeError("server shutting down")
            sub.event.set()
            return sub
        with self._stats_lock:
            self._stats["requests"] += 1
        sub.queued = observability.stamp()
        self._queue.put(sub)
        return sub

    # -- dispatcher --------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            self._drain_once(first)

    def _drain_once(self, first: Optional[_Submission] = None) -> None:
        """Collect one batch (waiting up to max_wait) and synthesize it."""
        subs: List[_Submission] = []
        if first is None:
            try:
                first = self._queue.get_nowait()
            except queue.Empty:
                return
        subs.append(first)
        # fill up to max_batch sentences (sentences are what occupy
        # device batch lanes), waiting at most max_wait for stragglers
        lanes = len(first.sentence_ids)
        t_end = time.monotonic() + self.max_wait
        while lanes < self.max_batch:
            wait_left = t_end - time.monotonic()
            try:
                sub = (self._queue.get(timeout=wait_left)
                       if wait_left > 0 else self._queue.get_nowait())
            except queue.Empty:
                break
            subs.append(sub)
            lanes += len(sub.sentence_ids)
        # Opportunistic over-drain: when the queue is backlogged past
        # max_batch, pull what is ALREADY waiting (no extra waiting)
        # into this group, up to 4x max_batch lanes. The group is
        # chunked at max_batch per device dispatch either way; draining
        # a deeper backlog at once lets the length-sorted chunking in
        # _synthesize_group put short sentences in chunks that decode
        # at a smaller bucket, instead of bucket composition being an
        # accident of FIFO arrival order.
        while lanes < 4 * self.max_batch:
            try:
                sub = self._queue.get_nowait()
            except queue.Empty:
                break
            subs.append(sub)
            lanes += len(sub.sentence_ids)

        # group by scale scalars: one set of scale inputs each.
        # Explicitly-seeded submissions synthesize SOLO: lane i's noise
        # comes from seed + i, so a seeded request's audio would otherwise
        # depend on which requests it happened to batch with.
        groups: Dict[Any, List[_Submission]] = {}
        for sub in subs:
            if sub.seed is not None:
                self._synthesize_group([sub], sub.scales, sub.seed)
            else:
                groups.setdefault(sub.scales, []).append(sub)
        for scales, group in groups.items():
            self._synthesize_group(group, scales, None)

    def _synthesize_group(self, group: List[_Submission],
                          scales: Tuple[float, float, float],
                          seed: Optional[int]) -> None:
        group_id = next(self._group_ids)
        for sub in group:
            if sub.queued is not None:
                observability.record("batcher.queue", sub.queued,
                                     request_id=sub.request_id,
                                     group_id=group_id)
        flat_ids: List[List[int]] = []
        speaker_ids: List[int] = []
        for sub in group:
            flat_ids.extend(sub.sentence_ids)
            speaker_ids.extend([sub.speaker_id] * len(sub.sentence_ids))
        with observability.span("batcher.group", group_id=group_id,
                                requests=len(group), lanes=len(flat_ids)):
            try:
                if not flat_ids:
                    for sub in group:
                        sub.audio = np.zeros(0, np.float32)
                        sub.event.set()
                    return
                lanes = len(flat_ids)
                # Length-sorted dispatch of unseeded groups: the engine pads
                # every lane to the chunk's text/frame bucket, so a chunk's
                # cost is set by its LONGEST sentence; sorting lanes by length
                # before chunking groups short sentences together, and those
                # chunks decode at a smaller bucket. A seeded group (one
                # submission) keeps its order: lane i's noise is drawn from
                # seed + i, so sorting would hand each sentence the noise of
                # another. Order is restored below via the permutation.
                order = (list(range(lanes)) if seed is not None else
                         sorted(range(lanes), key=lambda i: len(flat_ids[i])))
                sorted_ids = [flat_ids[i] for i in order]
                sorted_sids = [speaker_ids[i] for i in order]
                # a single submission can exceed max_batch on its own (one
                # request whose text splits into many sentences): cap every
                # device dispatch at max_batch lanes. Pad lanes up to a
                # power-of-two batch bucket: the lane count is part of every
                # graph key, so arbitrary counts would capture fresh graphs
                # per distinct concurrency level, all on this single
                # dispatcher thread. Engines that run rows sequentially get
                # no pad: each pad row would be a REAL extra synthesis there.
                pads = getattr(self.engine, "compiled_batching", True)
                upsample = self.engine.hp.total_upsample
                counts: Dict[str, int] = collections.Counter()
                chunks = []
                for start in range(0, lanes, self.max_batch):
                    chunk_ids = sorted_ids[start:start + self.max_batch]
                    chunk_sids = sorted_sids[start:start + self.max_batch]
                    n_chunk = len(chunk_ids)
                    target = n_chunk
                    if pads:
                        target = 1
                        while target < n_chunk:
                            target *= 2
                    pad_rows = target - n_chunk
                    with observability.span("batcher.dispatch",
                                            group_id=group_id) as dispatch:
                        audio, frame_lengths = self.engine.synthesize_batch(
                            chunk_ids + [[1]] * pad_rows,
                            noise_scale=scales[0], length_scale=scales[1],
                            noise_w=scales[2],
                            speaker_ids=chunk_sids + [0] * pad_rows,
                            # lane i of the chunk is lane start + i of the
                            # group
                            seed=None if seed is None else seed + start,
                        )
                        real = int(sum(frame_lengths[:n_chunk]))
                        # a pad lane decodes as many frames as a real one;
                        # a sequential engine decodes each row at its length
                        decoded = (target * (audio.shape[1] // upsample)
                                   if pads else real)
                        samples = (audio.shape[0] * audio.shape[1] if pads
                                   else real * upsample)
                        dispatch.set(lanes=n_chunk, pad_lanes=pad_rows,
                                     frames_real=real, frames_decoded=decoded,
                                     samples_decoded=samples)
                    chunks.append((start, n_chunk, audio, frame_lengths))
                    counts.update(lanes=n_chunk, pad_lanes=pad_rows,
                                  frames_real=real, frames_decoded=decoded,
                                  samples_decoded=samples)
                with self._stats_lock:
                    self._stats["groups"] += 1
                    self._stats["dispatches"] += len(chunks)
                    for key, n in counts.items():
                        self._stats[key] += n
                    self._stats["max_batch_seen"] = max(
                        self._stats["max_batch_seen"], min(lanes,
                                                           self.max_batch))
                with observability.span("batcher.reassemble",
                                        group_id=group_id):
                    rows_audio: List[Optional[np.ndarray]] = [None] * lanes
                    rows_frames: List[int] = [0] * lanes
                    for start, n_chunk, audio, frame_lengths in chunks:
                        for i in range(n_chunk):
                            rows_audio[order[start + i]] = audio[i]
                            rows_frames[order[start + i]] = frame_lengths[i]
                    cursor = 0
                    for sub in group:
                        pieces = []
                        for _ in sub.sentence_ids:
                            n = rows_frames[cursor] * upsample
                            pieces.append(rows_audio[cursor][:n])
                            cursor += 1
                        sub.audio = (np.concatenate(pieces) if pieces
                                     else np.zeros(0, np.float32))
                        sub.event.set()
            except Exception as exc:  # surface to the waiting handler
                LOG.exception("batch synthesis failed")
                for sub in group:
                    if not sub.event.is_set():
                        sub.error = exc
                        sub.event.set()


class BatcherPool:
    """One DynamicBatcher per device engine; fans submissions out.

    Multi-GPU serving: each engine holds its own parameter copy in its
    card's memory (``VitsEngine.replicate``) and its own graphs, lock and
    stream, so requests scale with cards: TTS voices are orders of
    magnitude smaller than a card, so replication beats sharding (no
    collectives, no cross-card latency on the hot path). Submissions go
    to the least-loaded batcher; streams round-robin.
    Exposes the same submit/stats/stop surface as DynamicBatcher.
    """

    def __init__(self, engines, max_batch: int = 16,
                 max_wait_ms: float = 10.0, autostart: bool = True):
        self.batchers = [
            DynamicBatcher(e, max_batch=max_batch, max_wait_ms=max_wait_ms,
                           autostart=autostart)
            for e in engines
        ]
        self._rr = 0
        self._lock = threading.Lock()

    @property
    def engine(self):
        return self.batchers[0].engine

    def next_engine(self):
        """Round-robin engine pick (streaming requests)."""
        with self._lock:
            engine = self.batchers[self._rr % len(self.batchers)].engine
            self._rr += 1
        return engine

    def submit(self, *args, **kwargs) -> _Submission:
        best = min(self.batchers, key=lambda b: b._queue.qsize())
        return best.submit(*args, **kwargs)

    @property
    def stats(self) -> Dict[str, Any]:
        merged: Dict[str, Any] = dict.fromkeys(COUNTERS, 0)
        merged["max_batch_seen"] = 0
        per = []
        for b in self.batchers:
            s = dict(b.stats)
            per.append(s)
            for key in COUNTERS:
                merged[key] += s[key]
            merged["max_batch_seen"] = max(merged["max_batch_seen"],
                                           s["max_batch_seen"])
        merged["batches"] = merged["groups"]
        merged["devices"] = len(self.batchers)
        merged["per_device"] = per
        return merged

    def start(self) -> None:
        for b in self.batchers:
            b.start()

    def stop(self) -> None:
        for b in self.batchers:
            b.stop()


def _resolve_devices(devices):
    """--devices value -> list of torch.device (None -> the voice's own).

    An int or ``"all"`` counts the CUDA devices; a list names devices
    (``"cuda:1"``, ``torch.device``, or ``"cpu"`` for the plain path)."""
    if devices is None:
        return None
    import torch

    if isinstance(devices, (str, int)):
        count = torch.cuda.device_count()
        n = count if devices == "all" else int(devices)
        if devices != "all" and n < 1:
            raise ValueError("devices must be >= 1")
        if not 0 < n <= count:
            raise ValueError(
                f"requested {devices} devices, only {count} CUDA "
                f"device(s) visible")
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device(d) for d in devices]


class TTSServer:
    """HTTP front-end over a loaded :class:`~phoonnx_tpu_torch.voice.TTSVoice`.

    Routes:

    * ``GET /health`` -> ``{"status": "ok", "sample_rate": N, ...}``
    * ``GET /stats`` -> batcher counters (and per-card memory)
    * ``POST /synthesize`` body ``{"text": "...", "noise_scale"?,
      "length_scale"?, "noise_w"?, "speaker_id"?, "seed"?}`` ->
      ``audio/wav`` bytes (dynamic-batched with concurrent requests)
    * ``POST /synthesize`` with ``"stream": true`` -> chunked
      ``application/octet-stream`` of raw s16le PCM (headers
      ``X-Sample-Rate``/``X-Sample-Width``/``X-Channels``), chunks
      emitted as the vocoder produces them
    * ``POST /phonemize`` body ``{"text": "..."}`` -> sentences of
      phonemes + ids (debugging / pipelines)
    """

    def __init__(self, voice, host: str = "127.0.0.1", port: int = 0,
                 max_batch: int = 16, max_wait_ms: float = 10.0,
                 request_timeout: float = 120.0, devices=None):
        """``voice``: a TTSVoice, or a dict name -> TTSVoice to serve
        several voices from one process (each gets its own batcher;
        requests pick one with ``"voice": "<name>"``).

        request_timeout: per-request wait bound in seconds. A cold start
        without ``warmup()`` captures each new key's graph on the
        dispatcher thread; raise this or warm up when first-request
        latency matters.

        devices: None (the voice's own device), an int/"all" (that many
        CUDA devices), or a list of devices: every voice's engine is
        replicated onto each device (one parameter copy and graph set
        per card) and requests fan out across them (BatcherPool)."""
        if not isinstance(voice, dict):
            voice = {"default": voice}
        if not voice:
            raise ValueError("at least one voice is required")
        self.voices = voice
        self.request_timeout = float(request_timeout)
        self.default_voice = next(iter(voice))
        devs = _resolve_devices(devices)
        self.max_batch = int(max_batch)
        self.batchers = {}
        for name, v in voice.items():
            if devs is not None and len(devs) > 1 \
                    and hasattr(v.engine, "replicate"):
                self.batchers[name] = BatcherPool(
                    v.engine.replicate(devs), max_batch=max_batch,
                    max_wait_ms=max_wait_ms)
            else:
                if devs is not None and len(devs) > 1:
                    # a foreign voice's graph engine cannot replicate:
                    # serve it on one device instead of failing the boot
                    LOG.warning(
                        "voice %r uses a non-replicable engine (%s); "
                        "serving it on one device", name,
                        type(v.engine).__name__)
                self.batchers[name] = DynamicBatcher(
                    v.engine, max_batch=max_batch,
                    max_wait_ms=max_wait_ms)
        handler = _make_handler(self)
        self.httpd = _HTTPServer((host, port), handler)
        self._thread: Optional[threading.Thread] = None
        self._serving = False  # serve_forever entered (shutdown() waits
        # on an event only serve_forever sets; calling it earlier hangs)

    # single-voice conveniences
    @property
    def voice(self):
        return self.voices[self.default_voice]

    @property
    def batcher(self) -> DynamicBatcher:
        return self.batchers[self.default_voice]

    def _select(self, body: Dict[str, Any]):
        name = str(body.get("voice", self.default_voice))
        if name not in self.voices:
            raise KeyError(
                f"unknown voice {name!r}; available: {sorted(self.voices)}"
            )
        return self.voices[name], self.batchers[name]

    @property
    def address(self) -> Tuple[str, int]:
        return self.httpd.server_address[:2]

    def start(self) -> None:
        self._serving = True
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="phoonnx-http")
        self._thread.start()

    def stop(self) -> None:
        if self._serving:
            # socketserver.shutdown() blocks on an event that only
            # serve_forever() sets on exit — calling it on a server that
            # never served would hang this thread forever
            self.httpd.shutdown()
        self.httpd.server_close()
        for batcher in self.batchers.values():
            batcher.stop()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def serve_forever(self) -> None:
        self._serving = True
        try:
            self.httpd.serve_forever()
        finally:
            for batcher in self.batchers.values():
                batcher.stop()

    def warmup(self) -> None:
        """Capture the graphs of the common bucket grid for every voice
        and device, at every power-of-two lane count the batcher can
        dispatch. Warming only batch 1 would leave the FIRST coalesced
        batch paying its captures on the dispatcher thread, the stall
        --warmup promises to prevent."""
        sizes = [1]
        while sizes[-1] < self.max_batch:
            sizes.append(sizes[-1] * 2)
        for name, batcher in self.batchers.items():
            engines = ([b.engine for b in batcher.batchers]
                       if isinstance(batcher, BatcherPool)
                       else [batcher.engine])
            for i, engine in enumerate(engines):
                LOG.info("warming up voice %r (engine %d/%d)", name,
                         i + 1, len(engines))
                engine.warmup(batch_sizes=tuple(sizes))

    # -- request-side synthesis -------------------------------------

    def _prepare(self, voice, text: str,
                 cfg: SynthesisConfig) -> List[List[int]]:
        if voice.phonetic_spellings and cfg.enable_phonetic_spellings:
            text = voice.phonetic_spellings.apply(text)
        if cfg.add_diacritics:
            text = voice.phonemizer.add_diacritics(
                text, voice.config.lang_code)
        ids = [voice.phonemes_to_ids(ph)
               for ph in voice.phonemize(text) if ph]
        ids = [i for i in ids if i]
        # validate HERE (handler thread): an oversized sentence must 400
        # its own request, not fail inside the dispatcher where the error
        # would poison every request co-batched with it
        limit = getattr(voice.engine, "text_buckets", (0,))[-1]
        for row in ids:
            if limit and len(row) > limit:
                raise ValueError(
                    f"a sentence phonemizes to {len(row)} ids, above the "
                    f"largest text bucket {limit} — split the input text"
                )
        n_speakers = voice.config.num_speakers
        if n_speakers > 1 and cfg.speaker_id is not None \
                and not 0 <= cfg.speaker_id < n_speakers:
            raise ValueError(
                f"speaker_id {cfg.speaker_id} out of range: voice has "
                f"{n_speakers} speakers (0..{n_speakers - 1})"
            )
        return ids

    @staticmethod
    def _scales(voice, body: Dict[str, Any]) -> Tuple[float, float, float]:
        cfg = voice.config
        scales = (
            float(body.get("noise_scale", cfg.noise_scale)),
            float(body.get("length_scale", cfg.length_scale)),
            float(body.get("noise_w", cfg.noise_w_scale)),
        )
        # json.loads accepts bare NaN/Infinity: NaN noise returns a 200
        # WAV of garbage and NaN length_scale raises deep inside the
        # dispatcher — reject at validation time instead (-> 400)
        if not all(math.isfinite(s) for s in scales):
            raise ValueError(
                "noise_scale/length_scale/noise_w must be finite numbers")
        if scales[1] <= 0:
            raise ValueError("length_scale must be > 0")
        return scales

    def synthesize_wav_bytes(self, body: Dict[str, Any]) -> bytes:
        voice, batcher = self._select(body)
        seed = body.get("seed")
        seed = int(seed) if seed is not None else None  # JSON floats
        cfg = SynthesisConfig(seed=seed,
                              speaker_id=int(body.get("speaker_id", 0)))
        sentence_ids = self._prepare(voice, str(body["text"]), cfg)
        sub = batcher.submit(
            sentence_ids, self._scales(voice, body),
            speaker_id=int(body.get("speaker_id", 0)),
            seed=seed,
        )
        audio = sub.wait(timeout=self.request_timeout)
        if body.get("normalize", False) and len(audio):
            peak = np.max(np.abs(audio))
            audio = audio / peak if peak > 1e-8 else audio
        volume = float(body.get("volume", 1.0))
        if volume != 1.0:
            # same knob the streaming route honors (stream_pcm_chunks
            # feeds it through SynthesisConfig.volume) — the two routes
            # must not disagree on loudness for the same request
            audio = audio * volume
        pcm = np.clip(audio * 32767.0, -32767.0, 32767.0).astype(np.int16)
        buf = io.BytesIO()
        with wave.open(buf, "wb") as w:
            w.setframerate(voice.config.sample_rate)
            w.setsampwidth(2)
            w.setnchannels(1)
            w.writeframes(pcm.tobytes())
        return buf.getvalue()

    def stream_pcm_chunks(self, body: Dict[str, Any]):
        """Yield s16le PCM chunks (engine chunked decode; sub-utterance
        latency — bypasses the batcher by design: streaming optimizes
        time-to-first-audio, batching optimizes throughput; with a
        device pool, streams round-robin across cards)."""
        voice, batcher = self._select(body)
        if body.get("normalize", False):
            # peak normalization needs the complete utterance; honoring
            # it per-chunk would change loudness mid-stream, and silently
            # ignoring it would make the two routes disagree on loudness
            # for the same request — refuse loudly (-> 400)
            raise ValueError(
                "normalize is not available on the streaming route "
                "(peak normalization needs the whole utterance); use "
                "the WAV route or the 'volume' option")
        engine = (batcher.next_engine()
                  if isinstance(batcher, BatcherPool) else None)
        seed = body.get("seed")
        seed = int(seed) if seed is not None else None
        scales = self._scales(voice, body)
        cfg = SynthesisConfig(
            seed=seed,
            speaker_id=int(body.get("speaker_id", 0)),
            noise_scale=scales[0], length_scale=scales[1],
            noise_w_scale=scales[2],
            volume=float(body.get("volume", 1.0)),
        )
        n_speakers = voice.config.num_speakers
        if n_speakers > 1 and not 0 <= cfg.speaker_id < n_speakers:
            raise ValueError(
                f"speaker_id {cfg.speaker_id} out of range: voice has "
                f"{n_speakers} speakers (0..{n_speakers - 1})"
            )
        # delegate to the voice pipeline (one source of truth for
        # spelling/diacritics/volume/clipping) rather than re-implement it
        for chunk in voice.synthesize_streaming(
            str(body["text"]), cfg,
            chunk_frames=int(body.get("chunk_frames", 128)),
            overlap_frames=int(body.get("overlap_frames", 32)),
            engine=engine,
        ):
            yield chunk.audio_int16_bytes


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # socketserver listens with a backlog of 5: dozens of clients that
    # connect at once overflow it and have their connections reset
    request_queue_size = 1024


def _make_handler(server: TTSServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route to logging, not stderr
            LOG.debug("%s - %s", self.address_string(), fmt % args)

        def _json(self, code: int, payload: Dict[str, Any]) -> None:
            data = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _read_body(self) -> Optional[Dict[str, Any]]:
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
                return body
            except (ValueError, json.JSONDecodeError) as exc:
                self._json(400, {"error": f"bad request: {exc}"})
                return None

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {
                    "status": "ok",
                    "voices": sorted(server.voices),
                    "sample_rate": server.voice.config.sample_rate,
                    "num_speakers": server.voice.config.num_speakers,
                    "lang_code": server.voice.config.lang_code,
                })
            elif self.path == "/voices":
                self._json(200, {
                    name: {
                        "sample_rate": v.config.sample_rate,
                        "num_speakers": v.config.num_speakers,
                        "lang_code": v.config.lang_code,
                        "phoneme_type": getattr(v.config.phoneme_type,
                                                "value",
                                                str(v.config.phoneme_type)),
                    } for name, v in server.voices.items()
                })
            elif self.path == "/stats":
                from phoonnx_tpu_torch.observability import (
                    device_memory_stats,
                )

                payload = ({name: dict(b.stats)
                            for name, b in server.batchers.items()}
                           if len(server.batchers) > 1
                           else dict(server.batcher.stats))
                memory = device_memory_stats()
                if memory:
                    payload["device_memory"] = memory
                self._json(200, payload)
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            body = self._read_body()
            if body is None:
                return
            if self.path == "/synthesize":
                if "text" not in body:
                    self._json(400, {"error": "missing 'text'"})
                    return
                try:
                    if body.get("stream"):
                        self._stream(body)
                    else:
                        wav = server.synthesize_wav_bytes(body)
                        self.send_response(200)
                        self.send_header("Content-Type", "audio/wav")
                        self.send_header("Content-Length", str(len(wav)))
                        self.end_headers()
                        self.wfile.write(wav)
                except KeyError as exc:  # unknown voice name
                    self._json(400, {"error": str(exc)})
                except ValueError as exc:  # bad request parameters
                    self._json(400, {"error": str(exc)})
                except TimeoutError as exc:
                    self._json(504, {"error": str(exc)})
                except Exception as exc:
                    LOG.exception("synthesis failed")
                    self._json(500, {"error": str(exc)})
            elif self.path == "/phonemize":
                if "text" not in body:
                    self._json(400, {"error": "missing 'text'"})
                    return
                try:
                    voice, _ = server._select(body)
                except KeyError as exc:
                    self._json(400, {"error": str(exc)})
                    return
                try:
                    sentences = voice.phonemize(str(body["text"]))
                    self._json(200, {
                        "phonemes": sentences,
                        "ids": [voice.phonemes_to_ids(ph)
                                for ph in sentences],
                    })
                except Exception as exc:
                    LOG.exception("phonemize failed")
                    self._json(500, {"error": str(exc)})
            else:
                self._json(404, {"error": "not found"})

        def _stream(self, body: Dict[str, Any]) -> None:
            voice, _ = server._select(body)  # validate before headers
            # run the pipeline up to the FIRST chunk before sending
            # headers: engine errors surface as a clean JSON 500 via
            # do_POST instead of corrupting a chunked body
            chunks = server.stream_pcm_chunks(body)
            first = next(chunks, None)
            try:
                # everything from send_response on is inside the guard:
                # once the first status-line byte is buffered, any error
                # path that emits a second response (do_POST's _json
                # handlers) would corrupt the HTTP framing — log, drop
                # the connection, never _json()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/octet-stream")
                self.send_header("Transfer-Encoding", "chunked")
                self.send_header("X-Sample-Rate",
                                 str(voice.config.sample_rate))
                self.send_header("X-Sample-Width", "2")
                self.send_header("X-Channels", "1")
                self.end_headers()
                head = [first] if first is not None else []
                for chunk in itertools.chain(head, chunks):
                    if not chunk:
                        continue  # a zero-length chunk would terminate
                    self.wfile.write(f"{len(chunk):x}\r\n".encode())
                    self.wfile.write(chunk)
                    self.wfile.write(b"\r\n")
                self.wfile.write(b"0\r\n\r\n")
            except Exception:
                LOG.exception("stream aborted mid-response")
                self.close_connection = True

    return Handler


def _parser():
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m phoonnx_tpu_torch.serve",
        description="phoonnx_tpu_torch TTS server (dynamic batching)")
    ap.add_argument("--model", required=True, action="append",
                    help="voice model path; repeatable. Use NAME=PATH to "
                         "name a voice (requests select it with "
                         '{"voice": NAME}); a bare PATH serves as '
                         "'default' / its file stem")
    ap.add_argument("--config", default=None,
                    help="voice config json (single-voice only; "
                         "multi-voice uses <model>.json)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-wait-ms", type=float, default=10.0)
    ap.add_argument("--precision", default=None,
                    choices=["default", "high", "highest"],
                    help="matmul precision: 'high' allows TF32 in "
                         "cuBLAS/cuDNN products; 'default' and 'highest' "
                         "keep them float32")
    ap.add_argument("--bf16", action="store_true",
                    help="serve in bfloat16 (every floating weight cast, "
                         "the kernels' bf16 builds)")
    ap.add_argument("--warmup", action="store_true",
                    help="capture the common bucket grid's graphs at "
                         "every lane count before accepting traffic")
    ap.add_argument("--request-timeout", type=float, default=120.0,
                    help="per-request synthesis wait in seconds; cold "
                         "starts without --warmup capture graphs on the "
                         "dispatcher")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the voices (default: cuda; "
                         "'cpu' serves the plain PyTorch path)")
    ap.add_argument("--devices", default=None,
                    help="serve across several GPUs: an int, or 'all' "
                         "for every visible CUDA device. Each voice's "
                         "engine is replicated per card (own weight copy "
                         "and graphs); batched requests go to the "
                         "least-loaded card, streams round-robin. "
                         "Default: the --device alone")
    return ap


def main(argv: Optional[List[str]] = None) -> None:
    from pathlib import Path

    from phoonnx_tpu_torch.voice import TTSVoice

    ap = _parser()
    args = ap.parse_args(argv)
    load = dict(dtype="bfloat16" if args.bf16 else "float32",
                device=args.device,
                matmul_precision=(None if args.precision in (None, "default")
                                  else args.precision))
    if len(args.model) == 1 and "=" not in args.model[0]:
        voices = TTSVoice.load(args.model[0], args.config, **load)
    else:
        if args.config:
            ap.error("--config only applies to a single bare --model")
        voices = {}
        for i, spec in enumerate(args.model):
            if "=" in spec:
                name, path = spec.split("=", 1)
            else:
                path = spec
                name = Path(spec).stem if i else "default"
            voices[name] = TTSVoice.load(path, **load)
    srv = TTSServer(voices, host=args.host, port=args.port,
                    max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                    request_timeout=args.request_timeout,
                    devices=args.devices)
    if args.warmup:
        srv.warmup()
    LOG.info("serving on %s:%d", *srv.address)
    srv.serve_forever()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
