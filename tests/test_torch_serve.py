"""The port's TTS HTTP server: dynamic batching, WAV and streaming PCM.

The counterparts of tests/test_serve.py, on the CPU (``device="cpu"``,
the ``micro`` preset, a voice written with the port's own ONNX writer).
Pool tests build a ``BatcherPool`` of two engines on the CPU
(``devices=["cpu", "cpu"]``); asking for more GPUs than exist raises.
"""

import http.client
import io
import json
import socket
import subprocess
import sys
import threading
import time
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from phoonnx_tpu_torch.infer import VitsEngine
from phoonnx_tpu_torch.models.vits.model import VitsHParams, random_params
from phoonnx_tpu_torch.serve import BatcherPool, DynamicBatcher, TTSServer

from tests.test_torch_cli import write_port_voice

ROOT = Path(__file__).resolve().parent.parent
SCALES = (0.667, 1.0, 0.8)


@pytest.fixture(scope="module")
def voice_path(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_serve_voice")
    return write_port_voice(tmp / "model.onnx",
                            VitsHParams.preset("micro", n_vocab=20), 0)


@pytest.fixture(scope="module")
def voice(voice_path):
    from phoonnx_tpu_torch import TTSVoice

    return TTSVoice.load(str(voice_path), device="cpu")


@pytest.fixture(scope="module")
def server(voice):
    srv = TTSServer(voice, port=0, max_batch=8, max_wait_ms=30.0)
    srv.start()
    yield srv
    srv.stop()


def _request(server, method, path, body=None, raw=None):
    host, port = server.address
    conn = http.client.HTTPConnection(host, port, timeout=120)
    conn.request(method, path,
                 body=raw if raw is not None else
                 (json.dumps(body) if body is not None else None),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp, data


def _pcm(wav_bytes):
    with wave.open(io.BytesIO(wav_bytes), "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def _spy_engine(real, calls, compiled_batching=True):
    """An engine whose synthesize_batch records its calls, then runs
    ``real``'s."""
    def spy(batch_ids, **kw):
        calls.append(len(batch_ids))
        return real.synthesize_batch(batch_ids, **kw)
    return type("E", (), {"synthesize_batch": staticmethod(spy),
                          "hp": real.hp,
                          "compiled_batching": compiled_batching})()


def test_health(server):
    resp, data = _request(server, "GET", "/health")
    assert resp.status == 200
    payload = json.loads(data)
    assert payload["status"] == "ok"
    assert payload["sample_rate"] == 16000


def test_synthesize_wav(server):
    resp, data = _request(server, "POST", "/synthesize",
                          {"text": "[[abc def]]", "seed": 3})
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "audio/wav"
    with wave.open(io.BytesIO(data), "rb") as w:
        assert w.getframerate() == 16000
        assert w.getnchannels() == 1
    pcm = _pcm(data)
    assert len(pcm) > 0
    assert np.abs(pcm).max() > 0


def test_synthesize_deterministic_seed(server):
    _, wav1 = _request(server, "POST", "/synthesize",
                       {"text": "[[abc]]", "seed": 42})
    _, wav2 = _request(server, "POST", "/synthesize",
                       {"text": "[[abc]]", "seed": 42})
    assert wav1 == wav2


def test_synthesize_stream_pcm(server):
    resp, data = _request(server, "POST", "/synthesize",
                          {"text": "[[abc def gah]]", "seed": 5,
                           "stream": True, "chunk_frames": 8,
                           "overlap_frames": 8})
    assert resp.status == 200
    assert resp.getheader("X-Sample-Rate") == "16000"
    pcm_stream = np.frombuffer(data, np.int16)
    assert len(pcm_stream) > 0

    # the streamed PCM equals the batch path's audio for the seed: the
    # stream equals the request to ~1e-7, so int16 truncation differs by
    # at most one step
    resp, wav = _request(server, "POST", "/synthesize",
                         {"text": "[[abc def gah]]", "seed": 5})
    pcm_full = _pcm(wav)
    assert len(pcm_stream) == len(pcm_full)
    np.testing.assert_allclose(pcm_stream, pcm_full, atol=1)


def test_volume_consistent_between_routes(server):
    """Same request with/without stream must agree on loudness."""
    base = {"text": "[[abc def]]", "seed": 9}
    _, wav_half = _request(server, "POST", "/synthesize",
                           dict(base, volume=0.5))
    _, wav_full = _request(server, "POST", "/synthesize", base)
    pcm_half, pcm_full = _pcm(wav_half), _pcm(wav_full)
    np.testing.assert_allclose(pcm_half, (pcm_full * 0.5), atol=2)

    resp, data = _request(server, "POST", "/synthesize",
                          dict(base, volume=0.5, stream=True,
                               chunk_frames=8, overlap_frames=8))
    assert resp.status == 200
    pcm_stream = np.frombuffer(data, np.int16)
    assert len(pcm_stream) == len(pcm_half)
    np.testing.assert_allclose(pcm_stream, pcm_half, atol=2)


def test_concurrent_requests_batch(server):
    results = {}

    def worker(i):
        resp, data = _request(server, "POST", "/synthesize",
                              {"text": "[[abc def]]", "seed": 9})
        results[i] = (resp.status, data)

    before = dict(server.batcher.stats)
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert all(status == 200 for status, _ in results.values())
    # identical params + seed -> identical audio regardless of batching
    blobs = {data for _, data in results.values()}
    assert len(blobs) == 1
    after = server.batcher.stats
    assert after["requests"] - before["requests"] == 6


def test_stats_route_counts_groups_and_dispatches(server):
    """``/stats``: a request of more sentences than ``max_batch`` is one
    group of two dispatches, and the lanes and frames add up."""
    from phoonnx_tpu_torch.serve import COUNTERS

    _, data = _request(server, "GET", "/stats")
    before = json.loads(data)
    # ten sentences at max_batch 8; a seeded request is a group of its own
    resp, wav = _request(server, "POST", "/synthesize",
                         {"text": "Abc def. " * 10, "seed": 3})
    assert resp.status == 200
    _, data = _request(server, "GET", "/stats")
    after = json.loads(data)
    assert set(COUNTERS) | {"max_batch_seen"} <= set(after)
    # the JAX package's name for the groups, beside it
    assert after["batches"] == after["groups"]
    grew = {k: after[k] - before[k] for k in COUNTERS}
    assert grew["requests"] == 1 and grew["groups"] == 1
    assert grew["dispatches"] == 2 and grew["lanes"] == 10
    assert grew["pad_lanes"] == 0 and grew["graph_captures"] == 0
    up = server.batcher.engine.hp.total_upsample
    assert grew["frames_real"] == len(_pcm(wav)) // up
    assert grew["frames_real"] <= grew["frames_decoded"]
    assert grew["samples_decoded"] == up * grew["frames_decoded"]
    assert after["dispatches"] >= after["groups"]


def test_phonemize_route(server):
    resp, data = _request(server, "POST", "/phonemize",
                          {"text": "[[abc]]"})
    assert resp.status == 200
    payload = json.loads(data)
    assert payload["phonemes"]
    assert payload["ids"]


def test_bad_requests(server):
    resp, _ = _request(server, "POST", "/synthesize", {"nope": 1})
    assert resp.status == 400
    resp, _ = _request(server, "GET", "/nope")
    assert resp.status == 404
    resp, _ = _request(server, "POST", "/synthesize", raw=b"{not json")
    assert resp.status == 400
    resp, data = _request(server, "POST", "/synthesize", raw=b"[1, 2]")
    assert resp.status == 400
    assert "JSON object" in json.loads(data)["error"]


def test_stream_engine_error_returns_json_500(server, voice, monkeypatch):
    """A streaming-engine failure must surface as a clean JSON 500:
    the pipeline runs up to the first chunk BEFORE headers go out, so a
    status line is never written into a chunked body."""
    def boom(*a, **k):
        raise NotImplementedError("no streaming on this engine")
        yield  # pragma: no cover — make it a generator

    monkeypatch.setattr(voice.engine, "synthesize_ids_streaming", boom)
    resp, data = _request(server, "POST", "/synthesize",
                          {"text": "abc def", "stream": True})
    assert resp.status == 500
    assert "error" in json.loads(data)


def test_phonemize_error_returns_json_500(server, voice, monkeypatch):
    monkeypatch.setattr(
        voice, "phonemize",
        lambda text: (_ for _ in ()).throw(RuntimeError("g2p down")))
    resp, data = _request(server, "POST", "/phonemize", {"text": "abc"})
    assert resp.status == 500
    assert "g2p down" in json.loads(data)["error"]


def test_multi_voice_server(voice):
    import dataclasses

    from phoonnx_tpu_torch.voice import TTSVoice

    hp = VitsHParams.preset("micro", n_vocab=20, sample_rate=8000)
    second = TTSVoice(
        engine=VitsEngine(random_params(hp, torch.Generator().manual_seed(7)),
                          hp, device="cpu"),
        config=dataclasses.replace(voice.config, sample_rate=8000),
    )
    srv = TTSServer({"en": voice, "alt": second}, port=0,
                    max_batch=4, max_wait_ms=10.0)
    srv.start()
    try:
        resp, data = _request(srv, "GET", "/voices")
        assert resp.status == 200
        listing = json.loads(data)
        assert set(listing) == {"en", "alt"}
        assert listing["alt"]["sample_rate"] == 8000

        resp, data = _request(srv, "POST", "/synthesize",
                              {"text": "[[abc]]", "voice": "alt",
                               "seed": 1})
        assert resp.status == 200
        with wave.open(io.BytesIO(data), "rb") as w:
            assert w.getframerate() == 8000

        resp, data = _request(srv, "POST", "/synthesize",
                              {"text": "[[abc]]", "voice": "nope"})
        assert resp.status == 400
        assert "unknown voice" in json.loads(data)["error"]

        resp, data = _request(srv, "GET", "/stats")
        assert set(json.loads(data)) == {"en", "alt"}
    finally:
        srv.stop()


def test_batcher_coalesces_submissions(voice):
    """Deterministic batching check: stopped dispatcher, manual drain."""
    calls = []
    batcher = DynamicBatcher(voice.engine, max_batch=8, max_wait_ms=1.0,
                             autostart=False)
    batcher.engine = _spy_engine(voice.engine, calls)
    ids = [[1, 5, 9, 3]]
    subs = [batcher.submit(ids, SCALES) for _ in range(3)]
    batcher._drain_once()
    for sub in subs:
        audio = sub.wait(timeout=1.0)
        assert len(audio) > 0
    # ONE device batch; 3 real lanes padded up to the power-of-two batch
    # bucket (4) so distinct concurrency levels share graphs
    assert calls == [4]
    assert batcher.stats["max_batch_seen"] == 3


def test_oversized_sentence_returns_400_not_batched(server, voice):
    """A sentence above the largest text bucket must 400 its own request
    on the handler thread, never reach the dispatcher (where the error
    would poison co-batched requests)."""
    limit = voice.engine.text_buckets[-1]
    before = server.batcher.stats["requests"]
    resp, data = _request(server, "POST", "/synthesize",
                          {"text": "[[" + "a " * (limit + 4) + "]]"})
    assert resp.status == 400
    assert "split the input text" in json.loads(data)["error"]
    assert server.batcher.stats["requests"] == before


def test_float_seed_coerced(server):
    resp, data = _request(server, "POST", "/synthesize",
                          {"text": "[[abc]]", "seed": 5.0})
    assert resp.status == 200


def test_request_timeout_returns_clear_json_error(voice):
    """A too-small request_timeout must fail as a clean JSON error that
    points at warmup and graph captures, not hang or corrupt HTTP
    framing."""
    srv = TTSServer(voice, port=0, max_batch=8, max_wait_ms=500.0,
                    request_timeout=1e-4)
    srv.start()
    try:
        resp, data = _request(srv, "POST", "/synthesize",
                              {"text": "[[abc]]"})
        assert resp.status == 504  # gateway-timeout, not a generic 500
        error = json.loads(data)["error"]
        assert "timed out" in error
        assert "--warmup" in error
        assert "CUDA graph" in error and "XLA" not in error
    finally:
        srv.stop()


def test_single_oversized_submission_chunks_to_max_batch(voice):
    """One request with more sentences than max_batch dispatches in
    max_batch-lane chunks."""
    calls = []
    batcher = DynamicBatcher(voice.engine, max_batch=8, max_wait_ms=1.0,
                             autostart=False)
    batcher.engine = _spy_engine(voice.engine, calls)
    sub = batcher.submit([[1, 5, 9]] * 20, SCALES)
    batcher._drain_once()
    audio = sub.wait(timeout=30.0)
    assert len(audio) > 0
    assert calls == [8, 8, 4], calls  # 20 lanes -> 8+8+4(pow2 of 4)
    assert batcher.stats["max_batch_seen"] == 8


def _fake_engine(hp, calls):
    """An engine that stamps each lane's audio with its first id and
    records every call's lane lengths and seed."""
    up = hp.total_upsample

    def fake(batch_ids, seed=None, **kw):
        calls.append(([len(u) for u in batch_ids], seed))
        bucket = max(len(u) for u in batch_ids)
        audio = np.zeros((len(batch_ids), bucket * up), np.float32)
        for i, u in enumerate(batch_ids):
            audio[i, :len(u) * up] = float(u[0])
        return audio, [len(u) for u in batch_ids]
    return type("E", (), {"synthesize_batch": staticmethod(fake), "hp": hp,
                          "compiled_batching": True})()


def test_batcher_length_sorted_bucket_chunks(voice):
    """A backlogged queue is over-drained past max_batch and the lanes of
    an unseeded group are LENGTH-SORTED before chunking, while every
    submission still receives exactly its own audio."""
    calls = []
    up = voice.engine.hp.total_upsample
    batcher = DynamicBatcher(voice.engine, max_batch=4, max_wait_ms=1.0,
                             autostart=False)
    batcher.engine = _fake_engine(voice.engine.hp, calls)
    lens = [12, 3, 11, 2, 10, 4, 9, 5]  # interleaved long/short arrivals
    subs = [batcher.submit([[i + 1] * n], SCALES)
            for i, n in enumerate(lens)]
    batcher._drain_once()
    # the whole 8-lane backlog joined one group (over-drain), split into
    # two chunks with shorts and longs SEPARATED
    assert len(calls) == 2, calls
    assert max(calls[0][0]) <= min(calls[1][0]), calls
    for i, (sub, n) in enumerate(zip(subs, lens)):
        audio = sub.wait(timeout=5.0)
        assert len(audio) == n * up
        assert audio[0] == i + 1
    assert batcher.stats["max_batch_seen"] == 4


def test_seeded_submission_keeps_its_order(voice):
    """A seeded multi-sentence submission is dispatched in its own order
    (lane i draws its noise from seed + i), not length-sorted as the JAX
    batcher does (ADVICE.md:5), and its audio equals the engine's batch
    of those sentences in that order with that seed."""
    calls = []
    batcher = DynamicBatcher(voice.engine, max_batch=8, max_wait_ms=1.0,
                             autostart=False)
    batcher.engine = _fake_engine(voice.engine.hp, calls)
    sentences = [[1, 5, 9, 4, 6, 7, 8, 2], [1, 4, 2], [1, 6, 7, 8, 2]]
    seeded = batcher.submit(sentences, SCALES, seed=11)
    unseeded = batcher.submit(sentences, SCALES)
    batcher._drain_once()
    seeded.wait(timeout=5.0), unseeded.wait(timeout=5.0)
    assert calls[0] == ([8, 3, 5, 1], 11)  # own order, one pad lane
    assert calls[1] == ([3, 5, 8, 1], None)  # sorted

    engine = voice.engine
    batcher = DynamicBatcher(engine, max_batch=8, max_wait_ms=1.0,
                             autostart=False)
    sub = batcher.submit(sentences, SCALES, seed=11)
    batcher._drain_once()
    got = sub.wait(timeout=30.0)
    audio, frames = engine.synthesize_batch(sentences, *SCALES, seed=11)
    up = engine.hp.total_upsample
    want = np.concatenate([audio[i, :n * up] for i, n in enumerate(frames)])
    assert got.shape == want.shape
    # the batcher's batch has one pad lane more: another frame bucket at
    # most, which changes no valid sample beyond rounding
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)



def test_seeded_submission_longer_than_max_batch(voice):
    """A seeded submission of more sentences than max_batch is chunked,
    and each chunk continues the seed where the last one stopped (chunk
    lane i is lane start + i), so its audio equals the engine's batch of
    all its sentences with that seed: no sentence reuses another's
    noise."""
    rng = np.random.default_rng(3)
    sentences = [[1] + rng.integers(3, 20, size=int(n)).tolist() + [2]
                 for n in rng.integers(2, 12, size=20)]
    engine = voice.engine
    calls = []
    batcher = DynamicBatcher(engine, max_batch=8, max_wait_ms=1.0,
                             autostart=False)
    batcher.engine = _fake_engine(engine.hp, calls)
    batcher.submit(sentences, SCALES, seed=5)
    batcher._drain_once()
    assert [seed for _, seed in calls] == [5, 13, 21]

    batcher = DynamicBatcher(engine, max_batch=8, max_wait_ms=1.0,
                             autostart=False)
    sub = batcher.submit(sentences, SCALES, seed=5)
    batcher._drain_once()
    got = sub.wait(timeout=30.0)
    audio, frames = engine.synthesize_batch(sentences, *SCALES, seed=5)
    up = engine.hp.total_upsample
    want = np.concatenate([audio[i, :n * up] for i, n in enumerate(frames)])
    assert got.shape == want.shape
    # the chunks pad to other batch and frame buckets than the batch of
    # 20, which changes no valid sample beyond rounding
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

def test_sequential_engine_gets_no_pad_rows(voice):
    """Engines that synthesize rows sequentially (compiled_batching
    False) must not receive pad lanes: every pad row would be a REAL
    extra synthesis there."""
    calls = []
    batcher = DynamicBatcher(voice.engine, max_batch=8, max_wait_ms=1.0,
                             autostart=False)
    batcher.engine = _spy_engine(voice.engine, calls,
                                 compiled_batching=False)
    subs = [batcher.submit([[1, 5, 9]], SCALES) for _ in range(3)]
    batcher._drain_once()
    for sub in subs:
        assert len(sub.wait(timeout=30.0)) > 0
    assert calls == [3], calls  # 3 lanes, NOT padded to 4


def test_failed_group_reaches_its_handlers(voice):
    """An engine error in a group is given to every submission of it."""
    def boom(batch_ids, **kw):
        raise RuntimeError("device lost")
    batcher = DynamicBatcher(voice.engine, max_batch=8, max_wait_ms=1.0,
                             autostart=False)
    batcher.engine = type("E", (), {"synthesize_batch": staticmethod(boom),
                                    "hp": voice.engine.hp})()
    subs = [batcher.submit([[1, 5, 9]], SCALES) for _ in range(2)]
    batcher._drain_once()
    for sub in subs:
        with pytest.raises(RuntimeError, match="device lost"):
            sub.wait(timeout=1.0)


def test_submit_after_stop_fails_fast(voice):
    """A submission racing stop() must error immediately, not sleep out
    the full request timeout on an event nobody will set."""
    batcher = DynamicBatcher(voice.engine, autostart=False)
    batcher.stop()
    sub = batcher.submit([[1]], SCALES)
    with pytest.raises(RuntimeError, match="shutting down"):
        sub.wait(timeout=1.0)


def test_stop_before_start_returns_promptly(voice):
    """socketserver.shutdown() blocks forever on a server whose
    serve_forever never ran; stop() must handle the never-started case."""
    srv = TTSServer(voice, port=0, max_batch=4)
    t0 = time.monotonic()
    srv.stop()
    assert time.monotonic() - t0 < 3.0


def test_nan_scales_return_400(server):
    resp, data = _request(server, "POST", "/synthesize",
                          {"text": "[[abc]]", "noise_scale": float("nan")})
    assert resp.status == 400
    assert "finite" in json.loads(data)["error"]
    resp, data = _request(server, "POST", "/synthesize",
                          {"text": "[[abc]]", "length_scale": 0.0})
    assert resp.status == 400


def test_stream_with_normalize_returns_400(server):
    resp, data = _request(server, "POST", "/synthesize",
                          {"text": "[[abc]]", "stream": True,
                           "normalize": True})
    assert resp.status == 400
    assert "normalize" in json.loads(data)["error"]


# -- multi-device serving (two engines on the CPU) --------------------------

@pytest.fixture(scope="module")
def pool_server(voice):
    srv = TTSServer(voice, port=0, max_batch=8, max_wait_ms=30.0,
                    devices=["cpu", "cpu"])
    srv.start()
    yield srv
    srv.stop()


def test_pool_engines_on_distinct_devices(pool_server, voice, monkeypatch):
    """More GPUs asked for than exist raise, naming the count; a list of
    devices builds one engine each."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for devices in (2, "2"):
        with pytest.raises(ValueError, match="only 1 CUDA device"):
            TTSServer(voice, port=0, devices=devices)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="only 0 CUDA device"):
        TTSServer(voice, port=0, devices="all")
    with pytest.raises(ValueError, match=">= 1"):
        TTSServer(voice, port=0, devices=0)

    batcher = pool_server.batcher
    assert isinstance(batcher, BatcherPool)
    engines = [b.engine for b in batcher.batchers]
    assert len(engines) == 2 and engines[0] is voice.engine
    assert engines[1] is not engines[0]
    assert [str(e.device) for e in engines] == ["cpu", "cpu"]


def test_pool_synthesis_and_stats(pool_server):
    # seeded requests are deterministic and engines share weights, so
    # the same request must produce identical audio whichever engine
    # serves it
    wavs = []
    for _ in range(4):
        resp, data = _request(pool_server, "POST", "/synthesize",
                              {"text": "abcabc", "seed": 5})
        assert resp.status == 200
        wavs.append(data)
    assert all(w == wavs[0] for w in wavs[1:])
    resp, data = _request(pool_server, "GET", "/stats")
    stats = json.loads(data)
    assert stats["devices"] == 2
    assert stats["requests"] >= 4
    assert len(stats["per_device"]) == 2
    # the pool's counters are its batchers' sums
    for key in ("groups", "dispatches", "lanes", "frames_real"):
        assert stats[key] == sum(s[key] for s in stats["per_device"]) > 0
    assert stats["dispatches"] >= stats["groups"]


def test_pool_concurrent_requests_spread(pool_server):
    results = [None] * 6

    def hit(i):
        resp, data = _request(pool_server, "POST", "/synthesize",
                              {"text": "abcdef"})
        results[i] = resp.status

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert all(s == 200 for s in results)
    assert pool_server.batcher.stats["requests"] >= 6


def test_pool_streaming_round_robin(pool_server):
    batcher = pool_server.batcher
    assert isinstance(batcher, BatcherPool)
    e1, e2 = batcher.next_engine(), batcher.next_engine()
    assert e1 is not e2
    resp, data = _request(pool_server, "POST", "/synthesize",
                          {"text": "abc", "stream": True, "seed": 1})
    assert resp.status == 200
    assert len(data) > 0 and len(data) % 2 == 0  # s16le


def test_engine_replicate_reuses_primary(voice):
    engines = voice.engine.replicate(["cpu", torch.device("cpu")])
    assert engines[0] is voice.engine
    assert engines[1] is not voice.engine
    assert engines[1].frame_buckets == voice.engine.frame_buckets
    assert engines[1].mode == voice.engine.mode
    ids = [5, 6, 7, 8, 9, 4]
    a = engines[0].synthesize_ids(ids, seed=3)
    b = engines[1].synthesize_ids(ids, seed=3)
    np.testing.assert_array_equal(a, b)


def test_device_memory_stats_shape():
    """device_memory_stats returns MB-scaled dicts (empty without a CUDA
    device)."""
    from phoonnx_tpu_torch.observability import device_memory_stats

    stats = device_memory_stats()
    for entry in stats.values():
        assert set(entry) == {"bytes_in_use_mb", "peak_bytes_in_use_mb",
                              "bytes_limit_mb"}
        assert all(v >= 0 for v in entry.values())


# -- the CLI ----------------------------------------------------------------

@pytest.mark.parametrize("flags,want", [
    (["--bf16", "--precision", "high"], ("bfloat16", "high")),
    (["--precision", "highest"], ("float32", "highest")),
    (["--precision", "default"], ("float32", None)),
    (["--precision", "medium"], None)], ids=["bf16", "highest", "default",
                                             "bad"])
def test_cli_refuses_bf16(voice_path, monkeypatch, flags, want):
    """``--bf16`` and ``--precision`` reach the served engine (the
    server is built and not started); a precision the JAX server does not
    offer is refused."""
    from phoonnx_tpu_torch import serve

    seen = []
    monkeypatch.setattr(serve.TTSServer, "serve_forever", lambda self: (
        seen.append((self.voice.engine.dtype_str,
                     self.voice.engine.matmul_precision)), self.stop()))
    argv = ["--model", str(voice_path), "--device", "cpu", "--port",
            "0"] + flags
    if want is None:
        with pytest.raises(SystemExit) as err:
            serve.main(argv)
        assert err.value.code != 0
        return
    serve.main(argv)
    assert seen == [want]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_serves_on_the_cpu(voice_path):
    """``python -m phoonnx_tpu_torch.serve --device cpu`` answers
    /health, /synthesize (WAV and stream) and /stats."""
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "phoonnx_tpu_torch.serve", "--device", "cpu",
         "--model", str(voice_path), "--port", str(port)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    srv = type("S", (), {"address": ("127.0.0.1", port)})()
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                resp, data = _request(srv, "GET", "/health")
                break
            except OSError:
                assert proc.poll() is None, proc.stdout.read().decode()
                assert time.monotonic() < deadline, "server did not start"
                time.sleep(0.2)
        assert resp.status == 200 and json.loads(data)["status"] == "ok"
        resp, wav = _request(srv, "POST", "/synthesize",
                             {"text": "[[abc def]]", "seed": 2})
        assert resp.status == 200 and len(_pcm(wav)) > 0
        resp, pcm = _request(srv, "POST", "/synthesize",
                             {"text": "[[abc def]]", "seed": 2,
                              "stream": True})
        assert resp.status == 200
        np.testing.assert_allclose(np.frombuffer(pcm, np.int16), _pcm(wav),
                                   atol=1)
        resp, data = _request(srv, "GET", "/stats")
        assert resp.status == 200 and json.loads(data)["requests"] == 1
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()
