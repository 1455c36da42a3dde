"""The port's server held against the JAX package's, on the CPU.

One ONNX voice, written from JAX parameters (the flow's post layers made
non-zero so the inverse flow is not the identity), is loaded by both
packages' ``TTSVoice``. Then:

* the two ``DynamicBatcher``s, given the same submissions over a
  recording engine, make the same ``synthesize_batch`` calls (ids, pad
  rows, speaker ids, seeds, scales), except that the port keeps a seeded
  group in its own order where JAX length-sorts it (ADVICE.md:5), and
  count the same requests and groups (JAX's ``batches``);
* the two HTTP servers answer a table of bad bodies with the same status
  and the same error, and ``/phonemize`` and ``/voices`` with the same
  JSON;
* at noise_scale 0 and noise_w 0 their WAVs have the same length and
  agree within 35 LSB: the path bound of 1e-3 (ARCHITECTURE.md:86-89)
  times 32767, plus one step of int16 truncation.
"""

import http.client
import io
import json
import wave

import jax
import numpy as np
import pytest

from phoonnx_tpu.models.vits import model as jax_model
from phoonnx_tpu.models.vits.load import params_to_flat
from phoonnx_tpu.onnx.writer import write_onnx
from phoonnx_tpu.serve import DynamicBatcher as JaxBatcher
from phoonnx_tpu.serve import TTSServer as JaxServer
from phoonnx_tpu_torch.serve import DynamicBatcher as PortBatcher
from phoonnx_tpu_torch.serve import TTSServer as PortServer

from tests.test_torch_infer import randomize_flow_post
from tests.test_torch_train_forward import one_torch_thread  # noqa: F401

PATH_LSB = 35

SAMPLE_RATE = 16000


@pytest.fixture(scope="module")
def voice_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_parity_voice")
    hp = jax_model.VitsHParams.preset("micro")
    params = randomize_flow_post(jax_model.random_params(
        jax.random.PRNGKey(4), hp))
    model_path = tmp / "model.onnx"
    write_onnx(str(model_path),
               {k: np.asarray(v) for k, v in params_to_flat(params).items()},
               metadata={"model_type": "vits",
                         "sample_rate": str(SAMPLE_RATE)},
               inputs=["input", "input_lengths", "scales"],
               outputs=["output"])
    id_map = {"_": 0, "^": 1, "$": 2, " ": 3}
    id_map.update({c: i + 4 for i, c in enumerate("abcdefghijklmnop")})
    config_path = tmp / "model.onnx.json"
    config_path.write_text(json.dumps({
        "phoneme_type": "raw", "lang_code": "en", "alphabet": "ipa",
        "phoneme_id_map": id_map, "num_symbols": len(id_map),
        "num_speakers": 1, "audio": {"sample_rate": SAMPLE_RATE},
        "inference": {"noise_scale": 0.667, "length_scale": 1.0,
                      "noise_w": 0.8},
    }), encoding="utf-8")
    return str(model_path), str(config_path)


@pytest.fixture(scope="module")
def servers(voice_files):
    from phoonnx_tpu import TTSVoice as JaxVoice
    from phoonnx_tpu_torch import TTSVoice as PortVoice

    pair = (JaxServer(JaxVoice.load(*voice_files), port=0, max_batch=8,
                      max_wait_ms=5.0),
            PortServer(PortVoice.load(*voice_files, device="cpu"), port=0,
                       max_batch=8, max_wait_ms=5.0))
    for srv in pair:
        srv.start()
    yield pair
    for srv in pair:
        srv.stop()


def _request(server, method, path, body=None, raw=None):
    host, port = server.address
    conn = http.client.HTTPConnection(host, port, timeout=300)
    conn.request(method, path,
                 body=raw if raw is not None else
                 (json.dumps(body) if body is not None else None),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


class _Recorder:
    """An engine that records every synthesize_batch call and returns
    silence of one frame a lane."""

    compiled_batching = True

    def __init__(self, hp):
        self.hp = hp
        self.calls = []

    def synthesize_batch(self, batch_ids, noise_scale, length_scale,
                         noise_w, speaker_ids, seed):
        self.calls.append({
            "ids": [list(u) for u in batch_ids],
            "speaker_ids": list(speaker_ids), "seed": seed,
            "scales": (noise_scale, length_scale, noise_w)})
        up = self.hp.total_upsample
        return (np.zeros((len(batch_ids), up), np.float32),
                [1] * len(batch_ids))


def _submissions():
    """(sentence ids, scales, speaker id, seed) of each submission: two
    scale groups, a seeded multi-sentence request out of length order, a
    request longer than max_batch, and one with no sentence."""
    rng = np.random.default_rng(8)

    def sentence(n):
        return [1] + rng.integers(4, 20, n).tolist() + [2]

    a, b = (0.667, 1.0, 0.8), (0.3, 1.2, 0.5)
    return [
        ([sentence(9), sentence(2)], a, 0, None),
        ([sentence(14)], b, 1, None),
        ([sentence(12), sentence(3), sentence(7)], a, 0, 77),
        ([sentence(n) for n in (5, 1, 8, 3, 11, 2, 6, 4, 9, 10)], a, 2,
         None),
        ([], a, 0, None),
        ([sentence(4)], b, 0, None),
    ]


def _dispatch(batcher_cls, hp):
    engine = _Recorder(hp)
    batcher = batcher_cls(engine, max_batch=4, max_wait_ms=1.0,
                          autostart=False)
    subs = [batcher.submit(ids, scales, speaker_id=sid, seed=seed)
            for ids, scales, sid, seed in _submissions()]
    while not batcher._queue.empty():
        batcher._drain_once()
    for sub in subs:
        sub.wait(timeout=5.0)
    return engine.calls, dict(batcher.stats)


def test_batchers_make_the_same_calls():
    hp = jax_model.VitsHParams.preset("micro")
    jax_calls, jax_stats = _dispatch(JaxBatcher, hp)
    port_calls, port_stats = _dispatch(PortBatcher, hp)
    # the port's stats report JAX's "batches" and, beside it, the same
    # count as "groups", and count the dispatches and their lanes, frames
    # and samples besides (the recording engine answers one frame a lane)
    assert port_stats["groups"] == jax_stats["batches"]
    assert {k: port_stats[k] for k in jax_stats} == jax_stats
    assert len(port_calls) == len(jax_calls) == 6
    assert port_stats["dispatches"] == len(port_calls)
    assert port_stats["frames_real"] == port_stats["lanes"]
    assert port_stats["frames_decoded"] == sum(len(c["ids"])
                                               for c in port_calls) == \
        port_stats["lanes"] + port_stats["pad_lanes"]
    assert port_stats["samples_decoded"] == \
        port_stats["frames_decoded"] * hp.total_upsample

    seeded = [i for i, c in enumerate(jax_calls) if c["seed"] is not None]
    assert seeded == [0]
    for i, (got, want) in enumerate(zip(port_calls, jax_calls)):
        if i in seeded:
            continue
        assert got == want, i

    # the one difference: the seeded group's lanes. JAX dispatches them
    # length-sorted, the port in the submission's own order; both pad
    # the chunk to 4 lanes with [1] and speaker 0
    sentences = _submissions()[2][0]
    pad = [[1]]
    assert port_calls[0]["ids"] == sentences + pad
    assert jax_calls[0]["ids"] == sorted(sentences, key=len) + pad
    assert port_calls[0]["ids"] != jax_calls[0]["ids"]
    for key in ("speaker_ids", "seed", "scales"):
        assert port_calls[0][key] == jax_calls[0][key]


BAD_BODIES = [
    ("missing text", {"nope": 1}),
    ("NaN noise_scale", {"text": "[[abc]]", "noise_scale": float("nan")}),
    ("length_scale 0", {"text": "[[abc]]", "length_scale": 0.0}),
    ("unknown voice", {"text": "[[abc]]", "voice": "nope"}),
    ("oversized sentence", {"text": "[[" + "a " * 1030 + "]]"}),
    ("normalize with stream", {"text": "[[abc]]", "stream": True,
                               "normalize": True}),
    ("not an object", [1, 2]),
]


@pytest.mark.parametrize("body", [b for _, b in BAD_BODIES],
                         ids=[name for name, _ in BAD_BODIES])
def test_bad_bodies_get_the_same_answer(servers, body):
    (j_status, j_data), (p_status, p_data) = (
        _request(srv, "POST", "/synthesize", body) for srv in servers)
    assert p_status == j_status == 400
    assert json.loads(p_data)["error"] == json.loads(j_data)["error"]


@pytest.mark.parametrize("method,path,body", [
    ("POST", "/phonemize", {"text": "[[abc def]] [[gah]]"}),
    ("GET", "/voices", None),
    ("GET", "/health", None),
    ("GET", "/nope", None),
])
def test_routes_give_the_same_json(servers, method, path, body):
    (j_status, j_data), (p_status, p_data) = (
        _request(srv, method, path, body) for srv in servers)
    assert p_status == j_status
    assert json.loads(p_data) == json.loads(j_data)


def _pcm(wav_bytes):
    with wave.open(io.BytesIO(wav_bytes), "rb") as w:
        assert w.getframerate() == SAMPLE_RATE and w.getsampwidth() == 2
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


@pytest.mark.parametrize("text", ["[[abc def gah]]", "[[pon mlk]] [[jihg]]",
                                  "abc dae. fgh"])
def test_wavs_agree_at_zero_noise(servers, text):
    body = {"text": text, "noise_scale": 0.0, "noise_w": 0.0}
    jax_wav, port_wav = (_request(srv, "POST", "/synthesize", body)
                         for srv in servers)
    assert jax_wav[0] == port_wav[0] == 200
    want, got = _pcm(jax_wav[1]), _pcm(port_wav[1])
    assert len(got) == len(want) > 0
    err = int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max())
    assert err <= PATH_LSB, err
