"""The port's engine programs and surface against the JAX package, on the CPU.

Each program of ``phoonnx_tpu_torch.infer.engine.VitsEngine`` (the
functions that the card captures as CUDA graphs) is held against the JAX
model function it replaces, at bucket shapes, with the same weights and
the same injected noise; the engine's bucket and budget choices against
the JAX engine's; and its modes against each other: fused against
two-phase on the valid span, ``synthesize_many`` against per-utterance
fused calls, the int16 fetch against float32. On the CPU the engine calls
the programs directly and the kernel wrappers run their plain versions.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoonnx_tpu.infer import engine as jax_engine
from phoonnx_tpu.models.vits import model as jax_model
from phoonnx_tpu_torch.infer import engine as port_engine
from phoonnx_tpu_torch.infer.engine import VitsEngine

from tests.test_torch_infer import port_params, randomize_flow_post
from tests.test_torch_train_forward import one_torch_thread  # noqa: F401
from tests.test_voice_e2e import SMALL_HP

# end-to-end waveform bound (ARCHITECTURE.md:86-89) and the per-module
# bound of the port's tests: both sides are f32 on the CPU and sum in
# other orders
WAVE_TOL = 1e-3
MODULE_TOL = 1e-5
# fused against two-phase: the same noise, decoded at two frame buckets
# (kernel C's plain version masks every stage to the valid span)
MODE_TOL = 1e-4
PCM16_TOL = 1.0 / 32767.0 + 1e-6

TEXT_BUCKETS = (16, 32)
FRAME_BUCKETS = (64, 128, 256)
SCALES = (0.667, 1.0, 0.8)

_j_durations = jax.jit(jax_model.infer_durations, static_argnums=(1,))
_j_latents = jax.jit(jax_model.infer_latents, static_argnums=(1, 6))
_j_decode = jax.jit(jax_model.infer_decode, static_argnums=(1, 6))
_j_infer = jax.jit(jax_model.infer, static_argnums=(1, 4))
_j_decode_audio = jax.jit(jax_model.decode_audio, static_argnums=(1,))


@pytest.fixture(scope="module")
def models():
    hp = dataclasses.replace(SMALL_HP, n_vocab=40)
    jp = randomize_flow_post(jax_model.random_params(jax.random.PRNGKey(3),
                                                     hp))
    tp, thp = port_params(jp, hp)
    eng = VitsEngine(tp, thp, text_buckets=TEXT_BUCKETS,
                     frame_buckets=FRAME_BUCKETS, device="cpu")
    return jp, hp, eng


def _inputs(hp, seed, lengths, t_bucket, frames):
    """ids padded to ``t_bucket``, and duration and prior noise, by numpy."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    ids = np.zeros((b, t_bucket), np.int64)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.integers(1, hp.n_vocab, n)
    lens = np.asarray(lengths, np.int32)
    dp_noise = rng.standard_normal((b, t_bucket, 2)).astype(np.float32)
    prior = rng.standard_normal(
        (b, frames, hp.inter_channels)).astype(np.float32)
    return ids, lens, dp_noise, prior


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _phase1_both(jp, hp, eng, seed=0, lengths=(12, 7), scales=SCALES):
    ids, lens, dp_noise, _ = _inputs(hp, seed, lengths, 32, 1)
    want = _j_durations(jp, hp, jnp.asarray(ids, jnp.int32),
                        jnp.asarray(lens), scales[1], scales[2],
                        dp_noise=jnp.asarray(dp_noise))
    got = eng._phase1(*_t(ids, lens), torch.zeros(len(lengths),
                                                  dtype=torch.int64),
                      torch.tensor(scales), torch.from_numpy(dp_noise))
    return want, got


def _close(got, want, tol, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err)
    return err


def test_phase1_matches_jax_infer_durations(models):
    jp, hp, eng = models
    want, got = _phase1_both(jp, hp, eng)
    for name, w, g in zip(("m_p", "logs_p", "w_ceil", "x_mask"), want, got):
        _close(g, w, MODULE_TOL, name)
    assert want[4] is None and got[4] is None  # single speaker: no g
    frames = np.maximum(np.asarray(want[2]).sum(-1), 1).astype(np.int32)
    np.testing.assert_array_equal(got[5].numpy(), frames)


def test_latents_match_jax_infer_latents(models):
    jp, hp, eng = models
    want1, got1 = _phase1_both(jp, hp, eng, seed=1)
    _, _, _, prior = _inputs(hp, 2, (1, 1), 1, 128)
    m_p, logs_p, w_ceil, x_mask, _ = want1
    z, y = _j_latents(jp, hp, m_p, logs_p, w_ceil, x_mask, 128, SCALES[0],
                      prior_noise=jnp.asarray(prior))
    z_t, y_t = eng._latents(*got1[:5], torch.tensor(SCALES),
                            torch.from_numpy(prior), max_frames=128)
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y))
    _close(z_t, z, MODULE_TOL, "z")


def test_phase2_matches_jax_infer_decode(models):
    jp, hp, eng = models
    want1, got1 = _phase1_both(jp, hp, eng, seed=2)
    _, _, _, prior = _inputs(hp, 3, (1, 1), 1, 128)
    m_p, logs_p, w_ceil, x_mask, _ = want1
    audio, y = _j_decode(jp, hp, m_p, logs_p, w_ceil, x_mask, 128, SCALES[0],
                         prior_noise=jnp.asarray(prior))
    a_t, y_t = eng._phase2(*got1[:5], torch.tensor(SCALES),
                           torch.from_numpy(prior), max_frames=128)
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y))
    up = hp.total_upsample
    assert a_t.shape == audio.shape == (2, 128 * up)
    for i, n in enumerate(np.asarray(y)):
        _close(a_t[i, :n * up], np.asarray(audio)[i, :n * up], WAVE_TOL,
               f"audio {i}")


@pytest.mark.parametrize("scales", [SCALES, (0.3, 1.4, 0.5)],
                         ids=["default", "other"])
def test_fused_program_matches_jax_infer(models, scales):
    """The scales are inputs of the program: one program, two sets of
    scales, each against the JAX reference."""
    jp, hp, eng = models
    ids, lens, dp_noise, prior = _inputs(hp, 4, (14, 9), 32, 128)
    audio, y, _ = _j_infer(jp, hp, jnp.asarray(ids, jnp.int32),
                           jnp.asarray(lens), 128, *scales,
                           dp_noise=jnp.asarray(dp_noise),
                           prior_noise=jnp.asarray(prior))
    program = partial(eng._fused, max_frames=128)
    a_t, y_t = program(*_t(ids, lens), torch.zeros(2, dtype=torch.int64),
                       torch.tensor(scales), *_t(dp_noise, prior))
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y))
    up = hp.total_upsample
    for i, n in enumerate(np.asarray(y)):
        _close(a_t[i, :n * up], np.asarray(audio)[i, :n * up], WAVE_TOL,
               f"audio {i}")


def test_first_chunk_matches_jax_composition(models):
    """The first-chunk program against the JAX engine's first-chunk
    computation (``_get_first_chunk``: durations, latents over the
    prefix, decode of the first window) on the same noise."""
    jp, hp, eng = models
    window = 96
    prefix = window + port_engine.FLOW_CONTEXT
    assert prefix == jax_engine.VitsEngine._FLOW_CONTEXT + window
    ids, lens, dp_noise, prior = _inputs(hp, 5, (13,), 32, prefix)
    m_p, logs_p, w_ceil, x_mask, g = _j_durations(
        jp, hp, jnp.asarray(ids, jnp.int32), jnp.asarray(lens), SCALES[1],
        SCALES[2], dp_noise=jnp.asarray(dp_noise))
    z_pre, y_pre = _j_latents(jp, hp, m_p, logs_p, w_ceil, x_mask, prefix,
                              SCALES[0], prior_noise=jnp.asarray(prior))
    valid = jnp.clip(y_pre, 0, window).astype(jnp.int32)
    want = _j_decode_audio(jp, hp, z_pre[:, :window], frame_lengths=valid)
    out = eng._first_chunk(*_t(ids, lens), torch.zeros(1, dtype=torch.int64),
                           torch.tensor(SCALES), *_t(dp_noise, prior),
                           window=window)
    audio, frames = out[0], out[6]
    np.testing.assert_array_equal(
        frames.numpy(), np.maximum(np.asarray(w_ceil).sum(-1), 1))
    n = int(valid[0]) * hp.total_upsample
    assert audio.shape == want.shape
    _close(audio[:, :n], np.asarray(want)[:, :n], WAVE_TOL, "first window")


def test_decode_chunk_takes_tensor_positions(models):
    """On the card the window's position is a device scalar (an input of
    the graph); it gives what the Python ints give."""
    _, hp, eng = models
    z = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 128, hp.inter_channels)).astype(np.float32) * 0.5)
    for start, offset, y_len in ((0, 0, 128), (40, 16, 100), (64, 8, 70)):
        want = eng._decode_chunk(z, start, offset, y_len, None, 48, 16)
        got = eng._decode_chunk(z, torch.tensor(start), torch.tensor(offset),
                                torch.tensor(y_len), None, 48, 16)
        assert torch.equal(got, want)


def test_bucket_choice_matches_jax_engine(models, caplog):
    """Text bucket, two-phase frame bucket (with its clamp and warning)
    and fused budget over a sweep of lengths, against the JAX engine's
    ``_bucket_for``, ``_frame_bucket_clamped`` and the fused budget of
    its ``synthesize_batch`` (engine.py:627-634)."""
    jp, hp, _ = models
    jax_eng = jax_engine.VitsEngine(jp, hp)
    eng = VitsEngine(port_params(jp, hp)[0], port_engine.VitsHParams(
        **dataclasses.asdict(hp)), device="cpu")
    assert eng.text_buckets == jax_eng.text_buckets
    assert eng.frame_buckets == jax_eng.frame_buckets
    assert eng.max_frames == jax_eng.frame_buckets[-1] == 4096
    assert eng.compiled_batching is jax_engine.VitsEngine.compiled_batching
    for n in list(range(1, 1025, 7)) + [32, 33, 1024]:
        assert (port_engine._bucket_for(n, eng.text_buckets)
                == jax_engine._bucket_for(n, jax_eng.text_buckets)), n
        budget = n * jax_eng.frames_per_token
        want = jax_engine._bucket_for(min(budget, jax_eng.frame_buckets[-1]),
                                      jax_eng.frame_buckets)
        if n in eng.text_buckets:
            assert eng._fused_bucket(n) == want, n
    for frames in list(range(0, 4200, 37)) + [4096, 4097, 9000]:
        with caplog.at_level("WARNING"):
            caplog.clear()
            got = eng._frame_bucket_clamped(frames)
            port_warned = "truncated" in caplog.text
            caplog.clear()
            assert got == jax_eng._frame_bucket_clamped(frames), frames
            assert port_warned == ("truncated" in caplog.text), frames
    with pytest.raises(ValueError, match="largest bucket"):
        port_engine._bucket_for(1025, eng.text_buckets)


@pytest.mark.parametrize("batch", [[[3, 7, 9, 11, 2, 5, 6, 8, 10]],
                                   [[3, 7, 9, 11, 2], [4, 6, 8, 2, 9, 12, 14,
                                                       5, 3, 7, 1, 2]]],
                         ids=["one", "ragged"])
def test_fused_equals_two_phase_on_valid_span(models, batch):
    _, hp, eng = models
    fused = VitsEngine(eng.params, eng.hp, text_buckets=TEXT_BUCKETS,
                       frame_buckets=FRAME_BUCKETS, mode="fused",
                       device="cpu")
    a2, f2 = eng.synthesize_batch(batch, seed=21)
    af, ff = fused.synthesize_batch(batch, seed=21)
    up = hp.total_upsample
    t_bucket = port_engine._bucket_for(max(map(len, batch)), TEXT_BUCKETS)
    assert af.shape[1] == fused._fused_bucket(t_bucket) * up
    assert max(ff) < af.shape[1] // up  # budget not reached
    assert ff == f2
    for i, n in enumerate(f2):
        _close(af[i, :n * up], a2[i, :n * up], MODE_TOL, f"utterance {i}")


def test_synthesize_many_equals_fused_calls(models):
    _, _, eng = models
    fused = VitsEngine(eng.params, eng.hp, text_buckets=TEXT_BUCKETS,
                       frame_buckets=FRAME_BUCKETS, mode="fused",
                       device="cpu")
    utts = [[3, 7, 9], [4, 6, 8, 2, 9, 12, 14, 5, 3, 7, 1, 2, 5, 9, 11, 13,
                        2], [5, 5, 6]]
    outs = eng.synthesize_many(utts, seed=9)
    assert len(outs) == len(utts)
    for i, (utt, out) in enumerate(zip(utts, outs)):
        np.testing.assert_array_equal(out, fused.synthesize_ids(utt, seed=9 + i))


@pytest.mark.parametrize("mode", ["two_phase", "fused"])
def test_pcm16_fetch_within_one_step(models, mode):
    """The counterpart of tests/test_voice_e2e.py:test_engine_pcm16_fetch,
    in both modes and for a stream."""
    _, _, eng = models
    kw = dict(text_buckets=TEXT_BUCKETS, frame_buckets=FRAME_BUCKETS,
              mode=mode, device="cpu")
    base = VitsEngine(eng.params, eng.hp, **kw)
    quant = VitsEngine(eng.params, eng.hp, fetch_pcm16=True, **kw)
    ids = [1, 4, 5, 9, 2, 8, 3, 6]
    a = base.synthesize_ids(ids, seed=0)
    b = quant.synthesize_ids(ids, seed=0)
    assert b.dtype == np.float32 and len(a) == len(b) > 0
    assert np.abs(a - b).max() <= PCM16_TOL
    stream = np.concatenate(list(quant.synthesize_ids_streaming(
        ids, chunk_frames=8, overlap_frames=8, seed=0)))
    assert np.abs(stream - a).max() <= PCM16_TOL


def test_warmup_runs(models):
    _, _, eng = models
    assert eng.warmup(batch_sizes=(1, 2), text_buckets=(16,)) is None
    eng.warmup()  # the default grid: the first three text buckets


def test_engine_options_refused_and_flags(models):
    _, _, eng = models
    params, hp = eng.params, eng.hp
    # bfloat16 is an engine dtype (tests/test_torch_bf16.py holds it);
    # another dtype raises
    assert VitsEngine(params, hp, dtype="bfloat16",
                      device="cpu").dtype == torch.bfloat16
    with pytest.raises(ValueError, match="dtype"):
        VitsEngine(params, hp, dtype="float16", device="cpu")
    # the JAX engine's matmul precisions: accepted, and on the CPU (where
    # TF32 does not exist) the audio of each equals the default's
    want = eng.synthesize_ids([1, 4, 5, 6, 2], seed=3)
    for prec in ("default", "high", "highest"):
        other = VitsEngine(params, hp, matmul_precision=prec, device="cpu")
        assert other.matmul_precision == prec
        np.testing.assert_array_equal(
            other.synthesize_ids([1, 4, 5, 6, 2], seed=3), want)
    with pytest.raises(ValueError, match="'high'"):
        VitsEngine(params, hp, matmul_precision="medium", device="cpu")
    with pytest.raises(ValueError, match="mode"):
        VitsEngine(params, hp, mode="eager", device="cpu")
    assert VitsEngine.compiled_batching is True
    assert eng.graphs is None  # the CPU calls the programs directly


def _tf32():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def _record_flags(engine, seen):
    """Wrap the engine's phase-1 program to record the TF32 flags it runs
    under."""
    program = engine._phase1

    def phase1(*args):
        seen.append(_tf32())
        return program(*args)

    engine._phase1 = phase1


def test_precision_scope_restores_the_flags(models):
    """A program runs under its engine's flags, which are restored after
    it, and after an exception inside the scope."""
    _, _, eng = models
    high = VitsEngine(eng.params, eng.hp, matmul_precision="high",
                      device="cpu")
    before = _tf32()
    seen = []
    _record_flags(high, seen)
    high.synthesize_ids([1, 4, 5, 2], seed=0)
    assert seen == [(True, True)] and _tf32() == before
    with pytest.raises(RuntimeError, match="inside"):
        with port_engine._prec_scope("high"):
            assert _tf32() == (True, True)
            raise RuntimeError("inside")
    assert _tf32() == before
    with pytest.raises(ValueError, match="matmul_precision"):
        with port_engine._prec_scope("fast"):
            pass


def test_precision_is_per_engine_across_threads(models):
    """A default engine on one thread and a "high" engine on another,
    their requests interleaved: each program runs under its own engine's
    flags, never the other's."""
    import threading

    _, _, eng = models
    engines = {prec: VitsEngine(eng.params, eng.hp, matmul_precision=prec,
                                device="cpu") for prec in (None, "high")}
    seen = {prec: [] for prec in engines}
    for prec, engine in engines.items():
        _record_flags(engine, seen[prec])
    start = threading.Barrier(2)
    errors = []

    def requests(engine):
        try:
            start.wait(timeout=30)
            for i in range(6):
                engine.synthesize_ids([1, 4, 5, 2], seed=i)
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=requests, args=(e,))
               for e in engines.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors
    assert seen[None] == [(False, False)] * 6
    assert seen["high"] == [(True, True)] * 6


# the bound of tests/test_torch_streaming.py: stream against monolithic
STREAM_TOL = 2e-5


def test_interleaved_streams_of_one_key(models):
    """Two streams of one graph key, pulled in turns: the second's first
    chunk runs between the first's first and second chunks. Each stream
    still equals its own request (on the card the first chunk's state is
    a fresh tensor, not the graph's static output)."""
    _, _, eng = models
    utts = [[3, 7, 9, 11, 2, 5, 6, 8, 10, 4, 12] * 2,
            [4, 6, 8, 2, 9, 12, 14, 5, 3, 7, 1, 2, 5] * 2]
    streams = [eng.synthesize_ids_streaming(u, chunk_frames=8,
                                            overlap_frames=8, seed=30 + i)
               for i, u in enumerate(utts)]
    chunks = [[], []]
    live = [0, 1]
    while live:
        for i in list(live):
            chunk = next(streams[i], None)
            if chunk is None:
                live.remove(i)
            else:
                chunks[i].append(chunk)
    for i, u in enumerate(utts):
        assert len(chunks[i]) > 2  # the latents and decode-chunk programs
        want = eng.synthesize_ids(u, seed=30 + i)
        got = np.concatenate(chunks[i])
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=STREAM_TOL, rtol=0)


def test_threads_share_an_engine(models):
    """Two threads making requests of one key at once each get what the
    same request gives alone."""
    import threading

    _, _, eng = models
    utts = [[3, 7, 9, 11, 2, 5, 6], [4, 6, 8, 2, 9, 12, 14, 5, 3]]
    alone = [eng.synthesize_ids(u, seed=40 + i) for i, u in enumerate(utts)]
    got = [[], []]

    def requests(i):
        for _ in range(3):
            got[i].append(eng.synthesize_ids(utts[i], seed=40 + i))

    threads = [threading.Thread(target=requests, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for outs, want in zip(got, alone):
        assert len(outs) == 3
        for out in outs:
            np.testing.assert_array_equal(out, want)


def test_capture_error_chain_finds_out_of_memory():
    """Inside a capture the allocator's out-of-memory error makes the
    capture's end fail too, and the end's error surfaces: the graphs'
    out-of-memory check looks through the chain of errors."""
    from phoonnx_tpu_torch.infer.graphs import _out_of_memory

    try:
        try:
            raise torch.OutOfMemoryError("CUDA out of memory")
        except torch.OutOfMemoryError:
            raise RuntimeError("operation failed due to a previous error "
                               "during capture")
    except RuntimeError as exc:
        assert _out_of_memory(exc)
    assert not _out_of_memory(RuntimeError("another failure"))
